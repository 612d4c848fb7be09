"""Cross-band peak-ordering features, the v56 AGN / TDE separator (port of
``mallorn_tpu.features.peak_ordering``).

- per band (>= 3 points): the peak time, the earliest time among the
  max-flux points;
- g -> r and u -> i peak delays, NaN unless both bands are valid;
- blue_to_red_delay = min(peak z, y) - min(peak u, g) over the valid
  bands of each side, and is_blue_first;
- with >= 2 valid bands: the one-hot first-peaking band (ties to the
  lowest band index), g_peaks_last (ties to the highest index) and the
  peak-time spread.
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.utils.constants import LSST_BANDS

_NAN = float("nan")
_BIG = 1.0e30


def _nanmin2(a, b):
    both = torch.isnan(a) & torch.isnan(b)
    lo = torch.minimum(torch.nan_to_num(a, nan=_BIG), torch.nan_to_num(b, nan=_BIG))
    return torch.where(both, _NAN, lo)


def extract(packed, meta=None) -> FeatureSet:
    t, f, m = packed.band_time, packed.band_flux, packed.band_mask  # [N, 6, T]
    ok = M.count(m) >= 3
    fmax = M.mmax(f, m)
    at_peak = m & (f == fmax[..., None])
    pt = torch.where(at_peak, t, _BIG).amin(dim=-1)
    pt = torch.where(ok, pt, _NAN)  # [N, 6]

    feats: FeatureSet = {
        "g_to_r_peak_delay": pt[:, 2] - pt[:, 1],
        "u_to_i_peak_delay": pt[:, 3] - pt[:, 0],
    }
    blue = _nanmin2(pt[:, 0], pt[:, 1])
    red = _nanmin2(pt[:, 4], pt[:, 5])
    feats["blue_to_red_delay"] = red - blue
    feats["is_blue_first"] = torch.where(torch.isnan(blue) | torch.isnan(red), _NAN,
                                         (blue < red).to(torch.float32))

    valid = ~torch.isnan(pt)
    enough = valid.sum(dim=1) >= 2
    first_b = torch.argmin(torch.where(valid, pt, _BIG), dim=1)
    last_b = 5 - torch.argmax(torch.where(valid, pt, -_BIG).flip(1), dim=1)
    for bi, band in enumerate(LSST_BANDS):
        feats[f"first_peak_{band}"] = torch.where(enough, (first_b == bi).to(torch.float32),
                                                  _NAN)
    feats["g_peaks_last"] = torch.where(enough, (last_b == 1).to(torch.float32), _NAN)
    spread = (torch.where(valid, pt, -_BIG).amax(dim=1)
              - torch.where(valid, pt, _BIG).amin(dim=1))
    feats["peak_time_spread"] = torch.where(enough, spread, _NAN)
    return sorted_features(feats)
