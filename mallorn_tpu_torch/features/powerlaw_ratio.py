"""Power-law decay and MaxVar features, v65 (port of
``mallorn_tpu.features.powerlaw_ratio``).

Per band g, r, i (>= 5 points):

- ``maxvar`` (max - median) / MAD, NaN when MAD == 0;
- ``peak_baseline_ratio`` max / 10th percentile, NaN when that is <= 0;
- ``power_exponent``: the log10-log10 slope of the points > 5 d after
  the peak with positive flux (>= 3);
- ``late_frac`` / ``very_late_frac``: the mean flux > 50 / > 100 d after
  the peak over the peak flux.

Across bands: the exponents' std (ddof 0) / mean / min over >= 2 finite
bands, ``tde_decay_score`` = -|r exponent + 1.67|, and the mean / max of
the finite g / r maxvars.
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.ops import masked as M

_NAN = float("nan")
BANDS = ((1, "g"), (2, "r"), (3, "i"))
_NAMES = ("maxvar", "peak_baseline_ratio", "power_exponent", "late_frac", "very_late_frac")


def _band_feats(t, f, mask):
    """The five per-band columns of [N, 3, T] rows -> five [N, 3]."""
    n = M.count(mask)
    ok5 = n >= 5
    mx = M.mmax(f, mask)
    med = M.median(f, mask)
    mad = M.mad(f, mask)
    maxvar = torch.where(ok5 & (mad > 0), (mx - med) / torch.where(mad > 0, mad, 1.0), _NAN)
    baseline = M.quantile(f, mask, 0.10)
    pbr = torch.where(ok5 & (baseline > 0), mx / torch.where(baseline > 0, baseline, 1.0), _NAN)

    pi = M.argmax(f, mask)
    peak_t, peak_f = M.take(t, pi)[..., None], M.take(f, pi)
    post = mask & (t > peak_t + 5.0)
    valid = post & (f > 0) & (t - peak_t > 0)
    lt = torch.log10(torch.where(valid, t - peak_t, 1.0))
    lf = torch.log10(torch.where(valid, f, 1.0))
    slope, _ = M.linfit(lt, lf, valid)
    pexp = torch.where(ok5 & (M.count(post) >= 3) & (M.count(valid) >= 3), slope, _NAN)

    pf_ = torch.where(peak_f > 0, peak_f, 1.0)
    late = mask & (t > peak_t + 50.0)
    lfrac = torch.where(ok5 & (M.count(late) > 0) & (peak_f > 0), M.mean(f, late) / pf_, _NAN)
    vlate = mask & (t > peak_t + 100.0)
    vfrac = torch.where(ok5 & (M.count(vlate) > 0) & (peak_f > 0), M.mean(f, vlate) / pf_, _NAN)
    return maxvar, pbr, pexp, lfrac, vfrac


def extract(packed, meta=None) -> FeatureSet:
    sel = [bi for bi, _ in BANDS]
    vals = _band_feats(packed.band_time[:, sel], packed.band_flux[:, sel],
                       packed.band_mask[:, sel])
    feats: FeatureSet = {}
    for j, (_, b) in enumerate(BANDS):
        for name, val in zip(_NAMES, vals):
            feats[f"{b}_{name}"] = val[:, j]

    exps = vals[2]
    emask = ~torch.isnan(exps)
    ge2 = M.count(emask) >= 2
    feats["power_exp_std"] = torch.where(ge2, M.std(exps, emask), _NAN)
    feats["power_exp_mean"] = torch.where(ge2, M.mean(exps, emask), _NAN)
    feats["power_exp_min"] = torch.where(ge2, M.mmin(exps, emask), _NAN)
    r_exp = exps[:, 1]
    feats["tde_decay_score"] = torch.where(~torch.isnan(r_exp), -torch.abs(r_exp + 1.67), _NAN)
    mvs = vals[0][:, :2]
    mmask = ~torch.isnan(mvs)
    ge1 = M.count(mmask) >= 1
    feats["maxvar_mean"] = torch.where(ge1, M.mean(mvs, mmask), _NAN)
    feats["maxvar_max"] = torch.where(ge1, M.mmax(mvs, mmask), _NAN)
    return sorted_features(feats)
