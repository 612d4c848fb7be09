"""Time-to-decline features, v48 (port of
``mallorn_tpu.features.time_to_decline``): per band (>= 3 points) the
time from the peak to the first post-peak point below 80 / 60 / 40 / 20 /
10 % of the peak flux, linearly interpolated from the previous post-peak
point, and the decline velocity 0.6 / (t_20 - t_80) when both exist,
t_20 > t_80 and at least two thresholds were reached.
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.utils.constants import LSST_BANDS

_NAN = float("nan")
THRESHOLDS = (0.8, 0.6, 0.4, 0.2, 0.1)


def _decline_time(t, f, mask, peak_t, peak_f, frac):
    """Interpolated first crossing below frac * peak after the peak [N, 6]."""
    post = mask & (t > peak_t[..., None])
    target = frac * peak_f
    below = post & (f < target[..., None])
    any_below = below.any(dim=-1)
    idx = M.first_true(below)
    t2, f2 = M.take(t, idx), M.take(f, idx)
    prev = (idx - 1).clamp(min=0)
    t1, f1 = M.take(t, prev), M.take(f, prev)
    prev_is_post = M.take(post, prev) & (idx > 0)
    df = f2 - f1
    cross = torch.where(df != 0,
                        t1 + (target - f1) * (t2 - t1) / torch.where(df != 0, df, 1.0), t2)
    cross = torch.where(prev_is_post, cross, t2)
    return torch.where(any_below, cross - peak_t, _NAN)


def extract(packed, meta=None) -> FeatureSet:
    t, f, mask = packed.band_time, packed.band_flux, packed.band_mask
    nb = M.count(mask)
    ok = nb >= 3
    bm = mask & ok[..., None]
    pk = M.argmax(f, bm)
    peak_t, peak_f = M.take(t, pk), M.take(f, pk)

    per_thresh = {}
    n_reached = torch.zeros_like(nb)
    for thresh in THRESHOLDS:
        dt = torch.where(ok, _decline_time(t, f, bm, peak_t, peak_f, thresh), _NAN)
        per_thresh[thresh] = dt
        n_reached = n_reached + torch.isfinite(dt).to(nb.dtype)

    feats: FeatureSet = {}
    for bi, band in enumerate(LSST_BANDS):
        for thresh in THRESHOLDS:
            feats[f"{band}_decline_to_{int(thresh * 100)}pct"] = per_thresh[thresh][:, bi]
        t80, t20 = per_thresh[0.8][:, bi], per_thresh[0.2][:, bi]
        vel_ok = (n_reached[:, bi] >= 2) & torch.isfinite(t80) & torch.isfinite(t20) & (t20 > t80)
        vel = 0.6 / torch.where(t20 > t80, t20 - t80, 1.0)
        feats[f"{band}_decline_velocity"] = torch.where(vel_ok, vel, _NAN)
    return sorted_features(feats)
