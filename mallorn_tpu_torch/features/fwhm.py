"""FWHM features, v58 (port of ``mallorn_tpu.features.fwhm``).

Per band (>= 5 points, positive peak flux), on the time-sorted valid
prefix:

- the peak is the first max-flux point;
- rise_hwhm: on t <= peak (>= 2 points), peak_t - t_first when every
  point is at or above half-max, else the half-max crossing interpolated
  between the first point at or above half and the point before it (NaN
  when that point is the side's first, or the two fluxes are equal);
- fall_hwhm: the mirror on t >= peak, with the first point below half;
- fwhm = rise + fall, fwhm_asymmetry = fall / rise (rise > 0);
- over the bands with a valid fwhm: mean, std (ddof 0), max, min, the
  g / r and r / i ratios and the mean asymmetry.
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.utils.constants import LSST_BANDS

_NAN = float("nan")
_BIG = 1.0e30


def _interp_cross(t1, f1, t2, f2, half):
    t_cross = t1 + (half - f1) * (t2 - t1) / torch.where(f2 == f1, 1.0, f2 - f1)
    return torch.where(f2 == f1, _NAN, t_cross)


def _hwhm_side(t, f, m, peak_i, peak_t, half, rising: bool):
    """One side's HWHM [N, 6] by index adjacency on the valid prefix."""
    idx = torch.arange(t.shape[-1], device=t.device)
    pi_ = peak_i[..., None]
    side = m & ((idx <= pi_) if rising else (idx >= pi_))
    n_side = side.sum(dim=-1)
    above = side & (f >= half[..., None])
    target = above if rising else (side & (f < half[..., None]))
    n_above = above.sum(dim=-1)

    last_i = (m.sum(dim=-1) - 1).clamp(min=0)
    all_above = (peak_t - t[..., 0]) if rising else (M.take(t, last_i) - peak_t)

    ci = M.first_true(target)
    has_target = target.any(dim=-1)
    has_prev = (ci > 0) if rising else (ci > peak_i)
    pi = (ci - 1).clamp(min=0)
    t_cross = _interp_cross(M.take(t, pi), M.take(f, pi), M.take(t, ci), M.take(f, ci), half)
    crossed = (peak_t - t_cross) if rising else (t_cross - peak_t)
    crossed = torch.where(has_prev, crossed, _NAN)

    mixed = has_target & (n_above > 0) & (n_above < n_side)
    out = torch.where(mixed, crossed, torch.where(n_above == n_side, all_above, _NAN))
    return torch.where(n_side >= 2, out, _NAN)


def extract(packed, meta=None) -> FeatureSet:
    t, f, m = packed.band_time, packed.band_flux, packed.band_mask
    ok = M.count(m) >= 5
    fmax = M.mmax(f, m)
    peak_i = M.first_true(m & (f == fmax[..., None]))
    peak_t = M.take(t, peak_i)
    valid = ok & (fmax > 0)
    half = fmax / 2.0

    rise = torch.where(valid, _hwhm_side(t, f, m, peak_i, peak_t, half, True), _NAN)
    fall = torch.where(valid, _hwhm_side(t, f, m, peak_i, peak_t, half, False), _NAN)
    both = ~torch.isnan(rise) & ~torch.isnan(fall)
    fwhm = torch.where(both, rise + fall, _NAN)
    asym = torch.where(both & (rise > 0), fall / torch.where(rise > 0, rise, 1.0), _NAN)

    feats: FeatureSet = {}
    for bi, band in enumerate(LSST_BANDS):
        feats[f"{band}_rise_hwhm"] = rise[:, bi]
        feats[f"{band}_fall_hwhm"] = fall[:, bi]
        feats[f"{band}_fwhm"] = fwhm[:, bi]
        feats[f"{band}_fwhm_asymmetry"] = asym[:, bi]

    fv = ~torch.isnan(fwhm)
    nf = fv.sum(dim=1)
    mu = torch.where(fv, fwhm, 0.0).sum(dim=1) / nf.clamp(min=1)
    var = torch.where(fv, (fwhm - mu[:, None]) ** 2, 0.0).sum(dim=1) / nf.clamp(min=1)
    any_f = nf > 0
    feats["fwhm_mean"] = torch.where(any_f, mu, _NAN)
    feats["fwhm_std"] = torch.where(any_f, torch.sqrt(var), _NAN)
    feats["fwhm_max"] = torch.where(any_f, torch.where(fv, fwhm, -_BIG).amax(dim=1), _NAN)
    feats["fwhm_min"] = torch.where(any_f, torch.where(fv, fwhm, _BIG).amin(dim=1), _NAN)

    def _ratio(num, den):
        okr = fv[:, num] & fv[:, den] & (fwhm[:, den] > 0)
        return torch.where(okr, fwhm[:, num] / torch.where(okr, fwhm[:, den], 1.0), _NAN)

    feats["fwhm_g_over_r"] = _ratio(1, 2)
    feats["fwhm_r_over_i"] = _ratio(2, 3)
    av = ~torch.isnan(asym)
    na = av.sum(dim=1)
    feats["fwhm_asymmetry_mean"] = torch.where(
        na > 0, torch.where(av, asym, 0.0).sum(dim=1) / na.clamp(min=1), _NAN)
    return sorted_features(feats)
