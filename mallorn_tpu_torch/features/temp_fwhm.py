"""Temperature-at-FWHM features, v59b (port of
``mallorn_tpu.features.temp_fwhm``): the g - r color temperature at the
r-band peak and at its half-max crossing times.

- all 7 columns need g and r with >= 5 points and a positive r peak;
- rise / fall half-max times: the first time-adjacent r-band pair
  straddling half (f_i < half <= f_i+1 before the peak, f_i >= half >
  f_i+1 from it on), linearly interpolated;
- flux at a time: interpolation between the searchsorted neighbours,
  clamped to the end values, NaN when the nearest point is > 10 d away;
- temperature 7000 / (g - r + 0.6), 50000 K below g - r = -0.5 and
  3000 K above 2.0, NaN for non-positive fluxes;
- the change, fall / rise ratio, peak-to-fall drop and cooling rate.
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.ops import masked as M

_NAN = float("nan")
_BIG = 1.0e30


def _temp_from_gr(gf, rf):
    bad = (gf <= 0) | (rf <= 0) | torch.isnan(gf) | torch.isnan(rf)
    g_r = -2.5 * torch.log10(torch.where(bad, 1.0, gf / rf))
    t = torch.where(g_r < -0.5, 50000.0, torch.where(g_r > 2.0, 3000.0, 7000.0 / (g_r + 0.6)))
    return torch.where(bad, _NAN, t)


def _flux_at_time(t, f, m, n, target, tolerance=10.0):
    """[N] flux of each row at ``target`` [N]."""
    T = t.shape[-1]
    tt = target[:, None]
    d = torch.where(m, torch.abs(t - tt), _BIG)
    far = d.amin(dim=-1) > tolerance
    idx = (m & (t < tt)).sum(dim=-1)  # searchsorted side='left'
    lo, hi = (idx - 1).clamp(0, T - 1), idx.clamp(0, T - 1)
    t1, t2 = M.take(t, lo), M.take(t, hi)
    f1, f2 = M.take(f, lo), M.take(f, hi)
    w = (target - t1) / torch.where(t2 == t1, 1.0, t2 - t1)
    interp = torch.where(t2 == t1, f1, f1 + w * (f2 - f1))
    out = torch.where(idx == 0, f[:, 0], torch.where(idx >= n, M.take(f, (n - 1) % T), interp))
    return torch.where(far | torch.isnan(target), _NAN, out)


def _first_cross(t, f, peak_idx, n, half, rising: bool):
    i = torch.arange(t.shape[-1] - 1, device=t.device)[None, :]
    f1, f2, t1, t2 = f[:, :-1], f[:, 1:], t[:, :-1], t[:, 1:]
    h = half[:, None]
    if rising:
        cond = (i < peak_idx[:, None]) & (f1 < h) & (f2 >= h)
    else:
        cond = (i >= peak_idx[:, None]) & (i + 1 < n[:, None]) & (f1 >= h) & (f2 < h)
    first = M.first_true(cond)
    a1, a2, b1, b2 = M.take(t1, first), M.take(t2, first), M.take(f1, first), M.take(f2, first)
    tc = a1 + (half - b1) * (a2 - a1) / torch.where(b2 == b1, 1.0, b2 - b1)
    return torch.where(cond.any(dim=-1), tc, _NAN)


def extract(packed, meta=None) -> FeatureSet:
    t, f, m = packed.band_time, packed.band_flux, packed.band_mask
    tg, fg, mg = t[:, 1], f[:, 1], m[:, 1]
    tr, fr, mr = t[:, 2], f[:, 2], m[:, 2]
    ng, nr = M.count(mg), M.count(mr)

    fmax = M.mmax(fr, mr)
    peak_idx = torch.argmax(torch.where(mr, fr, -_BIG), dim=-1)
    peak_t = M.take(tr, peak_idx)
    ok = (ng >= 5) & (nr >= 5) & (fmax > 0)
    half = fmax / 2.0
    rise_t = _first_cross(tr, fr, peak_idx, nr, half, True)
    fall_t = _first_cross(tr, fr, peak_idx, nr, half, False)

    def temp_at(target):
        return _temp_from_gr(_flux_at_time(tg, fg, mg, ng, target),
                             _flux_at_time(tr, fr, mr, nr, target))

    t_peak, t_rise, t_fall = temp_at(peak_t), temp_at(rise_t), temp_at(fall_t)
    dt = fall_t - peak_t
    feats: FeatureSet = {
        "temp_at_peak": t_peak,
        "temp_at_rise_hm": t_rise,
        "temp_at_fall_hm": t_fall,
        "temp_change_hm": t_fall - t_rise,
        "temp_ratio_fall_rise": torch.where(
            t_rise > 0, t_fall / torch.where(t_rise > 0, t_rise, 1.0), _NAN),
        "temp_drop_peak_to_hm": t_peak - t_fall,
        "cooling_rate_to_hm": torch.where(
            dt > 0, (t_peak - t_fall) / torch.where(dt > 0, dt, 1.0), _NAN),
    }
    return sorted_features({k: torch.where(ok, v, _NAN) for k, v in feats.items()})
