"""v32/v105 physics-motivated feature interactions and their top-K
selection (port of ``mallorn_tpu.features.interactions``; host numpy).

Host-side tabular transform on the feature matrix, mirroring reference
src/features/interactions.py:
products/ratios over existing features (color x Z, temperature cooling,
amplitude x duration, GP x amplitude, asymmetry x color, slope
interactions, skew x std, polynomial squares, cross-band ratios,
:23-196) and point-biserial top-K selection (:197-246).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

Features = Dict[str, np.ndarray]


def create_physics_interactions(feats: Features) -> Features:
    """Returns ONLY the new interaction columns (callers merge)."""
    out: Features = {}

    def get(name):
        return feats.get(name)

    Z = get("Z")
    if Z is not None:
        for cf in ("g_r_at_peak", "g_r_post_20d", "g_r_post_50d", "r_i_at_peak"):
            c = get(cf)
            if c is not None:
                out[f"{cf}_x_Z"] = c * Z
                out[f"{cf}_div_Z"] = c / (Z + 0.1)
        for cf in ("gp_gr_color_20d", "gp_gr_color_50d", "gp_ri_color_20d"):
            c = get(cf)
            if c is not None:
                out[f"{cf}_x_Z"] = c * Z

    tp, t50 = get("temp_at_peak"), get("temp_post_50d")
    if tp is not None and t50 is not None:
        out["temp_cooling_ratio"] = t50 / (tp + 100.0)
        out["temp_drop_rate"] = (tp - t50) / 50.0
        out["temp_peak_4th"] = np.power(np.clip(tp, 0, 100000), 0.25)

    for band in ("g", "r", "i"):
        pk, dur = get(f"{band}_peak_flux"), get(f"{band}_duration_50")
        if pk is not None and dur is not None:
            out[f"{band}_flux_duration"] = pk * dur
            out[f"{band}_flux_per_day"] = pk / (dur + 1.0)

    gp_t, gp_w = get("gp2d_time_scale"), get("gp2d_wave_scale")
    for band in ("g", "r", "i"):
        amp = get(f"{band}_amplitude")
        if gp_t is not None and amp is not None:
            out[f"{band}_gp_amp_time"] = amp * gp_t
        if gp_w is not None and amp is not None:
            out[f"{band}_gp_amp_wave"] = amp * gp_w

    for band in ("g", "r"):
        rise, fade = get(f"{band}_rise_time"), get(f"{band}_fade_time_50")
        color = get("g_r_at_peak") if band == "g" else get("r_i_at_peak")
        if rise is not None and fade is not None and color is not None:
            out[f"{band}_asym_x_color"] = (rise / (fade + 1.0)) * color

    s50, s100, cpk = get("g_r_slope_50d"), get("g_r_slope_100d"), get("g_r_at_peak")
    if s50 is not None and cpk is not None:
        out["gr_peak_x_slope50"] = cpk * s50
    if s100 is not None and cpk is not None:
        out["gr_peak_x_slope100"] = cpk * s100
    if s50 is not None and s100 is not None:
        out["gr_color_accel"] = s100 - s50

    for band in ("g", "r", "i"):
        sk, sd = get(f"{band}_skew"), get(f"{band}_std")
        if sk is not None and sd is not None:
            out[f"{band}_skew_x_std"] = sk * sd

    ug, gr = get("u_g_peak_flux_ratio"), get("g_r_peak_flux_ratio")
    if ug is not None and gr is not None:
        out["ug_x_gr_ratio"] = ug * gr

    for feat in ("r_skew", "g_skew", "flux_p25"):
        v = get(feat)
        if v is not None:
            out[f"{feat}_squared"] = v ** 2

    g_rise, r_rise = get("g_rise_time"), get("r_rise_time")
    if g_rise is not None and r_rise is not None:
        out["rise_ratio_g_r"] = g_rise / (r_rise + 1.0)
    g_fade, r_fade = get("g_fade_time_50"), get("r_fade_time_50")
    if g_fade is not None and r_fade is not None:
        out["fade_ratio_g_r"] = g_fade / (r_fade + 1.0)
    if gp_t is not None and gp_w is not None:
        out["gp_time_wave_ratio"] = gp_t / (gp_w + 1e-6)

    return out


def _betainc(a: float, b: float, x: float) -> float:
    """The regularised incomplete beta function I_x(a, b) by its continued
    fraction (modified Lentz), on the side where it converges fast."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    if x > (a + 1.0) / (a + b + 2.0):
        return 1.0 - _betainc(b, a, 1.0 - x)
    log_front = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
                 + a * math.log(x) + b * math.log1p(-x))
    tiny = 1e-300
    c, d = 1.0, 1.0 - (a + b) * x / (a + 1.0)
    d = 1.0 / (d if abs(d) > tiny else tiny)
    h = d
    for m in range(1, 10000):
        for num in (m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m)),
                    -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1))):
            d = 1.0 + num * d
            d = 1.0 / (d if abs(d) > tiny else tiny)
            c = 1.0 + num / c
            c = c if abs(c) > tiny else tiny
            h *= d * c
        if abs(d * c - 1.0) < 1e-16:
            break
    return math.exp(log_front) * h / a


def pointbiserialr(x: np.ndarray, y: np.ndarray):
    """(r, two-sided p) of Pearson's correlation between a binary ``x``
    and ``y`` (scipy.stats.pointbiserialr's arithmetic: centred vectors
    scaled by their largest entry before the norm, r clipped to [-1, 1],
    NaN for a constant input; p from the beta distribution of r under the
    null, a = b = n/2 - 1)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    if n < 2 or np.all(x == x[0]) or np.all(y == y[0]):
        return np.nan, np.nan
    xm = x - x.mean()
    ym = y - y.mean()
    xmax, ymax = np.abs(xm).max(), np.abs(ym).max()
    normxm = xmax * np.sqrt(np.sum((xm / xmax) ** 2))
    normym = ymax * np.sqrt(np.sum((ym / ymax) ** 2))
    r = float(np.clip(np.vecdot(xm / normxm, ym / normym), -1.0, 1.0))
    if n == 2:
        return float(np.round(r)), 1.0
    ab = n / 2.0 - 1.0
    return r, min(1.0, 2.0 * _betainc(ab, ab, (1.0 - abs(r)) / 2.0))


def select_top_interactions(interactions: Features, y: np.ndarray,
                            top_k: int = 30, min_samples: int = 100,
                            max_pval: float = 0.05) -> List[str]:
    """Point-biserial |correlation| ranking with a p-value gate."""
    scored: List[Tuple[float, float, str]] = []
    for name, vals in interactions.items():
        vals = np.asarray(vals, dtype=np.float64)
        valid = np.isfinite(vals)
        if valid.sum() > min_samples:
            corr, pval = pointbiserialr(y[valid], vals[valid])
            if np.isfinite(corr):
                scored.append((abs(corr), pval, name))
    scored.sort(reverse=True)
    return [name for c, p, name in scored if p < max_pval][:top_k]
