"""Lightcurve shape features (port of ``mallorn_tpu.features.shape``).

Per-band features need >= 3 points, the all-band block >= 5:
rise/fade times, asymmetry, durations above a fraction of peak,
log-log power-law decay, cross-band peak-time spread and optical
(g, r, i) consistency, all-band flux percentiles and concentration.
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.utils.constants import LSST_BANDS

_BIG = 1.0e30
_NAN = float("nan")


def _peak(t, f, mask):
    idx = M.argmax(f, mask)
    any_ = M.count(mask) > 0
    return (torch.where(any_, M.take(t, idx), _NAN),
            torch.where(any_, M.take(f, idx), _NAN))


def _rise_time(t, f, mask, peak_t, peak_f, frac=0.1):
    pre = mask & (t < peak_t.unsqueeze(-1))
    any_pre = pre.any(dim=-1)
    above = pre & (f > (frac * peak_f).unsqueeze(-1))
    any_above = above.any(dim=-1)
    t_above = M.take(t, M.first_true(above))
    t_first = M.take(t, M.first_true(pre))
    rt = torch.where(any_above, peak_t - t_above, peak_t - t_first)
    ok = any_pre & (M.count(mask) >= 2) & ~torch.isnan(peak_t)
    return torch.where(ok, rt, _NAN)


def _fade_time(t, f, mask, peak_t, peak_f, frac):
    post = mask & (t > peak_t.unsqueeze(-1))
    any_post = post.any(dim=-1)
    below = post & (f < (frac * peak_f).unsqueeze(-1))
    any_below = below.any(dim=-1)
    t_below = M.take(t, M.first_true(below))
    t_last = M.mmax(torch.where(post, t, -_BIG), post)
    ft = torch.where(any_below, t_below - peak_t, t_last - peak_t)
    ok = any_post & (M.count(mask) >= 2) & ~torch.isnan(peak_t)
    return torch.where(ok, ft, _NAN)


def _duration_above(t, f, mask, frac):
    peak_f = M.mmax(f, mask)
    above = mask & (f > (frac * peak_f).unsqueeze(-1))
    span = M.mmax(t, above) - M.mmin(t, above)
    dur = torch.where(above.any(dim=-1), span, 0.0)
    return torch.where(M.count(mask) >= 2, dur, _NAN)


def _power_law_decay(t, f, mask, peak_t):
    sel = mask & (t > peak_t.unsqueeze(-1) + 5.0) & (f > 0)
    n_sel = sel.sum(dim=-1)
    dt = torch.clamp(t - peak_t.unsqueeze(-1), min=1.0)
    log_dt = torch.log10(torch.where(sel, dt, 1.0))
    log_f = torch.log10(torch.clamp(torch.where(sel, f, 1.0), min=1e-10))
    slope, intercept = M.linfit(log_dt, log_f, sel)
    pred = slope.unsqueeze(-1) * log_dt + intercept.unsqueeze(-1)
    resid = torch.sqrt(M.mean((log_f - pred) ** 2, sel))
    ok = (n_sel >= 5) & ~torch.isnan(peak_t)
    return torch.where(ok, slope, _NAN), torch.where(ok, resid, _NAN)


def _nan_agg(vals):
    """(mean, std ddof0, spread, n) over non-NaN along the last axis."""
    m = ~torch.isnan(vals)
    n = m.sum(dim=-1)
    mu = torch.where(m, vals, 0.0).sum(-1) / n.clamp(min=1)
    var = torch.where(m, (vals - mu.unsqueeze(-1)) ** 2, 0.0).sum(-1) / n.clamp(min=1)
    spread = M.mmax(vals, m) - M.mmin(vals, m)
    return mu, torch.sqrt(var), spread, n


def _opt(vals):
    """Mean / std / count over the optical bands g, r, i (indices 1..3)."""
    ov = vals[:, 1:4]
    m = ~torch.isnan(ov)
    n = m.sum(dim=-1)
    mu = torch.where(m, ov, 0.0).sum(-1) / n.clamp(min=1)
    var = torch.where(m, (ov - mu.unsqueeze(-1)) ** 2, 0.0).sum(-1) / n.clamp(min=1)
    return torch.where(n > 0, mu, _NAN), torch.sqrt(var), n


def extract(packed, meta=None) -> FeatureSet:
    feats: FeatureSet = {}
    t, f, mask = packed.band_time, packed.band_flux, packed.band_mask
    nb = M.count(mask)  # [N, 6]
    band_ok = nb >= 3
    bm = mask & band_ok.unsqueeze(-1)

    peak_t, peak_f = _peak(t, f, bm)
    rise = _rise_time(t, f, bm, peak_t, peak_f)
    fade50 = _fade_time(t, f, bm, peak_t, peak_f, 0.5)
    fade25 = _fade_time(t, f, bm, peak_t, peak_f, 0.25)
    asym = torch.where(~torch.isnan(rise) & ~torch.isnan(fade50) & (fade50 > 0),
                       rise / torch.where(fade50 > 0, fade50, 1.0), _NAN)
    dur50 = _duration_above(t, f, bm, 0.5)
    dur25 = _duration_above(t, f, bm, 0.25)
    alpha, resid = _power_law_decay(t, f, bm, peak_t)

    per_band = {
        "rise_time": rise, "fade_time_50": fade50, "fade_time_25": fade25,
        "asymmetry": asym, "duration_50": dur50, "duration_25": dur25,
        "power_law_alpha": alpha, "power_law_residual": resid,
    }
    for bi, band in enumerate(LSST_BANDS):
        for name, vals in per_band.items():
            feats[f"{band}_{name}"] = torch.where(band_ok[:, bi], vals[:, bi], _NAN)

    pt = torch.where(band_ok, peak_t, _NAN)
    _, pt_std, pt_spread, n_pt = _nan_agg(pt)
    feats["peak_time_spread"] = torch.where(n_pt >= 2, pt_spread, _NAN)
    feats["peak_time_std"] = torch.where(n_pt >= 2, pt_std, _NAN)

    r_mu, r_sd, r_n = _opt(rise)
    f_mu, f_sd, f_n = _opt(fade50)
    a_mu, _, a_n = _opt(alpha)
    feats["optical_mean_rise_time"] = r_mu
    feats["optical_mean_fade_time"] = f_mu
    feats["optical_mean_power_alpha"] = torch.where(a_n > 0, a_mu, _NAN)
    feats["rise_time_consistency"] = torch.where(r_n >= 2, r_sd / (r_mu + 1e-6), _NAN)
    feats["fade_time_consistency"] = torch.where(f_n >= 2, f_sd / (f_mu + 1e-6), _NAN)

    at, af, am = packed.all_time, packed.all_flux, packed.all_mask
    ok_all = M.count(am) >= 5
    am_ok = am & ok_all.unsqueeze(-1)

    pt_a, pf_a = _peak(at, af, am_ok)
    # all_rise_time scans rows in the reference's raw CSV order — band-major
    # blocks, time-sorted within band — which the flattened band view is
    n = t.shape[0]
    tfl = packed.band_time.reshape(n, -1)
    ffl = packed.band_flux.reshape(n, -1)
    mfl = packed.band_mask.reshape(n, -1) & ok_all.unsqueeze(-1)
    rise_a = _rise_time(tfl, ffl, mfl, pt_a, pf_a)
    fade_a = _fade_time(at, af, am_ok, pt_a, pf_a, 0.5)
    asym_a = torch.where(~torch.isnan(rise_a) & ~torch.isnan(fade_a) & (fade_a > 0),
                         rise_a / torch.where(fade_a > 0, fade_a, 1.0), _NAN)
    alpha_a, resid_a = _power_law_decay(at, af, am_ok, pt_a)

    feats["all_rise_time"] = torch.where(ok_all, rise_a, _NAN)
    feats["all_fade_time_50"] = torch.where(ok_all, fade_a, _NAN)
    feats["all_asymmetry"] = torch.where(ok_all, asym_a, _NAN)
    feats["all_power_law_alpha"] = torch.where(ok_all, alpha_a, _NAN)
    feats["all_power_law_residual"] = torch.where(ok_all, resid_a, _NAN)

    for q, name in ((0.10, "flux_p10"), (0.25, "flux_p25"),
                    (0.75, "flux_p75"), (0.90, "flux_p90")):
        feats[name] = torch.where(ok_all, M.quantile(af, am_ok, q), _NAN)

    total = M.msum(af, am_ok)
    conc = torch.where(pf_a > 0, pf_a / (total + 1e-6), _NAN)
    feats["flux_concentration"] = torch.where(ok_all, conc, _NAN)
    return sorted_features(feats)
