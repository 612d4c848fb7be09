"""v64 blackbody-radius evolution features (port of
``mallorn_tpu.features.blackbody``).

Planck temperature fits at 6 epochs (peak, +10/20/30/50/100 d) over the
g/r/i fluxes, a pseudo-bolometric luminosity, R_bb ~ sqrt(L) / T^2 and its
evolution:

- epoch flux per band: the mean of the observations within +-5 d, else a
  linear interpolation between the bracketing points when their gap is
  < 30 d (``_flux_at_epoch``);
- the global peak: the flux-weighted mean of the g/r/i peak times;
- the T fit (``_fit_bb``): 10^logA B_lambda(T) over >= 2 positive bands,
  fluxes divided by their median, T in [3000, 1e5], logA in [-20, 0], six
  starts in T, through ``ops.lm.lm_fit_batched`` with the analytic
  Jacobian (``_bb_model``; ``_planck``'s clip of x to [1e-6, 500] zeroes
  d/dT where it binds);
- derived: dR/dt early / late / overall, monotonic-decrease flags over the
  compacted valid sequence (a stable sort), R ratios, R / T statistics,
  T drops / ratios, T constancy, the R direction score.

Columns come in the JAX package's order.
"""

from __future__ import annotations

import math

import torch

from mallorn_tpu_torch.data.packing import PackedLightcurves
from mallorn_tpu_torch.features.base import FeatureSet
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.ops.lm import d_clip, d_max, lm_fit_batched

_NAN = float("nan")

H_PLANCK, C_LIGHT, K_BOLTZ = 6.626e-27, 2.998e10, 1.381e-16
FIT_WAVES = (4825.0, 6222.0, 7545.0)  # g, r, i Angstrom
EPOCHS = (0.0, 10.0, 20.0, 30.0, 50.0, 100.0)
EPOCH_NAMES = ("peak", "10d", "20d", "30d", "50d", "100d")
_LN10 = math.log(10.0)


def _planck(lam_A, T, with_jac: bool = False):
    """B_lambda(T) in cgs for wavelengths in Angstrom; with ``with_jac``
    also d B / d T."""
    lam_cm = lam_A * 1e-8
    Tm = torch.clamp(T, min=1.0)
    xr = (H_PLANCK * C_LIGHT) / (lam_cm * K_BOLTZ * Tm)
    x = torch.clamp(xr, 1e-6, 500.0)
    em1 = torch.expm1(x)
    B = ((2.0 * H_PLANCK * C_LIGHT ** 2) / lam_cm ** 5) / em1
    if not with_jac:
        return B
    # d B / d x = -K e^x / (e^x - 1)^2 = -B (1 + 1 / expm1(x)); d x / d T
    # through the clip of x and the floor of T
    dB_dx = -B * (1.0 + 1.0 / em1)
    dx_dT = d_clip(xr, 1e-6, 500.0) * (-xr / Tm) * d_max(T, 1.0)
    return B, dB_dx * dx_dT


def _bb_model(lam, theta, with_jac: bool = False):
    """10^logA B_lambda(T) for theta [..., 2] = (T, logA)."""
    T, logA = theta[..., 0:1], theta[..., 1:2]
    amp = torch.pow(10.0, logA)
    if not with_jac:
        return amp * _planck(lam, T)
    B, dB_dT = _planck(lam, T, True)
    f = amp * B
    return f, torch.stack([amp * dB_dT, _LN10 * f], dim=-1)


def _flux_at_epoch(t, f, mask, target):
    """Epoch flux per lane ([..., T] lanes, ``target`` broadcast against
    their leading axes): the window mean, else the bracketed interpolation
    (< 30 d), else NaN."""
    tg = target[..., None]
    win = mask & ((t - tg).abs() <= 5.0)
    nwin = M.count(win)
    win_mean = M.mean(f, win)

    before = mask & (t < tg)
    after = mask & (t > tg)
    t_b = M.mmax(t, before)
    t_a = M.mmin(t, after)
    ib = M.argmax(torch.where(before, t, -1e30), before)
    ia = M.argmin(torch.where(after, t, 1e30), after)
    f_b = M.take(f, ib)
    f_a = M.take(f, ia)
    ok_interp = before.any(dim=-1) & after.any(dim=-1) & (t_a - t_b < 30.0)
    w = (target - t_b) / torch.clamp(t_a - t_b, min=1e-10)
    interp = f_b + w * (f_a - f_b)

    out = torch.where(nwin > 0, win_mean, torch.where(ok_interp, interp, _NAN))
    return torch.where(M.count(mask) > 0, out, _NAN)


def _fit_bb(gri_flux):
    """Batched (T, logA) Planck fits of [L, 3] fluxes -> (T, reduced chi^2,
    valid band count)."""
    valid = torch.isfinite(gri_flux) & (gri_flux > 0)
    nv = valid.sum(dim=1)
    med = M.median(gri_flux, valid)
    ok = (nv >= 2) & (med > 0)
    obs = torch.where(valid, gri_flux / torch.where(med > 0, med, 1.0)[:, None], 0.0)

    L = gri_flux.shape[0]
    lam = torch.tensor(FIT_WAVES, dtype=obs.dtype, device=obs.device).expand(L, 3)
    ones = torch.ones(L, dtype=obs.dtype, device=obs.device)
    lb = torch.stack([3000.0 * ones, -20.0 * ones], 1)
    ub = torch.stack([100000.0 * ones, 0.0 * ones], 1)
    starts = torch.stack([torch.stack([T0 * ones, -10.0 * ones], 1)
                          for T0 in (8000.0, 12000.0, 15000.0, 20000.0, 30000.0, 50000.0)])
    res = lm_fit_batched(_bb_model, lam, obs, torch.ones_like(obs), valid, starts, lb, ub,
                         n_iters=60)
    chi2_red = res.cost / torch.clamp(nv - 2, min=1)
    ok = ok & res.valid
    return torch.where(ok, res.theta[:, 0], _NAN), torch.where(ok, chi2_red, _NAN), nv


def extract(packed: PackedLightcurves, meta=None) -> FeatureSet:
    N = packed.n_objects
    t, f, mask = packed.band_time[:, 1:4], packed.band_flux[:, 1:4], packed.band_mask[:, 1:4]

    # global peak: flux-weighted mean of the g/r/i per-band argmax times
    pk_idx = M.argmax(f, mask)  # [N, 3]
    pk_t = M.take(t, pk_idx)
    pk_f = M.take(f, pk_idx)
    has = M.count(mask) > 0
    wsum = torch.where(has, pk_f, 0.0).sum(dim=1)
    peak_time = (torch.where(has, pk_t * pk_f, 0.0).sum(dim=1)
                 / torch.where(wsum != 0, wsum, 1.0))
    have_peak = has.any(dim=1) & (wsum != 0)

    # epoch fluxes for g, r, i: [N, E, 3]
    gri = torch.stack([_flux_at_epoch(t, f, mask, (peak_time + dt)[:, None])
                       for dt in EPOCHS], dim=1)
    gri = torch.where(have_peak[:, None, None], gri, _NAN)

    E = len(EPOCHS)
    T_fit, chi2, _ = _fit_bb(gri.reshape(N * E, 3))
    T_fit = T_fit.reshape(N, E)
    chi2 = chi2.reshape(N, E)

    # L proxy: the mean of the valid positive g/r/i fluxes
    lv = torch.isfinite(gri) & (gri > 0)
    nlv = lv.sum(dim=-1)
    L_proxy = torch.where(lv, gri, 0.0).sum(dim=-1) / torch.clamp(nlv, min=1)
    L_proxy = torch.where((nlv >= 2) & ~torch.isnan(T_fit), L_proxy, _NAN)
    R = torch.where((L_proxy > 0) & (T_fit > 0), torch.sqrt(L_proxy) / (T_fit ** 2) * 1e8, _NAN)

    feats: FeatureSet = {}
    for ei, name in enumerate(EPOCH_NAMES):
        feats[f"T_{name}"] = T_fit[:, ei]
        feats[f"T_chi2_{name}"] = chi2[:, ei]
        feats[f"R_bb_{name}"] = R[:, ei]
        feats[f"L_proxy_{name}"] = L_proxy[:, ei]

    valid_e = ~torch.isnan(R) & ~torch.isnan(T_fit)  # [N, E]
    n_val = valid_e.sum(dim=1)
    ok2 = n_val >= 2
    ep = torch.tensor(EPOCHS, dtype=R.dtype, device=R.device)

    def nanfit(y, m):
        return M.linfit(ep.expand_as(y), torch.where(m, y, 0.0), m)[0]

    early = valid_e & (ep <= 30.0)
    late = valid_e & (ep >= 30.0)
    s_early = nanfit(R, early)
    s_late = nanfit(R, late)
    s_all = nanfit(R, valid_e)
    ok_early = ok2 & (early.sum(dim=1) >= 2)
    feats["dRdt_early"] = torch.where(ok_early, s_early, _NAN)
    feats["R_increasing_early"] = torch.where(ok_early, (s_early > 0).to(R.dtype), _NAN)
    feats["dRdt_late"] = torch.where(ok2 & (late.sum(dim=1) >= 2), s_late, _NAN)
    feats["dRdt_overall"] = torch.where(ok2, s_all, _NAN)
    feats["R_bb_trend_slope"] = feats["dRdt_overall"]

    # monotonic decrease over the COMPACTED valid sequence
    order = torch.sort((~valid_e).to(torch.uint8), dim=1, stable=True).indices
    R_c = torch.gather(R, 1, order)
    pos = torch.arange(E, device=R.device)
    pairm = pos[1:][None, :] < n_val[:, None]
    dR = R_c[:, 1:] - R_c[:, :-1]
    all_dec = torch.where(pairm, dR < 0, True).all(dim=1)
    frac_dec = (torch.where(pairm, (dR < 0).to(R.dtype), 0.0).sum(dim=1)
                / torch.clamp(pairm.sum(dim=1), min=1))
    feats["R_monotonic_decrease"] = torch.where(ok2, all_dec.to(R.dtype), _NAN)
    feats["R_frac_decreasing"] = torch.where(ok2, frac_dec, _NAN)

    def ratio(a, b):
        okr = ~torch.isnan(a) & ~torch.isnan(b) & (b > 0)
        return torch.where(ok2 & okr, a / torch.where(okr, b, 1.0), _NAN)

    feats["R_ratio_peak_50d"] = ratio(R[:, 0], R[:, 4])
    feats["R_ratio_peak_100d"] = ratio(R[:, 0], R[:, 5])
    feats["R_ratio_10d_30d"] = ratio(R[:, 1], R[:, 3])

    R_mu = M.mean(R, valid_e)
    R_var = M.var(R, valid_e, 0)
    feats["R_bb_variance"] = torch.where(ok2, R_var, _NAN)
    feats["R_bb_range"] = torch.where(ok2, M.mmax(R, valid_e) - M.mmin(R, valid_e), _NAN)
    feats["R_bb_mean"] = torch.where(ok2, R_mu, _NAN)
    feats["R_bb_std"] = torch.where(ok2, torch.sqrt(R_var), _NAN)
    first = R_c[:, 0]
    last = M.take(R_c, torch.clamp(n_val - 1, min=0))
    feats["R_bb_rel_change"] = torch.where(ok2, (last - first) / (first + 1e-10), _NAN)

    T_mu = M.mean(T_fit, valid_e)
    T_var = M.var(T_fit, valid_e, 0)
    feats["T_variance"] = torch.where(ok2, T_var, _NAN)
    feats["T_std"] = torch.where(ok2, torch.sqrt(T_var), _NAN)
    feats["T_range"] = torch.where(ok2, M.mmax(T_fit, valid_e) - M.mmin(T_fit, valid_e), _NAN)

    def t_pair(a, b, drop_name, ratio_name):
        okt = ok2 & ~torch.isnan(a) & ~torch.isnan(b)
        feats[drop_name] = torch.where(okt, a - b, _NAN)
        feats[ratio_name] = torch.where(okt, a / (b + 1.0), _NAN)

    t_pair(T_fit[:, 0], T_fit[:, 4], "T_drop_peak_50d", "T_ratio_peak_50d")
    t_pair(T_fit[:, 0], T_fit[:, 5], "T_drop_peak_100d", "T_ratio_peak_100d")

    feats["dTdt"] = torch.where(ok2, nanfit(T_fit, valid_e), _NAN)
    t_var_norm = T_var / (T_mu ** 2 + 1.0)
    feats["T_constancy"] = torch.where(ok2, 1.0 / (t_var_norm + 0.01), _NAN)
    feats["R_direction_score"] = torch.where(ok2, s_all / (R_mu + 1e-10), _NAN)
    return feats
