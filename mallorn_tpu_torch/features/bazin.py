"""Bazin parametric lightcurve fits, all objects x 6 bands at once (port of
``mallorn_tpu.features.bazin``).

f(t) = A exp(-(t-t0)/tau_fall) / (1 + exp(-(t-t0)/tau_rise)) + B

Init, bounds, weights, clipping, chi^2 and the cross-band features match
the JAX package:

- init A = f_peak - median, t0 = t_peak, B = median, tau_rise = 0.2 dur,
  tau_fall = 0.3 dur; bounds A [0, 3 max], t0 [t_first, t_last],
  tau [0.1, dur], B [-max, 2 max]; sigma = err if err > 0 else 1;
- NaN row when n < 5 or the box is infeasible;
- A, B clipped to +-1e6, tau to [0.1, 1e4], reduced chi^2 to [0, 1e6];
- 4 multi-starts through ``ops.lm.lm_fit_batched`` at the shipped
  iteration cap of 40.
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.data.packing import PackedLightcurves
from mallorn_tpu_torch.features.base import FeatureSet, sorted_features
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.ops.lm import lm_fit_batched
from mallorn_tpu_torch.utils.constants import LSST_BANDS, N_BANDS

_NAN = float("nan")

PARAM_NAMES = ("bazin_A", "bazin_t0", "bazin_tau_rise", "bazin_tau_fall",
               "bazin_B")
FEATURE_NAMES = PARAM_NAMES + ("bazin_fit_chi2", "bazin_rise_fall_ratio",
                               "bazin_peak_flux")


def bazin_model(t, theta, with_jac: bool = False):
    """Stable Bazin evaluation (sigmoid form) for ``theta [..., 5]``
    broadcast against ``t [..., T]``; with ``with_jac`` also the analytic
    d f / d theta [..., T, 5] (the exponent clip has zero derivative
    outside (-60, 60), as the JAX package's autodiff gives)."""
    A, t0, tau_rise, tau_fall, B = (theta[..., k:k + 1] for k in range(5))
    dt = t - t0
    x = -dt / tau_fall
    decay = torch.exp(torch.clamp(x, -60.0, 60.0))
    rise = torch.sigmoid(dt / tau_rise)
    f = A * decay * rise + B
    if not with_jac:
        return f
    inside = ((x > -60.0) & (x < 60.0)).to(f.dtype)
    drise = rise * (1.0 - rise)  # d rise / d (dt / tau_rise)
    d_A = decay * rise
    d_t0 = -A * (decay * inside * (-1.0 / tau_fall) * rise
                 + decay * drise / tau_rise)
    d_tr = A * decay * drise * (-dt / (tau_rise * tau_rise))
    d_tf = A * rise * decay * inside * (dt / (tau_fall * tau_fall))
    d_B = torch.ones_like(f)
    return f, torch.stack([d_A, d_t0, d_tr, d_tf, d_B], dim=-1)


def _setup(t, f, mask):
    """Per-lane init / bounds / feasibility on [L, T] lanes (L = N * 6)."""
    n = M.count(mask)
    peak_idx = M.argmax(f, mask)
    t_peak = M.take(t, peak_idx)
    f_peak = M.take(f, peak_idx)
    med = M.median(f, mask)
    t_first = M.mmin(t, mask)
    t_last = M.mmax(t, mask)
    duration = t_last - t_first
    max_flux = M.mmax(f, mask)

    theta0 = torch.stack([f_peak - med, t_peak, duration * 0.2,
                          duration * 0.3, med], dim=1)
    lb = torch.stack([torch.zeros_like(med), t_first,
                      torch.full_like(med, 0.1), torch.full_like(med, 0.1),
                      -max_flux], dim=1)
    ub = torch.stack([3.0 * max_flux, t_last, duration, duration,
                      2.0 * max_flux], dim=1)
    # scipy's curve_fit raises (a NaN row in the reference) when lb >= ub
    # anywhere or p0 lies outside the box
    feasible = (ub > lb).all(dim=1) & ((theta0 >= lb) & (theta0 <= ub)).all(dim=1)
    return theta0, lb, ub, feasible & (n >= 5), n


def fit_all_bands(packed: PackedLightcurves, n_iters: int = 60,
                  n_starts: int = 4):
    """Batched fit; a dict of [N, 6] tensors per feature name."""
    N = packed.n_objects
    T = packed.band_time.shape[-1]
    t = packed.band_time.reshape(N * N_BANDS, T)
    f = packed.band_flux.reshape(N * N_BANDS, T)
    e = packed.band_err.reshape(N * N_BANDS, T)
    mask = packed.band_mask.reshape(N * N_BANDS, T)

    theta0, lb, ub, feasible, n = _setup(t, f, mask)

    # starts, by measured marginal value: peak-anchored, fast-transient,
    # early-peak/slow-fall, mid-amplitude
    dur = ub[:, 1] - lb[:, 1]
    s2 = theta0.clone()
    s2[:, 1] = lb[:, 1] + 0.25 * dur
    s2[:, 2] = torch.clamp(0.05 * dur, min=0.1)
    s2[:, 3] = torch.clamp(0.6 * dur, min=0.1)
    s3 = theta0.clone()
    s3[:, 2] = torch.clamp(0.02 * dur, min=0.1)
    s3[:, 3] = torch.clamp(0.1 * dur, min=0.1)
    s4 = theta0.clone()
    s4[:, 0] = 0.5 * (lb[:, 0] + ub[:, 0])
    s4[:, 4] = 0.0
    starts = torch.stack([theta0, s3, s2, s4][:n_starts])  # [S, L, P]

    res = lm_fit_batched(bazin_model, t, f, e, mask, starts, lb, ub,
                         n_iters=n_iters)

    ok = feasible & res.valid
    A = torch.clamp(res.theta[:, 0], -1e6, 1e6)
    t0 = res.theta[:, 1]
    tau_rise = torch.clamp(res.theta[:, 2], 0.1, 1e4)
    tau_fall = torch.clamp(res.theta[:, 3], 0.1, 1e4)
    B = torch.clamp(res.theta[:, 4], -1e6, 1e6)

    # reduced chi^2 with the clipped params
    sig = torch.where(e > 0, e, 1.0)
    fitted = bazin_model(t, torch.stack([A, t0, tau_rise, tau_fall, B], dim=1))
    r = torch.where(mask, (f - fitted) / sig, 0.0)
    chi2 = (r * r).sum(dim=-1)
    red_chi2 = torch.clamp(chi2 / (n - 5).clamp(min=1), 0.0, 1e6)

    def keep(x):
        return torch.where(ok, x, _NAN)

    out = {
        "bazin_A": keep(A),
        "bazin_t0": keep(t0 + packed.time_offset),
        "bazin_tau_rise": keep(tau_rise),
        "bazin_tau_fall": keep(tau_fall),
        "bazin_B": keep(B),
        "bazin_fit_chi2": keep(red_chi2),
        "bazin_rise_fall_ratio": keep(torch.clamp(tau_rise / (tau_fall + 1e-6), 0.0, 100.0)),
        "bazin_peak_flux": keep(torch.clamp(A + B, -1e6, 1e6)),
    }
    return {k: v.reshape(N, N_BANDS) for k, v in out.items()}


def _nanstd_mean_ratio(vals):
    """std/mean over non-NaN entries along axis 1; NaN when < 2 valid."""
    m = ~torch.isnan(vals)
    n = m.sum(dim=1)
    mu = torch.where(m, vals, 0.0).sum(dim=1) / n.clamp(min=1)
    var = torch.where(m, (vals - mu[:, None]) ** 2, 0.0).sum(dim=1) / n.clamp(min=1)
    return torch.where(n >= 2, torch.sqrt(var) / mu, _NAN)


def extract(packed: PackedLightcurves, meta=None, n_iters: int = 40,
            n_starts: int = 4) -> FeatureSet:
    per_band = fit_all_bands(packed, n_iters=n_iters, n_starts=n_starts)

    feats: FeatureSet = {}
    for bi, band in enumerate(LSST_BANDS):
        for name in FEATURE_NAMES:
            feats[f"{band}_{name}"] = per_band[name][:, bi]

    feats["bazin_rise_consistency"] = _nanstd_mean_ratio(per_band["bazin_tau_rise"][:, 1:4])
    feats["bazin_fall_consistency"] = _nanstd_mean_ratio(per_band["bazin_tau_fall"][:, 1:4])

    chi2 = per_band["bazin_fit_chi2"]  # [N, 6]
    m = ~torch.isnan(chi2)
    n = m.sum(dim=1)
    mu = torch.where(m, chi2, 0.0).sum(dim=1) / n.clamp(min=1)
    var = torch.where(m, (chi2 - mu[:, None]) ** 2, 0.0).sum(dim=1) / n.clamp(min=1)
    feats["bazin_avg_fit_chi2"] = torch.where(n > 0, mu, _NAN)
    feats["bazin_fit_quality_dispersion"] = torch.where(n > 0, torch.sqrt(var), _NAN)
    return sorted_features(feats)
