"""v37a TDE parametric model fits: hybrid, Guillochon and piecewise (port
of ``mallorn_tpu.features.tde_models``).

Model forms, theta = (A, t0, tau_rise, tau_fall[, alpha], B), dt = t - t0:

- hybrid: A sigmoid(dt / tr) exp(clip(-dt / tf, -60, 60))
  [dt > 0] (1 + dt / tf)^(-alpha) + B;
- guillochon: A min([t_n > 0] (t_n / 3 tr)_+^0.4, 1) exp(clip(-dt / tf))
  + B with t_n = t - (t0 - 3 tr) (no alpha);
- piecewise: A clip((t - t0 + tr) / tr, 0, 1) [dt > 0] (1 + dt / tf)^(-alpha)
  + B.

Each model returns its analytic d f / d theta for ``ops.lm``; where a
``where`` hides a branch that would be infinite (``base ** 0.4`` at base
0, a power at dt <= 0), the derivative is taken behind the same guard.
``_fit_lanes`` keeps the JAX package's semantics: n >= 6, the init from
the peak, the sub-40th-percentile baseline and the half-light decay, the
data-scaled A / B bounds, three starts (the init, a slow fall, a fast
rise), chi^2 from the unclipped parameters, clipped reported parameters;
``extract`` adds the cross-band alpha / tau consistency.
"""

from __future__ import annotations

import math

import torch

from mallorn_tpu_torch.data.packing import PackedLightcurves
from mallorn_tpu_torch.features.base import FeatureSet
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.ops.lm import d_clip, d_max, d_min, lm_fit_batched
from mallorn_tpu_torch.utils.constants import LSST_BANDS, N_BANDS

_NAN = float("nan")

KEYS = ("tde_A", "tde_t0", "tde_tau_rise", "tde_tau_fall", "tde_alpha",
        "tde_B", "tde_fit_chi2", "tde_alpha_value", "tde_peak_flux")


def _power_decay(dt, tf, alpha, with_jac: bool):
    """[dt > 0] (1 + max(dt, 0) / tf)^(-alpha) (1 where dt <= 0), and with
    ``with_jac`` its derivatives by dt, tf and alpha (0 where dt <= 0)."""
    m = torch.clamp(dt, min=0.0)
    base = 1.0 + m / tf
    pw = base ** (-alpha)
    pos = dt > 0
    pl = torch.where(pos, pw, 1.0)
    if not with_jac:
        return pl, None
    d_base = torch.where(pos, -alpha * base ** (-alpha - 1.0), 0.0)
    d_dt = d_base * d_max(dt, 0.0) / tf
    d_tf = d_base * (-m / (tf * tf))
    d_alpha = torch.where(pos, -torch.log(base) * pw, 0.0)
    return pl, (d_dt, d_tf, d_alpha)


def _decay(dt, tf, with_jac: bool):
    """exp(clip(-dt / tf, -60, 60)) and its derivatives by dt and tf."""
    x = -dt / tf
    decay = torch.exp(torch.clamp(x, -60.0, 60.0))
    if not with_jac:
        return decay, None
    dx = decay * d_clip(x, -60.0, 60.0)
    return decay, (dx * (-1.0 / tf), dx * (dt / (tf * tf)))


def hybrid_model(t, theta, with_jac: bool = False):
    A, t0, tr, tf, alpha, B = (theta[..., k:k + 1] for k in range(6))
    dt = t - t0
    rise = torch.sigmoid(dt / tr)
    decay, dd = _decay(dt, tf, with_jac)
    pl, dp = _power_decay(dt, tf, alpha, with_jac)
    f = A * rise * decay * pl + B
    if not with_jac:
        return f
    rp = rise * (1.0 - rise)
    d_rise_dt = rp / tr
    # d / d dt of rise decay pl; dt = t - t0, so d / d t0 is its negative
    d_dt = d_rise_dt * decay * pl + rise * dd[0] * pl + rise * decay * dp[0]
    d_A = rise * decay * pl
    d_t0 = -A * d_dt
    d_tr = A * (rp * (-dt / (tr * tr))) * decay * pl
    d_tf = A * rise * (dd[1] * pl + decay * dp[1])
    d_alpha = A * rise * decay * dp[2]
    return f, torch.stack([d_A, d_t0, d_tr, d_tf, d_alpha, torch.ones_like(f)], dim=-1)


def guillochon_model(t, theta, with_jac: bool = False):
    A, t0, tr, tf, B = (theta[..., k:k + 1] for k in range(5))
    t_norm = t - (t0 - 3.0 * tr)
    q = t_norm / (3.0 * tr)
    base = torch.clamp(q, min=0.0)
    pos = t_norm > 0
    rise0 = torch.where(pos, base ** 0.4, 0.0)
    rise = torch.clamp(rise0, max=1.0)
    dt = t - t0
    decay, dd = _decay(dt, tf, with_jac)
    f = A * rise * decay + B
    if not with_jac:
        return f
    # d rise / d q, behind the guard (base ** -0.6 is infinite at base 0)
    safe = torch.where(pos, base, 1.0)
    d_q = d_min(rise0, 1.0) * torch.where(pos, 0.4 * safe ** -0.6, 0.0) * d_max(q, 0.0)
    three_tr = 3.0 * tr
    dq_dt0 = -1.0 / three_tr
    dq_dtr = 3.0 / three_tr - t_norm * 3.0 / (three_tr * three_tr)
    d_A = rise * decay
    d_t0 = A * (d_q * dq_dt0 * decay - rise * dd[0])
    d_tr = A * d_q * dq_dtr * decay
    d_tf = A * rise * dd[1]
    return f, torch.stack([d_A, d_t0, d_tr, d_tf, torch.ones_like(f)], dim=-1)


def piecewise_model(t, theta, with_jac: bool = False):
    A, t0, tr, tf, alpha, B = (theta[..., k:k + 1] for k in range(6))
    num = t - (t0 - tr)
    q = num / tr
    rise = torch.clamp(q, 0.0, 1.0)
    dt = t - t0
    pl, dp = _power_decay(dt, tf, alpha, with_jac)
    f = A * rise * pl + B
    if not with_jac:
        return f
    dr = d_clip(q, 0.0, 1.0)
    d_A = rise * pl
    d_t0 = A * (dr * (-1.0 / tr) * pl - rise * dp[0])
    d_tr = A * dr * (1.0 / tr - num / (tr * tr)) * pl
    d_tf = A * rise * dp[1]
    d_alpha = A * rise * dp[2]
    return f, torch.stack([d_A, d_t0, d_tr, d_tf, d_alpha, torch.ones_like(f)], dim=-1)


MODELS = {"hybrid": hybrid_model, "guillochon": guillochon_model,
          "piecewise": piecewise_model}


def _fit_lanes(t, f, e, mask, model_type: str, n_iters: int):
    n = M.count(mask)
    peak_idx = M.argmax(f, mask)
    t_peak = M.take(t, peak_idx)
    f_peak = M.take(f, peak_idx)
    p40 = M.quantile(f, mask, 0.40)
    low = mask & (f < p40[:, None])
    f_base = M.median(f, low)  # NaN when the sub-40% set is empty

    t_first = M.mmin(t, mask)
    t_last = M.mmax(t, mask)

    pre = mask & (t < t_peak[:, None])
    any_pre = pre.any(dim=1)
    first_pre = M.mmin(t, pre)
    tr_guess = torch.clamp(torch.where(any_pre, (t_peak - first_pre) / 2.0, 30.0), 5.0, 100.0)

    post_half = mask & (t > t_peak[:, None]) & (f < 0.5 * f_peak[:, None])
    any_half = post_half.any(dim=1)
    t_half = M.mmin(t, post_half)
    tf_guess = torch.clamp(torch.where(any_half, (t_half - t_peak) / math.log(2.0), 100.0),
                           10.0, 500.0)

    A_guess = f_peak - f_base
    # generous data-scaled stand-ins for the reference's infinite A / B bounds
    amp_hi = torch.clamp(100.0 * f_peak.abs(), min=1e4)

    zeros = torch.zeros_like(f_peak)
    ones = torch.ones_like(f_peak)
    tr_lo = 5.0 if model_type == "piecewise" else 1.0
    model = MODELS[model_type]
    if model_type == "guillochon":
        theta0 = torch.stack([A_guess, t_peak, tr_guess, tf_guess, f_base], 1)
        lb = torch.stack([zeros, t_first - 50.0, ones, 10.0 * ones, -amp_hi], 1)
        ub = torch.stack([amp_hi, t_last + 50.0, 200.0 * ones, 1000.0 * ones, amp_hi], 1)
        n_params = 5
    else:
        theta0 = torch.stack([A_guess, t_peak, tr_guess, tf_guess, 1.67 * ones, f_base], 1)
        lb = torch.stack([zeros, t_first - 50.0, tr_lo * ones, 10.0 * ones,
                          0.5 * ones, -amp_hi], 1)
        ub = torch.stack([amp_hi, t_last + 50.0, 200.0 * ones, 1000.0 * ones,
                          3.0 * ones, amp_hi], 1)
        n_params = 6

    feasible = (n >= 6) & torch.isfinite(theta0).all(dim=1) & (A_guess >= 0)

    # multi-start: the reference init, a slow-fall and a fast-rise variant
    s2 = theta0.clone()
    s2[:, 3] = torch.clamp(2.5 * tf_guess, 10.0, 1000.0)
    s3 = theta0.clone()
    s3[:, 2] = torch.clamp(0.3 * tr_guess, tr_lo, 200.0)
    res = lm_fit_batched(model, t, f, e, mask, torch.stack([theta0, s2, s3]), lb, ub,
                         n_iters=n_iters)
    ok = feasible & res.valid

    theta = res.theta
    if model_type == "guillochon":
        A, t0, tr, tf, B = theta.unbind(1)
        alpha = torch.full_like(A, 1.67)
    else:
        A, t0, tr, tf, alpha, B = theta.unbind(1)

    # chi2 from the UNclipped parameters
    sig = torch.where(e > 0, e, 1.0)
    pred = model(t, theta)
    r = torch.where(mask, (f - pred) / sig, 0.0)
    chi2 = (r * r).sum(dim=1)
    red_chi2 = torch.clamp(chi2 / torch.clamp(n - n_params, min=1), 0.0, 1e6)

    A_c = torch.clamp(A, -1e6, 1e6)
    t0_c = torch.minimum(torch.maximum(t0, t_first - 100.0), t_last + 100.0)
    tr_c = torch.clamp(tr, 0.1, 300.0)
    tf_c = torch.clamp(tf, 1.0, 2000.0)
    al_c = torch.clamp(alpha, 0.1, 5.0)
    B_c = torch.clamp(B, -1e6, 1e6)

    def keep(x):
        return torch.where(ok, x, _NAN)

    return {
        "tde_A": keep(A_c),
        "tde_t0": keep(t0_c),
        "tde_tau_rise": keep(tr_c),
        "tde_tau_fall": keep(tf_c),
        "tde_alpha": keep(al_c),
        "tde_B": keep(B_c),
        "tde_fit_chi2": keep(red_chi2),
        "tde_alpha_value": keep(al_c),
        "tde_peak_flux": keep(torch.clamp(A_c + B_c, -1e6, 1e6)),
    }


def _nan_cross(vals):
    """(mean, population std, count) over each row's non-NaN entries."""
    m = ~torch.isnan(vals)
    n = m.sum(dim=1)
    mu = torch.where(m, vals, 0.0).sum(dim=1) / n.clamp(min=1)
    var = torch.where(m, (vals - mu[:, None]) ** 2, 0.0).sum(dim=1) / n.clamp(min=1)
    return mu, torch.sqrt(var), n


def extract(packed: PackedLightcurves, meta=None, model_type: str = "hybrid",
            n_iters: int = 60) -> FeatureSet:
    N = packed.n_objects
    T = packed.band_time.shape[-1]
    t = packed.band_time.reshape(N * N_BANDS, T)
    f = packed.band_flux.reshape(N * N_BANDS, T)
    e = packed.band_err.reshape(N * N_BANDS, T)
    mask = packed.band_mask.reshape(N * N_BANDS, T)

    lanes = _fit_lanes(t, f, e, mask, model_type, n_iters)
    per_band = {k: v.reshape(N, N_BANDS) for k, v in lanes.items()}

    feats: FeatureSet = {}
    for bi, band in enumerate(LSST_BANDS):
        for key in KEYS:
            val = per_band[key][:, bi]
            if key == "tde_t0":
                val = val + packed.time_offset
            feats[f"{band}_{key}"] = val

    alpha = per_band["tde_alpha"]
    has_alpha = ~torch.isnan(alpha)
    mu_a, sd_a, n_a = _nan_cross(alpha)
    abs_mu = torch.where(has_alpha, alpha.abs(), 0.0).sum(dim=1) / n_a.clamp(min=1)
    two = n_a >= 2
    feats["tde_alpha_consistency"] = torch.where(two, sd_a / abs_mu, _NAN)
    feats["tde_mean_alpha"] = torch.where(two, mu_a, _NAN)
    feats["tde_alpha_deviation"] = torch.where(two, (mu_a - 1.67).abs(), _NAN)

    for key, name in (("tde_tau_fall", "tde_tau_fall_consistency"),
                      ("tde_tau_rise", "tde_tau_rise_consistency")):
        # over the bands whose alpha is finite only
        mu, sd, n = _nan_cross(torch.where(has_alpha, per_band[key], _NAN))
        feats[name] = torch.where(n >= 2, sd / mu, _NAN)

    mu_c, sd_c, n_c = _nan_cross(torch.where(has_alpha, per_band["tde_fit_chi2"], _NAN))
    feats["tde_avg_fit_chi2"] = torch.where(n_c > 0, mu_c, _NAN)
    feats["tde_fit_quality_dispersion"] = torch.where(n_c > 0, sd_c, _NAN)
    return feats
