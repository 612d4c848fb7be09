"""v55 decline-model features: R^2 of 9 parametric decay models per band
(port of ``mallorn_tpu.features.powerlaw``).

Models, fitted to post-peak data with t relative to the peak:

- powerlaw_p:  A max(t - t0, 0.1)^(-p), p in {5/3, 1, 1.5, 2, 2.5, 3, 0.5};
- exponential: A exp(-max(t - t0, 0) / tau);
- linear:      A - b max(t - t0, 0).

Each is one ``ops.lm.lm_fit_batched`` solve over N x 3 optical-band lanes
(g, r, i), with its analytic d f / d theta. Guards: fewer than 5 points in
the band or fewer than 3 after the peak, an infeasible p0 (a peak flux
outside [0, 1e6]) or a non-finite fit -> NaN. Feature = R^2 =
1 - ss_res / ss_tot (0 when ss_tot == 0); the fits are unweighted.
Columns come in the JAX package's order (band, then model).
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.data.packing import PackedLightcurves
from mallorn_tpu_torch.features.base import FeatureSet
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.ops.lm import d_max, lm_fit_batched

_NAN = float("nan")

BANDS = ((1, "g"), (2, "r"), (3, "i"))

POWERS = {"powerlaw_5_3": 5.0 / 3.0, "powerlaw_1": 1.0, "powerlaw_1_5": 1.5,
          "powerlaw_2": 2.0, "powerlaw_2_5": 2.5, "powerlaw_3": 3.0,
          "powerlaw_0_5": 0.5}
MODEL_NAMES = tuple(POWERS) + ("exponential", "linear")


def make_power_model(p: float):
    """A max(t - t0, 0.1)^(-p) for theta [..., 2] = (A, t0)."""
    def model(t, theta, with_jac: bool = False):
        A, t0 = theta[..., 0:1], theta[..., 1:2]
        x = t - t0
        base = torch.clamp(x, min=0.1)
        pw = torch.pow(base, -p)
        f = A * pw
        if not with_jac:
            return f
        d_t0 = A * (-p) * torch.pow(base, -p - 1.0) * d_max(x, 0.1) * -1.0
        return f, torch.stack([pw, d_t0], dim=-1)
    return model


def exp_model(t, theta, with_jac: bool = False):
    """A exp(-max(t - t0, 0) / tau) for theta [..., 3] = (A, tau, t0)."""
    A, tau, t0 = (theta[..., k:k + 1] for k in range(3))
    x = t - t0
    m = torch.clamp(x, min=0.0)
    e = torch.exp(-m / tau)
    f = A * e
    if not with_jac:
        return f
    d_tau = A * e * (m / (tau * tau))
    d_t0 = A * e * (d_max(x, 0.0) / tau)
    return f, torch.stack([e, d_tau, d_t0], dim=-1)


def linear_model(t, theta, with_jac: bool = False):
    """A - b max(t - t0, 0) for theta [..., 3] = (A, b, t0)."""
    A, b, t0 = (theta[..., k:k + 1] for k in range(3))
    x = t - t0
    m = torch.clamp(x, min=0.0)
    f = A - b * m
    if not with_jac:
        return f
    return f, torch.stack([torch.ones_like(f), -m, b * d_max(x, 0.0)], dim=-1)


def extract(packed: PackedLightcurves, meta=None, n_iters: int = 60) -> FeatureSet:
    N = packed.n_objects
    T = packed.band_time.shape[-1]

    # lanes = N x 3 optical bands
    t = packed.band_time[:, 1:4].reshape(N * 3, T)
    f = packed.band_flux[:, 1:4].reshape(N * 3, T)
    mask = packed.band_mask[:, 1:4].reshape(N * 3, T)

    n = M.count(mask)
    peak_idx = M.argmax(f, mask)
    pt = M.take(t, peak_idx)
    pf = M.take(f, peak_idx)

    post = mask & (t > pt[:, None])
    n_post = post.sum(dim=1)
    guard = (n >= 5) & (n_post >= 3)

    tp = torch.where(post, t - pt[:, None], 0.0)  # t_post
    fp = torch.where(post, f, 0.0)
    sigma = torch.ones_like(fp)

    ss_tot = torch.where(post, (f - M.mean(f, post)[:, None]) ** 2, 0.0).sum(dim=1)
    ones = torch.ones_like(pf)
    zeros = torch.zeros_like(pf)
    feasible = (pf >= 0) & (pf <= 1e6)

    def r2_of(model, theta0, lb, ub):
        res = lm_fit_batched(model, tp, fp, sigma, post, theta0, lb, ub, n_iters=n_iters)
        pred = torch.where(post, model(tp, res.theta), 0.0)
        ss_res = torch.where(post, (fp - pred) ** 2, 0.0).sum(dim=1)
        r2 = torch.where(ss_tot > 0, 1.0 - ss_res / torch.where(ss_tot > 0, ss_tot, 1.0), 0.0)
        return torch.where(guard & feasible & res.valid, r2, _NAN)

    results = {}
    # 2-parameter power laws: p0 = [peak flux, 0], bounds ([0, -10], [1e6, 10])
    theta0_2 = torch.stack([pf, zeros], 1)
    lb_2 = torch.stack([zeros, -10.0 * ones], 1)
    ub_2 = torch.stack([1e6 * ones, 10.0 * ones], 1)
    for name, p in POWERS.items():
        results[name] = r2_of(make_power_model(p), theta0_2, lb_2, ub_2)
    # exponential: p0 = [peak, 30, 0], bounds ([0, 1, -10], [1e6, 500, 10])
    results["exponential"] = r2_of(
        exp_model, torch.stack([pf, 30.0 * ones, zeros], 1),
        torch.stack([zeros, ones, -10.0 * ones], 1),
        torch.stack([1e6 * ones, 500.0 * ones, 10.0 * ones], 1))
    # linear: p0 = [peak, 1, 0], bounds ([0, 0, -10], [1e6, 100, 10])
    results["linear"] = r2_of(
        linear_model, torch.stack([pf, ones, zeros], 1),
        torch.stack([zeros, zeros, -10.0 * ones], 1),
        torch.stack([1e6 * ones, 100.0 * ones, 10.0 * ones], 1))

    feats: FeatureSet = {}
    for pi, (_, bname) in enumerate(BANDS):
        for mname in MODEL_NAMES:
            feats[f"{bname}_{mname}_r2"] = results[mname].reshape(N, 3)[:, pi]
    return feats
