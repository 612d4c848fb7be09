"""Batched 2D Gaussian-process machinery (port of ``mallorn_tpu.ops.gp``).

Matern-3/2 kernel over (time, wavelength) with george's parametrisation
``p = (mean, log_amp, log_lt2, log_lw2)``:

  k(x, x') = amp (1 + sqrt(3) r) exp(-sqrt(3) r),  r^2 = dt^2/l_t^2 + dl^2/l_w^2

plus observational noise on the diagonal; padded points are identity
rows. Every object is one lane of a [N, T, T] batch, and every Cholesky
in here is the fused Cholesky-inverse of ``ops.chol_cuda`` (the Hopper
kernel on a CUDA tensor): the Adam steps' NLL and analytic gradient, the
final NLL, and the posterior mean. The JAX package left the final NLL and
the prediction to XLA's Cholesky; here ``K^-1 r = Linv^T (Linv r)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mallorn_tpu_torch.ops.chol_cuda import chol_inv, cho_solve

_JITTER = 1e-6
_SQRT3 = 1.7320508075688772
_LOG_2PI = math.log(2.0 * math.pi)


class GPFit(NamedTuple):
    params: torch.Tensor  # [N, 4] (mean, log_amp, log_lt2, log_lw2)
    log_likelihood: torch.Tensor  # [N]
    valid: torch.Tensor  # [N] bool


def _masked_kernel(params, dt2, dl2, mask, yerr, scaled_by_inverse: bool):
    """(K0 without noise, K with noise + identity on padded rows, amp,
    exp(-s), 1/l_t^2, 1/l_w^2) for a [N, T, T] batch."""
    log_amp, log_lt2, log_lw2 = params[:, 1], params[:, 2], params[:, 3]
    amp = torch.exp(log_amp)[:, None, None]
    if scaled_by_inverse:  # the lanes gradient's form
        ilt2 = torch.exp(-log_lt2)[:, None, None]
        ilw2 = torch.exp(-log_lw2)[:, None, None]
        r = torch.sqrt(dt2 * ilt2 + dl2 * ilw2 + 1e-30)
    else:  # the per-lane NLL's form
        ilt2 = ilw2 = None
        r = torch.sqrt(dt2 / torch.exp(log_lt2)[:, None, None]
                       + dl2 / torch.exp(log_lw2)[:, None, None] + 1e-30)
    s = _SQRT3 * r
    es = torch.exp(-s)
    mm = mask[:, :, None] & mask[:, None, :]
    K0 = torch.where(mm, amp * (1.0 + s) * es, 0.0)
    diag = torch.where(mask, yerr ** 2 + _JITTER, 1.0)
    K = K0 + torch.diag_embed(diag)
    return K0, K.contiguous(), amp, es, mm, ilt2, ilw2


def batched_nll_grad(params, dt2, dl2, y, yerr, mask):
    """Batched NLL [N] and analytic gradient [N, 4] (port of
    ``_batched_nll_grad_lanes``).

    dNLL/dtheta = 0.5 [tr(K^-1 dK) - a^T dK a], a = K^-1 r, with
    K^-1 = Linv^T Linv from the fused kernel; the two batched products go
    to ``torch.matmul`` in full float32 (TF32 off), as the JAX package
    left them to XLA at HIGHEST precision.
    """
    K0, K, amp, es, mm, ilt2, ilw2 = _masked_kernel(params, dt2, dl2, mask,
                                                    yerr, True)
    Linv, logdet = chol_inv(K)
    Kinv = torch.matmul(Linv.transpose(1, 2), Linv)
    resid = torch.where(mask, y - params[:, 0:1], 0.0)
    alpha = torch.matmul(Kinv, resid.unsqueeze(-1)).squeeze(-1)
    n = mask.sum(dim=1)
    nll = 0.5 * ((resid * alpha).sum(dim=1) + logdet + n * _LOG_2PI)

    W = Kinv - alpha[:, :, None] * alpha[:, None, :]
    g = torch.stack([
        -torch.where(mask, alpha, 0.0).sum(dim=1),
        0.5 * (W * K0).sum(dim=(1, 2)),
        0.5 * (W * torch.where(mm, 1.5 * amp * es * (dt2 * ilt2), 0.0)).sum(dim=(1, 2)),
        0.5 * (W * torch.where(mm, 1.5 * amp * es * (dl2 * ilw2), 0.0)).sum(dim=(1, 2)),
    ], dim=1)
    return nll, g


def batched_nll(params, dt2, dl2, y, yerr, mask):
    """NLL [N] at ``params`` (port of ``_nll_pre`` over the batch)."""
    _, K, *_ = _masked_kernel(params, dt2, dl2, mask, yerr, False)
    Linv, logdet = chol_inv(K)
    rr = torch.where(mask, y - params[:, 0:1], 0.0)
    alpha = cho_solve(Linv, rr)
    n = mask.sum(dim=1)
    return 0.5 * ((rr * alpha).sum(dim=1) + logdet + n * _LOG_2PI)


def fit_gp_batched(t, lam, y, yerr, mask, init_time_scale: float = 100.0,
                   init_wave_scale: float = 6000.0, n_steps: int = 100,
                   lr: float = 0.5, lr_final: float = 0.02,
                   params0: Optional[torch.Tensor] = None) -> GPFit:
    """Optimise every lane's hyperparameters with batched Adam.

    Cosine lr from ``lr`` to ``lr_final``; non-finite gradients are
    zeroed; each lane keeps the better of its initial and final params.
    Init: amp = var(y), scales 100 d / 6000 A, mean = mean(y); ``params0``
    overrides it (the phase-2 warm start).
    """
    if params0 is None:
        nf = mask.sum(dim=1).clamp(min=1).to(y.dtype)
        mu0 = torch.where(mask, y, 0.0).sum(1) / nf
        var0 = torch.where(mask, (y - mu0[:, None]) ** 2, 0.0).sum(1) / nf
        params0 = torch.stack([
            mu0,
            torch.log(torch.clamp(var0, min=1e-8)),
            torch.full_like(mu0, 2.0 * math.log(init_time_scale)),
            torch.full_like(mu0, 2.0 * math.log(init_wave_scale)),
        ], dim=1)

    dt2 = (t[:, :, None] - t[:, None, :]) ** 2
    dl2 = (lam[:, :, None] - lam[:, None, :]) ** 2

    params = params0
    m = torch.zeros_like(params0)
    v = torch.zeros_like(params0)
    init_nll = None
    for i in range(n_steps):
        lr_i = lr_final + 0.5 * (lr - lr_final) * (1.0 + math.cos(math.pi * i / n_steps))
        nll, g = batched_nll_grad(params, dt2, dl2, y, yerr, mask)
        if i == 0:
            init_nll = nll
        g = torch.where(torch.isfinite(g), g, 0.0)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1.0 - 0.9 ** (i + 1))
        vh = v / (1.0 - 0.999 ** (i + 1))
        params = params - lr_i * mh / (torch.sqrt(vh) + 1e-8)

    final_nll = batched_nll(params, dt2, dl2, y, yerr, mask)
    if init_nll is not None:
        use_init = init_nll < final_nll
        params = torch.where(use_init[:, None], params0, params)
        final_nll = torch.minimum(final_nll, init_nll)
    valid = torch.isfinite(final_nll) & torch.isfinite(params).all(dim=1)
    return GPFit(params=params, log_likelihood=-final_nll, valid=valid)


def gp_predict(params, t, lam, y, yerr, mask, t_star, lam_star) -> torch.Tensor:
    """Posterior mean at (t_star, lam_star): [N, S]."""
    dt2 = (t[:, :, None] - t[:, None, :]) ** 2
    dl2 = (lam[:, :, None] - lam[:, None, :]) ** 2
    _, K, *_ = _masked_kernel(params, dt2, dl2, mask, yerr, False)
    Linv, _ = chol_inv(K)
    mean = params[:, 0:1]
    alpha = cho_solve(Linv, torch.where(mask, y - mean, 0.0))
    log_amp, log_lt2, log_lw2 = params[:, 1:2, None], params[:, 2:3, None], params[:, 3:4, None]
    sdt2 = (t_star[:, :, None] - t[:, None, :]) ** 2
    sdl2 = (lam_star[:, :, None] - lam[:, None, :]) ** 2
    rr = torch.sqrt(sdt2 / torch.exp(log_lt2) + sdl2 / torch.exp(log_lw2) + 1e-30)
    ks = torch.exp(log_amp) * (1.0 + _SQRT3 * rr) * torch.exp(-_SQRT3 * rr)
    ks = torch.where(mask[:, None, :], ks, 0.0)
    return torch.matmul(ks, alpha.unsqueeze(-1)).squeeze(-1) + mean
