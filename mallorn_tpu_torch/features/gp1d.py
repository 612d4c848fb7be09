"""Per-band 1D GP features, v18 (port of ``mallorn_tpu.features.gp1d``).

sklearn's kernel, RBF x Constant + White, plus the observational alpha =
err^2 on the diagonal:

  k(t, t') = amp^2 exp(-(t - t')^2 / (2 l^2)) + noise^2 I,

fitted per (object, band) lane (>= 5 valid points, finite flux, err > 0)
on time normalised to [0, 1] and flux standardised by its std. The three
log-space hyperparameters (log amp^2, log l, log noise^2, clipped to
sklearn's bounds) are optimised by batched Adam over all N x 6 lanes at
once: 150 steps by default, cosine learning rate 0.5 -> 0.02, non-finite
gradients zeroed, then the final NLL; features are reported in original
units (length scale x t_range days, amplitude and noise x f_std), with
the g / r and r / i length-scale ratios and g / r / i aggregates.

Every Cholesky is K2, the fused Cholesky-inverse of ``ops.chol_cuda``
(the Hopper kernel on a CUDA tensor) at the band view's width T: each Adam
step's NLL and analytic gradient and the final NLL, 151 launches per call
at the default. The JAX package differentiates the NLL through XLA's
Cholesky with ``jax.value_and_grad``; here

  dNLL/dtheta = 0.5 sum((K^-1 - a a^T) o dK/dtheta),  a = K^-1 r,

with dK/dlog amp^2 = K0 (the masked RBF part), dK/dlog l = K0 o d^2 / l^2
and dK/dlog noise^2 = noise^2 on the used rows' diagonal. Padded rows are
identity rows with residual 0, so they add nothing to the NLL, the logdet
or the gradient. Column order is the JAX package's insertion order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mallorn_tpu_torch.data.packing import PackedLightcurves
from mallorn_tpu_torch.features.base import FeatureSet
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.ops.chol_cuda import chol_inv
from mallorn_tpu_torch.utils.constants import LSST_BANDS, N_BANDS

_NAN = float("nan")
_LOG_2PI = math.log(2.0 * math.pi)
_JITTER = 1e-8
# log-space bounds of the sklearn kernel: amp^2, l, noise^2
_LO = np.log(np.array([0.01, 0.01, 1e-5], np.float32))
_HI = np.log(np.array([100.0, 2.0, 10.0], np.float32))
_P0 = np.log(np.array([1.0, 0.2, 0.1], np.float32))


def _kernel(params, d2, alpha, mask):
    """(K0, K) of [L, T, T]: the masked RBF part and the full matrix with
    noise + alpha + jitter on the used diagonal and identity elsewhere."""
    amp2 = torch.exp(params[:, 0])[:, None, None]
    il2 = torch.exp(2.0 * params[:, 1])[:, None, None]
    mm = mask[:, :, None] & mask[:, None, :]
    K0 = torch.where(mm, amp2 * torch.exp(-0.5 * d2 / il2), 0.0)
    noise2 = torch.exp(params[:, 2])
    diag = torch.where(mask, noise2[:, None] + alpha + _JITTER, 1.0)
    return K0, (K0 + torch.diag_embed(diag)).contiguous(), il2, noise2


def nll_grad(params, d2, y, alpha, mask):
    """Batched NLL [L] and its analytic gradient [L, 3] at ``params``."""
    K0, K, il2, noise2 = _kernel(params, d2, alpha, mask)
    Linv, logdet = chol_inv(K)
    Kinv = torch.matmul(Linv.transpose(1, 2), Linv)
    r = torch.where(mask, y, 0.0)
    a = torch.matmul(Kinv, r.unsqueeze(-1)).squeeze(-1)
    n = mask.sum(dim=1)
    nll = 0.5 * ((r * a).sum(dim=1) + logdet + n * _LOG_2PI)
    W = Kinv - a[:, :, None] * a[:, None, :]
    g = torch.stack([
        0.5 * (W * K0).sum(dim=(1, 2)),
        0.5 * (W * K0 * d2 / il2).sum(dim=(1, 2)),
        0.5 * noise2 * torch.where(mask, torch.diagonal(W, dim1=1, dim2=2), 0.0).sum(dim=1),
    ], dim=1)
    return nll, g


def nll(params, d2, y, alpha, mask):
    """Batched NLL [L] at ``params``."""
    _, K, _, _ = _kernel(params, d2, alpha, mask)
    Linv, logdet = chol_inv(K)
    r = torch.where(mask, y, 0.0)
    z = torch.matmul(Linv, r.unsqueeze(-1)).squeeze(-1)
    return 0.5 * ((z * z).sum(dim=1) + logdet + mask.sum(dim=1) * _LOG_2PI)


def _schedule(n_steps: int, lr: float, lr_final: float):
    """Per step (lr_i, 1 - 0.9^(i+1), 1 - 0.999^(i+1)) in float32, as the
    JAX package's scan computes them from its int32 step counter."""
    f = np.float32
    out = []
    for i in range(n_steps):
        cos = np.cos(f(np.pi) * f(i) / f(n_steps))
        lr_i = f(lr_final) + f(0.5 * (lr - lr_final)) * (f(1.0) + cos)
        out.append((float(lr_i), float(f(1.0) - f(0.9) ** f(i + 1)),
                    float(f(1.0) - f(0.999) ** f(i + 1))))
    return out


def fit_lanes(t, y, alpha, mask, n_steps: int = 150, lr: float = 0.5,
              lr_final: float = 0.02):
    """Adam over all lanes from (log 1, log 0.2, log 0.1): (params [L, 3],
    log-likelihood [L] at the fitted params)."""
    L = t.shape[0]
    d2 = (t[:, :, None] - t[:, None, :]) ** 2
    dev = t.device
    lo, hi = torch.from_numpy(_LO).to(dev), torch.from_numpy(_HI).to(dev)
    p = torch.from_numpy(_P0).to(dev).expand(L, 3).clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for lr_i, bc1, bc2 in _schedule(n_steps, lr, lr_final):
        _, g = nll_grad(p, d2, y, alpha, mask)
        g = torch.where(torch.isfinite(g), g, 0.0)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        p = p - lr_i * (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
        p = torch.minimum(torch.maximum(p, lo), hi)
    return p, -nll(p, d2, y, alpha, mask)


def extract(packed: PackedLightcurves, meta=None, n_steps: int = 150) -> FeatureSet:
    N, _, T = packed.band_time.shape
    t = packed.band_time.reshape(N * N_BANDS, T)
    f = packed.band_flux.reshape(N * N_BANDS, T)
    e = packed.band_err.reshape(N * N_BANDS, T)
    mask = packed.band_mask.reshape(N * N_BANDS, T)

    use = mask & torch.isfinite(f) & torch.isfinite(e) & (e > 0)
    n = use.sum(dim=1)
    t0, t1 = M.mmin(t, use), M.mmax(t, use)
    t_range = t1 - t0
    ok = (n >= 5) & (t_range > 0)
    tn = torch.where(use, (t - t0[:, None]) / torch.where(t_range > 0, t_range, 1.0)[:, None],
                     0.0)
    f_mu = M.mean(f, use)
    f_sd = M.std(f, use, 0)
    f_sd = torch.where(f_sd > 0, f_sd, 1.0)
    yn = torch.where(use, (f - f_mu[:, None]) / f_sd[:, None], 0.0)
    alpha = torch.where(use, torch.clamp((e / f_sd[:, None]) ** 2, min=1e-10), 0.0)

    params, ll = fit_lanes(tn, yn, alpha, use, n_steps)
    ok = ok & torch.isfinite(ll)
    per = {
        "gp_length_scale": torch.exp(params[:, 1]) * t_range,
        "gp_amplitude": torch.sqrt(torch.exp(params[:, 0])) * f_sd,
        "gp_noise": torch.sqrt(torch.exp(params[:, 2])) * f_sd,
        "gp_log_likelihood": ll,
    }
    per = {k: torch.where(ok, v, _NAN).reshape(N, N_BANDS) for k, v in per.items()}

    feats: FeatureSet = {}
    for bi, band in enumerate(LSST_BANDS):
        for key, val in per.items():
            feats[f"{band}_{key}"] = val[:, bi]

    ls = per["gp_length_scale"]
    for b1, b2, pname in ((1, 2, "gr"), (2, 3, "ri")):
        okr = ~torch.isnan(ls[:, b1]) & ~torch.isnan(ls[:, b2]) & (ls[:, b2] > 0)
        feats[f"gp_ls_ratio_{pname}"] = torch.where(
            okr, ls[:, b1] / torch.where(okr, ls[:, b2], 1.0), _NAN)

    opt = ls[:, 1:4]
    m = ~torch.isnan(opt)
    nv = m.sum(dim=1)
    mu = torch.where(m, opt, 0.0).sum(dim=1) / nv.clamp(min=1)
    sd = torch.sqrt(torch.where(m, (opt - mu[:, None]) ** 2, 0.0).sum(dim=1) / nv.clamp(min=1))
    feats["gp_mean_length_scale"] = torch.where(nv > 0, mu, _NAN)
    feats["gp_std_length_scale"] = torch.where(nv > 0, torch.where(nv > 1, sd, 0.0), _NAN)
    av = per["gp_amplitude"][:, 1:4]
    am = ~torch.isnan(av)
    na = am.sum(dim=1)
    feats["gp_mean_amplitude"] = torch.where(
        na > 0, torch.where(am, av, 0.0).sum(dim=1) / na.clamp(min=1), _NAN)
    return feats
