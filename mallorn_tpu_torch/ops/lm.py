"""Batched bounded nonlinear least squares, Levenberg-Marquardt (port of
``mallorn_tpu.ops.lm``).

Every (lane, start) pair is one element of a batch:

- box constraints by the sigmoid reparametrisation
  theta = lb + (ub - lb) * sigmoid(u), so the solver is unconstrained in u;
- per iteration: Jacobian, P x P normal equations, an unrolled P x P
  Cholesky solve, Marquardt lambda accept/reject;
- the JAX package runs one ``while_loop`` per element under ``vmap``: all
  elements iterate until the last one stops, and stopped elements are
  frozen. Here a ``done`` mask over the batch does the same: an element
  stops after STALL consecutive accepted steps that improve the cost by
  <= FTOL relative, once lambda passes 1e10, or at ``n_iters``.

The model supplies its own Jacobian (``model_fn(t, theta, with_jac=True)``
returns the value and d value / d theta); the port needs no autodiff here.
``d_max`` / ``d_min`` / ``d_clip`` are the clamps' derivatives as the JAX
package's ``jax.jacfwd`` takes them (1/2 at a tie), for the models to use.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

FTOL, STALL = 1e-9, 3


def d_max(x, lo):
    """d max(x, lo) / d x as JAX's JVP gives it: 1 above ``lo``, 0 below,
    1/2 at a tie (``jnp.maximum``, and ``jnp.clip``, which is built of it)."""
    return torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0)).to(x.dtype)


def d_min(x, hi):
    """d min(x, hi) / d x: 1 below ``hi``, 0 above, 1/2 at a tie."""
    return torch.where(x < hi, 1.0, torch.where(x == hi, 0.5, 0.0)).to(x.dtype)


def d_clip(x, lo, hi):
    """d clip(x, lo, hi) / d x of ``jnp.clip`` = min(max(x, lo), hi)."""
    return d_max(x, lo) * d_min(torch.clamp(x, min=lo), hi)


class LMResult(NamedTuple):
    theta: torch.Tensor  # [L, P]
    cost: torch.Tensor  # [L]
    valid: torch.Tensor  # [L] bool


def chol_solve_small(A, b):
    """Solve SPD ``A x = b`` for a small static P by a fully unrolled
    Cholesky (A [..., P, P], b [..., P]); pivots floored at 1e-30."""
    P = A.shape[-1]
    L = [[None] * P for _ in range(P)]
    for i in range(P):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    z = [None] * P
    for i in range(P):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s / L[i][i]
    x = [None] * P
    for i in reversed(range(P)):
        s = z[i]
        for k in range(i + 1, P):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def lm_fit_batched(model_fn: Callable, t, y, sigma, mask, theta0, lb, ub,
                   n_iters: int = 80, lambda0: float = 1e-3) -> LMResult:
    """Fit ``model_fn`` on every lane; the lowest-cost start wins.

    t/y/sigma/mask: [L, T]; theta0: [L, P] or [S, L, P]; lb/ub: [L, P].
    ``model_fn(t [..., T], theta [..., P], with_jac)`` -> f [..., T] (and
    df/dtheta [..., T, P] when ``with_jac``)."""
    if theta0.dim() == 2:
        theta0 = theta0[None]
    theta0 = theta0.transpose(0, 1)  # [L, S, P]
    lb_, ub_ = lb[:, None, :], ub[:, None, :]
    span = ub_ - lb_
    mk = mask[:, None, :]  # [L, 1, T]
    t_safe = torch.where(mask, t, 0.0)[:, None, :]
    sig = torch.where(sigma > 0, sigma, 1.0)[:, None, :]
    y_ = y[:, None, :]

    def resid(u, with_jac=False):
        s = torch.sigmoid(u)
        theta = lb_ + span * s
        if not with_jac:
            f = model_fn(t_safe, theta, False)
            return torch.where(mk, (f - y_) / sig, 0.0)
        f, df = model_fn(t_safe, theta, True)
        r = torch.where(mk, (f - y_) / sig, 0.0)
        J = df * (span * s * (1.0 - s)).unsqueeze(-2) / sig.unsqueeze(-1)
        return r, torch.where(mk.unsqueeze(-1), J, 0.0)

    def cost_of(u):
        r = resid(u)
        return (r * r).sum(dim=-1)

    frac = torch.clamp((theta0 - lb_) / torch.where(span > 0, span, 1.0), 0.02, 0.98)
    u = torch.log(frac / (1.0 - frac))
    c = cost_of(u)
    lam = torch.full_like(c, lambda0)
    stall = torch.zeros_like(c, dtype=torch.int32)
    P = u.shape[-1]
    eye = torch.eye(P, dtype=u.dtype, device=u.device)

    for _ in range(n_iters):
        active = (stall < STALL) & (lam < 1e10)
        if not bool(active.any()):
            break
        r, J = resid(u, with_jac=True)
        g = torch.einsum("...tp,...t->...p", J, r)
        H = torch.einsum("...tp,...tq->...pq", J, J)
        d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-10)
        delta = chol_solve_small(H + lam[..., None, None] * (d[..., None] * eye), -g)
        trial = torch.clamp(u + delta, -30.0, 30.0)
        c_trial = cost_of(trial)
        ok = torch.isfinite(c_trial) & (c_trial < c) & active
        improved = ok & (c - c_trial > FTOL * (c + 1e-30))
        u = torch.where(ok[..., None], trial, u)
        lam = torch.where(active, torch.where(ok, torch.clamp(lam / 3.0, min=1e-12),
                                              torch.clamp(lam * 3.0, max=1e12)), lam)
        c = torch.where(ok, c_trial, c)
        stall = torch.where(improved, 0, torch.where(ok, stall + 1, stall))

    best = torch.argmin(torch.where(torch.isfinite(c), c, torch.inf), dim=1)  # [L]
    u_best = torch.gather(u, 1, best[:, None, None].expand(-1, 1, P))[:, 0]
    theta = lb + (ub - lb) * torch.sigmoid(u_best)
    c_best = torch.gather(c, 1, best[:, None])[:, 0]
    valid = torch.isfinite(c_best) & torch.isfinite(theta).all(dim=1)
    return LMResult(theta=theta, cost=c_best, valid=valid)
