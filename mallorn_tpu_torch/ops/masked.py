"""Masked reductions and order statistics over padded tensors (port of
``mallorn_tpu.ops.masked``).

Inputs are ``(x, mask)`` pairs; reductions run over the last axis, so a
leading batch axis (objects, bands, epochs) is simply carried along — the
port's replacement for the JAX package's per-object ``vmap``.

- Masked-out lanes never contribute.
- An empty reduction returns NaN, never an exception.
- ``std`` is the population std (ddof=0); ``median``/``quantile`` use
  linear interpolation (NumPy semantics).
- Index functions return the FIRST index on ties, as ``np.argmax``.
"""

from __future__ import annotations

import torch

_BIG = 1.0e30
_NAN = float("nan")


def first_true(b: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none), as
    ``jnp.argmax`` on a boolean array."""
    return torch.argmax(b.to(torch.uint8), dim=-1)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx[...]]`` (``take_along_axis`` of one index per row)."""
    x = x.expand(*idx.shape, x.shape[-1])
    return torch.gather(x, -1, idx.unsqueeze(-1)).squeeze(-1)


def count(mask):
    return mask.sum(dim=-1)


def msum(x, mask):
    return torch.where(mask, x, 0.0).sum(dim=-1)


def mean(x, mask):
    n = count(mask)
    return torch.where(n > 0, msum(x, mask) / n.clamp(min=1), _NAN)


def var(x, mask, ddof: int = 0):
    n = count(mask)
    mu = mean(x, mask)
    d = torch.where(mask, x - mu.unsqueeze(-1), 0.0)
    ss = (d * d).sum(dim=-1)
    return torch.where(n > ddof, ss / (n - ddof).clamp(min=1), _NAN)


def std(x, mask, ddof: int = 0):
    return torch.sqrt(var(x, mask, ddof))


def mmin(x, mask):
    v = torch.where(mask, x, _BIG).amin(dim=-1)
    return torch.where(count(mask) > 0, v, _NAN)


def mmax(x, mask):
    v = torch.where(mask, x, -_BIG).amax(dim=-1)
    return torch.where(count(mask) > 0, v, _NAN)


def argmax(x, mask):
    """Index of the max valid element (first on ties)."""
    return torch.argmax(torch.where(mask, x, -_BIG), dim=-1)


def argmin(x, mask):
    """Index of the min valid element (first on ties)."""
    return torch.argmin(torch.where(mask, x, _BIG), dim=-1)


def quantile(x, mask, q: float):
    """``np.percentile(x[mask], q*100)`` with linear interpolation."""
    xs = torch.sort(torch.where(mask, x, _BIG), dim=-1).values
    n = count(mask)
    t = xs.shape[-1]
    idx = q * (n.to(xs.dtype) - 1.0)
    lo = torch.floor(idx).clamp(0, t - 1).long()
    hi = torch.ceil(idx).clamp(0, t - 1).long()
    w = idx - lo.to(xs.dtype)
    v = take(xs, lo) * (1.0 - w) + take(xs, hi) * w
    return torch.where(n > 0, v, _NAN)


def median(x, mask):
    return quantile(x, mask, 0.5)


def mad(x, mask):
    """Median absolute deviation about the median."""
    med = median(x, mask)
    return median(torch.abs(x - med.unsqueeze(-1)), mask)


def iqr(x, mask):
    return quantile(x, mask, 0.75) - quantile(x, mask, 0.25)


def _z(x, mask):
    n = count(mask)
    mu = mean(x, mask)
    sd = std(x, mask, ddof=0)
    sd_ = torch.where(sd > 0, sd, 1.0).unsqueeze(-1)
    return n, sd, torch.where(mask, (x - mu.unsqueeze(-1)) / sd_, 0.0)


def skewness(x, mask):
    """0 for n < 3 or zero std; population moments otherwise."""
    n, sd, zn = _z(x, mask)
    m3 = (zn ** 3).sum(dim=-1) / n.clamp(min=1)
    return torch.where((n >= 3) & (sd > 0), m3, 0.0)


def kurtosis(x, mask):
    """Excess kurtosis; 0 for n < 4 or zero std."""
    n, sd, zn = _z(x, mask)
    m4 = (zn ** 4).sum(dim=-1) / n.clamp(min=1)
    return torch.where((n >= 4) & (sd > 0), m4 - 3.0, 0.0)


def beyond_nstd(x, mask, nsig: float):
    """Fraction of valid points with |z| > nsig (0 when std == 0)."""
    n = count(mask)
    mu = mean(x, mask)
    sd = std(x, mask, ddof=0)
    z = torch.abs(x - mu.unsqueeze(-1)) / torch.where(sd > 0, sd, 1.0).unsqueeze(-1)
    frac = torch.where(mask, (z > nsig).to(x.dtype), 0.0).sum(dim=-1) / n.clamp(min=1)
    return torch.where(sd > 0, frac, 0.0)


def linfit(x, y, mask):
    """Masked least-squares line ``y ~ a*x + b`` -> (slope, intercept);
    NaN for fewer than 2 valid points or degenerate x."""
    x, y, mask = torch.broadcast_tensors(x, y, mask)
    n = count(mask)
    xm = mean(x, mask)
    ym = mean(y, mask)
    dx = torch.where(mask, x - xm.unsqueeze(-1), 0.0)
    dy = torch.where(mask, y - ym.unsqueeze(-1), 0.0)
    sxx = (dx * dx).sum(dim=-1)
    sxy = (dx * dy).sum(dim=-1)
    slope = torch.where(sxx > 0, sxy / torch.where(sxx > 0, sxx, 1.0), _NAN)
    intercept = ym - slope * xm
    bad = (n < 2) | ~torch.isfinite(slope)
    return torch.where(bad, _NAN, slope), torch.where(bad, _NAN, intercept)


def interp_at(times, values, mask, target_time, max_gap: float = 50.0):
    """Gap-limited linear interpolation at ``target_time``.

    - NaN when fewer than 2 valid points, when the target is outside
      [t_min, t_max] or NaN, or when the bracketing gap exceeds max_gap;
    - the endpoint value when the target hits the first valid time.

    ``times`` are time-sorted within the valid run (a prefix or window);
    ``target_time`` broadcasts against the leading axes of ``times``.
    """
    target_time = torch.as_tensor(target_time, dtype=times.dtype,
                                  device=times.device)
    times, values, mask, tt = torch.broadcast_tensors(
        times, values, mask, target_time.unsqueeze(-1))
    target_time = tt[..., 0]
    n = count(mask)
    t = torch.where(mask, times, _BIG)
    ge = (t >= tt) & mask
    idx = first_true(ge)
    any_ge = ge.any(dim=-1)
    first_valid = first_true(mask)

    t_first = take(t, first_valid)
    t_last = mmax(times, mask)

    lo = (idx - 1).clamp(min=0)
    t1, t2 = take(t, lo), take(t, idx)
    f1, f2 = take(values, lo), take(values, idx)

    dt = t2 - t1
    w = torch.where(dt > 0, (target_time - t1) / torch.where(dt > 0, dt, 1.0), 0.0)
    interp = f1 + w * (f2 - f1)
    at_start = idx == first_valid
    interp = torch.where(at_start, f2, interp)

    invalid = ((n < 2) | torch.isnan(target_time)
               | (target_time < t_first) | (target_time > t_last)
               | (~at_start & (dt > max_gap))
               | (~at_start & (dt <= 0))
               | ~any_ge)
    return torch.where(invalid, _NAN, interp)


def value_at_nearest(times, values, mask, target_time, max_dt: float):
    """Value at the valid observation nearest to target_time; NaN when the
    nearest is farther than max_dt."""
    target_time = torch.as_tensor(target_time, dtype=times.dtype,
                                  device=times.device)
    d = torch.where(mask, torch.abs(times - target_time.unsqueeze(-1)), _BIG)
    i = torch.argmin(d, dim=-1)
    dmin = take(d, i)
    v = take(values, i)
    ok = (count(mask) > 0) & (dmin < max_dt) & ~torch.isnan(target_time)
    return torch.where(ok, v, _NAN)
