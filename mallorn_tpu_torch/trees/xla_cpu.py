"""Float32 arithmetic of the GBDT fit, on the CPU, as the JAX package's CPU
backend (XLA:CPU) does it: three reductions in its order, and its exp.

A split is an argmax over gains, and gains that are equal in exact
arithmetic (a missing-vs-present split written as "missing left below the
lowest bin" or "missing right above the highest"; two features that cut
a node's rows the same way; every split of round 0, where all gradients
take two values) are told apart by the last bit of their sums. The port
reproduces the JAX package's forests on the CPU only if those bits agree,
so there it adds in XLA:CPU's order and takes XLA:CPU's exp:

- ``node_totals`` (sum over features and bins): XLA splits each reduced
  axis longer than 32 into zero-padded windows of 32 (padding split low /
  high), adds each window sequentially (feature-major), then adds the
  window sums sequentially;
- ``bin_cumsum`` (cumulative sum over 256 bins): sequential sums within
  16 blocks of 16, plus the sequential prefix of the block totals;
- ``row_sums`` (per-leaf sums over rows, a one-hot matrix product in the
  JAX package): sequential over rows up to 384 rows (and for any N with at
  most 2 leaves), else sequential within two halves of ``ceil(N / 2)``
  rows (rounded up to a multiple of 8 above 300), the first half then the
  second. Held bit-exact up to 600 rows by tests/test_torch_gbdt_train.py;
  above 768 rows the product's blocking was not pinned down and this order
  is only close;
- ``level_sum`` (a symmetric level's gains summed over its nodes):
  sequential over the node axis;
- ``scaled_sum`` (a DART margin, the scale vector times the per-tree
  contributions, a [R] . [R, N] product in the JAX package): sequential
  over trees, each step a fused multiply-add;
- ``mul_add`` (a * b + c where the JAX package's compiled fit fuses the
  product into the sum: a node's h_tot + lambda, h_tot being the bin sum
  times 1/F): one rounding, as the fused multiply-add that XLA:CPU emits,
  computed as a float64 product (exact for float32 inputs) plus c, rounded
  to float32;
- ``exp`` (of the logistic objective): Cephes' range reduction and
  degree-5 polynomial with fused multiply-adds (Eigen's ``pexp``, which
  XLA:CPU emits), evaluated in float64 products rounded to float32 (held
  bit-exact by tests/test_torch_gbdt_train.py); at the clamped ends
  (|x| > 87) it takes ``torch.exp``.

On the card none of this is needed: plain ordered PyTorch reductions,
which give the same result from run to run, and ``torch.exp``.
"""

from __future__ import annotations

import numpy as np
import torch


def _windows(n: int):
    """(window, pad_lo, pad_hi) of one reduced axis of length n."""
    if n <= 32:
        return n, 0, 0
    padded = -(-n // 32) * 32
    lo = (padded - n) // 2
    return 32, lo, padded - n - lo


def node_totals(x: torch.Tensor) -> torch.Tensor:
    """[K, F, C, B] -> [K, C]: the sum over features and bins."""
    if x.device.type != "cpu":
        return x.sum(dim=(1, 3))
    a = x.numpy()
    K, F, C, B = a.shape
    wf, lf, hf = _windows(F)
    wb, lb, hb = _windows(B)
    a = np.pad(a, ((0, 0), (lf, hf), (0, 0), (lb, hb)))
    nf, nb = a.shape[1] // wf, a.shape[3] // wb
    # [K, C, nf, nb, wf * wb], each window's elements feature-major
    w = a.reshape(K, nf, wf, C, nb, wb).transpose(0, 3, 1, 4, 2, 5).reshape(K, C, nf, nb, -1)
    part = np.cumsum(w, axis=-1, dtype=np.float32)[..., -1]  # sequential float32
    tot = np.cumsum(part.reshape(K, C, -1), axis=-1, dtype=np.float32)[..., -1]
    return torch.from_numpy(np.ascontiguousarray(tot))


def bin_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis (256 bins on the CPU path)."""
    if x.device.type != "cpu" or x.shape[-1] != 256:
        return torch.cumsum(x, dim=-1)
    blocks = x.numpy().reshape(*x.shape[:-1], 16, 16)
    inner = np.cumsum(blocks, axis=-1, dtype=blocks.dtype)  # sequential within a block
    prefix = np.zeros(inner.shape[:-1], blocks.dtype)  # [..., 16] block offsets
    prefix[..., 1:] = np.cumsum(inner[..., :-1, 15], axis=-1, dtype=blocks.dtype)
    return torch.from_numpy((inner + prefix[..., None]).reshape(x.shape))


def row_sums(x: torch.Tensor) -> torch.Tensor:
    """[K, N, L, 2] -> [K, L, 2]: the sum over rows."""
    if x.device.type != "cpu":
        return x.sum(dim=1)
    a = x.numpy()
    n, n_leaves = a.shape[1], a.shape[2]
    if n == 0:
        return torch.zeros(a.shape[0], *a.shape[2:], dtype=x.dtype)
    half = n if (n <= 384 or n_leaves <= 2) else -(-n // 2)
    if half > 300 and half < n:
        half = -(-half // 8) * 8
    parts = np.stack([np.cumsum(a[:, s:s + half], axis=1, dtype=np.float32)[:, -1]
                      for s in range(0, n, half)], axis=1)
    return torch.from_numpy(np.cumsum(parts, axis=1, dtype=np.float32)[:, -1])


def level_sum(x: torch.Tensor) -> torch.Tensor:
    """[K, F, C, B] -> [K, F, B]: the sum over nodes."""
    if x.device.type != "cpu":
        return x.sum(dim=2)
    out = x[:, :, 0].clone()
    for c in range(1, x.shape[2]):
        out += x[:, :, c]
    return out


def scaled_sum(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[K, R] x [K, R, N] -> [K, N]: sum over r of s[:, r] * c[:, r]."""
    if s.device.type != "cpu":
        return torch.bmm(s[:, None, :], c)[:, 0]
    a, b = s.double().numpy(), c.double().numpy()
    out = np.zeros((c.shape[0], c.shape[2]), np.float32)
    for r in range(c.shape[1]):
        out = (a[:, r, None] * b[:, r] + out).astype(np.float32)
    return torch.from_numpy(out)


def mul_add(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 a * b + c."""
    if a.device.type != "cpu":
        return a * b + c
    c = torch.as_tensor(c, dtype=torch.float64)
    return (a.double() * b.double() + c).float()


_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
             1.6666665459e-1, 5.0000001201e-1)


def exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp."""
    if x.device.type != "cpu" or x.dtype != torch.float32:
        return torch.exp(x)
    a = x.numpy()

    def fma(p, q, r):
        return (p.astype(np.float64) * q + np.asarray(r, np.float64)).astype(np.float32)

    xc = np.clip(a, np.float32(-88.3762626647950), np.float32(88.3762626647949))
    m = np.floor(fma(xc, np.float32(1.44269504088896341), np.float32(0.5)))
    r = fma(m, np.float32(-0.693359375), xc)
    r = fma(m, np.float32(2.12194440e-4), r)
    r2 = r * r
    y = np.full_like(xc, np.float32(_EXP_POLY[0]))
    for c in _EXP_POLY[1:]:
        y = fma(y, r, np.float32(c))
    y = fma(y, r2, r) + np.float32(1)
    out = np.ldexp(y, m.astype(np.int32)).astype(np.float32)
    return torch.from_numpy(np.where(np.abs(a) > 87.0, np.exp(a), out))
