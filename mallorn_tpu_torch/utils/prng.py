"""The ``jax.random`` key schedule that the GBDT fit depends on, in numpy.

The JAX package draws every round's row and column masks from threefry
keys (``PRNGKey(seed)``, ``split``, 32-bit ``random_bits`` and
``permutation``). Identical forests need identical bits, so this module
reproduces them on the host with uint32 arithmetic, in JAX's
``jax_threefry_partitionable=True`` mode (the default of the JAX version
the package runs on):

- a key is a ``[2]`` uint32 array; ``PRNGKey(s)`` = ``(0, s mod 2^32)`` (JAX
  with 64-bit types off, as the JAX package runs, takes the seed as a
  32-bit integer);
- ``split(key, n)`` hashes the 64-bit counters ``0..n-1`` (high and low
  words) with Threefry-2x32 under the key; output ``i`` is the pair of
  hashed words of counter ``i``;
- ``random_bits(key, shape)`` (32 bits) hashes counters ``0..size-1`` the
  same way and XORs the two words;
- ``permutation(key, n)`` is ``_shuffle``: ``ceil(3 ln n / ln(2^32 - 1))``
  rounds of ``key, sub = split(key)`` and a stable sort of the values by
  ``random_bits(sub, n)``;
- ``uniform(key, shape)`` (float32 on [0, 1)) puts the top 23 of the 32
  random bits into the mantissa of a float in [1, 2) and subtracts 1;
  with ``minval`` / ``maxval`` it is ``max(minval, u (maxval - minval) +
  minval)`` with the product and sum fused, as XLA:CPU compiles it;
- ``normal(key, shape)`` is ``sqrt(2) erfinv(u)`` for u uniform on
  (nextafter(-1, 0), 1), with XLA's float32 ``erf_inv`` polynomial
  (Giles' approximation, Horner steps fused);
- ``beta(key, a, b, shape)`` is ``jax.random.beta``: two ``loggamma``
  draws from ``split(key)``, each element from its own key of
  ``split(k, size)`` by Marsaglia and Tsang's rejection loop, run here
  over all elements at once with masks.

The GBDT fit's draws are bit for bit JAX's. ``normal`` and ``beta`` go
through ``log1p`` / ``log`` / ``exp``, whose last bit numpy and XLA round
differently, so they agree within a few float32 ulps (an accept / reject
test of the gamma loop could flip on one).

Everything here runs on the host; the results go to the device as
tensors.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)`` under
    ``key`` ([..., 2] uint32); the key words and counters broadcast
    elementwise."""
    k0, k1 = np.asarray(key[..., 0], np.uint32), np.asarray(key[..., 1], np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        a = np.asarray(x0, np.uint32) + ks[0]
        b = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    c = np.arange(n, dtype=np.uint64)
    return (c >> np.uint64(32)).astype(np.uint32), (c & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a [2] uint32 array."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> [num, 2] uint32."""
    hi, lo = _counters(num)
    a, b = threefry2x32(key, hi, lo)
    return np.stack([a, b], axis=1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32-bit ``jax.random.bits(key, shape)`` -> uint32 of ``shape``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    hi, lo = _counters(math.prod(shape))
    a, b = threefry2x32(key, hi, lo)
    return (a ^ b).reshape(shape)


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` -> int64 [n]."""
    x = np.arange(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as XLA:CPU fuses it (the float64
    product of two float32 values is exact)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _unit_floats(bits: np.ndarray) -> np.ndarray:
    """uint32 bits -> float32 on [0, 1) (top 23 bits as the mantissa)."""
    bits = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def _scale(u: np.ndarray, minval, maxval) -> np.ndarray:
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma(u, hi - lo, lo))


def uniform(key: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, minval=..., maxval=...)`` (float32)."""
    return _scale(_unit_floats(random_bits(key, shape)), minval, maxval)


# XLA's ErfInv32 (M. Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, w = -log1p(-x^2)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 ``lax.erf_inv`` in XLA's polynomial form."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):
        w = -np.log1p(-(x * x))
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, np.float32(c_lt), np.float32(c_ge)))
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == 1.0, x * np.float32(np.inf), p * x).astype(np.float32)


_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def _normal_of_bits(bits: np.ndarray) -> np.ndarray:
    u = _scale(_unit_floats(bits), _NORMAL_LO, 1.0)
    return (np.float32(np.sqrt(2.0)) * erfinv(u)).astype(np.float32)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` (float32)."""
    return _normal_of_bits(random_bits(key, shape))


def _split_many(keys: np.ndarray, num: int) -> np.ndarray:
    """``split(k, num)`` for every key of ``keys`` [n, 2] -> [n, num, 2]."""
    hi, lo = _counters(num)
    a, b = threefry2x32(keys[:, None, :], hi[None, :], lo[None, :])
    return np.stack([a, b], axis=-1)


def _scalar_bits(keys: np.ndarray) -> np.ndarray:
    """``random_bits(k, ())`` for every key of ``keys`` [n, 2] -> [n]."""
    zero = np.zeros(len(keys), np.uint32)
    a, b = threefry2x32(keys, zero, zero)
    return a ^ b


def loggamma(key: np.ndarray, a, shape) -> np.ndarray:
    """``jax.random.loggamma(key, a, shape)`` (float32): element i from key
    i of ``split(key, size)`` by ``_gamma_one``'s Marsaglia-Tsang loop in
    log space (alpha < 1 boosted to alpha + 1), every element's while loops
    run together under masks."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = math.prod(shape)
    alpha0 = np.broadcast_to(np.asarray(a, np.float32), shape).reshape(n)
    keys = split(key, n)
    boost = alpha0 >= np.float32(1.0)
    alpha = np.where(boost, alpha0, alpha0 + np.float32(1.0)).astype(np.float32)
    d = (alpha - np.float32(1.0 / 3.0)).astype(np.float32)
    c = (np.float32(1.0 / 3.0) / np.sqrt(d)).astype(np.float32)
    pair = _split_many(keys, 2)
    key, subkey = pair[:, 0], pair[:, 1]
    X = np.zeros(n, np.float32)
    V = np.ones(n, np.float32)
    U = np.full(n, 2.0, np.float32)
    reject = np.ones(n, bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        while reject.any():
            r = np.flatnonzero(reject)
            three = _split_many(key[r], 3)
            key[r] = three[:, 0]
            kx, ku = three[:, 1].copy(), three[:, 2]
            x = np.zeros(len(r), np.float32)
            v = np.full(len(r), -1.0, np.float32)
            again = v <= 0.0
            while again.any():
                q = np.flatnonzero(again)
                kk = _split_many(kx[q], 2)
                kx[q] = kk[:, 0]
                x[q] = _normal_of_bits(_scalar_bits(kk[:, 1]))
                v[q] = _fma(x[q], c[r][q], np.float32(1.0))
                again = v <= 0.0
            X[r] = x * x
            V[r] = v * v * v
            U[r] = _unit_floats(_scalar_bits(ku))
            Xr, Vr, Ur = X[r], V[r], U[r]
            reject[r] = ((Ur >= _fma(-np.float32(0.0331), Xr * Xr, np.float32(1.0)))
                         & (np.log(Ur) >= _fma(d[r], (np.float32(1.0) - Vr) + np.log(Vr),
                                               Xr * np.float32(0.5))))
        log_samples = np.log1p(-_unit_floats(_scalar_bits(subkey)))
        log_boost = np.where(boost | (log_samples == 0.0), np.float32(0.0),
                             log_samples * (np.float32(1.0) / alpha0)).astype(np.float32)
    out = (np.log(d) + np.log(V)).astype(np.float32) + log_boost
    return out.astype(np.float32).reshape(shape)


def beta(key: np.ndarray, a, b, shape) -> np.ndarray:
    """``jax.random.beta(key, a, b, shape)`` (float32)."""
    key_a, key_b = split(key)
    la = loggamma(key_a, a, shape)
    lb = loggamma(key_b, b, shape)
    m = np.maximum(la, lb)
    ga = np.exp(la - m)
    gb = np.exp(lb - m)
    return (ga / (ga + gb)).astype(np.float32)


def round_keys(seed: int, n_rounds: int) -> np.ndarray:
    """The fit's per-round keys, ``split(PRNGKey(seed), n_rounds)`` -> [R, 2]."""
    return split(PRNGKey(seed), n_rounds)


def round_subkeys(keys: np.ndarray, num: int = 2) -> Tuple[np.ndarray, ...]:
    """``split(rkey, num)`` for every round key [R, 2] -> ``num`` [R, 2]
    arrays: ``k_sub, k_col`` of a boosted fit (``num=2``), ``k_drop, k_sub,
    k_col`` of a DART fit (``num=3``)."""
    parts = np.stack([split(k, num) for k in keys])  # [R, num, 2]
    return tuple(parts[:, i] for i in range(num))


def column_masks(k_col: np.ndarray, n_features: int, colsample: float,
                 n_class: int = 0) -> np.ndarray:
    """[R, F] bool per-round column samples: the first
    ``max(1, round(colsample * F))`` entries of ``permutation(k_col[r], F)``
    (all True when ``colsample >= 1``). With ``n_class >= 2``, one sample
    per class tree from ``split(k_col[r], n_class)``: [R, n_class, F]."""
    if n_class >= 2:
        per_class = np.stack([split(k, n_class) for k in k_col], axis=1)  # [C, R, 2]
        return np.stack([column_masks(kc, n_features, colsample) for kc in per_class],
                        axis=1)
    R = len(k_col)
    if colsample >= 1.0:
        return np.ones((R, n_features), bool)
    k_cols = max(1, int(round(colsample * n_features)))
    out = np.zeros((R, n_features), bool)
    for r in range(R):
        out[r, permutation(k_col[r], n_features)[:k_cols]] = True
    return out
