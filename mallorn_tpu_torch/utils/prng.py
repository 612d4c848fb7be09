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
  ``random_bits(sub, n)``.

Everything here runs once per fit on the host; the results go to the
device as tensors.
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
    ``key`` ([2] uint32); the arrays broadcast elementwise."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
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


def round_keys(seed: int, n_rounds: int) -> np.ndarray:
    """The fit's per-round keys, ``split(PRNGKey(seed), n_rounds)`` -> [R, 2]."""
    return split(PRNGKey(seed), n_rounds)


def round_subkeys(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``k_sub, k_col = split(rkey)`` for every round key [R, 2] -> two [R, 2]."""
    pairs = np.stack([split(k) for k in keys])  # [R, 2, 2]
    return pairs[:, 0], pairs[:, 1]


def column_masks(k_col: np.ndarray, n_features: int, colsample: float) -> np.ndarray:
    """[R, F] bool per-round column samples: the first
    ``max(1, round(colsample * F))`` entries of ``permutation(k_col[r], F)``
    (all True when ``colsample >= 1``)."""
    R = len(k_col)
    if colsample >= 1.0:
        return np.ones((R, n_features), bool)
    k_cols = max(1, int(round(colsample * n_features)))
    out = np.zeros((R, n_features), bool)
    for r in range(R):
        out[r, permutation(k_col[r], n_features)[:k_cols]] = True
    return out
