"""Port vs JAX package: the threefry key schedule of the GBDT fit, and the
draws of the augmentation transforms.

Every bit of the key schedule must agree (``np.testing.assert_array_equal``):
one wrong bit changes a column or row mask and the forests diverge from
the first tree. JAX runs with ``jax_threefry_partitionable`` on (its
default), and the port reproduces that mode. ``uniform`` with a range is
bit for bit too; ``normal`` (XLA's erf_inv polynomial over numpy's
log1p) is held at rtol 1e-6 and ``beta`` (two Marsaglia-Tsang loggamma
loops) at rtol 1e-5 on every element: their log1p / log / exp round their
last bit otherwise than XLA's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mallorn_tpu.trees.gbdt import _row_subsample_mask as jax_row_mask
from mallorn_tpu_torch.trees.gbdt import _row_subsample_mask
from mallorn_tpu_torch.utils import prng


def test_partitionable_mode_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 42, 123, 2**31 + 7, -5])
def test_prng_key_and_split(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(key))
    for num in (2, 3, 500):
        np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), num),
                                      np.asarray(jax.random.split(key, num)))


def test_random_bits():
    key = jax.random.split(jax.random.PRNGKey(7), 4)[3]
    for shape in ((5,), (7, 3), (1001,)):
        np.testing.assert_array_equal(prng.random_bits(np.asarray(key), shape),
                                      np.asarray(jax.random.bits(key, shape)))


@pytest.mark.parametrize("n", [12, 222, 307])
def test_permutation(n):
    for r, key in enumerate(jax.random.split(jax.random.PRNGKey(n), 20)):
        np.testing.assert_array_equal(prng.permutation(np.asarray(key), n),
                                      np.asarray(jax.random.permutation(key, n)),
                                      err_msg=f"key {r}")


def test_round_key_schedule_of_a_500_round_fit():
    """split(PRNGKey(42), 500) -> per round (k_sub, k_col) = split(rkey)
    -> column masks from permutation(k_col, F)[:round(0.8 F)], as the
    JAX package's _fit_impl draws them."""
    R, F = 500, 222
    keys = jax.random.split(jax.random.PRNGKey(42), R)
    np.testing.assert_array_equal(prng.round_keys(42, R), np.asarray(keys))
    k_sub, k_col = prng.round_subkeys(prng.round_keys(42, R))
    pairs = np.asarray(jax.vmap(jax.random.split)(keys))
    np.testing.assert_array_equal(k_sub, pairs[:, 0])
    np.testing.assert_array_equal(k_col, pairs[:, 1])
    masks = prng.column_masks(k_col, F, 0.8)
    k_cols = max(1, int(round(0.8 * F)))

    def jax_mask(kc):
        perm = jax.random.permutation(kc, F)
        return jnp.zeros(F, bool).at[perm[:k_cols]].set(True)

    np.testing.assert_array_equal(masks, np.asarray(jax.vmap(jax_mask)(pairs[:, 1])))
    assert (masks.sum(axis=1) == k_cols).all()


def test_row_subsample_mask():
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    rows = np.arange(2444)
    got = _row_subsample_mask(torch.from_numpy(np.asarray(keys, np.int64)),
                              torch.from_numpy(np.tile(rows, (6, 1))), 0.8).numpy()
    want = np.stack([np.asarray(jax_row_mask(k, jnp.asarray(rows, jnp.int32), 0.8))
                     for k in keys])
    np.testing.assert_array_equal(got, want)
    assert 0.75 < got.mean() < 0.85


@pytest.mark.parametrize("lo,hi", [(0.8, 1.2), (-20.0, 20.0), (-0.05, 0.1), (1.2, 2.0)])
def test_uniform_with_a_range(lo, hi):
    for seed in (0, 5, 77):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            prng.uniform(np.asarray(key), (3, 257), lo, hi),
            np.asarray(jax.random.uniform(key, (3, 257), minval=lo, maxval=hi)))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_normal(seed):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.normal(key, (24, 6, 40)))
    got = prng.normal(np.asarray(key), (24, 6, 40))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_erfinv_edges():
    x = np.array([-1.0, -0.999, -0.5, 0.0, 1e-7, 0.5, 0.999, 1.0], np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    np.testing.assert_allclose(prng.erfinv(x), want, rtol=1e-6)


@pytest.mark.parametrize("a,b", [(0.3, 0.3), (2.0, 2.0), (0.5, 3.0)])
def test_beta(a, b):
    """Every element within rtol 1e-5 (none flips an accept / reject step
    on these keys), and the sample's moments."""
    for seed in (0, 1, 2):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.beta(key, a, b, (2000,)))
        got = prng.beta(np.asarray(key), a, b, (2000,))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
        assert abs(got.mean() - a / (a + b)) < 0.03
        var = a * b / ((a + b) ** 2 * (a + b + 1))
        assert abs(got.var() - var) < 0.2 * var


def test_loggamma_boost_and_shape():
    key = jax.random.PRNGKey(9)
    alpha = np.array([[0.2, 0.9, 1.0], [1.5, 4.0, 0.05]], np.float32)
    want = np.asarray(jax.random.loggamma(key, jnp.asarray(alpha), (2, 3)))
    np.testing.assert_allclose(prng.loggamma(np.asarray(key), alpha, (2, 3)), want,
                               rtol=1e-5, atol=1e-6)


def test_permutation_of_an_index_array():
    """``jax.random.permutation(key, x)`` of an index array is ``x`` indexed
    by ``permutation(key, len(x))``."""
    key = jax.random.PRNGKey(4)
    x = np.array([3, 9, 14, 0, 0, 0, 0], np.int32)
    np.testing.assert_array_equal(x[prng.permutation(np.asarray(key), len(x))],
                                  np.asarray(jax.random.permutation(key, jnp.asarray(x))))
