"""Port vs JAX package: the threefry key schedule of the GBDT fit.

Every bit must agree (``np.testing.assert_array_equal``): one wrong bit
changes a column or row mask and the forests diverge from the first tree.
JAX runs with ``jax_threefry_partitionable`` on (its default), and the
port reproduces that mode.
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
