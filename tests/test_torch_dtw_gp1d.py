"""Port vs JAX package: DTW, the per-band 1D GP, and the last slice as a
whole.

- DTW: the anti-diagonal table equals a NumPy float32 DP bit for bit
  (its first row the running sum in XLA:CPU's cumsum order, itself held
  to a float64 cumsum); distances and warp fractions equal the JAX
  package's cell-by-cell scan bit for bit on the same curves; the family's
  templates and distances at ``tests/test_torch_features.py``'s rule
  (rtol 1e-4, a floor of 1e-4 of the column's largest magnitude) and its
  warp fractions equal.
- gp1d: the NLL within 1e-4 and the analytic gradient within 2e-3 of
  ``jax.value_and_grad(gp1d._nll)`` at fixed parameters (the GP's bars,
  ``tests/test_torch_gp.py``); the features after 30 Adam steps at the
  multiband_gp gate (per column >= 90% of lanes within rtol 2e-3, mean
  >= 97%), their guard NaNs identical.

The slice as a whole (all twelve families through ``chunked_extract``) is
held in ``tests/test_torch_more_families.py``; gp1d on the card in the
``cuda`` cases of ``tests/test_torch_chol.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mallorn_tpu.features import dtw as jdtw
from mallorn_tpu.features import gp1d as jgp1d
from mallorn_tpu_torch.features import dtw, gp1d
from tests.test_torch_gp import _assert_mostly_close
from tests.test_torch_more_families import assert_columns_close, torch_packed

torch.set_num_threads(2)

P = dtw.N_POINTS


# ---------------------------------------------------------------------------
# DTW
# ---------------------------------------------------------------------------

def _curves(L, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (L, P)).astype(np.float32)
    y = rng.uniform(0, 1, (L, P)).astype(np.float32)
    y[0] = x[0]  # identical curves
    y[1] = 0.0  # a constant template: ties everywhere in the backtrack
    return x, y


def _blocked_cumsum(c):
    """XLA:CPU's cumsum of 50 float32 values: blocks of 16 summed left to
    right, plus the running sum of the earlier blocks' totals."""
    n = len(c)
    blocks = np.zeros(-(-n // 16) * 16, np.float32)
    blocks[:n] = c
    blocks = blocks.reshape(-1, 16)
    inner = np.zeros_like(blocks)
    for j in range(16):
        inner[:, j] = blocks[:, j] if j == 0 else inner[:, j - 1] + blocks[:, j]
    offset = np.zeros(len(blocks), np.float32)
    for b in range(1, len(blocks)):
        offset[b] = offset[b - 1] + inner[b - 1, -1]
    return (inner + offset[:, None]).reshape(-1)[:n]


def test_dtw_table_is_the_dp():
    x, y = _curves(6, seed=0)
    D = dtw.dtw_table(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    for lane in range(len(x)):
        c = np.abs(x[lane][:, None] - y[lane][None, :])
        R = np.zeros((P, P), np.float32)
        R[0] = _blocked_cumsum(c[0])
        np.testing.assert_allclose(R[0], np.cumsum(c[0].astype(np.float64)), rtol=1e-6)
        for i in range(1, P):
            R[i, 0] = c[i, 0] + R[i - 1, 0]
            for j in range(1, P):
                R[i, j] = c[i, j] + min(min(R[i, j - 1], R[i - 1, j]), R[i - 1, j - 1])
        np.testing.assert_array_equal(D[lane], R, err_msg=f"lane {lane}")
    dist, warp = dtw.dtw(torch.from_numpy(x[:1]), torch.from_numpy(x[:1]))
    assert float(dist[0]) == 0.0 and float(warp[0]) == 0.0


def test_dtw_matches_the_jax_scan():
    x, y = _curves(64, seed=1)
    d_want, w_want = jax.jit(jax.vmap(jdtw._dtw))(x, y)
    d_got, w_got = dtw.dtw(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(d_got.numpy(), np.asarray(d_want))
    np.testing.assert_array_equal(w_got.numpy(), np.asarray(w_want))


def test_dtw_family_matches_jax(small_dataset):
    packed, meta, _ = small_dataset
    tp = torch_packed(packed)
    want_c = np.asarray(jax.jit(jax.vmap(jdtw._resample))(
        packed.band_time, packed.band_flux, packed.band_mask))
    np.testing.assert_array_equal(dtw.resample(tp.band_time, tp.band_flux,
                                               tp.band_mask).numpy(), want_c)
    want_t = np.asarray(jdtw.build_templates(packed, meta.target))
    got_t = dtw.build_templates(tp, meta.target)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-4,
                               atol=1e-4 * np.abs(want_t).max())
    want = jdtw.extract(packed, jnp.asarray(want_t))
    got = dtw.extract(tp, got_t)
    assert list(got) == list(want)
    warp = [k for k in want if "warp" in k]
    held = [k for k in want if k not in warp]
    assert_columns_close({k: want[k] for k in held}, {k: got[k] for k in held})
    for k in warp:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert np.isfinite(got["r_dtw_ratio"].numpy()).mean() > 0.5


# ---------------------------------------------------------------------------
# gp1d
# ---------------------------------------------------------------------------

def _lanes(L=10, T=24, seed=3):
    rng = np.random.default_rng(seed)
    mask = rng.random((L, T)) < 0.75
    mask[0] = False  # an empty lane
    mask[1] = np.arange(T) < 3  # fewer than 5 points
    t = np.where(mask, np.sort(rng.uniform(0, 1, (L, T)), 1), 0.0).astype(np.float32)
    y = np.where(mask, rng.normal(size=(L, T)), 0.0).astype(np.float32)
    alpha = np.where(mask, 0.005 + 0.2 * rng.random((L, T)), 0.0).astype(np.float32)
    return t, y, alpha, mask


@pytest.mark.parametrize("params", [(0.0, np.log(0.2), np.log(0.1)), (1.0, -1.0, -3.0),
                                    (-2.0, 0.5, 1.0), (np.log(50.0), np.log(0.02), np.log(2e-5))])
def test_gp1d_nll_and_gradient_match_jax(params):
    t, y, alpha, mask = _lanes()
    p = np.tile(np.asarray(params, np.float32), (len(t), 1))
    nll_want, g_want = jax.vmap(jax.value_and_grad(jgp1d._nll))(jnp.asarray(p), t, y, alpha,
                                                                mask)
    d2 = torch.from_numpy((t[:, :, None] - t[:, None, :]) ** 2)
    args = (torch.from_numpy(p), d2, torch.from_numpy(y), torch.from_numpy(alpha),
            torch.from_numpy(mask))
    nll_got, g_got = gp1d.nll_grad(*args)
    np.testing.assert_allclose(nll_got.numpy(), np.asarray(nll_want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(gp1d.nll(*args).numpy(), np.asarray(nll_want), rtol=1e-4,
                               atol=1e-4)
    assert float(nll_got[0]) == 0.0 and float(g_got[0].abs().max()) == 0.0


@pytest.mark.parametrize("fixture", ["tiny", "small"])
def test_gp1d_features_match_jax(tiny_dataset, small_dataset, fixture):
    packed = (tiny_dataset if fixture == "tiny" else small_dataset)[0]
    want = jgp1d.extract(packed, n_steps=30)
    got = gp1d.extract(torch_packed(packed), n_steps=30)
    _assert_mostly_close(want, {k: v.numpy() for k, v in got.items()}, 2e-3)
