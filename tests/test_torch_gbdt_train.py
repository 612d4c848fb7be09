"""Port vs JAX package: depthwise GBDT training (``train_gbdt``,
``train_gbdt_folds``) on the CPU.

Fixtures: 384 training rows (+128 validation rows) x 12 columns, 15% NaN,
subsample = colsample = 0.8, scale_pos_weight, early stopping.

- Against the JAX package's default CPU path (``segment_sum`` histograms,
  every node built directly) the port runs with ``hist_subtract=False``,
  which is the same arithmetic. The forests must be identical: ``feature``,
  ``split_bin``, ``default_left``, ``is_leaf`` and ``best_iteration``
  equal; leaf values within rtol 2e-4 / atol 2e-5 (the bars of
  tests/test_hist_pallas.py::test_fullhot_training_parity); validation
  margins within 1e-5. Identity holds because the port's CPU path sums
  the split search's totals and leaf values in XLA:CPU's order
  (``trees/xla_cpu.py``): splits whose gains tie in exact arithmetic are
  decided by the last bit.
  The port's subtracted fit (its default, as on the card) equals the JAX
  default path too on these fixtures.
- Against the JAX package's TPU path (``use_binlane_hist=True``, the
  ``i8full`` kernel K1 in interpret mode, with histogram subtraction) the
  port runs with subtraction. A subtracted right child is parent minus
  sibling, which leaves a float residual in a bin that should be empty
  when the parent was itself subtracted; JAX sums bf16 digits (exact for
  small counts) and the port sums float32 values, so their residuals and
  hence some empty-bin ties differ. The JAX package's own default and
  binlane paths disagree on some fixtures of this family in the same way.
  The binlane comparisons are held on seed 7 (single fit, the seed of the
  JAX package's own binlane parity tests) and on the unweighted seed-11
  folds, where JAX's two paths agree with each other.
"""

import jax
import numpy as np
import pytest
import torch

from mallorn_tpu.trees import gbdt as J
from mallorn_tpu.trees import objectives as jobj
from mallorn_tpu_torch.train.cv import stratified_kfold
from mallorn_tpu_torch.trees import gbdt as T
from mallorn_tpu_torch.trees import objectives as tobj

torch.set_num_threads(2)

COMMON = dict(n_rounds=40, max_depth=4, learning_rate=0.3, subsample=0.8,
              colsample_bytree=0.8)
ES = 5


def _fixture(seed, n=384, nv=128, f=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + nv, f)).astype(np.float32)
    y = (0.7 * X[:, 2] - 0.4 * X[:, 5] + 0.4 * rng.normal(size=n + nv) > 0.3).astype(np.float32)
    X[rng.random((n + nv, f)) < 0.15] = np.nan
    return X[:n], y[:n], X[n:], y[n:]


def _assert_same_forest(jm, tm):
    for name in ("feature", "split_bin", "default_left", "is_leaf"):
        np.testing.assert_array_equal(getattr(tm.forest, name).numpy(),
                                      np.asarray(getattr(jm.forest, name)), err_msg=name)
    assert tm.best_iteration == jm.best_iteration
    np.testing.assert_allclose(tm.forest.leaf_value.numpy(), np.asarray(jm.forest.leaf_value),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tm.eval_history, np.asarray(jm.eval_history), rtol=1e-5)


@pytest.mark.parametrize("subtract", [False, True])
@pytest.mark.parametrize("seed", [3, 5, 7])
def test_train_gbdt_matches_jax_default_path(seed, subtract):
    X, y, Xv, yv = _fixture(seed)
    spw = float((y == 0).sum() / (y == 1).sum())
    jm = J.train_gbdt(X, y, J.GBDTParams(**COMMON), scale_pos_weight=spw,
                      X_val=Xv, y_val=yv, early_stopping_rounds=ES)
    tm = T.train_gbdt(X, y, T.GBDTParams(**COMMON, hist_subtract=subtract),
                      scale_pos_weight=spw, X_val=Xv, y_val=yv,
                      early_stopping_rounds=ES, device="cpu")
    _assert_same_forest(jm, tm)
    assert tm.best_iteration < COMMON["n_rounds"] - ES  # early stopping acted
    np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)
    np.testing.assert_allclose(tm.importance_gain, np.asarray(jm.importance_gain),
                               rtol=1e-4, atol=1e-4)


def test_train_gbdt_with_subtraction_matches_jax_binlane_path():
    X, y, Xv, yv = _fixture(7)
    spw = float((y == 0).sum() / (y == 1).sum())
    jm = J.train_gbdt(X, y, J.GBDTParams(**COMMON, use_binlane_hist=True,
                                         hist_dtype="i8full"),
                      scale_pos_weight=spw, X_val=Xv, y_val=yv, early_stopping_rounds=ES)
    tm = T.train_gbdt(X, y, T.GBDTParams(**COMMON), scale_pos_weight=spw,
                      X_val=Xv, y_val=yv, early_stopping_rounds=ES, device="cpu")
    _assert_same_forest(jm, tm)
    np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)


def _folds(seed, weighted):
    X, y, _, _ = _fixture(seed, n=480, nv=0)
    folds = []
    for k, (tr, va) in enumerate(stratified_kfold(y, 5, 42)):
        w = np.linspace(0.5, 2.0, len(tr)) if weighted else None
        folds.append({"X": X[tr], "y": y[tr], "w": w,
                      "X_val": X[va], "y_val": y[va],
                      "spw": float((y[tr] == 0).sum() / (y[tr] == 1).sum()), "seed": 42 + k,
                      "X_parent": X, "tr_idx": tr, "va_idx": va})
    return folds


@pytest.mark.parametrize("binlane,weighted", [(False, True), (False, False), (True, False)])
def test_train_gbdt_folds_matches_jax(binlane, weighted):
    """All 5 folds as one batched fit, each fold with its own seed; rows
    pad to 384 (the binlane kernel needs a row count with a 128-multiple
    divisor of at least 256)."""
    folds = _folds(11, weighted)
    jp = J.GBDTParams(**COMMON, use_binlane_hist=binlane, hist_dtype="i8full")
    jms = J.train_gbdt_folds(folds, jp, early_stopping_rounds=ES, pad_rows_to=384)
    tms = T.train_gbdt_folds(folds, T.GBDTParams(**COMMON, hist_subtract=binlane),
                             early_stopping_rounds=ES, pad_rows_to=384, device="cpu")
    for jm, tm in zip(jms, tms):
        np.testing.assert_array_equal(tm.bin_spec.edges.numpy(), np.asarray(jm.bin_spec.edges))
        _assert_same_forest(jm, tm)
        np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)


def test_cpu_arithmetic_follows_xla_cpu():
    """The CPU path's sums and exp are bit-for-bit XLA:CPU's (the jitted
    ops of the JAX package's fit) at the fit's shapes."""
    from mallorn_tpu_torch.trees import xla_cpu

    rng = np.random.default_rng(1)
    jnp = jax.numpy
    for shape in ((1, 12, 4, 257), (5, 37, 8, 257), (5, 222, 8, 257)):
        h = (rng.normal(size=shape) * rng.random(shape) * 100).astype(np.float32)
        np.testing.assert_array_equal(
            xla_cpu.node_totals(torch.from_numpy(h)).numpy(),
            np.asarray(jax.jit(lambda x: jnp.sum(x, axis=(1, 3)))(h)))
        c = np.ascontiguousarray(h[..., :256])
        np.testing.assert_array_equal(
            xla_cpu.bin_cumsum(torch.from_numpy(c)).numpy(),
            np.asarray(jax.jit(lambda x: jnp.cumsum(x, axis=-1))(c)))
    dot = jax.jit(jax.vmap(lambda o, d: jnp.dot(o.T, d, preferred_element_type=jnp.float32)))
    for n, leaves in ((240, 8), (384, 32), (480, 16), (600, 8)):
        node = rng.integers(0, leaves + 1, size=(5, n))
        gh = (rng.normal(size=(5, n, 2)) * rng.random((5, n, 2))).astype(np.float32)
        onehot = (node[..., None] == np.arange(leaves)).astype(np.float32)
        vals = np.where(onehot[..., None] > 0, gh[:, :, None, :], np.float32(0))
        np.testing.assert_array_equal(xla_cpu.row_sums(torch.from_numpy(vals)).numpy(),
                                      np.asarray(dot(onehot, gh)))
    x = (rng.normal(size=100000) * 4).astype(np.float32)
    np.testing.assert_array_equal(xla_cpu.exp(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.exp)(x)))


def test_fold_binning_matches_jax():
    """fit_bins_folds (one shared sort) and apply_bins_folds_gather (device
    gather + count of edges <= x, int16, padded rows 0) equal the JAX
    package's, uniform and weighted, with NaN, +-inf, an all-NaN column,
    tied values and padded indices (the fixture of
    tests/test_weighted_binning.py)."""
    from mallorn_tpu.trees import binning as JB
    from mallorn_tpu_torch.trees import binning as TB

    rng = np.random.default_rng(7)
    n, f = 400, 23
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.random(X.shape) < 0.25] = np.nan
    X[:, 3] = np.nan
    X[0, 1], X[1, 1] = np.inf, -np.inf
    X[:, 5] = np.round(X[:, 5] * 2)
    folds = [rng.choice(n, size=320, replace=False) for _ in range(4)]
    w_mixed = [rng.random(320).astype(np.float32) + 0.5 for _ in range(4)]
    w_mixed[2] = np.ones(320, np.float32)
    for ws in (None, w_mixed):
        want = JB.fit_bins_folds(X, folds, n_bins=16, sample_weights=ws)
        got = TB.fit_bins_folds(X, folds, n_bins=16, sample_weights=ws, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.edges.numpy(), np.asarray(w.edges))
        idx = np.full((4, 384), -1, np.int64)
        for k, fi in enumerate(folds):
            idx[k, :len(fi)] = fi
        edges = np.stack([np.asarray(w.edges) for w in want])
        want_b = np.asarray(JB.apply_bins_folds_gather(
            jax.numpy.asarray(X), jax.numpy.asarray(edges),
            jax.numpy.asarray(idx.astype(np.int32)), 16))
        got_b = TB.apply_bins_folds_gather(torch.from_numpy(X), torch.from_numpy(edges),
                                           torch.from_numpy(idx), 16)
        assert got_b.dtype == torch.int16
        np.testing.assert_array_equal(got_b.numpy(), want_b)


def test_objectives_match():
    rng = np.random.default_rng(0)
    m = rng.normal(size=500).astype(np.float32) * 3
    y = (rng.random(500) < 0.3).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 500).astype(np.float32)
    cases = [(jobj.logistic, tobj.logistic)]
    cases += [(jobj.make_focal(g, a), tobj.make_focal(g, a))
              for g, a in ((1.0, 0.85), (2.0, 0.85), (2.0, 0.9))]
    for jf, tf in cases:
        jg, jh = jf(jax.numpy.asarray(m), jax.numpy.asarray(y), jax.numpy.asarray(w))
        tg, th = tf(torch.from_numpy(m), torch.from_numpy(y), torch.from_numpy(w))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(tobj.logloss_metric(torch.from_numpy(m), torch.from_numpy(y))),
        float(jobj.logloss_metric(jax.numpy.asarray(m), jax.numpy.asarray(y))), rtol=1e-6)


def test_fit_is_reproducible_and_predicts_its_val_margin():
    X, y, Xv, yv = _fixture(5)
    p = T.GBDTParams(**COMMON)
    a = T.train_gbdt(X, y, p, X_val=Xv, y_val=yv, early_stopping_rounds=ES, device="cpu")
    b = T.train_gbdt(X, y, p, X_val=Xv, y_val=yv, early_stopping_rounds=ES, device="cpu")
    for x, z in zip(a.forest, b.forest):
        assert torch.equal(x, z)
    m = T.predict_margin_models([a], torch.from_numpy(Xv))[0].numpy()
    np.testing.assert_allclose(m, a.val_margin, atol=1e-5)
