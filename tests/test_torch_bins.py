"""Port vs JAX package at bin counts other than 256, on the CPU.

The split search sums its histograms in XLA:CPU's order on the CPU
(``trees/xla_cpu.py``), so that splits whose gains tie in exact arithmetic
fall as in the JAX package. Two of those orders depend on the bin count:

- ``bin_cumsum`` (``jnp.cumsum`` over the bins): sequential within blocks
  of 16, the block totals prefixed by the same rule, recursively; held bit
  for bit against ``jax.jit(jnp.cumsum)`` at lengths around and far from
  256;
- ``node_totals`` (``jnp.sum`` over features and bins): windows of 32,
  whose sums are reduced by the same rule once there are more than 32 of
  them (beyond 1,024 bins); held bit for bit against the jitted sum.

With both, depthwise forests at 100, 600 and 1,024 bins on
tests/test_torch_gbdt_train.py's fixture, and leaf-wise forests at 600 and
1,024 bins on tests/test_torch_lossguide.py's "leaves31" data, equal the
JAX package's under those files' bars. The port refuses more than
32,767 bins (its bin ids are int16 on every histogram kernel), in a fit,
in a bin spec and in a model file, where the JAX package would go on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mallorn_tpu.trees import gbdt as J
from mallorn_tpu_torch.io import model_store as tstore
from mallorn_tpu_torch.trees import binning, xla_cpu
from mallorn_tpu_torch.trees import gbdt as T

import test_torch_gbdt_train as depthwise_fixture
import test_torch_lossguide as lossguide_fixture

torch.set_num_threads(2)


@pytest.mark.parametrize("length", [16, 100, 255, 256, 257, 300, 600, 1024, 4096])
def test_bin_cumsum_is_xla_cpus_cumsum(length):
    rng = np.random.default_rng(length)
    # values over many binades, so that any other order shows in the bits
    x = (rng.normal(size=(3, 4, length)) * np.exp(3 * rng.normal(size=(3, 4, length)))
         ).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    got = xla_cpu.bin_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n_features", [8, 222])
@pytest.mark.parametrize("n_bins_tot", [257, 1025, 2049, 8193])
def test_node_totals_are_xla_cpus_sum(n_features, n_bins_tot):
    rng = np.random.default_rng(n_bins_tot + n_features)
    h = (rng.normal(size=(n_features, 2, n_bins_tot))
         * np.exp(2 * rng.normal(size=(n_features, 2, n_bins_tot)))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=(0, 2)))(h))
    got = xla_cpu.node_totals(torch.from_numpy(h[None].copy()))[0].numpy()  # [K, F, C, B]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n_bins", [100, 600, 1024])
def test_depthwise_forest_matches_jax_at_other_bin_counts(n_bins):
    X, y, Xv, yv = depthwise_fixture._fixture(3)
    spw = float((y == 0).sum() / (y == 1).sum())
    kw = dict(depthwise_fixture.COMMON, n_bins=n_bins)
    jm = J.train_gbdt(X, y, J.GBDTParams(**kw), scale_pos_weight=spw, X_val=Xv, y_val=yv,
                      early_stopping_rounds=depthwise_fixture.ES)
    tm = T.train_gbdt(X, y, T.GBDTParams(**kw, hist_subtract=False), scale_pos_weight=spw,
                      X_val=Xv, y_val=yv, early_stopping_rounds=depthwise_fixture.ES,
                      device="cpu")
    assert tm.bin_spec.edges.shape == (X.shape[1], n_bins - 1)
    depthwise_fixture._assert_same_forest(jm, tm)
    np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)


@pytest.mark.parametrize("n_bins", [600, 1024])
def test_leaf_wise_forest_matches_jax_at_other_bin_counts(n_bins):
    make, kw = lossguide_fixture.CASES["leaves31"]
    X, y = make()
    n_tr = int(0.75 * len(X))
    Xt, yt, Xv, yv = X[:n_tr], y[:n_tr], X[n_tr:], y[n_tr:]
    spw = float((yt == 0).sum() / (yt == 1).sum())
    kw = dict(kw, n_bins=n_bins, grow_policy="lossguide")
    jm = J.train_gbdt(Xt, yt, J.GBDTParams(**kw), scale_pos_weight=spw, X_val=Xv, y_val=yv,
                      early_stopping_rounds=5)
    tm = T.train_gbdt(Xt, yt, T.GBDTParams(**kw), scale_pos_weight=spw, X_val=Xv, y_val=yv,
                      early_stopping_rounds=5, device="cpu")
    lossguide_fixture._assert_same_forest(jm, tm)
    np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)


def test_more_bins_than_int16_ids_hold_raise(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    top = binning.MAX_N_BINS
    assert top == 32767
    with pytest.raises(ValueError, match="int16"):
        T.train_gbdt(X, y, T.GBDTParams(n_rounds=1, n_bins=top + 1), device="cpu")
    folds = [dict(X=X[:40], y=y[:40], X_val=X[40:], y_val=y[40:])]
    with pytest.raises(ValueError, match="int16"):
        T.train_gbdt_folds(folds, T.GBDTParams(n_rounds=1, n_bins=top + 1), device="cpu")
    for fit in (binning.fit_bins, lambda a, n: binning.fit_bins_folds(a, [np.arange(40)], n)):
        with pytest.raises(ValueError, match="int16"):
            fit(X, top + 1)
    # the limit itself fits: the missing bin is 32,767, every id stays int16
    m = T.train_gbdt(X, y, T.GBDTParams(n_rounds=2, max_depth=2, n_bins=top), device="cpu")
    assert m.bin_spec.n_bins == top and m.bin_spec.edges.shape == (3, top - 1)
    assert np.isfinite(T.predict_proba(m, X).numpy()).all()
    # a model file that claims more bins is refused where it is read
    path = tstore.save_model(tmp_path / "m.npz", m)
    wide = m._replace(bin_spec=m.bin_spec._replace(n_bins=top + 1),
                      params=m.params._replace(n_bins=top + 1))
    bad = tstore.save_model(tmp_path / "wide.npz", wide)
    assert tstore.load_model(path, device="cpu").bin_spec.n_bins == top
    with pytest.raises(ValueError, match="int16"):
        tstore.load_model(bad, device="cpu")
