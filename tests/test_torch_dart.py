"""Port vs JAX package: DART (``dart_rate > 0``) on each tree policy, and
the random draws it adds, on the CPU.

Fixtures: the 384 (+128 validation) x 12 fixture of
tests/test_torch_gbdt_train.py (15% NaN, subsample = colsample = 0.8,
scale_pos_weight), 30 rounds of depth 3 at the v111 drop rate 0.15, as
one fit per policy (depthwise, symmetric, leaf-wise: 8 leaves) and as 5
batched leaf-wise folds (v111's shape, cut to size).

The bars are tests/test_torch_gbdt_train.py's: ``feature``, ``split_bin``,
``default_left``, ``is_leaf`` (and ``left``, ``right`` leaf-wise) and
``best_iteration`` identical; leaf values (the final scales folded in)
within rtol 2e-4 / atol 2e-5; the validation logloss history within rtol
1e-5; predicted margins within 1e-5. The JAX package never subtracts
histograms in a DART fit, so the port runs with ``hist_subtract=False``.
Identity needs the DART margin, a [R] . [R, N] product in the JAX
package, in XLA:CPU's order: sequential over trees, one fused
multiply-add per tree (``xla_cpu.scaled_sum``).
"""

import jax
import numpy as np
import pytest
import torch

from mallorn_tpu.trees import gbdt as J
from mallorn_tpu_torch.train.cv import stratified_kfold
from mallorn_tpu_torch.trees import gbdt as T
from mallorn_tpu_torch.utils import prng

torch.set_num_threads(2)

COMMON = dict(n_rounds=30, max_depth=3, learning_rate=0.3, subsample=0.8,
              colsample_bytree=0.8, dart_rate=0.15, hist_subtract=False)
POLICIES = {"depthwise": {}, "symmetric": dict(grow_policy="symmetric"),
            "lossguide": dict(grow_policy="lossguide", max_leaves=8)}
ES = 5


def _fixture(seed, n=384, nv=128, f=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + nv, f)).astype(np.float32)
    y = (0.7 * X[:, 2] - 0.4 * X[:, 5] + 0.4 * rng.normal(size=n + nv) > 0.3).astype(np.float32)
    X[rng.random((n + nv, f)) < 0.15] = np.nan
    return X[:n], y[:n], X[n:], y[n:]


def _jparams(**kw):
    kw = {k: v for k, v in kw.items() if k != "hist_subtract"}
    return J.GBDTParams(**kw)


def _assert_same_forest(jm, tm):
    names = [n for n in type(tm.forest)._fields if n != "leaf_value"]
    for name in names:
        np.testing.assert_array_equal(getattr(tm.forest, name).numpy(),
                                      np.asarray(getattr(jm.forest, name)), err_msg=name)
    assert tm.best_iteration == jm.best_iteration
    np.testing.assert_allclose(tm.forest.leaf_value.numpy(), np.asarray(jm.forest.leaf_value),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tm.eval_history, np.asarray(jm.eval_history), rtol=1e-5)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_dart_fit_matches_jax(policy):
    X, y, Xv, yv = _fixture(5)
    spw = float((y == 0).sum() / (y == 1).sum())
    kw = {**COMMON, **POLICIES[policy]}
    jm = J.train_gbdt(X, y, _jparams(**kw), scale_pos_weight=spw, X_val=Xv, y_val=yv,
                      early_stopping_rounds=ES)
    tm = T.train_gbdt(X, y, T.GBDTParams(**kw), scale_pos_weight=spw, X_val=Xv, y_val=yv,
                      early_stopping_rounds=ES, device="cpu")
    _assert_same_forest(jm, tm)
    # every round ran (no device early stop); no fit-tracked margins
    assert np.isfinite(tm.eval_history).all() and len(tm.eval_history) == kw["n_rounds"]
    assert tm.val_margin is None and jm.val_margin is None
    np.testing.assert_allclose(tm.importance_gain, np.asarray(jm.importance_gain),
                               rtol=1e-4, atol=1e-4)
    got = T.predict_margin_models([tm], torch.from_numpy(Xv))[0].numpy()
    np.testing.assert_allclose(got, np.asarray(J.predict_margin(jm, Xv)), atol=1e-5)
    # the scales really moved: some stored trees are shrunk below eta
    assert not np.allclose(tm.forest.leaf_value.numpy(),
                           T.train_gbdt(X, y, T.GBDTParams(**{**kw, "dart_rate": 0.0}),
                                        scale_pos_weight=spw, device="cpu"
                                        ).forest.leaf_value.numpy())


def test_dart_lossguide_folds_match_jax():
    """v111's shape cut to size: leaf-wise DART over 5 batched folds, each
    with its own seed."""
    X, y, _, _ = _fixture(11, n=480, nv=0)
    folds = [{"X": X[tr], "y": y[tr], "X_val": X[va], "y_val": y[va],
              "spw": float((y[tr] == 0).sum() / (y[tr] == 1).sum()), "seed": 42 + k,
              "X_parent": X, "tr_idx": tr, "va_idx": va}
             for k, (tr, va) in enumerate(stratified_kfold(y, 5, 42))]
    kw = {**COMMON, **POLICIES["lossguide"], "n_rounds": 20}
    jms = J.train_gbdt_folds(folds, _jparams(**kw), early_stopping_rounds=ES, pad_rows_to=384)
    tms = T.train_gbdt_folds(folds, T.GBDTParams(**kw), early_stopping_rounds=ES,
                             pad_rows_to=384, device="cpu")
    for jm, tm in zip(jms, tms):
        _assert_same_forest(jm, tm)
        assert tm.val_margin is None


def test_uniform_and_three_way_round_keys():
    key = jax.random.split(jax.random.PRNGKey(5), 3)[2]
    for shape in ((7,), (600,), (3, 5)):
        np.testing.assert_array_equal(prng.uniform(np.asarray(key), shape),
                                      np.asarray(jax.random.uniform(key, shape)))
    keys = jax.random.split(jax.random.PRNGKey(42), 40)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys))
    got = prng.round_subkeys(prng.round_keys(42, 40), 3)
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[:, i])


def test_dart_round_randomness_matches_jax():
    """A DART fit's per-round draws, as the JAX package's ``_fit_dart``
    makes them: the drop candidates uniform(k_drop, (R,)) < rate, the row
    keys k_sub and the column masks from k_col."""
    R, F, rate = 40, 12, 0.15
    k_sub, masks, drop = T._round_randomness(42, R, F, 0.8, 0, rate)
    keys = jax.random.split(jax.random.PRNGKey(42), R)
    parts = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    np.testing.assert_array_equal(
        drop, np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (R,)) < rate)(parts[:, 0])))
    np.testing.assert_array_equal(k_sub, np.asarray(parts[:, 1]).astype(np.int64))
    k_cols = max(1, int(round(0.8 * F)))

    def jax_mask(kc):
        perm = jax.random.permutation(kc, F)
        return jax.numpy.zeros(F, bool).at[perm[:k_cols]].set(True)

    np.testing.assert_array_equal(masks, np.asarray(jax.vmap(jax_mask)(parts[:, 2])))
    assert 0.1 < drop.mean() < 0.2
