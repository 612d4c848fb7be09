"""Port vs JAX package: the DL models (v10 LSTM, v13 transformer, v22 ATAT,
v27 GRU, v14 MLP), their batches, losses and training steps, and the
runners that drive them.

The parameters a flax model is initialised with are carried into the
port's module (``models.layers.state_from_flax``: the port's modules keep
flax's parameter names and layouts), and the same numpy inputs go
through both. The JAX side runs under ``jax.jit``, as the JAX package
trains it. Bars:

- batches within rtol / atol 1e-6, losses within rtol 1e-6;
- eval-mode forwards (logits, ``return_embedding``, ``return_features``)
  within rtol 1e-4, atol 1e-5, on a fixture with an empty band, a band of
  3 points and an object of 4 points;
- three full-batch Adam steps of one-layer models at dropout 0
  (``train_model`` against
  ``optax.adam`` driven here) and three AdamW / cosine steps of the v14
  MLP: every step's loss within rtol 1e-5, the parameters after the last
  step within atol 2e-5 (Adam normalises each step to ~lr, so rounding
  differences in the gradients move the parameters by far less than lr);
- training gates: the JAX package's overfit bar (losses fall, validation
  F1 > 0.8 on train = val) for each sequence model and the v14 CV.

Widths are small (hidden 8-16, one or two layers) so that the file runs
in well under a minute on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mallorn_tpu.data.synthetic import generate_dataset
from mallorn_tpu.models import ATAT as JATAT
from mallorn_tpu.models import GRUClassifier as JGRU
from mallorn_tpu.models import LSTMClassifier as JLSTM
from mallorn_tpu.models import TransformerClassifier as JTransformer
from mallorn_tpu.models import make_band_batch as j_band_batch
from mallorn_tpu.models import make_sequence_batch as j_sequence_batch
from mallorn_tpu.models import train_dl as J
from mallorn_tpu.models.mlp import ResidualMLP as JMLP
from mallorn_tpu_torch.data.packing import Metadata, from_numpy
from mallorn_tpu_torch.models import (ATAT, GRUClassifier, LSTMClassifier,
                                      TransformerClassifier, make_band_batch,
                                      make_sequence_batch)
from mallorn_tpu_torch.models import train_dl as T
from mallorn_tpu_torch.models.layers import state_from_flax, state_to_flax
from mallorn_tpu_torch.models.mlp import ResidualMLP, adamw_cosine, train_mlp_cv

torch.set_num_threads(2)

FWD = dict(rtol=1e-4, atol=1e-5)


def _sparse(packed):
    """The fixture with object 0's band 2 emptied, object 1's band 3 cut to
    3 points and object 2's all-band view cut to 4 points (valid points
    stay a prefix, as packing lays them out)."""
    bm = np.array(packed.band_mask)
    am = np.array(packed.all_mask)
    bm[0, 2] = False
    bm[1, 3, 3:] = False
    am[2, 4:] = False
    return packed._replace(band_mask=jnp.asarray(bm), all_mask=jnp.asarray(am))


@pytest.fixture(scope="module")
def data():
    packed, meta, _ = generate_dataset(48, seed=5, tde_frac=0.3)
    packed = _sparse(packed)
    tp = from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset, device="cpu")
    tmeta = Metadata(object_ids=meta.object_ids, z=np.asarray(meta.z, np.float32),
                     ebv=np.asarray(meta.ebv, np.float32), target=np.asarray(meta.target))
    return (packed, meta), (tp, tmeta)


@pytest.fixture(scope="module")
def batches(data):
    (packed, meta), (tp, tmeta) = data
    return ((j_sequence_batch(packed, meta), j_band_batch(packed, meta)),
            (make_sequence_batch(tp, tmeta), make_band_batch(tp, tmeta)))


def test_fixture_has_empty_and_sparse_lanes(batches):
    (_, jb), (tb, bb) = batches
    counts = bb.mask.sum(-1)
    assert (counts == 0).any() and ((counts > 0) & (counts < 5)).any()
    assert (tb.mask.sum(-1) == 4).any()


@pytest.mark.parametrize("view", [0, 1], ids=["sequence", "band"])
def test_batches_match(batches, view):
    jb, tb = batches[0][view], batches[1][view]
    assert type(tb).__name__ == type(jb).__name__ and tb._fields == jb._fields
    for name, a, b in zip(jb._fields, jb, tb):
        b = b.numpy()
        if a.dtype == bool or np.issubdtype(np.asarray(a).dtype, np.integer):
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)
        else:
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-6, err_msg=name)


def test_losses_match():
    rng = np.random.default_rng(0)
    logits = rng.normal(scale=3.0, size=257).astype(np.float32)
    logits[:3] = (-40.0, 40.0, 0.0)
    labels = (rng.random(257) < 0.3).astype(np.float32)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    for kw in ({}, {"gamma": 1.5, "alpha": 0.6}):
        np.testing.assert_allclose(T.focal_loss(lt, yt, **kw).item(),
                                   float(J.focal_loss(logits, labels, **kw)), rtol=1e-6)
    for w in (10.0, 3.0):
        np.testing.assert_allclose(T.weighted_bce(lt, yt, w).item(),
                                   float(J.weighted_bce(logits, labels, w)), rtol=1e-6)


def _tab(seq_batch):
    """A tabular matrix for ATAT: metadata plus the mean normalised flux."""
    return np.concatenate([np.asarray(seq_batch.meta),
                           np.asarray(seq_batch.features[:, :, 0]).mean(1, keepdims=True)],
                          axis=1).astype(np.float32)


# name -> (JAX model, port model, batch view, tabular?, apply kwargs); the
# constructors take the dropout rate and the number of layers
CASES = {
    "lstm": (lambda d, L: JLSTM(hidden_dim=8, n_layers=L, dropout=d),
             lambda d, L: LSTMClassifier(hidden_dim=8, n_layers=L, dropout=d, device="cpu"),
             0, False, {}),
    "transformer": (lambda d, L: JTransformer(d_model=16, n_layers=L, dropout=d),
                    lambda d, L: TransformerClassifier(d_model=16, n_layers=L, dropout=d,
                                                       device="cpu"), 0, False, {}),
    "gru": (lambda d, L: JGRU(hidden_dim=8, n_layers=L, dropout=d),
            lambda d, L: GRUClassifier(hidden_dim=8, n_layers=L, dropout=d, device="cpu"),
            1, False, {}),
    "atat_meta": (lambda d, L: JATAT(embed_dim=16, n_lc_layers=L, n_tab_layers=1, dropout=d),
                  lambda d, L: ATAT(embed_dim=16, n_lc_layers=L, n_tab_layers=1, dropout=d,
                                    device="cpu"), 0, False, {}),
    "atat_tabular": (lambda d, L: JATAT(embed_dim=16, n_lc_layers=L, n_tab_layers=1,
                                        dropout=d),
                     lambda d, L: ATAT(embed_dim=16, n_lc_layers=L, n_tab_layers=1, dropout=d,
                                       n_tabular=3, device="cpu"), 0, True, {}),
}
CASES["transformer_embedding"] = CASES["transformer"][:4] + ({"return_embedding": True},)
CASES["gru_features"] = CASES["gru"][:4] + ({"return_features": True},)


def _pair(case, batches, dropout=0.2, seed=3, layers=2):
    """(flax model, flax params, port module with them, JAX batch, port
    batch, JAX tabular, port tabular)."""
    jmake, tmake, view, tabular, _ = CASES[case]
    jb, tb = batches[0][view], batches[1][view]
    tab = _tab(batches[0][0]) if tabular else None
    jm = jmake(dropout, layers)
    args = (jb,) if tab is None else (jb, jnp.asarray(tab))
    init = jax.jit(lambda k, *a: jm.init(k, *a, train=False))
    params = init(jax.random.PRNGKey(seed), *args)
    tm = tmake(dropout, layers)
    tm.load_state_dict(state_from_flax(params))
    return jm, params, tm, jb, tb, tab, (None if tab is None else torch.from_numpy(tab))


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_matches(batches, case):
    jm, params, tm, jb, tb, tab, ttab = _pair(case, batches)
    kw = CASES[case][4]
    assert set(state_to_flax(tm)) == set(_flat(params))
    args = (jb,) if tab is None else (jb, jnp.asarray(tab))
    want = np.asarray(jax.jit(lambda p, *a: jm.apply(p, *a, train=False, **kw))(params, *args))
    tm.eval()
    with torch.no_grad():
        got = (tm(tb, **kw) if ttab is None else tm(tb, ttab, **kw)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **FWD)


@pytest.mark.parametrize("case", ["lstm", "transformer", "gru", "atat_tabular"])
def test_three_adam_steps_match_optax(batches, case):
    """``train_model`` at dropout 0 from carried parameters against optax's
    Adam driven on the flax model with the JAX package's loss."""
    jm, params, tm, jb, tb, tab, ttab = _pair(case, batches, dropout=0.0, layers=1)
    lr = 3e-3
    args = (jb,) if tab is None else (jb, jnp.asarray(tab))
    y = jb.label.astype(jnp.float32)
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(
            lambda q: J.focal_loss(jm.apply(q, *args, train=True), y))(p)
        u, s = tx.update(g, s)
        return optax.apply_updates(p, u), s, loss

    want = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state)
        want.append(float(loss))
    start = state_to_flax(tm)
    res = T.train_model(tm, tb, n_epochs=3, lr=lr, tabular=ttab)
    np.testing.assert_allclose(res.losses, want, rtol=1e-5)
    got = state_to_flax(tm)
    for path, value in _flat(params).items():
        if path.endswith("key/bias"):
            # softmax is shift-invariant along a row, so the key bias's
            # gradient is 0 in exact arithmetic: either package's Adam step
            # normalises its rounding noise, which moves it by up to lr
            assert np.abs(got[path] - start[path]).max() <= 3 * lr * (1 + 1e-6)
            continue
        np.testing.assert_allclose(got[path], value, rtol=0, atol=2e-5, err_msg=path)


def _flat(params):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def test_three_adamw_cosine_steps_match_optax():
    """The v14 MLP's optimiser: ``adamw_cosine`` against
    ``optax.adamw(cosine_decay_schedule(lr, 3), weight_decay)``, weighted
    BCE at dropout 0."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(64, 10)).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.normal(size=64) > 0.5).astype(np.float32)
    jm = JMLP(hidden_dims=(16, 12, 8), dropout=0.0)
    params = jm.init(jax.random.PRNGKey(4), X[:2], train=False)
    tm = ResidualMLP(10, (16, 12, 8), dropout=0.0, device="cpu")
    tm.load_state_dict(state_from_flax(params))
    lr, wd, n = 3e-3, 1e-2, 3
    tx = optax.adamw(optax.cosine_decay_schedule(lr, n), weight_decay=wd)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(
            lambda q: J.weighted_bce(jm.apply(q, X, train=True), y))(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    want = []
    for _ in range(n):
        params, opt_state, loss = step(params, opt_state)
        want.append(float(loss))
    opt, sched = adamw_cosine(tm, lr, n, wd)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    got_losses = []
    tm.train()
    for _ in range(n):
        opt.zero_grad()
        loss = T.weighted_bce(tm(Xt), yt)
        loss.backward()
        opt.step()
        sched.step()
        got_losses.append(loss.item())
    np.testing.assert_allclose(got_losses, want, rtol=1e-5)
    got = state_to_flax(tm)
    for path, value in _flat(params).items():
        np.testing.assert_allclose(got[path], value, rtol=0, atol=2e-5, err_msg=path)


@pytest.mark.parametrize("case", [
    "lstm", "gru", pytest.param("transformer", marks=pytest.mark.slow),
    pytest.param("atat_tabular", marks=pytest.mark.slow)])
def test_models_overfit(batches, case):
    """The JAX package's training gate (tests/test_dl_models.py): 150
    full-batch epochs at lr 3e-3 on train = val; losses finite and
    falling, validation F1 > 0.8. The transformer and ATAT take ~20 s each
    on the CPU and are marked slow, as the JAX package marks all four."""
    small = {"lstm": lambda: LSTMClassifier(hidden_dim=16, n_layers=1, device="cpu"),
             "transformer": lambda: TransformerClassifier(d_model=16, n_layers=1,
                                                          device="cpu"),
             "gru": lambda: GRUClassifier(hidden_dim=16, n_layers=1, device="cpu"),
             "atat_tabular": lambda: ATAT(embed_dim=16, n_lc_layers=1, n_tab_layers=1,
                                          n_tabular=3, device="cpu")}
    view = CASES[case][2]
    b = batches[1][view]
    tab = torch.from_numpy(_tab(batches[0][0])) if case == "atat_tabular" else None
    model = small[case]()
    res = T.train_model(model, b, val_batch=b, n_epochs=150, lr=3e-3, tabular=tab,
                        val_tabular=tab)
    assert np.isfinite(res.losses).all()
    assert res.losses[-1] < res.losses[0]
    assert res.val_f1 > 0.8, res.val_f1
    if case == "gru":
        with torch.no_grad():
            feats = model(b, return_features=True)
        assert feats.shape == (b.mask.shape[0], 32) and torch.isfinite(feats).all()


def test_mlp_cv_overfits_separable():
    """v14: the JAX package's gate for ``train_mlp_cv`` (3-fold CV on a
    separable matrix with NaNs, OOF F1 > 0.8, averaged test
    probabilities)."""
    rng = np.random.default_rng(0)
    n = 300
    X = rng.normal(size=(n, 12)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0.8).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 2] = np.nan
    out = train_mlp_cv(X, y, X_test=X[:50], n_epochs=300, hidden_dims=(32, 16), n_folds=3,
                       device="cpu")
    assert out["best_f1"] > 0.8, out["best_f1"]
    assert out["test_preds"].shape == (50,)
    assert np.isfinite(out["oof"]).all()


def test_params_file_round_trip(batches, tmp_path):
    """``save_params`` writes the flax names; ``load_params`` reads them
    into a fresh module, which then predicts the same logits."""
    _, params, tm, _, tb, _, _ = _pair("gru", batches)
    path = T.save_params(tmp_path / "gru.npz", tm)
    flat = T.load_params(path)
    assert set(flat) == set(_flat(params))
    fresh = T.load_params(path, GRUClassifier(hidden_dim=8, n_layers=2, seed=9, device="cpu"))
    tm.eval(), fresh.eval()
    with torch.no_grad():
        assert torch.equal(tm(tb), fresh(tb))


def test_dl_holdout_is_the_command_lines():
    """``dl_holdout`` against the JAX package's command line's split
    (mallorn_tpu/cli/main.py, the v10 / v13 / v22 / v27 branch), written
    out here."""
    from mallorn_tpu_torch.train.pipelines import dl_holdout

    label = (np.random.default_rng(3).random(611) < 0.07).astype(np.int64)
    rng = np.random.default_rng(42)
    pos, neg = np.flatnonzero(label == 1), np.flatnonzero(label == 0)
    rng.shuffle(pos), rng.shuffle(neg)
    val_ix = np.concatenate([pos[: max(len(pos) // 5, 1)], neg[: max(len(neg) // 5, 1)]])
    tr_ix = np.setdiff1d(np.arange(len(label)), val_ix)
    got_tr, got_val = dl_holdout(label)
    np.testing.assert_array_equal(got_tr, tr_ix)
    np.testing.assert_array_equal(got_val, val_ix)


@pytest.mark.parametrize("config", ["v10", "v13", "v22", "v27"])
def test_run_dl_model(data, config):
    """Each sequence runner at its default width for two epochs on the
    fixture: finite losses, validation and test probabilities."""
    from mallorn_tpu_torch.train.pipelines import run_dl_model

    _, (tp, tmeta) = data
    X = np.random.default_rng(2).normal(size=(tp.n_objects, 7)).astype(np.float32)
    X[0, 1] = np.nan
    res = run_dl_model(config, tp, tmeta, tp, tmeta, X_tab=X, X_tab_test=X, n_epochs=2,
                       device="cpu")
    assert res.n_train + res.n_val == tp.n_objects and res.val_probs.shape == (res.n_val,)
    assert np.isfinite(res.losses).all() and len(res.losses) == 2
    assert res.test_preds.shape == (tp.n_objects,) and np.isfinite(res.test_preds).all()
    assert not res.model.training


def test_run_v14_and_v26(data):
    """v14's CV and v26's astromer columns on a small backbone: the
    columns are ``features.astromer.extract``'s, the CV runs on both."""
    from mallorn_tpu_torch.features import astromer
    from mallorn_tpu_torch.trees.gbdt import GBDTParams
    from mallorn_tpu_torch.train.pipelines import run_v14, run_v26

    _, (tp, tmeta) = data
    y = tmeta.target
    X = np.random.default_rng(5).normal(size=(tp.n_objects, 6)).astype(np.float32)
    X[:, 0] += 2.0 * y
    out = run_v14(X, y, X[:10], n_epochs=5, device="cpu")
    assert out["oof"].shape == (tp.n_objects,) and out["test_preds"].shape == (10,)
    timings = {}
    res = run_v26(X, y, [f"c{i}" for i in range(6)], tp, X, tp,
                  params=GBDTParams(n_rounds=5, max_depth=3), timings=timings, device="cpu")
    assert res.feature_names[6:] == astromer.feature_names()
    want = astromer.extract(tp)
    np.testing.assert_array_equal(res.astromer_train[:, 3], want["g_astromer_emb_3"].numpy())
    assert res.cv.oof_preds.shape == (tp.n_objects,) and set(timings) == {"astromer", "cv"}
