"""Port vs JAX package: the v92 pipeline, and the port's whole v92d
training slice on the CPU.

``run_v92`` of both packages on the same JAX-extracted v34a matrix of a
small synthetic set (the v92d winner, with the adversarial stage): the
JAX package's CPU path builds every histogram directly, so the port runs
with ``hist_subtract=False``, the same arithmetic. The winner's OOF F1
and threshold must be equal, its OOF and test probabilities and the
adversarial weights within 1e-5. (The focal variants' objective is held
to the JAX package's in tests/test_torch_gbdt_train.py at rtol 1e-5: its
pow and log round differently from XLA:CPU's in the last bit, so a focal
fit is not bit-reproducible against the JAX package's and is not compared
here.)

``train_v92d`` then runs the port's whole slice (feature families of
both splits, the selection CV, assembly, adversarial weights, the v92d
CV, the test F1) on the CPU at a small size, with histogram subtraction
as on the card and shortened fits.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.data.synthetic import generate_dataset
from mallorn_tpu.features.base import feature_matrix as jax_feature_matrix
from mallorn_tpu.train import pipelines as JP
from mallorn_tpu.trees.gbdt import GBDTParams as JParams
from mallorn_tpu_torch.data.packing import Metadata, from_numpy
from mallorn_tpu_torch.train import adversarial as TA
from mallorn_tpu_torch.train import pipelines as TPL
from mallorn_tpu_torch.trees.gbdt import GBDTParams as TParams

torch.set_num_threads(2)

N_TRAIN, N_TEST, GP_STEPS = 120, 80, 8
FIT = dict(n_rounds=100, max_depth=4, learning_rate=0.15, subsample=0.8,
           colsample_bytree=0.8, min_child_weight=1.0)
VARIANTS = {"v92d_baseline_adv": JP.V92_VARIANTS["v92d_baseline_adv"]}


@pytest.fixture(scope="module")
def splits():
    tr = generate_dataset(N_TRAIN, seed=21, tde_frac=0.2)
    te = generate_dataset(N_TEST, seed=22, tde_frac=0.2, depth_scale=1.4)
    return tr, te


@pytest.fixture(scope="module")
def jax_matrices(splits):
    (tr_p, tr_m, _), (te_p, te_m, _) = splits
    tr_b = JP.extract_v34a_bundle(tr_p, tr_m, gp_steps=GP_STEPS)
    te_b = JP.extract_v34a_bundle(te_p, te_m, gp_steps=GP_STEPS)
    _, v4_names = jax_feature_matrix(tr_b["features_v4"])
    rng = np.random.default_rng(0)
    others = [n for n in v4_names if n not in JP.SHIFT_FEATURES]
    selected = list(JP.SHIFT_FEATURES) + [others[i] for i in
                                          rng.choice(len(others), 118, replace=False)]
    X_tr, names = JP.assemble_v34a_matrix(tr_b, selected)
    X_te, _ = JP.assemble_v34a_matrix(te_b, selected)
    return X_tr, X_te, names, np.asarray(tr_m.target)


def test_run_v92_matches_jax(jax_matrices):
    X_tr, X_te, names, y = jax_matrices
    assert len(names) == 224
    jr = JP.run_v92(X_tr, y, names, X_te, params=JParams(**FIT), variants=VARIANTS)
    tr = TPL.run_v92(X_tr, y, names, X_te, params=TParams(**FIT, hist_subtract=False),
                     variants=VARIANTS,
                     adv_params=TA.ADV_PARAMS._replace(hist_subtract=False), device="cpu")
    assert tr.feature_names == jr.feature_names and len(tr.feature_names) == 222
    assert tr.best_variant == jr.best_variant
    assert tr.adversarial.distribution_shift == jr.adversarial.distribution_shift
    np.testing.assert_allclose(tr.adversarial.sample_weights, jr.adversarial.sample_weights,
                               atol=1e-5)
    w_t, w_j = tr.winner, jr.winner
    assert (w_t.best_f1, w_t.best_threshold) == (w_j.best_f1, w_j.best_threshold)
    assert [m.best_iteration for m in w_t.models] == [m.best_iteration for m in w_j.models]
    np.testing.assert_allclose(w_t.oof_preds, w_j.oof_preds, atol=1e-5)
    np.testing.assert_allclose(w_t.test_preds, w_j.test_preds, atol=1e-5)


def test_chunked_extract_and_time_padding_match_jax(splits):
    """unify_time_padding re-pads both splits to the JAX package's widths
    and fills; chunked_extract over chunks of 32 objects equals one pass."""
    from mallorn_tpu.data.packing import unify_time_padding as jax_unify
    from mallorn_tpu_torch.data.packing import unify_time_padding
    from mallorn_tpu_torch.features import statistical
    from mallorn_tpu_torch.features.base import chunked_extract

    (tr_p, _, _), (te_p, _, _) = splits
    want = jax_unify(tr_p, te_p)
    got = unify_time_padding(_port_split(splits[0])[0], _port_split(splits[1])[0])
    for g, w in zip(got, want):
        for a, b in zip(g.tensors(), w[:-1]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    packed, meta = _port_split(splits[0])
    whole = statistical.extract(packed, meta)
    parts = chunked_extract(statistical.extract, packed, meta, chunk_size=32)
    assert list(parts) == list(whole)
    for k in whole:
        np.testing.assert_array_equal(parts[k].numpy(), whole[k].numpy())


def _port_split(packed_meta):
    packed, meta, _ = packed_meta
    arrays = [np.asarray(v) for k, v in packed._asdict().items() if k != "time_offset"]
    return (from_numpy(arrays, packed.time_offset, device="cpu"),
            Metadata(object_ids=meta.object_ids, z=np.asarray(meta.z),
                     ebv=np.asarray(meta.ebv), target=np.asarray(meta.target)))


def test_train_v92d_slice_on_cpu(splits, tmp_path):
    tr_p, tr_m = _port_split(splits[0])
    te_p, te_m = _port_split(splits[1])
    cache = tmp_path / "selection_port.npz"
    out = TPL.train_v92d(tr_p, tr_m, te_p, te_m, gp_steps=GP_STEPS, selection_cache=cache,
                         params=TParams(**FIT)._replace(n_rounds=40, max_depth=3),
                         adv_params=TA.ADV_PARAMS._replace(n_rounds=30), device="cpu")
    assert cache.exists()
    assert len(out.selection.selected) == 120
    assert not set(TPL.SHIFT_FEATURES) & set(out.feature_names)
    n_shift = sum(n in out.selection.selected for n in TPL.SHIFT_FEATURES)
    assert len(out.feature_names) == 224 - n_shift
    w = out.adversarial.sample_weights
    assert w.shape == (N_TRAIN,) and 0.5 <= w.min() and w.max() <= 2.0
    win = out.winner
    assert win.oof_preds.shape == (N_TRAIN,) and win.test_preds.shape == (N_TEST,)
    assert np.isfinite(win.oof_preds).all() and np.isfinite(win.test_preds).all()
    assert 0.0 < win.best_f1 <= 1.0 and out.test_f1 is not None
    for stage in ("features_train/features_v4", "features_test/bazin", "selection",
                  "assembly", "adversarial", "v92d_cv", "total"):
        assert out.timings[stage] >= 0.0
    # the fits ran (selection included: the artifact did not exist yet)
    assert out.rounds_run == {"selection": 40, "adversarial": out.rounds_run["adversarial"],
                              "v92d": out.rounds_run["v92d"]}
    assert 0 < out.rounds_run["adversarial"] <= 30 and 0 < out.rounds_run["v92d"] <= 40
