"""Port vs JAX package: GBDT training with rows split over a mesh, on the
CPU.

The port's mesh is gloo ranks on the host (``parallel.mesh.launch``: one
process per rank, ``FileStore`` rendezvous under ``tmp_path``, one torch
thread each); the JAX package's is its 8-device virtual CPU mesh
(tests/conftest.py), taken at the same size with ``make_mesh(n)``. Every
port launch runs several fits at once (``mesh.run_each``), since starting
ranks costs seconds.

- Exactness: the int64 fixed-point twins at one global scale over two
  halves of the rows add up to the whole rows' sums, and their one
  conversion is ``build_histograms_fixed`` / ``build_seg_histograms_fixed``
  of all rows bit for bit (an empty half, a non-finite g).
- Forests: port ``train_gbdt_sharded`` against port ``train_gbdt`` with
  the kernels' fixed-point twins (``hist_fn``), and against JAX's
  ``train_gbdt_sharded``, at tests/test_sharded_training.py:35-45's bars:
  ``feature`` and ``split_bin`` equal, leaf values within rtol 2e-4 /
  atol 2e-5, probabilities within 5e-4. The JAX package's CPU fits never
  subtract histograms, so the fits here do not either, but for one case
  held to the port alone.
- Folds: ``train_gbdt_folds_sharded`` with early stopping against
  ``train_gbdt_folds`` and JAX's at :107-122 (eval history within rtol
  1e-4 / atol 1e-5, ``best_iteration`` equal), and a 3-class case
  (:149-197).
- The comm volume: the int64 histogram bytes of a round equal the
  analytic count and twice the float32 histogram part of JAX's
  ``comm_volume_report``; the only row-length tensors that cross are the
  leaf sums' terms (each row's leaf and (g, h), 12 bytes a row), which
  keep the leaf values the single-device ones bit for bit.

The histograms are exact and the leaf sums and metrics run on the
single-device rows in their order, so the port's sharded fits equal its
single-device fits bit for bit; the JAX package's (float32 psums of
partial sums) are held at its own bars.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.parallel import sharded_train as JS
from mallorn_tpu.parallel.mesh import DCN_AXIS, OBJ_AXIS
from mallorn_tpu.parallel.mesh import make_mesh as jax_mesh
from mallorn_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d
from mallorn_tpu.trees import gbdt as J
from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.parallel import mesh as M
from mallorn_tpu_torch.parallel import sharded_train as S
from mallorn_tpu_torch.trees import gbdt as T

torch.set_num_threads(2)

BASE = dict(n_rounds=20, max_depth=4, learning_rate=0.2, subsample=1.0, colsample_bytree=0.8,
            hist_subtract=False)
CASES = {
    "depthwise": {},
    "subsample": dict(subsample=0.8),
    "symmetric": dict(subsample=0.8, grow_policy="symmetric"),
    "lossguide": dict(subsample=0.8, grow_policy="lossguide", max_leaves=8),
    "dart": dict(subsample=0.8, dart_rate=0.15),
}
# held to the port alone: with subtraction (the port's default), which the
# JAX package's CPU fits never do
PORT_ONLY = {"subtract": dict(subsample=0.8, hist_subtract=True)}
FOLD_PARAMS = dict(n_rounds=15, max_depth=3, learning_rate=0.2, subsample=0.8,
                   colsample_bytree=0.8, hist_subtract=False)
MC_PARAMS = dict(n_rounds=10, max_depth=3, learning_rate=0.2, subsample=0.8,
                 colsample_bytree=0.8, num_class=3, hist_subtract=False)
LEAF_TOL = dict(rtol=2e-4, atol=2e-5)


def _jparams(**kw):
    return J.GBDTParams(**{k: v for k, v in kw.items() if k != "hist_subtract"})


def _data(seed, n=512, f=10):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = ((X[:, 0] - X[:, 1] + rng.normal(0, 0.4, n)) > 0).astype(np.float32)
    X[rng.uniform(size=n) < 0.1, 3] = np.nan
    return X, y


def _folds(seed, n=300, k=3, classes=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    if classes:
        y = np.argmax(X @ rng.normal(size=(6, classes)) + rng.normal(0, 0.4, (n, classes)),
                      axis=1).astype(np.float32)
        w = None
    else:
        y = ((X[:, 0] - X[:, 1] + rng.normal(0, 0.5, n)) > 0).astype(np.float32)
        w = (rng.exponential(1.0, n) + 0.2).astype(np.float32)
    folds = []
    for j in range(k):
        va = np.arange(n) % k == j
        folds.append({"X": X[~va], "y": y[~va], "w": None if w is None else w[~va],
                      "X_val": X[va], "y_val": y[va], "spw": 1.0 if classes else 2.0})
    return folds


def _pads(folds, q=8):
    pr = -(-max(len(f["y"]) for f in folds) // q) * q
    pv = -(-max(len(f["y_val"]) for f in folds) // q) * q
    return pr, pv


def _fixed(**kw):
    return dict(hist_fn=hist_cuda.build_histograms_fixed,
                seg_hist_fn=hist_cuda.build_seg_histograms_fixed, device="cpu", **kw)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank fits: every forest case, the 3-class folds and the comm
    volume, in one launch."""
    X, y = _data(0)
    mc = _folds(5, n=240, classes=3)
    calls = [(S.train_gbdt_sharded, (X, y, T.GBDTParams(**{**BASE, **kw})), {})
             for kw in {**CASES, **PORT_ONLY}.values()]
    calls.append((S.train_gbdt_folds_sharded, (mc, T.GBDTParams(**MC_PARAMS)),
                  dict(early_stopping_rounds=5, pad_rows_to=_pads(mc)[0],
                       pad_val_rows_to=_pads(mc)[1])))
    calls.append((S.comm_volume_report, (512, 32, T.GBDTParams(
        n_rounds=10, max_depth=4, learning_rate=0.2, hist_subtract=False)), {}))
    calls.append((S.comm_volume_report, (512, 32, T.GBDTParams(
        n_rounds=10, max_depth=4, learning_rate=0.2)), {}))
    out = M.launch(M.run_each, 2, (calls,), threads=1,
                   workdir=tmp_path_factory.mktemp("mesh2"))
    names = list({**CASES, **PORT_ONLY})
    return {"forests": dict(zip(names, out)), "multiclass": out[len(names)],
            "comm": out[-2], "comm_subtract": out[-1]}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The 2 x 2 mesh (4 ranks): a forest with its rows over both axes and
    the early-stopped folds."""
    X, y = _data(5)
    folds = _folds(2)
    pr, pv = _pads(folds)
    calls = [(S.train_gbdt_sharded, (X, y, T.GBDTParams(**{**BASE, **CASES["subsample"]})), {}),
             (S.train_gbdt_folds_sharded, (folds, T.GBDTParams(**FOLD_PARAMS)),
              dict(early_stopping_rounds=10, pad_rows_to=pr, pad_val_rows_to=pv))]
    return M.launch(M.run_each, 4, (calls,), mesh_shape=(2, 2), threads=1,
                    workdir=tmp_path_factory.mktemp("mesh4"))


def _assert_forest(got, want, exact=False):
    """Port model ``got`` against a port or JAX model ``want`` at the JAX
    package's bars, or field for field bit for bit (``exact``)."""
    if exact:
        for a, b in zip(got.forest, want.forest):
            assert torch.equal(a, b)
        return
    for name in ("feature", "split_bin"):
        np.testing.assert_array_equal(np.asarray(getattr(got.forest, name)),
                                      np.asarray(getattr(want.forest, name)), err_msg=name)
    np.testing.assert_allclose(np.asarray(got.forest.leaf_value),
                               np.asarray(want.forest.leaf_value), **LEAF_TOL)


def _assert_fold_models(got, want, exact=False):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _assert_forest(a, b, exact)
        if exact:
            np.testing.assert_array_equal(a.eval_history, b.eval_history)
        np.testing.assert_allclose(a.eval_history, np.asarray(b.eval_history), rtol=1e-4,
                                   atol=1e-5)
        assert a.best_iteration == b.best_iteration
        if a.val_margin is not None and b.val_margin is not None:
            np.testing.assert_allclose(a.val_margin, np.asarray(b.val_margin), rtol=1e-4,
                                       atol=1e-5)


# --------------------------------------------------------------- exactness

@pytest.mark.parametrize("cut", [0, 150, 301])
@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_int64_halves_add_to_the_whole_bit_for_bit(kernel, cut):
    g = torch.Generator().manual_seed(7 + cut)
    K, F, N, k, B = 3, 6, 301, 4, 17
    binned = torch.randint(0, B, (K, F, N), generator=g).to(torch.int16)
    node_q = torch.randint(0, k + 1, (K, N), generator=g).to(torch.int32)
    gh = torch.randn(K, N, 2, generator=g) * torch.tensor([3.0, 0.25])
    gh[1, 40, 0] = float("nan")  # lane 1 not finite
    gh[2, 7, 1] = float("inf") if cut else gh[2, 7, 1]
    halves = [slice(0, cut), slice(cut, N)]
    m = torch.maximum(*[hist_cuda.lane_maxabs(gh[:, s]) for s in halves])
    if kernel == "K1":
        parts = [hist_cuda.build_histograms_i64(binned[:, :, s].contiguous(),
                                                node_q[:, s].contiguous(),
                                                gh[:, s].contiguous(), k, B, m, N)
                 for s in halves]
        whole = hist_cuda.build_histograms_fixed(binned, node_q, gh, k, B)
    else:
        seg = (node_q.long() * B).to(torch.int32)
        parts = [hist_cuda.build_seg_histograms_i64(binned[:, :, s].contiguous(),
                                                    seg[:, s].contiguous(),
                                                    gh[:, s].contiguous(), k * B, m, N)
                 for s in halves]
        whole = hist_cuda.build_seg_histograms_fixed(binned, seg, gh, k * B)
    total = parts[0] + parts[1]
    assert total.dtype == torch.int64
    got = hist_cuda.from_fixed_sums(total, m, N)
    assert torch.equal(got.view(torch.int32), whole.view(torch.int32))  # NaN included
    assert torch.isnan(got[1]).all() and (total[1] == 0).all()
    if cut:
        assert torch.isnan(got[2]).all()
    else:
        assert torch.isfinite(got[0]).all() and torch.isfinite(got[2]).all()


def test_lane_maxabs_marks_non_finite_lanes():
    gh = torch.tensor([[[1.0, -2.0], [-3.0, 0.5]], [[float("nan"), 1.0], [0.0, 0.0]],
                       [[0.0, float("-inf")], [1.0, 1.0]]])
    m = hist_cuda.lane_maxabs(gh)
    assert m.tolist() == [[3.0, 2.0], [float("inf")] * 2, [float("inf")] * 2]
    assert hist_cuda.lane_maxabs(gh[:, :0]).tolist() == [[0.0, 0.0]] * 3


# --------------------------------------------------------------- forests

@pytest.mark.parametrize("case", list(CASES) + list(PORT_ONLY))
def test_sharded_forest_matches_port_single_device(two_ranks, case):
    X, y = _data(0)
    params = T.GBDTParams(**{**BASE, **{**CASES, **PORT_ONLY}[case]})
    single = T.train_gbdt(X, y, params, **_fixed())
    got = two_ranks["forests"][case]
    _assert_forest(got, single, exact=True)
    if case != "dart":
        p1 = T.predict_proba(single, X).numpy()
        p2 = T.predict_proba(got, X).numpy()
        np.testing.assert_allclose(p2, p1, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_forest_matches_jax_sharded(two_ranks, case):
    X, y = _data(0)
    kw = {**BASE, **CASES[case]}
    jm = JS.train_gbdt_sharded(jax_mesh(2), X, y, _jparams(**kw))
    got = two_ranks["forests"][case]
    _assert_forest(got, jm)
    if case != "dart":
        p1 = np.asarray(J.predict_proba(jm, X, kw["n_rounds"]))
        p2 = T.predict_proba(got, X).numpy()
        np.testing.assert_allclose(p2, p1, rtol=5e-4, atol=5e-4)


def test_2d_mesh_forest_matches_port_and_jax(four_ranks):
    X, y = _data(5)
    kw = {**BASE, **CASES["subsample"]}
    got = four_ranks[0]
    _assert_forest(got, T.train_gbdt(X, y, T.GBDTParams(**kw), **_fixed()), exact=True)
    jm = JS.train_gbdt_sharded(jax_mesh_2d(2, 2), X, y, _jparams(**kw),
                               axis=(DCN_AXIS, OBJ_AXIS))
    _assert_forest(got, jm)


def test_sharded_folds_match_port_and_jax(four_ranks):
    folds = _folds(2)
    pr, pv = _pads(folds)
    kw = dict(early_stopping_rounds=10, pad_rows_to=pr, pad_val_rows_to=pv)
    got = four_ranks[1]
    _assert_fold_models(got, T.train_gbdt_folds(folds, T.GBDTParams(**FOLD_PARAMS),
                                                **kw, **_fixed()), exact=True)
    _assert_fold_models(got, JS.train_gbdt_folds_sharded(jax_mesh(4), folds,
                                                         _jparams(**FOLD_PARAMS), **kw))
    assert all(m.val_margin is not None and m.val_margin.shape == (pv,) for m in got)


def test_sharded_multiclass_folds_match_port_and_jax(two_ranks):
    folds = _folds(5, n=240, classes=3)
    pr, pv = _pads(folds)
    kw = dict(early_stopping_rounds=5, pad_rows_to=pr, pad_val_rows_to=pv)
    got = two_ranks["multiclass"]
    assert got[0].forest.feature.dim() == 3  # [R, C, I]
    _assert_fold_models(got, T.train_gbdt_folds(folds, T.GBDTParams(**MC_PARAMS),
                                                **kw, **_fixed()), exact=True)
    _assert_fold_models(got, JS.train_gbdt_folds_sharded(jax_mesh(2), folds,
                                                         _jparams(**MC_PARAMS), **kw))


# --------------------------------------------------------------- comm volume

@pytest.mark.parametrize("subtract", [False, True])
def test_comm_volume_is_the_int64_histograms(two_ranks, subtract):
    F, depth, n_bins = 32, 4, 256
    rep = two_ranks["comm_subtract" if subtract else "comm"]
    assert rep["n_devices"] == 2
    # the row-length tensors: each rank's 256 rows' leaf beside their (g,
    # h) as 32-bit words in one gather, for the exact leaf sums, and
    # nothing else
    rows = [(k, s) for k, s, _ in rep["collectives"] if k == "all_gather"]
    assert rows == [("all_gather", "int32[256,1,3]")]
    assert rep["gathered_bytes_per_round"] == 256 * (4 + 8)
    assert rep["rows_resharded"]
    hist = [(k, s, b) for k, s, b in rep["collectives"] if s.startswith("int64")]
    assert all(k == "all_reduce_sum" for k, _, _ in hist)
    # one int64 [K = 1, F, nodes, bins, 2] all-reduce per level: every node
    # at level d, or its left children alone with subtraction
    nodes = [2 ** d if not subtract or d == 0 else 2 ** (d - 1) for d in range(depth)]
    assert [s for _, s, _ in hist] == [f"int64[1,{F},{c},{n_bins + 1},2]" for c in nodes]
    analytic = sum(F * c * (n_bins + 1) * 2 * 8 for c in nodes)
    assert sum(b for *_, b in hist) == analytic
    small = rep["psum_bytes_per_round"] - analytic
    assert small == 2 * 4, rep["collectives"]  # the lane maxima [1, 2], once a tree
    if not subtract:
        jrep = JS.comm_volume_report(jax_mesh(2), n_rows=512, n_features=F, params=J.GBDTParams(
            n_rounds=10, max_depth=depth, learning_rate=0.2, n_bins=n_bins))
        jhist = sum(b for _, _, b in jrep["collectives"] if b > 1024)
        assert analytic == 2 * jhist


# --------------------------------------------------------------- refusals

@pytest.mark.parametrize("mode", ["bf16", "i8bf16", "int8"])
def test_histogram_modes_refuse_a_mesh(mode):
    X, y = _data(0, n=32)
    with pytest.raises(ValueError, match=mode):
        S.train_gbdt_sharded(None, X, y, T.GBDTParams(hist_dtype=mode))
    with pytest.raises(ValueError, match=mode):
        S.train_gbdt_folds_sharded(None, _folds(1), T.GBDTParams(hist_dtype=mode))
    # a leaf-wise fit ignores the mode
    S.check_mesh_params(T.GBDTParams(hist_dtype=mode, grow_policy="lossguide"))


def test_mesh_shapes_and_refusals(tmp_path):
    def check(mesh):
        out = {"shape": mesh.shape, "block": mesh.block(11), "default": M.default_mesh()}
        with mesh.record() as calls:
            mesh.broadcast(torch.arange(3.0))
            mesh.all_reduce(torch.ones(2, dtype=torch.int64), "max")
        out["calls"] = calls
        for bad in ((3,), (1, 2), (0,)):
            with pytest.raises(ValueError, match="make_mesh_2d"):
                M.make_mesh_2d(*bad)
        with pytest.raises(ValueError, match="make_mesh"):
            M.make_mesh(2)
        out["mesh_2d"] = M.make_mesh_2d(1).shape
        return out

    out = M.launch(check, 1, spawn=False, workdir=tmp_path)
    assert out == {"shape": (1,), "block": (0, 11, 11), "default": None, "mesh_2d": (1, 1),
                   "calls": [("broadcast", "float32[3]", 12), ("all_reduce_max", "int64[2]", 16)]}
    with pytest.raises(RuntimeError, match="process group"):
        M.make_mesh()


def test_row_gather_packs_tensors_bit_for_bit(tmp_path):
    """``gather_fn`` moves several [K, rows, ...] tensors in one all-gather
    and gives each back in its dtype, bits included (a NaN's payload, -0.0,
    negative ints), cut to the fit's rows."""
    f = torch.tensor([[1.5, -0.0, 3.0, 4.0]]).repeat(2, 1)
    f.view(torch.int32)[1, 2] = 0x7FC00123  # a NaN with a payload
    i = torch.tensor([[-31, 0, 7, 2 ** 30], [5, -1, 0, 1]], dtype=torch.int32)
    gh = torch.randn(2, 4, 2, generator=torch.Generator().manual_seed(1))
    mask = torch.tensor([[True, False, True, True], [False, True, True, False]])

    def gather(mesh):
        with mesh.record() as calls:
            out = S.gather_fn(mesh, 3)(f, i, gh, mask)
        return out, calls, S.gather_fn(mesh, 4)(gh)

    (gf, gi, ggh, gm), calls, one = M.launch(gather, 1, spawn=False, workdir=tmp_path)
    assert calls == [("all_gather", "int32[4,2,5]", 4 * 2 * 5 * 4)]
    for got, want in ((gf, f), (gi, i), (ggh, gh), (gm, mask)):
        assert got.dtype == want.dtype and got.is_contiguous()
        assert torch.equal(got.view(torch.uint8) if got.dtype == torch.bool else
                           got.view(torch.int32), want[:, :3].contiguous().view(
                               torch.uint8 if want.dtype == torch.bool else torch.int32))
    assert torch.equal(one.view(torch.int32), gh.view(torch.int32))


def test_a_failing_rank_fails_the_launch_with_its_traceback(tmp_path):
    X, y = _data(0, n=32)
    with pytest.raises(RuntimeError, match="hist_dtype 'int8'"):
        M.launch(S.train_gbdt_sharded, 2, (X, y, T.GBDTParams(hist_dtype="int8")), threads=1,
                 workdir=tmp_path)
    with pytest.raises(RuntimeError, match="needs a GPU|only 0 devices"):
        M.launch(S.train_gbdt_sharded, 2, (X, y, T.GBDTParams()), device="cuda")


def test_sharded_training_step_grows_the_single_device_tree(tmp_path):
    """One ``make_sharded_training_step`` round (statistical features,
    binning, the tree, the margin update) on a one-rank mesh in this
    process against ``_train_tree`` on the same matrix."""
    from mallorn_tpu_torch.data.synthetic import generate_dataset
    from mallorn_tpu_torch.features import statistical
    from mallorn_tpu_torch.features.base import feature_matrix
    from mallorn_tpu_torch.trees import objectives
    from mallorn_tpu_torch.trees.binning import apply_bins, fit_bins

    packed, meta, _ = generate_dataset(40, seed=3, tde_frac=0.3, device="cpu")
    y = np.asarray(meta.target, np.float32)
    X, names = feature_matrix(statistical.extract(packed))
    names = names[:12]
    X = X[:, :12]
    params = T.GBDTParams(max_depth=3, learning_rate=0.3, min_child_weight=0.5)
    spec = fit_bins(X.numpy(), params.n_bins, device="cpu")
    w = np.ones(40, np.float32)

    def one_round(mesh):
        step = S.make_sharded_training_step(mesh, params, names, spec)
        return step(packed, y, w, torch.zeros(40))

    tree, margin = M.launch(one_round, 1, spawn=False, workdir=tmp_path)
    binned_T = apply_bins(spec, X).to(torch.int16).T.contiguous()[None]
    g, h = objectives.logistic(torch.zeros(1, 40), torch.from_numpy(y)[None],
                               torch.from_numpy(w)[None])
    want, _, node = T._train_tree(binned_T, torch.stack([g, h], -1), torch.ones(1, 12, dtype=bool),
                                  params, hist_cuda.build_histograms_fixed)
    for a, b in zip(tree, want):
        assert torch.equal(a, b[0])
    assert torch.equal(margin, torch.gather(want[-1], 1, node)[0])
