"""Port vs JAX package: the depthwise fit's histogram modes
(``GBDTParams.hist_dtype``), K4 ("bf16" / "i8bf16") and K5 ("int8").

- K5's plain version (``build_histograms_i8_plain``, what
  ``build_histograms_i8`` runs on a CPU tensor): its digits and scales
  equal ``hist_pallas.quantize_gh_i8``'s, and its histograms equal
  ``build_histograms_binlane_i8`` in Pallas interpret mode bit for bit.
- K4's plain version (``build_histograms_bf16_plain``): its digits equal
  ``split_gh_digits``'s, and its histograms are within the JAX package's
  histogram bar (rtol 1e-5, atol 1e-4; tests/test_hist_pallas.py:56) of
  ``build_histograms_binlane`` in interpret mode and of the float64 oracle.
- K4's fixed-point twin (``build_histograms_bf16_fixed``, the kernel's
  arithmetic): within the same bar of both; each digit sum within one
  float32 ulp (plus the fixed point's rounding) of the float64 digit sum;
  NaN in every cell of a fold with a non-finite g.
- Fits in each mode against the JAX package's binlane path in the same
  mode, on the fixtures of tests/test_torch_gbdt_train.py (seed 7, and the
  unweighted seed-11 folds padded to 384 rows): identical forests under
  that file's bars.
- Routing: ``hist_dtype`` picks the level-histogram kernel; an unknown
  mode raises; a leaf-wise fit ignores the mode.

The CUDA kernels are held against the plain versions on the card (K5 bit
for bit against its plain version, K4 against its fixed-point twin) by the
``cuda`` case below and by ``chip_smoke.py``. The machine with the card
has no JAX, so the JAX package is imported inside the tests that use it,
and the file runs there as ``pytest --noconftest -m cuda
tests/test_torch_hist_modes.py``.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.trees import gbdt as T

torch.set_num_threads(2)

K, F, N, NBT = 2, 12, 500, 257
RTOL, ATOL = 1e-5, 1e-4


def _fixture(n_nodes, seed=9):
    """binned [K, F, N], node ids [K, N] (n_nodes = inactive), gh [K, N, 2]
    shaped like weighted logistic gradients, some rows subsampled to 0."""
    rng = np.random.default_rng(seed + n_nodes)
    binned = rng.integers(0, NBT, size=(K, F, N)).astype(np.int16)
    binned[:, :, ::5] = NBT - 1  # a crowded missing bin
    node_q = rng.integers(0, n_nodes + 1, size=(K, N)).astype(np.int32)
    p = rng.random((K, N))
    y = rng.random((K, N)) < 0.2
    w = rng.uniform(0.5, 2.0, (K, N))
    keep = rng.random((K, N)) < 0.8
    gh = np.stack([w * (p - y) * keep, w * p * (1 - p) * keep], -1).astype(np.float32)
    return binned, node_q, gh


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_i8_digits_and_scales_equal_quantize_gh_i8():
    import jax.numpy as jnp

    from mallorn_tpu.ops import hist_pallas as hp

    _, _, gh = _fixture(1)
    gh[1, 3, 0] = -np.abs(gh[1]).max() * 1.5  # the scale's extreme is negative
    digits, scale = hist_cuda.quantize_gh_i8(torch.from_numpy(gh))
    assert digits.dtype == torch.int8 and scale.dtype == torch.float32
    for k in range(K):
        gd, s_g, s_h = hp.quantize_gh_i8(jnp.asarray(gh[k, :, 0]), jnp.asarray(gh[k, :, 1]))
        np.testing.assert_array_equal(digits[k].numpy(), np.asarray(gd))
        np.testing.assert_array_equal(scale[k].numpy(), np.array([s_g, s_h], np.float32))


@pytest.mark.parametrize("n_nodes", [1, 4])
def test_i8_plain_equals_binlane_i8_bit_for_bit(n_nodes):
    import jax.numpy as jnp

    from mallorn_tpu.ops import hist_pallas as hp

    binned, node_q, gh = _fixture(n_nodes)
    got = hist_cuda.build_histograms_i8(*_t(binned, node_q, gh), n_nodes, NBT).numpy()
    assert got.shape == (K, F, n_nodes, NBT, 2) and got.dtype == np.float32
    for k in range(K):
        bhot, hib = hp.precompute_binlane_i8(jnp.asarray(binned[k].astype(np.int32)))
        gd, s_g, s_h = hp.quantize_gh_i8(jnp.asarray(gh[k, :, 0]), jnp.asarray(gh[k, :, 1]))
        want = hp.build_histograms_binlane_i8(bhot, hib, jnp.asarray(node_q[k]), gd, s_g, s_h,
                                              n_nodes, NBT, interpret=True)
        np.testing.assert_array_equal(got[k], np.asarray(want))


def test_i8_plain_is_within_its_quantization_error_of_the_f64_oracle():
    """|cell - exact| <= N s 2^-27 (hist_pallas.py:317-329) plus the float32
    roundings of the recombination."""
    binned, node_q, gh = _fixture(4)
    tb, tq, tg = _t(binned, node_q, gh)
    got = hist_cuda.build_histograms_i8(tb, tq, tg, 4, NBT).numpy().astype(np.float64)
    want = hist_cuda.build_histograms_plain(tb, tq, tg.double(), 4, NBT).numpy()
    s = np.abs(gh).max(axis=1)  # [K, 2]
    bound = N * s * 2.0 ** -27
    err = np.abs(got - want).max(axis=(1, 2, 3))  # [K, 2]
    assert (err <= bound + 4 * np.finfo(np.float32).eps * np.abs(want).max()).all(), (err, bound)


def test_bf16_digits_equal_split_gh_digits():
    import jax.numpy as jnp

    from mallorn_tpu.ops import hist_pallas as hp

    _, _, gh = _fixture(2)
    got = hist_cuda.split_gh_digits(torch.from_numpy(gh))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (K, N, 6)
    for k in range(K):
        want = hp.split_gh_digits(jnp.asarray(gh[k, :, 0]), jnp.asarray(gh[k, :, 1]))
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("n_nodes", [1, 4])
def test_bf16_plain_matches_binlane_interpret_and_f64(n_nodes):
    import jax.numpy as jnp

    from mallorn_tpu.ops import hist_pallas as hp

    binned, node_q, gh = _fixture(n_nodes, seed=21)
    tb, tq, tg = _t(binned, node_q, gh)
    got = hist_cuda.build_histograms_bf16(tb, tq, tg, n_nodes, NBT).numpy()
    assert got.shape == (K, F, n_nodes, NBT, 2) and got.dtype == np.float32
    want64 = hist_cuda.build_histograms_plain(tb, tq, tg.double(), n_nodes, NBT).numpy()
    np.testing.assert_allclose(got, want64, rtol=RTOL, atol=ATOL)
    for k in range(K):
        bhot, hib = hp.precompute_binlane(jnp.asarray(binned[k].astype(np.int32)))
        gd = hp.split_gh_digits(jnp.asarray(gh[k, :, 0]), jnp.asarray(gh[k, :, 1]))
        want = hp.build_histograms_binlane(bhot, hib, jnp.asarray(node_q[k]), gd, n_nodes, NBT,
                                           interpret=True)
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_nodes", [1, 4])
def test_bf16_fixed_matches_binlane_interpret_and_f64(n_nodes):
    import jax.numpy as jnp

    from mallorn_tpu.ops import hist_pallas as hp

    binned, node_q, gh = _fixture(n_nodes, seed=21)
    tb, tq, tg = _t(binned, node_q, gh)
    got = hist_cuda.build_histograms_bf16_fixed(tb, tq, tg, n_nodes, NBT).numpy()
    assert got.shape == (K, F, n_nodes, NBT, 2) and got.dtype == np.float32
    want64 = hist_cuda.build_histograms_plain(tb, tq, tg.double(), n_nodes, NBT).numpy()
    np.testing.assert_allclose(got, want64, rtol=RTOL, atol=ATOL)
    for k in range(K):
        bhot, hib = hp.precompute_binlane(jnp.asarray(binned[k].astype(np.int32)))
        gd = hp.split_gh_digits(jnp.asarray(gh[k, :, 0]), jnp.asarray(gh[k, :, 1]))
        want = hp.build_histograms_binlane(bhot, hib, jnp.asarray(node_q[k]), gd, n_nodes, NBT,
                                           interpret=True)
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_nodes", [1, 4])
def test_bf16_fixed_digit_sums_are_within_one_ulp_of_exact(n_nodes):
    """Each fixed-point digit sum is the float32 rounding of an integer sum
    that is within n / (2 S) of the exact one (n rows, S the channel's
    scale): one float32 ulp of the float64 digit sum plus that."""
    binned, node_q, gh = _fixture(n_nodes, seed=23)
    tb, tq, tg = _t(binned, node_q, gh)
    got = hist_cuda.bf16_digit_sums_fixed(tb, tq, tg, n_nodes, NBT).numpy().astype(np.float64)
    d = hist_cuda.split_gh_digits(tg).double()
    exact = np.stack([hist_cuda.build_histograms_plain(tb, tq, d[..., [i, 3 + i]], n_nodes,
                                                       NBT).numpy() for i in range(3)], -1)
    exact = exact.reshape(got.shape)  # [..., (g, h), digit] -> g's d0-d2, then h's
    _, e = np.frexp(np.abs(d.numpy()).max(axis=1))  # [K, 6]: max |digit| < 2^e
    scale = np.ldexp(1.0, 62 - int(np.ceil(np.log2(N))) - e)
    slack = (N / (2 * scale))[:, None, None, None, :]
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - exact) <= ulp + slack).all()


@pytest.mark.parametrize("n_nodes,bad", [(1, np.inf), (4, np.nan)])
def test_bf16_fixed_is_nan_in_every_cell_of_a_non_finite_fold(n_nodes, bad):
    binned, node_q, gh = _fixture(n_nodes, seed=21)
    gh[1, 7, 0] = bad
    got = hist_cuda.build_histograms_bf16_fixed(*_t(binned, node_q, gh), n_nodes, NBT).numpy()
    assert np.isnan(got[1]).all() and np.isfinite(got[0]).all()


def test_launch_inputs_are_row_major_digits_and_their_scales():
    """What the mode kernel takes: K5 ``quantize_gh_i8``'s digits and scales;
    K4 ``split_gh_digits``' [K, N, 6] bf16 digits, contiguous, with their
    float32 max |digit| per fold and channel."""
    tg = torch.from_numpy(_fixture(2)[2])
    d5, s5 = hist_cuda.launch_inputs(True, tg)
    want5 = hist_cuda.quantize_gh_i8(tg)
    assert torch.equal(d5, want5[0]) and torch.equal(s5, want5[1]) and d5.is_contiguous()
    d4, m4 = hist_cuda.launch_inputs(False, tg)
    assert torch.equal(d4, hist_cuda.split_gh_digits(tg)) and d4.is_contiguous()
    assert m4.dtype == torch.float32 and tuple(m4.shape) == (K, 6)
    assert torch.equal(m4, d4.float().abs().amax(dim=1))


def test_hist_dtype_picks_the_kernel_and_unknown_modes_raise():
    """"i8full" is K1's wrapper on (g, h); each histogram mode a
    ``LevelHist``: its digits prepared once a tree (K4's bf16, K5's int8),
    then the mode kernel at every level."""
    assert T.level_hist_fn(T.GBDTParams(hist_dtype="i8full")) is hist_cuda.build_histograms
    for mode, int8 in (("bf16", False), ("i8bf16", False), ("int8", True)):
        fn = T.level_hist_fn(T.GBDTParams(hist_dtype=mode))
        assert isinstance(fn, T.LevelHist) and fn.hist is hist_cuda.mode_hist
        assert fn.prepare.func is hist_cuda.prepare_digits and fn.prepare.args == (int8,)
    assert T.GBDTParams().hist_dtype == "i8full"
    X = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    for p in (T.GBDTParams(n_rounds=2, hist_dtype="fp8"),
              T.GBDTParams(n_rounds=2, hist_dtype="int8 ", grow_policy="lossguide")):
        with pytest.raises(ValueError, match="hist_dtype"):
            T.train_gbdt(X, y, p, device="cpu")


def test_a_fit_calls_only_its_modes_kernel(monkeypatch):
    """Every level of a depthwise fit goes through the mode's level
    function, its digits prepared once a tree; a leaf-wise fit ignores the
    mode."""
    calls = {}

    def counting(name, fn):
        def wrapped(*a):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a)
        return wrapped

    for mode in ("i8full", "bf16", "int8"):
        fn = T.HIST_DTYPE_FNS[mode]
        fn = (T.LevelHist(counting(f"{mode} prepare", fn.prepare), counting(mode, fn.hist))
              if isinstance(fn, T.LevelHist) else counting(mode, fn))
        monkeypatch.setitem(T.HIST_DTYPE_FNS, mode, fn)
    X = np.random.default_rng(1).normal(size=(96, 5)).astype(np.float32)
    y = (X[:, 1] + 0.3 * X[:, 2] > 0).astype(np.float32)
    T.train_gbdt(X, y, T.GBDTParams(n_rounds=3, max_depth=3, hist_dtype="int8"), device="cpu")
    assert calls == {"int8 prepare": 3, "int8": 9}
    lg = T.GBDTParams(n_rounds=3, max_depth=3, grow_policy="lossguide", max_leaves=4)
    a = T.train_gbdt(X, y, lg._replace(hist_dtype="int8"), device="cpu")
    b = T.train_gbdt(X, y, lg, device="cpu")
    assert calls == {"int8 prepare": 3, "int8": 9}
    for x, z in zip(a.forest, b.forest):
        assert torch.equal(x, z)


def _gbdt_fixtures():
    import test_torch_gbdt_train as base

    return base


@pytest.mark.parametrize("mode", ["int8", "i8bf16", "bf16"])
def test_train_gbdt_matches_jax_in_the_mode(mode):
    from mallorn_tpu.trees import gbdt as J

    base = _gbdt_fixtures()
    X, y, Xv, yv = base._fixture(7)
    spw = float((y == 0).sum() / (y == 1).sum())
    jm = J.train_gbdt(X, y, J.GBDTParams(**base.COMMON, use_binlane_hist=True, hist_dtype=mode),
                      scale_pos_weight=spw, X_val=Xv, y_val=yv,
                      early_stopping_rounds=base.ES)
    tm = T.train_gbdt(X, y, T.GBDTParams(**base.COMMON, hist_dtype=mode), scale_pos_weight=spw,
                      X_val=Xv, y_val=yv, early_stopping_rounds=base.ES, device="cpu")
    base._assert_same_forest(jm, tm)
    np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "i8bf16", "bf16"])
def test_train_gbdt_folds_matches_jax_in_the_mode(mode):
    from mallorn_tpu.trees import gbdt as J

    base = _gbdt_fixtures()
    folds = base._folds(11, weighted=False)
    jms = J.train_gbdt_folds(folds, J.GBDTParams(**base.COMMON, use_binlane_hist=True,
                                                 hist_dtype=mode),
                             early_stopping_rounds=base.ES, pad_rows_to=384)
    tms = T.train_gbdt_folds(folds, T.GBDTParams(**base.COMMON, hist_dtype=mode),
                             early_stopping_rounds=base.ES, pad_rows_to=384, device="cpu")
    for jm, tm in zip(jms, tms):
        base._assert_same_forest(jm, tm)
        np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    binned, node_q, gh = _t(*_fixture(2))
    hist_cuda.reset_launches()
    a = hist_cuda.build_histograms_bf16(binned, node_q, gh, 2, NBT)
    b = hist_cuda.build_histograms_i8(binned, node_q, gh, 2, NBT)
    assert hist_cuda.bf16_launches == 0 and hist_cuda.i8_launches == 0
    assert torch.equal(a, hist_cuda.build_histograms_bf16_plain(binned, node_q, gh, 2, NBT))
    assert torch.equal(b, hist_cuda.build_histograms_i8_plain(binned, node_q, gh, 2, NBT))
    with pytest.raises(ValueError):
        hist_cuda.build_histograms_i8(binned.to("meta"), node_q.to("meta"), gh.to("meta"),
                                      2, NBT)


@pytest.mark.cuda
def test_mode_kernels_match_plain_and_repeat_bit_for_bit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    for n_nodes in (1, 4, 8, 11, 17):
        binned, node_q, gh = (torch.from_numpy(a).cuda() for a in _fixture(n_nodes))
        node_q[:, 1::9] = -1  # outside [0, k_nodes): inactive
        hist_cuda.reset_launches()
        a5 = hist_cuda.build_histograms_i8(binned, node_q, gh, n_nodes, NBT)
        b5 = hist_cuda.build_histograms_i8(binned, node_q, gh, n_nodes, NBT)
        a4 = hist_cuda.build_histograms_bf16(binned, node_q, gh, n_nodes, NBT)
        b4 = hist_cuda.build_histograms_bf16(binned, node_q, gh, n_nodes, NBT)
        torch.cuda.synchronize()
        assert (hist_cuda.i8_launches, hist_cuda.bf16_launches, hist_cuda.launches) == (2, 2, 0)
        assert torch.equal(a5, b5) and torch.equal(a4, b4)
        assert torch.equal(a5, hist_cuda.build_histograms_i8_plain(binned, node_q, gh, n_nodes,
                                                                    NBT))
        assert torch.equal(a4, hist_cuda.build_histograms_bf16_fixed(binned, node_q, gh, n_nodes,
                                                                      NBT))
        want = hist_cuda.build_histograms_plain(binned, node_q, gh.double(), n_nodes, NBT)
        np.testing.assert_allclose(a4.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL)


def test_launch_inputs_take_an_external_maximum():
    """An external launch's inputs: K5's digits at the s of the given
    ``amax`` (not the rows' own), K4's digits with the given maxima as the
    scale."""
    tg = torch.from_numpy(_fixture(2)[2])
    amax = tg.abs().amax(dim=1) * 2.0
    d5, s5 = hist_cuda.launch_inputs(True, tg, amax)
    assert torch.equal(s5, amax) and torch.equal(d5, hist_cuda.quantize_gh_i8(tg, amax)[0])
    assert not torch.equal(d5, hist_cuda.quantize_gh_i8(tg)[0])
    m = hist_cuda.digit_maxabs(tg) * 4.0
    d4, m4 = hist_cuda.launch_inputs(False, tg, m)
    assert m4 is m and torch.equal(d4, hist_cuda.split_gh_digits(tg))


@pytest.mark.cuda
def test_mode_external_entries_match_twins_on_the_card():
    """K4's and K5's external-scale entries against their plain twins bit
    for bit, over two halves of the rows at one global scale: the halves
    add up to the whole launch, whose conversion is the float32 launch's
    histogram (NaN lanes included); an external K5 beyond 2^25 rows
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    for n_nodes in (1, 8, 17):
        binned, node_q, gh = (torch.from_numpy(a).cuda() for a in _fixture(n_nodes))
        gh[1, 11, 0] = float("nan")
        halves = [slice(0, N // 3), slice(N // 3, N)]
        parts = [(binned[:, :, s].contiguous(), node_q[:, s].contiguous(),
                  gh[:, s].contiguous()) for s in halves]
        m = torch.maximum(*[hist_cuda.digit_maxabs(p[2]) for p in parts])
        a = hist_cuda.amax_of(torch.maximum(*[hist_cuda.amax_parts(p[2]) for p in parts]))
        hist_cuda.reset_launches()
        s4 = [hist_cuda.build_histograms_bf16_i64(*p, n_nodes, NBT, m, N) for p in parts]
        s5 = [hist_cuda.build_histograms_i8_sums(*p, n_nodes, NBT, a, N) for p in parts]
        torch.cuda.synchronize()
        assert (hist_cuda.bf16_i64_launches, hist_cuda.i8_sums_launches) == (2, 2)
        assert hist_cuda.bf16_launches == hist_cuda.i8_launches == 0
        for p, x4, x5 in zip(parts, s4, s5):
            assert torch.equal(x4, hist_cuda.build_histograms_bf16_i64_fixed(*p, n_nodes, NBT,
                                                                            m, N))
            assert torch.equal(x5, hist_cuda.build_histograms_i8_sums_fixed(*p, n_nodes, NBT,
                                                                           a, N))
        assert torch.equal(s4[0] + s4[1],
                           hist_cuda.build_histograms_bf16_i64(binned, node_q, gh, n_nodes,
                                                               NBT, m, N))
        assert torch.equal(s5[0] + s5[1],
                           hist_cuda.build_histograms_i8_sums(binned, node_q, gh, n_nodes,
                                                              NBT, a, N))
        f4 = hist_cuda.build_histograms_bf16(binned, node_q, gh, n_nodes, NBT)
        f5 = hist_cuda.build_histograms_i8(binned, node_q, gh, n_nodes, NBT)
        for got, want in ((hist_cuda.from_bf16_sums(s4[0] + s4[1], m, N), f4),
                          (hist_cuda.from_i8_sums(s5[0] + s5[1], a), f5)):
            assert torch.equal(got.isnan(), want.isnan())
            assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        assert torch.isnan(f4[1]).all() and torch.isnan(f5[1, ..., 0]).all()
    with pytest.raises(ValueError, match="2\\^25"):
        hist_cuda.build_histograms_i8_sums(binned, node_q, gh, 1, NBT, a, 2 ** 25 + 1)


# ---------------------------------------------------------------------------
# K4's accumulation: six int64 fixed-point channels as pairs of 32-bit words
# ---------------------------------------------------------------------------

def _split_word_sums(cells, q, n_cells, order_lo, order_hi):
    """csrc/hist.cu ``add_fixed<C>`` in numpy: channel c's sum of a cell as a
    low word (plane 2 c) and a high word (plane 2 c + 1) of uint32, an
    item's low words added first (each add returning the old word, wrapping
    mod 2^32), its high words later, each with q's high word plus the carry
    of its low add (old + lo wrapped). The items' low adds run in
    ``order_lo`` and their high adds in ``order_hi``: any interleaving the
    card's atomics may take. Returns the [n_cells, C] int64 sums the
    epilogue reads (high << 32 | low)."""
    C = q.shape[1]
    words = np.zeros((2 * C, n_cells), np.uint64)  # each holds a uint32
    u = q.astype(np.uint64)  # two's complement bits
    lo, hi = u & np.uint64(0xFFFFFFFF), u >> np.uint64(32)
    carry = np.zeros(q.shape, np.uint64)
    for i in order_lo:
        for c in range(C):
            old = words[2 * c, cells[i]]
            words[2 * c, cells[i]] = (old + lo[i, c]) & np.uint64(0xFFFFFFFF)
            carry[i, c] = old > (~lo[i, c] & np.uint64(0xFFFFFFFF))
    for i in order_hi:
        for c in range(C):
            h = (hi[i, c] + carry[i, c]) & np.uint64(0xFFFFFFFF)
            words[2 * c + 1, cells[i]] = (words[2 * c + 1, cells[i]] + h) & np.uint64(0xFFFFFFFF)
    return ((words[1::2] << np.uint64(32)) | words[0::2]).T.astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_six_channel_split_word_add_is_the_int64_sum(seed):
    # negative q, q at the low word's edges (wraps on every add) and q up to
    # K4's largest fixed point (2^62 over the rows), into a few crowded cells
    rng = np.random.default_rng(seed)
    n, C, n_cells = 600, 6, 7
    edges = np.array([-1, 1, 2 ** 32 - 1, 2 ** 32, -2 ** 32, 2 ** 32 + 1, -(2 ** 32) + 1,
                      -(2 ** 52), 2 ** 52], dtype=np.int64)
    q = rng.integers(-2 ** 52, 2 ** 52, (n, C))
    pick = rng.random((n, C)) < 0.4
    q[pick] = rng.choice(edges, size=int(pick.sum()))
    cells = rng.integers(0, n_cells, n)
    want = np.zeros((n_cells, C), np.int64)
    np.add.at(want, cells, q)  # int64 sums (these stay within int64)
    in_order = np.arange(n)
    for order_lo, order_hi in ((in_order, in_order), (rng.permutation(n), rng.permutation(n)),
                               (in_order[::-1], rng.permutation(n))):
        got = _split_word_sums(cells, q, n_cells, order_lo, order_hi)
        assert np.array_equal(got, want)


def test_split_word_sums_are_the_k4_twins_sums():
    # the int64 sums K4's external entry writes, for the twin's own q: the
    # split-word add of every (row, feature) item gives them bit for bit
    binned, node_q, gh = _t(*_fixture(3))
    tg = gh.clone()
    tg[0, :7] *= -1e3  # large negative g: high words of all ones
    m = hist_cuda.digit_maxabs(tg)
    want = hist_cuda.build_histograms_bf16_i64_fixed(binned, node_q, tg, 3, NBT, m, N)
    q, _, _ = hist_cuda._fixed_point(hist_cuda.split_gh_digits(tg).float(), m, N)
    for k in range(K):
        for f in (0, F - 1):
            b, nq = binned[k, f].long().numpy(), node_q[k].long().numpy()
            act = (nq >= 0) & (nq < 3) & (b >= 0) & (b < NBT)
            cells = (nq * NBT + b)[act]
            got = _split_word_sums(cells, q[k].numpy()[act], 3 * NBT, np.arange(act.sum()),
                                   np.arange(act.sum())[::-1])
            assert np.array_equal(got.reshape(3, NBT, 6), want[k, f].numpy())


@pytest.mark.cuda
def test_k4_at_the_v92d_level_equals_its_twins_on_the_card():
    """K4 at the v92d CV's deepest level (K = 5, F = 222, N = 2,444, 8
    nodes), both entries on the fit's prepared digits, with a lane that is
    not finite beside finite ones: bit for bit the fixed-point twins, and
    two launches equal."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    rng = np.random.default_rng(92)
    Kv, Fv, Nv, nodes = 5, 222, 2444, 8
    binned = torch.from_numpy(rng.integers(0, NBT, (Kv, Fv, Nv)).astype(np.int16)).cuda()
    node_q = torch.from_numpy(rng.integers(-1, nodes + 1, (Kv, Nv)).astype(np.int32)).cuda()
    gh = torch.from_numpy(np.stack([rng.normal(size=(Kv, Nv)) * 3,
                                    rng.uniform(0.01, 0.25, (Kv, Nv))], -1)
                          .astype(np.float32)).cuda()
    gh[2, 17, 1] = float("inf")
    lv = (binned, node_q, gh, nodes, NBT)
    hist_cuda.reset_launches()
    own = hist_cuda.prepare_digits(False, gh)
    a, b = (hist_cuda.mode_hist(binned, node_q, own, nodes, NBT) for _ in range(2))
    m = hist_cuda.digit_maxabs(gh)
    ext = hist_cuda.prepare_digits(False, gh, m)
    e1, e2 = (hist_cuda.mode_hist(binned, node_q, ext, nodes, NBT, Nv) for _ in range(2))
    torch.cuda.synchronize()
    assert (hist_cuda.bf16_launches, hist_cuda.bf16_i64_launches) == (2, 2)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)) and torch.equal(e1, e2)
    # the finite lanes bit for bit; the twin's NaN lane went through the
    # card's float adds, which make every NaN 0x7FFFFFFF (the kernel writes
    # 0x7FC00000), so that lane is held by NaN alone
    want = hist_cuda.build_histograms_bf16_fixed(*lv)
    fin = [k for k in range(Kv) if k != 2]
    assert torch.equal(a[fin].view(torch.int32), want[fin].view(torch.int32))
    assert torch.isnan(a[2]).all() and torch.isnan(want[2]).all()
    assert torch.equal(e1, hist_cuda.build_histograms_bf16_i64_fixed(*lv, m, Nv))
    assert not (e1[2] != 0).any()
