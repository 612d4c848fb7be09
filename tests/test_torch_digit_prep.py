"""Port vs JAX package: K4 / K5's digits, prepared once a tree.

- The prep step's plain version (``hist_cuda.launch_inputs``, what
  ``prepare_digits`` runs on a CPU tensor) is the jitted
  ``hist_pallas.quantize_gh_i8`` (K5: digits and scales bit for bit) and
  ``split_gh_digits`` (K4: digits bit for bit, a NaN digit NaN on both
  sides: a float32 -> bf16 cast of NaN writes 0xFFFF on torch's CPU, 0x7FC0
  under XLA:CPU and 0x7FFF on the card, and no histogram reads a NaN
  digit's bits, since its lane is NaN; the subnormal lane only against
  K5's, since XLA:CPU flushes K4's subnormal differences to zero), lane by
  lane, on lanes of zeros, of ties at half a unit (K5's x / s 2^26 at
  k + 1/2, K4's x halfway between two bf16 values), with a NaN, with +inf
  and with -inf; K4's maxima follow
  ``lane_maxabs`` (+inf in every channel of a lane with a non-finite
  digit); given a mesh's scale, K5 quantizes at it and K4 returns it.
- ``mode_hist`` on prepared digits is the (g, h) entries bit for bit, on
  both scales.
- A fit prepares the digits once a tree and launches the mode kernel at
  every level, in every depthwise path: plain, symmetric, multiclass lanes,
  DART, a CV's folds, a caller's own ``LevelHist`` (``hist_fn=``) and a
  world-size-1 mesh (counted through the plain versions: ``launch_inputs``
  once a tree, ``mode_hist_plain`` rounds x depth).
- On the card (``cuda``): the prep kernel bit for bit its plain version
  run on the card, in both entries (a lane's own scale and a mesh's),
  K = 5 and 25 lanes of 2,444 rows with zero, tie, NaN and infinite lanes;
  a fit in each mode launches the prep kernel once a tree, and the mode
  kernel rounds x depth times, its forest bit for bit its plain twin's.

The machine with the card has no JAX, so the JAX package is imported inside
the tests that use it (``pytest --noconftest -m cuda
tests/test_torch_digit_prep.py`` there).
"""

import functools

import numpy as np
import pytest
import torch

from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.trees import gbdt as T

torch.set_num_threads(2)

NBT = 257


def _lanes(n=2444, seed=3):
    """(g, h) [9, n, 2] float32: logistic-shaped lanes, then one of zeros
    (and -0.0), one of K5's ties (x / s 2^26 = k + 1/2 exactly, s = 1), one
    of K4's ties (x halfway between two bf16 values), one with a NaN g, one
    with +inf h, one with -inf g, one of subnormal and huge values, one with
    a NaN h beside an inf g."""
    rng = np.random.default_rng(seed)
    p = rng.random((9, n))
    y = rng.random((9, n)) < 0.2
    w = rng.uniform(0.5, 2.0, (9, n))
    gh = np.stack([w * (p - y), w * p * (1 - p)], -1).astype(np.float32)
    gh[1] = 0.0
    gh[1, ::3, 0] = -0.0
    k = rng.integers(-2 ** 20, 2 ** 20, size=(n, 2))
    gh[2] = (k + 0.5) / 2.0 ** 26  # exact in float32: |k + 1/2| < 2^21
    gh[2, 0] = 1.0  # s = 1 in both channels
    gh[2, 1, 1] = -1.0
    m = rng.integers(0, 128, size=(n, 2))  # 1 + (m + 1/2) 2^-7: a bf16 tie
    gh[3] = ((1.0 + (m + 0.5) / 128.0) * np.where(rng.random((n, 2)) < 0.5, -1, 1)
             * 2.0 ** rng.integers(-20, 20, size=(n, 2))).astype(np.float32)
    gh[4, 7, 0] = np.nan
    gh[5, 11, 1] = np.inf
    gh[6, 13, 0] = -np.inf
    gh[7, ::2] *= 1e-39  # subnormal
    gh[7, 1::4] *= 3e37
    gh[8, 5, 1] = np.nan
    gh[8, 9, 0] = np.inf
    return gh


def _bits(t):
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(t.dtype,
                                                                                 t.dtype))


@pytest.fixture(scope="module")
def lanes():
    return _lanes()


def test_i8_prep_plain_is_jitted_quantize_gh_i8_bit_for_bit(lanes):
    import jax
    import jax.numpy as jnp

    from mallorn_tpu.ops import hist_pallas as hp

    quantize = jax.jit(hp.quantize_gh_i8)
    got = hist_cuda.launch_inputs(True, torch.from_numpy(lanes))
    assert got.digits.dtype == torch.int8 and tuple(got.digits.shape) == lanes.shape[:2] + (8,)
    for k in range(len(lanes)):
        gd, s_g, s_h = quantize(jnp.asarray(lanes[k, :, 0]), jnp.asarray(lanes[k, :, 1]))
        np.testing.assert_array_equal(got.digits[k].numpy(), np.asarray(gd), err_msg=f"lane {k}")
        want = np.array([s_g, s_h], np.float32)
        np.testing.assert_array_equal(_bits(got.scale[k]).numpy(), want.view(np.int32))
    # the ties rounded to even: q = k + 1/2 -> the even neighbour
    q = lanes[2] * 2.0 ** 26
    d = got.digits[2].numpy().astype(np.int64)
    rec = d[:, 0] + 128 * d[:, 1] + 128 ** 2 * d[:, 2] + 128 ** 3 * d[:, 3]
    assert (rec[2:] == np.round(q[2:, 0])).all() and (rec[2:] % 2 == 0).all()


def test_bf16_prep_plain_is_jitted_split_gh_digits(lanes):
    import jax
    import jax.numpy as jnp

    from mallorn_tpu.ops import hist_pallas as hp

    split = jax.jit(hp.split_gh_digits)
    got = hist_cuda.launch_inputs(False, torch.from_numpy(lanes))
    assert got.digits.dtype == torch.bfloat16 and got.digits.is_contiguous()
    # not lane 7: XLA:CPU flushes a subnormal difference x - d0 to zero,
    # where torch (and the card) keep it (-0.0 against +0.0 there)
    for k in (0, 1, 2, 3, 4, 5, 6, 8):
        want = np.asarray(split(jnp.asarray(lanes[k, :, 0]), jnp.asarray(lanes[k, :, 1])))
        mine = got.digits[k].float().numpy()
        want = want.astype(np.float32)
        np.testing.assert_array_equal(np.isnan(mine), np.isnan(want), err_msg=f"lane {k}")
        fin = ~np.isnan(want)
        np.testing.assert_array_equal(mine[fin].view(np.int32), want[fin].view(np.int32),
                                      err_msg=f"lane {k}")
    # K4's ties went to the even bf16 neighbour: d0's last mantissa bit is 0
    assert ((_bits(got.digits[3, :, [0, 3]]).numpy() & 1) == 0).all()
    # the maxima: lane_maxabs of the digits, +inf in every channel of lanes 4-6, 8
    m = got.scale.numpy()
    assert np.isinf(m[[4, 5, 6, 8]]).all() and np.isfinite(m[[0, 1, 2, 3, 7]]).all()
    np.testing.assert_array_equal(m[:4], np.abs(got.digits[:4].float().numpy()).max(axis=1))
    assert (m[1] == 0).all()


def test_prep_plain_takes_a_mesh_scale(lanes):
    """Given a mesh's scale: K5's digits at s = max(amax, 1e-30) of that
    amax, its NaN kept; K4's digits as ever, the maxima returned as given."""
    tg = torch.from_numpy(lanes)
    amax = hist_cuda.amax_of(hist_cuda.amax_parts(tg)) * 2.0
    d5 = hist_cuda.launch_inputs(True, tg, amax)
    assert torch.equal(_bits(d5.scale), _bits(torch.clamp(amax, min=1e-30)))
    assert torch.equal(d5.digits, hist_cuda.quantize_gh_i8(tg, amax)[0])
    assert not torch.equal(d5.digits, hist_cuda.launch_inputs(True, tg).digits)
    assert torch.isnan(d5.scale[4, 0]) and torch.isinf(d5.scale[5, 1])
    m = hist_cuda.digit_maxabs(tg) * 4.0
    d4 = hist_cuda.launch_inputs(False, tg, m)
    assert d4.scale is m and torch.equal(_bits(d4.digits), _bits(hist_cuda.split_gh_digits(tg)))


@pytest.mark.parametrize("int8", [True, False])
def test_mode_hist_on_prepared_digits_is_the_gh_entries(int8):
    """``mode_hist`` on ``prepare_digits``' output equals the (g, h)
    entries bit for bit on the CPU, on the folds' own scale and on a mesh's
    (the raw integer sums)."""
    rng = np.random.default_rng(5)
    K, F, N, nodes = 3, 7, 400, 4
    binned = torch.from_numpy(rng.integers(0, NBT, size=(K, F, N)).astype(np.int16))
    node_q = torch.from_numpy(rng.integers(0, nodes + 1, size=(K, N)).astype(np.int32))
    gh = torch.from_numpy(_lanes(N)[[0, 3, 4]])
    own = hist_cuda.mode_hist(binned, node_q, hist_cuda.prepare_digits(int8, gh), nodes, NBT)
    entry = hist_cuda.build_histograms_i8 if int8 else hist_cuda.build_histograms_bf16
    assert torch.equal(_bits(own), _bits(entry(binned, node_q, gh, nodes, NBT)))
    if int8:
        scale = hist_cuda.amax_of(hist_cuda.amax_parts(gh))
        ext = hist_cuda.build_histograms_i8_sums(binned, node_q, gh, nodes, NBT, scale, 2 * N)
    else:
        scale = hist_cuda.digit_maxabs(gh)
        ext = hist_cuda.build_histograms_bf16_i64(binned, node_q, gh, nodes, NBT, scale, 2 * N)
    got = hist_cuda.mode_hist(binned, node_q, hist_cuda.prepare_digits(int8, gh, scale), nodes,
                              NBT, 2 * N)
    assert got.dtype == ext.dtype and torch.equal(got, ext)


def _fit_data(n=160, f=6, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 2]) > 0.1).astype(np.float32)
    return X, y


@pytest.fixture
def counted(monkeypatch):
    """Counts the plain prep step (``launch_inputs``) and the plain level
    launches (``mode_hist_plain``) that a CPU fit makes."""
    calls = {"prep": 0, "level": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(hist_cuda, "launch_inputs", counting("prep", hist_cuda.launch_inputs))
    monkeypatch.setattr(hist_cuda, "mode_hist_plain",
                        counting("level", hist_cuda.mode_hist_plain))
    return calls


PATHS = {
    "depthwise": dict(),
    "symmetric": dict(grow_policy="symmetric"),
    "multiclass": dict(num_class=3),
    "dart": dict(dart_rate=0.2),
}


@pytest.mark.parametrize("mode", ["int8", "i8bf16"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_fit_prepares_once_a_tree(counted, mode, path):
    X, y = _fit_data()
    if path == "multiclass":
        y = (np.nan_to_num(X[:, 1]) > 0.3).astype(np.float32) + (
            np.nan_to_num(X[:, 3]) > 0.5).astype(np.float32)
    p = T.GBDTParams(n_rounds=4, max_depth=3, learning_rate=0.3, hist_dtype=mode,
                     **PATHS[path])
    T.train_gbdt(X, y, p, device="cpu")
    # with subtraction every level launches once; a multiclass round's
    # class trees are lanes of one tree
    assert counted == {"prep": 4, "level": 4 * 3}


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_cv_folds_and_callers_prepare_once_a_tree(counted, mode, tmp_path):
    """A CV's folds (one batched fit), a caller's own ``LevelHist`` given
    as ``hist_fn`` and a world-size-1 mesh (in process): one prep a tree,
    rounds x depth level launches, the same forests."""
    from mallorn_tpu_torch.parallel import mesh as M
    from mallorn_tpu_torch.parallel import sharded_train as S

    X, y = _fit_data(seed=4)
    p = T.GBDTParams(n_rounds=5, max_depth=3, learning_rate=0.3, hist_dtype=mode,
                     hist_subtract=False)
    folds = [dict(X=X[i::2], y=y[i::2], X_val=X[1 - i::2], y_val=y[1 - i::2]) for i in (0, 1)]
    cv = T.train_gbdt_folds(folds, p, device="cpu")
    assert counted == {"prep": 5, "level": 5 * 3}
    mine = T.LevelHist(functools.partial(hist_cuda.prepare_digits, mode == "int8"),
                       hist_cuda.mode_hist)
    a = T.train_gbdt(X, y, p, device="cpu")
    b = T.train_gbdt(X, y, p, device="cpu", hist_fn=mine)
    assert counted == {"prep": 15, "level": 45}
    assert all(torch.equal(u, v) for u, v in zip(a.forest, b.forest))
    sharded = M.launch(S.train_gbdt_sharded, 1, (X, y, p), spawn=False, workdir=tmp_path)
    assert counted == {"prep": 20, "level": 60}
    assert all(torch.equal(u, v) for u, v in zip(a.forest, sharded.forest))
    assert len(cv) == 2


# ------------------------------------------------------------------ the card

def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the prep kernel runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [5, 25])
def test_prep_kernel_is_its_plain_version_on_the_card(K):
    _on_card()
    base = torch.from_numpy(_lanes())
    gh = torch.cat([base] * (K // 9 + 1))[:K].contiguous().cuda()
    amax = hist_cuda.amax_of(hist_cuda.amax_parts(gh)).contiguous()
    maxima = hist_cuda.digit_maxabs(gh).contiguous()
    for int8, ext in ((True, None), (True, amax), (True, amax * 3.0), (False, None),
                      (False, maxima)):
        hist_cuda.reset_launches()
        got = hist_cuda.prepare_digits(int8, gh, ext)
        again = hist_cuda.prepare_digits(int8, gh, ext)
        want = hist_cuda.launch_inputs(int8, gh, ext)
        torch.cuda.synchronize()
        assert hist_cuda.digit_prep_launches == 2
        for a in (got, again):
            assert torch.equal(_bits(a.digits), _bits(want.digits)), (int8, ext is None)
            bad = (_bits(a.scale) != _bits(want.scale)).nonzero().tolist()
            assert not bad, [(i, _bits(a.scale)[tuple(i)].item(), _bits(want.scale)[tuple(i)].item())
                             for i in bad]
        if not int8 and ext is not None:
            assert got.scale is ext


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "i8bf16"])
def test_a_fit_on_the_card_prepares_once_a_tree(mode):
    _on_card()
    X, y = _fit_data(n=600, f=12)
    p = T.GBDTParams(n_rounds=6, max_depth=4, learning_rate=0.3, hist_dtype=mode)
    hist_cuda.reset_launches()
    got = T.train_gbdt(X, y, p, device="cuda")
    torch.cuda.synchronize()
    level = hist_cuda.i8_launches if mode == "int8" else hist_cuda.bf16_launches
    assert (hist_cuda.digit_prep_launches, level, hist_cuda.launches) == (6, 6 * 4, 0)
    twin = (hist_cuda.build_histograms_i8_plain if mode == "int8"
            else hist_cuda.build_histograms_bf16_fixed)
    want = T.train_gbdt(X, y, p, device="cuda", hist_fn=twin)
    for u, v in zip(got.forest, want.forest):
        assert torch.equal(_bits(u.cpu()) if u.is_floating_point() else u.cpu(),
                           _bits(v.cpu()) if v.is_floating_point() else v.cpu())
