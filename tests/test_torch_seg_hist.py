"""Port vs JAX package: the leaf-wise segment histogram (K3).

``build_seg_histograms_plain`` (the CUDA kernel's plain PyTorch version,
which is what ``build_seg_histograms`` runs on a CPU tensor) against
``hist_pallas.build_histograms_pallas`` in Pallas interpret mode, lane by
lane, on the fixture of tests/test_hist_pallas.py::test_matches_segment_sum
(n 700, f 5, 4 nodes x 65 bins, some rows inactive) with 2 lanes, at that
test's bar: rtol 1e-5, atol 1e-4. The kernel's fixed-point arithmetic in
plain PyTorch (``build_seg_histograms_fixed``, bit for bit the kernel) is
within one float32 rounding of the float64 plain version. Also on the
CPU: the wrapper against the Pallas kernel at the v114d member's own
layout (2 nodes x 257 bins, 70% of rows inactive), the per-lane NaN rule
for NaN and infinities in g and in h, and the kernel's shared-memory
layout rule (``seg_hist_layout``) up to its limit, its byte sum equal to
the kernel source's ``seg_smem_bytes``. The kernel itself is
held against both on the card (the ``cuda`` cases below: bit for bit
against ``build_seg_histograms_fixed`` at N = 1, 17 and 2,443 with F not
a multiple of the features per CTA, an all-inactive lane, a NaN lane
beside finite ones, the segment limit, two launches equal and counted;
and ``chip_smoke.py``); run them there as
``pytest --noconftest -m cuda tests/test_torch_seg_hist.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.ops.hist_cuda import (SEG_MAX_SEGMENTS, SMEM_BYTES, build_seg_histograms,
                                             build_seg_histograms_fixed,
                                             build_seg_histograms_plain, seg_hist_layout)

torch.set_num_threads(2)

K, N, F, NBT, NODES = 2, 700, 5, 65, 4
N_SEG = NODES * NBT
RTOL, ATOL = 1e-5, 1e-4


def _fixture(seed=0):
    """bins [K, F, N] int16, segment bases [K, N] int32 (node * NBT, an
    inactive share at N_SEG and beyond), gh [K, N, 2] float32."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, NBT, size=(K, F, N)).astype(np.int16)
    node = rng.integers(0, NODES + 1, size=(K, N))
    seg_base = np.where(node < NODES, node * NBT, N_SEG + rng.integers(0, 10, size=(K, N)))
    gh = rng.normal(size=(K, N, 2)).astype(np.float32)
    return binned, seg_base.astype(np.int32), gh


def _oracle(binned, seg_base, gh):
    out = np.zeros((K, F, N_SEG, 2), np.float64)
    for k in range(K):
        for f in range(F):
            s = seg_base[k] + binned[k, f]
            act = seg_base[k] < N_SEG
            np.add.at(out[k, f], s[act], gh[k, act].astype(np.float64))
    return out


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_plain_matches_pallas_interpret_and_f64():
    import jax.numpy as jnp

    from mallorn_tpu.ops.hist_pallas import build_histograms_pallas

    binned, seg_base, gh = _fixture()
    got = build_seg_histograms(*_t(binned, seg_base, gh), N_SEG).numpy()
    assert got.shape == (K, F, N_SEG, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, _oracle(binned, seg_base, gh), rtol=RTOL, atol=ATOL)
    for k in range(K):
        # the JAX package's own composition of the ids (gbdt.py:254-258)
        seg = np.where(seg_base[k] < N_SEG, seg_base[k] + binned[k].astype(np.int32), N_SEG)
        want = build_histograms_pallas(jnp.asarray(seg.astype(np.int32)), jnp.asarray(gh[k]),
                                       N_SEG, row_chunk=256, interpret=True)
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=RTOL, atol=ATOL)


def test_fixed_point_version_is_the_exact_sum_rounded_once():
    binned, seg_base, gh = _fixture(1)
    got = build_seg_histograms_fixed(*_t(binned, seg_base, gh), N_SEG)
    f64 = build_seg_histograms_plain(*_t(binned, seg_base, gh.astype(np.float64)), N_SEG)
    assert got.dtype == torch.float32 and f64.dtype == torch.float64
    np.testing.assert_allclose(f64.numpy(), _oracle(binned, seg_base, gh), rtol=1e-12,
                               atol=1e-12)
    # within one float32 ulp of the exact (float64) sum
    want = f64.numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert (np.abs(got.numpy().astype(np.float64) - want) <= ulp).all()
    gh[1, 3, 1] = np.nan
    got = build_seg_histograms_fixed(*_t(binned, seg_base, gh), N_SEG).numpy()
    assert np.isnan(got[1]).all() and np.isfinite(got[0]).all()


def test_root_and_pair_shapes_and_cpu_counts_no_launch():
    """The leaf-wise fit's two calls: the root (one node, every row active)
    and a pair of children (2 nodes, most rows inactive)."""
    binned, _, gh = _fixture(2)
    hist_cuda.reset_launches()
    root = build_seg_histograms(*_t(binned, np.zeros((K, N), np.int32), gh), NBT).numpy()
    np.testing.assert_allclose(root.sum(axis=2), np.broadcast_to(gh.sum(1)[:, None], (K, F, 2)),
                               rtol=1e-4, atol=1e-4)
    rng = np.random.default_rng(3)
    pair = np.where(rng.random((K, N)) < 0.7, 2 * NBT, rng.integers(0, 2, (K, N)) * NBT)
    got = build_seg_histograms(*_t(binned, pair.astype(np.int32), gh), 2 * NBT).numpy()
    act = pair < 2 * NBT
    for k in range(K):
        np.testing.assert_allclose(got[k].sum(axis=1), np.broadcast_to(
            gh[k, act[k]].sum(0), (F, 2)), rtol=1e-4, atol=1e-4)
    assert hist_cuda.seg_launches == 0
    with pytest.raises(ValueError):
        build_seg_histograms(*(torch.empty(s, device="meta") for s in ((K, F, N), (K, N), (K, N, 2))),
                             NBT)


@pytest.mark.cuda
def test_kernel_matches_plain_and_repeats_bit_for_bit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    binned, seg_base, gh = (t.cuda() for t in _t(*_fixture(4)))
    hist_cuda.reset_launches()
    a = build_seg_histograms(binned, seg_base, gh, N_SEG)
    b = build_seg_histograms(binned, seg_base, gh, N_SEG)
    assert hist_cuda.seg_launches == 2
    assert torch.equal(a, b)
    assert torch.equal(a, build_seg_histograms_fixed(binned, seg_base, gh, N_SEG))
    want = build_seg_histograms_plain(binned, seg_base, gh.double(), N_SEG)
    np.testing.assert_allclose(a.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL)


# the leaf-wise fit's split step (trees/gbdt.py ``_train_tree_lossguide``):
# 2 nodes x 257 bins, rows outside the split leaf at 2 x 257
NBT_FIT = 257
N_SEG_FIT = 2 * NBT_FIT


def _split_step(K=2, F=6, N=300, inactive=0.7, seed=5):
    """bins [K, F, N] int16 over all 257 bins (256 = missing), segment
    bases [K, N] int32 as the fit composes them after a split (left child
    0, right child 257, every other row 514), gh [K, N, 2] float32."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, NBT_FIT, size=(K, F, N)).astype(np.int16)
    binned[rng.random((K, F, N)) < 0.2] = NBT_FIT - 1
    at_l = rng.random((K, N)) >= inactive
    right = rng.random((K, N)) < 0.5
    seg_base = np.where(at_l, np.where(right, NBT_FIT, 0), N_SEG_FIT).astype(np.int32)
    gh = np.stack([rng.normal(size=(K, N)), rng.uniform(0.01, 0.25, size=(K, N))],
                  axis=-1).astype(np.float32)
    return binned, seg_base, gh


def test_split_step_layout_matches_pallas_interpret():
    import jax.numpy as jnp

    from mallorn_tpu.ops.hist_pallas import build_histograms_pallas

    binned, seg_base, gh = _split_step()
    got = build_seg_histograms(*_t(binned, seg_base, gh), N_SEG_FIT).numpy()
    fixed = build_seg_histograms_fixed(*_t(binned, seg_base, gh), N_SEG_FIT).numpy()
    assert got.shape == (2, 6, N_SEG_FIT, 2)
    for k in range(2):
        # the JAX package's composition (mallorn_tpu/trees/gbdt.py:261)
        seg = np.where(seg_base[k] < N_SEG_FIT, seg_base[k] + binned[k].astype(np.int32),
                       N_SEG_FIT)
        want = np.asarray(build_histograms_pallas(jnp.asarray(seg.astype(np.int32)),
                                                  jnp.asarray(gh[k]), N_SEG_FIT,
                                                  row_chunk=256, interpret=True))
        np.testing.assert_allclose(got[k], want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(fixed[k], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("channel", [0, 1], ids=["g", "h"])
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf], ids=["nan", "inf", "-inf"])
def test_fixed_point_nan_rule_is_per_lane(value, channel):
    """One non-finite g or h makes every cell of its lane NaN (fixed point
    cannot carry it) and leaves the other lanes as they were."""
    binned, seg_base, gh = _split_step(inactive=0.3, seed=6)
    clean = build_seg_histograms_fixed(*_t(binned, seg_base, gh), N_SEG_FIT)
    gh[1, 17, channel] = value
    got = build_seg_histograms_fixed(*_t(binned, seg_base, gh), N_SEG_FIT)
    assert torch.isnan(got[1]).all()
    assert torch.equal(got[0], clean[0]) and torch.isfinite(got[0]).all()


@pytest.mark.parametrize("n_seg", [1, 257, 514, 2056, SEG_MAX_SEGMENTS])
def test_seg_hist_layout_fits_shared_memory(n_seg):
    group, rows, smem = seg_hist_layout(n_seg)
    assert group >= 1 and rows >= hist_cuda.SEG_THREADS and rows % hist_cuda.SEG_THREADS == 0
    assert smem == hist_cuda._seg_smem_bytes(n_seg, group, rows) <= SMEM_BYTES == 232448
    if n_seg <= N_SEG_FIT:  # the fit's widths take the timed layout
        assert (group, rows) == (hist_cuda.SEG_GROUP, hist_cuda.SEG_TILE_ROWS)


def test_seg_hist_layout_refuses_beyond_its_limit():
    # one int64 [n_seg, 2] histogram, two 256-row tiles, the list and the
    # reductions fill the 232,448 bytes at 14,004 segments
    assert SEG_MAX_SEGMENTS == 14004
    for n_seg in (0, SEG_MAX_SEGMENTS + 1):
        with pytest.raises(ValueError, match=str(SEG_MAX_SEGMENTS)):
            seg_hist_layout(n_seg)


def _kernel_smem_bytes():
    """csrc/hist.cu's ``seg_smem_bytes`` as a Python function: its
    constants and the two return expressions, read from the source."""
    src = (Path(hist_cuda.__file__).resolve().parents[1] / "csrc" / "hist.cu").read_text()
    env = {}
    for name, expr in re.findall(r"constexpr int (kSeg\w+) = ([^;]+);", src):
        env[name] = eval(expr.replace("/", "//"), {}, env)
    for name, args in (("seg_stage_bytes", "group, rows"), ("seg_smem_bytes", "n_seg, group, rows")):
        body = re.search(rf"size_t {name}\([^)]*\) \{{\s*return ([^;]+);", src)[1]
        body = re.sub(r"static_cast<size_t>\(([^()]*)\)", r"(\1)", " ".join(body.split()))
        env[name] = eval(f"lambda {args}: {body}", env)
    return env


def test_seg_hist_layout_repeats_the_kernel_byte_sum():
    # the launcher refuses a layout by its own sum, the wrapper picks one
    # by this module's; the two must not drift apart
    c = _kernel_smem_bytes()
    assert (c["kSegThreads"], c["kSegStages"]) == (hist_cuda.SEG_THREADS, hist_cuda.SEG_STAGES)
    for n_seg in (0, 1, 257, 514, 2056, SEG_MAX_SEGMENTS):
        for group in (1, 2, 3, 4, 8):
            for rows in (256, 512, 1024, 4096):
                assert (c["seg_smem_bytes"](n_seg, group, rows)
                        == hist_cuda._seg_smem_bytes(n_seg, group, rows)), (n_seg, group, rows)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")


def _kernel_equals_fixed(binned, seg_base, gh, n_seg):
    """The kernel twice on the card: both launches bit for bit equal to
    each other and to ``build_seg_histograms_fixed``, and within the JAX
    package's bar of the float64 plain version; returns the output."""
    binned, seg_base, gh = (torch.as_tensor(a).cuda() for a in (binned, seg_base, gh))
    a = build_seg_histograms(binned, seg_base, gh, n_seg)
    b = build_seg_histograms(binned, seg_base, gh, n_seg)

    def bits(t):  # bit for bit, NaN included
        return t.view(torch.int32)

    assert torch.equal(bits(a), bits(b))
    assert torch.equal(bits(a), bits(build_seg_histograms_fixed(binned, seg_base, gh, n_seg)))
    want = build_seg_histograms_plain(binned, seg_base, gh.double(), n_seg)
    lanes = torch.isfinite(gh).flatten(1).all(dim=1)  # the others are NaN throughout
    np.testing.assert_allclose(a[lanes].cpu().numpy(), want[lanes].cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [1, 17, 2443])
def test_kernel_bit_for_bit_at_ragged_rows_and_features(n_rows):
    _cuda_or_skip()
    F_ragged = 2 * hist_cuda.SEG_GROUP + 1  # the last group holds one feature
    binned, seg_base, gh = _split_step(K=3, F=F_ragged, N=n_rows, inactive=0.5, seed=n_rows)
    _kernel_equals_fixed(binned, seg_base, gh, N_SEG_FIT)


@pytest.mark.cuda
def test_kernel_all_inactive_lane_is_zero():
    _cuda_or_skip()
    binned, seg_base, gh = _split_step(K=3, F=7, N=700, seed=8)
    seg_base[1] = N_SEG_FIT
    got = _kernel_equals_fixed(binned, seg_base, gh, N_SEG_FIT)
    assert (got[1] == 0).all() and got[0].abs().sum() > 0


@pytest.mark.cuda
def test_kernel_nan_lane_beside_finite_lanes():
    _cuda_or_skip()
    binned, seg_base, gh = _split_step(K=4, F=7, N=700, seed=9)
    gh[1, 3, 0] = np.nan
    gh[2, 699, 1] = -np.inf
    got = _kernel_equals_fixed(binned, seg_base, gh, N_SEG_FIT)
    assert torch.isnan(got[1]).all() and torch.isnan(got[2]).all()
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[3]).all()


@pytest.mark.cuda
def test_kernel_at_the_segment_limit():
    _cuda_or_skip()
    rng = np.random.default_rng(10)
    binned = rng.integers(0, NBT_FIT, size=(2, 3, 500)).astype(np.int16)
    seg_base = rng.integers(0, SEG_MAX_SEGMENTS - NBT_FIT + 60, size=(2, 500)).astype(np.int32)
    gh = rng.normal(size=(2, 500, 2)).astype(np.float32)
    assert seg_hist_layout(SEG_MAX_SEGMENTS)[2] == SMEM_BYTES
    _kernel_equals_fixed(binned, seg_base, gh, SEG_MAX_SEGMENTS)
    # one segment more takes two windows of segments, the same sums
    assert hist_cuda.seg_hist_plan(SEG_MAX_SEGMENTS + 1)[0] == 2
    _kernel_equals_fixed(binned, seg_base, gh, SEG_MAX_SEGMENTS + 1)
    with pytest.raises(ValueError):
        build_seg_histograms(*(torch.as_tensor(a).cuda() for a in (binned, seg_base, gh)),
                             hist_cuda.SEG_MAX_TOTAL + 1)
