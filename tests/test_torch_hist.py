"""Port vs JAX package: the depthwise level histogram (K1).

``build_histograms_plain`` (the CUDA kernel's plain PyTorch version, which
is what ``build_histograms`` runs on a CPU tensor) against
``hist_pallas.build_histograms_fullhot`` in Pallas interpret mode, fold by
fold, and against a float64 numpy oracle, at the JAX package's bar for
its histogram kernels (tests/test_hist_pallas.py): rtol 1e-5, atol 1e-4.
The fixture is that of ``test_fullhot_matches_binlane_interpret`` (F=37,
N=500, 257 bins, 1/2/8 nodes, inactive rows), with a fold axis of 3. Also
on the CPU: the kernel's layout rule (``hist_layout``: one CTA fits the
shared memory at 1 to 54 nodes of 257 bins and refuses more, and its byte sum is
the kernel source's ``seg_smem_bytes``), and CPU tensors taking the plain
version with no launch counted. The CUDA kernel itself is held against
the plain version on the card (the ``cuda`` cases below: bit for bit
``build_histograms_fixed`` and two launches equal and counted, at 1, 17,
2,443 and 8,143 rows, F = 222 with a ragged last feature group, 1, 8 and
16 nodes, and 64 and 128 nodes in chunks of nodes on the grid's z axis; a
chunked launch bit for bit the one-chunk launch; K1's rule for node ids
and bins out of range, NaN and inf folds beside finite ones, an
all-inactive fold; and ``chip_smoke.py``). On the CPU also the chunking
rule (``hist_plan``: a level of at most 54 nodes is the parent's one
chunk, a wider one the fewest chunks that fit, refused beyond the grid's
z axis) and its arithmetic (the fixed-point histogram of a level is its
chunks' side by side). The
machine with the card has no JAX, so this file imports the JAX package
inside the test that uses it and runs there as
``pytest --noconftest -m cuda tests/test_torch_hist.py``.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.ops.hist_cuda import (SEG_MAX_SEGMENTS, SMEM_BYTES, build_histograms,
                                             build_histograms_fixed, build_histograms_plain,
                                             hist_layout)
from test_torch_seg_hist import _kernel_smem_bytes

torch.set_num_threads(2)

K, F, N, NBT = 3, 37, 500, 257
RTOL, ATOL = 1e-5, 1e-4


def _fixture(n_nodes, seed=5):
    """binned [K, F, N], node ids [K, N] (n_nodes = inactive), gh [K, N, 2]."""
    rng = np.random.default_rng(seed + n_nodes)
    binned = rng.integers(0, NBT, size=(K, F, N)).astype(np.int16)
    node_q = rng.integers(0, n_nodes + 1, size=(K, N)).astype(np.int32)
    g = rng.normal(size=(K, N)).astype(np.float32)
    h = np.abs(g) * 0.25 + 0.01
    return binned, node_q, np.stack([g, h], -1).astype(np.float32)


def _oracle(binned, node_q, gh, n_nodes):
    out = np.zeros((K, F, n_nodes, NBT, 2), np.float64)
    for k in range(K):
        act = node_q[k] < n_nodes
        for f in range(F):
            np.add.at(out[k, f], (node_q[k, act], binned[k, f, act]),
                      gh[k, act].astype(np.float64))
    return out


@pytest.mark.parametrize("n_nodes", [1, 2, 8])
def test_plain_matches_fullhot_interpret_and_f64(n_nodes):
    import jax.numpy as jnp

    from mallorn_tpu.ops import hist_pallas as hp

    binned, node_q, gh = _fixture(n_nodes)
    got = build_histograms(torch.from_numpy(binned), torch.from_numpy(node_q),
                           torch.from_numpy(gh), n_nodes, NBT).numpy()
    assert got.shape == (K, F, n_nodes, NBT, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, _oracle(binned, node_q, gh, n_nodes),
                               rtol=RTOL, atol=ATOL)
    for k in range(K):
        b = jnp.asarray(binned[k].astype(np.int32))
        want = hp.build_histograms_fullhot(
            hp.precompute_fullhot_i8(b, NBT), jnp.asarray(node_q[k]),
            hp.split_gh_digits(jnp.asarray(gh[k, :, 0]), jnp.asarray(gh[k, :, 1])),
            n_nodes, NBT, row_chunk=256, interpret=True)
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=RTOL, atol=ATOL)


def test_plain_float64_is_the_oracle():
    binned, node_q, gh = _fixture(2)
    got = build_histograms_plain(torch.from_numpy(binned), torch.from_numpy(node_q),
                                 torch.from_numpy(gh.astype(np.float64)), 2, NBT)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _oracle(binned, node_q, gh, 2),
                               rtol=1e-12, atol=1e-12)


def test_fixed_point_version_is_the_exact_sum_rounded_once():
    """The kernel's int64 fixed-point arithmetic, in plain PyTorch: within
    one float32 rounding of the float64 oracle, and NaN in every cell of a
    fold whose (g, h) is not finite."""
    binned, node_q, gh = _fixture(8)
    got = build_histograms_fixed(torch.from_numpy(binned), torch.from_numpy(node_q),
                                 torch.from_numpy(gh), 8, NBT).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _oracle(binned, node_q, gh, 8), rtol=1.2e-7, atol=1e-12)
    gh[1, 7, 0] = np.inf
    got = build_histograms_fixed(torch.from_numpy(binned), torch.from_numpy(node_q),
                                 torch.from_numpy(gh), 8, NBT).numpy()
    assert np.isnan(got[1]).all() and np.isfinite(got[[0, 2]]).all()


def test_inactive_rows_and_out_of_range_bins_count_nowhere():
    binned, node_q, gh = _fixture(4)
    node_q[:, ::3] = 4  # inactive
    node_q[:, 1::7] = -1  # outside [0, k_nodes): inactive too
    binned[0, :, 5] = NBT  # a bin outside [0, n_bins_tot): skipped
    got = build_histograms(torch.from_numpy(binned), torch.from_numpy(node_q),
                           torch.from_numpy(gh), 4, NBT).numpy()
    act = (node_q >= 0) & (node_q < 4)
    act0 = act[0].copy()
    act0[5] = False
    for k, a in enumerate((act0, act[1], act[2])):
        np.testing.assert_allclose(got[k].sum(axis=(1, 2)),
                                   np.broadcast_to(gh[k, a].sum(0), (F, 2)),
                                   rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    binned, node_q, gh = (torch.from_numpy(a) for a in _fixture(1))
    hist_cuda.reset_launches()
    got = build_histograms(binned, node_q, gh, 1, NBT)
    assert hist_cuda.launches == 0
    assert torch.equal(got, build_histograms_plain(binned, node_q, gh, 1, NBT))


@pytest.mark.parametrize("k_nodes", [1, 2, 3, 4, 8, 16, 32, 54])
def test_hist_layout_fits_shared_memory(k_nodes):
    group, rows, smem = hist_layout(k_nodes, NBT)
    assert group >= 1 and rows >= hist_cuda.SEG_THREADS and rows % hist_cuda.SEG_THREADS == 0
    assert smem == hist_cuda._seg_smem_bytes(k_nodes * NBT, group, rows) <= SMEM_BYTES
    if k_nodes in hist_cuda.HIST_LAYOUTS:  # the fits' levels take the timed layout
        assert (group, rows) == hist_cuda.HIST_LAYOUTS[k_nodes]


@pytest.mark.parametrize("k_nodes", [55, 64])
def test_hist_layout_refuses_beyond_its_limit(k_nodes):
    # 54 nodes of 257 bins fit the kernel's 14,004 segments, 55 do not
    assert 54 * NBT <= SEG_MAX_SEGMENTS < 55 * NBT
    with pytest.raises(ValueError, match=str(SEG_MAX_SEGMENTS)):
        hist_layout(k_nodes, NBT)


@pytest.mark.parametrize("k_nodes", [1, 8, 16, 54])
def test_hist_plan_takes_a_level_that_fits_as_one_chunk(k_nodes):
    # the parent's launch: one chunk of every node, the grid's z extent 1
    assert hist_cuda.hist_plan(k_nodes, NBT) == (k_nodes, 1) + hist_layout(k_nodes, NBT)


@pytest.mark.parametrize("k_nodes", [55, 64, 128, 1000])
def test_hist_plan_splits_a_wider_level_into_chunks(k_nodes):
    c = _kernel_smem_bytes()
    chunk, n_chunks, group, rows, smem = hist_cuda.hist_plan(k_nodes, NBT)
    assert chunk <= 54 and (n_chunks - 1) * chunk < k_nodes <= n_chunks * chunk
    assert n_chunks == -(-k_nodes // 54)  # the fewest chunks that fit
    assert (group, rows, smem) == hist_layout(chunk, NBT)
    assert c["seg_smem_bytes"](chunk * NBT, group, rows) == smem <= SMEM_BYTES


def test_hist_plan_refuses_beyond_the_grid_z_axis():
    top = hist_cuda.GRID_Z_MAX * 54
    assert hist_cuda.hist_plan(top, NBT)[1] == hist_cuda.GRID_Z_MAX
    with pytest.raises(ValueError, match="z axis"):
        hist_cuda.hist_plan(top + 1, NBT)
    with pytest.raises(ValueError, match=str(SEG_MAX_SEGMENTS)):
        hist_cuda.hist_plan(1, SEG_MAX_SEGMENTS + 1)


@pytest.mark.parametrize("k_nodes", [64, 128])
def test_fixed_point_histogram_is_its_chunks_side_by_side(k_nodes):
    """What a chunked launch computes: each chunk of nodes counts the rows
    whose node lies in it (ids shifted to the chunk, the rest inactive);
    the chunks side by side are the whole level's fixed-point histogram
    bit for bit (the scale depends on (g, h) alone)."""
    rng = np.random.default_rng(70 + k_nodes)
    binned = torch.from_numpy(rng.integers(0, NBT, size=(2, 11, 900)).astype(np.int16))
    node_q = torch.from_numpy(rng.integers(0, k_nodes + 1, size=(2, 900)).astype(np.int32))
    gh = torch.from_numpy(rng.normal(size=(2, 900, 2)).astype(np.float32))
    chunk, n_chunks = hist_cuda.hist_plan(k_nodes, NBT)[:2]
    assert n_chunks > 1
    parts = []
    for n0 in range(0, k_nodes, chunk):
        c = min(chunk, k_nodes - n0)
        ids = torch.where((node_q >= n0) & (node_q < n0 + c), node_q - n0, c)
        parts.append(build_histograms_fixed(binned, ids.to(torch.int32), gh, c, NBT))
    whole = build_histograms_fixed(binned, node_q, gh, k_nodes, NBT)
    assert torch.equal(torch.cat(parts, dim=2).view(torch.int32), whole.view(torch.int32))


def test_hist_layout_repeats_the_kernel_byte_sum():
    # the launcher refuses a layout by its own sum, the wrapper picks one
    # by this module's; the two must not drift apart at any level
    c = _kernel_smem_bytes()
    for k_nodes in range(1, 55):
        group, rows, smem = hist_layout(k_nodes, NBT)
        assert c["seg_smem_bytes"](k_nodes * NBT, group, rows) == smem, k_nodes


@pytest.mark.cuda
def test_kernel_matches_plain_and_repeats_bit_for_bit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    for n_nodes in (1, 2, 8):
        binned, node_q, gh = (torch.from_numpy(a).cuda() for a in _fixture(n_nodes))
        hist_cuda.reset_launches()
        a = build_histograms(binned, node_q, gh, n_nodes, NBT)
        b = build_histograms(binned, node_q, gh, n_nodes, NBT)
        assert hist_cuda.launches == 2
        assert torch.equal(a, b)
        assert torch.equal(a, build_histograms_fixed(binned, node_q, gh, n_nodes, NBT))
        want = build_histograms_plain(binned, node_q, gh.double(), n_nodes, NBT)
        np.testing.assert_allclose(a.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")


def _level(K, F, N, k_nodes, seed, inactive=0.3):
    """bins [K, F, N] over all NBT bins, node ids [K, N] in [0, k_nodes]
    (k_nodes = inactive, plus a share ``inactive`` forced inactive),
    logistic-like gh [K, N, 2]: numpy arrays."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, NBT, size=(K, F, N)).astype(np.int16)
    node_q = rng.integers(0, k_nodes + 1, size=(K, N))
    node_q[rng.random((K, N)) < inactive] = k_nodes
    p, y = rng.random((K, N)), rng.random((K, N)) < 0.1
    gh = np.stack([p - y, p * (1 - p)], axis=-1).astype(np.float32)
    return binned, node_q.astype(np.int32), gh


def _kernel_equals_fixed(binned, node_q, gh, k_nodes):
    """K1 twice on the card: two launches counted, bit for bit equal to
    each other and to ``build_histograms_fixed``, and within the JAX
    package's bar of the float64 plain version on the finite folds;
    returns the output."""
    binned, node_q, gh = (torch.as_tensor(a).cuda() for a in (binned, node_q, gh))
    hist_cuda.reset_launches()
    a = build_histograms(binned, node_q, gh, k_nodes, NBT)
    b = build_histograms(binned, node_q, gh, k_nodes, NBT)
    assert hist_cuda.launches == 2

    def bits(t):  # bit for bit, NaN included
        return t.view(torch.int32)

    assert torch.equal(bits(a), bits(b))
    assert torch.equal(bits(a), bits(build_histograms_fixed(binned, node_q, gh, k_nodes, NBT)))
    want = build_histograms_plain(binned, node_q, gh.double(), k_nodes, NBT)
    folds = torch.isfinite(gh).flatten(1).all(dim=1)  # the others are NaN throughout
    np.testing.assert_allclose(a[folds].cpu().numpy(), want[folds].cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [1, 17, 2443, 8143])
def test_kernel_bit_for_bit_at_ragged_rows(n_rows):
    # 8,143 rows: more than one tile and than 4,096 (a list entry keeps its
    # tile row in 16 bits)
    _cuda_or_skip()
    F_ragged = 2 * hist_layout(4, NBT)[0] + 1  # the last group holds one feature
    _kernel_equals_fixed(*_level(3, F_ragged, n_rows, 4, seed=n_rows), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("k_nodes", [1, 8, 16])
def test_kernel_bit_for_bit_at_the_fits_width(k_nodes):
    # F = 222: not a multiple of any G > 1, so the last group is ragged
    _cuda_or_skip()
    _kernel_equals_fixed(*_level(5, 222, 2444, k_nodes, seed=30 + k_nodes), k_nodes)


@pytest.mark.cuda
@pytest.mark.parametrize("k_nodes", [64, 128])
def test_kernel_bit_for_bit_wider_than_one_cta(k_nodes):
    # depth 8's last level with subtraction (64 nodes) and without (128):
    # two and three chunks of nodes on the grid's z axis
    _cuda_or_skip()
    _kernel_equals_fixed(*_level(5, 222, 2444, k_nodes, seed=80 + k_nodes), k_nodes)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_kernel_chunked_launch_equals_one_chunk(chunk):
    """A 16-node level launched in chunks of ``chunk`` nodes gives the bits
    of the one-chunk launch (which is the wrapper's)."""
    _cuda_or_skip()
    from mallorn_tpu_torch.utils import cuda_build

    binned, node_q, gh = (torch.as_tensor(a).cuda() for a in _level(3, 37, 2443, 16, seed=90))
    want = build_histograms(binned, node_q, gh, 16, NBT)
    out = torch.full_like(want, float("nan"))
    group, rows, _ = hist_layout(chunk, NBT)
    lib = cuda_build.load()
    cuda_build.check(lib.mallorn_hist(binned.data_ptr(), node_q.data_ptr(), gh.data_ptr(),
                                      out.data_ptr(), 3, 37, 2443, 16, NBT, group, rows, chunk,
                                      None, 0, torch.cuda.current_stream().cuda_stream),
                     "mallorn_hist")
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k_nodes", [1, 8])
def test_kernel_skips_out_of_range_nodes_and_bins(k_nodes):
    """K1's rule, which is not K3's: a node id outside [0, k_nodes) and a
    bin outside [0, n_bins_tot) count nowhere, whatever node + bin gives."""
    _cuda_or_skip()
    binned, node_q, gh = _level(3, 9, 700, k_nodes, seed=40 + k_nodes, inactive=0.0)
    node_q[:, 1::5] = -1
    node_q[:, 2::7] = k_nodes + 1
    node_q[0, 3::11] = np.iinfo(np.int32).min
    node_q[1, 4::11] = np.iinfo(np.int32).max
    binned[:, :, 5::6] = NBT  # would be node + 1's bin 0 under K3's rule
    binned[:, 1, 6::9] = -1
    binned[2, 2, 7::9] = np.iinfo(np.int16).max
    got = _kernel_equals_fixed(binned, node_q, gh, k_nodes).cpu().numpy().astype(np.float64)
    for k in range(3):
        for f in range(9):
            act = ((node_q[k] >= 0) & (node_q[k] < k_nodes)
                   & (binned[k, f] >= 0) & (binned[k, f] < NBT))
            np.testing.assert_allclose(got[k, f].sum(axis=(0, 1)), gh[k, act].sum(0),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_nan_and_inf_folds_beside_finite_folds():
    _cuda_or_skip()
    binned, node_q, gh = _level(4, 7, 700, 2, seed=50)
    gh[1, 3, 0] = np.nan
    gh[2, 699, 1] = np.inf
    got = _kernel_equals_fixed(binned, node_q, gh, 2)
    assert torch.isnan(got[1]).all() and torch.isnan(got[2]).all()
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[3]).all()


@pytest.mark.cuda
def test_kernel_all_inactive_fold_is_zero():
    _cuda_or_skip()
    binned, node_q, gh = _level(3, 7, 700, 2, seed=60)
    node_q[1] = 2
    got = _kernel_equals_fixed(binned, node_q, gh, 2)
    assert (got[1] == 0).all() and got[0].abs().sum() > 0
