"""Port vs JAX package: K1 at levels wider than one CTA holds (the wide
path: more than 54 nodes of 257 bins, depth 7-8's last levels).

On the CPU: the prep kernel's plain version (``group_rows_plain``),
property-tested with hypothesis over node distributions (empty nodes,
all-inactive folds, ids of -1 and of ``k_nodes``, NaN and inf lanes):
every active row in exactly its chunk's list, in row order, with its node
in the chunk and its q, no inactive row in any, the maxima those of
``lane_maxabs``; the wide path's arithmetic in plain
PyTorch (``build_histograms_wide_fixed``) bit for bit
``build_histograms_fixed`` and ``build_histograms_i64_fixed`` at 55, 64
and 128 nodes; ``build_histograms_plain`` at 64 nodes against
``hist_pallas.build_histograms_fullhot`` in Pallas interpret mode at the
JAX package's bar (rtol 1e-5, atol 1e-4); and the wide layout rule
(``wide_plan``), whose byte sum repeats the kernel source's.

On the card (the ``cuda`` cases: ``pytest --noconftest -m cuda
tests/test_torch_hist_wide.py``; the JAX package is imported only inside
the test that uses it): the prep kernel bit for bit ``group_rows_plain``
over its lists, on both scales, and K1 through
the wide path bit for bit the fixed-point twins at 55, 64, 100 and 128
nodes on both scales, on a ragged shape (30% inactive rows, empty nodes, a
NaN and an inf fold beside finite ones, an all-inactive fold), at every
layout of ``tools/time_hist.py``'s sweep, two launches equal and counted.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.ops.hist_cuda import (SMEM_BYTES, WIDE_LAYOUTS, build_histograms,
                                             build_histograms_fixed, build_histograms_i64,
                                             build_histograms_i64_fixed, build_histograms_plain,
                                             build_histograms_wide_fixed, group_rows_plain,
                                             lane_maxabs, wide_plan)

torch.set_num_threads(2)

NBT = 257
RTOL, ATOL = 1e-5, 1e-4


def _level(K, F, N, k_nodes, seed, inactive=0.3):
    """bins [K, F, N] over all NBT bins (a few out of range), node ids
    [K, N] in [-1, k_nodes] (-1 and k_nodes inactive, plus a share
    ``inactive`` forced to k_nodes), logistic-like (g, h) [K, N, 2]: numpy
    arrays."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, NBT, size=(K, F, N)).astype(np.int16)
    binned[rng.random((K, F, N)) < 0.01] = NBT
    node_q = rng.integers(-1, k_nodes + 1, size=(K, N))
    node_q[rng.random((K, N)) < inactive] = k_nodes
    p, y = rng.random((K, N)), rng.random((K, N)) < 0.1
    gh = np.stack([p - y, p * (1 - p)], axis=-1).astype(np.float32)
    return binned, node_q.astype(np.int32), gh


def _ragged(K=6, F=9, N=2443, k_nodes=100, seed=11):
    """The chip check's ragged level: 30% of rows inactive, every node of a
    band of ids empty, a NaN fold and an inf fold beside finite ones and a
    fold whose every row is inactive."""
    binned, node_q, gh = _level(K, F, N, k_nodes, seed)
    node_q[(node_q >= 16) & (node_q < 48)] = -1  # empty nodes, whole chunks among them
    gh[1, N // 3, 0] = np.nan
    gh[2, N - 1, 1] = np.inf
    node_q[3] = k_nodes
    return binned, node_q, gh


def _bits(t):  # bit for bit, NaN included
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# ---------------------------------------------------------------------------
# the row grouping's plain version
# ---------------------------------------------------------------------------

@st.composite
def _grouping_case(draw):
    K = draw(st.integers(1, 4))
    N = draw(st.integers(0, 70))
    k_nodes = draw(st.integers(1, 140))
    chunk = draw(st.integers(1, 40))
    # ids from a few nodes only (most nodes empty), with -1 and k_nodes
    pool = draw(st.lists(st.integers(-1, k_nodes), min_size=1, max_size=6))
    ids = draw(st.lists(st.sampled_from(pool), min_size=K * N, max_size=K * N))
    node_q = np.asarray(ids, dtype=np.int32).reshape(K, N)
    if K > 1 and draw(st.booleans()):
        node_q[draw(st.integers(0, K - 1))] = k_nodes  # an all-inactive fold
    vals = st.floats(-1e6, 1e6, width=32) | st.sampled_from([np.nan, np.inf, -np.inf, 0.0])
    gh = np.asarray(draw(st.lists(vals, min_size=2 * K * N, max_size=2 * K * N)),
                    dtype=np.float32).reshape(K, N, 2)
    return node_q, gh, k_nodes, chunk


@settings(max_examples=150, deadline=None)
@given(_grouping_case())
def test_group_rows_plain_lists_each_active_row_in_its_chunk(case):
    node_q, gh, k_nodes, chunk = case
    K, N = node_q.shape
    n_chunks = -(-k_nodes // chunk)
    entries, q, offsets, maxabs = (t.numpy() for t in group_rows_plain(
        torch.from_numpy(node_q), torch.from_numpy(gh), k_nodes, chunk))
    assert entries.shape == q.shape == (K, N, 2) and offsets.shape == (K, n_chunks + 1)
    # q at the folds' own scale, each row's own
    want_q = hist_cuda._fixed_point(torch.from_numpy(gh))[0].numpy()
    for k in range(K):
        active = (node_q[k] >= 0) & (node_q[k] < k_nodes)
        off = offsets[k]
        assert off[0] == 0 and (np.diff(off) >= 0).all() and off[-1] == active.sum()
        for c in range(n_chunks):
            rows, nodes = entries[k, off[c]:off[c + 1]].T
            want = np.flatnonzero(active & (node_q[k] // chunk == c))
            assert np.array_equal(rows, want)  # in row order
            assert np.array_equal(nodes, node_q[k, want] - c * chunk)
            assert np.array_equal(q[k, off[c]:off[c + 1]], want_q[k, want])
        assert (entries[k, off[-1]:] == -1).all() and (q[k, off[-1]:] == 0).all()
        # the maxima: max |g|, max |h| of the fold, +inf in both channels of a
        # fold holding a NaN or an infinity (lane_maxabs)
        if N and not np.isfinite(gh[k]).all():
            want_m = np.full(2, np.inf, np.float32)
        else:
            want_m = np.abs(gh[k]).max(axis=0) if N else np.zeros(2, np.float32)
        assert np.array_equal(maxabs[k], want_m)
    assert np.array_equal(maxabs, lane_maxabs(torch.from_numpy(gh)).numpy())


def test_group_rows_plain_at_an_external_scale():
    _, node_q, gh = (torch.from_numpy(a) for a in _level(2, 1, 50, 64, seed=3))
    m = lane_maxabs(gh) * 4  # every rank's maxima, above these rows'
    got = group_rows_plain(node_q, gh, 64, 16, m, 400)
    assert got.maxabs is m and got.offsets.shape == (2, 5)
    want_q = hist_cuda._fixed_point(gh, m, 400)[0]
    for k in range(2):
        rows = got.entries[k, :int(got.offsets[k, -1]), 0].long()
        assert torch.equal(got.q[k, :len(rows)], want_q[k, rows])


# ---------------------------------------------------------------------------
# the wide path's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("external", [False, True])
@pytest.mark.parametrize("k_nodes", [55, 64, 128])
def test_wide_arithmetic_is_the_fixed_point_twin_bit_for_bit(k_nodes, external):
    binned, node_q, gh = (torch.from_numpy(a) for a in _level(3, 5, 300, k_nodes,
                                                                 seed=k_nodes))
    gh[1, 7, 0] = float("nan")  # fold 1 not finite
    chunk = wide_plan(k_nodes, NBT)[0]
    if external:  # a global scale: these rows are a third of 900
        m = lane_maxabs(gh)
        got = build_histograms_wide_fixed(binned, node_q, gh, k_nodes, NBT, chunk, m, 900)
        want = build_histograms_i64_fixed(binned, node_q, gh, k_nodes, NBT, m, 900)
        assert got.dtype == torch.int64 and (got[1] == 0).all()
    else:
        got = build_histograms_wide_fixed(binned, node_q, gh, k_nodes, NBT, chunk)
        want = build_histograms_fixed(binned, node_q, gh, k_nodes, NBT)
        assert torch.isnan(got[1]).all() and torch.isfinite(got[[0, 2]]).all()
    assert got.shape == (3, 5, k_nodes, NBT, 2)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("chunk", [1, 7, 40])
def test_wide_arithmetic_does_not_depend_on_the_chunk(chunk):
    binned, node_q, gh = (torch.from_numpy(a) for a in _ragged(K=4, F=3, N=400))
    want = build_histograms_fixed(binned, node_q, gh, 100, NBT)
    got = build_histograms_wide_fixed(binned, node_q, gh, 100, NBT, chunk)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.isnan(got[1]).all() and torch.isnan(got[2]).all() and (got[3] == 0).all()


def test_plain_at_64_nodes_matches_fullhot_interpret():
    import jax.numpy as jnp

    from mallorn_tpu.ops import hist_pallas as hp

    binned, node_q, gh = _level(2, 8, 300, 64, seed=17, inactive=0.2)
    binned[binned >= NBT] = NBT - 1  # the JAX one-hot takes bins in range only
    node_q[node_q < 0] = 64
    got = build_histograms_plain(torch.from_numpy(binned), torch.from_numpy(node_q),
                                 torch.from_numpy(gh), 64, NBT).numpy()
    for k in range(2):
        want = hp.build_histograms_fullhot(
            hp.precompute_fullhot_i8(jnp.asarray(binned[k].astype(np.int32)), NBT),
            jnp.asarray(node_q[k]), hp.split_gh_digits(jnp.asarray(gh[k, :, 0]),
                                                       jnp.asarray(gh[k, :, 1])),
            64, NBT, row_chunk=256, interpret=True)
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the layout rule
# ---------------------------------------------------------------------------

def _kernel_source():
    return (Path(hist_cuda.__file__).resolve().parents[1] / "csrc" / "hist.cu").read_text()


def test_wide_constants_and_byte_sums_repeat_the_kernel_source():
    src = _kernel_source()
    consts = {name: int(v) for name, v in
              re.findall(r"constexpr int (kWide\w+|kPrepThreads) = (\d+);", src)}
    assert (consts["kWideThreads"], consts["kWideMaxGroup"], consts["kWideMaxChunks"]) == (
        hist_cuda.WIDE_THREADS, hist_cuda.WIDE_MAX_GROUP, hist_cuda.WIDE_MAX_CHUNKS)
    # the prep kernel's shared memory at the most chunks it takes fits a CTA
    body = re.search(r"size_t prep_smem_bytes\(int n_chunks\) \{\s*return ([^;]+);", src)[1]
    body = re.sub(r"static_cast<size_t>\(([^()]*)\)", r"(\1)", " ".join(body.split()))
    prep_sum = eval(f"lambda n_chunks: {body}", {"kPrepWarps": consts["kPrepThreads"] // 32})
    assert prep_sum(hist_cuda.WIDE_MAX_CHUNKS) <= SMEM_BYTES
    body = re.search(r"size_t wide_smem_bytes\(int chunk_nodes, int n_bins, int group\) "
                     r"\{\s*return ([^;]+);", src)[1]
    body = re.sub(r"static_cast<size_t>\(([^()]*)\)", r"(\1)", " ".join(body.split()))
    c_sum = eval(f"lambda chunk_nodes, n_bins, group: {body}")
    for nodes in (1, 14, 16, 43, 56):
        for group in (1, 2, 4, 8):
            for n_bins in (2, 257, 14528):
                assert c_sum(nodes, n_bins, group) == hist_cuda._wide_smem_bytes(
                    nodes, n_bins, group)


@pytest.mark.parametrize("k_nodes", [55, 64, 100, 128, 4000])
def test_wide_plan_fits_and_covers_the_level(k_nodes):
    chunk, n_chunks, group, smem = wide_plan(k_nodes, NBT)
    levels = sorted(WIDE_LAYOUTS)
    want_g, want_nodes = WIDE_LAYOUTS[next((c for c in levels if c >= k_nodes), levels[-1])]
    assert group == want_g and chunk <= want_nodes
    assert (n_chunks - 1) * chunk < k_nodes <= n_chunks * chunk
    assert n_chunks == -(-k_nodes // want_nodes)  # the fewest chunks of the layout's nodes
    assert smem == hist_cuda._wide_smem_bytes(chunk, NBT, group) <= SMEM_BYTES


def test_wide_plan_shrinks_a_layout_until_a_cta_fits():
    # 4 features of 32 nodes do not fit: G halves to 1 (4 KB of 257 bins a
    # node and feature); 100 nodes of one feature do not either: the nodes
    # are cut to the 56 that fit
    assert wide_plan(128, NBT, (4, 32)) == (32, 4, 1, hist_cuda._wide_smem_bytes(32, NBT, 1))
    chunk, n_chunks, group, smem = wide_plan(200, NBT, (1, 100))
    assert group == 1 and chunk <= SMEM_BYTES // (16 * NBT) and smem <= SMEM_BYTES
    with pytest.raises(ValueError, match="layout"):
        wide_plan(64, NBT, (hist_cuda.WIDE_MAX_GROUP + 1, 16))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")


def _grouped_equal(got, want):
    """The prep kernel's output bit for bit its plain version's over the
    lists (the kernel leaves their tails unwritten)."""
    assert torch.equal(got.offsets, want.offsets) and torch.equal(got.maxabs, want.maxabs)
    listed = torch.arange(got.q.shape[1], device=got.q.device) < got.offsets[:, -1:]
    for a, b in ((got.entries, want.entries), (got.q, want.q)):
        assert torch.equal(a[listed], b[listed])


@pytest.mark.cuda
@pytest.mark.parametrize("k_nodes", [17, 55, 64, 100, 128])
def test_prep_kernel_matches_its_plain_version(k_nodes):
    _cuda_or_skip()
    node_q, gh = (torch.as_tensor(a).cuda() for a in _ragged(K=5, F=1, k_nodes=k_nodes)[1:])
    chunk = wide_plan(k_nodes, NBT)[0]
    _grouped_equal(hist_cuda.launch_group_rows(node_q, gh, k_nodes, chunk),
                   group_rows_plain(node_q, gh, k_nodes, chunk))
    m = (lane_maxabs(gh) * 2).contiguous()  # an external scale: every rank's maxima and rows
    n_rows = 3 * gh.shape[1]
    _grouped_equal(hist_cuda.launch_group_rows(node_q, gh, k_nodes, chunk, m,
                                               hist_cuda._log2_ceil(n_rows)),
                   group_rows_plain(node_q, gh, k_nodes, chunk, m, n_rows))


def _wide_holds(binned, node_q, gh, k_nodes):
    """Both scales through the wrappers, twice each: counted, two launches
    equal, bit for bit the fixed-point twins; the float32 one within the JAX
    package's bar of the float64 plain version on its finite folds."""
    binned, node_q, gh = (torch.as_tensor(a).cuda() for a in (binned, node_q, gh))
    N = gh.shape[1]
    hist_cuda.reset_launches()
    a = build_histograms(binned, node_q, gh, k_nodes, NBT)
    b = build_histograms(binned, node_q, gh, k_nodes, NBT)
    m = lane_maxabs(gh)
    s = [build_histograms_i64(binned, node_q, gh, k_nodes, NBT, m, 2 * N) for _ in range(2)]
    assert (hist_cuda.launches, hist_cuda.i64_launches, hist_cuda.prep_launches) == (2, 2, 4)
    assert hist_cuda.launches_by_nodes == {k_nodes: 2}
    assert torch.equal(_bits(a), _bits(b)) and torch.equal(s[0], s[1])
    assert torch.equal(_bits(a), _bits(build_histograms_fixed(binned, node_q, gh, k_nodes, NBT)))
    assert torch.equal(s[0], build_histograms_i64_fixed(binned, node_q, gh, k_nodes, NBT, m,
                                                        2 * N))
    want = build_histograms_plain(binned, node_q, gh.double(), k_nodes, NBT)
    folds = torch.isfinite(gh).flatten(1).all(dim=1)
    np.testing.assert_allclose(a[folds].cpu().numpy(), want[folds].cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    return a, s[0]


@pytest.mark.cuda
@pytest.mark.parametrize("k_nodes", [17, 32, 55, 64, 100, 128])
def test_wide_kernel_bit_for_bit_at_depth_8_widths(k_nodes):
    _cuda_or_skip()
    _wide_holds(*_level(5, 222, 2444, k_nodes, seed=120 + k_nodes), k_nodes)


@pytest.mark.cuda
def test_wide_kernel_bit_for_bit_on_the_ragged_level():
    _cuda_or_skip()
    a, s = _wide_holds(*_ragged(), 100)
    assert torch.isnan(a[1]).all() and torch.isnan(a[2]).all()
    assert (s[1] == 0).all() and (s[2] == 0).all()
    assert (a[3] == 0).all() and (s[3] == 0).all() and torch.isfinite(a[[0, 4, 5]]).all()
    assert (a[[0, 3, 4, 5], :, 16:48] == 0).all()  # the empty nodes


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_wide_kernel_at_a_level_one_cta_holds_equals_that_launch(chunk):
    """A 16-node level through the wide path in chunks of ``chunk`` nodes
    gives the bits of the one-CTA launch (the wrapper's at 16 nodes)."""
    _cuda_or_skip()
    binned, node_q, gh = (torch.as_tensor(a).cuda() for a in _level(3, 37, 2443, 16, seed=90))
    want = build_histograms(binned, node_q, gh, 16, NBT)
    out = torch.full_like(want, float("nan"))
    grouped = hist_cuda.launch_group_rows(node_q, gh, 16, chunk)
    hist_cuda.launch_wide_kernel(binned, grouped, out, 16, NBT, chunk, 2)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4])
def test_wide_kernel_every_layout_gives_the_same_bits(group):
    _cuda_or_skip()
    binned, node_q, gh = (torch.as_tensor(a).cuda() for a in _level(5, 27, 2444, 128, seed=7))
    want = build_histograms_fixed(binned, node_q, gh, 128, NBT)
    for nodes in (4, 8, 11, 16, 22, 32):
        chunk, _, g, _ = wide_plan(128, NBT, (group, nodes))
        out = torch.full_like(want, float("nan"))
        grouped = hist_cuda.launch_group_rows(node_q, gh, 128, chunk)
        hist_cuda.launch_wide_kernel(binned, grouped, out, 128, NBT, chunk, g)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(want)), (group, nodes)
