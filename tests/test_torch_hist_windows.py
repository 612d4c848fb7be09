"""The histogram kernels at every bin count up to MAX_NODE_BINS (32,768)
bins a node: their plans on the CPU, their windowed launches on the card.

Where one CTA cannot hold a node's bins (K4 beyond 4,842, K5 beyond 7,264)
or a call's segments (K3 beyond 14,004), each CTA holds a window of them
and adds only the rows that fall in it (``ops/hist_cuda.py`` ``mode_plan``,
``seg_hist_plan``; grid z takes the windows). K1's wide path takes a node
of more than 7,264 bins in a CTA of its own (``wide_node_plan``): a table
of the bins its rows occupy, or, for a node of more rows than the table's
slots, windows of bins (``wide_windows``) one after another inside the
CTA. On the CPU, for a sampled grid of bin counts and levels: every (node,
bin) cell, or segment, belongs to exactly one CTA (and one window); every
CTA fits SMEM_BYTES; grid z stays within 65,535; a level that one CTA held
before keeps its plan; the per-node kernel's table, emulated, gives the
dense sums. On the card (``cuda`` cases, ``python -m pytest -q
--noconftest -m cuda tests/test_torch_hist_windows.py``): each windowed
launch, in the float32 and the external-scale entry, bit for bit its plain
twin and its own second launch, with its windows counted in
``hist_cuda.windows_by_call``; the per-node kernel likewise, with a node of
more rows than its slots.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.ops.hist_cuda import MAX_GRID_Z, MAX_NODE_BINS, SMEM_BYTES

BIN_COUNTS = [2, 3, 17, 257, 605, 606, 908, 909, 1025, 4842, 4843, 7264, 7265, 8193,
              14528, 14529, 16385, 29057, MAX_NODE_BINS]
NODE_COUNTS = [1, 2, 3, 7, 8, 9, 17, 54, 128]


def _covered_once(cells: np.ndarray) -> bool:
    return bool((cells == 1).all())


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n_bins_tot", BIN_COUNTS)
def test_mode_plan_covers_every_cell_once(n_bins_tot, int8):
    cell = hist_cuda.MODE_CELL_BYTES[int8]
    for k_nodes in NODE_COUNTS:
        group, windows, window, smem = hist_cuda.mode_plan(k_nodes, n_bins_tot, int8)
        assert 1 <= group <= min(k_nodes, hist_cuda.MODE_NODES)
        assert windows == 1 or group == 1  # a CTA's cells are one run of out
        assert smem == group * window * cell <= SMEM_BYTES
        # the most nodes that fit, and windows only where one node does not
        assert group == min(k_nodes, hist_cuda.MODE_NODES, max(1, SMEM_BYTES // (n_bins_tot * cell)))
        assert (windows > 1) == (n_bins_tot * cell > SMEM_BYTES)
        z = -(-k_nodes // group) * windows
        assert z <= MAX_GRID_Z
        cells = np.zeros((k_nodes, n_bins_tot), np.int8)
        for bz in range(z):  # the kernel's own index arithmetic
            grp, w = divmod(bz, windows)
            node0, bin0 = grp * group, w * window
            nb = min(window, n_bins_tot - bin0)
            cells[node0:node0 + min(group, k_nodes - node0), bin0:bin0 + nb] += 1
        assert _covered_once(cells), (k_nodes, n_bins_tot)


@pytest.mark.parametrize("n_bins_tot", BIN_COUNTS)
def test_wide_plan_covers_every_cell_once(n_bins_tot):
    per_node = n_bins_tot > hist_cuda.WIDE_NODE_FROM_BINS
    slots, windows, window, node_smem = hist_cuda.wide_node_plan(n_bins_tot)
    for k_nodes in NODE_COUNTS + [1024]:
        chunk, n_chunks, group, smem = hist_cuda.wide_plan(k_nodes, n_bins_tot)
        if per_node:  # a CTA a node, its bins in its table or its windows
            assert (chunk, group, smem) == (1, 1, node_smem) and window <= slots
        else:  # the chunk kernel holds its chunk's bins whole
            assert smem == hist_cuda._wide_smem_bytes(chunk, n_bins_tot, group)
        assert smem <= SMEM_BYTES
        assert n_chunks <= hist_cuda.WIDE_MAX_CHUNKS and n_chunks <= MAX_GRID_Z
        cells = np.zeros((k_nodes, n_bins_tot), np.int8)
        for bz in range(n_chunks):  # the kernels' own index arithmetic
            node0 = bz * chunk
            for bin0 in (range(0, n_bins_tot, window) if per_node else [0]):
                nb = min(window, n_bins_tot - bin0) if per_node else n_bins_tot
                cells[node0:node0 + min(chunk, k_nodes - node0), bin0:bin0 + nb] += 1
        assert _covered_once(cells), (k_nodes, n_bins_tot)


@pytest.mark.parametrize("n_seg", [1, 257, 514, 14004, 14005, 2 * 7003, 2 * 8193, 28009,
                                   2 * 16385, hist_cuda.SEG_MAX_TOTAL])
def test_seg_hist_plan_covers_every_segment_once(n_seg):
    windows, window, group, rows, smem = hist_cuda.seg_hist_plan(n_seg)
    assert (windows > 1) == (n_seg > hist_cuda.SEG_MAX_SEGMENTS) and windows <= MAX_GRID_Z
    assert (group, rows, smem) == hist_cuda.seg_hist_layout(window)
    assert smem == hist_cuda._seg_smem_bytes(window, group, rows) <= SMEM_BYTES
    segs = np.zeros(n_seg, np.int8)
    for bz in range(windows):
        s0 = bz * window
        segs[s0:s0 + min(window, n_seg - s0)] += 1
    assert _covered_once(segs)


def test_plans_refuse_what_no_launch_takes():
    for int8 in (False, True):
        with pytest.raises(ValueError, match=str(MAX_NODE_BINS)):
            hist_cuda.mode_plan(1, MAX_NODE_BINS + 1, int8)
    with pytest.raises(ValueError, match="65535"):  # 65,536 node groups of one window
        hist_cuda.mode_plan(8 * (MAX_GRID_Z + 1), 257, True)
    with pytest.raises(ValueError, match=str(MAX_NODE_BINS)):
        hist_cuda.wide_plan(2, MAX_NODE_BINS + 1)
    with pytest.raises(ValueError, match="chunks"):  # one node a chunk beyond 7,264 bins
        hist_cuda.wide_plan(hist_cuda.WIDE_MAX_CHUNKS + 1, 14529)
    for n_seg in (0, hist_cuda.SEG_MAX_TOTAL + 1):
        with pytest.raises(ValueError, match=str(hist_cuda.SEG_MAX_TOTAL)):
            hist_cuda.seg_hist_plan(n_seg)


def test_257_bin_plans_are_unchanged():
    # the plans every shipped configuration runs, as before the windows
    for k_nodes in (1, 2, 3, 4, 8, 16, 17, 128):
        group = min(k_nodes, 8)
        assert hist_cuda.mode_plan(k_nodes, 257, False) == (group, 1, 257, group * 257 * 48)
        assert hist_cuda.mode_plan(k_nodes, 257, True) == (group, 1, 257, group * 257 * 32)
    assert hist_cuda.wide_plan(17, 257) == (6, 3, 1, 24672)
    assert hist_cuda.wide_plan(64, 257) == (11, 6, 1, 45232)
    assert hist_cuda.wide_plan(128, 257) == (11, 12, 1, 45232)
    assert hist_cuda.wide_windows(257) == (1, 257)
    assert hist_cuda.seg_hist_plan(257) == (1, 257, 4, 512, 39264)
    assert hist_cuda.seg_hist_plan(514) == (1, 514, 4, 512, 55712)


def test_kernel_source_takes_the_plans_limits():
    # the launchers refuse by their own constants; they must be the plans'
    src = (Path(hist_cuda.__file__).resolve().parents[1] / "csrc" / "hist.cu").read_text()
    assert int(re.search(r"constexpr int kModeNodes = (\d+);", src)[1]) == hist_cuda.MODE_NODES
    assert int(re.search(r"constexpr int kMaxSmemBytes = (\d+);", src)[1]) == SMEM_BYTES
    assert "n_seg > 65536" in src and hist_cuda.SEG_MAX_TOTAL == 65536


def test_windows_are_counted_per_call():
    hist_cuda.reset_launches()
    hist_cuda._note_windows("bf16_launches", 1)
    hist_cuda._note_windows("bf16_launches", 3)
    hist_cuda._note_windows("bf16_launches", 3)
    assert hist_cuda.windows_by_call == {"bf16_launches": {3: 2}}
    hist_cuda.reset_launches()
    assert hist_cuda.windows_by_call == {}


def _c_sum(src: str, signature: str):
    """The byte sum a C function of the kernel source returns, as a Python
    function of its int arguments."""
    body = re.search(re.escape(signature) + r" \{\s*return ([^;]+);", src)[1]
    body = re.sub(r"static_cast<size_t>\(([^()]*(?:\([^()]*\)[^()]*)*)\)", r"(\1)",
                  " ".join(body.split()))
    args = signature[signature.index("(") + 1:-1].replace("int ", "")
    return eval(f"lambda {args}: {body.replace('/', '//')}")


def test_per_node_constants_and_byte_sum_repeat_the_kernel_source():
    src = (Path(hist_cuda.__file__).resolve().parents[1] / "csrc" / "hist.cu").read_text()
    from_bins = int(re.search(r"constexpr int kWideNodeFromBins = (\d+);", src)[1])
    assert from_bins == hist_cuda.WIDE_NODE_FROM_BINS == SMEM_BYTES // 32
    c_sum = _c_sum(src, "size_t node_smem_bytes(int n_bins, int slots)")
    for n_bins in (7265, 8193, 16385, 29057, MAX_NODE_BINS):
        for slots in (32, 512, 1024, 2048, 4096):
            assert c_sum(n_bins, slots) == hist_cuda._node_smem_bytes(n_bins, slots)


@pytest.mark.parametrize("n_bins_tot", [b for b in BIN_COUNTS if b > 7264])
def test_per_node_plan_is_small_and_its_windows_cover_the_node(n_bins_tot):
    # the per-node kernel's bytes grow with its slots, not with the bins:
    # at the default slots at least two CTAs share an SM at any bin count
    slots, windows, window, smem = hist_cuda.wide_node_plan(n_bins_tot)
    assert slots == hist_cuda.WIDE_NODE_SLOTS and smem == hist_cuda._node_smem_bytes(
        n_bins_tot, slots)
    assert 2 * smem <= SMEM_BYTES
    assert window <= slots and (windows - 1) * window < n_bins_tot <= windows * window
    for other in (1024, 2048, 4096, 8192):  # the slots tools/time_hist.py sweeps
        assert hist_cuda.wide_node_plan(n_bins_tot, other)[3] <= SMEM_BYTES
    for bad in (0, 48, 20000):  # not a multiple of 32, or beyond a CTA
        with pytest.raises(ValueError, match="slots"):
            hist_cuda.wide_node_plan(n_bins_tot, bad)


def _node_table(bins: np.ndarray, q: np.ndarray, n_bins: int):
    """The per-node kernel's table of occupied bins in numpy: the bitmap of
    the entries' bins, its words' ranks (exclusive popcount sums), each
    entry's slot = rank[b / 32] + popc(the word's bits below b), the int64
    sums per slot; returns the node's dense sums [n_bins, C] rebuilt from the
    table as the epilogue reads it."""
    n_words = -(-n_bins // 32)
    bitmap = np.zeros(n_words, np.uint64)
    ok = (bins >= 0) & (bins < n_bins)
    for b in bins[ok]:
        bitmap[b >> 5] |= np.uint64(1) << np.uint64(b & 31)
    popc = np.array([bin(int(w)).count("1") for w in bitmap], np.int64)
    rank = np.concatenate([[0], np.cumsum(popc)[:-1]])

    def slot_of(b):
        below = int(bitmap[b >> 5]) & ((1 << (b & 31)) - 1)
        return int(rank[b >> 5]) + bin(below).count("1")

    table = np.zeros((int(popc.sum()), q.shape[1]), np.int64)
    for b, qe in zip(bins[ok], q[ok]):
        table[slot_of(int(b))] += qe
    dense = np.zeros((n_bins, q.shape[1]), np.int64)
    for b in range(n_bins):
        if (int(bitmap[b >> 5]) >> (b & 31)) & 1:
            dense[b] = table[slot_of(b)]
    return dense, table.shape[0]


@pytest.mark.parametrize("n_bins,n_entries", [(7265, 1), (16385, 76), (MAX_NODE_BINS, 2048)])
def test_per_node_table_gives_the_dense_sums(n_bins, n_entries):
    rng = np.random.default_rng(n_bins + n_entries)
    bins = rng.integers(-1, n_bins + 2, n_entries)  # a few outside the node's bins
    bins[: n_entries // 4] = n_bins - 1  # a crowded missing bin
    q = rng.integers(-2 ** 40, 2 ** 40, (n_entries, 2))
    dense, used = _node_table(bins, q, n_bins)
    want = np.zeros((n_bins + 1, 2), np.int64)
    np.add.at(want, np.where((bins >= 0) & (bins < n_bins), bins, n_bins), q)
    assert np.array_equal(dense, want[:n_bins])
    assert used == len(set(int(b) for b in bins if 0 <= b < n_bins)) <= n_entries


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")


def _level(K, F, N, k_nodes, n_bins_tot, seed):
    """binned [K, F, N] over every bin (a crowded missing bin), node ids
    [K, N] (k_nodes = inactive, some -1), gh [K, N, 2] on the card."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, n_bins_tot, size=(K, F, N)).astype(np.int16)
    binned[:, :, ::7] = n_bins_tot - 1
    node_q = rng.integers(0, k_nodes + 1, size=(K, N)).astype(np.int32)
    node_q[:, 1::13] = -1
    gh = np.stack([rng.normal(size=(K, N)), rng.uniform(0.01, 0.25, (K, N))], -1)
    return [torch.from_numpy(a).cuda() for a in (binned, node_q, gh.astype(np.float32))]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _twice_equal(fn, twin, counter, windows):
    hist_cuda.reset_launches()
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert getattr(hist_cuda, counter) == 2
    assert hist_cuda.windows_by_call.get(counter, {}) == ({windows: 2} if windows > 1 else {})
    assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(_bits(a), _bits(twin))


@pytest.mark.cuda
@pytest.mark.parametrize("k_nodes,n_bins_tot", [(8, 1025), (1, 8193), (2, MAX_NODE_BINS)])
def test_mode_kernels_in_windows_equal_their_twins(k_nodes, n_bins_tot):
    _cuda_or_skip()
    K, F, N = 2, 3, 3000
    binned, node_q, gh = _level(K, F, N, k_nodes, n_bins_tot, seed=n_bins_tot)
    lv = (binned, node_q, gh, k_nodes, n_bins_tot)
    w4 = hist_cuda.mode_plan(k_nodes, n_bins_tot, False)[1]
    w5 = hist_cuda.mode_plan(k_nodes, n_bins_tot, True)[1]
    assert (w4 > 1, w5 > 1) == ((n_bins_tot > 4842), (n_bins_tot > 7264))
    _twice_equal(lambda: hist_cuda.build_histograms_bf16(*lv),
                 hist_cuda.build_histograms_bf16_fixed(*lv), "bf16_launches", w4)
    _twice_equal(lambda: hist_cuda.build_histograms_i8(*lv),
                 hist_cuda.build_histograms_i8_plain(*lv), "i8_launches", w5)
    m = hist_cuda.digit_maxabs(gh)
    a = hist_cuda.amax_of(hist_cuda.amax_parts(gh))
    _twice_equal(lambda: hist_cuda.build_histograms_bf16_i64(*lv, m, N),
                 hist_cuda.build_histograms_bf16_i64_fixed(*lv, m, N), "bf16_i64_launches", w4)
    _twice_equal(lambda: hist_cuda.build_histograms_i8_sums(*lv, a, N),
                 hist_cuda.build_histograms_i8_sums_fixed(*lv, a, N), "i8_sums_launches", w5)


@pytest.mark.cuda
@pytest.mark.parametrize("k_nodes,n_bins_tot,skew", [(2, 16385, False), (3, MAX_NODE_BINS, False),
                                                     (32, 16385, False), (3, 8193, False),
                                                     (2, 16385, True), (1, 16385, True),
                                                     (17, 7265, True)])
def test_wide_path_in_windows_equals_its_twins(k_nodes, n_bins_tot, skew):
    # the per-node kernel: every node in its table, or (skew: node 0 takes
    # most rows, more than the slots) node 0 in windows inside its CTA; no
    # call in windows on the grid
    _cuda_or_skip()
    K, F, N = 2, 3, 7000 if skew else 3000
    binned, node_q, gh = _level(K, F, N, k_nodes, n_bins_tot, seed=k_nodes)
    if skew:
        node_q[:, :N - 400] = 0
    gh[1, 11, 0] = float("nan")  # a lane that is not finite beside a finite one
    assert hist_cuda.hist_plan(k_nodes, n_bins_tot)[3] == 0  # the wide path
    assert n_bins_tot > hist_cuda.WIDE_NODE_FROM_BINS
    most = max(int(torch.bincount(q[q >= 0].long()).max()) for q in node_q)  # a fold's node
    assert (most > hist_cuda.WIDE_NODE_SLOTS) == skew
    lv = (binned, node_q, gh, k_nodes, n_bins_tot)
    _twice_equal(lambda: hist_cuda.build_histograms(*lv), hist_cuda.build_histograms_fixed(*lv),
                 "launches", 1)
    m = hist_cuda.lane_maxabs(gh)
    _twice_equal(lambda: hist_cuda.build_histograms_i64(*lv, m, N),
                 hist_cuda.build_histograms_i64_fixed(*lv, m, N), "i64_launches", 1)
    assert hist_cuda.prep_launches == 2 and hist_cuda.node_launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("nbt", [8193, MAX_NODE_BINS])
def test_seg_kernel_in_windows_equals_its_twins(nbt):
    _cuda_or_skip()
    K, F, N = 3, 5, 2500
    n_seg = 2 * nbt
    rng = np.random.default_rng(nbt)
    binned = rng.integers(0, nbt, size=(K, F, N)).astype(np.int16)
    seg_base = rng.choice([0, nbt, n_seg], size=(K, N)).astype(np.int32)  # a pair, inactive
    gh = np.stack([rng.normal(size=(K, N)), rng.uniform(0.01, 0.25, (K, N))], -1)
    binned, seg_base, gh = (torch.from_numpy(a).cuda()
                            for a in (binned, seg_base, gh.astype(np.float32)))
    windows = hist_cuda.seg_hist_plan(n_seg)[0]
    assert windows > 1
    args = (binned, seg_base, gh, n_seg)
    _twice_equal(lambda: hist_cuda.build_seg_histograms(*args),
                 hist_cuda.build_seg_histograms_fixed(*args), "seg_launches", windows)
    m = hist_cuda.lane_maxabs(gh)
    _twice_equal(lambda: hist_cuda.build_seg_histograms_i64(*args, m, N),
                 hist_cuda.build_seg_histograms_i64_fixed(*args, m, N), "seg_i64_launches",
                 windows)
