"""GBDT histograms, batched over folds or lanes: the Hopper kernels and
their plain PyTorch versions.

Four kernels of ``csrc/hist.cu``, all shared-memory integer histograms:
the depthwise level histogram (K1, ``build_histograms``) and the leaf-wise
segment histogram (K3, ``build_seg_histograms``), one kernel template,
and the depthwise fit's two histogram modes (K4, ``build_histograms_bf16``,
and K5, ``build_histograms_i8``, one kernel template;
``GBDTParams.hist_dtype``; their digits prepared once a tree by a prep
kernel, ``prepare_digits``, and each level launched on them,
``mode_hist``), each in its own section below.

K1 is the counterpart of
``mallorn_tpu/ops/hist_pallas.py:build_histograms_fullhot`` (Pallas body
``_fullhot_kernel``), with a leading fold axis so one launch covers every
fold of a CV (K4 and K5 keep its contract). For fold k, feature f, node
c < ``k_nodes`` and bin b < ``n_bins_tot`` (bin ``n_bins_tot - 1`` is the
missing bin)::

    hist[k, f, c, b, :] = sum_r [node_q[k, r] == c] [binned[k, f, r] == b] gh[k, r, :]

Rows whose node id is outside ``[0, k_nodes)`` (the depthwise fit uses
``k_nodes``) are inactive: rows not on this level, or right children when
the level is built by subtraction. A bin outside ``[0, n_bins_tot)`` is
skipped like an inactive row.

- ``build_histograms`` launches the CUDA kernel (``csrc/hist.cu``) for CUDA
  tensors and runs ``build_histograms_plain`` for CPU tensors. A CUDA
  tensor never falls back: the kernel launches or the call raises. The
  kernel adds in 64-bit fixed point, so its result is the exact sum to
  within one float32 ulp and identical from launch to launch.
- ``build_histograms_plain`` is an ``index_add_`` per feature over the
  flattened (fold, node, bin) segments, in ``gh``'s dtype (float64 gives
  the oracle). The CPU tests use it; ``chip_smoke.py`` holds the kernel
  against it on the card.
- ``build_histograms_fixed`` is the kernel's own arithmetic in plain
  PyTorch (the same scale, rounding and int64 sums): it equals the kernel
  bit for bit, so a fit through it must build the kernel's forest
  (``build_seg_histograms_fixed`` and ``build_histograms_bf16_fixed`` are
  K3's and K4's; K5's plain version is its kernel's arithmetic already).
- ``launches`` counts K1's launches (``launches_by_nodes`` per level
  width), ``seg_launches`` K3's,
  ``bf16_launches`` K4's and ``i8_launches`` K5's, ``i64_launches``,
  ``seg_i64_launches``, ``bf16_i64_launches`` and ``i8_sums_launches``
  the external-scale entries' of K1, K3, K4 and K5, ``digit_prep_launches``
  K4 / K5's prep kernel's (plain calls do not count).

K1 and K3 also have an external-scale entry for a fit whose rows are
split over ranks (``parallel.sharded_train``): ``build_histograms_i64``
and ``build_seg_histograms_i64`` take every rank's per-lane max |g| and
max |h| and the global row count, and return the raw int64 fixed-point
sums of this rank's rows. Those are exactly the single-device sums
restricted to the rank's rows, so their all-reduced total, converted once
(``from_fixed_sums``), is the single-device histogram bit for bit. Their
plain twins are ``build_histograms_i64_fixed`` and
``build_seg_histograms_i64_fixed`` (``build_histograms_fixed`` and
``build_seg_histograms_fixed`` are the twins of all rows at their own
scale, converted). K4 and K5 have theirs too, in their section:
``build_histograms_bf16_i64`` and ``build_histograms_i8_sums``.

K1 and K3 run one kernel, ``csrc/hist.cu`` ``group_hist_kernel`` (its note
says more): K1's output is K3's with n_seg = k_nodes n_bins_tot and a
row's segment base its node times n_bins_tot, and the two differ only in
which (row, feature) counts. One CTA takes a fold and a group of G
features, finds the fold's scale itself (max |g|, max |h| and a
non-finite flag), stages the rows in tiles with asynchronous copies,
compacts each tile's active rows once, computes q once per row and adds it
into its G histograms as pairs of 32-bit atomics. G and the tile come from
the shape: ``hist_layout`` (K1, by level) and ``seg_hist_layout`` (K3).
The wrappers allocate ``out`` and launch, nothing else; ``launch_hist_kernel``
and ``launch_seg_kernel`` are the launches alone, of either scale (the
external one given ``maxabs`` and ``log2n``: one C entry per kernel,
``mallorn_hist`` / ``mallorn_seg_hist``, with a nullable ``maxabs``).

A K1 level of 17 nodes or more (``WIDE_FROM_NODES``: depth 6-8's last
levels), or wider than one CTA's histograms hold, takes the wide path
(``hist_plan`` picks it, ``wide_plan`` lays it out; its section below): a
prep kernel groups each fold's active rows by chunk of nodes once a level
and finds the folds' maxima (``launch_group_rows``, plain version
``group_rows_plain``), then one CTA per (fold, group of G features, chunk of
nodes) walks its chunk's row list alone (``launch_wide_kernel``; its
arithmetic in plain PyTorch, ``build_histograms_wide_fixed``). Same scale,
same integer sums: the output is ``build_histograms_fixed``'s
(``build_histograms_i64_fixed``'s) bit for bit. ``launches`` and
``launches_by_nodes`` count one per K1 call on either path,
``prep_launches`` the prep kernel's launches.

Every kernel takes up to MAX_NODE_BINS (32,768) bins a node, the most
int16 bin ids hold. Where a CTA cannot hold a node's bins (K4 beyond 4,842,
K5 beyond 7,264) or a call's segments (K3 beyond SEG_MAX_SEGMENTS), each
CTA holds a window of them, the windows on the grid's z axis beside the
node groups, and adds only the rows whose bin (K3: segment base + bin)
falls in it (``mode_plan``, ``seg_hist_plan``). Integer sums do not depend
on the tiling, so a windowed launch is its twin's bit for bit; each window
re-reads its rows. The counters count calls; ``windows_by_call`` records
the windows of each call that took more than one. K1's wide path takes a
node of more than WIDE_NODE_FROM_BINS (7,264) bins in a CTA of its own
whose shared memory grows with the node's rows, not its bins
(``wide_node_plan``; its calls counted in ``node_launches``): a table of
the bins its rows occupy, or, for a node of more rows than the table's
slots, windows of bins inside the CTA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mallorn_tpu_torch.utils import cuda_build

# the shared memory a CTA may take on an H100. K1 and K3 hold their group's
# histograms, staged row tiles and active list in it (``_group_layout``:
# at most SEG_MAX_SEGMENTS = 14,004 segments, 54 nodes at 257 bins; K1's
# wide path holds a chunk of nodes' histograms alone), K4 / K5 one (fold,
# feature, <= 8 nodes) histogram. Where a node's bins (K1's wide path, K4,
# K5) or a call's segments (K3) exceed one CTA, each CTA holds a window of
# them (grid z takes the windows) and adds only the rows that fall in it
SMEM_BYTES = 232448
# bins a node (n_bins_tot) every histogram kernel takes: 32,767 value bins
# and the missing bin, the most int16 bin ids hold (trees.binning.MAX_N_BINS)
MAX_NODE_BINS = 32768
MAX_GRID_Z = 65535  # CTAs on a grid's z axis at most

launches = 0
launches_by_nodes: dict = {}  # K1's launches per k_nodes
seg_launches = 0
bf16_launches = 0
i8_launches = 0
i64_launches = 0  # K1's external-scale entry
seg_i64_launches = 0  # K3's
bf16_i64_launches = 0  # K4's
i8_sums_launches = 0  # K5's
prep_launches = 0  # K1's row grouping (the wide path's prep kernel, both scales)
node_launches = 0  # K1's calls through the wide path's per-node kernel (both scales)
digit_prep_launches = 0  # K4 / K5's digits (the prep kernel, once a tree)
# {counter name: {windows: calls}} of the calls whose launch took more than
# one window of bins or segments (the counters above count calls)
windows_by_call: dict = {}


def reset_launches() -> None:
    global launches, seg_launches, bf16_launches, i8_launches, i64_launches, seg_i64_launches
    global bf16_i64_launches, i8_sums_launches, prep_launches, digit_prep_launches, node_launches
    launches = seg_launches = bf16_launches = i8_launches = 0
    i64_launches = seg_i64_launches = bf16_i64_launches = i8_sums_launches = prep_launches = 0
    digit_prep_launches = node_launches = 0
    launches_by_nodes.clear()
    windows_by_call.clear()


def _note_windows(counter: str, windows: int) -> None:
    if windows > 1:
        calls = windows_by_call.setdefault(counter, {})
        calls[windows] = calls.get(windows, 0) + 1


def _windows(n: int, max_per_cta: int):
    """(windows, per window) of n cells in the fewest equal windows (the
    last may be shorter) of at most ``max_per_cta``."""
    windows = -(-n // max_per_cta)
    return windows, -(-n // windows)


def _check_shapes(binned, node_q, gh):
    if binned.dim() != 3 or node_q.dim() != 2 or gh.dim() != 3 or gh.shape[2] != 2:
        raise ValueError(f"expected binned [K, F, N], node_q [K, N], gh [K, N, 2]; got "
                         f"{tuple(binned.shape)}, {tuple(node_q.shape)}, {tuple(gh.shape)}")
    K, _, N = binned.shape
    if tuple(node_q.shape) != (K, N) or tuple(gh.shape[:2]) != (K, N):
        raise ValueError("binned, node_q and gh disagree on folds or rows")


def _segment_sums(binned, node_q, vals, k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """[K, F, k_nodes, n_bins_tot, C] sums of ``vals`` [K, N, C] in its
    dtype: an ``index_add_`` per feature over the flattened (fold, node,
    bin) segments."""
    K, F, N = binned.shape
    C = vals.shape[2]
    n_seg = k_nodes * n_bins_tot
    dev = vals.device
    nq = node_q.long()
    node_ok = (nq >= 0) & (nq < k_nodes)
    base = torch.arange(K, device=dev)[:, None] * n_seg + nq * n_bins_tot
    flat = vals.reshape(K * N, C)
    out = torch.zeros(F, K * n_seg + 1, C, dtype=vals.dtype, device=dev)
    for f in range(F):
        b = binned[:, f, :].long()
        ok = node_ok & (b >= 0) & (b < n_bins_tot)
        seg = torch.where(ok, base + b, K * n_seg)  # inactive -> a sink segment
        out[f].index_add_(0, seg.reshape(-1), flat)
    return out[:, :-1].reshape(F, K, k_nodes, n_bins_tot, C).transpose(0, 1).contiguous()


def build_histograms_plain(binned: torch.Tensor, node_q: torch.Tensor,
                           gh: torch.Tensor, k_nodes: int,
                           n_bins_tot: int) -> torch.Tensor:
    """[K, F, k_nodes, n_bins_tot, 2] histograms in ``gh``'s dtype."""
    _check_shapes(binned, node_q, gh)
    return _segment_sums(binned, node_q, gh, k_nodes, n_bins_tot)


def _log2_ceil(n: int) -> int:
    return max(int(n) - 1, 0).bit_length()


def lane_maxabs(gh: torch.Tensor) -> torch.Tensor:
    """[K, C] float32 max |gh| over the rows of each lane and channel, +inf
    where a lane holds a non-finite value: what ``fixed_scale`` and the
    external-scale entries take (a max-reduce of it over ranks is the
    global one)."""
    K, N, C = gh.shape
    if not N:
        return torch.zeros(K, C, dtype=torch.float32, device=gh.device)
    m = gh.abs().amax(dim=1).float()  # NaN propagates
    bad = ~torch.isfinite(gh).all(dim=1).all(dim=1, keepdim=True)
    return torch.where(bad | ~torch.isfinite(m), torch.inf, m)


def fixed_scale(maxabs: torch.Tensor, n_rows: int):
    """(scale [K, C] float64, finite [K]) of the fixed point at per-lane
    maxima ``maxabs`` [K, C] and ``n_rows`` rows: S = 2^(62 - ceil(log2
    n_rows) - e) with maxabs < 2^e (1 where maxabs is 0); a lane is finite
    when all its maxima are."""
    _, e = torch.frexp(maxabs)
    scale = torch.where(maxabs > 0,
                        torch.ldexp(torch.ones_like(maxabs, dtype=torch.float64),
                                    62 - _log2_ceil(n_rows) - e), 1.0).to(torch.float64)
    return scale, torch.isfinite(maxabs).all(dim=1)


def _fixed_point(gh: torch.Tensor, maxabs: Optional[torch.Tensor] = None,
                 n: Optional[int] = None):
    """(q [K, N, C] int64, scale [K, C] float64, finite [K]): per fold and
    channel, S = 2^(62 - ceil(log2 N) - e) with max|gh| < 2^e, each value
    rounded to the nearest integer of value * S (0 in a lane that is not
    finite). ``maxabs`` [K, C] and ``n`` replace the rows' own maxima and
    count (the global ones of a fit split over ranks)."""
    K, N, C = gh.shape
    if maxabs is None:
        maxabs = gh.abs().amax(dim=1) if N else torch.zeros(K, C, device=gh.device)
    scale, finite = fixed_scale(maxabs, N if n is None else n)
    q = torch.round(gh.double() * scale[:, None, :])
    q = torch.where(torch.isfinite(q) & finite[:, None, None], q, 0.0).to(torch.int64)
    return q, scale, finite


def _from_fixed(acc: torch.Tensor, scale: torch.Tensor, finite: torch.Tensor) -> torch.Tensor:
    """Integer sums [K, ..., C] -> float32 sums / S; NaN in every cell of a
    fold whose gh is not finite."""
    tail = (1,) * (acc.dim() - 2)
    out = (acc.double() * (1.0 / scale).reshape(len(scale), *tail, scale.shape[1])).float()
    return torch.where(finite.reshape(-1, *tail, 1), out, torch.nan)


def from_fixed_sums(acc: torch.Tensor, maxabs: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Int64 sums of the external-scale entries (or their all-reduced
    total) -> float32 histograms at the scale of ``maxabs`` and ``n_rows``;
    NaN in every cell of a lane that is not finite."""
    scale, finite = fixed_scale(maxabs.to(acc.device), n_rows)
    return _from_fixed(acc, scale, finite)


def build_histograms_i64_fixed(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                               k_nodes: int, n_bins_tot: int, maxabs: torch.Tensor,
                               n_rows: int) -> torch.Tensor:
    """K1's int64 fixed-point sums [K, F, k_nodes, n_bins_tot, 2] in plain
    PyTorch, at the scale of ``maxabs`` and ``n_rows``, zeros in a lane
    that is not finite: equal to ``build_histograms_i64`` bit for bit."""
    _check_shapes(binned, node_q, gh)
    q, _, _ = _fixed_point(gh, maxabs, n_rows)
    return build_histograms_plain(binned, node_q, q, k_nodes, n_bins_tot)


def build_histograms_fixed(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                           k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """The kernel's int64 fixed-point histogram in plain PyTorch: per fold
    and channel, scale S = 2^(62 - ceil(log2 N) - e) with max|gh| < 2^e,
    each value rounded to the nearest integer of value * S, integer sums
    (exact, any order), one conversion (sum / S -> float32); NaN in every
    cell of a fold whose gh is not finite."""
    _check_shapes(binned, node_q, gh)
    q, scale, finite = _fixed_point(gh)
    return _from_fixed(build_histograms_plain(binned, node_q, q, k_nodes, n_bins_tot),
                       scale, finite)


def _check_cuda_inputs(name: str, binned, node_q, gh) -> None:
    """What the level-histogram kernels (K1, K4, K5) take: CUDA tensors on
    one device, int16 bins, int32 node ids, float32 (g, h), contiguous."""
    if binned.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {binned.device}")
    _check_shapes(binned, node_q, gh)
    if (binned.dtype, node_q.dtype, gh.dtype) != (torch.int16, torch.int32, torch.float32):
        raise TypeError(f"{name}: expected int16 bins, int32 node ids and "
                        f"float32 (g, h); got {binned.dtype}, {node_q.dtype}, {gh.dtype}")
    if not (binned.is_contiguous() and node_q.is_contiguous() and gh.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if not (node_q.device == gh.device == binned.device):
        raise ValueError(f"{name}: inputs on different devices")


# ---------------------------------------------------------------------------
# The group kernel's layout (K1 and K3: csrc/hist.cu group_hist_kernel)
# ---------------------------------------------------------------------------
# The kernel is bound by bytes: K1 at the v92d CV's deepest level (K = 5,
# F = 222, N = 2,444, 8 nodes) moves 5.4 MB in and 18.3 MB out, ~7 us at
# 3.35 TB/s; K3 at v114d's split step (K = 25, F = 228, N = 2,443,
# n_seg = 514) 28.0 MB in and 23.4 MB out, ~15 us. A CTA holds G features'
# int64 histograms (16 G n_seg bytes), two staged row tiles and the active
# list, so G and the tile trade the histograms' room against the grid:
# ceil(F / G) x K CTAs on 132 SMs.

SEG_THREADS = 256  # threads per CTA (csrc/hist.cu kSegThreads)
SEG_STAGES = 2  # row tiles in flight (kSegStages)
# K3's features per CTA and rows per tile at the fit's widths (the fastest
# of G = 2, 4, 8 and 256-, 512-, 1,024-row tiles on an H100 at a v114d
# split step; tools/time_seg_hist.py --layouts times them)
SEG_GROUP, SEG_TILE_ROWS = 4, 512
# K1's features per CTA and rows per tile by level (nodes per launch; a
# level between two entries takes the larger's): the fastest of G = 1, 2,
# 4, 8 and 256-, 512-, 1,024-row tiles on an H100 at the fits' shapes
# (tools/time_hist.py --layouts times them)
HIST_LAYOUTS = {1: (4, 512), 2: (4, 512), 4: (2, 512), 8: (1, 256), 16: (1, 256)}


def _seg_smem_bytes(n_seg: int, group: int, rows: int) -> int:
    """The group kernel's shared memory per CTA (csrc/hist.cu
    ``seg_smem_bytes``): the group's int64 [n_seg, 2] histograms,
    SEG_STAGES staged tiles (the rows' ids and the group's bins, 16 spare
    bytes per array), the active list (20 B a row) and the per-warp
    reductions."""
    stage = 4 * rows + 16 + group * (2 * rows + 16)
    return 16 * group * n_seg + SEG_STAGES * stage + 20 * rows + 16 * (SEG_THREADS // 32)


SEG_MAX_SEGMENTS = (SMEM_BYTES - _seg_smem_bytes(0, 1, SEG_THREADS)) // 16


def _group_layout(name: str, n_seg: int, group: int, rows: int):
    """(G, rows per tile, shared-memory bytes) from a starting G and tile:
    G halved while a CTA would exceed SMEM_BYTES, then the rows (not below
    SEG_THREADS). Raises beyond SEG_MAX_SEGMENTS."""
    if not 1 <= n_seg <= SEG_MAX_SEGMENTS:
        raise ValueError(f"{name}: {n_seg} segments; the kernel's shared memory "
                         f"({SMEM_BYTES} bytes per CTA) takes 1 to {SEG_MAX_SEGMENTS}")
    while group > 1 and _seg_smem_bytes(n_seg, group, rows) > SMEM_BYTES:
        group //= 2
    while _seg_smem_bytes(n_seg, group, rows) > SMEM_BYTES:
        rows //= 2
    return group, rows, _seg_smem_bytes(n_seg, group, rows)


def hist_layout(k_nodes: int, n_bins_tot: int):
    """(features per CTA G, rows per tile, shared-memory bytes) of a K1 CTA
    that holds ``k_nodes`` x ``n_bins_tot`` segments: HIST_LAYOUTS' entry
    for the level, shrunk as ``_group_layout`` does until the CTA fits.
    Raises beyond SEG_MAX_SEGMENTS segments (54 nodes at 257 bins);
    ``hist_plan`` sends such a level, and any of WIDE_FROM_NODES nodes or
    more, down the wide path."""
    levels = sorted(HIST_LAYOUTS)
    level = next((c for c in levels if c >= k_nodes), levels[-1])
    return _group_layout(f"build_histograms ({k_nodes} nodes x {n_bins_tot} bins)",
                         k_nodes * n_bins_tot, *HIST_LAYOUTS[level])


def hist_plan(k_nodes: int, n_bins_tot: int):
    """(nodes per CTA, chunks, G, rows per tile, shared-memory bytes) of a
    K1 call: a level of fewer than WIDE_FROM_NODES nodes that one CTA holds
    is one chunk at ``hist_layout``, the one-CTA kernel; any other takes the
    wide path at ``wide_plan``, its chunks of nodes and G, with 0 rows per
    tile (no tiles: each CTA walks its chunk's row list). Raises as
    ``wide_plan`` does."""
    if (1 <= k_nodes < WIDE_FROM_NODES and n_bins_tot >= 1
            and k_nodes * n_bins_tot <= SEG_MAX_SEGMENTS):
        return (k_nodes, 1) + hist_layout(k_nodes, n_bins_tot)
    chunk, n_chunks, group, smem = wide_plan(k_nodes, n_bins_tot)
    return chunk, n_chunks, group, 0, smem


def seg_hist_layout(n_seg: int):
    """(features per CTA G, rows per tile, shared-memory bytes) of a K3 CTA
    that holds ``n_seg`` segments: SEG_GROUP and SEG_TILE_ROWS, shrunk as
    ``_group_layout`` does until the CTA fits. Raises beyond
    SEG_MAX_SEGMENTS."""
    return _group_layout("build_seg_histograms", n_seg, SEG_GROUP, SEG_TILE_ROWS)


# segments a K3 call takes: a pair of nodes of MAX_NODE_BINS bins (a row's
# list entry keeps its segment base in 16 bits)
SEG_MAX_TOTAL = 2 * MAX_NODE_BINS


def seg_hist_plan(n_seg: int):
    """(windows, segments per window, G, rows per tile, shared-memory bytes)
    of a K3 call of ``n_seg`` segments: up to SEG_MAX_SEGMENTS one window
    (one CTA per (lane, G features)), beyond it the fewest equal windows of
    at most that many, each a CTA of its own, at ``seg_hist_layout`` of a
    window. Raises beyond SEG_MAX_TOTAL."""
    if not 1 <= n_seg <= SEG_MAX_TOTAL:
        raise ValueError(f"build_seg_histograms: {n_seg} segments; the kernel takes 1 to "
                         f"{SEG_MAX_TOTAL}")
    windows, window = _windows(n_seg, SEG_MAX_SEGMENTS)
    return (windows, window) + seg_hist_layout(window)


# ---------------------------------------------------------------------------
# K1: level histograms of the depthwise fit
# ---------------------------------------------------------------------------

def launch_hist_kernel(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                       out: torch.Tensor, k_nodes: int, n_bins_tot: int,
                       maxabs: Optional[torch.Tensor] = None, log2n: int = 0) -> None:
    """One K1 call on inputs the wrapper checked, at ``hist_plan(k_nodes,
    n_bins_tot)``: the one-CTA kernel, or the wide path's prep and
    histogram kernels; writes ``out`` [K, F, k_nodes, n_bins_tot, 2]:
    float32 at the folds' own scale, or, given ``maxabs`` [K, 2] and
    ``log2n``, the int64 sums at that external scale. Counts nothing."""
    K, F, N = binned.shape
    chunk, _, group, rows, _ = hist_plan(k_nodes, n_bins_tot)
    if rows == 0:
        grouped = launch_group_rows(node_q, gh, k_nodes, chunk, maxabs, log2n)
        launch_wide_kernel(binned, grouped, out, k_nodes, n_bins_tot, chunk, group,
                           None if maxabs is None else log2n)
        return
    lib = cuda_build.load()
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = lib.mallorn_hist(binned.data_ptr(), node_q.data_ptr(), gh.data_ptr(),
                              out.data_ptr(), K, F, N, k_nodes, n_bins_tot, group, rows,
                              None if maxabs is None else maxabs.data_ptr(), log2n, stream)
    cuda_build.check(rc, "mallorn_hist")


def _check_external(name: str, gh: torch.Tensor, maxabs: torch.Tensor, n_rows: int,
                    channels: int = 2, max_log2: int = 62) -> int:
    """log2 of the global row count of an external-scale call, after
    checking ``maxabs`` [K, channels] float32 on ``gh``'s device and
    ``n_rows`` against the rows given (at most 2^max_log2)."""
    K, N, _ = gh.shape
    if tuple(maxabs.shape) != (K, channels) or maxabs.dtype != torch.float32:
        raise ValueError(f"{name}: maxabs must be [K, {channels}] float32, got "
                         f"{tuple(maxabs.shape)} {maxabs.dtype}")
    if maxabs.device != gh.device or not maxabs.is_contiguous():
        raise ValueError(f"{name}: maxabs must be contiguous on {gh.device}")
    log2n = _log2_ceil(n_rows)
    if n_rows < N or log2n > max_log2:
        raise ValueError(f"{name}: n_rows = {n_rows} must count at least this call's {N} "
                         f"rows and at most 2^{max_log2}")
    return log2n


def build_histograms_i64(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                         k_nodes: int, n_bins_tot: int, maxabs: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """K1's external-scale entry: the int64 fixed-point (grad, hess) sums
    [K, F, k_nodes, n_bins_tot, 2] of these rows at the scale of ``maxabs``
    [K, 2] float32 (every rank's max |g|, max |h| per lane, +inf where not
    finite; ``lane_maxabs``) and ``n_rows`` (the global row count). Zeros
    in a lane that is not finite. A CPU tensor runs the plain twin
    ``build_histograms_i64_fixed``."""
    global i64_launches, prep_launches, node_launches
    if binned.device.type == "cpu":
        return build_histograms_i64_fixed(binned, node_q, gh, k_nodes, n_bins_tot,
                                          maxabs, n_rows)
    _check_cuda_inputs("build_histograms_i64", binned, node_q, gh)
    log2n = _check_external("build_histograms_i64", gh, maxabs, n_rows)
    wide = hist_plan(k_nodes, n_bins_tot)[3] == 0
    K, F, _ = binned.shape
    out = torch.empty(K, F, k_nodes, n_bins_tot, 2, dtype=torch.int64, device=binned.device)
    if K == 0 or F == 0:
        return out
    launch_hist_kernel(binned, node_q, gh, out, k_nodes, n_bins_tot, maxabs, log2n)
    i64_launches += 1
    prep_launches += wide
    node_launches += wide and n_bins_tot > WIDE_NODE_FROM_BINS
    return out


def build_histograms(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                     k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """[K, F, k_nodes, n_bins_tot, 2] float32 (grad, hess) histograms from
    int16 bins [K, F, N], int32 node ids [K, N] and float32 (g, h) [K, N, 2]."""
    global launches, prep_launches, node_launches
    if binned.device.type == "cpu":
        return build_histograms_plain(binned, node_q, gh, k_nodes, n_bins_tot)
    _check_cuda_inputs("build_histograms", binned, node_q, gh)
    wide = hist_plan(k_nodes, n_bins_tot)[3] == 0  # refuses a level the kernels do not take
    K, F, _ = binned.shape
    out = torch.empty(K, F, k_nodes, n_bins_tot, 2, dtype=torch.float32, device=binned.device)
    if K == 0 or F == 0:
        return out
    launch_hist_kernel(binned, node_q, gh, out, k_nodes, n_bins_tot)
    launches += 1
    launches_by_nodes[k_nodes] = launches_by_nodes.get(k_nodes, 0) + 1
    prep_launches += wide
    node_launches += wide and n_bins_tot > WIDE_NODE_FROM_BINS
    return out


# ---------------------------------------------------------------------------
# K1's wide path (csrc/hist.cu wide_prep_kernel and wide_hist_kernel; its
# note says more)
# ---------------------------------------------------------------------------
# A wide level is bound by its output (K = 5, F = 222, 257 bins: 146 MB at
# 64 nodes, 292 MB at 128). A prep kernel groups each fold's active rows by
# chunk of nodes once a level (the lists and their offsets) and finds the
# folds' max |g|, max |h|; one CTA per (fold, G features, chunk) then walks
# its chunk's list alone, so a chunk may be small enough for several CTAs
# to share an SM.

WIDE_THREADS = 256  # threads per CTA of the wide kernel (csrc/hist.cu kWideThreads)
WIDE_MAX_GROUP = 4  # features per CTA at most (kWideMaxGroup)
WIDE_MAX_CHUNKS = 1024  # chunks of nodes per level at most (kWideMaxChunks)
# levels of at least this many nodes take the wide path, as does any level
# one CTA cannot hold: at 17-54 nodes of the v92d CV's shape the wide path
# was the faster in every sweep (tools/time_hist.py --layouts, NVIDIA H100
# 80GB HBM3 at 700 W); 1-16 nodes, every shipped configuration's levels,
# keep the one-CTA kernel
WIDE_FROM_NODES = 17
# the wide kernel's (features per CTA G, nodes per chunk) by level (a level
# between two entries takes the larger's, a wider one the last): from
# ``tools/time_hist.py --layouts`` at K = 5, F = 222, N = 2,444 (G = 1-4,
# 6-22 nodes per chunk): one feature of 11 nodes was the fastest or within
# 7% of it at 64 and 128 nodes in every sweep; at 17-54 nodes the sweep's
# calls are bound by the host, every layout of one feature within 0.06-0.08
# ms on an NVIDIA H100 80GB HBM3 at 700 W, 6 nodes the fastest at 17
WIDE_LAYOUTS = {17: (1, 6), 128: (1, 11)}


def _wide_smem_bytes(chunk_nodes: int, n_bins_tot: int, group: int) -> int:
    """The wide kernel's shared memory per CTA (csrc/hist.cu
    ``wide_smem_bytes``): G int64 [chunk_nodes n_bins_tot, 2] histograms."""
    return 16 * group * chunk_nodes * n_bins_tot


# a node of more bins than this takes the per-node kernel (csrc/hist.cu
# node_hist_kernel; kWideNodeFromBins): two such nodes' histograms exceed a
# CTA, so the chunk kernel would hold one alone, its shared memory growing
# with the bins
WIDE_NODE_FROM_BINS = SMEM_BYTES // _wide_smem_bytes(2, 1, 1)
def _node_smem_bytes(n_bins_tot: int, slots: int) -> int:
    """The per-node kernel's shared memory per CTA (csrc/hist.cu
    ``node_smem_bytes``): ``slots`` cells of four word planes and an
    entry's bin (18 B a slot), the bitmap of the node's bins and its words'
    ranks (8 B a word of 32 bins)."""
    return 18 * slots + 8 * (-(-n_bins_tot // 32))


# an H100 SM's shared memory, of which each resident CTA takes 1 KB more
# than it asks for
SM_SMEM_BYTES, CTA_RESERVED_SMEM = 233472, 1024
# the per-node kernel's slots: a node of at most this many rows takes the
# table of its occupied bins, one of more its bins in windows of at most
# this many. The most (a multiple of 32) for which two CTAs share an SM at
# MAX_NODE_BINS bins: with tools/time_hist.py --slots at 32 x 16,385 bins,
# F = 16 (NVIDIA H100 80GB HBM3, 700 W), 4,096-6,144 slots (two CTAs an SM)
# were within 1% of each other in both entries, the external one 7% faster
# than at 1,024-2,048 (more CTAs an SM streaming their runs of out at once)
# and the float32 one 23-26% faster than at 8,192 (one CTA an SM); a
# crowded node (7,743 rows) in windows took 0.046 ms at 6,144 slots against
# 0.070 at 4,096
WIDE_NODE_SLOTS = (SM_SMEM_BYTES // 2 - CTA_RESERVED_SMEM
                   - _node_smem_bytes(MAX_NODE_BINS, 0)) // 18 // 32 * 32


def wide_windows(n_bins_tot: int, slots: int = WIDE_NODE_SLOTS):
    """(windows, bins per window) in which the per-node kernel takes the
    bins of a node of more rows than ``slots``, one window after another
    inside its CTA: the fewest equal windows (the last may be shorter) of at
    most ``slots`` bins."""
    return _windows(n_bins_tot, slots)


def wide_node_plan(n_bins_tot: int, slots: int = WIDE_NODE_SLOTS):
    """(slots, windows, bins per window, shared-memory bytes) of the
    per-node kernel at ``n_bins_tot`` bins a node: the table of ``slots``
    occupied bins (a multiple of 32), or ``wide_windows`` for a node of more
    rows. Raises where a CTA would exceed SMEM_BYTES."""
    smem = _node_smem_bytes(n_bins_tot, slots)
    if slots < 32 or slots % 32 or smem > SMEM_BYTES:
        raise ValueError(f"build_histograms ({n_bins_tot} bins a node): {slots} slots are not "
                         f"a multiple of 32 whose CTA fits {SMEM_BYTES} bytes")
    return (slots,) + wide_windows(n_bins_tot, slots) + (smem,)


def wide_plan(k_nodes: int, n_bins_tot: int, layout=None):
    """(nodes per chunk, chunks, G, shared-memory bytes) of K1's wide path:
    ``layout`` (G, nodes per chunk), by default WIDE_LAYOUTS' entry for the
    level, with G halved and then the nodes cut while a CTA would exceed
    SMEM_BYTES, the nodes at most ``k_nodes``; the level in the fewest
    chunks of at most that many nodes, equal but for the last. A node of
    more than WIDE_NODE_FROM_BINS bins is a chunk of its own, G = 1, on the
    per-node kernel (``wide_node_plan``'s bytes). Raises beyond
    MAX_NODE_BINS bins a node or WIDE_MAX_CHUNKS chunks."""
    name = f"build_histograms ({k_nodes} nodes x {n_bins_tot} bins)"
    if k_nodes < 1 or not 1 <= n_bins_tot <= MAX_NODE_BINS:
        raise ValueError(f"{name}: the kernels take 1 to {MAX_NODE_BINS} bins a node and at "
                         f"least one node")
    if layout is None:
        levels = sorted(WIDE_LAYOUTS)
        layout = WIDE_LAYOUTS[next((c for c in levels if c >= k_nodes), levels[-1])]
    group, nodes = layout
    if not (1 <= group <= WIDE_MAX_GROUP and nodes >= 1):
        raise ValueError(f"{name}: layout {layout} is not (1 to {WIDE_MAX_GROUP} features, "
                         f"at least one node)")
    per_node = n_bins_tot > WIDE_NODE_FROM_BINS
    if per_node:
        group = nodes = 1
    else:
        while group > 1 and _wide_smem_bytes(nodes, n_bins_tot, group) > SMEM_BYTES:
            group //= 2
        nodes = min(nodes, k_nodes, SMEM_BYTES // _wide_smem_bytes(1, n_bins_tot, group))
    n_chunks = -(-k_nodes // nodes)
    if n_chunks > WIDE_MAX_CHUNKS:
        raise ValueError(f"{name}: {n_chunks} chunks of {nodes} nodes exceed the "
                         f"{WIDE_MAX_CHUNKS} the row grouping takes")
    chunk = -(-k_nodes // n_chunks)
    smem = (wide_node_plan(n_bins_tot)[3] if per_node
            else _wide_smem_bytes(chunk, n_bins_tot, group))
    return chunk, n_chunks, group, smem


class GroupedRows(NamedTuple):
    """The prep kernel's output: each fold's active rows grouped by chunk
    of nodes, in row order within a chunk (chunk c's at [offsets[k, c],
    offsets[k, c + 1])), with their fixed-point (g, h) at the scale of
    ``maxabs``."""
    entries: torch.Tensor  # [K, N, 2] int32: (row, node - the chunk's first node)
    q: torch.Tensor  # [K, N, 2] int64: the row's q (0 in a lane that is not finite)
    offsets: torch.Tensor  # [K, n_chunks + 1] int32
    maxabs: torch.Tensor  # [K, 2] float32: the folds' own maxima (lane_maxabs) or the caller's


def group_rows_plain(node_q: torch.Tensor, gh: torch.Tensor, k_nodes: int, chunk_nodes: int,
                     maxabs: Optional[torch.Tensor] = None,
                     n_rows: Optional[int] = None) -> GroupedRows:
    """The prep kernel's function in plain PyTorch: each fold's rows whose
    node id lies in [0, ``k_nodes``) grouped by chunk of ``chunk_nodes``
    nodes, in row order within a chunk, as (row, node in the chunk), and
    their q at the folds' own scale (``lane_maxabs`` and N) or, given
    ``maxabs`` and ``n_rows``, at that external scale; entries of -1 and q
    of 0 after the lists (the kernel leaves them unwritten)."""
    K, N = node_q.shape
    dev = node_q.device
    n_chunks = -(-k_nodes // chunk_nodes)
    nq = node_q.long()
    active = (nq >= 0) & (nq < k_nodes)
    chunk = torch.where(active, nq.clamp(min=0) // chunk_nodes, n_chunks)
    order = torch.sort(chunk * N + torch.arange(N, device=dev), dim=1).indices
    counts = torch.zeros(K, n_chunks + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, chunk, torch.ones_like(chunk))
    offsets = torch.cat([torch.zeros(K, 1, dtype=torch.int64, device=dev),
                         counts[:, :n_chunks].cumsum(dim=1)], dim=1)
    listed = torch.arange(N, device=dev) < offsets[:, -1:]
    local = nq.gather(1, order) - chunk.gather(1, order) * chunk_nodes
    entries = torch.where(listed[..., None], torch.stack([order, local], dim=-1), -1)
    m = lane_maxabs(gh) if maxabs is None else maxabs
    q, _, _ = _fixed_point(gh, m, N if n_rows is None else n_rows)
    q = torch.where(listed[..., None], q.gather(1, order[..., None].expand(K, N, 2)), 0)
    return GroupedRows(entries.to(torch.int32), q, offsets.to(torch.int32), m)


def build_histograms_wide_fixed(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                                k_nodes: int, n_bins_tot: int, chunk_nodes: int,
                                maxabs: Optional[torch.Tensor] = None,
                                n_rows: Optional[int] = None) -> torch.Tensor:
    """The wide path's arithmetic in plain PyTorch: the rows grouped by
    chunk with their q (``group_rows_plain``, at the folds' own scale or at
    that of ``maxabs`` and ``n_rows``), and per fold and chunk the int64
    sums of its listed rows' q into the chunk's cells. Returns them
    converted once (float32, NaN in a fold that is not finite:
    ``build_histograms_fixed`` bit for bit) or, given ``maxabs``, raw (zeros
    in such a lane: ``build_histograms_i64_fixed`` bit for bit)."""
    _check_shapes(binned, node_q, gh)
    K, F, N = binned.shape
    grouped = group_rows_plain(node_q, gh, k_nodes, chunk_nodes, maxabs, n_rows)
    n_cells = k_nodes * n_bins_tot
    cells = torch.zeros(K, F, n_cells + 1, 2, dtype=torch.int64, device=gh.device)  # + a sink
    f_off = torch.arange(F, device=gh.device)[:, None] * (n_cells + 1)
    off = grouped.offsets.tolist()
    for k in range(K):
        for c in range(len(off[k]) - 1):
            en = grouped.entries[k, off[k][c]:off[k][c + 1]].long()
            b = binned[k][:, en[:, 0]].long()
            local = en[:, 1] * n_bins_tot + b  # the chunk's own cells
            seg = torch.where((b >= 0) & (b < n_bins_tot), c * chunk_nodes * n_bins_tot + local,
                              n_cells)
            q = grouped.q[k, off[k][c]:off[k][c + 1]]
            cells[k].view(-1, 2).index_add_(0, (f_off + seg).reshape(-1),
                                            q[None].expand(F, -1, 2).reshape(-1, 2))
    out = cells[:, :, :n_cells].reshape(K, F, k_nodes, n_bins_tot, 2)
    if maxabs is not None:
        return out
    scale, finite = fixed_scale(grouped.maxabs, N)
    return _from_fixed(out, scale, finite)


def launch_group_rows(node_q: torch.Tensor, gh: torch.Tensor, k_nodes: int, chunk_nodes: int,
                      maxabs: Optional[torch.Tensor] = None, log2n: int = 0) -> GroupedRows:
    """One launch of the prep kernel on checked CUDA inputs: what
    ``group_rows_plain`` gives, bit for bit over the lists (their tails
    unwritten), at the folds' own scale or, given ``maxabs`` [K, 2] and
    ``log2n``, at that external scale. Counts nothing."""
    K, N = node_q.shape
    n_chunks = -(-k_nodes // chunk_nodes)
    dev = node_q.device
    entries = torch.empty(K, N, 2, dtype=torch.int32, device=dev)
    q = torch.empty(K, N, 2, dtype=torch.int64, device=dev)
    offsets = torch.empty(K, n_chunks + 1, dtype=torch.int32, device=dev)
    external = maxabs is not None
    m = maxabs if external else torch.empty(K, 2, dtype=torch.float32, device=dev)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mallorn_hist_group_rows(node_q.data_ptr(), gh.data_ptr(), entries.data_ptr(),
                                         q.data_ptr(), offsets.data_ptr(), m.data_ptr(), K, N,
                                         k_nodes, chunk_nodes, int(external), log2n, stream)
    cuda_build.check(rc, "mallorn_hist_group_rows")
    return GroupedRows(entries, q, offsets, m)


def launch_wide_kernel(binned: torch.Tensor, grouped: GroupedRows, out: torch.Tensor,
                       k_nodes: int, n_bins_tot: int, chunk_nodes: int, group: int,
                       log2n: Optional[int] = None, slots: int = WIDE_NODE_SLOTS) -> None:
    """One launch of the wide path's histogram kernel on checked inputs and
    the prep's ``grouped`` rows at ``chunk_nodes``: the chunk kernel, or
    beyond WIDE_NODE_FROM_BINS bins a node the per-node kernel with
    ``slots`` slots (``wide_node_plan``); float32 ``out`` at the folds' own
    scale, or, given ``log2n`` (the prep's), the int64 sums at the external
    scale of ``grouped.maxabs``. Counts nothing."""
    K, F, N = binned.shape
    window = 0
    if n_bins_tot > WIDE_NODE_FROM_BINS:
        window = wide_node_plan(n_bins_tot, slots)[2]
    lib = cuda_build.load()
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = lib.mallorn_hist_wide(binned.data_ptr(), grouped.entries.data_ptr(),
                                   grouped.q.data_ptr(), grouped.offsets.data_ptr(),
                                   grouped.maxabs.data_ptr(), out.data_ptr(), K, F, N, k_nodes,
                                   n_bins_tot, chunk_nodes, group, slots, window,
                                   int(log2n is not None), log2n or 0, stream)
    cuda_build.check(rc, "mallorn_hist_wide")


# ---------------------------------------------------------------------------
# K3: segment histograms of the leaf-wise fit
# ---------------------------------------------------------------------------
# Counterpart of ``mallorn_tpu/ops/hist_pallas.py:build_histograms_pallas``
# (Pallas body ``_hist_kernel``) with a leading lane axis. For lane k,
# feature f and segment s < ``n_seg``::
#
#     out[k, f, s, :] = sum_r [seg_base[k, r] + binned[k, f, r] == s] gh[k, r, :]
#
# ``seg_base`` is a row's node times ``n_bins_tot`` (the ids the JAX
# package's ``_build_level_hist`` composes); a row whose ``seg_base`` is
# outside ``[0, n_seg)``, or whose bin is negative, is inactive. The three
# versions mirror K1's: the wrapper, ``index_add_`` in gh's dtype, and the
# kernel's fixed point (``build_seg_histograms_fixed``, equal to the
# kernel bit for bit at any layout: integer sums do not depend on order).
# The kernel is K1's (the group kernel above) with K3's rule for which
# (row, feature) counts.


def _check_seg_shapes(binned, seg_base, gh):
    if binned.dim() != 3 or seg_base.dim() != 2 or gh.dim() != 3 or gh.shape[2] != 2:
        raise ValueError(f"expected binned [K, F, N], seg_base [K, N], gh [K, N, 2]; got "
                         f"{tuple(binned.shape)}, {tuple(seg_base.shape)}, {tuple(gh.shape)}")
    K, _, N = binned.shape
    if tuple(seg_base.shape) != (K, N) or tuple(gh.shape[:2]) != (K, N):
        raise ValueError("binned, seg_base and gh disagree on lanes or rows")


def build_seg_histograms_plain(binned: torch.Tensor, seg_base: torch.Tensor,
                               gh: torch.Tensor, n_seg: int) -> torch.Tensor:
    """[K, F, n_seg, 2] segment sums in ``gh``'s dtype, added row by row in
    row order per (lane, feature) (the order of the JAX package's
    ``segment_sum`` on the CPU)."""
    _check_seg_shapes(binned, seg_base, gh)
    K, F, N = binned.shape
    dev = gh.device
    sb = seg_base.long()
    base_ok = (sb >= 0) & (sb < n_seg)
    lane = torch.arange(K, device=dev)[:, None] * n_seg
    vals = gh.reshape(K * N, 2)
    out = torch.zeros(F, K * n_seg + 1, 2, dtype=gh.dtype, device=dev)
    for f in range(F):
        b = binned[:, f, :].long()
        seg = sb + b
        ok = base_ok & (b >= 0) & (seg < n_seg)
        out[f].index_add_(0, torch.where(ok, lane + seg, K * n_seg).reshape(-1), vals)
    return out[:, :-1].reshape(F, K, n_seg, 2).transpose(0, 1).contiguous()


def build_seg_histograms_fixed(binned: torch.Tensor, seg_base: torch.Tensor,
                               gh: torch.Tensor, n_seg: int) -> torch.Tensor:
    """K3's int64 fixed-point arithmetic in plain PyTorch (as
    ``build_histograms_fixed``): equal to the kernel bit for bit."""
    _check_seg_shapes(binned, seg_base, gh)
    q, scale, finite = _fixed_point(gh)
    return _from_fixed(build_seg_histograms_plain(binned, seg_base, q, n_seg), scale, finite)


def build_seg_histograms_i64_fixed(binned: torch.Tensor, seg_base: torch.Tensor,
                                   gh: torch.Tensor, n_seg: int, maxabs: torch.Tensor,
                                   n_rows: int) -> torch.Tensor:
    """K3's int64 fixed-point sums [K, F, n_seg, 2] in plain PyTorch at the
    scale of ``maxabs`` and ``n_rows`` (as ``build_histograms_i64_fixed``):
    equal to ``build_seg_histograms_i64`` bit for bit."""
    _check_seg_shapes(binned, seg_base, gh)
    q, _, _ = _fixed_point(gh, maxabs, n_rows)
    return build_seg_histograms_plain(binned, seg_base, q, n_seg)


def _check_seg_cuda_inputs(name: str, binned, seg_base, gh) -> None:
    """What K3 takes: CUDA tensors on one device, int16 bins, int32
    segment bases, float32 (g, h), contiguous."""
    if binned.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {binned.device}")
    _check_seg_shapes(binned, seg_base, gh)
    if (binned.dtype, seg_base.dtype, gh.dtype) != (torch.int16, torch.int32, torch.float32):
        raise TypeError(f"{name}: expected int16 bins, int32 segment bases "
                        f"and float32 (g, h); got {binned.dtype}, {seg_base.dtype}, {gh.dtype}")
    if not (binned.is_contiguous() and seg_base.is_contiguous() and gh.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if not (seg_base.device == gh.device == binned.device):
        raise ValueError(f"{name}: inputs on different devices")


def launch_seg_kernel(binned: torch.Tensor, seg_base: torch.Tensor, gh: torch.Tensor,
                      out: torch.Tensor, n_seg: int, maxabs: Optional[torch.Tensor] = None,
                      log2n: int = 0) -> None:
    """One launch of K3 on inputs the wrapper checked, at
    ``seg_hist_plan(n_seg)``; writes ``out`` [K, F, n_seg, 2]: float32,
    or int64 at the external scale of ``maxabs`` and ``log2n`` (as
    ``launch_hist_kernel``). Counts nothing."""
    K, F, N = binned.shape
    _, window, group, rows, _ = seg_hist_plan(n_seg)
    lib = cuda_build.load()
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = lib.mallorn_seg_hist(binned.data_ptr(), seg_base.data_ptr(), gh.data_ptr(),
                                  out.data_ptr(), K, F, N, n_seg, window, group, rows,
                                  None if maxabs is None else maxabs.data_ptr(), log2n, stream)
    cuda_build.check(rc, "mallorn_seg_hist")


def build_seg_histograms(binned: torch.Tensor, seg_base: torch.Tensor, gh: torch.Tensor,
                         n_seg: int) -> torch.Tensor:
    """[K, F, n_seg, 2] float32 (grad, hess) segment sums from int16 bins
    [K, F, N], int32 segment bases [K, N] and float32 (g, h) [K, N, 2]."""
    global seg_launches
    if binned.device.type == "cpu":
        return build_seg_histograms_plain(binned, seg_base, gh, n_seg)
    _check_seg_cuda_inputs("build_seg_histograms", binned, seg_base, gh)
    windows = seg_hist_plan(n_seg)[0]  # refuses n_seg beyond SEG_MAX_TOTAL
    K, F, _ = binned.shape
    out = torch.empty(K, F, n_seg, 2, dtype=torch.float32, device=binned.device)
    if K == 0 or F == 0:
        return out
    launch_seg_kernel(binned, seg_base, gh, out, n_seg)
    seg_launches += 1
    _note_windows("seg_launches", windows)
    return out


def build_seg_histograms_i64(binned: torch.Tensor, seg_base: torch.Tensor, gh: torch.Tensor,
                             n_seg: int, maxabs: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K3's external-scale entry: the int64 fixed-point segment sums
    [K, F, n_seg, 2] of these rows at the scale of ``maxabs`` [K, 2] and
    ``n_rows`` (as ``build_histograms_i64``). A CPU tensor runs the plain
    twin ``build_seg_histograms_i64_fixed``."""
    global seg_i64_launches
    if binned.device.type == "cpu":
        return build_seg_histograms_i64_fixed(binned, seg_base, gh, n_seg, maxabs, n_rows)
    _check_seg_cuda_inputs("build_seg_histograms_i64", binned, seg_base, gh)
    log2n = _check_external("build_seg_histograms_i64", gh, maxabs, n_rows)
    windows = seg_hist_plan(n_seg)[0]
    K, F, _ = binned.shape
    out = torch.empty(K, F, n_seg, 2, dtype=torch.int64, device=binned.device)
    if K == 0 or F == 0:
        return out
    launch_seg_kernel(binned, seg_base, gh, out, n_seg, maxabs, log2n)
    seg_i64_launches += 1
    _note_windows("seg_i64_launches", windows)
    return out


# ---------------------------------------------------------------------------
# K4 / K5: the depthwise fit's histogram modes (GBDTParams.hist_dtype)
# ---------------------------------------------------------------------------
# K1's contract, with (g, h) entering as digits:
#
# - K4 (``hist_dtype`` "bf16" / "i8bf16"; counterpart of
#   ``hist_pallas.build_histograms_binlane``, Pallas body
#   ``_binlane_kernel``): three bf16 digits each of g and h
#   (``split_gh_digits``), a sum per digit, each channel (S d0 + S d1) + S d2
#   in float32. The JAX package's "bf16" and "i8bf16" differ only in how the
#   TPU streams the one-hot, and give equal outputs; here they are one
#   kernel.
# - K5 (``hist_dtype`` "int8"; counterpart of
#   ``hist_pallas.build_histograms_binlane_i8``, Pallas body
#   ``_binlane_kernel_i8``): per fold and channel, q = round(x / s 2^26)
#   with s = max |x| over the fold's rows, as 4 balanced base-128 int8
#   digits (``quantize_gh_i8``); exact integer sums per digit, recombined
#   in float32 as P0 + 128 P1 + 128^2 P2 + 128^3 P3 (added in that order,
#   XLA:CPU's order for the JAX package's einsum) times s / 2^26. A cell is
#   within N s 2^-27 of the exact sum (``hist_pallas.py:317-329``).
#
# The kernel (``csrc/hist.cu`` ``mode_hist_kernel``) is K1's first
# design: one CTA per (fold, feature, group of <= 8 nodes) adds each active
# row's digits into a shared-memory integer histogram (K5: the 8 digits as
# int32, 65,792 B at 8 nodes x 257 bins; K4: the 6 digits in K1's int64
# fixed point with a per-fold scale per digit, 98,688 B, each int64 sum two
# 32-bit words added with native atomics and a carry, as K1 adds its two)
# and its epilogue writes
# the float32 (g, h) histograms: K5's recombination in the order above,
# K4's one conversion per digit sum, then (S0 + S1) + S2. Integer sums are
# exact, so two launches agree bit for bit.
#
# The digits enter as the TPU kernels take them: row-major ([K, N, 8] int8
# or [K, N, 6] bf16) with their scales (``ModeDigits``), prepared once a
# tree, as the JAX package's ``_binlane_for`` prepares them once a round
# (``mallorn_tpu/trees/gbdt.py:844``): a tree's (g, h) are fixed across its
# levels, so each level's launch takes the same digits. A fit calls
# ``prepare_digits`` before a tree's levels (one launch of the prep kernel,
# ``csrc/hist.cu`` ``digit_prep_kernel``, counted in
# ``digit_prep_launches``; its plain version is ``launch_inputs``) and
# ``mode_hist`` at each level (``launch_mode_kernel``, the launch alone).
# The (g, h) entries (``build_histograms_bf16``, ``build_histograms_i8``
# and their external-scale twins) prepare and launch in one call.
#
# The external-scale entries serve a fit whose rows are split over ranks
# (``parallel.sharded_train``), as K1's ``build_histograms_i64`` does: one
# scale for every rank's rows, raw integer sums, an all-reduce, one
# conversion (``mode_hist`` given ``n_rows``, on digits prepared at that
# scale). K5's ``build_histograms_i8_sums`` quantizes (g, h) at the s of
# every rank's rows (``amax``: ``x.abs().amax`` over them, which the ranks
# reach by max-reducing ``amax_parts`` and decoding with ``amax_of``) and
# returns the int32 digit sums [K, F, k_nodes, n_bins_tot, 8] (at most 2^25
# global rows); ``from_i8_sums`` recombines them. K4's
# ``build_histograms_bf16_i64`` takes every rank's max |digit| [K, 6]
# (``digit_maxabs``, a non-finite lane +inf) and the global row count and
# returns the int64 sums [.., 6]; ``from_bf16_sums`` converts each digit
# channel once and adds (S0 + S1) + S2. Their plain twins,
# ``build_histograms_i8_sums_fixed`` and ``build_histograms_bf16_i64_fixed``,
# equal them bit for bit; counters ``i8_sums_launches`` and
# ``bf16_i64_launches``.
#
# Plain versions: K5's (``build_histograms_i8_plain``, ``index_add_`` of
# the digits, ``_recombine_i8``) is bit for bit the kernel's and the JAX
# package's. K4 has two: ``build_histograms_bf16_plain`` (float32
# ``index_add_`` per digit, what a CPU tensor runs, held with the JAX
# package's binlane path on the CPU) and ``build_histograms_bf16_fixed``
# (the kernel's fixed-point arithmetic, equal to the kernel bit for bit);
# both within the JAX package's histogram bar of the float64 oracle
# ``build_histograms_plain(..., gh.double())``.

Q_BITS = 26  # hist_pallas._Q_BITS
MODE_NODES = 8  # nodes per CTA of the mode kernel at most (grid z takes the rest)
MODE_CELL_BYTES = {False: 6 * 8, True: 8 * 4}  # per (node, bin): K4, K5
# K5's external entry sums digits (|digit| <= 64) in int32: exact up to
# 2^25 global rows (csrc/hist.cu kMaxLog2RowsI8)
I8_SUMS_MAX_LOG2_ROWS = 25


def split_gh_digits(gh: torch.Tensor) -> torch.Tensor:
    """[K, N, 6] bf16: three digits of g, then of h
    (``hist_pallas.split_gh_digits``): d0 = bf16(x), r = x - d0,
    d1 = bf16(r), d2 = bf16(r - d1); each cast rounds to nearest even and
    each difference is a float32 subtraction."""
    x = gh.float()
    d0 = x.to(torch.bfloat16)
    r = x - d0.float()
    d1 = r.to(torch.bfloat16)
    d2 = (r - d1.float()).to(torch.bfloat16)
    return torch.stack([d0, d1, d2], dim=-1).reshape(*gh.shape[:2], 6)


def digit_maxabs(gh: torch.Tensor) -> torch.Tensor:
    """[K, 6] float32 max |digit| of (g, h) [K, N, 2]'s bf16 digits per lane
    and channel, +inf in every channel of a lane with a non-finite digit
    (``lane_maxabs``): what K4's external entry takes, max-reduced over
    ranks."""
    return lane_maxabs(split_gh_digits(gh).float())


def amax_parts(gh: torch.Tensor) -> torch.Tensor:
    """[K, 2 C] float32 of [K, N, C] values: per lane and channel the max
    |x| over its finite values, then a code, 2 where the channel holds a
    NaN, 1 an infinity, else 0. The elementwise max of two ranks' parts is
    the parts of their rows together, and ``amax_of`` turns them into
    ``x.abs().amax(dim=1)`` NaN and inf included (a max-reduce of NaN
    itself does not agree across backends)."""
    x = gh.float()
    K, N, C = x.shape
    if not N:
        return torch.zeros(K, 2 * C, dtype=torch.float32, device=x.device)
    fin = torch.isfinite(x)
    m = torch.where(fin, x.abs(), 0.0).amax(dim=1)
    code = torch.where(torch.isnan(x).any(dim=1), 2.0, (~fin).any(dim=1).float())
    return torch.cat([m, code], dim=1).contiguous()


def amax_of(parts: torch.Tensor) -> torch.Tensor:
    """[K, C] float32 max |x| of ``amax_parts``' [K, 2 C] (or their
    max-reduce): NaN where a value was NaN, else +inf where one was
    infinite."""
    C = parts.shape[1] // 2
    m, code = parts[:, :C], parts[:, C:]
    return torch.where(code == 2.0, torch.nan,
                       torch.where(code == 1.0, torch.inf, m)).contiguous()


def quantize_gh_i8(gh: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """(digits [K, N, 8] int8, scale [K, 2] float32) of float32 (g, h)
    [K, N, 2] (``hist_pallas.quantize_gh_i8`` per fold): s = max(max |x|,
    1e-30) over the fold's rows (``amax`` [K, 2]: over every rank's rows),
    q = round_half_even(x / s * 2^26) (a true division), balanced base-128
    digits d0..d2 in [-64, 64] and the rest d3 (|d3| <= 32): g's four
    digits, then h's."""
    x = gh.float()
    K, N, _ = x.shape
    if amax is None:
        amax = x.abs().amax(dim=1) if N else torch.zeros(K, 2, device=x.device)
    s = torch.clamp(amax.to(x.device), min=1e-30)
    q = torch.round(x / s[:, None, :] * float(2 ** Q_BITS)).to(torch.int32)
    # q + 64 (1 + 128 + 128^2) = sum_{j<3} (d_j + 64) 128^j + d3 128^3, so
    # the balanced digits are shifts and masks of one offset integer: the
    # digits of the JAX package's loop d = ((r + 64) & 127) - 64,
    # r = (r - d) >> 7, in half the ops
    u = q + 64 * (1 + 128 + 128 ** 2)
    shifts = torch.arange(0, 21, 7, dtype=torch.int32, device=x.device)
    low = ((u[..., None] >> shifts) & 127) - 64
    digits = torch.cat([low, (u >> 21)[..., None]], dim=-1)
    return digits.reshape(K, N, 8).to(torch.int8), s


def _recombine_i8(P: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Integer digit sums [K, F, C, 8, B] -> float32 (g, h) [K, F, C, B, 2]:
    per channel ((P0 + 128 P1) + 128^2 P2) + 128^3 P3 in float32 (each
    product exact), times s / 2^26."""
    p = P.float()
    s = (scale / float(2 ** Q_BITS)).reshape(-1, 1, 1, 1, 2)

    def channel(o):
        return ((p[:, :, :, o] + p[:, :, :, o + 1] * 128.0) + p[:, :, :, o + 2] * 16384.0) \
            + p[:, :, :, o + 3] * 2097152.0

    return torch.stack([channel(0), channel(4)], dim=-1) * s


class ModeDigits(NamedTuple):
    """K4 / K5's inputs of one tree, prepared once from its float32 (g, h)
    [K, N, 2] (``prepare_digits``) and taken by every level's launch."""
    digits: torch.Tensor  # [K, N, 8] int8 (K5) or [K, N, 6] bf16 (K4), row-major
    scale: torch.Tensor  # [K, 2] float32 s (K5) or [K, 6] float32 max |digit| (K4)


def launch_inputs(int8: bool, gh: torch.Tensor,
                  maxabs: Optional[torch.Tensor] = None) -> ModeDigits:
    """The prep kernel's plain version: K5 (``int8``) ``quantize_gh_i8``'s
    [K, N, 8] int8 digits and [K, 2] scales s; K4 ``split_gh_digits``'
    [K, N, 6] bf16 digits and their [K, 6] float32 max |digit| per lane and
    channel (``lane_maxabs``: +inf in every channel of a lane with a
    non-finite digit). ``maxabs``, a mesh's global scale: K5's ``amax``
    [K, 2] (the digits at its s), K4's [K, 6] maxima (returned as the
    scale)."""
    if int8:
        return ModeDigits(*quantize_gh_i8(gh, maxabs))
    digits = split_gh_digits(gh)
    return ModeDigits(digits, lane_maxabs(digits.float()) if maxabs is None else maxabs)


def mode_hist_plain(binned: torch.Tensor, node_q: torch.Tensor, dg: ModeDigits, k_nodes: int,
                    n_bins_tot: int, n_rows: Optional[int] = None) -> torch.Tensor:
    """``mode_hist`` in plain PyTorch on prepared digits. K5 (int8 digits):
    int64 ``index_add_`` sums of the 8 digit columns, recombined in float32
    (bit for bit the kernel's and the JAX package's
    ``build_histograms_binlane_i8``), or given ``n_rows`` the int32 digit
    sums. K4 (bf16 digits): three float32 ``index_add_`` histograms, one per
    digit, summed (S0 + S1) + S2 (within the JAX package's histogram bar of
    the kernel's fixed point; ``build_histograms_bf16_fixed`` is that
    arithmetic), or given ``n_rows`` the int64 fixed-point digit sums at the
    scale of ``dg.scale`` and ``n_rows`` (the kernel's bit for bit)."""
    if dg.digits.dtype == torch.int8:
        P = _segment_sums(binned, node_q, dg.digits.long(), k_nodes, n_bins_tot)
        if n_rows is not None:
            return P.to(torch.int32)
        return _recombine_i8(P.transpose(3, 4), dg.scale)
    d = dg.digits.float()
    if n_rows is not None:
        q, _, _ = _fixed_point(d, dg.scale, n_rows)
        return _segment_sums(binned, node_q, q, k_nodes, n_bins_tot)
    S = [_segment_sums(binned, node_q, d[..., [i, 3 + i]], k_nodes, n_bins_tot) for i in range(3)]
    return (S[0] + S[1]) + S[2]


def build_histograms_i8_plain(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                              k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """K5's arithmetic in plain PyTorch from (g, h): the digits
    (``launch_inputs``), then ``mode_hist_plain``. Bit for bit the kernel's,
    and the JAX package's ``build_histograms_binlane_i8``."""
    _check_shapes(binned, node_q, gh)
    return mode_hist_plain(binned, node_q, launch_inputs(True, gh), k_nodes, n_bins_tot)


def build_histograms_i8_sums_fixed(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                                   k_nodes: int, n_bins_tot: int, amax: torch.Tensor,
                                   n_rows: int) -> torch.Tensor:
    """K5's digit sums [K, F, k_nodes, n_bins_tot, 8] int32 in plain
    PyTorch: the digits at s = max(``amax``, 1e-30) (``amax`` [K, 2] the
    max |x| of every rank's rows, ``amax_of``), ``index_add_`` sums of the
    8 digit columns. Equal to ``build_histograms_i8_sums`` bit for bit; at
    most 2^25 global rows (``n_rows``)."""
    _check_shapes(binned, node_q, gh)
    _check_external("build_histograms_i8_sums_fixed", gh, amax, n_rows, 2,
                    I8_SUMS_MAX_LOG2_ROWS)
    return mode_hist_plain(binned, node_q, launch_inputs(True, gh, amax), k_nodes, n_bins_tot,
                           n_rows)


def from_i8_sums(P: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """K5's digit sums [K, F, k_nodes, n_bins_tot, 8] (or their all-reduced
    total) -> float32 (g, h) [K, F, k_nodes, n_bins_tot, 2] at s = max(
    ``amax``, 1e-30): the kernel's recombination, once."""
    return _recombine_i8(P.transpose(3, 4), torch.clamp(amax.to(P.device), min=1e-30))


def build_histograms_bf16_plain(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                                k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """K4's arithmetic in plain PyTorch with float32 sums from (g, h): the
    digits (``launch_inputs``), then ``mode_hist_plain``'s three float32
    ``index_add_`` histograms (one per digit), summed (S0 + S1) + S2."""
    _check_shapes(binned, node_q, gh)
    return mode_hist_plain(binned, node_q, launch_inputs(False, gh), k_nodes, n_bins_tot)


def bf16_digit_sums_fixed(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                          k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """[K, F, k_nodes, n_bins_tot, 6] float32 sums of the six bf16 digits
    (g's d0, d1, d2, then h's) in the kernel's fixed point: per fold and
    digit channel S = 2^(62 - ceil(log2 N) - e) with max |digit| < 2^e,
    int64 sums of round(digit * S), one conversion each; NaN in every cell
    of a fold whose digits are not finite."""
    _check_shapes(binned, node_q, gh)
    q, scale, finite = _fixed_point(split_gh_digits(gh).float())
    return _from_fixed(_segment_sums(binned, node_q, q, k_nodes, n_bins_tot), scale, finite)


def _sum_digits(S: torch.Tensor) -> torch.Tensor:
    """(S0 + S1) + S2 per channel in float32: [.., 6] -> [.., 2]."""
    return torch.stack([(S[..., 3 * c] + S[..., 3 * c + 1]) + S[..., 3 * c + 2]
                        for c in range(2)], dim=-1)


def build_histograms_bf16_fixed(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                                k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """K4's kernel arithmetic in plain PyTorch (``bf16_digit_sums_fixed``,
    then (S0 + S1) + S2 per channel in float32): equal to the kernel bit
    for bit."""
    return _sum_digits(bf16_digit_sums_fixed(binned, node_q, gh, k_nodes, n_bins_tot))


def build_histograms_bf16_i64_fixed(binned: torch.Tensor, node_q: torch.Tensor,
                                    gh: torch.Tensor, k_nodes: int, n_bins_tot: int,
                                    maxabs: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K4's int64 fixed-point digit sums [K, F, k_nodes, n_bins_tot, 6] in
    plain PyTorch at the scale of ``maxabs`` [K, 6] (every rank's max
    |digit|, ``digit_maxabs``) and ``n_rows``, zeros in a lane that is not
    finite: equal to ``build_histograms_bf16_i64`` bit for bit."""
    _check_shapes(binned, node_q, gh)
    _check_external("build_histograms_bf16_i64_fixed", gh, maxabs, n_rows, 6)
    return mode_hist_plain(binned, node_q, launch_inputs(False, gh, maxabs), k_nodes, n_bins_tot,
                           n_rows)


def from_bf16_sums(acc: torch.Tensor, maxabs: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K4's int64 digit sums [K, F, k_nodes, n_bins_tot, 6] (or their
    all-reduced total) -> float32 (g, h) [.., 2]: each digit channel
    converted once at the scale of ``maxabs`` and ``n_rows``, then
    (S0 + S1) + S2, the kernel's epilogue; NaN (0x7fc00000, the kernel's)
    in every cell of a lane that is not finite."""
    scale, finite = fixed_scale(maxabs.to(acc.device), n_rows)
    out = _sum_digits(_from_fixed(acc, scale, finite))
    return torch.where(finite.reshape(-1, *(1,) * (out.dim() - 1)), out, torch.nan)


def mode_plan(k_nodes: int, n_bins_tot: int, int8: bool):
    """(nodes per CTA G, windows, bins per window, shared-memory bytes) of
    the mode kernel (K5 if ``int8``, else K4) at a level of ``k_nodes``
    nodes of ``n_bins_tot`` bins: G the most of 1 to MODE_NODES nodes (at
    most ``k_nodes``) whose G x n_bins_tot cells fit a CTA, one window of
    all the bins; where one node's cells do not fit (K4 beyond 4,842 bins,
    K5 beyond 7,264), G = 1 and the bins in the fewest equal windows that
    do. Grid z takes ceil(k_nodes / G) x windows CTAs. Raises beyond
    MAX_NODE_BINS bins or MAX_GRID_Z CTAs on z (csrc/hist.cu launch_mode
    refuses the same)."""
    name = f"{'build_histograms_i8' if int8 else 'build_histograms_bf16'} " \
           f"({k_nodes} nodes x {n_bins_tot} bins)"
    if k_nodes < 1 or not 1 <= n_bins_tot <= MAX_NODE_BINS:
        raise ValueError(f"{name}: the kernel takes 1 to {MAX_NODE_BINS} bins a node and at "
                         f"least one node")
    cell = MODE_CELL_BYTES[int8]
    group = min(k_nodes, MODE_NODES)
    while group > 1 and group * n_bins_tot * cell > SMEM_BYTES:
        group -= 1
    windows, window = _windows(n_bins_tot, SMEM_BYTES // cell)
    if -(-k_nodes // group) * windows > MAX_GRID_Z:
        raise ValueError(f"{name}: {-(-k_nodes // group) * windows} CTAs on the grid's z axis "
                         f"exceed {MAX_GRID_Z}")
    return group, windows, window, group * window * cell


def _check_scale(name: str, scale: torch.Tensor, K: int, channels: int, dev) -> None:
    if tuple(scale.shape) != (K, channels) or scale.dtype != torch.float32:
        raise ValueError(f"{name}: the scale must be [K, {channels}] float32, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if scale.device != dev or not scale.is_contiguous():
        raise ValueError(f"{name}: the scale must be contiguous on {dev}")


def launch_digit_prep(int8: bool, gh: torch.Tensor,
                      maxabs: Optional[torch.Tensor] = None) -> ModeDigits:
    """One launch of the prep kernel (csrc/hist.cu ``digit_prep_kernel``) on
    checked CUDA inputs: ``launch_inputs``' digits and scale, bit for bit
    that plain version run on the card (K4 given ``maxabs`` returns it as
    the scale). Counts nothing."""
    K, N, _ = gh.shape
    dev = gh.device
    digits = torch.empty(K, N, 8 if int8 else 6, dtype=torch.int8 if int8 else torch.bfloat16,
                         device=dev)
    external = maxabs is not None
    written = int8 or not external  # K4 given its maxima writes no scale
    scale = torch.empty(K, 2 if int8 else 6, dtype=torch.float32, device=dev) if written else maxabs
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mallorn_digit_prep(gh.data_ptr(), digits.data_ptr(),
                                    scale.data_ptr() if written else None,
                                    maxabs.data_ptr() if external else None, K, N, int(int8),
                                    stream)
    cuda_build.check(rc, "mallorn_digit_prep")
    return ModeDigits(digits, scale)


def prepare_digits(int8: bool, gh: torch.Tensor,
                   maxabs: Optional[torch.Tensor] = None) -> ModeDigits:
    """K5's (``int8``) or K4's digits and scales of float32 (g, h) [K, N, 2],
    made once a tree: a depthwise fit calls it before a tree's levels
    (``trees.gbdt.LevelHist``), as the JAX package's ``_binlane_for`` does
    once a round. A CUDA tensor takes one launch of the prep kernel
    (``launch_digit_prep``, counted in ``digit_prep_launches``), a CPU
    tensor its plain version ``launch_inputs``. ``maxabs``: a mesh's global
    scale, K5's ``amax`` [K, 2] (every rank's max |x|, ``amax_of``) or K4's
    [K, 6] maxima (every rank's, ``digit_maxabs``)."""
    global digit_prep_launches
    if gh.device.type == "cpu":
        return launch_inputs(int8, gh, maxabs)
    name = "prepare_digits"
    if gh.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {gh.device}")
    if gh.dim() != 3 or gh.shape[2] != 2 or gh.dtype != torch.float32 or not gh.is_contiguous():
        raise ValueError(f"{name}: expected contiguous float32 (g, h) [K, N, 2], got "
                         f"{tuple(gh.shape)} {gh.dtype}")
    if maxabs is not None:
        _check_scale(name, maxabs, gh.shape[0], 2 if int8 else 6, gh.device)
    out = launch_digit_prep(int8, gh, maxabs)
    digit_prep_launches += 1
    return out


def _check_mode_inputs(name: str, binned, node_q, dg: ModeDigits) -> bool:
    """What the mode kernel takes: CUDA tensors on one device, int16 bins
    [K, F, N], int32 node ids [K, N], ``prepare_digits``' digits and scale,
    contiguous. Returns whether the digits are K5's (int8)."""
    if binned.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {binned.device}")
    int8 = dg.digits.dtype == torch.int8
    if binned.dim() != 3 or node_q.dim() != 2 or dg.digits.dim() != 3:
        raise ValueError(f"{name}: expected binned [K, F, N], node_q [K, N], digits [K, N, C]; got "
                         f"{tuple(binned.shape)}, {tuple(node_q.shape)}, {tuple(dg.digits.shape)}")
    K, _, N = binned.shape
    want = (torch.int8, 8) if int8 else (torch.bfloat16, 6)
    if (dg.digits.dtype, dg.digits.shape[2]) != want:
        raise TypeError(f"{name}: digits must be [K, N, 8] int8 or [K, N, 6] bf16, got "
                        f"{tuple(dg.digits.shape)} {dg.digits.dtype}")
    if tuple(node_q.shape) != (K, N) or tuple(dg.digits.shape[:2]) != (K, N):
        raise ValueError(f"{name}: binned, node_q and the digits disagree on folds or rows")
    if (binned.dtype, node_q.dtype) != (torch.int16, torch.int32):
        raise TypeError(f"{name}: expected int16 bins and int32 node ids; got {binned.dtype}, "
                        f"{node_q.dtype}")
    if not (binned.is_contiguous() and node_q.is_contiguous() and dg.digits.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if not (node_q.device == dg.digits.device == binned.device):
        raise ValueError(f"{name}: inputs on different devices")
    _check_scale(name, dg.scale, K, 2 if int8 else 6, binned.device)
    return int8


def launch_mode_kernel(int8: bool, binned: torch.Tensor, node_q: torch.Tensor,
                       digits: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
                       k_nodes: int, n_bins_tot: int, log2n: Optional[int] = None) -> None:
    """One launch of the mode kernel (K5 if ``int8``, else K4) at
    ``mode_plan`` on checked inputs and prepared digits; writes ``out``
    [K, F, k_nodes, n_bins_tot, 2] float32, or, given ``log2n`` (of the
    global row count), the external launch's raw sums (K5 int32 [.., 8], K4
    int64 [.., 6]). Counts nothing."""
    K, F, N = binned.shape
    group, _, window, _ = mode_plan(k_nodes, n_bins_tot, int8)
    fn_name = "mallorn_hist_i8" if int8 else "mallorn_hist_bf16"
    lib = cuda_build.load()
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = getattr(lib, fn_name)(binned.data_ptr(), node_q.data_ptr(), digits.data_ptr(),
                                   scale.data_ptr(), out.data_ptr(), K, F, N, k_nodes,
                                   n_bins_tot, group, window, int(log2n is not None),
                                   log2n or 0, stream)
    cuda_build.check(rc, fn_name)


def mode_hist(binned: torch.Tensor, node_q: torch.Tensor, dg: ModeDigits, k_nodes: int,
              n_bins_tot: int, n_rows: Optional[int] = None) -> torch.Tensor:
    """One level of K5 (``dg``'s digits int8) or K4 (bf16) on a tree's
    prepared digits (``prepare_digits``): [K, F, k_nodes, n_bins_tot, 2]
    float32 (g, h) histograms from int16 bins [K, F, N] and int32 node ids
    [K, N], or, given ``n_rows`` (the global row count of a fit split over
    ranks, the digits prepared at every rank's scale), the raw integer sums
    of these rows (K5 int32 [.., 8], at most 2^25 global rows; K4 int64
    [.., 6], zeros in a lane that is not finite). A CPU tensor runs
    ``mode_hist_plain``."""
    global bf16_launches, i8_launches, bf16_i64_launches, i8_sums_launches
    if binned.device.type == "cpu":
        return mode_hist_plain(binned, node_q, dg, k_nodes, n_bins_tot, n_rows)
    int8 = _check_mode_inputs("mode_hist", binned, node_q, dg)
    external = n_rows is not None
    log2n = None
    if external:
        log2n = _log2_ceil(n_rows)
        if n_rows < binned.shape[2] or log2n > (I8_SUMS_MAX_LOG2_ROWS if int8 else 62):
            raise ValueError(f"mode_hist: n_rows = {n_rows} must count at least this call's "
                             f"{binned.shape[2]} rows and at most "
                             f"2^{I8_SUMS_MAX_LOG2_ROWS if int8 else 62}")
    K, F, _ = binned.shape
    if external:
        channels, dtype = (8, torch.int32) if int8 else (6, torch.int64)
    else:
        channels, dtype = 2, torch.float32
    out = torch.empty(K, F, k_nodes, n_bins_tot, channels, dtype=dtype, device=binned.device)
    if out.numel() == 0:
        return out
    windows = mode_plan(k_nodes, n_bins_tot, int8)[1]  # refuses a level it cannot lay out
    launch_mode_kernel(int8, binned, node_q, dg.digits, dg.scale, out, k_nodes, n_bins_tot, log2n)
    if external and int8:
        i8_sums_launches += 1
        counter = "i8_sums_launches"
    elif external:
        bf16_i64_launches += 1
        counter = "bf16_i64_launches"
    elif int8:
        i8_launches += 1
        counter = "i8_launches"
    else:
        bf16_launches += 1
        counter = "bf16_launches"
    _note_windows(counter, windows)
    return out


def build_histograms_bf16(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                          k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """K4 from (g, h): [K, F, k_nodes, n_bins_tot, 2] float32 (grad, hess)
    histograms summed as bf16 digits, from int16 bins [K, F, N], int32 node
    ids [K, N] and float32 (g, h) [K, N, 2]: the digits prepared
    (``prepare_digits``), then one level (``mode_hist``). A fit prepares
    once a tree instead (``trees.gbdt.HIST_DTYPE_FNS``)."""
    if binned.device.type == "cpu":
        return build_histograms_bf16_plain(binned, node_q, gh, k_nodes, n_bins_tot)
    return mode_hist(binned, node_q, prepare_digits(False, gh), k_nodes, n_bins_tot)


def build_histograms_i8(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                        k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """K5 from (g, h): [K, F, k_nodes, n_bins_tot, 2] float32 (grad, hess)
    histograms of the int8 fixed-point digits, from int16 bins [K, F, N],
    int32 node ids [K, N] and float32 (g, h) [K, N, 2]: the digits prepared
    (``prepare_digits``), then one level (``mode_hist``)."""
    if binned.device.type == "cpu":
        return build_histograms_i8_plain(binned, node_q, gh, k_nodes, n_bins_tot)
    return mode_hist(binned, node_q, prepare_digits(True, gh), k_nodes, n_bins_tot)


def build_histograms_bf16_i64(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                              k_nodes: int, n_bins_tot: int, maxabs: torch.Tensor,
                              n_rows: int) -> torch.Tensor:
    """K4's external-scale entry from (g, h): the int64 fixed-point sums of
    the six bf16 digits [K, F, k_nodes, n_bins_tot, 6] of these rows, each
    digit channel at the scale of ``maxabs`` [K, 6] float32 (every rank's
    max |digit| per lane, +inf where not finite; ``digit_maxabs``) and
    ``n_rows`` (the global row count). Zeros in a lane that is not finite.
    A CPU tensor runs the plain twin ``build_histograms_bf16_i64_fixed``."""
    if binned.device.type == "cpu":
        return build_histograms_bf16_i64_fixed(binned, node_q, gh, k_nodes, n_bins_tot,
                                               maxabs, n_rows)
    _check_external("build_histograms_bf16_i64", gh, maxabs, n_rows, 6)
    return mode_hist(binned, node_q, prepare_digits(False, gh, maxabs), k_nodes, n_bins_tot,
                     n_rows)


def build_histograms_i8_sums(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                             k_nodes: int, n_bins_tot: int, amax: torch.Tensor,
                             n_rows: int) -> torch.Tensor:
    """K5's external-scale entry from (g, h): the int32 sums of the eight
    int8 digits [K, F, k_nodes, n_bins_tot, 8] of these rows, quantized at
    s = max(``amax``, 1e-30) (``amax`` [K, 2] float32, the max |x| of every
    rank's rows, NaN and inf as ``x.abs().amax`` gives them; ``amax_of``),
    for ``n_rows`` <= 2^25 global rows. A CPU tensor runs the plain twin
    ``build_histograms_i8_sums_fixed``."""
    if binned.device.type == "cpu":
        return build_histograms_i8_sums_fixed(binned, node_q, gh, k_nodes, n_bins_tot, amax,
                                              n_rows)
    _check_external("build_histograms_i8_sums", gh, amax, n_rows, 2, I8_SUMS_MAX_LOG2_ROWS)
    return mode_hist(binned, node_q, prepare_digits(True, gh, amax), k_nodes, n_bins_tot, n_rows)
