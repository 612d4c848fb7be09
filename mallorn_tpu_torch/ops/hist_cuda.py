"""GBDT histograms, batched over folds or lanes: the Hopper kernels and
their plain PyTorch versions.

Four kernels of ``csrc/hist.cu``, all shared-memory integer histograms:
the depthwise level histogram (K1, ``build_histograms``) and the leaf-wise
segment histogram (K3, ``build_seg_histograms``), one kernel template,
and the depthwise fit's two histogram modes (K4, ``build_histograms_bf16``,
and K5, ``build_histograms_i8``, one kernel template;
``GBDTParams.hist_dtype``), each in its own section below.

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
  ``bf16_launches`` K4's and ``i8_launches`` K5's, ``i64_launches`` and
  ``seg_i64_launches`` the external-scale entries' (plain calls do not
  count).

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
scale, converted).

K1 and K3 run one kernel, ``csrc/hist.cu`` ``group_hist_kernel`` (its note
says more): K1's output is K3's with n_seg = k_nodes n_bins_tot and a
row's segment base its node times n_bins_tot, and the two differ only in
which (row, feature) counts. One CTA takes a fold and a group of G
features, finds the fold's scale itself (max |g|, max |h| and a
non-finite flag), stages the rows in tiles with asynchronous copies,
compacts each tile's active rows once, computes q once per row and adds it
into its G histograms as pairs of 32-bit atomics. G and the tile come from
the shape: ``hist_layout`` (K1, by level) and ``seg_hist_layout`` (K3).
A K1 level wider than one CTA's histograms hold (54 nodes at 257 bins) is
split into chunks of nodes over the grid's z axis (``hist_plan``).
The wrappers allocate ``out`` and launch, nothing else; ``launch_hist_kernel``
and ``launch_seg_kernel`` are the launches alone, of either scale (the
external one given ``maxabs`` and ``log2n``: one C entry per kernel,
``mallorn_hist`` / ``mallorn_seg_hist``, with a nullable ``maxabs``).
"""

from __future__ import annotations

from typing import Optional

import torch

from mallorn_tpu_torch.utils import cuda_build

# the shared memory a CTA may take on an H100. K1 and K3 hold their group's
# histograms, staged row tiles and active list in it (``_group_layout``:
# at most SEG_MAX_SEGMENTS = 14,004 segments, 54 nodes at 257 bins; K1
# splits a wider level into chunks of nodes, ``hist_plan``), K4 / K5 one
# (fold, feature, <= 8 nodes) histogram
SMEM_BYTES = 232448

launches = 0
launches_by_nodes: dict = {}  # K1's launches per k_nodes
seg_launches = 0
bf16_launches = 0
i8_launches = 0
i64_launches = 0  # K1's external-scale entry
seg_i64_launches = 0  # K3's


def reset_launches() -> None:
    global launches, seg_launches, bf16_launches, i8_launches, i64_launches, seg_i64_launches
    launches = seg_launches = bf16_launches = i8_launches = 0
    i64_launches = seg_i64_launches = 0
    launches_by_nodes.clear()


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
    Raises beyond SEG_MAX_SEGMENTS segments (54 nodes at 257 bins); a
    wider level is split into chunks of nodes (``hist_plan``)."""
    levels = sorted(HIST_LAYOUTS)
    level = next((c for c in levels if c >= k_nodes), levels[-1])
    return _group_layout(f"build_histograms ({k_nodes} nodes x {n_bins_tot} bins)",
                         k_nodes * n_bins_tot, *HIST_LAYOUTS[level])


GRID_Z_MAX = 65535  # CUDA's limit on a grid's z extent


def hist_plan(k_nodes: int, n_bins_tot: int):
    """(nodes per CTA, chunks, G, rows per tile, shared-memory bytes) of a
    K1 launch: a level that one CTA holds (at most SEG_MAX_SEGMENTS //
    n_bins_tot nodes, 54 at 257 bins) is one chunk at ``hist_layout``;
    a wider one is split into the fewest equal chunks of at most that many
    nodes (the last may be smaller) on the grid's z axis, each CTA at the
    chunk's ``hist_layout``. Raises where one node's bins exceed a CTA or
    the chunks exceed the grid's z axis."""
    name = f"build_histograms ({k_nodes} nodes x {n_bins_tot} bins)"
    per_cta = SEG_MAX_SEGMENTS // max(int(n_bins_tot), 1)
    if k_nodes < 1 or n_bins_tot < 1 or per_cta < 1:
        raise ValueError(f"{name}: the kernel takes 1 to {SEG_MAX_SEGMENTS} bins a node "
                         f"and at least one node")
    n_chunks = -(-k_nodes // per_cta)
    if n_chunks > GRID_Z_MAX:
        raise ValueError(f"{name}: {n_chunks} chunks of {per_cta} nodes exceed the grid's "
                         f"z axis ({GRID_Z_MAX}); the kernel takes at most "
                         f"{GRID_Z_MAX * per_cta} nodes at {n_bins_tot} bins")
    chunk = -(-k_nodes // n_chunks)
    return (chunk, -(-k_nodes // chunk)) + hist_layout(chunk, n_bins_tot)


def seg_hist_layout(n_seg: int):
    """(features per CTA G, rows per tile, shared-memory bytes) of K3 at
    ``n_seg`` segments: SEG_GROUP and SEG_TILE_ROWS, shrunk as
    ``_group_layout`` does until the CTA fits. Raises beyond
    SEG_MAX_SEGMENTS."""
    return _group_layout("build_seg_histograms", n_seg, SEG_GROUP, SEG_TILE_ROWS)


# ---------------------------------------------------------------------------
# K1: level histograms of the depthwise fit
# ---------------------------------------------------------------------------

def launch_hist_kernel(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                       out: torch.Tensor, k_nodes: int, n_bins_tot: int,
                       maxabs: Optional[torch.Tensor] = None, log2n: int = 0) -> None:
    """One launch of K1 on inputs the wrapper checked, at
    ``hist_plan(k_nodes, n_bins_tot)``; writes ``out`` [K, F, k_nodes,
    n_bins_tot, 2]: float32 at the folds' own scale, or, given ``maxabs``
    [K, 2] and ``log2n``, the int64 sums at that external scale. Counts
    nothing."""
    K, F, N = binned.shape
    chunk, _, group, rows, _ = hist_plan(k_nodes, n_bins_tot)
    lib = cuda_build.load()
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = lib.mallorn_hist(binned.data_ptr(), node_q.data_ptr(), gh.data_ptr(),
                              out.data_ptr(), K, F, N, k_nodes, n_bins_tot, group, rows,
                              chunk, None if maxabs is None else maxabs.data_ptr(), log2n,
                              stream)
    cuda_build.check(rc, "mallorn_hist")


def _check_external(name: str, gh: torch.Tensor, maxabs: torch.Tensor, n_rows: int) -> int:
    """log2 of the global row count of an external-scale call, after
    checking ``maxabs`` [K, 2] float32 on ``gh``'s device and ``n_rows``
    against the rows given."""
    K, N, _ = gh.shape
    if tuple(maxabs.shape) != (K, 2) or maxabs.dtype != torch.float32:
        raise ValueError(f"{name}: maxabs must be [K, 2] float32, got "
                         f"{tuple(maxabs.shape)} {maxabs.dtype}")
    if maxabs.device != gh.device or not maxabs.is_contiguous():
        raise ValueError(f"{name}: maxabs must be contiguous on {gh.device}")
    log2n = _log2_ceil(n_rows)
    if n_rows < N or log2n > 62:
        raise ValueError(f"{name}: n_rows = {n_rows} must count at least this call's {N} "
                         f"rows and at most 2^62")
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
    global i64_launches
    if binned.device.type == "cpu":
        return build_histograms_i64_fixed(binned, node_q, gh, k_nodes, n_bins_tot,
                                          maxabs, n_rows)
    _check_cuda_inputs("build_histograms_i64", binned, node_q, gh)
    log2n = _check_external("build_histograms_i64", gh, maxabs, n_rows)
    hist_plan(k_nodes, n_bins_tot)
    K, F, _ = binned.shape
    out = torch.empty(K, F, k_nodes, n_bins_tot, 2, dtype=torch.int64, device=binned.device)
    if K == 0 or F == 0:
        return out
    launch_hist_kernel(binned, node_q, gh, out, k_nodes, n_bins_tot, maxabs, log2n)
    i64_launches += 1
    return out


def build_histograms(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                     k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """[K, F, k_nodes, n_bins_tot, 2] float32 (grad, hess) histograms from
    int16 bins [K, F, N], int32 node ids [K, N] and float32 (g, h) [K, N, 2]."""
    global launches
    if binned.device.type == "cpu":
        return build_histograms_plain(binned, node_q, gh, k_nodes, n_bins_tot)
    _check_cuda_inputs("build_histograms", binned, node_q, gh)
    hist_plan(k_nodes, n_bins_tot)  # refuses a level beyond the grid's z axis
    K, F, _ = binned.shape
    out = torch.empty(K, F, k_nodes, n_bins_tot, 2, dtype=torch.float32, device=binned.device)
    if K == 0 or F == 0:
        return out
    launch_hist_kernel(binned, node_q, gh, out, k_nodes, n_bins_tot)
    launches += 1
    launches_by_nodes[k_nodes] = launches_by_nodes.get(k_nodes, 0) + 1
    return out


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
    ``seg_hist_layout(n_seg)``; writes ``out`` [K, F, n_seg, 2]: float32,
    or int64 at the external scale of ``maxabs`` and ``log2n`` (as
    ``launch_hist_kernel``). Counts nothing."""
    K, F, N = binned.shape
    group, rows, _ = seg_hist_layout(n_seg)
    lib = cuda_build.load()
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = lib.mallorn_seg_hist(binned.data_ptr(), seg_base.data_ptr(), gh.data_ptr(),
                                  out.data_ptr(), K, F, N, n_seg, group, rows,
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
    seg_hist_layout(n_seg)  # refuses n_seg beyond the kernel's shared memory
    K, F, _ = binned.shape
    out = torch.empty(K, F, n_seg, 2, dtype=torch.float32, device=binned.device)
    if K == 0 or F == 0:
        return out
    launch_seg_kernel(binned, seg_base, gh, out, n_seg)
    seg_launches += 1
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
    seg_hist_layout(n_seg)
    K, F, _ = binned.shape
    out = torch.empty(K, F, n_seg, 2, dtype=torch.int64, device=binned.device)
    if K == 0 or F == 0:
        return out
    launch_seg_kernel(binned, seg_base, gh, out, n_seg, maxabs, log2n)
    seg_i64_launches += 1
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
# fixed point with a per-fold scale per digit, 98,688 B, through the first
# K1's device body, ``accumulate_fixed``) and its epilogue writes
# the float32 (g, h) histograms: K5's recombination in the order above,
# K4's one conversion per digit sum, then (S0 + S1) + S2. Integer sums are
# exact, so two launches agree bit for bit. The wrappers prepare the
# digits row-major ([K, N, 8] int8 or [K, N, 6] bf16) and their scales
# (``launch_inputs``), then launch (``launch_mode_kernel``).
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
MODE_NODES = 8  # nodes per CTA of the mode kernel (grid z takes the rest)
MODE_CELL_BYTES = {False: 6 * 8, True: 8 * 4}  # per (node, bin): K4, K5


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


def quantize_gh_i8(gh: torch.Tensor):
    """(digits [K, N, 8] int8, scale [K, 2] float32) of float32 (g, h)
    [K, N, 2] (``hist_pallas.quantize_gh_i8`` per fold): s = max(max |x|,
    1e-30) over the fold's rows, q = round_half_even(x / s * 2^26) (a true
    division), balanced base-128 digits d0..d2 in [-64, 64] and the rest
    d3 (|d3| <= 32): g's four digits, then h's."""
    x = gh.float()
    K, N, _ = x.shape
    amax = x.abs().amax(dim=1) if N else torch.zeros(K, 2, device=x.device)
    s = torch.clamp(amax, min=1e-30)
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


def build_histograms_i8_plain(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                              k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """K5's arithmetic in plain PyTorch: the digits, int64 ``index_add_``
    sums of the 8 digit columns, the float32 recombination. Bit for bit the
    kernel's, and the JAX package's ``build_histograms_binlane_i8``."""
    _check_shapes(binned, node_q, gh)
    digits, scale = quantize_gh_i8(gh)
    P = _segment_sums(binned, node_q, digits.long(), k_nodes, n_bins_tot)
    return _recombine_i8(P.transpose(3, 4), scale)


def build_histograms_bf16_plain(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                                k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """K4's arithmetic in plain PyTorch with float32 sums: the digits, three
    float32 ``index_add_`` histograms (one per digit), summed
    (S0 + S1) + S2."""
    _check_shapes(binned, node_q, gh)
    d = split_gh_digits(gh).float()
    S = [_segment_sums(binned, node_q, d[..., [i, 3 + i]], k_nodes, n_bins_tot)
         for i in range(3)]
    return (S[0] + S[1]) + S[2]


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


def build_histograms_bf16_fixed(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                                k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """K4's kernel arithmetic in plain PyTorch (``bf16_digit_sums_fixed``,
    then (S0 + S1) + S2 per channel in float32): equal to the kernel bit
    for bit."""
    S = bf16_digit_sums_fixed(binned, node_q, gh, k_nodes, n_bins_tot)
    return torch.stack([(S[..., 3 * c] + S[..., 3 * c + 1]) + S[..., 3 * c + 2]
                        for c in range(2)], dim=-1)


def launch_inputs(int8: bool, gh: torch.Tensor):
    """(digits, scale) the mode kernel takes for float32 (g, h) [K, N, 2]:
    K5 (``int8``) ``quantize_gh_i8``'s [K, N, 8] int8 digits and [K, 2]
    scales s; K4 ``split_gh_digits``' [K, N, 6] bf16 digits and their
    [K, 6] float32 max |digit| per fold."""
    if int8:
        return quantize_gh_i8(gh)
    digits = split_gh_digits(gh)
    K, N, _ = digits.shape
    maxabs = digits.abs().amax(dim=1).float() if N else torch.zeros(
        K, 6, dtype=torch.float32, device=gh.device)
    return digits, maxabs


def launch_mode_kernel(int8: bool, binned: torch.Tensor, node_q: torch.Tensor,
                       digits: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
                       k_nodes: int, n_bins_tot: int) -> None:
    """One launch of the mode kernel (K5 if ``int8``, else K4) on inputs the
    wrappers checked and ``launch_inputs`` prepared; writes ``out``
    [K, F, k_nodes, n_bins_tot, 2] float32. Counts nothing."""
    K, F, N = binned.shape
    fn_name = "mallorn_hist_i8" if int8 else "mallorn_hist_bf16"
    lib = cuda_build.load()
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = getattr(lib, fn_name)(binned.data_ptr(), node_q.data_ptr(), digits.data_ptr(),
                                   scale.data_ptr(), out.data_ptr(), K, F, N, k_nodes,
                                   n_bins_tot, stream)
    cuda_build.check(rc, fn_name)


def _mode_hist(int8: bool, name: str, binned, node_q, gh, k_nodes, n_bins_tot) -> torch.Tensor:
    """K5 (``int8``) or K4 on CUDA tensors: check, prepare, launch, count."""
    global bf16_launches, i8_launches
    _check_cuda_inputs(name, binned, node_q, gh)
    if min(k_nodes, MODE_NODES) * n_bins_tot * MODE_CELL_BYTES[int8] > SMEM_BYTES:
        raise ValueError(f"{name}: {n_bins_tot} bins exceed the kernel's shared memory "
                         f"({SMEM_BYTES} bytes per CTA)")
    K, F, _ = binned.shape
    out = torch.empty(K, F, k_nodes, n_bins_tot, 2, dtype=torch.float32, device=binned.device)
    if out.numel() == 0:
        return out
    digits, scale = launch_inputs(int8, gh)
    launch_mode_kernel(int8, binned, node_q, digits, scale, out, k_nodes, n_bins_tot)
    if int8:
        i8_launches += 1
    else:
        bf16_launches += 1
    return out


def build_histograms_bf16(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                          k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """K4: [K, F, k_nodes, n_bins_tot, 2] float32 (grad, hess) histograms
    summed as bf16 digits, from int16 bins [K, F, N], int32 node ids
    [K, N] and float32 (g, h) [K, N, 2]."""
    if binned.device.type == "cpu":
        return build_histograms_bf16_plain(binned, node_q, gh, k_nodes, n_bins_tot)
    return _mode_hist(False, "build_histograms_bf16", binned, node_q, gh, k_nodes, n_bins_tot)


def build_histograms_i8(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                        k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """K5: [K, F, k_nodes, n_bins_tot, 2] float32 (grad, hess) histograms
    of the int8 fixed-point digits, from int16 bins [K, F, N], int32 node
    ids [K, N] and float32 (g, h) [K, N, 2]."""
    if binned.device.type == "cpu":
        return build_histograms_i8_plain(binned, node_q, gh, k_nodes, n_bins_tot)
    return _mode_hist(True, "build_histograms_i8", binned, node_q, gh, k_nodes, n_bins_tot)
