"""Per-level GBDT histograms, batched over folds: the Hopper kernel and its
plain PyTorch version.

Counterpart of ``mallorn_tpu/ops/hist_pallas.py:build_histograms_fullhot``
(Pallas body ``_fullhot_kernel``), with a leading fold axis so one launch
covers every fold of a CV. For fold k, feature f, node c < ``k_nodes`` and
bin b < ``n_bins_tot`` (bin ``n_bins_tot - 1`` is the missing bin)::

    hist[k, f, c, b, :] = sum_r [node_q[k, r] == c] [binned[k, f, r] == b] gh[k, r, :]

Rows whose node id is outside ``[0, k_nodes)`` (the depthwise fit uses
``k_nodes``) are inactive: rows not on this level, or right children when
the level is built by subtraction.

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
  bit for bit, so a fit through it must build the kernel's forest.
- ``launches`` counts kernel launches (plain calls do not count).
"""

from __future__ import annotations

import torch

from mallorn_tpu_torch.utils import cuda_build

# a CTA holds one (fold, feature) histogram as int64 cells in shared memory
SMEM_BYTES = 232448

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _check_shapes(binned, node_q, gh):
    if binned.dim() != 3 or node_q.dim() != 2 or gh.dim() != 3 or gh.shape[2] != 2:
        raise ValueError(f"expected binned [K, F, N], node_q [K, N], gh [K, N, 2]; got "
                         f"{tuple(binned.shape)}, {tuple(node_q.shape)}, {tuple(gh.shape)}")
    K, _, N = binned.shape
    if tuple(node_q.shape) != (K, N) or tuple(gh.shape[:2]) != (K, N):
        raise ValueError("binned, node_q and gh disagree on folds or rows")


def build_histograms_plain(binned: torch.Tensor, node_q: torch.Tensor,
                           gh: torch.Tensor, k_nodes: int,
                           n_bins_tot: int) -> torch.Tensor:
    """[K, F, k_nodes, n_bins_tot, 2] histograms in ``gh``'s dtype."""
    _check_shapes(binned, node_q, gh)
    K, F, N = binned.shape
    n_seg = k_nodes * n_bins_tot
    dev = gh.device
    nq = node_q.long()
    node_ok = (nq >= 0) & (nq < k_nodes)
    base = torch.arange(K, device=dev)[:, None] * n_seg + nq * n_bins_tot
    vals = gh.reshape(K * N, 2)
    out = torch.zeros(F, K * n_seg + 1, 2, dtype=gh.dtype, device=dev)
    for f in range(F):
        b = binned[:, f, :].long()
        ok = node_ok & (b >= 0) & (b < n_bins_tot)
        seg = torch.where(ok, base + b, K * n_seg)  # inactive -> a sink segment
        out[f].index_add_(0, seg.reshape(-1), vals)
    return out[:, :-1].reshape(F, K, k_nodes, n_bins_tot, 2).transpose(0, 1).contiguous()


def _log2_ceil(n: int) -> int:
    return max(int(n) - 1, 0).bit_length()


def build_histograms_fixed(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                           k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """The kernel's int64 fixed-point histogram in plain PyTorch: per fold
    and channel, scale S = 2^(62 - ceil(log2 N) - e) with max|gh| < 2^e,
    each value rounded to the nearest integer of value * S, integer sums
    (exact, any order), one conversion (sum / S -> float32); NaN in every
    cell of a fold whose gh is not finite."""
    _check_shapes(binned, node_q, gh)
    K, F, N = binned.shape
    dev = gh.device
    maxabs = gh.abs().amax(dim=1) if N else torch.zeros(K, 2, device=dev)  # [K, 2]
    _, e = torch.frexp(maxabs)
    scale = torch.where(maxabs > 0,
                        torch.ldexp(torch.ones_like(maxabs, dtype=torch.float64),
                                    62 - _log2_ceil(N) - e), 1.0).to(torch.float64)
    q = torch.round(gh.double() * scale[:, None, :])
    q = torch.where(torch.isfinite(q), q, 0.0).to(torch.int64)
    acc = build_histograms_plain(binned, node_q, q, k_nodes, n_bins_tot)
    out = (acc.double() * (1.0 / scale)[:, None, None, None, :]).float()
    finite = torch.isfinite(maxabs).all(dim=1)
    return torch.where(finite[:, None, None, None, None], out, torch.nan)


def build_histograms(binned: torch.Tensor, node_q: torch.Tensor, gh: torch.Tensor,
                     k_nodes: int, n_bins_tot: int) -> torch.Tensor:
    """[K, F, k_nodes, n_bins_tot, 2] float32 (grad, hess) histograms from
    int16 bins [K, F, N], int32 node ids [K, N] and float32 (g, h) [K, N, 2]."""
    global launches
    if binned.device.type == "cpu":
        return build_histograms_plain(binned, node_q, gh, k_nodes, n_bins_tot)
    if binned.device.type != "cuda":
        raise ValueError(f"build_histograms: unsupported device {binned.device}")
    _check_shapes(binned, node_q, gh)
    if (binned.dtype, node_q.dtype, gh.dtype) != (torch.int16, torch.int32, torch.float32):
        raise TypeError(f"build_histograms: expected int16 bins, int32 node ids and "
                        f"float32 (g, h); got {binned.dtype}, {node_q.dtype}, {gh.dtype}")
    if not (binned.is_contiguous() and node_q.is_contiguous() and gh.is_contiguous()):
        raise ValueError("build_histograms: inputs must be contiguous")
    if not (node_q.device == gh.device == binned.device):
        raise ValueError("build_histograms: inputs on different devices")
    if k_nodes * n_bins_tot * 2 * 8 > SMEM_BYTES:
        raise ValueError(f"build_histograms: {k_nodes} nodes x {n_bins_tot} bins exceed "
                         f"the kernel's shared memory ({SMEM_BYTES} bytes per CTA)")
    K, F, N = binned.shape
    out = torch.empty(K, F, k_nodes, n_bins_tot, 2, dtype=torch.float32,
                      device=binned.device)
    if K == 0 or F == 0:
        return out
    maxabs = gh.abs().amax(dim=1).contiguous() if N else torch.zeros(
        K, 2, dtype=torch.float32, device=gh.device)
    lib = cuda_build.load()
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = lib.mallorn_hist(binned.data_ptr(), node_q.data_ptr(), gh.data_ptr(),
                              maxabs.data_ptr(), out.data_ptr(), K, F, N, k_nodes,
                              n_bins_tot, stream)
    cuda_build.check(rc, "mallorn_hist")
    launches += 1
    return out
