"""Batched Cholesky for the 2D-GP: the Hopper kernels and their plain
PyTorch versions. K2, the fused Cholesky-inverse, is below; K6, the
factorisation alone (``cholesky``), is at the end of this module.

Counterpart of ``mallorn_tpu/ops/chol_pallas.py:cholesky_inverse_lanes``
(Pallas body ``_chol_inv_kernel``). For a [B, T, T] float32 batch of SPD
matrices (identity on masked rows) it returns ``Linv = chol(K)^-1``
[B, T, T] (upper triangle zero) and ``logdet(K)`` [B], where logdet sums
``log(pivot)`` over the columns. A non-positive pivot gives NaN that
propagates; nothing raises, the GP's ``isfinite`` guards take it from
there.

- ``chol_inv`` launches a CUDA kernel for a CUDA tensor and runs
  ``chol_inv_plain`` for a CPU tensor. A CUDA tensor never falls back: a
  kernel launches or the call raises. The width picks the kernel:
  T <= ``MAX_T`` takes the blocked kernel (``csrc/chol_inv_blocked.cu``:
  one triangle of 16 x 16 tiles in one CTA's shared memory,
  register-tiled updates, the inverse formed in place);
  ``MAX_T`` < T <= ``MAX_T_CLUSTER`` the cluster kernel
  (``csrc/chol_inv_cluster.cu``: the same tiles and arithmetic, the
  triangle spread over the shared memory of a thread-block cluster of
  ``cluster_size(T)`` CTAs), each one launch per call; a wider batch the
  tiled kernel (``csrc/chol_tiled.cu``: 64 x 64 tiles in a global scratch
  allocated here, a grid of (tile, matrix) CTAs per step, one C call of
  ``tiled_plan(T)[2]`` launches per call; any width that memory holds).
- ``chol_inv_plain`` is the right-looking column loop in PyTorch, batched
  over B: the contract's plain version. The CPU tests use it, and
  ``chip_smoke.py`` holds every kernel against it on the card.
  ``chol_inv_blocked_plain`` is the kernels' algorithm in their order
  (nb = 16 for the blocked and the cluster kernel, nb = 64 for the tiled
  one, whose diagonal tiles are factored at nb = 16 inside), held against
  the JAX package and float64 by the CPU tests; no path calls it.
- Counts of kernel calls (plain calls do not count): ``launches``
  (blocked, per width in ``launches_by_t``), ``cluster_launches`` (per
  width in ``cluster_launches_by_t``) and ``large_launches`` (the tiled
  kernel, per width in ``large_launches_by_t``; one per call, whatever
  the launches inside it) for K2; ``chol_launches``,
  ``chol_cluster_launches`` and ``chol_large_launches`` for K6.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from mallorn_tpu_torch.utils import cuda_build

# widest batch the blocked kernel takes, for K2 and K6 (one triangle of
# 16 x 16 tiles in shared memory: 215,040 bytes at T = 320, and T = 336
# would pass the 232,448 a block may take); a wider batch takes the cluster
# kernel up to MAX_T_CLUSTER, the tiled kernel beyond
MAX_T = 320
MAX_T_CLUSTER = 784
SMEM_BYTES = 232448  # shared memory one block may take on an H100
CLUSTER_SIZES = (2, 4, 8)  # portable cluster sizes
TILED_NB = 64  # the tiled kernel's tile side (kPanel of csrc/chol_tiled.cu)

launches = 0
launches_by_t: Dict[int, int] = {}
cluster_launches = 0
cluster_launches_by_t: Dict[int, int] = {}
large_launches = 0
large_launches_by_t: Dict[int, int] = {}
chol_launches = 0
chol_cluster_launches = 0
chol_large_launches = 0
# (device index, C, shared memory bytes, K2?) whose cluster was found to fit
# the device (``_check_cluster_fits``)
_cluster_fits: set = set()


def reset_launches() -> None:
    global launches, cluster_launches, large_launches
    global chol_launches, chol_cluster_launches, chol_large_launches
    launches = cluster_launches = large_launches = 0
    chol_launches = chol_cluster_launches = chol_large_launches = 0
    launches_by_t.clear()
    cluster_launches_by_t.clear()
    large_launches_by_t.clear()


def _tile_index(I: int, J: int, C: int) -> int:
    """Tile (I, J) in its owner's shared memory (``tile_index`` of
    ``csrc/chol_inv_cluster.cu``): tile row I lives in rank I mod C."""
    return (I // C) * (I % C + 1) + C * ((I // C) * (I // C - 1) // 2) + J


def cluster_smem_bytes(T: int, C: int) -> int:
    """Shared memory of one CTA of the cluster kernel at width T on C
    ranks (``cluster_smem_bytes`` of the .cu): the largest rank's tile rows,
    a staging area of nt tiles and a 16-byte logdet slot."""
    nt = -(-T // 16)
    most = max((_tile_index(r + ((nt - 1 - r) // C + 1) * C, 0, C) if r < nt else 0)
               for r in range(C))
    return (4 + (most + nt) * 256) * 4


def cluster_size(T: int) -> int:
    """CTAs per matrix of the cluster kernel at width T: the smallest of
    ``CLUSTER_SIZES`` whose share fits one block's shared memory; 0 where
    the cluster kernel does not serve T (T <= MAX_T or T > MAX_T_CLUSTER).
    2 up to T = 432, 4 up to 576, 8 up to 784."""
    if T <= MAX_T or T > MAX_T_CLUSTER:
        return 0
    return next(C for C in CLUSTER_SIZES if cluster_smem_bytes(T, C) <= SMEM_BYTES)


def cluster_occupancy(T: int, inverse: bool = True, device=None) -> int:
    """Clusters of ``cluster_size(T)`` CTAs that the device holds at once at
    width T (``cudaOccupancyMaxActiveClusters``); 0 means a launch cannot
    run."""
    C = cluster_size(T)
    if not C:
        raise ValueError(f"the cluster kernel does not serve T = {T}")
    lib = cuda_build.load()
    n = ctypes.c_int(0)
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        cuda_build.check(lib.mallorn_chol_cluster_occupancy(T, C, int(inverse),
                                                            ctypes.byref(n)),
                         "mallorn_chol_cluster_occupancy")
    return n.value


def _check_cluster_fits(device: torch.device, T: int, inverse: bool) -> int:
    """C for T, after checking once per (device, C, shared memory, kernel)
    that such a cluster can be resident; raises where it cannot."""
    C = cluster_size(T)
    key = (device.index, C, cluster_smem_bytes(T, C), inverse)
    if key not in _cluster_fits:
        n = cluster_occupancy(T, inverse, device)
        if n == 0:
            raise RuntimeError(f"a cluster of {C} CTAs with {key[2]} bytes of shared memory "
                               f"each cannot be resident on {device} (T = {T})")
        _cluster_fits.add(key)
    return C


def tiled_plan(T: int, inverse: bool = True) -> Tuple[int, int, int]:
    """(nb, nt, kernel launches per call) of the tiled kernel at width T
    (``launch_tiled`` of ``csrc/chol_tiled.cu``): nt panels of nb = 64
    columns; a pack and an unpack launch, per panel a diagonal launch and,
    but for the last, a panel and a trailing-update launch, and for K2
    (``inverse``) two launches per block column but the last: 63 at
    T = 800 and 78 at T = 1024 (K6: 39, 48)."""
    nt = -(-T // TILED_NB)
    return TILED_NB, nt, 2 + nt + 2 * (nt - 1) + (2 * (nt - 1) if inverse else 0)


def tiled_scratch_floats(B: int, T: int) -> int:
    """Floats of the tiled kernel's global scratch: B [Tp, Tp] identity-padded
    triangles (Tp = nb nt) and B [Tp, nb] rows for the inverse's W (K2) or
    Linv_kk (K6)."""
    nb, nt, _ = tiled_plan(T)
    Tp = nb * nt
    return B * Tp * (Tp + nb)


def chol_inv_plain(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched column loop with the kernel's pivot / NaN / logdet rules.

    Works in K's dtype (float64 on request, for an oracle)."""
    if K.dim() != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"expected [B, T, T], got {tuple(K.shape)}")
    B, T, _ = K.shape
    A = K.clone()
    X = torch.eye(T, dtype=K.dtype, device=K.device).expand(B, T, T).clone()
    ld = torch.zeros(B, dtype=K.dtype, device=K.device)
    for j in range(T):
        piv = A[:, j, j]
        d = torch.rsqrt(piv)
        col = A[:, j + 1:, j] * d[:, None]  # L[j+1:, j]
        A[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
        xj = X[:, j, : j + 1] * d[:, None]
        X[:, j, : j + 1] = xj
        X[:, j + 1:, : j + 1] -= col[:, :, None] * xj[:, None, :]
        ld = ld + torch.log(piv)
    return X, ld


def _blocked_factor(K: torch.Tensor, nb: int, inverse: bool):
    """The blocked kernel's factorisation in its panel order: (A, logdet),
    A the [B, Tp, Tp] identity-padded triangle with L below the diagonal
    tiles and, in them, Linv_kk (``inverse``) or L_kk."""
    if K.dim() != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"expected [B, T, T], got {tuple(K.shape)}")
    B, T, _ = K.shape
    nt = -(-T // nb)
    Tp = nt * nb
    A = torch.eye(Tp, dtype=K.dtype, device=K.device).expand(B, Tp, Tp).clone()
    A[:, :T, :T] = torch.tril(K)
    ld = torch.zeros(B, dtype=K.dtype, device=K.device)
    eye = torch.eye(nb, dtype=K.dtype, device=K.device)
    for k in range(nt):
        kk = slice(k * nb, (k + 1) * nb)
        D = A[:, kk, kk].clone()
        dinv = torch.empty(B, nb, dtype=K.dtype, device=K.device)
        for j in range(nb):  # (a)
            piv = D[:, j, j].clone()
            dinv[:, j] = torch.rsqrt(piv)
            D[:, j:, j] *= dinv[:, j, None]
            D[:, j + 1:, j + 1:] -= D[:, j + 1:, j, None] * D[:, None, j + 1:, j]
            ld = ld + torch.log(piv)
        X = torch.zeros_like(D)
        for r in range(nb):
            X[:, r] = (eye[r] - (D[:, r, None, :r] @ X[:, :r]).squeeze(1)) * dinv[:, r, None]
        A[:, kk, kk] = X if inverse else torch.tril(D)
        below = slice((k + 1) * nb, Tp)
        panel = A[:, below, kk] @ X.transpose(1, 2)  # (b)
        A[:, below, kk] = panel
        A[:, below, below] -= panel @ panel.transpose(1, 2)  # (c)
    return A, ld


def chol_inv_blocked_plain(K: torch.Tensor, nb: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocked algorithm of the kernels in plain PyTorch: the same
    (Linv, logdet) as ``chol_inv_plain``, in the kernels' order. nb = 16 is
    the blocked and the cluster kernel's (the cluster kernel forms every W
    before the recurrence, which changes no sum); nb = 64 the tiled
    kernel's, but for the order inside a diagonal tile, which the kernel
    factors at nb = 16. No path calls it; the CPU tests hold it against the
    JAX package and float64.

    K's lower triangle is padded with identity to a multiple of ``nb`` and
    worked on in place, nb x nb tiles at a time:
      factorisation, panel k: (a) the diagonal tile's Cholesky, column by
      column (logdet in column order), then Linv_kk = L_kk^-1 by forward
      substitution, left in that tile; (b) the panel below it,
      L[I, k] = A[I, k] Linv_kk^T; (c) the trailing update
      A[I, J] -= L[I, k] L[J, k]^T;
      inverse, block columns J from the right:
      Linv[J+1:, J] = -Linv[J+1:, J+1:] (L[J+1:, J] Linv_JJ).
    """
    A, ld = _blocked_factor(K, nb, inverse=True)
    T, Tp = K.shape[1], A.shape[1]
    for J in range(Tp // nb - 2, -1, -1):
        below, cols = slice((J + 1) * nb, Tp), slice(J * nb, (J + 1) * nb)
        W = A[:, below, cols] @ A[:, cols, cols]
        A[:, below, cols] = -torch.tril(A[:, below, below]) @ W
    return torch.tril(A)[:, :T, :T].contiguous(), ld


def _check_cuda_batch(name: str, K: torch.Tensor) -> None:
    if K.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {K.device}")
    if K.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {K.dtype}")
    if K.dim() != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"{name}: expected [B, T, T], got {tuple(K.shape)}")
    if not K.is_contiguous():
        raise ValueError(f"{name}: K must be contiguous")


def chol_inv(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Linv [B, T, T], logdet [B]) for a batch of SPD matrices."""
    global launches, cluster_launches, large_launches
    if K.device.type == "cpu":
        return chol_inv_plain(K)
    _check_cuda_batch("chol_inv", K)
    B, T, _ = K.shape
    Linv = torch.empty_like(K)
    logdet = torch.empty(B, dtype=torch.float32, device=K.device)
    if B == 0:
        return Linv, logdet
    if T > MAX_T_CLUSTER:
        _launch_tiled(K, True, Linv.data_ptr(), logdet.data_ptr())
        large_launches += 1
        large_launches_by_t[T] = large_launches_by_t.get(T, 0) + 1
        return Linv, logdet
    if T > MAX_T:
        C = _check_cluster_fits(K.device, T, True)
        _launch(K, "mallorn_chol_inv_cluster", K.data_ptr(), Linv.data_ptr(),
                logdet.data_ptr(), B, T, C)
        cluster_launches += 1
        cluster_launches_by_t[T] = cluster_launches_by_t.get(T, 0) + 1
        return Linv, logdet
    _launch(K, "mallorn_chol_inv", K.data_ptr(), Linv.data_ptr(), logdet.data_ptr(), B, T)
    launches += 1
    launches_by_t[T] = launches_by_t.get(T, 0) + 1
    return Linv, logdet


def _launch(K: torch.Tensor, name: str, *args) -> None:
    """The library's entry point ``name`` on K's device and current stream
    (the stream is its last argument); raises on a CUDA error."""
    lib = cuda_build.load()
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        cuda_build.check(getattr(lib, name)(*args, stream), name)


def _launch_tiled(K: torch.Tensor, inverse: bool, *outs: int) -> None:
    """The tiled kernel, K2 (``inverse``) or K6, from K into the outputs at
    ``outs`` (data pointers), with its scratch, on K's device and current
    stream; raises on a CUDA error or when the launches it made are not
    ``tiled_plan``'s."""
    B, T, _ = K.shape
    name = "mallorn_chol_inv_tiled" if inverse else "mallorn_chol_tiled"
    want = tiled_plan(T, inverse)[2]
    scratch = torch.empty(tiled_scratch_floats(B, T), dtype=torch.float32, device=K.device)
    n = ctypes.c_int(0)
    _launch(K, name, K.data_ptr(), *outs, scratch.data_ptr(), B, T, ctypes.byref(n))
    if n.value != want:
        raise RuntimeError(f"{name}: {n.value} kernel launches at T = {T}, planned {want}")


def cho_solve(Linv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """K^-1 r = Linv^T (Linv r) for [B, T, T] Linv and [B, T] r."""
    z = torch.matmul(Linv, r.unsqueeze(-1))
    return torch.matmul(Linv.transpose(1, 2), z).squeeze(-1)


# ---------------------------------------------------------------------------
# K6: the factorisation alone
# ---------------------------------------------------------------------------
# Counterpart of ``mallorn_tpu/ops/chol_pallas.py:cholesky_lanes`` (Pallas
# body ``_chol_kernel``): L = chol(K) [B, T, T], upper triangle exactly 0,
# L[j, j] = pivot * rsqrt(pivot); a non-positive pivot gives NaN in that
# matrix only. The kernels are K2's with the inverse switched off
# (``kInverse = false``: L_kk stays in the diagonal tiles, Linv_kk for the
# panel step in one more tile): the blocked kernel for T <= MAX_T, counted
# in ``chol_launches``, the cluster kernel up to MAX_T_CLUSTER, counted in
# ``chol_cluster_launches``, and the tiled kernel beyond, one call counted
# in ``chol_large_launches``. ``cholesky_blocked_plain`` is the kernels'
# algorithm in their order (nb = 64 for the tiled kernel); no path calls
# it.


def cholesky_plain(K: torch.Tensor) -> torch.Tensor:
    """The right-looking column loop in K's dtype (float64 for an oracle)."""
    if K.dim() != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"expected [B, T, T], got {tuple(K.shape)}")
    B, T, _ = K.shape
    A = K.clone()
    L = torch.zeros_like(K)
    for j in range(T):
        piv = A[:, j, j]
        col = A[:, j:, j] * torch.rsqrt(piv)[:, None]  # L[j:, j]
        L[:, j:, j] = col
        A[:, j + 1:, j + 1:] -= col[:, 1:, None] * col[:, None, 1:]
    return L


def cholesky_blocked_plain(K: torch.Tensor, nb: int = 16) -> torch.Tensor:
    """K6's algorithm in the kernels, in plain PyTorch: the same L as
    ``cholesky_plain``, in the kernels' panel order with identity padding
    (``chol_inv_blocked_plain`` without the inverse and logdet; L_kk stays
    in the diagonal tiles, Linv_kk serves the panel step); nb = 16 for the
    blocked and the cluster kernel, 64 for the tiled one. No path calls it;
    the CPU tests hold it against the JAX package and float64."""
    A, _ = _blocked_factor(K, nb, inverse=False)
    T = K.shape[1]
    return torch.tril(A)[:, :T, :T].contiguous()


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """L [B, T, T] with K = L L^T for a batch of SPD matrices."""
    global chol_launches, chol_cluster_launches, chol_large_launches
    if K.device.type == "cpu":
        return cholesky_plain(K)
    _check_cuda_batch("cholesky", K)
    B, T, _ = K.shape
    L = torch.empty_like(K)
    if B == 0:
        return L
    if T > MAX_T_CLUSTER:
        _launch_tiled(K, False, L.data_ptr())
        chol_large_launches += 1
    elif T > MAX_T:
        C = _check_cluster_fits(K.device, T, False)
        _launch(K, "mallorn_chol_cluster", K.data_ptr(), L.data_ptr(), B, T, C)
        chol_cluster_launches += 1
    else:
        _launch(K, "mallorn_chol", K.data_ptr(), L.data_ptr(), B, T)
        chol_launches += 1
    return L
