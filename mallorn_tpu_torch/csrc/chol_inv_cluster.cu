// K2 and K6 for 320 < T <= 784: the batched Cholesky of the 2D-GP as one
// thread-block cluster per matrix, the triangle of tiles spread over the
// cluster's shared memory; with the inverse (K2) it forms Linv in place.
//
// K2 replaces mallorn_tpu/ops/chol_pallas.py:_chol_inv_kernel (:60, behind
// cholesky_inverse_lanes), K6 mallorn_tpu/ops/chol_pallas.py:_chol_kernel
// (:28, behind cholesky_lanes). The contract is the blocked kernel's
// (chol_inv_blocked.cu): per matrix b of a [B, T, T] float32 row-major batch
// of SPD matrices (identity on masked rows), K2 gives Linv = chol(K)^-1 from
// K's lower triangle (upper triangle exactly 0) and logdet[b] = sum_j
// log(pivot_j) in column order; K6 gives L = chol(K) alone, its upper
// triangle exactly 0 and L[j, j] = pivot * rsqrt(pivot). A non-positive
// pivot gives NaN that spreads through that matrix only: no early exit, so
// no rank waits at a barrier that another never reaches. No atomics: two
// launches are bit for bit equal, a matrix's result does not depend on B,
// and every element takes the blocked kernel's arithmetic in its order
// (chol_tiles.cuh), so the blocked kernel's CPU twins
// (chol_cuda.chol_inv_blocked_plain, cholesky_blocked_plain) are this
// kernel's too.
//
// Bound on an H100: as the blocked kernel's, B (T(T+1)/2 + T^2) 4 bytes
// against 2T^3/3 flops per matrix (K2; T^3/3 for K6) at the float32 rate
// outside the tensor cores: operations above T of about 180.
//
// Why a cluster: the triangle of 16 x 16 tiles, padded with identity to
// Tp = 16 ceil(T / 16), needs Tp (Tp + 16) / 2 floats (T = 400: 325 tiles,
// 332,800 B), more than one block may take (232,448 B). A cluster of C CTAs
// on C SMs holds it in distributed shared memory: tile row I lives in CTA
// (rank) I mod C, rows packed one after another (tile_index). Each rank
// also keeps a staging area of nt tiles at the same offset on every rank
// (stage_off, the largest rank's share), and a 16-byte slot for the running
// logdet. C is the smallest of 2, 4, 8 for which that fits
// (chol_cuda.cluster_size repeats the sum): 2 up to T = 432 (T = 400:
// 169 + 25 tiles and the slot, 198,672 B), 4 up to 576, 8 up to 784.
//
//   Factorisation, panel k = 0 .. nt-1 (the blocked kernel's order):
//   (a) the owner of diagonal tile k factors it with one warp and forms
//       Linv_kk (diag_chol_inv): K2 leaves it in the tile, K6 in the
//       owner's first staging tile (L_kk stays in the diagonal tile);
//   (b) every rank copies Linv_kk from its owner through distributed shared
//       memory (one 1 KB tile), then forms the panel rows L[I, k] =
//       A[I, k] Linv_kk^T of the tile rows it owns;
//       cluster barrier;
//   (c) every rank copies the panel column L[k+1:, k] from all ranks into
//       its staging area (nt-1-k tiles, read once through DSMEM and then
//       by every tile of the update from local shared memory: 3-5% faster
//       on an H100 than reading the panel tiles in place through DSMEM,
//       timed with tools/time_chol.py), then updates its own
//       tiles A[I, J] -= L[I, k] L[J, k]^T with the blocked kernel's
//       register tiling (update_tile: 16 threads per tile, a 4 x 4 block
//       each). The owner of tile k + 1 looks ahead: its warp 0 updates that
//       tile first and runs (a) on it while the rest of the cluster updates;
//       it takes the running logdet from the owner of tile k (the slot) and
//       leaves it in its own slot, so logdet is summed in column order, as
//       the blocked kernel sums it;
//       cluster barrier.
//   That is 2 cluster barriers per panel, against 2T block barriers per
//   matrix in the column loop it replaced.
//   Inverse (K2 only). W = L[J+1:, J] Linv_JJ depends only on L and
//   Linv_JJ, so every rank forms W for all its tiles at once (Linv_JJ of
//   every J staged), one cluster barrier; then block columns J from the
//   right: every rank stages W[J+1:, J] from all ranks, a cluster barrier
//   (no rank overwrites a tile before every rank has read it), and forms
//   Linv[I, J] = -sum_{M=J+1..I} Linv[I, M] W[M, J] for its rows from local
//   shared memory: one cluster barrier per block column.
// K's triangle comes in by cp.async into the rank that owns each tile row;
// each rank writes its own rows out. No rank reads another's shared memory
// after its last cluster barrier, so none may exit early.

#include <cooperative_groups.h>

#include "chol_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / 16;  // tiles updated at once, 16 threads each
constexpr int kMaxT = 784;
constexpr int kMaxBlockSmem = 232448;
constexpr int kSlotFloats = 4;  // the running logdet, padded to 16 bytes

// tile (I, J), J <= I, in its owner's shared memory (rank I mod C), in tiles
// from the first: rows r, r + C, ... of I + 1 tiles each, one after another
__host__ __device__ constexpr int tile_index(int I, int J, int C) {
  return (I / C) * (I % C + 1) + C * ((I / C) * (I / C - 1) / 2) + J;
}

// tiles rank r holds for nt tile rows
__host__ __device__ constexpr int owned_tiles(int nt, int C, int r) {
  return r < nt ? tile_index(r + ((nt - 1 - r) / C + 1) * C, 0, C) : 0;
}

// the largest rank's share: where every rank's staging area starts
int stage_offset(int nt, int C) {
  int most = 0;
  for (int r = 0; r < C; ++r) most = owned_tiles(nt, C, r) > most ? owned_tiles(nt, C, r) : most;
  return most;
}

size_t cluster_smem_bytes(int nt, int C) {
  return (kSlotFloats + static_cast<size_t>(stage_offset(nt, C) + nt) * kTile) * sizeof(float);
}

// the first tile row after k that rank r owns
__device__ __forceinline__ int first_row_after(int k, int r, int C) {
  return k + 1 + ((r - (k + 1)) % C + C) % C;
}

// moves (I, off) on to the next of rank's tiles (I, lo + off) with
// lo + off <= I - excl, rows I stepping by C: off counts tiles in row I
__device__ __forceinline__ void walk(int& I, int& off, int lo, int excl, int nt, int C) {
  while (I < nt && off >= I + 1 - excl - lo) {
    off -= I + 1 - excl - lo;
    I += C;
  }
}

template <int kC, bool kInverse>
__global__ void __launch_bounds__(kThreads, 1)
chol_cluster_kernel(const float* __restrict__ K, float* __restrict__ out,
                    float* __restrict__ logdet, int T, int stage_off) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* const slot = reinterpret_cast<float*>(smem4);
  float* const s = slot + kSlotFloats;
  float* const stage = s + stage_off * kTile;
  const int nt = (T + kNb - 1) / kNb;
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_rows = rank < nt ? (nt - 1 - rank) / kC + 1 : 0;
  // tile (I, J) at its owner's offset: local when I mod C is this rank
  auto tile = [&](int I, int J) { return s + tile_index(I, J, kC) * kTile; };
  auto remote4 = [&](float* p, int owner) {
    return reinterpret_cast<const float4*>(cluster.map_shared_rank(p, owner));
  };
  // where (a) leaves Linv_kk: the diagonal tile (K2) or the first staging
  // tile (K6), at the same offset on every rank
  auto winv = [&](int k) { return kInverse ? tile(k, k) : stage; };

  // this rank's tile rows of K's lower triangle by cp.async; identity beyond
  // T, zeros above the diagonal of the diagonal tiles
  const float* Kb = K + static_cast<size_t>(b) * T * T;
  for (int lr = warp; lr < n_rows * kNb; lr += kWarps) {
    const int I = rank + kC * (lr / kNb);
    const int i = I * kNb + lr % kNb;
    for (int c = lane; c < (I + 1) * kNb; c += 32) {
      float* dst = tile(I, c / kNb) + elem_off(i % kNb, c % kNb);
      if (c <= i && i < T) {
        const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(d), "l"(Kb + static_cast<size_t>(i) * T + c));
      } else {
        *dst = (c == i) ? 1.0f : 0.0f;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float ld = 0.0f;  // the look-ahead warp's, in column order
  if (rank == 0 && warp == 0) {
    diag_chol_inv<kInverse>(tile(0, 0), winv(0), ld, lane);
    if (lane == 0) *slot = ld;
  }
  cluster.sync();  // every CTA of the cluster runs, and (a) on tile 0 is visible

  for (int k = 0; k < nt - 1; ++k) {
    const int owner = k % kC;
    // (b) Linv_kk from its owner into the first staging tile, then the
    // panel rows of this rank's tile rows below k
    const float* D = winv(k);
    if (owner != rank) {
      const float4* src = remote4(winv(k), owner);
      for (int i = tid; i < kTile / 4; i += kThreads) reinterpret_cast<float4*>(stage)[i] = src[i];
      D = stage;
    }
    __syncthreads();
    const int I0 = first_row_after(k, rank, kC);
    const int nb_rows = I0 < nt ? (nt - 1 - I0) / kC + 1 : 0;
    for (int t = tid; t < nb_rows * kNb; t += kThreads)
      row_times_diag<true>(tile(I0 + kC * (t / kNb), k), t % kNb, D);
    cluster.sync();

    // (c) the panel column L[k+1:, k] from every rank into staging tiles
    // 1 .. nt-1-k, then the trailing update of this rank's tiles
    const int m = nt - 1 - k;
    float4* pc = reinterpret_cast<float4*>(stage + kTile);
    for (int i = tid; i < m * (kTile / 4); i += kThreads) {
      const int J = k + 1 + i / (kTile / 4);
      pc[i] = remote4(tile(J, k), J % kC)[i % (kTile / 4)];
    }
    __syncthreads();
    auto panel = [&](int J) { return stage + (J - k) * kTile; };
    const bool ahead = (k + 1) % kC == rank;
    if (ahead && warp == 0) {
      if (lane < 16) update_tile(panel(k + 1), panel(k + 1), tile(k + 1, k + 1), lane);
      __syncwarp();
      if (kInverse) ld = *cluster.map_shared_rank(slot, owner);
      diag_chol_inv<kInverse>(tile(k + 1, k + 1), winv(k + 1), ld, lane);
      if (kInverse && lane == 0) {
        *slot = ld;
        if (k + 1 == nt - 1) logdet[b] = ld;
      }
    } else {
      // 16 threads per tile; the look-ahead rank's first tile is warp 0's
      const int groups = ahead ? kGroups - 2 : kGroups;
      int I = I0;
      int off = ahead ? 1 + (tid - 32) / 16 : tid / 16;
      for (walk(I, off, k + 1, 0, nt, kC); I < nt; off += groups, walk(I, off, k + 1, 0, nt, kC))
        update_tile(panel(I), panel(k + 1 + off), tile(I, k + 1 + off), tid & 15);
    }
    cluster.sync();
  }

  if (kInverse) {
    // W = L[I, J] Linv_JJ on every tile of this rank below the diagonal,
    // with every Linv_JJ staged (staging tile J), 16 row tasks per tile
    for (int i = tid; i < (nt - 1) * (kTile / 4); i += kThreads) {
      const int J = i / (kTile / 4);
      reinterpret_cast<float4*>(stage)[i] = remote4(tile(J, J), J % kC)[i % (kTile / 4)];
    }
    __syncthreads();
    {
      int I = rank;
      int off = tid / 16;
      for (walk(I, off, 0, 1, nt, kC); I < nt; off += kGroups, walk(I, off, 0, 1, nt, kC))
        row_times_diag<false>(tile(I, off), tid & 15, stage + off * kTile);
    }
    cluster.sync();
    for (int J = nt - 2; J >= 0; --J) {
      // W[J+1:, J] from every rank into staging tiles 0 .. nt-2-J
      const int m = nt - 1 - J;
      for (int i = tid; i < m * (kTile / 4); i += kThreads) {
        const int M = J + 1 + i / (kTile / 4);
        reinterpret_cast<float4*>(stage)[i] = remote4(tile(M, J), M % kC)[i % (kTile / 4)];
      }
      cluster.sync();  // every rank has read column J: its tiles may change
      // Linv[I, J] = -sum_{M=J+1..I} Linv[I, M] W[M, J]: rows ra + 4u, the
      // four columns of chunk cb
      const int I0 = first_row_after(J, rank, kC);
      const int n = I0 < nt ? (nt - 1 - I0) / kC + 1 : 0;
      for (int t = tid; t < n * 16; t += kThreads) {
        const int I = I0 + kC * (t / 16);
        const int ra = (t >> 2) & 3;
        const int cb = t & 3;
        float acc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
        for (int M = J + 1; M <= I; ++M)
          inv_accumulate(acc, tile(I, M), stage + (M - J - 1) * kTile, ra, cb);
        store_neg(tile(I, J), acc, ra, cb);
      }
      __syncthreads();
    }
  }

  // this rank's rows out, coalesced along each row
  float* Ob = out + static_cast<size_t>(b) * T * T;
  for (int lr = warp; lr < n_rows * kNb; lr += kWarps) {
    const int I = rank + kC * (lr / kNb);
    const int i = I * kNb + lr % kNb;
    if (i >= T) continue;
    for (int c = lane; c < T; c += 32)
      Ob[static_cast<size_t>(i) * T + c] =
          (c <= i) ? tile(I, c / kNb)[elem_off(i % kNb, c % kNb)] : 0.0f;
  }
}

template <int kC, bool kInverse>
cudaError_t configure(int B, int T, void* stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  const int nt = (T + kNb - 1) / kNb;
  const size_t smem = cluster_smem_bytes(nt, kC);
  if (T <= 0 || T > kMaxT || smem > static_cast<size_t>(kMaxBlockSmem))
    return cudaErrorInvalidValue;
  auto kernel = chol_cluster_kernel<kC, kInverse>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kC;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * kC);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int kC, bool kInverse>
int launch(const float* K, float* out, float* logdet, int B, int T, void* stream) {
  if (B <= 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<kC, kInverse>(B, T, stream, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int stage_off = stage_offset((T + kNb - 1) / kNb, kC);
  auto kernel = chol_cluster_kernel<kC, kInverse>;
  err = cudaLaunchKernelEx(&cfg, kernel, K, out, logdet, T, stage_off);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kC, bool kInverse>
int occupancy(int T, int* n_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<kC, kInverse>(1, T, nullptr, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = chol_cluster_kernel<kC, kInverse>;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n_clusters, kernel, &cfg));
}

template <bool kInverse>
int launch_c(const float* K, float* out, float* logdet, int B, int T, int C, void* stream) {
  switch (C) {
    case 2: return launch<2, kInverse>(K, out, logdet, B, T, stream);
    case 4: return launch<4, kInverse>(K, out, logdet, B, T, stream);
    case 8: return launch<8, kInverse>(K, out, logdet, B, T, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K2, 320 < T <= 784, one cluster of C (2, 4 or 8) CTAs per matrix
extern "C" int mallorn_chol_inv_cluster(const float* K, float* Linv, float* logdet, int B,
                                        int T, int C, void* stream) {
  return launch_c<true>(K, Linv, logdet, B, T, C, stream);
}

// K6, 320 < T <= 784
extern "C" int mallorn_chol_cluster(const float* K, float* L, int B, int T, int C,
                                    void* stream) {
  return launch_c<false>(K, L, nullptr, B, T, C, stream);
}

// clusters of C CTAs at width T that the device can hold at once (0: the
// cluster cannot be resident, and a launch would fail)
extern "C" int mallorn_chol_cluster_occupancy(int T, int C, int inverse, int* n_clusters) {
  *n_clusters = 0;
  switch (C * 2 + (inverse ? 1 : 0)) {
    case 5: return occupancy<2, true>(T, n_clusters);
    case 4: return occupancy<2, false>(T, n_clusters);
    case 9: return occupancy<4, true>(T, n_clusters);
    case 8: return occupancy<4, false>(T, n_clusters);
    case 17: return occupancy<8, true>(T, n_clusters);
    case 16: return occupancy<8, false>(T, n_clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
