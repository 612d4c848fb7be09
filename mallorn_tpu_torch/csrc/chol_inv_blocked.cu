// K2 and K6 for T <= 320: the batched Cholesky of the 2D-GP as a blocked,
// register-tiled kernel; with the inverse (K2) it forms Linv in place.
//
// K2 replaces mallorn_tpu/ops/chol_pallas.py:_chol_inv_kernel (:60, behind
// cholesky_inverse_lanes). Contract, per matrix b of a [B, T, T] float32
// row-major batch of SPD matrices (identity on masked rows):
//   Linv = chol(K)^-1 from K's lower triangle (upper triangle exactly 0),
//   logdet[b] = sum_j log(pivot_j), accumulated in column order.
// K6 replaces mallorn_tpu/ops/chol_pallas.py:_chol_kernel (:28, behind
// cholesky_lanes): L = chol(K) alone, row-major with its upper triangle
// exactly 0 and L[j, j] = pivot * rsqrt(pivot), as the Pallas kernel forms it.
// A non-positive pivot gives NaN (rsqrt of a negative) that spreads through
// the rest of that matrix: no early exit, no error. No atomics: two launches
// are bit for bit equal, and a matrix's result does not depend on B.
//
// Bound on an H100: one read of K's lower triangle and one write of the
// result, B (T(T+1)/2 + T^2) 4 bytes, against 2T^3/3 flops per matrix (K2;
// T^3/3 for K6) at the float32 rate outside the tensor cores (TF32 stays
// off): bytes below T of about 180 (K2) or 360 (K6), operations above.
//
// Design: one CTA per matrix. K's lower triangle, padded with identity to
// Tp = 16 ceil(T / 16), lives in dynamic shared memory as nb x nb tiles
// (nb = 16), packed by rows of tiles: Tp (Tp + 16) / 2 floats, one triangle
// (T = 160: 56,320 B; T = 240: 122,880 B; T = 320: 215,040 B, under the
// 232,448 B a block may take; T = 336 would need 236,544 B, and wider
// matrices take the cluster kernel of chol_inv_cluster.cu). K6 adds one
// tile for Linv_kk. Shared memory holds 4 CTAs per SM at T = 160, 2 at
// T = 192 and 1 from T = 240; the registers (128 a thread, 142-166 at 384
// threads) hold 4 CTAs of 128 threads (T <= 128), 2 of 256 (T <= 240) or 1
// of 384 (T > 240). The padding is an identity block: its pivots are 1, it
// adds log 1 = 0 to logdet, and it is never written out, so every T runs
// with no masking inside the loops.
//   Factorisation, panel k = 0 .. nt-1:
//   (a) one warp factors the diagonal tile in registers (lane i holds row i;
//       pivots and columns travel by shuffles, no block barrier; logdet
//       gains log(pivot) column by column), then forms Linv_kk column by
//       column by forward substitution: K2 leaves it in the tile, K6 leaves
//       L_kk there and Linv_kk in its extra tile;
//   (b) the panel below it, L[I, k] = A[I, k] Linv_kk^T, a row per thread,
//       Linv_kk read from shared memory as broadcasts;
//   (c) the trailing update A[I, J] -= L[I, k] L[J, k]^T on the lower
//       triangle of tiles: 16 threads per tile, each holding a 4 x 4 block
//       of A[I, J] in registers and streaming float4 fragments of the two
//       panel tiles (2 FMAs per float loaded; the column loop did one FMA
//       per two loads and a store). Warp 0 looks ahead: it updates the next
//       diagonal tile first and runs (a) on it while the other warps update
//       the rest, so the serial diagonal step hides behind (c). K6's extra
//       tile is rewritten by that (a) only after the barrier that ends
//       panel k's (b), its last reader, so one tile is enough.
//   Inverse (K2 only), block columns J = nt-2 .. 0 from the right, in place:
//       W = L[J+1:, J] Linv_JJ (a row per thread), then
//       Linv[I, J] = -sum_{M=J+1..I} Linv[I, M] W[M, J], each thread's 4 x 4
//       block held in registers across a barrier before it overwrites W.
// That is 2 barriers per panel and 2 per inverse block column (39 at
// T = 160, against 2T = 320 in the column loop it replaced), so the
// barrier chain no longer bounds the kernel, and with one triangle instead
// of two twice as many CTAs fit in an SM's shared memory. K's triangle comes
// in by cp.async, every load of a thread in flight at once. Tiles store
// their float4 chunks swizzled by row (chunk_off), so the rows a quarter
// warp reads at once fall in distinct banks without padding. The tile
// helpers ((a), (b), the 4 x 4 update and the inverse's product) live in
// chol_tiles.cuh, shared with the cluster kernel.

#include "chol_tiles.cuh"

namespace {

constexpr int kMaxT = 320;

// tile (I, J), I >= J, in the row-packed triangle of tiles
__device__ __forceinline__ float* tile(float* s, int I, int J) {
  return s + ((I * (I + 1)) / 2 + J) * kTile;
}

// (c) one task of the trailing update after panel k: 4 x 4 elements of
// tile (I, J) of the lower triangle of tiles below and right of tile (k, k)
__device__ __forceinline__ void trailing_task(float* s, int k, int task) {
  const int p = task >> 4;
  // p -> (I, J), J <= I, of the (nt-1-k)-square block, packed by rows
  int I = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  if (((I + 1) * (I + 2)) / 2 <= p) ++I;
  if ((I * (I + 1)) / 2 > p) --I;
  const int J = p - (I * (I + 1)) / 2;
  update_tile(tile(s, k + 1 + I, k), tile(s, k + 1 + J, k), tile(s, k + 1 + I, k + 1 + J),
              task & 15);
}

// the inverse, in place, after the factorisation (tiles (k, k) hold
// Linv_kk): block columns J from the right, W = L[J+1:, J] Linv_JJ, then
// Linv[I, J] = -sum_{M=J+1..I} Linv[I, M] W[M, J]
template <int kThreads>
__device__ void inverse_in_place(float* s, int nt, int tid) {
  for (int J = nt - 2; J >= 0; --J) {
    const int m = nt - 1 - J;
    for (int row = tid; row < m * kNb; row += kThreads)  // W = L[J+1:, J] Linv_JJ
      row_times_diag<false>(tile(s, J + 1 + row / kNb, J), row % kNb, tile(s, J, J));
    __syncthreads();
    // Linv[I, J] = -sum_{M=J+1..I} Linv[I, M] W[M, J]: rows ra + 4u, the
    // four columns of chunk cb
    const bool active = tid < m * 16;
    const int I = J + 1 + tid / 16;
    const int ra = (tid >> 2) & 3;
    const int cb = tid & 3;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
    if (active) {
      for (int M = J + 1; M <= I; ++M) inv_accumulate(acc, tile(s, I, M), tile(s, M, J), ra, cb);
    }
    __syncthreads();
    if (active) store_neg(tile(s, I, J), acc, ra, cb);
  }
  __syncthreads();
}

// kInverse: K2 (Linv in out, and logdet) or K6 (L in out; logdet unused).
// With the inverse, kThreads >= 16 (nt - 1): its second step holds one
// 4 x 4 block per thread across a barrier; kThreads >= 64: warp 0 looks
// ahead
template <int kThreads, bool kInverse>
__global__ void __launch_bounds__(kThreads)
chol_blocked_kernel(const float* __restrict__ K, float* __restrict__ out,
                    float* __restrict__ logdet, int T) {
  static_assert(kThreads >= 64 && kThreads % 32 == 0, "whole warps, warp 0 and others");
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int nt = (T + kNb - 1) / kNb;
  const int Tp = nt * kNb;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // where (a) leaves Linv_kk for (b): in the diagonal tile (K2) or in the
  // tile after the triangle (K6)
  float* const w = s + (nt * (nt + 1)) / 2 * kTile;
  auto winv = [&](int k) { return kInverse ? tile(s, k, k) : w; };

  // K's lower triangle (coalesced along its rows) by cp.async, so that all
  // of a thread's loads are in flight at once; identity beyond T, zeros
  // above the diagonal of the diagonal tiles
  const float* Kb = K + static_cast<size_t>(b) * T * T;
  for (int i = warp; i < Tp; i += kWarps) {
    const int I = i / kNb;
    for (int c = lane; c < (I + 1) * kNb; c += 32) {
      float* dst = tile(s, I, c / kNb) + elem_off(i % kNb, c % kNb);
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

  float ld = 0.0f;  // warp 0's, in column order
  if (warp == 0) diag_chol_inv<kInverse>(tile(s, 0, 0), winv(0), ld, lane);
  __syncthreads();
  for (int k = 0; k < nt - 1; ++k) {
    const int m = nt - 1 - k;
    for (int row = tid; row < m * kNb; row += kThreads)  // (b)
      row_times_diag<true>(tile(s, k + 1 + row / kNb, k), row % kNb, winv(k));
    __syncthreads();
    // (c), looking ahead: warp 0 updates the next diagonal tile (the first
    // 16 tasks) and runs (a) on it while the other warps update the rest
    if (warp == 0) {
      if (lane < 16) trailing_task(s, k, lane);
      __syncwarp();
      diag_chol_inv<kInverse>(tile(s, k + 1, k + 1), winv(k + 1), ld, lane);
    } else {
      for (int task = 16 + tid - 32; task < (m * (m + 1) / 2) * 16; task += kThreads - 32)
        trailing_task(s, k, task);
    }
    __syncthreads();
  }

  if (kInverse) {
    inverse_in_place<kThreads>(s, nt, tid);
    if (tid == 0) logdet[b] = ld;
  }
  float* Ob = out + static_cast<size_t>(b) * T * T;
  for (int i = warp; i < T; i += kWarps)
    for (int c = lane; c < T; c += 32)
      Ob[static_cast<size_t>(i) * T + c] =
          (c <= i) ? tile(s, i / kNb, c / kNb)[elem_off(i % kNb, c % kNb)] : 0.0f;
}

template <int kThreads, bool kInverse>
int launch(const float* K, float* out, float* logdet, int B, int T, void* stream) {
  const int nt = (T + kNb - 1) / kNb;
  if (kInverse && kThreads < 16 * (nt - 1)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(nt) * (nt + 1) / 2 + (kInverse ? 0 : 1)) * kTile * sizeof(float);
  auto kernel = chol_blocked_kernel<kThreads, kInverse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(K, out, logdet, T);
  return static_cast<int>(cudaGetLastError());
}

// threads per CTA, picked by timing 128 to 512 on an H100: 128 up to
// T = 128 (K6: 160), where more CTAs per SM hide each other's barriers,
// 256 up to T = 240, 384 beyond, where shared memory holds one CTA per SM
// (and the inverse's second step needs 16 (nt - 1), up to 304 threads)
template <bool kInverse>
int launch_width(const float* K, float* out, float* logdet, int B, int T, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (T > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  if (T <= (kInverse ? 128 : 160)) return launch<128, kInverse>(K, out, logdet, B, T, stream);
  if (T <= 240) return launch<256, kInverse>(K, out, logdet, B, T, stream);
  return launch<384, kInverse>(K, out, logdet, B, T, stream);
}

}  // namespace

// K2, T <= 320
extern "C" int mallorn_chol_inv(const float* K, float* Linv, float* logdet,
                                int B, int T, void* stream) {
  return launch_width<true>(K, Linv, logdet, B, T, stream);
}

// K6, T <= 320
extern "C" int mallorn_chol(const float* K, float* L, int B, int T, void* stream) {
  return launch_width<false>(K, L, nullptr, B, T, stream);
}
