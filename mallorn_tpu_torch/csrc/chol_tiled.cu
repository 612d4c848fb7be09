// K2 and K6 for T > 784: the batched Cholesky of the 2D-GP as a tiled,
// right-looking factorisation in a global scratch, spread over every SM by
// a grid of (tile, matrix) CTAs; with the inverse (K2) it then forms Linv
// block column by block column.
//
// K2 replaces mallorn_tpu/ops/chol_pallas.py:_chol_inv_kernel (:60, behind
// cholesky_inverse_lanes), K6 mallorn_tpu/ops/chol_pallas.py:_chol_kernel
// (:28, behind cholesky_lanes). The contract is the blocked kernel's
// (chol_inv_blocked.cu): per matrix b of a [B, T, T] float32 row-major batch
// of SPD matrices (identity on masked rows), K2 gives Linv = chol(K)^-1 from
// K's lower triangle (upper triangle exactly 0) and logdet[b] = sum_j
// log(pivot_j) in column order; K6 gives L = chol(K) alone, its upper
// triangle exactly 0 and L[j, j] = pivot * rsqrt(pivot). A non-positive
// pivot gives NaN that spreads through that matrix only. Every CTA works on
// one matrix and there are no atomics: two launches are bit for bit equal,
// and a matrix's result does not depend on B.
//
// Bound on an H100: B (T(T+1)/2 + T^2) 4 bytes against 2T^3/3 flops per
// matrix (K2; T^3/3 for K6) at the float32 rate outside the tensor cores
// (TF32 stays off): operations above T of about 180 (K2) or 360 (K6).
//
// Design. K's lower triangle is copied into a scratch of [B, Tp, Tp] floats,
// Tp = 64 ceil(T / 64), padded with identity (pack_kernel), and factored in
// place in tiles of nb = 64 (kPanel); after it the scratch holds B [Tp, 64]
// floats for the inverse's W (K2) or Linv_kk (K6). The algorithm is
// chol_cuda.chol_inv_blocked_plain / cholesky_blocked_plain at nb = 64.
// Per panel k, three launches on the stream:
//   (a) diag_kernel, one CTA per matrix: tile (k, k) into shared memory as
//       a triangle of 16 x 16 tiles, factored by the blocked kernel's
//       algorithm at T = 64 (chol_tiles.cuh), then inverted in place to
//       Linv_kk; logdet[b] is the carry, so log(pivot) is summed in column
//       order across panels. K2 leaves Linv_kk in tile (k, k); K6 leaves
//       L_kk there and Linv_kk in the matrix's aux tile;
//   (b) panel_kernel, one CTA per (tile row I > k, matrix):
//       L[I, k] = A[I, k] Linv_kk^T;
//   (c) update_kernel, one CTA per (tile (I, J), k < J <= I, matrix):
//       A[I, J] -= L[I, k] L[J, k]^T.
// Then, for K2, block columns J = nt-2 .. 0 from the right, two launches:
//       inv_w_kernel, one CTA per (I > J, matrix): W_I = L[I, J] Linv_JJ
//       into the aux rows of tile row I (tile (I, J) is overwritten next);
//       inv_sum_kernel, one CTA per (I > J, matrix):
//       Linv[I, J] = -sum_{M=J+1..I} Linv[I, M] W_M, the operand tiles of
//       term M + 1 loaded while term M is summed (two cp.async stages).
// Last, unpack_kernel writes Linv (or L) row-major with its upper triangle 0.
// That is 2 + nt + 2 (nt - 1) launches, and 2 (nt - 1) more for K2
// (chol_cuda.tiled_plan repeats the count): 63 at T = 800, 78 at T = 1024.
//
// What this does about the column loop it replaced (one CTA per matrix, T
// steps of two block barriers, one read-modify-write of global memory per
// FMA): the grid spans tiles x matrices (panel 0's update at T = 800 is 78
// tiles per matrix); the serial chain is nt panels, not T columns; and in
// (b), (c) and the inverse both 64 x 64 operand tiles are staged in shared
// memory by 16-byte cp.async copies and each of 256 threads keeps a 4 x 4
// block of the output in registers, so each float4 loaded from shared
// memory feeds 16 FMAs. Staged rows are padded to 68 floats, so the rows a
// quarter warp reads at once fall in distinct banks.

#include "chol_tiles.cuh"

namespace {

constexpr int kPanel = 64;                     // nb: a tile of the scratch is 64 x 64
constexpr int kSub = kPanel / kNb;             // 16 x 16 tiles per side of a diagonal tile
constexpr int kSubTiles = kSub * (kSub + 1) / 2;
constexpr int kLd = kPanel + 4;                // row stride of a tile staged in shared memory
constexpr int kStaged = kPanel * kLd;          // floats of one staged tile
constexpr int kThreads = 256;                  // (b), (c), the inverse: 16 x 16 threads
constexpr int kDiagThreads = 128;              // (a): the blocked kernel's width at T = 64
constexpr int kCopyThreads = 256;              // pack and unpack: one row per CTA
constexpr int kInvSmemBytes = 4 * kStaged * static_cast<int>(sizeof(float));

// ---------------------------------------------------------------- staging

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// a 64 x 64 tile of global memory (row stride ld floats, 16-byte aligned)
// into shared memory with rows of kLd floats, by 16-byte cp.async copies
__device__ __forceinline__ void stage(float* s, const float* g, size_t ld, int tid) {
  for (int q = tid; q < kPanel * kPanel / 4; q += kThreads) {
    const int r = q >> 4;
    const int c = (q & 15) << 2;
    cp_async16(s + r * kLd + c, g + r * ld + c);
  }
}

__device__ __forceinline__ float4 row4(const float* s, int r, int m) {
  return *reinterpret_cast<const float4*>(s + r * kLd + m);
}

// ---------------------------------------------------------- tile products
// Thread (tr, tc) = (tid / 16, tid % 16) keeps a 4 x 4 block of the 64 x 64
// output in registers.

// acc[u][v] (row tr + 16u, column tc + 16v) += sign sum_m X[row, m] Y[col, m]
template <bool kNegate>
__device__ __forceinline__ void mma_nt(float (&acc)[4][4], const float* X, const float* Y,
                                       int tr, int tc) {
#pragma unroll 2
  for (int m = 0; m < kPanel; m += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = row4(X, tr + 16 * u, m);
#pragma unroll
    for (int v = 0; v < 4; ++v) y[v] = row4(Y, tc + 16 * v, m);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          acc[u][v] = fmaf(kNegate ? -comp(x[u], e) : comp(x[u], e), comp(y[v], e), acc[u][v]);
  }
}

// acc[u][v] (row tr + 16u, column 4tc + v) += sum_m X[row, m] Y[m, col]
__device__ __forceinline__ void mma_nn(float (&acc)[4][4], const float* X, const float* Y,
                                       int tr, int tc) {
#pragma unroll 2
  for (int m = 0; m < kPanel; m += 4) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = row4(X, tr + 16 * u, m);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 y = row4(Y, m + e, 4 * tc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = comp(x[u], e);
        acc[u][0] = fmaf(a, y.x, acc[u][0]);
        acc[u][1] = fmaf(a, y.y, acc[u][1]);
        acc[u][2] = fmaf(a, y.z, acc[u][2]);
        acc[u][3] = fmaf(a, y.w, acc[u][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
}

// scratch tile (I, J) of a matrix's [Tp, Tp] block
__device__ __forceinline__ float* tile_at(float* Ab, int Tp, int I, int J) {
  return Ab + static_cast<size_t>(I) * kPanel * Tp + static_cast<size_t>(J) * kPanel;
}

// ------------------------------------------------------------ pack, unpack

// row i of matrix b: K's lower triangle, identity beyond T, zeros above the
// diagonal, up to the end of the row's diagonal tile
__global__ void __launch_bounds__(kCopyThreads)
pack_kernel(const float* __restrict__ K, float* __restrict__ A, int T, int Tp) {
  const int i = blockIdx.x;
  const size_t b = blockIdx.y;
  const float* Ki = K + (b * T + i) * T;
  float* Ai = A + (b * Tp + i) * Tp;
  const int end = (i / kPanel + 1) * kPanel;
  for (int c = threadIdx.x; c < end; c += kCopyThreads)
    Ai[c] = (i < T && c <= i) ? Ki[c] : (c == i ? 1.0f : 0.0f);
}

__global__ void __launch_bounds__(kCopyThreads)
unpack_kernel(const float* __restrict__ A, float* __restrict__ out, int T, int Tp) {
  const int i = blockIdx.x;
  const size_t b = blockIdx.y;
  const float* Ai = A + (b * Tp + i) * Tp;
  float* Oi = out + (b * T + i) * T;
  for (int c = threadIdx.x; c < T; c += kCopyThreads) Oi[c] = (c <= i) ? Ai[c] : 0.0f;
}

// ------------------------------------------------- (a) the diagonal tile

// 16 x 16 tile (I, J), J <= I, of the row-packed triangle in shared memory
__device__ __forceinline__ float* sub(float* s, int I, int J) {
  return s + ((I * (I + 1)) / 2 + J) * kTile;
}

// the triangle's Cholesky-inverse in place (its diagonal tiles hold the
// inverses of theirs): the blocked kernel's inverse_in_place at nt = kSub
__device__ void sub_inverse(float* s, int tid) {
  for (int J = kSub - 2; J >= 0; --J) {
    const int m = kSub - 1 - J;
    for (int row = tid; row < m * kNb; row += kDiagThreads)  // W = L[J+1:, J] Linv_JJ
      row_times_diag<false>(sub(s, J + 1 + row / kNb, J), row % kNb, sub(s, J, J));
    __syncthreads();
    const bool active = tid < m * 16;
    const int I = J + 1 + tid / 16;
    const int ra = (tid >> 2) & 3;
    const int cb = tid & 3;
    float acc[4][4];
    zero(acc);
    if (active) {
      for (int M = J + 1; M <= I; ++M) inv_accumulate(acc, sub(s, I, M), sub(s, M, J), ra, cb);
    }
    __syncthreads();
    if (active) store_neg(sub(s, I, J), acc, ra, cb);
  }
  __syncthreads();
}

// the triangle's lower triangle (upper triangle 0) into a row-major 64 x 64
// tile of global memory with row stride ld
__device__ __forceinline__ void sub_store(float* s, float* g, size_t ld, int tid) {
  for (int e = tid; e < kPanel * kPanel; e += kDiagThreads) {
    const int r = e / kPanel;
    const int c = e % kPanel;
    g[r * ld + c] = (c <= r) ? sub(s, r / kNb, c / kNb)[elem_off(r % kNb, c % kNb)] : 0.0f;
  }
}

// aux: the matrix's [Tp, 64] rows after the scratch; K6 keeps Linv_kk in its
// first tile. logdet (K2) is the running sum in column order.
template <bool kInverse>
__global__ void __launch_bounds__(kDiagThreads)
diag_kernel(float* __restrict__ A, float* __restrict__ aux, float* __restrict__ logdet, int Tp,
            int k) {
  // the triangle of 16 x 16 tiles and, for K6, the inverses of its
  // diagonal tiles
  __shared__ __align__(16) float s[(kSubTiles + (kInverse ? 0 : kSub)) * kTile];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* Ab = A + static_cast<size_t>(b) * Tp * Tp;
  float* g = tile_at(Ab, Tp, k, k);
  auto winv = [&](int j) { return kInverse ? sub(s, j, j) : s + (kSubTiles + j) * kTile; };

  for (int e = tid; e < kPanel * kPanel; e += kDiagThreads) {
    const int r = e / kPanel;
    const int c = e % kPanel;
    if (c / kNb <= r / kNb)
      sub(s, r / kNb, c / kNb)[elem_off(r % kNb, c % kNb)] =
          (c <= r) ? g[static_cast<size_t>(r) * Tp + c] : 0.0f;
  }
  __syncthreads();

  float ld = (kInverse && k > 0) ? logdet[b] : 0.0f;  // warp 0's, in column order
  for (int j = 0; j < kSub; ++j) {
    if (warp == 0) diag_chol_inv<kInverse>(sub(s, j, j), winv(j), ld, lane);
    __syncthreads();
    const int m = kSub - 1 - j;
    for (int row = tid; row < m * kNb; row += kDiagThreads)
      row_times_diag<true>(sub(s, j + 1 + row / kNb, j), row % kNb, winv(j));
    __syncthreads();
    for (int task = tid; task < (m * (m + 1) / 2) * 16; task += kDiagThreads) {
      const int p = task >> 4;
      int I = 0;
      while (((I + 1) * (I + 2)) / 2 <= p) ++I;
      const int J = p - (I * (I + 1)) / 2;
      update_tile(sub(s, j + 1 + I, j), sub(s, j + 1 + J, j), sub(s, j + 1 + I, j + 1 + J),
                  task & 15);
    }
    __syncthreads();
  }

  if (kInverse) {
    if (tid == 0) logdet[b] = ld;
  } else {
    sub_store(s, g, Tp, tid);  // L_kk
    __syncthreads();
    // the diagonal tiles' inverses in place of their L, for Linv_kk
    for (int e = tid; e < kSub * kTile; e += kDiagThreads)
      sub(s, e / kTile, e / kTile)[e % kTile] = s[kSubTiles * kTile + e];
    __syncthreads();
  }
  sub_inverse(s, tid);
  sub_store(s, kInverse ? g : aux + static_cast<size_t>(b) * Tp * kPanel,
            kInverse ? Tp : kPanel, tid);
}

// --------------------------------------------------------- (b) the panel

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
panel_kernel(float* __restrict__ A, const float* __restrict__ aux, int Tp, int k) {
  __shared__ __align__(16) float sx[kStaged];
  __shared__ __align__(16) float sy[kStaged];
  const int I = k + 1 + blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  float* Ab = A + static_cast<size_t>(b) * Tp * Tp;
  float* X = tile_at(Ab, Tp, I, k);
  stage(sx, X, Tp, tid);
  if (kInverse)
    stage(sy, tile_at(Ab, Tp, k, k), Tp, tid);
  else
    stage(sy, aux + static_cast<size_t>(b) * Tp * kPanel, kPanel, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc[4][4];
  zero(acc);
  mma_nt<false>(acc, sx, sy, tr, tc);  // A[I, k] Linv_kk^T
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) X[static_cast<size_t>(tr + 16 * u) * Tp + tc + 16 * v] = acc[u][v];
}

// ------------------------------------------------ (c) the trailing update

__global__ void __launch_bounds__(kThreads)
update_kernel(float* __restrict__ A, int Tp, int k) {
  __shared__ __align__(16) float sx[kStaged];
  __shared__ __align__(16) float sy[kStaged];
  // blockIdx.x -> (i, j), j <= i, of the trailing triangle, packed by rows
  const int p = blockIdx.x;
  int i = 0;
  while (((i + 1) * (i + 2)) / 2 <= p) ++i;
  const int I = k + 1 + i;
  const int J = k + 1 + p - (i * (i + 1)) / 2;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  float* Ab = A + static_cast<size_t>(b) * Tp * Tp;
  stage(sx, tile_at(Ab, Tp, I, k), Tp, tid);
  stage(sy, tile_at(Ab, Tp, J, k), Tp, tid);
  cp_async_commit();
  float* C = tile_at(Ab, Tp, I, J);
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = C[static_cast<size_t>(tr + 16 * u) * Tp + tc + 16 * v];
  cp_async_wait<0>();
  __syncthreads();
  mma_nt<true>(acc, sx, sy, tr, tc);  // A[I, J] - L[I, k] L[J, k]^T
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) C[static_cast<size_t>(tr + 16 * u) * Tp + tc + 16 * v] = acc[u][v];
}

// ------------------------------------------------------- the inverse (K2)

// W_I = L[I, J] Linv_JJ into the aux rows of tile row I
__global__ void __launch_bounds__(kThreads)
inv_w_kernel(float* __restrict__ A, float* __restrict__ aux, int Tp, int J) {
  __shared__ __align__(16) float sx[kStaged];
  __shared__ __align__(16) float sy[kStaged];
  const int I = J + 1 + blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  float* Ab = A + static_cast<size_t>(b) * Tp * Tp;
  stage(sx, tile_at(Ab, Tp, I, J), Tp, tid);
  stage(sy, tile_at(Ab, Tp, J, J), Tp, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc[4][4];
  zero(acc);
  mma_nn(acc, sx, sy, tr, tc);
  float* W = aux + (static_cast<size_t>(b) * Tp + static_cast<size_t>(I) * kPanel) * kPanel;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    *reinterpret_cast<float4*>(W + (tr + 16 * u) * kPanel + 4 * tc) =
        make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
}

// Linv[I, J] = -sum_{M=J+1..I} Linv[I, M] W_M; the tiles of term M + 1 are
// staged while term M is summed
__global__ void __launch_bounds__(kThreads)
inv_sum_kernel(float* __restrict__ A, const float* __restrict__ aux, int Tp, int J) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);  // two stages of (Linv[I, M], W_M)
  const int I = J + 1 + blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  float* Ab = A + static_cast<size_t>(b) * Tp * Tp;
  const float* Wb = aux + static_cast<size_t>(b) * Tp * kPanel;
  auto load = [&](int M, int stage_id) {
    float* st = s + stage_id * 2 * kStaged;
    stage(st, tile_at(Ab, Tp, I, M), Tp, tid);
    stage(st + kStaged, Wb + static_cast<size_t>(M) * kPanel * kPanel, kPanel, tid);
    cp_async_commit();
  };
  float acc[4][4];
  zero(acc);
  load(J + 1, 0);
  for (int M = J + 1; M <= I; ++M) {
    const int cur = (M - J - 1) & 1;
    if (M < I) {
      load(M + 1, cur ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = s + cur * 2 * kStaged;
    mma_nn(acc, st, st + kStaged, tr, tc);
    __syncthreads();  // this stage is loaded again two terms on
  }
  float* C = tile_at(Ab, Tp, I, J);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    *reinterpret_cast<float4*>(C + static_cast<size_t>(tr + 16 * u) * Tp + 4 * tc) =
        make_float4(-acc[u][0], -acc[u][1], -acc[u][2], -acc[u][3]);
}

// -------------------------------------------------------------- host side

// scratch: B Tp (Tp + 64) floats (chol_cuda.tiled_scratch_floats);
// n_launches: the kernels launched, checked by the caller against
// chol_cuda.tiled_plan
template <bool kInverse>
int launch_tiled(const float* K, float* out, float* logdet, float* scratch, int B, int T,
                 int* n_launches, void* stream_ptr) {
  *n_launches = 0;
  if (B <= 0 || T <= 0) return 0;
  if (scratch == nullptr || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int nt = (T + kPanel - 1) / kPanel;
  const int Tp = nt * kPanel;
  float* A = scratch;
  float* aux = scratch + static_cast<size_t>(B) * Tp * Tp;
  int n = 0;
  cudaError_t err = cudaSuccess;
  auto launched = [&]() {
    err = cudaGetLastError();
    ++n;
    return err == cudaSuccess;
  };

  pack_kernel<<<dim3(Tp, B), kCopyThreads, 0, stream>>>(K, A, T, Tp);
  if (!launched()) return static_cast<int>(err);
  for (int k = 0; k < nt; ++k) {
    diag_kernel<kInverse><<<B, kDiagThreads, 0, stream>>>(A, aux, logdet, Tp, k);
    if (!launched()) return static_cast<int>(err);
    const int m = nt - 1 - k;
    if (m == 0) break;
    panel_kernel<kInverse><<<dim3(m, B), kThreads, 0, stream>>>(A, aux, Tp, k);
    if (!launched()) return static_cast<int>(err);
    update_kernel<<<dim3(m * (m + 1) / 2, B), kThreads, 0, stream>>>(A, Tp, k);
    if (!launched()) return static_cast<int>(err);
  }
  if (kInverse) {
    err = cudaFuncSetAttribute(inv_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kInvSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int J = nt - 2; J >= 0; --J) {
      const int m = nt - 1 - J;
      inv_w_kernel<<<dim3(m, B), kThreads, 0, stream>>>(A, aux, Tp, J);
      if (!launched()) return static_cast<int>(err);
      inv_sum_kernel<<<dim3(m, B), kThreads, kInvSmemBytes, stream>>>(A, aux, Tp, J);
      if (!launched()) return static_cast<int>(err);
    }
  }
  unpack_kernel<<<dim3(T, B), kCopyThreads, 0, stream>>>(A, out, T, Tp);
  if (!launched()) return static_cast<int>(err);
  *n_launches = n;
  return 0;
}

}  // namespace

// K2, T > 784
extern "C" int mallorn_chol_inv_tiled(const float* K, float* Linv, float* logdet,
                                      float* scratch, int B, int T, int* n_launches,
                                      void* stream) {
  return launch_tiled<true>(K, Linv, logdet, scratch, B, T, n_launches, stream);
}

// K6, T > 784
extern "C" int mallorn_chol_tiled(const float* K, float* L, float* scratch, int B, int T,
                                  int* n_launches, void* stream) {
  return launch_tiled<false>(K, L, nullptr, scratch, B, T, n_launches, stream);
}

extern "C" const char* mallorn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
