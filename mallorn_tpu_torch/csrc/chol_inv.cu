// Batched Cholesky factorisation as a column loop in a global scratch: K2
// and K6 for T > 784, wider than the shared-memory kernels can hold (the
// blocked kernel of chol_inv_blocked.cu serves T <= 320, the cluster kernel
// of chol_inv_cluster.cu 320 < T <= 784).
//
// K2 replaces mallorn_tpu/ops/chol_pallas.py:_chol_inv_kernel (the Pallas
// kernel behind cholesky_inverse_lanes). Contract, per matrix b of a
// [B, T, T] float32 row-major batch of SPD matrices (identity on masked
// rows):
//   L = chol(K) from K's lower triangle, Linv = L^-1 (upper triangle 0),
//   logdet[b] = sum_j log(pivot_j), accumulated in column order.
// K6 replaces mallorn_tpu/ops/chol_pallas.py:_chol_kernel (the Pallas
// kernel behind cholesky_lanes): L = chol(K) alone, row-major with its
// upper triangle exactly 0, L[j, j] = pivot * rsqrt(pivot) as the Pallas
// kernel forms it.
// A non-positive pivot gives NaN (rsqrt of a negative) that propagates
// through the rest of the matrix: no early exit, no error.
//
// The column loop (chol_kernel): one CTA per matrix; step j of the
// right-looking loop (the Pallas kernel's fori_loop) is
//   1. d = rsqrt(A[j,j]); scale column j of A by d (-> L[:, j]); with the
//      inverse, scale row j of X = Linv by d -- that row is final;
//   2. trailing update A[i,c] -= L[i,j] L[c,j] (j < c <= i) and, with the
//      inverse, forward substitution X[i,k] -= L[i,j] X[j,k] (i > j, k <= j);
//      without it, L[j, j] = pivot * d is written back (no thread reads
//      A[j, j] in this phase), and L goes out once, at the end.
// A is the trailing Schur complement, lower triangle, packed column-major
// (column c holds rows c..T-1 contiguously) in a global-memory scratch of
// T(T+1)/2 floats per matrix that the caller allocates, overwritten by L;
// X = Linv is built in place in the output (row-major, its upper triangle
// never touched after the identity is written). Both phases read along
// contiguous packed runs, so a warp's 32 lanes touch 32 consecutive words;
// two __syncthreads per column. Every FMA is a read-modify-write through
// L1/L2 (T^3/6 each for the Schur update and the forward substitution per
// matrix) behind 2T block-wide barriers, so the loop is bound by cache
// bandwidth and the barrier chain, not by HBM; the caller launches it on
// about one matrix per SM at a time, so that the working sets stay in L2.
// It exists so that any object width runs, as the reference's does. Bound
// on an H100: K's lower triangle in, Linv (or L) out (B (T(T+1)/2 + T^2) 4
// bytes) against 2T^3/3 flops per matrix (T^3/3 for K6); operations above T
// of about 180 (K2) or 360 (K6).

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 16;

// start of column c in the packed column-major lower triangle; element
// (i, c), i >= c, lives at col_base(c, T) + (i - c)
__device__ __forceinline__ int col_base(int c, int T) {
  return c * T - (c * (c - 1)) / 2;
}

// kThreadsY rows of 32 threads. kInverse: K2 (Linv and logdet) or K6 (L).
template <bool kInverse>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
chol_kernel(const float* __restrict__ K, float* __restrict__ out,
            float* __restrict__ logdet, float* __restrict__ scratch, int T) {
  constexpr int kThreads = kThreadsX * kThreadsY;
  const int tri = (T * (T + 1)) / 2;
  const int b = blockIdx.x;
  const float* Kb = K + static_cast<size_t>(b) * T * T;
  float* Ob = out + static_cast<size_t>(b) * T * T;
  float* A = scratch + static_cast<size_t>(b) * tri;
  float* X = Ob;  // Linv in progress (kInverse)
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;

  // K's lower triangle into A (coalesced along each row of K); X = I over
  // whole rows
  for (int i = ty; i < T; i += kThreadsY) {
    const int cols = kInverse ? T : i + 1;
    for (int c = tx; c < cols; c += kThreadsX) {
      if (c <= i) A[col_base(c, T) + i - c] = Kb[static_cast<size_t>(i) * T + c];
      if (kInverse) X[i * T + c] = (i == c) ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  float ld = 0.0f;
  for (int j = 0; j < T; ++j) {
    const int cj = col_base(j, T);
    const float piv = A[cj];
    const float d = rsqrtf(piv);

    // phase 1: column j of L (rows below the pivot); with the inverse,
    // row j of Linv is final
    for (int i = j + 1 + tid; i < T; i += kThreads) A[cj + i - j] *= d;
    if (kInverse) {
      float* xj = X + j * T;
      for (int k = tid; k <= j; k += kThreads) xj[k] *= d;
      if (tid == 0) ld += logf(piv);
    }
    __syncthreads();

    // phase 2: trailing Schur update, one column of A per row of threads
    const float* colj = A + cj - j;  // colj[i] = L[i, j]
    for (int c = j + 1 + ty; c < T; c += kThreadsY) {
      const float lc = colj[c];
      float* colc = A + col_base(c, T) - c;  // colc[i] = A[i, c]
      for (int i = c + tx; i < T; i += kThreadsX) colc[i] -= colj[i] * lc;
    }
    if (kInverse) {
      // forward substitution into the rows of Linv below j
      const float* xj = X + j * T;
      for (int i = j + 1 + ty; i < T; i += kThreadsY) {
        const float lij = colj[i];
        float* xi = X + i * T;
        for (int k = tx; k <= j; k += kThreadsX) xi[k] -= lij * xj[k];
      }
    } else if (tid == 0) {
      A[cj] = piv * d;  // L[j, j]
    }
    __syncthreads();
  }
  if (kInverse) {
    if (tid == 0) logdet[b] = ld;
  } else {
    for (int i = ty; i < T; i += kThreadsY)
      for (int c = tx; c < T; c += kThreadsX)
        Ob[static_cast<size_t>(i) * T + c] = (c <= i) ? A[col_base(c, T) + i - c] : 0.0f;
  }
}

// scratch: B * T(T+1)/2 floats
template <bool kInverse>
int launch(const float* K, float* out, float* logdet, float* scratch, int B, int T,
           void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreadsX, kThreadsY);
  chol_kernel<kInverse><<<B, block, 0, static_cast<cudaStream_t>(stream)>>>(
      K, out, logdet, scratch, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2, T > 784; scratch: B * T(T+1)/2 floats
extern "C" int mallorn_chol_inv_large(const float* K, float* Linv, float* logdet,
                                      float* scratch, int B, int T, void* stream) {
  return launch<true>(K, Linv, logdet, scratch, B, T, stream);
}

// K6, T > 784; scratch: B * T(T+1)/2 floats
extern "C" int mallorn_chol_large(const float* K, float* L, float* scratch, int B, int T,
                                  void* stream) {
  return launch<false>(K, L, nullptr, scratch, B, T, stream);
}

extern "C" const char* mallorn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
