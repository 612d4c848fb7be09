// Batched Cholesky factorisation as a column loop: K2's wide path
// (T > 240) and K6 at every width. K2 at T <= 240 is the blocked kernel of
// chol_inv_blocked.cu.
//
// K2 replaces mallorn_tpu/ops/chol_pallas.py:_chol_inv_kernel (the Pallas
// kernel behind cholesky_inverse_lanes). Contract, per matrix b of a
// [B, T, T] float32 row-major batch of SPD matrices (identity on masked
// rows):
//   L = chol(K) from K's lower triangle, Linv = L^-1 (upper triangle 0),
//   logdet[b] = sum_j log(pivot_j), accumulated in column order.
// A non-positive pivot gives NaN (rsqrt of a negative) that propagates
// through the rest of the matrix: no early exit, no error.
//
// The column loop (chol_kernel): one CTA per matrix; step j of the
// right-looking loop (the Pallas kernel's fori_loop) is
//   1. d = rsqrt(A[j,j]); scale column j of A by d (-> L[:, j]); with the
//      inverse, scale row j of X = Linv by d -- that row is final;
//   2. trailing update A[i,c] -= L[i,j] L[c,j] (j < c <= i) and, with the
//      inverse, forward substitution X[i,k] -= L[i,j] X[j,k] (i > j, k <= j).
// A is the trailing Schur complement, lower triangle, packed column-major
// (column c holds rows c..T-1 contiguously), overwritten by L; X is packed
// row-major. Both phases read along contiguous packed runs, so a warp's 32
// lanes touch 32 consecutive words; two __syncthreads per column. L[j,j]
// itself is never needed again by the inverse, so it is not written back
// there. Every FMA is a shared- or global-memory read-modify-write behind
// 2T block-wide barriers: the loop is bound by that traffic and the barrier
// chain, not by HBM. Its shared-memory path with the inverse (both
// triangles in shared memory) is not instantiated: K2 at T <= 240 is the
// blocked kernel.
//
// T > 240 (chol_inv_large_kernel): the same loop, with Linv built in place
// in the output (row-major, its upper triangle never touched after the
// identity is written) and A as a packed triangle in a global-memory
// scratch of T(T+1)/2 floats per matrix that the caller allocates. Both
// the Schur update and the forward substitution then read and write
// through L1/L2 (T^3/6 read-modify-writes each per matrix), so this
// variant is bound by cache bandwidth; the caller launches it on about one
// matrix per SM at a time, so that the working sets stay in L2. It exists
// so that any object width runs, as the reference's does. Bound on an
// H100: K's lower triangle in, Linv out (B (T(T+1)/2 + T^2) 4 bytes)
// against 2T^3/3 flops per matrix; operations above T of about 180.

// K6 replaces mallorn_tpu/ops/chol_pallas.py:_chol_kernel (the Pallas
// kernel behind cholesky_lanes): L = chol(K) alone, row-major with its
// upper triangle exactly 0, L[j, j] = pivot * rsqrt(pivot) as the Pallas
// kernel forms it; NaN from a non-positive pivot on, in that matrix only.
// It is the same kernel (chol_kernel) with the inverse switched off: A
// alone in shared memory (T(T+1)/2 floats) for T <= 240, in the global
// scratch beyond; the diagonal is written back in phase 2 (no thread reads
// A[j, j] there) and L goes out once, at the end. Bound: K's lower
// triangle in, L out (B (T(T+1)/2 + T^2) 4 bytes), T^3/3 flops per matrix.

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kMaxSmemBytes = 232448;

// start of column c in the packed column-major lower triangle; element
// (i, c), i >= c, lives at col_base(c, T) + (i - c)
__device__ __forceinline__ int col_base(int c, int T) {
  return c * T - (c * (c - 1)) / 2;
}

// start of row i in the packed row-major lower triangle
__device__ __forceinline__ int row_base(int i) { return (i * (i + 1)) / 2; }

// kThreadsY rows of 32 threads; small matrices take fewer threads per
// block so more blocks share an SM and hide each other's barriers.
// kInverse: K2 (Linv and logdet) or K6 (L). kShared: A (and X) in dynamic
// shared memory (T <= 240), or A in scratch[b] and X in the output.
template <int kThreadsY, bool kInverse, bool kShared>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
chol_kernel(const float* __restrict__ K, float* __restrict__ out,
            float* __restrict__ logdet, float* __restrict__ scratch, int T) {
  constexpr int kThreads = kThreadsX * kThreadsY;
  extern __shared__ float smem[];
  const int tri = (T * (T + 1)) / 2;
  const int b = blockIdx.x;
  const float* Kb = K + static_cast<size_t>(b) * T * T;
  float* Ob = out + static_cast<size_t>(b) * T * T;
  float* A = kShared ? smem : scratch + static_cast<size_t>(b) * tri;
  float* X = kShared ? smem + tri : Ob;  // Linv in progress (kInverse)
  // start of row i of X: packed in shared memory, full rows in the output
  auto xrow = [T](int i) { return kShared ? row_base(i) : i * T; };
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;

  // K's lower triangle into A (coalesced along each row of K); X = I,
  // over whole rows when X is the output
  for (int i = ty; i < T; i += kThreadsY) {
    const int cols = (kInverse && !kShared) ? T : i + 1;
    for (int c = tx; c < cols; c += kThreadsX) {
      if (c <= i) A[col_base(c, T) + i - c] = Kb[static_cast<size_t>(i) * T + c];
      if (kInverse) X[xrow(i) + c] = (i == c) ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  float ld = 0.0f;
  for (int j = 0; j < T; ++j) {
    const int cj = col_base(j, T);
    const float piv = A[cj];
    const float d = rsqrtf(piv);

    // phase 1: column j of L (rows below the pivot); with the inverse,
    // row j of Linv is final (in shared memory it goes to the output here,
    // zeros above the diagonal included)
    for (int i = j + 1 + tid; i < T; i += kThreads) A[cj + i - j] *= d;
    if (kInverse) {
      float* xj = X + xrow(j);
      if (kShared) {
        for (int k = tid; k < T; k += kThreads) {
          float v = 0.0f;
          if (k <= j) {
            v = xj[k] * d;
            xj[k] = v;
          }
          Ob[static_cast<size_t>(j) * T + k] = v;
        }
      } else {
        for (int k = tid; k <= j; k += kThreads) xj[k] *= d;
      }
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
      const float* xj = X + xrow(j);
      for (int i = j + 1 + ty; i < T; i += kThreadsY) {
        const float lij = colj[i];
        float* xi = X + xrow(i);
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

template <int kThreadsY, bool kInverse, bool kShared>
int launch(const float* K, float* out, float* logdet, float* scratch, int B, int T,
           size_t smem, void* stream) {
  auto kernel = chol_kernel<kThreadsY, kInverse, kShared>;
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kThreadsX, kThreadsY);
  kernel<<<B, block, smem, static_cast<cudaStream_t>(stream)>>>(K, out, logdet, scratch, T);
  return static_cast<int>(cudaGetLastError());
}

// T <= 240: the matrix in shared memory, T(T + 1) floats with the inverse,
// T(T + 1) / 2 without
template <bool kInverse>
int launch_shared(const float* K, float* out, float* logdet, int B, int T, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const size_t smem = static_cast<size_t>(T) * (T + 1) / (kInverse ? 1 : 2) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 64) return launch<4, kInverse, true>(K, out, logdet, nullptr, B, T, smem, stream);
  if (T <= 96) return launch<8, kInverse, true>(K, out, logdet, nullptr, B, T, smem, stream);
  return launch<16, kInverse, true>(K, out, logdet, nullptr, B, T, smem, stream);
}

// T > 240: A in scratch (B * T(T+1)/2 floats), X in the output
template <bool kInverse>
int launch_wide(const float* K, float* out, float* logdet, float* scratch, int B, int T,
                void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<16, kInverse, false>(K, out, logdet, scratch, B, T, 0, stream);
}

}  // namespace

// K2, T > 240; scratch: B * T(T+1)/2 floats
extern "C" int mallorn_chol_inv_large(const float* K, float* Linv, float* logdet,
                                      float* scratch, int B, int T, void* stream) {
  return launch_wide<true>(K, Linv, logdet, scratch, B, T, stream);
}

// K6, T > 240; scratch: B * T(T+1)/2 floats
extern "C" int mallorn_chol_large(const float* K, float* L, float* scratch, int B, int T,
                                  void* stream) {
  return launch_wide<false>(K, L, nullptr, scratch, B, T, stream);
}

// K6, T <= 240
extern "C" int mallorn_chol(const float* K, float* L, int B, int T, void* stream) {
  return launch_shared<false>(K, L, nullptr, B, T, stream);
}

extern "C" const char* mallorn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
