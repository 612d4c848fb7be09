// Per-level (grad, hess) histograms of the depthwise GBDT, batched over folds.
//
// Replaces mallorn_tpu/ops/hist_pallas.py:_fullhot_kernel (the Pallas
// kernel behind build_histograms_fullhot). Contract, for fold k, feature f,
// node c < k_nodes and bin b < n_bins_tot:
//   out[k, f, c, b, :] = sum_r [node_q[k, r] == c] [binned[k, f, r] == b]
//                        (gh[k, r, 0], gh[k, r, 1])
// Inputs: binned [K, F, N] int16, node_q [K, N] int32 (k_nodes or any id
// outside [0, k_nodes) = inactive row), gh [K, N, 2] float32, and
// maxabs [K, 2] float32 = max_r |gh[k, r, :]|. Output [K, F, k_nodes,
// n_bins_tot, 2] float32. Bin n_bins_tot - 1 is the missing bin; a bin id
// outside [0, n_bins_tot) is skipped like an inactive row.
//
// The TPU kernel scatters through the MXU: an int8 full-bin one-hot times
// bf16x3 digits of (g, h). None of that carries over. Here each CTA owns
// one (fold, feature), walks the fold's rows once and accumulates into a
// [k_nodes, n_bins_tot, 2] histogram in shared memory (k_nodes = 8,
// the deepest level with subtraction: 32,896 B).
//
// Determinism: float atomics add in an order that changes from launch to
// launch, and a flipped last bit flips knife-edge splits. The CTA adds in
// 64-bit fixed point instead: g (and h) is scaled by S = 2^(62 - ceil(log2
// N) - e), where max|g| < 2^e for the fold, rounded to the nearest integer
// and added with integer atomics, which are exact and order-free; the
// integer sum (|sum| < 2^63 by the choice of S) is converted once to
// double, divided by S and rounded to float32. Each row's rounding is at
// most 1/(2S), so a cell is within N/(2S) <= max|g| * 2^(2 ceil(log2 N) - 62)
// of the exact sum before the final float32 rounding (N = 8,143:
// 1.5e-11 * max|g|): the result is the exact sum to within one float32 ulp,
// bit-identical from launch to launch. A fold whose g or h holds a
// non-finite value gets NaN in every cell (fixed point cannot carry it).
//
// Bound on an H100: the bins are read once (K F N 2 bytes), node ids and
// (g, h) once per fold (they stay in L2 across the fold's F CTAs), the
// histograms written once. At the v92d CV's shape (K = 5, F = 222, N =
// 2,444, k_nodes = 8) that is 5.4 MB in and 18.3 MB out: ~7 us at
// 3.35 TB/s. This first version spends its time on shared-memory atomics
// (two per row and feature, serialised where rows share a bin) and on
// zeroing and writing the whole histogram even where it is sparse.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ double fixed_scale(float maxabs, int log2n) {
  if (!(maxabs > 0.0f)) return 1.0;
  int e;
  frexpf(maxabs, &e);  // maxabs < 2^e
  return ldexp(1.0, 62 - log2n - e);
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int16_t* __restrict__ binned, const int32_t* __restrict__ node_q,
            const float2* __restrict__ gh, const float* __restrict__ maxabs,
            float* __restrict__ out, int F, int N, int k_nodes, int n_bins_tot,
            int log2n) {
  extern __shared__ unsigned long long acc[];
  const int f = blockIdx.x;
  const int k = blockIdx.y;
  const int cells = k_nodes * n_bins_tot * 2;
  for (int i = threadIdx.x; i < cells; i += kThreads) acc[i] = 0ull;

  const float mg = maxabs[2 * k], mh = maxabs[2 * k + 1];
  const bool finite = isfinite(mg) && isfinite(mh);
  const double sg = fixed_scale(mg, log2n), sh = fixed_scale(mh, log2n);
  __syncthreads();

  if (finite) {
    const int16_t* b = binned + (static_cast<size_t>(k) * F + f) * N;
    const int32_t* nq = node_q + static_cast<size_t>(k) * N;
    const float2* v = gh + static_cast<size_t>(k) * N;
    for (int r = threadIdx.x; r < N; r += kThreads) {
      const int c = nq[r];
      const int bin = b[r];
      if (static_cast<unsigned>(c) < static_cast<unsigned>(k_nodes) &&
          static_cast<unsigned>(bin) < static_cast<unsigned>(n_bins_tot)) {
        const float2 x = v[r];
        const long long qg = __double2ll_rn(static_cast<double>(x.x) * sg);
        const long long qh = __double2ll_rn(static_cast<double>(x.y) * sh);
        unsigned long long* cell = acc + 2 * (c * n_bins_tot + bin);
        atomicAdd(cell, static_cast<unsigned long long>(qg));
        atomicAdd(cell + 1, static_cast<unsigned long long>(qh));
      }
    }
  }
  __syncthreads();

  float* o = out + (static_cast<size_t>(k) * F + f) * cells;
  const double ig = 1.0 / sg, ih = 1.0 / sh;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const double s = static_cast<double>(static_cast<long long>(acc[i]));
    o[i] = finite ? static_cast<float>(s * ((i & 1) ? ih : ig)) : __int_as_float(0x7fc00000);
  }
}

}  // namespace

extern "C" int mallorn_hist(const int16_t* binned, const int32_t* node_q,
                            const float* gh, const float* maxabs, float* out,
                            int K, int F, int N, int k_nodes, int n_bins_tot,
                            void* stream) {
  if (K <= 0 || F <= 0 || k_nodes <= 0 || n_bins_tot <= 0) return 0;
  const size_t smem = static_cast<size_t>(k_nodes) * n_bins_tot * 2 *
                      sizeof(unsigned long long);
  if (smem > static_cast<size_t>(kMaxSmemBytes) || K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2n = 0;
  while ((1LL << log2n) < static_cast<long long>(N)) ++log2n;
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(F, K);
  hist_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      binned, node_q, reinterpret_cast<const float2*>(gh), maxabs, out, F, N,
      k_nodes, n_bins_tot, log2n);
  return static_cast<int>(cudaGetLastError());
}
