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

//
// seg_hist_kernel: the segment histograms of the leaf-wise fit. Replaces
// mallorn_tpu/ops/hist_pallas.py:_hist_kernel (the Pallas kernel behind
// build_histograms_pallas, K3), with a leading lane axis. Contract, for
// lane k, feature f and segment s < n_seg:
//   out[k, f, s, :] = sum_r [seg_base[k, r] + binned[k, f, r] == s] gh[k, r, :]
// Inputs: binned [K, F, N] int16, seg_base [K, N] int32 (a row's node
// times n_bins_tot; a row whose seg_base is outside [0, n_seg), or whose
// bin is negative, is inactive), gh [K, N, 2] float32, maxabs [K, 2].
// Output [K, F, n_seg, 2]
// float32 (n_seg = 257 at a tree's root, 514 for a pair of children). The
// TPU kernel splits each id into two 128-wide one-hots and multiplies
// them through the MXU at HIGHEST precision; here both kernels run one
// device body (accumulate), which differs between them only in how a row's
// segment is formed: one CTA per (lane, feature) adds int64 fixed point
// into a [n_seg, 2] shared-memory histogram (8,224 B at 514 segments),
// with the same scale, rounding, NaN rule and launch-to-launch identity
// as K1. Taking seg_base and
// the int16 bins, not a [K, F, N] int32 id tensor, keeps the ids out of
// device memory.
//
// Bound: the bins once (K F N 2 bytes), seg_base and (g, h) once per lane,
// the histograms written once. At v114d's split step (K = 25, F = 228,
// N = 2,443, n_seg = 514) that is 28.0 MB in and 23.4 MB out: ~15 us at
// 3.35 TB/s. A split step's rows are mostly inactive, so the CTA's time
// goes to reading the lane's rows and to zeroing and writing the
// histogram.

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

// One CTA per (lane k, feature f) = (blockIdx.y, blockIdx.x): row r adds
// into segment ids[k, r] * id_scale + bin when ids[k, r] * id_scale lies
// in [0, n_seg) and bin in [0, n_bins); the [n_seg, 2] int64 histogram is
// written out as float32 sums.
__device__ __forceinline__ void accumulate(
    const int16_t* __restrict__ binned, const int32_t* __restrict__ ids,
    const float2* __restrict__ gh, const float* __restrict__ maxabs,
    float* __restrict__ out, int F, int N, int id_scale, int n_bins, int n_seg,
    int log2n) {
  extern __shared__ unsigned long long acc[];
  const int f = blockIdx.x;
  const int k = blockIdx.y;
  const int cells = n_seg * 2;
  for (int i = threadIdx.x; i < cells; i += kThreads) acc[i] = 0ull;

  const float mg = maxabs[2 * k], mh = maxabs[2 * k + 1];
  const bool finite = isfinite(mg) && isfinite(mh);
  const double sg = fixed_scale(mg, log2n), sh = fixed_scale(mh, log2n);
  __syncthreads();

  if (finite) {
    const int16_t* b = binned + (static_cast<size_t>(k) * F + f) * N;
    const int32_t* id = ids + static_cast<size_t>(k) * N;
    const float2* v = gh + static_cast<size_t>(k) * N;
    for (int r = threadIdx.x; r < N; r += kThreads) {
      const long long base = static_cast<long long>(id[r]) * id_scale;
      const int bin = b[r];
      if (base < 0 || base >= n_seg ||
          static_cast<unsigned>(bin) >= static_cast<unsigned>(n_bins))
        continue;
      const long long s = base + bin;
      if (s < n_seg) {
        const float2 x = v[r];
        const long long qg = __double2ll_rn(static_cast<double>(x.x) * sg);
        const long long qh = __double2ll_rn(static_cast<double>(x.y) * sh);
        atomicAdd(acc + 2 * s, static_cast<unsigned long long>(qg));
        atomicAdd(acc + 2 * s + 1, static_cast<unsigned long long>(qh));
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

// K1: segment = node * n_bins_tot + bin
__global__ void __launch_bounds__(kThreads)
hist_kernel(const int16_t* __restrict__ binned, const int32_t* __restrict__ node_q,
            const float2* __restrict__ gh, const float* __restrict__ maxabs,
            float* __restrict__ out, int F, int N, int k_nodes, int n_bins_tot,
            int log2n) {
  accumulate(binned, node_q, gh, maxabs, out, F, N, n_bins_tot, n_bins_tot,
             k_nodes * n_bins_tot, log2n);
}

// K3: segment = seg_base + bin
__global__ void __launch_bounds__(kThreads)
seg_hist_kernel(const int16_t* __restrict__ binned, const int32_t* __restrict__ seg_base,
                const float2* __restrict__ gh, const float* __restrict__ maxabs,
                float* __restrict__ out, int F, int N, int n_seg, int log2n) {
  accumulate(binned, seg_base, gh, maxabs, out, F, N, 1, n_seg, n_seg, log2n);
}

int ceil_log2(int n) {
  int log2n = 0;
  while ((1LL << log2n) < static_cast<long long>(n)) ++log2n;
  return log2n;
}

// one CTA per (lane, feature) with an [n_seg, 2] int64 histogram in
// shared memory; args... follow (binned, ids, gh, maxabs, out) of the kernel
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int K, int F, int n_seg, void* stream, Args... args) {
  const size_t smem = static_cast<size_t>(n_seg) * 2 * sizeof(unsigned long long);
  if (smem > static_cast<size_t>(kMaxSmemBytes) || K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(F, K), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mallorn_seg_hist(const int16_t* binned, const int32_t* seg_base,
                                const float* gh, const float* maxabs, float* out,
                                int K, int F, int N, int n_seg, void* stream) {
  if (K <= 0 || F <= 0 || n_seg <= 0) return 0;
  return launch(seg_hist_kernel, K, F, n_seg, stream, binned, seg_base,
                reinterpret_cast<const float2*>(gh), maxabs, out, F, N, n_seg,
                ceil_log2(N));
}

extern "C" int mallorn_hist(const int16_t* binned, const int32_t* node_q,
                            const float* gh, const float* maxabs, float* out,
                            int K, int F, int N, int k_nodes, int n_bins_tot,
                            void* stream) {
  if (K <= 0 || F <= 0 || k_nodes <= 0 || n_bins_tot <= 0) return 0;
  return launch(hist_kernel, K, F, k_nodes * n_bins_tot, stream, binned, node_q,
                reinterpret_cast<const float2*>(gh), maxabs, out, F, N, k_nodes,
                n_bins_tot, ceil_log2(N));
}
