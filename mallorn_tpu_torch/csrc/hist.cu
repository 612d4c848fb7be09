// (grad, hess) histograms of the GBDT, batched over folds or lanes: the
// depthwise level histogram (K1, hist_kernel), the leaf-wise segment
// histogram (K3, seg_hist_kernel) and the depthwise fit's two histogram
// modes (K4 / K5, mode_hist_kernel, further down), all shared-memory
// integer histograms.
//
// K1 replaces mallorn_tpu/ops/hist_pallas.py:_fullhot_kernel (the Pallas
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

// The row walk of every kernel in this file: all kBlock threads stride the
// N rows and call add(s, r) for each row r whose segment
// s = (ids[r] - id0) * id_scale + bins[r] lies in [0, n_seg), with
// (ids[r] - id0) * id_scale in [0, n_seg) and the bin in [0, n_bins).
template <int kBlock, typename Add>
__device__ __forceinline__ void for_each_row(const int16_t* __restrict__ bins,
                                             const int32_t* __restrict__ ids, int N, int id0,
                                             int id_scale, int n_bins, int n_seg, Add add) {
  for (int r = threadIdx.x; r < N; r += kBlock) {
    const long long base = (static_cast<long long>(ids[r]) - id0) * id_scale;
    const int bin = bins[r];
    if (base < 0 || base >= n_seg ||
        static_cast<unsigned>(bin) >= static_cast<unsigned>(n_bins))
      continue;
    const long long s = base + bin;
    if (s < n_seg) add(static_cast<int>(s), r);
  }
}

// The fixed-point histogram of K1, K3 and K4: zeroes the [n_seg, C] int64
// histogram in shared memory, gives channel c the scale
// S_c = 2^(62 - log2n - e) with maxabs[c] < 2^e, and adds
// round(x_c * S_c) of each active row's C values (load(r, x)) with integer
// atomics. Returns whether every maxabs is finite (if not, nothing is
// added and every cell is NaN) and sets inv[c] = 1 / S_c (exact: S_c is a
// power of 2); the sums are in smem after its closing __syncthreads.
template <int C, int kBlock, typename Load>
__device__ __forceinline__ bool accumulate_fixed(uint4* smem, const float* __restrict__ maxabs,
                                                 int log2n, const int16_t* __restrict__ bins,
                                                 const int32_t* __restrict__ ids, int N, int id0,
                                                 int id_scale, int n_bins, int n_seg, Load load,
                                                 double (&inv)[C]) {
  static_assert(C % 2 == 0, "the histogram is zeroed as whole uint4s");
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem);
  for (int i = threadIdx.x; i < n_seg * C / 2; i += kBlock) smem[i] = make_uint4(0u, 0u, 0u, 0u);

  bool finite = true;
  double sc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float m = maxabs[c];
    finite = finite && isfinite(m);
    sc[c] = fixed_scale(m, log2n);
    inv[c] = 1.0 / sc[c];
  }
  __syncthreads();

  if (finite) {
    for_each_row<kBlock>(bins, ids, N, id0, id_scale, n_bins, n_seg, [&](int s, int r) {
      float x[C];
      load(r, x);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const long long q = __double2ll_rn(__dmul_rn(static_cast<double>(x[c]), sc[c]));
        if (q) atomicAdd(acc + s * C + c, static_cast<unsigned long long>(q));
      }
    });
  }
  __syncthreads();
  return finite;
}

// one int64 fixed-point sum, converted once: sum / S to float32
__device__ __forceinline__ float from_fixed(unsigned long long a, double inv) {
  return __double2float_rn(__dmul_rn(__ll2double_rn(static_cast<long long>(a)), inv));
}

// K1 and K3: one CTA per (lane k, feature f) = (blockIdx.y, blockIdx.x);
// row r adds (g, h) into segment ids[k, r] * id_scale + bin, and the
// [n_seg, 2] histogram is written out as float32 sums.
__device__ __forceinline__ void accumulate(
    const int16_t* __restrict__ binned, const int32_t* __restrict__ ids,
    const float2* __restrict__ gh, const float* __restrict__ maxabs,
    float* __restrict__ out, int F, int N, int id_scale, int n_bins, int n_seg,
    int log2n) {
  extern __shared__ uint4 smem[];
  const int f = blockIdx.x;
  const int k = blockIdx.y;
  const float2* v = gh + static_cast<size_t>(k) * N;
  double inv[2];
  const bool finite = accumulate_fixed<2, kThreads>(
      smem, maxabs + 2 * k, log2n, binned + (static_cast<size_t>(k) * F + f) * N,
      ids + static_cast<size_t>(k) * N, N, 0, id_scale, n_bins, n_seg,
      [&](int r, float(&x)[2]) {
        const float2 w = v[r];
        x[0] = w.x;
        x[1] = w.y;
      },
      inv);

  const unsigned long long* acc = reinterpret_cast<const unsigned long long*>(smem);
  float* o = out + (static_cast<size_t>(k) * F + f) * n_seg * 2;
  for (int i = threadIdx.x; i < n_seg * 2; i += kThreads)
    o[i] = finite ? from_fixed(acc[i], inv[i & 1]) : __int_as_float(0x7fc00000);
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

// ---------------------------------------------------------------------------
// K4 / K5: the depthwise fit's histogram modes (GBDTParams.hist_dtype
// "bf16" / "i8bf16" and "int8"), one template: mode_hist_kernel<kInt8>.
//
// K4 (mode_hist_kernel<false>) replaces mallorn_tpu/ops/hist_pallas.py:
// _binlane_kernel (behind build_histograms_binlane); K5
// (mode_hist_kernel<true>) replaces _binlane_kernel_i8 (behind
// build_histograms_binlane_i8). Both keep K1's contract: for fold k,
// feature f, node c < k_nodes and bin b < n_bins_tot,
//   out[k, f, c, b, ch] = sum_r [nodes[k, r] == c] [binned[k, f, r] == b] x_ch(r)
// but x enters as digits: K4 takes 3 bf16 digits each of g and h
// (hist_cuda.split_gh_digits), K5 4 balanced base-128 int8 digits of a
// 26-bit fixed-point (g, h) (hist_cuda.quantize_gh_i8).
//
// The TPU kernels scatter through the MXU (a one-hot times the digits),
// because a TPU has no scatter. Here the design is K1's: one CTA per
// (fold, feature, group of <= 8 nodes) (grid (F, K, ceil(k_nodes / 8))),
// a [nodes, n_bins_tot, C] integer histogram in shared memory, every
// thread striding the fold's rows once (for_each_row, K1's row walk with
// the group's first node as id0) and adding an active row's C digit
// channels with shared-memory integer atomics (a zero digit adds
// nothing and is skipped). Integer sums are exact and order-free, so two
// launches give the same bits.
//
// K5: C = 8 int32 cells, the digits themselves (g's four, then h's); 8
// nodes x 257 bins take 65,792 B. |digit| <= 64, so a cell is exact up to
// 2^25 rows. The epilogue recombines each channel in float32 in the JAX
// package's order, ((P0 + 128 P1) + 128^2 P2) + 128^3 P3, times s / 2^26
// (hist_pallas.py:317-329), every operation an explicit IEEE
// __fadd_rn / __fmul_rn so that nvcc contracts nothing into an FMA: bit
// for bit hist_cuda._recombine_i8 of the same integer sums, hence bit for
// bit the plain version and the JAX package.
//
// K4: C = 6 int64 fixed-point cells (g's d0, d1, d2, then h's); 8 nodes x
// 257 bins take 98,688 B. It runs K1's fixed-point body, accumulate_fixed,
// with six channels, and differs from K1 only in its epilogue. Each digit
// channel gets K1's per-fold scale,
// S = 2^(62 - ceil(log2 N) - e) with max |digit| < 2^e over the fold's rows
// (fixed_scale), a digit is rounded to the nearest integer of digit * S
// (exact for every digit above max |digit| 2^(ceil(log2 N) - 62)) and the
// integer sum is converted once to float32; each digit sum is therefore
// the exact sum to within one float32 ulp (plus N / (2 S)), and the output
// is (S0 + S1) + S2 per channel in float32, the order of the Pallas
// kernel's o[0:C] + o[C:2C] + o[2C:3C]. The same bits come out of
// hist_cuda.build_histograms_bf16_fixed. A fold whose digits hold a
// non-finite value gets NaN in every cell, as in K1.
//
// Inputs: binned [K, F, N] int16; nodes [K, N] int32 (an id outside
// [0, k_nodes) is an inactive row); digits row-major, [K, N, 8] int8 for
// K5 (one 8-byte load per row) or [K, N, 6] bf16 for K4 (three 4-byte
// loads); scale [K, 2] float32 s (K5) or [K, 6] float32 max |digit| per
// channel (K4). Output [K, F, k_nodes, n_bins_tot, 2] float32.
//
// Bound on an H100: as K1's, the bins once (K F N 2 bytes), the rows'
// node ids and digits once per fold (they stay in L2 across the fold's
// CTAs), the histograms written once: at the v92d CV's deepest level
// (K = 5, F = 222, N = 2,444, k_nodes = 8) ~24 MB, ~7 us at 3.35 TB/s. The
// kernel spends its time as K1 does, on shared-memory atomics (8 int32 or
// 6 int64 per active row and feature, serialised where rows share a bin,
// as in a crowded missing bin) and on zeroing and writing the whole
// histogram.

// 512 threads per CTA: an SM holds 3 (K5) or 2 (K4) CTAs of 65,792 /
// 98,688 B, 1,536 / 1,024 threads; of 256, 512 and 1,024, 512 was the
// fastest for both modes at the v92d CV's deepest level on an H100 (at one
// node, K4 is faster with 256)
constexpr int kModeThreads = 512;
constexpr int kModeNodes = 8;  // nodes per CTA

template <bool kInt8>
struct ModeTraits;

template <>
struct ModeTraits<false> {  // K4
  static constexpr int kChannels = 6;
  using Cell = unsigned long long;
};

template <>
struct ModeTraits<true> {  // K5
  static constexpr int kChannels = 8;
  using Cell = int;
};

template <bool kInt8>
__global__ void __launch_bounds__(kModeThreads)
mode_hist_kernel(const int16_t* __restrict__ binned, const int32_t* __restrict__ nodes,
                 const void* __restrict__ digits, const float* __restrict__ scale,
                 float* __restrict__ out, int F, int N, int k_nodes, int n_bins_tot,
                 int log2n) {
  constexpr int C = ModeTraits<kInt8>::kChannels;
  extern __shared__ uint4 smem[];
  const int f = blockIdx.x;
  const int k = blockIdx.y;
  const int node0 = blockIdx.z * kModeNodes;
  const int n_nodes = min(kModeNodes, k_nodes - node0);
  const int n_seg = n_nodes * n_bins_tot;
  const int16_t* b = binned + (static_cast<size_t>(k) * F + f) * N;
  const int32_t* nd = nodes + static_cast<size_t>(k) * N;
  // output cell i = (node, bin) * 2 + channel: its digit cells are
  // acc[i * C / 2 .. + C / 2), the group's output one contiguous run
  float* o = out + ((static_cast<size_t>(k) * F + f) * k_nodes + node0) * n_bins_tot * 2;
  const int n_out = n_seg * 2;

  if constexpr (kInt8) {
    int* acc = reinterpret_cast<int*>(smem);
    for (int i = threadIdx.x; i < n_seg * C / 4; i += kModeThreads)
      smem[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    const uint2* w = static_cast<const uint2*>(digits) + static_cast<size_t>(k) * N;
    for_each_row<kModeThreads>(b, nd, N, node0, n_bins_tot, n_bins_tot, n_seg,
                               [&](int s, int r) {
                                 const uint2 d = w[r];
                                 int* cell = acc + s * C;
#pragma unroll
                                 for (int j = 0; j < 4; ++j) {
                                   // sign-extended byte j of g's and h's words
                                   const int dg = static_cast<int>(d.x << (24 - 8 * j)) >> 24;
                                   const int dh = static_cast<int>(d.y << (24 - 8 * j)) >> 24;
                                   if (dg) atomicAdd(cell + j, dg);
                                   if (dh) atomicAdd(cell + 4 + j, dh);
                                 }
                               });
    __syncthreads();

    constexpr float kInvQ = 1.0f / 67108864.0f;  // 2^-26, exact
    const float sg = __fmul_rn(scale[2 * k], kInvQ), sh = __fmul_rn(scale[2 * k + 1], kInvQ);
    for (int i = threadIdx.x; i < n_out; i += kModeThreads) {
      const int4 p = reinterpret_cast<const int4*>(acc)[i];
      float v = __fadd_rn(__int2float_rn(p.x), __fmul_rn(__int2float_rn(p.y), 128.0f));
      v = __fadd_rn(v, __fmul_rn(__int2float_rn(p.z), 16384.0f));
      v = __fadd_rn(v, __fmul_rn(__int2float_rn(p.w), 2097152.0f));
      o[i] = __fmul_rn(v, (i & 1) ? sh : sg);
    }
  } else {
    // three 4-byte words per row: bf16 digit 2 j in word j's low half
    const uint32_t* w = static_cast<const uint32_t*>(digits) + static_cast<size_t>(k) * N * 3;
    double inv[C];
    const bool finite = accumulate_fixed<C, kModeThreads>(
        smem, scale + C * k, log2n, b, nd, N, node0, n_bins_tot, n_bins_tot, n_seg,
        [&](int r, float(&x)[C]) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const uint32_t v = w[3 * static_cast<size_t>(r) + j];
            x[2 * j] = __uint_as_float(v << 16);
            x[2 * j + 1] = __uint_as_float(v & 0xFFFF0000u);
          }
        },
        inv);

    const unsigned long long* acc = reinterpret_cast<const unsigned long long*>(smem);
    for (int i = threadIdx.x; i < n_out; i += kModeThreads) {
      const unsigned long long* a = acc + 3 * i;
      const int c0 = 3 * (i & 1);
      o[i] = finite ? __fadd_rn(__fadd_rn(from_fixed(a[0], inv[c0]), from_fixed(a[1], inv[c0 + 1])),
                                from_fixed(a[2], inv[c0 + 2]))
                    : __int_as_float(0x7fc00000);
    }
  }
}

template <bool kInt8>
int launch_mode(const int16_t* binned, const int32_t* nodes, const void* digits,
                const float* scale, float* out, int K, int F, int N, int k_nodes,
                int n_bins_tot, void* stream) {
  using Tr = ModeTraits<kInt8>;
  if (K <= 0 || F <= 0 || k_nodes <= 0 || n_bins_tot <= 0) return 0;
  const int group = k_nodes < kModeNodes ? k_nodes : kModeNodes;
  const size_t smem =
      static_cast<size_t>(group) * n_bins_tot * Tr::kChannels * sizeof(typename Tr::Cell);
  const int node_groups = (k_nodes + kModeNodes - 1) / kModeNodes;
  if (smem > static_cast<size_t>(kMaxSmemBytes) || K > 65535 || node_groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(mode_hist_kernel<kInt8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mode_hist_kernel<kInt8><<<dim3(F, K, node_groups), kModeThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      binned, nodes, digits, scale, out, F, N, k_nodes, n_bins_tot, ceil_log2(N));
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

// K4: digits [K, N, 6] bf16, maxabs [K, 6] float32 (max |digit| per channel)
extern "C" int mallorn_hist_bf16(const int16_t* binned, const int32_t* nodes,
                                 const void* digits, const float* maxabs, float* out, int K,
                                 int F, int N, int k_nodes, int n_bins_tot, void* stream) {
  return launch_mode<false>(binned, nodes, digits, maxabs, out, K, F, N, k_nodes, n_bins_tot,
                            stream);
}

// K5: digits [K, N, 8] int8, scale [K, 2] float32 (s per channel)
extern "C" int mallorn_hist_i8(const int16_t* binned, const int32_t* nodes,
                               const void* digits, const float* scale, float* out, int K,
                               int F, int N, int k_nodes, int n_bins_tot, void* stream) {
  return launch_mode<true>(binned, nodes, digits, scale, out, K, F, N, k_nodes, n_bins_tot,
                           stream);
}
