// (grad, hess) histograms of the GBDT, batched over folds or lanes: the
// depthwise level histogram (K1, hist_kernel), the leaf-wise segment
// histogram (K3, seg_hist_kernel) and the depthwise fit's two histogram
// modes on the tensor cores (K4 / K5, mode_hist_kernel, further down).
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

// ---------------------------------------------------------------------------
// K4 / K5: the depthwise fit's histogram modes on the tensor cores
// (GBDTParams.hist_dtype "bf16" / "i8bf16" and "int8").
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
// Both are one product per (fold, feature): D [digit slot x node, bin] =
// A [digit slot x node, row] . B [row, bin], with
//   A[8 c + d, r] = digit d of row r if row r is at node c, else 0
//     (the i8full form's feature-independent node matrix,
//     _fullhot_kernel at hist_pallas.py:526-537, node-major with 8 digit
//     slots per node: 6 bf16 digits + 2 zero slots, or 8 int8 digits), so
//     a 16-row m-tile holds all digits of 2 nodes;
//   B[r, b] = [binned[k, f, r] == b], built in registers from the int16
//     bins for each 8-bin n-tile, never stored.
// The product runs on mma.sync: m16n8k16 bf16 -> f32 (K4), m16n8k32 s8 ->
// s32 (K5). One CTA per (fold, feature, group of 8 nodes); each warp owns
// 3 n-tiles (24 bins) and walks every row of the fold in order, 16 (K4) or
// 32 (K5) rows per mma; an n-tile that no active row of the step hits is
// skipped (a warp vote). Each accumulator lives in one thread and is added
// in row order, with no atomics: two launches give the same bits.
//
// K4 sums each mma's products with a zero accumulator and adds that
// partial to the running float32 sum with an IEEE add, so a cell is a
// float32 sum over 16-row groups (a group rarely holds more than one row
// of a cell), not the tensor core's truncating long accumulation. Its
// output is (S d0 + S d1) + S d2 per channel, the order of the Pallas
// kernel's o[0:C] + o[C:2C] + o[2C:3C], formed in the epilogue through
// warp shuffles. K5's int32 partials are exact, so any order gives the
// Pallas kernel's partials bit for bit; it writes them out as
// [K, F, k_nodes, 8, n_bins_tot] and the wrapper recombines them in
// float32 in the JAX package's order (hist_cuda._recombine_i8).
//
// Inputs: binned [K, F, N] int16; nodes [K, Np] int32 (Np = N padded to a
// multiple of 32, padded rows -1; an id outside [0, k_nodes) is an
// inactive row); digits [K, 8, Np] (bf16 for K4, int8 for K5), digit-major
// so one 32-bit load gives a thread its 2 (K4) or 4 (K5) rows of one digit.
//
// Bound on an H100: as K1's, the bins once and the rows' (node, digits)
// once per fold, the histograms written once (~7 us at the v92d CV's
// deepest level). This first version is bound by its instruction count:
// every warp of a CTA re-reads the rows (through L1) and rebuilds A, and
// most of each mma's 8 x 16 product is zeros (one-hot B); wgmma, a shared
// A per CTA and sparser tiles are later work.

constexpr int kModeTilesPerWarp = 3;  // 8-bin n-tiles a warp owns
constexpr int kModeMTiles = 4;        // 16-row m-tiles per CTA: 8 nodes
constexpr int kModeMaxWarps = 16;

template <bool kInt8>
struct ModeTraits;

template <>
struct ModeTraits<false> {  // K4: bf16 digits, float32 sums
  static constexpr int kPack = 2;  // rows per 32-bit register
  static constexpr uint32_t kOne = 0x3F80u;  // bf16 1.0
  static constexpr uint32_t kLane = 0xFFFFu;
  using Acc = float;
  __device__ __forceinline__ static void mma_add(float (&acc)[4], const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    acc[0] = __fadd_rn(acc[0], d0);
    acc[1] = __fadd_rn(acc[1], d1);
    acc[2] = __fadd_rn(acc[2], d2);
    acc[3] = __fadd_rn(acc[3], d3);
  }
};

template <>
struct ModeTraits<true> {  // K5: int8 digits, exact int32 sums
  static constexpr int kPack = 4;
  static constexpr uint32_t kOne = 0x01u;
  static constexpr uint32_t kLane = 0xFFu;
  using Acc = int;
  __device__ __forceinline__ static void mma_add(int (&acc)[4], const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// grid (F, K, ceil(k_nodes / 8)); 32 x min(16, ceil(n_tiles / 3)) threads.
// Lane (gq, tq) = (lane / 4, lane % 4) holds, per mma, A rows gq (node
// 2 mt, digit gq) and gq + 8 (node 2 mt + 1, digit gq) and B column gq of
// each n-tile, for two packs of W rows: base + W tq + i and base + 4 W +
// W tq + i (i < W), the PTX fragment layouts of both mma shapes.
template <bool kInt8>
__global__ void __launch_bounds__(kModeMaxWarps * 32)
mode_hist_kernel(const int16_t* __restrict__ binned, const int32_t* __restrict__ nodes,
                 const uint32_t* __restrict__ digits, void* __restrict__ out, int F, int N,
                 int Np, int k_nodes, int n_bins_tot) {
  using Tr = ModeTraits<kInt8>;
  using Acc = typename Tr::Acc;
  constexpr int W = Tr::kPack;
  constexpr int kStep = 8 * W;  // rows per mma
  const int f = blockIdx.x;
  const int k = blockIdx.y;
  const int node0 = blockIdx.z * 2 * kModeMTiles;
  const int node_end = min(k_nodes, node0 + 2 * kModeMTiles);
  const int m_tiles = (node_end - node0 + 1) / 2;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int n_tiles = (n_bins_tot + 7) / 8;
  const int16_t* bins = binned + (static_cast<size_t>(k) * F + f) * N;
  const int32_t* nd = nodes + static_cast<size_t>(k) * Np;
  const uint32_t* dg = digits + (static_cast<size_t>(k) * 8 + gq) * (Np / W);

  for (int tile0 = warp * kModeTilesPerWarp; tile0 < n_tiles;
       tile0 += n_warps * kModeTilesPerWarp) {
    Acc acc[kModeMTiles][kModeTilesPerWarp][4];
#pragma unroll
    for (int mt = 0; mt < kModeMTiles; ++mt)
#pragma unroll
      for (int j = 0; j < kModeTilesPerWarp; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = Acc(0);

    for (int base = 0; base < N; base += kStep) {
      uint32_t a[kModeMTiles][4];
      int bin[2][W];
      uint32_t hit = 0;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int r0 = base + 4 * W * p + W * tq;
        const uint32_t word = dg[r0 / W];
        int local[W];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int r = r0 + i;
          const int q = nd[r];
          local[i] = (q >= node0 && q < node_end) ? q - node0 : -1;
          const int b = r < N ? static_cast<int>(bins[r]) : -1;
          bin[p][i] = b;
          const int rel = (b >> 3) - tile0;
          if (local[i] >= 0 && b >= 0 && rel >= 0 && rel < kModeTilesPerWarp) hit |= 1u << rel;
        }
#pragma unroll
        for (int mt = 0; mt < kModeMTiles; ++mt) {
          uint32_t m0 = 0u, m1 = 0u;
#pragma unroll
          for (int i = 0; i < W; ++i) {
            m0 |= (local[i] == 2 * mt ? Tr::kLane : 0u) << (i * (32 / W));
            m1 |= (local[i] == 2 * mt + 1 ? Tr::kLane : 0u) << (i * (32 / W));
          }
          a[mt][2 * p] = word & m0;      // A row gq: node 2 mt
          a[mt][2 * p + 1] = word & m1;  // A row gq + 8: node 2 mt + 1
        }
      }
      hit = __reduce_or_sync(0xffffffffu, hit);
#pragma unroll
      for (int j = 0; j < kModeTilesPerWarp; ++j) {
        if (!((hit >> j) & 1u)) continue;  // warp-uniform
        const int col = (tile0 + j) * 8 + gq;  // this lane's bin
        uint32_t b[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t v = 0u;
#pragma unroll
          for (int i = 0; i < W; ++i) v |= (bin[p][i] == col ? Tr::kOne : 0u) << (i * (32 / W));
          b[p] = v;
        }
#pragma unroll
        for (int mt = 0; mt < kModeMTiles; ++mt)
          if (mt < m_tiles) Tr::mma_add(acc[mt][j], a[mt], b);
      }
    }

    // epilogue: accumulator e of (mt, j) is A row gq (e < 2) or gq + 8
    // (e >= 2), bin (tile0 + j) * 8 + 2 tq + (e & 1)
#pragma unroll
    for (int mt = 0; mt < kModeMTiles; ++mt) {
      if (mt >= m_tiles) continue;  // warp-uniform
#pragma unroll
      for (int j = 0; j < kModeTilesPerWarp; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int node = node0 + 2 * mt + (e >> 1);
          const int col = (tile0 + j) * 8 + 2 * tq + (e & 1);
          const bool ok = node < k_nodes && col < n_bins_tot;
          const size_t kfc = (static_cast<size_t>(k) * F + f) * k_nodes + node;
          if constexpr (kInt8) {
            if (ok) static_cast<int*>(out)[(kfc * 8 + gq) * n_bins_tot + col] = acc[mt][j][e];
          } else {
            // digit slots 0-2 are g's, 3-5 h's: lanes gq = 0 and 3 form
            // (d0 + d1) + d2 from lanes gq + 1 and gq + 2
            const float v = acc[mt][j][e];
            const float v1 = __shfl_down_sync(0xffffffffu, v, 4);
            const float v2 = __shfl_down_sync(0xffffffffu, v, 8);
            if (ok && (gq == 0 || gq == 3))
              static_cast<float*>(out)[(kfc * n_bins_tot + col) * 2 + (gq == 3)] =
                  __fadd_rn(__fadd_rn(v, v1), v2);
          }
        }
      }
    }
  }
}

template <bool kInt8>
int launch_mode(const int16_t* binned, const int32_t* nodes, const void* digits, void* out,
                int K, int F, int N, int Np, int k_nodes, int n_bins_tot, void* stream) {
  if (K <= 0 || F <= 0 || k_nodes <= 0 || n_bins_tot <= 0) return 0;
  const int n_tiles = (n_bins_tot + 7) / 8;
  const int groups = (n_tiles + kModeTilesPerWarp - 1) / kModeTilesPerWarp;
  const int warps = groups < kModeMaxWarps ? groups : kModeMaxWarps;
  const int node_groups = (k_nodes + 2 * kModeMTiles - 1) / (2 * kModeMTiles);
  if (Np % 32 != 0 || Np < N || K > 65535 || node_groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  mode_hist_kernel<kInt8><<<dim3(F, K, node_groups), 32 * warps, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      binned, nodes, static_cast<const uint32_t*>(digits), out, F, N, Np, k_nodes,
      n_bins_tot);
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

// K4: digits [K, 8, Np] bf16, out [K, F, k_nodes, n_bins_tot, 2] float32
extern "C" int mallorn_hist_bf16(const int16_t* binned, const int32_t* nodes,
                                 const void* digits, float* out, int K, int F, int N,
                                 int Np, int k_nodes, int n_bins_tot, void* stream) {
  return launch_mode<false>(binned, nodes, digits, out, K, F, N, Np, k_nodes, n_bins_tot,
                            stream);
}

// K5: digits [K, 8, Np] int8, out [K, F, k_nodes, 8, n_bins_tot] int32 partials
extern "C" int mallorn_hist_i8(const int16_t* binned, const int32_t* nodes,
                               const void* digits, int32_t* out, int K, int F, int N,
                               int Np, int k_nodes, int n_bins_tot, void* stream) {
  return launch_mode<true>(binned, nodes, digits, out, K, F, N, Np, k_nodes, n_bins_tot,
                           stream);
}
