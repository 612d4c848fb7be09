// (grad, hess) histograms of the GBDT, batched over folds or lanes: the
// depthwise level histogram (K1) and the leaf-wise segment histogram (K3),
// one kernel template (group_hist_kernel<kLevel, kExternal>), K1's path for
// a level wider than one CTA holds (wide_prep_kernel and
// wide_hist_kernel<kExternal>, further down), and the depthwise fit's two
// histogram modes (K4 / K5, mode_hist_kernel<kInt8, kExternal>, further
// down), all shared-memory integer histograms; and K4 / K5's digits,
// prepared once a tree (digit_prep_kernel<kInt8>, last).
//
// K1 (group_hist_kernel<true, .>) replaces mallorn_tpu/ops/hist_pallas.py:
// _fullhot_kernel (the Pallas kernel behind build_histograms_fullhot), with
// a leading fold axis. Contract, for fold k, feature f, node c < k_nodes
// and bin b < n_bins_tot:
//   out[k, f, c, b, :] = sum_r [node_q[k, r] == c] [binned[k, f, r] == b]
//                        (gh[k, r, 0], gh[k, r, 1])
// Inputs: binned [K, F, N] int16, node_q [K, N] int32 (k_nodes or any id
// outside [0, k_nodes) = inactive row), gh [K, N, 2] float32. Output
// [K, F, k_nodes, n_bins_tot, 2] float32. Bin n_bins_tot - 1 is the
// missing bin; a bin id outside [0, n_bins_tot) is skipped like an
// inactive row. The TPU kernel scatters through the MXU: an int8 full-bin
// one-hot times bf16x3 digits of (g, h). None of that carries over.
//
// K3 (group_hist_kernel<false, false>) replaces mallorn_tpu/ops/hist_pallas.py:
// _hist_kernel (the Pallas kernel behind build_histograms_pallas), with a
// leading lane axis. Contract, for lane k, feature f and segment s < n_seg:
//   out[k, f, s, :] = sum_r [seg_base[k, r] + binned[k, f, r] == s] gh[k, r, :]
// Inputs: binned [K, F, N] int16, seg_base [K, N] int32 (a row's node
// times n_bins_tot; a row whose seg_base is outside [0, n_seg), or whose
// bin is negative, is inactive; so is a (row, feature) whose segment is
// n_seg or beyond), gh [K, N, 2] float32. Output [K, F, n_seg, 2] float32
// (n_seg = 257 at a tree's root, 514 for a pair of children). The TPU
// kernel splits each id into two 128-wide one-hots and multiplies them
// through the MXU at HIGHEST precision.
//
// K1's output is K3's with n_seg = k_nodes n_bins_tot and a row's base
// node_q n_bins_tot; the two differ only in which (row, feature) counts:
// K1 checks the node against k_nodes and the bin against n_bins_tot, K3
// the base against n_seg and base + bin against n_seg. kLevel picks the
// rule; everything else is one body.
//
// Determinism: float atomics add in an order that changes from launch to
// launch, and a flipped last bit flips knife-edge splits. The kernel adds
// in 64-bit fixed point instead: g (and h) is scaled by S = 2^(62 -
// ceil(log2 N) - e), where max|g| < 2^e for the fold, rounded to the
// nearest integer and added with integer atomics, which are exact and
// order-free; the integer sum (|sum| < 2^63 by the choice of S) is
// converted once to double, divided by S and rounded to float32. Each
// row's rounding is at most 1/(2S), so a cell is within N/(2S) <= max|g| *
// 2^(2 ceil(log2 N) - 62) of the exact sum before the final float32
// rounding (N = 8,143: 1.5e-11 * max|g|): the result is the exact sum to
// within one float32 ulp, bit-identical from launch to launch and for any
// tiling of the work. A fold whose g or h holds a non-finite value gets NaN
// in every cell (fixed point cannot carry it).
//
// Bound on an H100: the bins once (K F N 2 bytes), the ids and (g, h) once
// per fold, the histograms written once. At v114d's split step (K3: K = 25,
// F = 228, N = 2,443, n_seg = 514) that is 28.0 MB in and 23.4 MB out:
// ~15 us at 3.35 TB/s; at the v92d CV's deepest level (K1: K = 5, F = 222,
// N = 2,444, k_nodes = 8) 5.4 MB in and 18.3 MB out: ~7 us.
//
// What held the first design (one CTA per (fold, feature), which both
// kernels had before they moved onto this one) at 5-19x that bound: thousands of CTAs of ~10 rows per thread, each paying
// for zeroing, two barriers and a whole-histogram epilogue; every
// feature's CTA re-reading a row's ids and (g, h) from L2 (12 B a row
// against 2 B of bins) and redoing its fixed-point conversion; a row walk
// of dependent loads (id, then the bin, then (g, h)); int64 shared-memory
// atomics; and two PyTorch ops in the wrapper for the scale. This kernel:
// - one CTA per (fold, group of G features) (grid (ceil(F / G), K); the
//   last group is ragged), G [n_seg, 2] int64 histograms in shared memory;
//   G and the tile's rows come from the wrapper (hist_cuda.hist_layout for
//   K1, by level; hist_cuda.seg_hist_layout for K3), so that deep levels
//   take a smaller G than the root and a small grid a smaller G than a
//   large one;
// - K1's level of 17 nodes or more, or of more than one CTA's histograms
//   hold (54 at 257 bins), takes the wide path below (hist_cuda.hist_plan
//   picks it);
// - K3's call of more segments than one CTA holds (SEG_MAX_SEGMENTS, 14,004)
//   takes windows of at most that many on the grid's z axis
//   (hist_cuda.seg_hist_plan, up to 65,536 segments): a window's CTA
//   stages every row tile, compacts only the rows whose base lies before
//   the window's end, and adds only the (row, feature) items whose segment
//   falls in the window; K1 never windows here;
// - the fold's scale found in the kernel: the CTA reads the fold's (g, h)
//   once, keeps max |g|, max |h| (exact in any order) and a flag for any
//   non-finite value (fmaxf drops NaN; an infinity must give NaN too);
// - rows in tiles of R, their ids and the G features' bins staged in
//   shared memory by cp.async 16-byte copies, two stages, so that the
//   next tile lands while this one is added;
// - each warp compacts its rows of the tile once (ballot, __popc prefix)
//   into a list of (row, base, q_g, q_h), q computed once per row from the
//   (g, h) of the active rows alone (the scale's pass has just brought
//   them into L1); its lanes then add (entry, feature) items into the G
//   histograms: an inactive row costs its id;
// - an int64 cell is a low and a high 32-bit word, added with two native
//   32-bit atomics and the carry passed on (add_fixed): an int64
//   atomicAdd on shared memory compiles to a compare-and-swap loop
//   (ATOMS.CAST.SPIN.64), which held the first design too. An item adds
//   g's and h's low words before it reads either old value, so the two
//   round trips overlap. The words lie in four planes (g low, g high,
//   h low, h high), so a warp's random segments spread over all 32 banks;
// - the epilogue converts each sum once (from_fixed) and writes two
//   segments' (g, h) per float4;
// - the launcher raises an instantiation's dynamic shared-memory limit
//   (cudaFuncSetAttribute) only when a launch asks for more than it was
//   last given on the device, not on every launch.
//
// The external scale (kExternal; mallorn_hist and mallorn_seg_hist given a
// non-null maxabs) serves a fit whose rows are split over ranks
// (parallel/sharded_train.py). A rank that found its own scale from
// its own rows would round its q on another grid than its neighbours, and
// the float32 histograms of the shards would not add up to the whole's.
// So the caller gives every rank one scale: the per-lane max |g| and
// max |h| over all ranks' rows ([K, 2] float32, a non-finite value as
// +inf) and ceil(log2 N) of the global row count. The CTA skips its scale
// pass and writes the raw int64 sums [K, F, n_seg, 2] instead of float32
// (zeros in a lane whose maxima are not finite). Each rank's int64 sums
// are then exactly the single-device sums restricted to its rows, their
// int64 all-reduce is exact in any order, and one conversion of the total
// (hist_cuda._from_fixed) gives the single-device histogram bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxSmemBytes = 232448;

// The fixed-point scale S = 2^p of a channel whose values are at most
// maxabs: p = 62 - log2n - e with maxabs < 2^e (p = 0 where maxabs is 0 or
// not finite; such a scale is never used). |p| <= 210.
__device__ __forceinline__ int fixed_exponent(float maxabs, int log2n) {
  if (!(maxabs > 0.0f) || isinf(maxabs)) return 0;
  int e;
  frexpf(maxabs, &e);  // maxabs < 2^e
  return 62 - log2n - e;
}

// 2^p for p in [-1022, 1023], built from its bits: exact, and no call to
// a library routine (ldexp, or a double division for 1 / S)
__device__ __forceinline__ double exp2_exact(int p) {
  return __longlong_as_double(static_cast<long long>(p + 1023) << 52);
}

__device__ __forceinline__ double fixed_scale(float maxabs, int log2n) {
  return exp2_exact(fixed_exponent(maxabs, log2n));
}

// The row walk of K4 and K5 (K1 and K3 stage their rows in tiles, below):
// all kBlock threads stride the N rows and call add(s, r) for each row r
// whose segment
// s = (ids[r] - id0) * id_scale + bins[r] - bin0 lies in [0, n_seg), with
// (ids[r] - id0) * id_scale in [0, n_seg) and the bin in the window
// [bin0, bin0 + n_bins).
template <int kBlock, typename Add>
__device__ __forceinline__ void for_each_row(const int16_t* __restrict__ bins,
                                             const int32_t* __restrict__ ids, int N, int id0,
                                             int id_scale, int bin0, int n_bins, int n_seg,
                                             Add add) {
  for (int r = threadIdx.x; r < N; r += kBlock) {
    const long long base = (static_cast<long long>(ids[r]) - id0) * id_scale;
    const int bin = bins[r] - bin0;
    if (base < 0 || base >= n_seg ||
        static_cast<unsigned>(bin) >= static_cast<unsigned>(n_bins))
      continue;
    const long long s = base + bin;
    if (s < n_seg) add(static_cast<int>(s), r);
  }
}

// one int64 fixed-point sum, converted once: sum / S to float32
__device__ __forceinline__ float from_fixed(unsigned long long a, double inv) {
  return __double2float_rn(__dmul_rn(__ll2double_rn(static_cast<long long>(a)), inv));
}

// ---------------------------------------------------------------------------
// K1 and K3 (group_hist_kernel<kLevel, kExternal>; the design is in the
// header above)

constexpr int kSegThreads = 256;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegStages = 2;          // row tiles in flight
constexpr int kSegMaxTileRows = 4096;  // a list entry keeps its row in 16 bits

// shared memory of one CTA, in this order: the G int64 [n_seg, 2]
// histograms as four planes of 32-bit words (g's low and high words, then
// h's: neighbouring segments fall in neighbouring banks); kSegStages row
// tiles, each the rows' ids (4 B a row) and G features' bins (2 B), each
// array with 16 spare bytes for its alignment; the active list, R entries
// of (q_g, q_h) (16 B) and row | base << 16 (4 B), each warp's own R / 8;
// per warp max |g|, max |h| and the non-finite flag (16 B).
// hist_cuda._seg_smem_bytes repeats this sum for hist_layout and
// seg_hist_layout; tests/test_torch_seg_hist.py and
// tests/test_torch_hist.py read these two functions and hold them equal.
__host__ __device__ __forceinline__ size_t seg_stage_bytes(int group, int rows) {
  return 4 * static_cast<size_t>(rows) + 16 + static_cast<size_t>(group) * (2 * rows + 16);
}

size_t seg_smem_bytes(int n_seg, int group, int rows) {
  return 16 * static_cast<size_t>(group) * n_seg + kSegStages * seg_stage_bytes(group, rows) +
         20 * static_cast<size_t>(rows) + 16 * kSegWarps;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stages the elements [r0, r1) of src (n elements) into dst by the
// 16-byte chunks that cover them: element r lands at byte
// (address of src[r]) mod 16 + (r - r0) sizeof(T) of dst when r0 sizeof(T)
// is a multiple of 16. A chunk that reaches outside src[0, n) is copied
// element by element, so nothing outside the array is read.
template <typename T>
__device__ __forceinline__ void stage_rows(char* dst, const T* src, int n, int r0, int r1) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src);
  const uintptr_t hi = lo + static_cast<uintptr_t>(n) * sizeof(T);
  const uintptr_t a0 = (lo + static_cast<uintptr_t>(r0) * sizeof(T)) & ~uintptr_t{15};
  const uintptr_t a1 = lo + static_cast<uintptr_t>(r1) * sizeof(T);
  const int n_chunks = static_cast<int>((a1 - a0 + 15) >> 4);
  for (int c = threadIdx.x; c < n_chunks; c += kSegThreads) {
    const uintptr_t g = a0 + 16 * static_cast<uintptr_t>(c);
    if (g >= lo && g + 16 <= hi) {
      cp_async16(dst + 16 * c, reinterpret_cast<const void*>(g));
    } else {
      for (int b = 0; b < 16; b += static_cast<int>(sizeof(T)))
        if (g + b >= lo && g + b < hi)
          *reinterpret_cast<T*>(dst + 16 * c + b) = *reinterpret_cast<const T*>(g + b);
    }
  }
}

// Adds q[0..C) to cell c's C int64 sums, each kept as a low and a high
// 32-bit word in planes of words (channel j's low words in plane 2 j, its
// high words in plane 2 j + 1, each plane `plane` words), with native
// shared-memory atomics (an int64 atomicAdd on shared memory is a
// compare-and-swap loop): a low word's old value gives its carry, which the
// high word takes with q's high word. Every low word is added before any
// old value is read, so that the C round trips overlap. Every wrap of a low
// word is counted once, so each sum ends at the exact int64 sum, mod 2^64,
// in any order. K1 and K3 take C = 2 (g, h), K4 C = 6 (three digits each).
template <int C>
__device__ __forceinline__ void add_fixed(unsigned* words, int plane, int c,
                                          const long long (&q)[C]) {
  unsigned old[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const unsigned lo = static_cast<unsigned>(q[j]);
    old[j] = lo ? atomicAdd(words + 2 * j * plane + c, lo) : 0u;
  }
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const unsigned lo = static_cast<unsigned>(q[j]);
    // old + lo wrapped: carry 1 into the high word
    const unsigned hi = static_cast<unsigned>(static_cast<unsigned long long>(q[j]) >> 32) +
                        (old[j] > ~lo ? 1u : 0u);
    if (hi) atomicAdd(words + (2 * j + 1) * plane + c, hi);
  }
}

__device__ __forceinline__ void add_fixed(unsigned* words, int plane, int c, longlong2 q) {
  const long long v[2] = {q.x, q.y};
  add_fixed<2>(words, plane, c, v);
}

// channel j's int64 sum of cell c in add_fixed's planes
__device__ __forceinline__ long long fixed_sum(const unsigned* words, int plane, int c, int j) {
  return static_cast<long long>(
      static_cast<unsigned long long>(words[(2 * j + 1) * plane + c]) << 32 |
      words[2 * j * plane + c]);
}

// One CTA per (fold k, features f0 .. f0 + group - 1, window of segments)
// = (blockIdx.y, blockIdx.x, blockIdx.z); tile_rows a multiple of
// kSegThreads. ids are K1's node ids (kLevel: a row is active for a node in
// [0, n_ids = k_nodes), its base is node * n_bins and a bin counts in [0,
// n_bins); one window of all n_seg segments) or K3's segment bases (n_ids
// = n_seg: a row is active for a base in [0, n_seg), a bin counts in [0,
// n_seg - base); n_bins unused; the CTA holds the window [s0, s0 + window)
// of the segments, s0 = blockIdx.z window, and adds only the (row,
// feature) items whose segment base + bin lies in it). kExternal: the
// lane's scale comes from ext_max[k] (max |g|, max |h| of every rank's
// rows) and log2n (of the global row count), and out is int64 [.., n_seg,
// 2] (raw sums); otherwise the CTA finds the scale from its fold's rows and
// out is float32.
template <bool kLevel, bool kExternal>
__global__ void __launch_bounds__(kSegThreads)
group_hist_kernel(const int16_t* __restrict__ binned, const int32_t* __restrict__ ids,
                  const float2* __restrict__ gh, void* __restrict__ out, int F, int N,
                  int n_seg, int n_ids, int n_bins, int window, int group, int tile_rows,
                  int log2n, const float2* __restrict__ ext_max) {
  extern __shared__ uint4 smem[];
  const int k = blockIdx.y;
  const int f0 = blockIdx.x * group;
  const int n_f = min(group, F - f0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = tile_rows;
  // the CTA's segments [s0, s0 + n_cells): K1's all of them
  const int s0 = kLevel ? 0 : blockIdx.z * window;
  const int n_cells = kLevel ? n_seg : min(window, n_seg - s0);
  // a row whose base lies at or past the window's end adds nothing here
  const int n_act = kLevel ? n_ids : min(n_ids, s0 + n_cells);

  // the carve-up of seg_smem_bytes
  const int plane = group * n_cells;  // words per plane; feature g's at g * n_cells
  unsigned* words = reinterpret_cast<unsigned*>(smem);
  char* stage0 = reinterpret_cast<char*>(smem) + 16 * static_cast<size_t>(plane);
  const size_t stage_bytes = seg_stage_bytes(group, R);
  const int bins_off = 4 * R + 16, bin_bytes = 2 * R + 16;
  longlong2* list_q = reinterpret_cast<longlong2*>(stage0 + kSegStages * stage_bytes);
  unsigned* list_rb = reinterpret_cast<unsigned*>(list_q + R);
  float2* red_max = reinterpret_cast<float2*>(list_rb + R);
  int* red_bad = reinterpret_cast<int*>(red_max + kSegWarps);
  const int per_warp = R / kSegWarps;  // a warp's rows of a tile, and its list entries
  const int w0 = warp * per_warp;
  list_q += w0;
  list_rb += w0;

  const int32_t* row_ids = ids + static_cast<size_t>(k) * N;
  const float2* v = gh + static_cast<size_t>(k) * N;
  const int16_t* bins = binned + (static_cast<size_t>(k) * F + f0) * N;
  // where element r0 of a tile sits in its staged array (the same for
  // every tile: R sizeof(T) is a multiple of 16)
  const int ids_mis = static_cast<int>(reinterpret_cast<uintptr_t>(row_ids) & 15);
  const unsigned bins_mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(bins));
  const int n_tiles = (N + R - 1) / R;

  // one commit group per tile (empty past the last), so that a wait for
  // kSegStages - 2 pending groups always means tile t has landed
  auto stage_tile = [&](int t) {
    if (t < n_tiles) {
      char* st = stage0 + (t % kSegStages) * stage_bytes;
      const int r0 = t * R, r1 = min(N, r0 + R);
      stage_rows(st, row_ids, N, r0, r1);
      for (int g = 0; g < n_f; ++g)
        stage_rows(st + bins_off + g * bin_bytes, bins + static_cast<size_t>(g) * N, N, r0, r1);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kSegStages - 1; ++t) stage_tile(t);

  for (int i = tid; i < plane; i += kSegThreads) smem[i] = make_uint4(0u, 0u, 0u, 0u);

  // the fold's scale: max |g|, max |h| over its rows (exact in any order)
  // and whether any value is not finite; eight loads in flight a thread.
  // kExternal: the caller's maxima of every rank's rows
  float mg = 0.0f, mh = 0.0f;
  bool bad = false;
  if (kExternal) {
    const float2 m = ext_max[k];
    mg = m.x;
    mh = m.y;
    bad = !(isfinite(mg) && isfinite(mh));
  } else {
    for (int r0 = tid; r0 < N; r0 += 8 * kSegThreads) {
      float2 w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = r0 + u * kSegThreads;
        w[u] = r < N ? v[r] : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        mg = fmaxf(mg, fabsf(w[u].x));
        mh = fmaxf(mh, fabsf(w[u].y));
        bad = bad || !(isfinite(w[u].x) && isfinite(w[u].y));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, o));
      mh = fmaxf(mh, __shfl_xor_sync(0xffffffffu, mh, o));
    }
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) {
      red_max[warp] = make_float2(mg, mh);
      red_bad[warp] = bad;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kSegWarps; ++w) {
      mg = fmaxf(mg, red_max[w].x);
      mh = fmaxf(mh, red_max[w].y);
      bad = bad || red_bad[w];
    }
  }
  const bool finite = !bad;
  const int pg = fixed_exponent(mg, log2n), ph = fixed_exponent(mh, log2n);
  const double sg = exp2_exact(pg), sh = exp2_exact(ph);

  if (finite) {
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kSegStages - 2>();
      // tile t staged for every thread; the histograms zeroed; tile t - 1
      // added, so its stage takes tile t + kSegStages - 1
      __syncthreads();
      stage_tile(t + kSegStages - 1);
      const char* st = stage0 + (t % kSegStages) * stage_bytes;
      const int32_t* t_ids = reinterpret_cast<const int32_t*>(st + ids_mis);
      const int r0 = t * R, rows = min(R, N - r0);

      // the warp's active rows of the tile, compacted into its list; q
      // once per row, from (g, h) read for the active rows alone (the
      // scale's pass has just brought them into L1)
      int cnt = 0;
      for (int j = 0; j < per_warp; j += 32) {
        const int i = w0 + j + lane;
        // the unsigned compare also drops negative ids
        const int id = i < rows ? t_ids[i] : -1;
        const bool act = static_cast<unsigned>(id) < static_cast<unsigned>(n_act);
        const unsigned mask = __ballot_sync(0xffffffffu, act);
        if (act) {
          const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
          const int base = kLevel ? id * n_bins : id;
          const float2 x = v[r0 + i];
          list_q[pos] = make_longlong2(__double2ll_rn(__dmul_rn(static_cast<double>(x.x), sg)),
                                       __double2ll_rn(__dmul_rn(static_cast<double>(x.y), sh)));
          list_rb[pos] = static_cast<unsigned>(i) | (static_cast<unsigned>(base) << 16);
        }
        cnt += __popc(mask);
      }
      __syncwarp();

      // (entry, feature) items, feature fastest (rows that crowd one cell,
      // as in a missing bin, meet in a warp's atomics G times less often):
      // the staged bin, its range check, the int64 adds
      for (int it = lane; it < cnt * n_f; it += 32) {
        const int e = it / n_f;
        const int g = it - e * n_f;
        const unsigned rb = list_rb[e];
        const int i = static_cast<int>(rb & 0xffffu), base = static_cast<int>(rb >> 16);
        const int16_t* t_bins = reinterpret_cast<const int16_t*>(
            st + bins_off + g * bin_bytes + ((bins_mis + 2u * static_cast<unsigned>(N) * g) & 15u));
        const int bin = t_bins[i];
        if (kLevel) {
          if (static_cast<unsigned>(bin) < static_cast<unsigned>(n_bins))
            add_fixed(words, plane, g * n_cells + base + bin, list_q[e]);
        } else {
          const int c = base + bin - s0;  // the segment's cell in the window
          if (static_cast<unsigned>(bin) < static_cast<unsigned>(n_seg - base) &&
              static_cast<unsigned>(c) < static_cast<unsigned>(n_cells))
            add_fixed(words, plane, g * n_cells + c, list_q[e]);
        }
      }
      __syncwarp();  // the list is free again
    }
    __syncthreads();  // every add is in
  }
  cp_async_wait<0>();

  // kExternal's epilogue: the raw int64 sums, one segment's (g, h) per
  // 16-byte store (zeros where the lane is not finite)
  if (kExternal) {
    for (int g = 0; g < n_f; ++g) {
      const int c0 = g * n_cells;
      longlong2* o = reinterpret_cast<longlong2*>(out) +
                     (static_cast<size_t>(k) * F + f0 + g) * n_seg + s0;
      for (int s = tid; s < n_cells; s += kSegThreads) {
        const int c = c0 + s;
        o[s] = finite ? make_longlong2(
                            static_cast<long long>(
                                static_cast<unsigned long long>(words[plane + c]) << 32 |
                                words[c]),
                            static_cast<long long>(
                                static_cast<unsigned long long>(words[3 * plane + c]) << 32 |
                                words[2 * plane + c]))
                      : make_longlong2(0, 0);
      }
    }
    return;
  }

  // the epilogue: one conversion per sum, two segments per float4 store
  const double inv_g = exp2_exact(-pg), inv_h = exp2_exact(-ph);  // 1 / S, exact
  auto cell = [&](int c) {
    if (!finite) return make_float2(__int_as_float(0x7fc00000), __int_as_float(0x7fc00000));
    const unsigned long long a_g =
        static_cast<unsigned long long>(words[plane + c]) << 32 | words[c];
    const unsigned long long a_h =
        static_cast<unsigned long long>(words[3 * plane + c]) << 32 | words[2 * plane + c];
    return make_float2(from_fixed(a_g, inv_g), from_fixed(a_h, inv_h));
  };
  for (int g = 0; g < n_f; ++g) {
    const int c0 = g * n_cells;
    float* o = reinterpret_cast<float*>(out) +
               ((static_cast<size_t>(k) * F + f0 + g) * n_seg + s0) * 2;
    const int head = (reinterpret_cast<uintptr_t>(o) & 15) ? 1 : 0;  // o is 8-byte aligned
    const int n_pairs = (n_cells - head) >> 1;
    for (int p = tid; p < n_pairs; p += kSegThreads) {
      const int s = head + 2 * p;
      const float2 x = cell(c0 + s), y = cell(c0 + s + 1);
      *reinterpret_cast<float4*>(o + 2 * s) = make_float4(x.x, x.y, y.x, y.y);
    }
    if (tid == 0 && head) *reinterpret_cast<float2*>(o) = cell(c0);
    if (tid == kSegThreads - 1 && ((n_cells - head) & 1))
      *reinterpret_cast<float2*>(o + 2 * (n_cells - 1)) = cell(c0 + n_cells - 1);
  }
}

int ceil_log2(int n) {
  int log2n = 0;
  while ((1LL << log2n) < static_cast<long long>(n)) ++log2n;
  return log2n;
}

constexpr int kMaxDevices = 64;

// Raises fn's dynamic shared-memory limit to smem on the current device
// only when smem exceeds what it was last given there (a driver call per
// launch otherwise): limits only grow, under the caller's lock, so every
// launch runs under a limit at least its own.
int grant_smem(const void* fn, size_t smem, std::mutex& lock, size_t (&granted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> hold(lock);
  if (dev >= kMaxDevices || smem > granted[dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) granted[dev] = smem;
  }
  return 0;
}

// K1's and K3's launch at a layout the wrapper picked (hist_cuda.hist_plan
// or seg_hist_plan); refuses one that does not fit. n_seg is the segments
// per (fold, feature) of out: K1's n_ids = k_nodes nodes of n_bins, K3's
// n_seg (n_ids = n_seg); window the segments of one CTA (K1: all n_seg;
// K3: grid z takes ceil(n_seg / window) windows). At most 65,536 segments:
// a row's list entry keeps its base in 16 bits. kExternal: ext_max [K, 2]
// and log2n come from the caller (log2n of a global row count, at least
// ceil(log2 N) and at most 62) and out is int64; otherwise out is float32
// and the kernel takes log2n = ceil(log2 N).
template <bool kLevel, bool kExternal>
int launch_group(const int16_t* binned, const int32_t* ids, const float* gh, void* out, int K,
                 int F, int N, int n_seg, int n_ids, int n_bins, int window, int group,
                 int tile_rows, const float* ext_max, int log2n, void* stream) {
  static std::mutex lock;
  static size_t granted[kMaxDevices] = {};
  if (K <= 0 || F <= 0 || n_seg <= 0) return 0;
  if (N < 0 || K > 65535 || n_seg > 65536 || window < 1 || window > n_seg ||
      (kLevel && window != n_seg) || (n_seg + window - 1) / window > 65535 || group < 1 ||
      tile_rows < kSegThreads || tile_rows % kSegThreads || tile_rows > kSegMaxTileRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!kExternal) {
    log2n = ceil_log2(N);
  } else if (ext_max == nullptr || log2n < ceil_log2(N) || log2n > 62) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = seg_smem_bytes(window, group, tile_rows);
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = grant_smem(reinterpret_cast<const void*>(group_hist_kernel<kLevel, kExternal>),
                             smem, lock, granted);
  if (err) return err;
  group_hist_kernel<kLevel, kExternal>
      <<<dim3((F + group - 1) / group, K, (n_seg + window - 1) / window), kSegThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(binned, ids, reinterpret_cast<const float2*>(gh),
                                              out, F, N, n_seg, n_ids, n_bins, window, group,
                                              tile_rows, log2n,
                                              reinterpret_cast<const float2*>(ext_max));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K1's wide path: a level of more nodes than one CTA's histograms hold
// (more than 54 of 257 bins: depth 7-8's last levels), and any level of 17
// nodes or more, where it is also the faster (hist_cuda.WIDE_FROM_NODES),
// in two kernels, the row grouping (wide_prep_kernel) and the histograms
// (wide_hist_kernel<kExternal>). The contract is K1's (the header); the
// sums are the same int64 fixed point at the same scale, so the output is
// the one-CTA kernel's and build_histograms_fixed's bit for bit.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s at 700 W): the output. At
// K = 5, F = 222, 257 bins it is 146 MB at 64 nodes and 292 MB at 128
// (float32 (g, h) per cell; twice that in the external scale's int64):
// 0.044 / 0.087 ms, against 5.4 MB of bins, ids and (g, h) in.
//
// What held the design before (each chunk of <= 54 nodes ran the one-CTA
// kernel on the grid's z axis): every chunk's CTA read its fold's whole
// (g, h) for the scale and staged every row tile, then dropped the rows of
// the other chunks (two in three at 128 nodes; with subtraction every right
// child too); a chunk of 32-43 nodes took 132-177 KB of shared memory, one
// CTA per SM, whose epilogue overlapped nothing. This design:
// - wide_prep_kernel, one CTA per fold: a first pass over the fold's rows
//   counts each chunk's active rows (their offsets: an exclusive scan) and,
//   at the fold's own scale, reduces its max |g|, max |h| and non-finite
//   flag into the [K, 2] maxima of hist_cuda.lane_maxabs (+inf in a lane
//   with NaN or inf), the one-CTA kernel's scale bit for bit; a second pass
//   lists each active row once, in row order within its chunk (a warp's
//   rows of one chunk ranked by __match_any_sync, the warps' counts scanned
//   per chunk: no atomics, the same lists on every launch), as (row, node
//   in the chunk) beside its q at the scale (the external scale's: the
//   caller's maxima). Rows whose node is outside [0, k_nodes) join no list;
// - wide_hist_kernel, one CTA per (fold, group of G features, chunk of
//   nodes) (grid (ceil(F / G), K, n_chunks)), walks its chunk's list alone:
//   a thread per entry reads (row, node) and q, 24 bytes of neighbouring
//   entries, gathers the row's G bins (rows in order, so a warp's gathers
//   share sectors; a fold's bins of one feature, 2N bytes, stay in L2 across
//   the chunks' CTAs) and adds q with add_fixed's pairs of 32-bit atomics
//   into the four word planes (G [chunk nodes n_bins, 2] int64 histograms:
//   45 KB at G = 1 and 11 nodes, so several CTAs share an SM and one CTA's
//   epilogue overlaps the others' walks);
// - the epilogue converts each cell once (or writes the raw int64 sums)
//   and writes 16-byte streaming stores (st.global.cs): the output is
//   larger than L2 and is read next by another kernel.
// G and the nodes per chunk come from hist_cuda.wide_plan (WIDE_LAYOUTS,
// from tools/time_hist.py --layouts).
//
// A node of more bins than two fit a CTA (kWideNodeFromBins, 7,264) is a
// chunk of its own and takes node_hist_kernel<kExternal> instead, one CTA
// per (fold, feature, node). Such a node's histogram is almost all empty
// (2,444 rows of a fold over 32 nodes of 16,385 bins fill <0.5% of its
// cells), and the chunk kernel's shared memory grew with its bins: 131 KB
// a CTA at 16,385 bins (two windows of 8,193 on the grid's z axis), one
// CTA per SM, which zeroed its histogram, walked ~76 entries and converted
// 8,193 cells one after the other, slower than zeros + one scatter_add_.
// The per-node kernel's shared memory grows with the node's entries:
// - where the node holds at most `slots` entries (hist_cuda.WIDE_NODE_SLOTS,
//   timed by tools/time_hist.py), it marks each entry's bin in a bitmap of
//   the node's bins (4 B a 32 bins), ranks the bitmap's words (an
//   exclusive scan of their popcounts), so that occupied bin b has slot
//   prefix[b / 32] + popc(the word's bits below b) (slots in bin order),
//   adds each entry's q into its slot's words with add_fixed, and then
//   streams the node's whole run of out with 16-byte streaming stores:
//   zeros (or NaN / raw zeros as below) where a bin is not marked, the
//   converted sums (or the raw int64 sums) where it is;
// - a node of more entries (a shallow level's) takes its bins in windows of
//   at most `slots` bins inside the CTA (hist_cuda.wide_windows): a window's
//   slots are its bins, zeroed, every entry in the window added, the window
//   written, then the next (each window walks every entry again: a crowded
//   node costs a few times its table's time).
// With 5,952 slots a CTA takes at most 115,328 B (32,768 bins), so two
// share an SM at any bin count and one CTA's stores overlap the other's
// walk (with five an SM, at 2,048 slots, the external entry's stores ran
// 7% slower; with one, at 8,192, the float32 entry's 23-26%); a node of up
// to MAX_NODE_BINS (32,768) bins needs no windows on the grid.

constexpr int kPrepThreads = 1024;
constexpr int kPrepWarps = kPrepThreads / 32;
constexpr int kWideMaxChunks = 1024;  // chunks of nodes per level at most
constexpr int kWideThreads = 256;
constexpr int kWideMaxGroup = 4;
// a node of more bins takes node_hist_kernel: two such nodes' histograms
// (16 B a bin) exceed one CTA (hist_cuda.WIDE_NODE_FROM_BINS)
constexpr int kWideNodeFromBins = 7264;

// the prep kernel's shared memory: each chunk's cursor and each warp's
// position in it
size_t prep_smem_bytes(int n_chunks) {
  return 4 * static_cast<size_t>(n_chunks) * (1 + kPrepWarps);
}

// One CTA per fold k. entries [K, N] int2 (row, node - the chunk's first
// node) and q [K, N] longlong2: fold k's active rows grouped by chunk of
// chunk_nodes nodes, in row order within a chunk (chunk c's at
// [offsets[k, c], offsets[k, c + 1])), q zero in a lane that is not
// finite; offsets [K, n_chunks + 1]. ext_max null: the fold's own scale,
// its maxima written to maxabs [K, 2]; else the caller's maxima ext_max
// [K, 2] (maxabs unwritten).
__global__ void __launch_bounds__(kPrepThreads)
wide_prep_kernel(const int32_t* __restrict__ ids, const float2* __restrict__ gh, int N,
                 int k_nodes, int chunk_nodes, int n_chunks, int log2n,
                 const float2* __restrict__ ext_max, int2* __restrict__ entries,
                 longlong2* __restrict__ q_out, int32_t* __restrict__ offsets,
                 float2* __restrict__ maxabs) {
  extern __shared__ int prep_smem[];
  int* cursor = prep_smem;               // [n_chunks]
  int* warp_pos = prep_smem + n_chunks;  // [kPrepWarps, n_chunks]
  __shared__ float2 red_max[kPrepWarps];
  __shared__ int red_bad[kPrepWarps];
  __shared__ float2 fold_max;
  const int k = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* row_ids = ids + static_cast<size_t>(k) * N;
  const float2* v = gh + static_cast<size_t>(k) * N;
  for (int c = tid; c < n_chunks; c += kPrepThreads) cursor[c] = 0;
  __syncthreads();

  // the chunks' counts, and the fold's maxima (exact in any order)
  float mg = 0.0f, mh = 0.0f;
  bool bad = false;
  for (int r = tid; r < N; r += kPrepThreads) {
    const int id = row_ids[r];
    if (static_cast<unsigned>(id) < static_cast<unsigned>(k_nodes))
      atomicAdd(cursor + id / chunk_nodes, 1);
    if (ext_max == nullptr) {
      const float2 x = v[r];
      mg = fmaxf(mg, fabsf(x.x));
      mh = fmaxf(mh, fabsf(x.y));
      bad = bad || !(isfinite(x.x) && isfinite(x.y));
    }
  }
  if (ext_max == nullptr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, o));
      mh = fmaxf(mh, __shfl_xor_sync(0xffffffffu, mh, o));
    }
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) {
      red_max[warp] = make_float2(mg, mh);
      red_bad[warp] = bad;
    }
  }
  __syncthreads();

  // the offsets: an exclusive scan of the counts, which become the chunks'
  // cursors (one thread: a level has few chunks); the fold's maxima
  if (tid == 0) {
    int32_t* off = offsets + static_cast<size_t>(k) * (n_chunks + 1);
    int total = 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int n = cursor[c];
      off[c] = cursor[c] = total;
      total += n;
    }
    off[n_chunks] = total;
    if (ext_max == nullptr) {
      for (int w = 0; w < kPrepWarps; ++w) {
        mg = fmaxf(mg, red_max[w].x);
        mh = fmaxf(mh, red_max[w].y);
        bad = bad || red_bad[w];
      }
      const float inf = __int_as_float(0x7f800000);
      fold_max = bad ? make_float2(inf, inf) : make_float2(mg, mh);
      maxabs[k] = fold_max;
    } else {
      fold_max = ext_max[k];
    }
  }
  __syncthreads();
  const float2 m = fold_max;
  const bool finite = isfinite(m.x) && isfinite(m.y);
  const double sg = exp2_exact(fixed_exponent(m.x, log2n));
  const double sh = exp2_exact(fixed_exponent(m.y, log2n));

  // the lists, kPrepThreads rows at a time: a row's place is its chunk's
  // cursor, plus the rows of that chunk in the warps before its own, plus
  // those in its warp's lanes before its own
  int2* fold_entries = entries + static_cast<size_t>(k) * N;
  longlong2* fold_q = q_out + static_cast<size_t>(k) * N;
  const unsigned below = (1u << lane) - 1u;
  for (int r0 = 0; r0 < N; r0 += kPrepThreads) {
    for (int i = tid; i < kPrepWarps * n_chunks; i += kPrepThreads) warp_pos[i] = 0;
    __syncthreads();
    const int r = r0 + tid;
    const int id = r < N ? row_ids[r] : -1;
    const int c = static_cast<unsigned>(id) < static_cast<unsigned>(k_nodes) ? id / chunk_nodes
                                                                             : -1;
    const unsigned same = __match_any_sync(0xffffffffu, c);
    if (c >= 0 && (same & below) == 0) warp_pos[warp * n_chunks + c] = __popc(same);
    __syncthreads();
    for (int cc = tid; cc < n_chunks; cc += kPrepThreads) {
      int run = cursor[cc];
      for (int w = 0; w < kPrepWarps; ++w) {
        const int n = warp_pos[w * n_chunks + cc];
        warp_pos[w * n_chunks + cc] = run;
        run += n;
      }
      cursor[cc] = run;
    }
    __syncthreads();
    if (c >= 0) {
      const int pos = warp_pos[warp * n_chunks + c] + __popc(same & below);
      fold_entries[pos] = make_int2(r, id - c * chunk_nodes);
      longlong2 q = make_longlong2(0, 0);
      if (finite) {
        const float2 x = v[r];
        q = make_longlong2(__double2ll_rn(__dmul_rn(static_cast<double>(x.x), sg)),
                           __double2ll_rn(__dmul_rn(static_cast<double>(x.y), sh)));
      }
      fold_q[pos] = q;
    }
    __syncthreads();  // warp_pos is read before the next rows clear it
  }
}

// the wide kernel's shared memory: the G int64 [chunk_nodes n_bins, 2]
// histograms as four planes of 32-bit words (hist_cuda._wide_smem_bytes
// repeats it; the CPU tests hold the two equal)
size_t wide_smem_bytes(int chunk_nodes, int n_bins, int group) {
  return 16 * static_cast<size_t>(group) * chunk_nodes * n_bins;
}

// The row's sums of chunk cell c, converted once (float32; NaN where the
// lane is not finite), for the epilogues below
struct FixedCells {
  const unsigned* words;
  int plane;
  bool finite;
  double inv_g, inv_h;  // 1 / S, exact
  __device__ float2 operator()(int c) const {
    if (!finite) return make_float2(__int_as_float(0x7fc00000), __int_as_float(0x7fc00000));
    return make_float2(
        from_fixed(static_cast<unsigned long long>(fixed_sum(words, plane, c, 0)), inv_g),
        from_fixed(static_cast<unsigned long long>(fixed_sum(words, plane, c, 1)), inv_h));
  }
};

// Writes n cells of float32 (g, h), cell(i) for cell i, to the run at o
// (8-byte aligned) with 16-byte streaming stores, two cells a store
template <typename Cell>
__device__ __forceinline__ void store_run(float* o, int n, const Cell& cell) {
  const int head = (reinterpret_cast<uintptr_t>(o) & 15) ? 1 : 0;
  const int n_pairs = (n - head) >> 1;
  for (int p = threadIdx.x; p < n_pairs; p += kWideThreads) {
    const int s = head + 2 * p;
    const float2 x = cell(s), y = cell(s + 1);
    __stcs(reinterpret_cast<float4*>(o + 2 * s), make_float4(x.x, x.y, y.x, y.y));
  }
  if (threadIdx.x == 0 && head) __stcs(reinterpret_cast<float2*>(o), cell(0));
  if (threadIdx.x == kWideThreads - 1 && n > head && ((n - head) & 1))
    __stcs(reinterpret_cast<float2*>(o + 2 * (n - 1)), cell(n - 1));
}

// One CTA per (fold k, features f0 .. f0 + group - 1, chunk of nodes) =
// (blockIdx.y, blockIdx.x, blockIdx.z): the chunk's nodes [node0, node0 +
// chunk_nodes) of k_nodes, its rows the prep's list. maxabs [K, 2] and
// log2n: the scale of the prep's q (the fold's own, or kExternal the
// caller's; a lane whose maxima are not finite adds nothing). out [K, F,
// k_nodes, n_bins, 2]: float32 (NaN in a lane that is not finite), or
// kExternal the raw int64 sums (zeros there).
template <bool kExternal>
__global__ void __launch_bounds__(kWideThreads)
wide_hist_kernel(const int16_t* __restrict__ binned, const int2* __restrict__ entries,
                 const longlong2* __restrict__ q, const int32_t* __restrict__ offsets,
                 const float2* __restrict__ maxabs, void* __restrict__ out, int F, int N,
                 int k_nodes, int n_bins, int chunk_nodes, int n_chunks, int group, int log2n) {
  extern __shared__ uint4 smem[];
  const int k = blockIdx.y;
  const int f0 = blockIdx.x * group;
  const int n_f = min(group, F - f0);
  const int chunk = blockIdx.z;
  const int node0 = chunk * chunk_nodes;
  const int n_seg = min(chunk_nodes, k_nodes - node0) * n_bins;
  const int plane = group * n_seg;  // words per plane; feature g's at g * n_seg
  const int tid = threadIdx.x;
  unsigned* words = reinterpret_cast<unsigned*>(smem);
  for (int i = tid; i < plane; i += kWideThreads) smem[i] = make_uint4(0u, 0u, 0u, 0u);

  const float2 m = maxabs[k];
  const bool finite = isfinite(m.x) && isfinite(m.y);
  const int32_t* off = offsets + static_cast<size_t>(k) * (n_chunks + 1) + chunk;
  const int e0 = off[0], e1 = off[1];
  __syncthreads();  // the histograms zeroed

  if (finite) {
    const int2* fold_entries = entries + static_cast<size_t>(k) * N;
    const longlong2* fold_q = q + static_cast<size_t>(k) * N;
    const int16_t* bins = binned + (static_cast<size_t>(k) * F + f0) * N;
    for (int e = e0 + tid; e < e1; e += kWideThreads) {
      const int2 en = fold_entries[e];
      // every bin first, then the adds: the loads in flight together
      int b[kWideMaxGroup];
#pragma unroll
      for (int g = 0; g < kWideMaxGroup; ++g)
        b[g] = g < n_f ? bins[static_cast<size_t>(g) * N + en.x] : -1;
      const longlong2 qe = fold_q[e];
      const int base = en.y * n_bins;
#pragma unroll
      for (int g = 0; g < kWideMaxGroup; ++g)
        if (static_cast<unsigned>(b[g]) < static_cast<unsigned>(n_bins))
          add_fixed(words, plane, g * n_seg + base + b[g], qe);
    }
  }
  __syncthreads();  // every add is in

  // the CTA's cells of feature f0 + g: one contiguous run of n_seg in out
  const size_t n_seg_out = static_cast<size_t>(k_nodes) * n_bins;
  const size_t seg0 = static_cast<size_t>(node0) * n_bins;
  if (kExternal) {  // the raw int64 sums, one cell per 16-byte store (zeros if not finite)
    for (int g = 0; g < n_f; ++g) {
      longlong2* o = reinterpret_cast<longlong2*>(out) +
                     (static_cast<size_t>(k) * F + f0 + g) * n_seg_out + seg0;
      for (int s = tid; s < n_seg; s += kWideThreads) {
        const int c = g * n_seg + s;
        __stcs(o + s, finite ? make_longlong2(fixed_sum(words, plane, c, 0),
                                              fixed_sum(words, plane, c, 1))
                             : make_longlong2(0, 0));
      }
    }
    return;
  }
  // one conversion per sum, two cells per float4 store
  const FixedCells cells{words, plane, finite, exp2_exact(-fixed_exponent(m.x, log2n)),
                         exp2_exact(-fixed_exponent(m.y, log2n))};
  for (int g = 0; g < n_f; ++g) {
    const int c0 = g * n_seg;
    float* o = reinterpret_cast<float*>(out) +
               ((static_cast<size_t>(k) * F + f0 + g) * n_seg_out + seg0) * 2;
    store_run(o, n_seg, [&](int s) { return cells(c0 + s); });
  }
}

// the per-node kernel's shared memory (hist_cuda._node_smem_bytes repeats
// it; the CPU tests hold the two equal): `slots` cells of four word planes
// (16 B) and an entry's bin (2 B) each, then the bitmap of the node's bins
// and its words' ranks (4 B each a word of 32 bins)
size_t node_smem_bytes(int n_bins, int slots) {
  return 18 * static_cast<size_t>(slots) + 8 * static_cast<size_t>((n_bins + 31) / 32);
}

// rank[w] = the set bits of bitmap[0 .. w), for w < n_words: each thread
// counts a run of consecutive words, the runs scanned across the CTA (a
// warp's by shuffles, the warps' totals in order). Every thread of the CTA
// calls it; the ranks are in shared memory after the caller's next barrier.
__device__ __forceinline__ void rank_bitmap(const unsigned* bitmap, int* rank, int n_words) {
  __shared__ int warp_total[kWideThreads / 32];
  const int per = (n_words + kWideThreads - 1) / kWideThreads;
  const int w0 = min(n_words, threadIdx.x * per), w1 = min(n_words, w0 + per);
  int own = 0;
  for (int w = w0; w < w1; ++w) own += __popc(bitmap[w]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int run = incl - own;
  for (int w = 0; w < warp; ++w) run += warp_total[w];
  for (int w = w0; w < w1; ++w) {
    rank[w] = run;
    run += __popc(bitmap[w]);
  }
}

// Calls visit(e, bin) for each of a node's n entries e (bin: the entry's
// row's bin of this feature), kWalk entries a thread at a time: every row
// id, then every bin, is loaded before any visit, so that a thread's loads
// are in flight together (a crowded node's walk is bound by their latency)
constexpr int kWalk = 4;
template <typename Visit>
__device__ __forceinline__ void walk_entries(const int2* __restrict__ entries,
                                             const int16_t* __restrict__ bins, int n,
                                             Visit visit) {
  for (int e0 = threadIdx.x; e0 < n; e0 += kWalk * kWideThreads) {
    int row[kWalk], b[kWalk];
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      const int e = e0 + u * kWideThreads;
      row[u] = e < n ? entries[e].x : -1;
    }
#pragma unroll
    for (int u = 0; u < kWalk; ++u) b[u] = row[u] >= 0 ? bins[row[u]] : -1;
#pragma unroll
    for (int u = 0; u < kWalk; ++u)
      if (row[u] >= 0) visit(e0 + u * kWideThreads, b[u]);
  }
}

// One CTA per (fold k, feature f, node) = (blockIdx.y, blockIdx.x,
// blockIdx.z) of a level whose nodes are chunks of one (n_bins >
// kWideNodeFromBins); the node's rows the prep's list. A node of at most
// `slots` entries takes the table of its occupied bins, a node of more its
// bins in windows of window_bins (<= slots) inside the CTA (the design note
// above). maxabs, log2n and out as wide_hist_kernel's.
template <bool kExternal>
__global__ void __launch_bounds__(kWideThreads)
node_hist_kernel(const int16_t* __restrict__ binned, const int2* __restrict__ entries,
                 const longlong2* __restrict__ q, const int32_t* __restrict__ offsets,
                 const float2* __restrict__ maxabs, void* __restrict__ out, int F, int N,
                 int k_nodes, int n_bins, int slots, int window_bins, int log2n) {
  extern __shared__ uint4 smem[];
  const int f = blockIdx.x, k = blockIdx.y, node = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_words = (n_bins + 31) / 32;
  // the carve-up of node_smem_bytes
  unsigned* words = reinterpret_cast<unsigned*>(smem);  // four planes of `slots` words
  unsigned short* entry_bin = reinterpret_cast<unsigned short*>(words + 4 * slots);
  unsigned* bitmap = reinterpret_cast<unsigned*>(entry_bin + slots);
  int* rank = reinterpret_cast<int*>(bitmap + n_words);

  const float2 m = maxabs[k];
  const bool finite = isfinite(m.x) && isfinite(m.y);
  const int32_t* off = offsets + static_cast<size_t>(k) * (k_nodes + 1) + node;
  const int e0 = off[0], n = off[1] - e0;
  const int2* node_entries = entries + static_cast<size_t>(k) * N + e0;
  const longlong2* node_q = q + static_cast<size_t>(k) * N + e0;
  const int16_t* bins = binned + (static_cast<size_t>(k) * F + f) * N;
  // the node's run of out: n_bins cells of feature f
  const size_t cell0 = (static_cast<size_t>(k) * F + f) * k_nodes * n_bins +
                       static_cast<size_t>(node) * n_bins;
  const double inv_g = exp2_exact(-fixed_exponent(m.x, log2n));  // 1 / S, exact
  const double inv_h = exp2_exact(-fixed_exponent(m.y, log2n));
  // writes cells [b0, b0 + nb) of the run, cell b from slot slot_of(b) of
  // planes of `plane` words (-1: an empty cell)
  auto write = [&](int b0, int nb, int plane, auto slot_of) {
    if (kExternal) {
      longlong2* o = reinterpret_cast<longlong2*>(out) + cell0 + b0;
      for (int b = tid; b < nb; b += kWideThreads) {
        const int c = finite ? slot_of(b) : -1;
        __stcs(o + b, c < 0 ? make_longlong2(0, 0)
                            : make_longlong2(fixed_sum(words, plane, c, 0),
                                             fixed_sum(words, plane, c, 1)));
      }
    } else {
      const FixedCells sums{words, plane, finite, inv_g, inv_h};
      float* o = reinterpret_cast<float*>(out) + (cell0 + b0) * 2;
      store_run(o, nb, [&](int b) {
        if (!finite) return sums(0);  // NaN
        const int c = slot_of(b);
        return c < 0 ? make_float2(0.0f, 0.0f) : sums(c);
      });
    }
  };

  if (n <= slots) {
    // the table of occupied bins: the bitmap, its ranks, one slot a bin
    for (int w = tid; w < n_words; w += kWideThreads) bitmap[w] = 0u;
    for (int i = tid; i < n; i += kWideThreads) {
#pragma unroll
      for (int p = 0; p < 4; ++p) words[p * slots + i] = 0u;
    }
    __syncthreads();
    if (finite) {
      walk_entries(node_entries, bins, n, [&](int e, int b) {
        const bool in = static_cast<unsigned>(b) < static_cast<unsigned>(n_bins);
        entry_bin[e] = in ? static_cast<unsigned short>(b) : 0xFFFFu;
        if (in) atomicOr(bitmap + (b >> 5), 1u << (b & 31));
      });
    }
    __syncthreads();
    rank_bitmap(bitmap, rank, n_words);
    __syncthreads();
    if (finite) {
      // kWalk entries a thread at a time, their q loaded before any add
      for (int e0 = tid; e0 < n; e0 += kWalk * kWideThreads) {
        int slot[kWalk];
        longlong2 qe[kWalk];
#pragma unroll
        for (int u = 0; u < kWalk; ++u) {
          const int e = e0 + u * kWideThreads;
          const unsigned b = e < n ? entry_bin[e] : 0xFFFFu;
          slot[u] = -1;
          if (b != 0xFFFFu) {
            slot[u] = rank[b >> 5] + __popc(bitmap[b >> 5] & ((1u << (b & 31)) - 1u));
            qe[u] = node_q[e];
          }
        }
#pragma unroll
        for (int u = 0; u < kWalk; ++u)
          if (slot[u] >= 0) add_fixed(words, slots, slot[u], qe[u]);
      }
    }
    __syncthreads();  // every add is in
    write(0, n_bins, slots, [&](int b) {
      const unsigned bits = bitmap[b >> 5], bit = 1u << (b & 31);
      return (bits & bit) ? rank[b >> 5] + __popc(bits & (bit - 1u)) : -1;
    });
    return;
  }
  // a node of more entries than slots: its bins in windows, each window's
  // slots its bins
  for (int b0 = 0; b0 < n_bins; b0 += window_bins) {
    const int nb = min(window_bins, n_bins - b0);
    for (int i = tid; i < slots; i += kWideThreads) smem[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    if (finite) {
      walk_entries(node_entries, bins, n, [&](int e, int b) {
        b -= b0;
        if (static_cast<unsigned>(b) < static_cast<unsigned>(nb))
          add_fixed(words, slots, b, node_q[e]);
      });
    }
    __syncthreads();  // every add of the window is in
    write(b0, nb, slots, [](int b) { return b; });
    __syncthreads();  // the window is read before the next one zeroes it
  }
}

int wide_chunks(int k_nodes, int chunk_nodes) { return (k_nodes + chunk_nodes - 1) / chunk_nodes; }

// The prep kernel's launch; refuses more than kWideMaxChunks chunks.
// ext_max null: the folds' own scale (log2n = ceil(log2 N)), their maxima
// written to maxabs; else the caller's maxima and log2n (of a global row
// count, at least ceil(log2 N) and at most 62).
int launch_wide_prep(const int32_t* ids, const float* gh, int2* entries, long long* q,
                     int32_t* offsets, const float* ext_max, float* maxabs, int K, int N,
                     int k_nodes, int chunk_nodes, int log2n, void* stream) {
  static std::mutex lock;
  static size_t granted[kMaxDevices] = {};
  if (K <= 0) return 0;
  if (N < 0 || k_nodes < 1 || chunk_nodes < 1 ||
      wide_chunks(k_nodes, chunk_nodes) > kWideMaxChunks ||
      (ext_max == nullptr) == (maxabs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ext_max == nullptr) {
    log2n = ceil_log2(N);
  } else if (log2n < ceil_log2(N) || log2n > 62) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_chunks = wide_chunks(k_nodes, chunk_nodes);
  const size_t smem = prep_smem_bytes(n_chunks);
  const int err = grant_smem(reinterpret_cast<const void*>(wide_prep_kernel), smem, lock, granted);
  if (err) return err;
  wide_prep_kernel<<<K, kPrepThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ids, reinterpret_cast<const float2*>(gh), N, k_nodes, chunk_nodes, n_chunks, log2n,
      reinterpret_cast<const float2*>(ext_max), entries, reinterpret_cast<longlong2*>(q),
      offsets, reinterpret_cast<float2*>(maxabs));
  return static_cast<int>(cudaGetLastError());
}

// The wide path's histogram launch; refuses a layout that does not fit.
// A level of nodes of at most kWideNodeFromBins bins takes the chunk
// kernel (window_bins and slots unused); of wider nodes, the per-node
// kernel (chunk_nodes and group 1; slots a multiple of 32, window_bins
// <= slots the bins of its windows). log2n as launch_wide_prep's (the
// caller's when kExternal, else ceil(log2 N)).
template <bool kExternal>
int launch_wide(const int16_t* binned, const int2* entries, const long long* q,
                const int32_t* offsets, const float* maxabs, void* out, int K, int F, int N,
                int k_nodes, int n_bins, int chunk_nodes, int group, int slots, int window_bins,
                int log2n, void* stream) {
  static std::mutex lock, node_lock;
  static size_t granted[kMaxDevices] = {}, node_granted[kMaxDevices] = {};
  if (K <= 0 || F <= 0) return 0;
  const int n_chunks = chunk_nodes < 1 ? 0 : wide_chunks(k_nodes, chunk_nodes);
  const bool per_node = n_bins > kWideNodeFromBins;
  if (N < 0 || K > 65535 || k_nodes < 1 || n_bins < 1 || chunk_nodes < 1 ||
      n_chunks > kWideMaxChunks || n_chunks > 65535 || group < 1 || group > kWideMaxGroup ||
      maxabs == nullptr ||
      (per_node && (chunk_nodes != 1 || group != 1 || slots < 32 || slots % 32 ||
                    window_bins < 1 || window_bins > slots)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!kExternal) {
    log2n = ceil_log2(N);
  } else if (log2n < ceil_log2(N) || log2n > 62) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      per_node ? node_smem_bytes(n_bins, slots) : wide_smem_bytes(chunk_nodes, n_bins, group);
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* m = reinterpret_cast<const float2*>(maxabs);
  const longlong2* q2 = reinterpret_cast<const longlong2*>(q);
  if (per_node) {
    const int err = grant_smem(reinterpret_cast<const void*>(node_hist_kernel<kExternal>), smem,
                               node_lock, node_granted);
    if (err) return err;
    node_hist_kernel<kExternal><<<dim3(F, K, k_nodes), kWideThreads, smem, s>>>(
        binned, entries, q2, offsets, m, out, F, N, k_nodes, n_bins, slots, window_bins, log2n);
    return static_cast<int>(cudaGetLastError());
  }
  const int err = grant_smem(reinterpret_cast<const void*>(wide_hist_kernel<kExternal>), smem,
                             lock, granted);
  if (err) return err;
  wide_hist_kernel<kExternal><<<dim3((F + group - 1) / group, K, n_chunks), kWideThreads, smem,
                                s>>>(binned, entries, q2, offsets, m, out, F, N, k_nodes, n_bins,
                                     chunk_nodes, n_chunks, group, log2n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K4 / K5: the depthwise fit's histogram modes (GBDTParams.hist_dtype
// "bf16" / "i8bf16" and "int8"), one template: mode_hist_kernel<kInt8,
// kExternal>.
//
// K4 (mode_hist_kernel<false, .>) replaces mallorn_tpu/ops/hist_pallas.py:
// _binlane_kernel (behind build_histograms_binlane); K5
// (mode_hist_kernel<true, .>) replaces _binlane_kernel_i8 (behind
// build_histograms_binlane_i8). Both keep K1's contract: for fold k,
// feature f, node c < k_nodes and bin b < n_bins_tot,
//   out[k, f, c, b, ch] = sum_r [nodes[k, r] == c] [binned[k, f, r] == b] x_ch(r)
// but x enters as digits: K4 takes 3 bf16 digits each of g and h
// (hist_cuda.split_gh_digits), K5 4 balanced base-128 int8 digits of a
// 26-bit fixed-point (g, h) (hist_cuda.quantize_gh_i8).
//
// The TPU kernels scatter through the MXU (a one-hot times the digits),
// because a TPU has no scatter. Here the design is K1's first one: one CTA per
// (fold, feature, group of <= 8 nodes) (grid (F, K, ceil(k_nodes / 8))),
// a [nodes, n_bins_tot, C] integer histogram in shared memory, every
// thread striding the fold's rows once (for_each_row, the first K1's row
// walk, with the group's first node as id0) and adding an active row's C digit
// channels with shared-memory integer atomics (a zero digit adds
// nothing and is skipped). Integer sums are exact and order-free, so two
// launches give the same bits.
//
// Wide bins (hist_cuda.mode_plan): a group holds the most of 1-8 nodes
// whose [nodes, n_bins_tot, C] cells fit a CTA (8 up to 604 bins for K4,
// 907 for K5, so every 257-bin level keeps the grid above); where one
// node's bins do not fit (K4 beyond 4,842, K5 beyond 7,264) the group is
// one node and its bins are split into equal windows, each a CTA of its own
// (grid z = node groups x windows) that walks all the fold's rows and adds
// those whose bin lies in its window. The sums stay exact, so a windowed
// launch gives the one-window launch's bits; a window re-reads the rows.
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
// K4: C = 6 int64 fixed-point cells (g's d0, d1, d2, then h's), each a
// low and a high 32-bit word in 12 planes of words (channel c's in planes
// 2 c and 2 c + 1), added by add_fixed<6>: six native 32-bit atomics on the
// low words, then the high words with the carries, as K1 and K3 add their
// two channels (an int64 atomicAdd on shared memory compiles to a
// compare-and-swap loop, which held K4 at 0.1108 ms at the v92d CV's
// deepest level on an H100 80GB HBM3, 700 W; tools/time_hist.py); 8 nodes x
// 257 bins take 98,688 B, as before. Each digit channel gets K1's per-fold
// scale,
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
// kernel spends its time as the first K1 did, on shared-memory atomics
// (8 int32, or 6-12 32-bit words of the six int64 sums, per active row
// and feature, serialised where rows share a bin, as in a crowded missing
// bin) and on zeroing and writing the whole histogram. Each of a fold's F
// CTAs computes its active rows' six products q = round(digit S_c) again
// (FP64). Taking q [K, N, 6] int64 from the prep kernel instead would make
// every CTA read 48 B a row rather than the digits' 12: 130 MB from L2 a
// launch at that level, against an estimated ~4 us of FP64 work (six
// multiplies and conversions per active row and feature at 16 conversions
// a clock an SM); that variant was not built or timed.
//
// The external scale (kExternal; mallorn_hist_bf16 / mallorn_hist_i8 given
// external = 1) serves a fit whose rows are split over ranks, as K1's does:
// every rank's digits must sit on one grid, and the ranks add integers, not
// floats. K5: the caller quantizes (g, h) at the s of every rank's rows
// (max |x| max-reduced), and the kernel writes each cell's eight raw digit
// sums [K, F, k_nodes, n_bins_tot, 8] int32 (32 B a cell; exact up to 2^25
// global rows, which the launch enforces). K4: each digit channel's scale
// comes from the caller's max |digit| [K, 6] (every rank's) and log2 of the
// global row count, and the kernel writes the six raw int64 sums [.., 6]
// (48 B a cell; zeros in a lane whose maxima are not finite). The
// all-reduced sums, converted once (hist_cuda.from_i8_sums: the
// recombination above; hist_cuda.from_bf16_sums: one conversion per digit
// channel, then (S0 + S1) + S2), are the single-device histograms bit for
// bit. The accumulation is the float32 launch's; only the epilogue differs.

// 512 threads per CTA: an SM holds 3 (K5) or 2 (K4) CTAs of 65,792 /
// 98,688 B, 1,536 / 1,024 threads; of 256, 512 and 1,024, 512 was the
// fastest for both modes at the v92d CV's deepest level on an H100 (at one
// node, K4 is faster with 256)
constexpr int kModeThreads = 512;
constexpr int kModeNodes = 8;  // nodes per CTA at most (hist_cuda.MODE_NODES)

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

// One CTA per (feature f, fold k, group of node_group nodes and window of
// window_bins bins) = (blockIdx.x, blockIdx.y, blockIdx.z = group
// n_windows + window); n_windows > 1 only with one node per group, so that
// the CTA's cells are one run of out (hist_cuda.mode_plan).
template <bool kInt8, bool kExternal>
__global__ void __launch_bounds__(kModeThreads)
mode_hist_kernel(const int16_t* __restrict__ binned, const int32_t* __restrict__ nodes,
                 const void* __restrict__ digits, const float* __restrict__ scale,
                 void* __restrict__ out, int F, int N, int k_nodes, int n_bins_tot,
                 int node_group, int n_windows, int window_bins, int log2n) {
  constexpr int C = ModeTraits<kInt8>::kChannels;
  extern __shared__ uint4 smem[];
  const int f = blockIdx.x;
  const int k = blockIdx.y;
  const int grp = blockIdx.z / n_windows;
  const int bin0 = (blockIdx.z - grp * n_windows) * window_bins;
  const int nb = min(window_bins, n_bins_tot - bin0);  // the window's bins
  const int node0 = grp * node_group;
  const int n_nodes = min(node_group, k_nodes - node0);
  const int n_seg = n_nodes * nb;
  const int16_t* b = binned + (static_cast<size_t>(k) * F + f) * N;
  const int32_t* nd = nodes + static_cast<size_t>(k) * N;
  // the CTA's first (node, bin) cell of out; its cells are one contiguous
  // run of n_seg: float32 (g, h) pairs, or kExternal's C raw sums each
  const size_t cell0 =
      ((static_cast<size_t>(k) * F + f) * k_nodes + node0) * n_bins_tot + bin0;
  float* o = static_cast<float*>(out) + cell0 * 2;
  const int n_out = n_seg * 2;  // output cell i = (node, bin) * 2 + channel

  if constexpr (kInt8) {
    // cell s's digit sums: acc[8 s .. 8 s + 8), g's four then h's, one int4 each
    int* acc = reinterpret_cast<int*>(smem);
    for (int i = threadIdx.x; i < n_seg * C / 4; i += kModeThreads)
      smem[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    const uint2* w = static_cast<const uint2*>(digits) + static_cast<size_t>(k) * N;
    for_each_row<kModeThreads>(b, nd, N, node0, nb, bin0, nb, n_seg,
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

    if constexpr (kExternal) {
      // the raw digit sums, [n_seg, 8] int32, two int4 stores per cell
      int4* oi = static_cast<int4*>(out) + cell0 * 2;
      for (int i = threadIdx.x; i < n_out; i += kModeThreads)
        oi[i] = reinterpret_cast<const int4*>(acc)[i];
      return;
    }
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
    // channel c's int64 fixed-point sum of cell s as two 32-bit words,
    // in planes 2 c and 2 c + 1 of n_seg words each (add_fixed<6>)
    unsigned* words = reinterpret_cast<unsigned*>(smem);
    for (int i = threadIdx.x; i < n_seg * C / 2; i += kModeThreads)
      smem[i] = make_uint4(0u, 0u, 0u, 0u);
    // channel c's scale S_c = 2^(62 - log2n - e) with maxabs[c] < 2^e; a
    // lane with a maximum that is not finite adds nothing
    const float* maxabs = scale + C * k;
    bool finite = true;
    double sc[C], inv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float m = maxabs[c];
      finite = finite && isfinite(m);
      const int p = fixed_exponent(m, log2n);
      sc[c] = exp2_exact(p);
      inv[c] = exp2_exact(-p);  // 1 / S_c, exact
    }
    __syncthreads();

    if (finite) {
      // three 4-byte words per row: bf16 digit 2 j in word j's low half
      const uint32_t* w = static_cast<const uint32_t*>(digits) + static_cast<size_t>(k) * N * 3;
      for_each_row<kModeThreads>(b, nd, N, node0, nb, bin0, nb, n_seg, [&](int s, int r) {
        long long q[C];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const uint32_t v = w[3 * static_cast<size_t>(r) + j];
          q[2 * j] = __double2ll_rn(__dmul_rn(static_cast<double>(__uint_as_float(v << 16)),
                                              sc[2 * j]));
          q[2 * j + 1] = __double2ll_rn(
              __dmul_rn(static_cast<double>(__uint_as_float(v & 0xFFFF0000u)), sc[2 * j + 1]));
        }
        add_fixed<C>(words, n_seg, s, q);
      });
    }
    __syncthreads();

    if constexpr (kExternal) {
      // the raw int64 sums, [n_seg, 6]: store i holds cell i / 3's channels
      // 2 (i % 3) and 2 (i % 3) + 1 (zeros where a channel's maximum is not
      // finite: nothing was added)
      longlong2* oi = static_cast<longlong2*>(out) + cell0 * 3;
      for (int i = threadIdx.x; i < n_seg * 3; i += kModeThreads) {
        const int s = i / 3, j = 2 * (i - 3 * s);
        oi[i] = make_longlong2(fixed_sum(words, n_seg, s, j), fixed_sum(words, n_seg, s, j + 1));
      }
      return;
    }
    for (int i = threadIdx.x; i < n_out; i += kModeThreads) {
      const int s = i >> 1, c0 = 3 * (i & 1);
      auto digit = [&](int c) {
        return from_fixed(static_cast<unsigned long long>(fixed_sum(words, n_seg, s, c)), inv[c]);
      };
      o[i] = finite ? __fadd_rn(__fadd_rn(digit(c0), digit(c0 + 1)), digit(c0 + 2))
                    : __int_as_float(0x7fc00000);
    }
  }
}

// K5 holds its digit sums in int32: |digit| <= 64 (d3's |d3| <= 32), so a
// cell is exact up to 2^25 rows, the most an external launch may count
constexpr int kMaxLog2RowsI8 = 25;

// The mode kernel's launch at the plan the wrapper picked
// (hist_cuda.mode_plan): node_group nodes per CTA (1 to kModeNodes) and
// window_bins bins per CTA (all n_bins_tot, or with one node per CTA a
// window of them); refuses a plan that does not fit. kExternal: scale is
// the caller's (K4: every rank's max |digit| [K, 6]; K5: unread, the
// digits were quantized at the global s) and log2n that of the global row
// count (at least ceil(log2 N); at most 62 for K4, 25 for K5), and out is
// the raw integer sums [K, F, k_nodes, n_bins_tot, C] (K4 int64, K5
// int32); otherwise out is float32 [.., 2] and log2n = ceil(log2 N).
template <bool kInt8, bool kExternal>
int launch_mode(const int16_t* binned, const int32_t* nodes, const void* digits,
                const float* scale, void* out, int K, int F, int N, int k_nodes,
                int n_bins_tot, int node_group, int window_bins, int log2n, void* stream) {
  using Tr = ModeTraits<kInt8>;
  if (K <= 0 || F <= 0 || k_nodes <= 0 || n_bins_tot <= 0) return 0;
  if (!kExternal) {
    log2n = ceil_log2(N);
  } else if (log2n < ceil_log2(N) || log2n > (kInt8 ? kMaxLog2RowsI8 : 62)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (node_group < 1 || node_group > kModeNodes || node_group > k_nodes || window_bins < 1 ||
      window_bins > n_bins_tot)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_windows = (n_bins_tot + window_bins - 1) / window_bins;
  const size_t smem =
      static_cast<size_t>(node_group) * window_bins * Tr::kChannels * sizeof(typename Tr::Cell);
  const long long grid_z =
      static_cast<long long>((k_nodes + node_group - 1) / node_group) * n_windows;
  if (smem > static_cast<size_t>(kMaxSmemBytes) || K > 65535 || grid_z > 65535 ||
      (n_windows > 1 && node_group != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(mode_hist_kernel<kInt8, kExternal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mode_hist_kernel<kInt8, kExternal><<<dim3(F, K, static_cast<unsigned>(grid_z)), kModeThreads,
                                       smem, static_cast<cudaStream_t>(stream)>>>(
      binned, nodes, digits, scale, out, F, N, k_nodes, n_bins_tot, node_group, n_windows,
      window_bins, log2n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K4 / K5's digits, prepared once a tree (digit_prep_kernel<kInt8>): the
// counterpart of the JAX package's once-a-round preparation,
// mallorn_tpu/trees/gbdt.py _binlane_for, which runs
// mallorn_tpu/ops/hist_pallas.py quantize_gh_i8 (K5) or split_gh_digits
// (K4) on the round's (g, h) and hands the result to every level's
// Pallas kernel. It replaces no Pallas kernel: on the TPU that preparation
// is XLA's. The tree's (g, h) do not change from level to level, so the
// digits and scales are the same at every level, and each level's
// mode_hist_kernel launch takes them.
//
// K5 (kInt8): per lane and channel s = max(max |x|, 1e-30) over the lane's
// rows, NaN kept (fmaxf drops a NaN; torch's amax, which the plain version
// takes, keeps it; torch's abs makes it 0x7FFFFFFF on the card, and so
// does abs_like_torch), or, given ext [K, 2] (a mesh's max |x| over every
// rank's rows), s = max(ext, 1e-30); q = round_half_even((x / s) 2^26) by
// an IEEE division and product and rintf, converted to int32 as
// static_cast does (NaN -> 0, as torch's cast on the card gives), and the
// balanced base-128 digits of q + 64 (1 + 128 + 128^2): d_j = ((u >> 7 j)
// & 127) - 64 for j < 3, d3 = u >> 21; out digits [K, N, 8] int8 (g's four,
// then h's) and scale [K, 2] (s).
// K4: d0 = bf16_rn(x), r = x - d0, d1 = bf16_rn(r), d2 = bf16_rn(r - d1),
// each cast cvt.rn.bf16.f32 (what torch's cast runs on the card, a NaN
// 0x7FFF) and each difference an IEEE subtraction; out digits [K, N, 6]
// bf16 (g's three, then h's) and, unless the caller has the maxima (ext
// non-null), scale [K, 6] the max |digit| per channel over the lane's rows
// with hist_cuda.lane_maxabs's rule: +inf in every channel of a lane that
// holds a non-finite digit.
// Each is bit for bit hist_cuda.launch_inputs (quantize_gh_i8, or
// split_gh_digits and lane_maxabs) run on the card.
//
// One CTA per lane (K = 5-50 lanes of ~2,444 rows in the fits): a first
// pass reduces the lane's maxima (K5; K4 folds it into its one pass), a
// second writes each row's digits, one 8-byte store (K5) or three 4-byte
// stores (K4) a row. Bound on an H100: (g, h) in (8 B a row) and the
// digits out (8 / 12 B a row), 0.20 / 0.24 MB at K = 5, N = 2,444: ~0.06 us
// at 3.35 TB/s, far below one launch's latency; the kernel takes 0.0042 /
// 0.0053 ms there on an H100 80GB HBM3 at 700 W (tools/time_hist.py's
// device time), once a tree.

constexpr int kDigitThreads = 1024;
constexpr int kDigitWarps = kDigitThreads / 32;

// the larger of a and b, a NaN kept if either is one
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (isnan(a) || a >= b) ? a : b;
}

// |x| as torch's abs gives it on the card (PTX abs.f32): a NaN becomes the
// canonical 0x7FFFFFFF, whatever its payload (a bit mask would keep it)
__device__ __forceinline__ float abs_like_torch(float x) {
  return isnan(x) ? __int_as_float(0x7fffffff) : fabsf(x);
}

__device__ __forceinline__ unsigned short bf16_rn(float x) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(x));
  return h;
}

__device__ __forceinline__ float bf16_value(unsigned short h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

// K5's four int8 digits of x at scale s, byte j digit j
__device__ __forceinline__ uint32_t i8_digits(float x, float s) {
  const float q = rintf(__fmul_rn(__fdiv_rn(x, s), 67108864.0f));  // 2^26
  // q + 64 (1 + 128 + 128^2), wrapping as torch's int32 add does
  const uint32_t u = static_cast<uint32_t>(static_cast<int>(q)) + 1056832u;
  uint32_t w = static_cast<uint32_t>(static_cast<int>(u) >> 21) << 24;
#pragma unroll
  for (int j = 0; j < 3; ++j) w |= ((((u >> (7 * j)) & 127u) - 64u) & 0xFFu) << (8 * j);
  return w;
}

// each of the C values reduced by op over the CTA's threads, the result
// in every thread
template <int C, typename Op>
__device__ __forceinline__ void cta_reduce(float (&v)[C], Op op) {
  __shared__ float part[kDigitWarps][C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[c] = op(v[c], __shfl_xor_sync(0xffffffffu, v[c], o));
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) part[warp][c] = v[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v[c] = part[0][c];
    for (int w = 1; w < kDigitWarps; ++w) v[c] = op(v[c], part[w][c]);
  }
}

// One CTA per lane k = blockIdx.x; gh [K, N] float2; ext null or [K, 2]
// (K5) / [K, 6] (K4, unread: its presence skips the maxima)
template <bool kInt8>
__global__ void __launch_bounds__(kDigitThreads)
digit_prep_kernel(const float2* __restrict__ gh, void* __restrict__ digits,
                  float* __restrict__ scale, const float* __restrict__ ext, int N) {
  const int k = blockIdx.x;
  const float2* v = gh + static_cast<size_t>(k) * N;
  if constexpr (kInt8) {
    float m[2] = {0.0f, 0.0f};
    if (ext == nullptr) {
      for (int r = threadIdx.x; r < N; r += kDigitThreads) {
        const float2 x = v[r];
        m[0] = max_keep_nan(m[0], abs_like_torch(x.x));
        m[1] = max_keep_nan(m[1], abs_like_torch(x.y));
      }
      cta_reduce(m, [](float a, float b) { return max_keep_nan(a, b); });
    } else {
      m[0] = ext[2 * k];
      m[1] = ext[2 * k + 1];
    }
    // torch.clamp(min=1e-30) keeps a NaN
    const float sg = isnan(m[0]) ? m[0] : fmaxf(m[0], 1e-30f);
    const float sh = isnan(m[1]) ? m[1] : fmaxf(m[1], 1e-30f);
    if (threadIdx.x == 0) {
      scale[2 * k] = sg;
      scale[2 * k + 1] = sh;
    }
    uint2* out = static_cast<uint2*>(digits) + static_cast<size_t>(k) * N;
    for (int r = threadIdx.x; r < N; r += kDigitThreads) {
      const float2 x = v[r];
      out[r] = make_uint2(i8_digits(x.x, sg), i8_digits(x.y, sh));
    }
  } else {
    // six digits a row as three words: word j holds digits 2 j (low half)
    // and 2 j + 1 of g's d0 d1 d2, h's d0 d1 d2
    uint32_t* out = static_cast<uint32_t*>(digits) + static_cast<size_t>(k) * N * 3;
    // each channel's max |digit|, then 1 where a digit is not finite
    float m[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = threadIdx.x; r < N; r += kDigitThreads) {
      const float2 x = v[r];
      unsigned short d[6];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float xc = c ? x.y : x.x;
        d[3 * c] = bf16_rn(xc);
        const float res = __fsub_rn(xc, bf16_value(d[3 * c]));
        d[3 * c + 1] = bf16_rn(res);
        d[3 * c + 2] = bf16_rn(__fsub_rn(res, bf16_value(d[3 * c + 1])));
      }
#pragma unroll
      for (int j = 0; j < 3; ++j)
        out[3 * static_cast<size_t>(r) + j] = d[2 * j] | static_cast<uint32_t>(d[2 * j + 1]) << 16;
      if (ext == nullptr) {
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const float a = fabsf(bf16_value(d[c]));
          if (!isfinite(a)) m[6] = 1.0f;
          m[c] = fmaxf(m[c], a);
        }
      }
    }
    if (ext == nullptr) {
      cta_reduce(m, [](float a, float b) { return fmaxf(a, b); });
      if (threadIdx.x < 6)
        scale[6 * k + threadIdx.x] = m[6] != 0.0f ? __int_as_float(0x7f800000) : m[threadIdx.x];
    }
  }
}

// The prep kernel's launch: K5 always writes scale; K4 writes it only
// without ext
template <bool kInt8>
int launch_digit_prep(const float* gh, void* digits, float* scale, const float* ext, int K, int N,
                      void* stream) {
  if (K <= 0) return 0;
  if (N < 0 || (scale == nullptr && (kInt8 || ext == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  digit_prep_kernel<kInt8><<<K, kDigitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(gh), digits, scale, ext, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: window segments, group features per CTA and tile_rows rows per
// staged tile (hist_cuda.seg_hist_plan); refuses a layout that does not
// fit. maxabs null: the lane's own scale, out float32 [K, F, n_seg, 2].
// maxabs [K, 2] float32 (every rank's max |g|, max |h| per lane, +inf where
// not finite) with log2n (ceil(log2) of the global row count): the external
// scale, out int64 [K, F, n_seg, 2] (the raw sums)
extern "C" int mallorn_seg_hist(const int16_t* binned, const int32_t* seg_base,
                                const float* gh, void* out, int K, int F, int N, int n_seg,
                                int window, int group, int tile_rows, const float* maxabs,
                                int log2n, void* stream) {
  const auto launch = maxabs ? launch_group<false, true> : launch_group<false, false>;
  return launch(binned, seg_base, gh, out, K, F, N, n_seg, n_seg, 0, window, group, tile_rows,
                maxabs, log2n, stream);
}

// K1 at a level one CTA holds: group features per CTA and tile_rows rows
// per staged tile (hist_cuda.hist_plan); refuses a layout that does not
// fit (a wider level takes mallorn_hist_group_rows and mallorn_hist_wide).
// maxabs and log2n as mallorn_seg_hist's: out float32 or int64 [K, F,
// k_nodes, n_bins_tot, 2]
extern "C" int mallorn_hist(const int16_t* binned, const int32_t* node_q, const float* gh,
                            void* out, int K, int F, int N, int k_nodes, int n_bins_tot,
                            int group, int tile_rows, const float* maxabs, int log2n,
                            void* stream) {
  if (k_nodes <= 0 || n_bins_tot <= 0) return 0;
  const long long n_seg = static_cast<long long>(k_nodes) * n_bins_tot;
  if (n_seg > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = maxabs ? launch_group<true, true> : launch_group<true, false>;
  return launch(binned, node_q, gh, out, K, F, N, static_cast<int>(n_seg), k_nodes, n_bins_tot,
                static_cast<int>(n_seg), group, tile_rows, maxabs, log2n, stream);
}

// K1's wide path, the row grouping: node_q [K, N] int32, gh [K, N, 2]
// float32 -> entries [K, N] int2 (each fold's rows of node ids in [0,
// k_nodes) grouped by chunk of chunk_nodes nodes, in row order within a
// chunk, as (row, node - the chunk's first node)), q [K, N, 2] int64 (their
// fixed-point (g, h)) and offsets [K, n_chunks + 1] int32. external 0: the
// folds' own scale, maxabs [K, 2] float32 written (max |g|, max |h| per
// fold, +inf in a fold with a non-finite value); external 1: maxabs [K, 2]
// and log2n as mallorn_seg_hist's, read. Refuses more than 1,024 chunks
extern "C" int mallorn_hist_group_rows(const int32_t* node_q, const float* gh, int2* entries,
                                       long long* q, int32_t* offsets, float* maxabs, int K,
                                       int N, int k_nodes, int chunk_nodes, int external,
                                       int log2n, void* stream) {
  return launch_wide_prep(node_q, gh, entries, q, offsets, external ? maxabs : nullptr,
                          external ? nullptr : maxabs, K, N, k_nodes, chunk_nodes, log2n, stream);
}

// K1's wide path, the histograms: group features and chunk_nodes nodes per
// CTA (hist_cuda.wide_plan) over the entries, q and offsets of
// mallorn_hist_group_rows at the same chunk_nodes and maxabs; a level of
// nodes of more than 7,264 bins one CTA per (fold, feature, node) with
// `slots` slots and windows of window_bins bins (hist_cuda.wide_node_plan).
// external 0: out float32 [K, F, k_nodes, n_bins_tot, 2]; external 1: log2n
// as mallorn_seg_hist's, out the raw int64 sums
extern "C" int mallorn_hist_wide(const int16_t* binned, const int2* entries, const long long* q,
                                 const int32_t* offsets, const float* maxabs, void* out, int K,
                                 int F, int N, int k_nodes, int n_bins_tot, int chunk_nodes,
                                 int group, int slots, int window_bins, int external, int log2n,
                                 void* stream) {
  const auto launch = external ? launch_wide<true> : launch_wide<false>;
  return launch(binned, entries, q, offsets, maxabs, out, K, F, N, k_nodes, n_bins_tot,
                chunk_nodes, group, slots, window_bins, log2n, stream);
}

// K4: node_group nodes and window_bins bins per CTA (hist_cuda.mode_plan);
// digits [K, N, 6] bf16, maxabs [K, 6] float32 (max |digit| per
// channel). external 0: the fold's own maxima and ceil(log2 N), out float32
// [K, F, k_nodes, n_bins_tot, 2]; external 1: every rank's maxima and log2n
// of the global row count, out the raw int64 sums [K, F, k_nodes,
// n_bins_tot, 6] (zeros in a lane whose maxima are not finite)
extern "C" int mallorn_hist_bf16(const int16_t* binned, const int32_t* nodes,
                                 const void* digits, const float* maxabs, void* out, int K,
                                 int F, int N, int k_nodes, int n_bins_tot, int node_group,
                                 int window_bins, int external, int log2n, void* stream) {
  const auto launch = external ? launch_mode<false, true> : launch_mode<false, false>;
  return launch(binned, nodes, digits, maxabs, out, K, F, N, k_nodes, n_bins_tot, node_group,
                window_bins, log2n, stream);
}

// K5: node_group nodes and window_bins bins per CTA (hist_cuda.mode_plan);
// digits [K, N, 8] int8, scale [K, 2] float32 (s per channel).
// external 0: out float32 [K, F, k_nodes, n_bins_tot, 2]; external 1: the
// digits were quantized at every rank's s (scale unread), out the raw
// int32 digit sums [K, F, k_nodes, n_bins_tot, 8], refused beyond 2^25
// global rows (log2n)
extern "C" int mallorn_hist_i8(const int16_t* binned, const int32_t* nodes,
                               const void* digits, const float* scale, void* out, int K,
                               int F, int N, int k_nodes, int n_bins_tot, int node_group,
                               int window_bins, int external, int log2n, void* stream) {
  const auto launch = external ? launch_mode<true, true> : launch_mode<true, false>;
  return launch(binned, nodes, digits, scale, out, K, F, N, k_nodes, n_bins_tot, node_group,
                window_bins, log2n, stream);
}

// K4 / K5's digits of a tree (digit_prep_kernel): gh [K, N, 2] float32 ->
// int8 1: digits [K, N, 8] int8 and scale [K, 2] float32 s, at the lanes'
// own max |x| or, given ext [K, 2] (every rank's), at that; int8 0: digits
// [K, N, 6] bf16 and, without ext, scale [K, 6] float32 max |digit| (+inf in
// a lane with a non-finite digit); given ext (the caller's maxima), scale
// may be null and is not written
extern "C" int mallorn_digit_prep(const float* gh, void* digits, float* scale, const float* ext,
                                  int K, int N, int int8, void* stream) {
  const auto launch = int8 ? launch_digit_prep<true> : launch_digit_prep<false>;
  return launch(gh, digits, scale, ext, K, N, stream);
}
