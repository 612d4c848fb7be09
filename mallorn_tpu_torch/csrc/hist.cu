// (grad, hess) histograms of the GBDT, batched over folds or lanes: the
// depthwise level histogram (K1) and the leaf-wise segment histogram (K3),
// one kernel template (group_hist_kernel<kLevel, kChunked, kExternal>), and the depthwise fit's
// two histogram modes (K4 / K5, mode_hist_kernel, further down), all
// shared-memory integer histograms.
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
// - K1's level of more nodes than one CTA's histograms hold (54 at 257
//   bins) is split into equal chunks of at most that many nodes on the
//   grid's z axis (hist_cuda.hist_plan), as K4 / K5 split theirs: a CTA
//   counts the rows whose node lies in its chunk and writes the chunk's
//   [F, chunk, n_bins, 2] slice. Integer sums, so a chunked launch gives
//   the bits of an unchunked one; a level that fits is one chunk, the
//   grid's z extent 1, and runs the unchunked instantiation (kChunked
//   false: no chunk offsets in its row walk);
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

// The fixed-point histogram of K4: zeroes the [n_seg, C] int64 histogram
// in shared memory, gives channel c the scale S_c = 2^(62 - log2n - e)
// with maxabs[c] < 2^e, and adds round(x_c * S_c) of each active row's C
// values (load(r, x)) with integer atomics. Returns whether every maxabs
// is finite (if not, nothing is added and every cell is NaN) and sets
// inv[c] = 1 / S_c (exact: S_c is a power of 2); the sums are in smem
// after its closing __syncthreads.
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

// ---------------------------------------------------------------------------
// K1 and K3 (group_hist_kernel<kLevel, kChunked, kExternal>; the design is in the header
// above)

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

// Adds (q_g, q_h) to cell c's two int64 sums, each kept as a low and a
// high 32-bit word in the planes of words, with native shared-memory
// atomics (an int64 atomicAdd on shared memory is a compare-and-swap
// loop): a low word's old value gives its carry, which the high word takes
// with q's high word. Both low words are added before either old value is
// read, so that the two round trips overlap. Every wrap of a low word is
// counted once, so each sum ends at the exact int64 sum, mod 2^64, in any
// order.
__device__ __forceinline__ void add_fixed(unsigned* words, int plane, int c, longlong2 q) {
  const unsigned long long ug = static_cast<unsigned long long>(q.x);
  const unsigned long long uh = static_cast<unsigned long long>(q.y);
  const unsigned lg = static_cast<unsigned>(ug), lh = static_cast<unsigned>(uh);
  const unsigned og = lg ? atomicAdd(words + c, lg) : 0u;
  const unsigned oh = lh ? atomicAdd(words + 2 * plane + c, lh) : 0u;
  // old + lo wrapped: carry 1 into the high word
  const unsigned hg = static_cast<unsigned>(ug >> 32) + (og > ~lg ? 1u : 0u);
  const unsigned hh = static_cast<unsigned>(uh >> 32) + (oh > ~lh ? 1u : 0u);
  if (hg) atomicAdd(words + plane + c, hg);
  if (hh) atomicAdd(words + 3 * plane + c, hh);
}

// One CTA per (fold k, features f0 .. f0 + group - 1, chunk of ids) =
// (blockIdx.y, blockIdx.x, blockIdx.z); tile_rows a multiple of
// kSegThreads. ids are K1's node ids (kLevel: a row is active for a node
// in this CTA's chunk [id0, id0 + z_ids) of [0, id_limit = k_nodes), its
// base is (node - id0) * n_bins and a bin counts in [0, n_bins); the CTA
// writes the chunk's [chunk nodes, n_bins, 2] slice of the k_nodes n_bins
// = n_seg segments) or K3's segment bases (one chunk: z_ids = id_limit =
// n_seg, a row is active for a base in [0, n_seg), a bin counts in
// [0, n_seg - base); n_bins unused). kChunked false: one chunk, id0 = 0
// and n_seg = n_seg_out at compile time. kExternal: the lane's scale comes
// from ext_max[k] (max |g|, max |h| of every rank's rows) and log2n (of the
// global row count), and out is int64 [.., n_seg_out, 2] (raw sums);
// otherwise the CTA finds the scale from its fold's rows and out is
// float32.
template <bool kLevel, bool kChunked, bool kExternal>
__global__ void __launch_bounds__(kSegThreads)
group_hist_kernel(const int16_t* __restrict__ binned, const int32_t* __restrict__ ids,
                  const float2* __restrict__ gh, void* __restrict__ out, int F, int N,
                  int n_seg_out, int id_limit, int z_ids, int n_bins, int group, int tile_rows,
                  int log2n, const float2* __restrict__ ext_max) {
  static_assert(kLevel || !kChunked, "K3 runs one chunk");
  extern __shared__ uint4 smem[];
  const int k = blockIdx.y;
  const int f0 = blockIdx.x * group;
  const int n_f = min(group, F - f0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = tile_rows;
  // this CTA's ids, [id0, id0 + n_ids), and its segments, [seg0, seg0 + n_seg)
  // of the n_seg_out in out: all of them where the grid has one chunk
  const int id0 = kChunked ? blockIdx.z * z_ids : 0;
  const int n_ids = kChunked ? min(z_ids, id_limit - id0) : id_limit;
  const int n_seg = kChunked ? n_ids * n_bins : n_seg_out;
  const size_t seg0 = kChunked ? static_cast<size_t>(id0) * n_bins : 0;

  // the carve-up of seg_smem_bytes
  const int plane = group * n_seg;  // words per plane; feature g's at g * n_seg
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
        // the id relative to the chunk (K3: id0 = 0); the unsigned compare
        // also drops ids below it
        const int id = i < rows ? static_cast<int>(static_cast<unsigned>(t_ids[i]) -
                                                   static_cast<unsigned>(id0))
                                : -1;
        const bool act = static_cast<unsigned>(id) < static_cast<unsigned>(n_ids);
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
        if (static_cast<unsigned>(bin) < static_cast<unsigned>(kLevel ? n_bins : n_seg - base)) {
          add_fixed(words, plane, g * n_seg + base + bin, list_q[e]);
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
      const int c0 = g * n_seg;
      longlong2* o = reinterpret_cast<longlong2*>(out) +
                     (static_cast<size_t>(k) * F + f0 + g) * n_seg_out + seg0;
      for (int s = tid; s < n_seg; s += kSegThreads) {
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
    const int c0 = g * n_seg;
    float* o = reinterpret_cast<float*>(out) +
               ((static_cast<size_t>(k) * F + f0 + g) * n_seg_out + seg0) * 2;
    const int head = (reinterpret_cast<uintptr_t>(o) & 15) ? 1 : 0;  // o is 8-byte aligned
    const int n_pairs = (n_seg - head) >> 1;
    for (int p = tid; p < n_pairs; p += kSegThreads) {
      const int s = head + 2 * p;
      const float2 x = cell(c0 + s), y = cell(c0 + s + 1);
      *reinterpret_cast<float4*>(o + 2 * s) = make_float4(x.x, x.y, y.x, y.y);
    }
    if (tid == 0 && head) *reinterpret_cast<float2*>(o) = cell(c0);
    if (tid == kSegThreads - 1 && ((n_seg - head) & 1))
      *reinterpret_cast<float2*>(o + 2 * (n_seg - 1)) = cell(c0 + n_seg - 1);
  }
}

int ceil_log2(int n) {
  int log2n = 0;
  while ((1LL << log2n) < static_cast<long long>(n)) ++log2n;
  return log2n;
}

constexpr int kMaxDevices = 64;

// K1's and K3's launch at a layout the wrapper picked (hist_cuda.hist_plan
// or seg_hist_layout); refuses one that does not fit. n_seg is the
// segments per (fold, feature) of out, cta_seg those of one CTA: K1's
// z_ids nodes of n_bins (grid z = ceil(id_limit / z_ids) chunks of nodes,
// kChunked where there is more than one), K3's n_seg (z_ids = id_limit,
// one chunk). The kernel's dynamic
// shared-memory limit is raised only when this launch needs more than the
// instantiation was last given on the current device (a driver call per
// launch otherwise): limits only grow, under a lock, so every launch runs
// under a limit at least its own. kExternal: ext_max [K, 2] and log2n come
// from the caller (log2n of a global row count, at least ceil(log2 N) and
// at most 62) and out is int64; otherwise out is float32 and the kernel
// takes log2n = ceil(log2 N).
template <bool kLevel, bool kChunked, bool kExternal>
int launch_group(const int16_t* binned, const int32_t* ids, const float* gh, void* out, int K,
                 int F, int N, int n_seg, int id_limit, int z_ids, int n_bins, int group,
                 int tile_rows, const float* ext_max, int log2n, void* stream) {
  static std::mutex lock;
  static size_t granted[kMaxDevices] = {};
  if (K <= 0 || F <= 0 || n_seg <= 0) return 0;
  if (z_ids < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long cta_seg = kChunked ? static_cast<long long>(z_ids) * n_bins : n_seg;
  const int n_chunks = (id_limit + z_ids - 1) / z_ids;
  if (N < 0 || K > 65535 || cta_seg > 65535 || n_chunks > 65535 || (n_chunks > 1) != kChunked ||
      group < 1 || tile_rows < kSegThreads || tile_rows % kSegThreads ||
      tile_rows > kSegMaxTileRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!kExternal) {
    log2n = ceil_log2(N);
  } else if (ext_max == nullptr || log2n < ceil_log2(N) || log2n > 62) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = seg_smem_bytes(static_cast<int>(cta_seg), group, tile_rows);
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    std::lock_guard<std::mutex> hold(lock);
    if (dev >= kMaxDevices || smem > granted[dev]) {
      err = cudaFuncSetAttribute(group_hist_kernel<kLevel, kChunked, kExternal>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) granted[dev] = smem;
    }
  }
  group_hist_kernel<kLevel, kChunked, kExternal>
      <<<dim3((F + group - 1) / group, K, n_chunks), kSegThreads, smem,
          static_cast<cudaStream_t>(stream)>>>(binned, ids, reinterpret_cast<const float2*>(gh),
                                               out, F, N, n_seg, id_limit, z_ids, n_bins, group,
                                               tile_rows, log2n,
                                               reinterpret_cast<const float2*>(ext_max));
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
// because a TPU has no scatter. Here the design is K1's first one: one CTA per
// (fold, feature, group of <= 8 nodes) (grid (F, K, ceil(k_nodes / 8))),
// a [nodes, n_bins_tot, C] integer histogram in shared memory, every
// thread striding the fold's rows once (for_each_row, the first K1's row
// walk, with the group's first node as id0) and adding an active row's C digit
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
// 257 bins take 98,688 B. It runs the first K1's fixed-point body,
// accumulate_fixed, with six channels. Each digit channel gets K1's
// per-fold scale,
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
// (8 int32 or 6 int64 per active row and feature, serialised where rows
// share a bin, as in a crowded missing bin) and on zeroing and writing the
// whole histogram.

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

// K3: group features per CTA and tile_rows rows per staged tile
// (hist_cuda.seg_hist_layout); refuses a layout that does not fit.
// maxabs null: the lane's own scale, out float32 [K, F, n_seg, 2]. maxabs
// [K, 2] float32 (every rank's max |g|, max |h| per lane, +inf where not
// finite) with log2n (ceil(log2) of the global row count): the external
// scale, out int64 [K, F, n_seg, 2] (the raw sums)
extern "C" int mallorn_seg_hist(const int16_t* binned, const int32_t* seg_base,
                                const float* gh, void* out, int K, int F, int N, int n_seg,
                                int group, int tile_rows, const float* maxabs, int log2n,
                                void* stream) {
  const auto launch =
      maxabs ? launch_group<false, false, true> : launch_group<false, false, false>;
  return launch(binned, seg_base, gh, out, K, F, N, n_seg, n_seg, n_seg, 0, group, tile_rows,
                maxabs, log2n, stream);
}

// K1: group features per CTA, tile_rows rows per staged tile and
// chunk_nodes nodes per CTA (hist_cuda.hist_plan; chunk_nodes = k_nodes is
// one chunk); refuses a layout that does not fit, or more chunks than the
// grid's z axis takes (65,535). maxabs and log2n as mallorn_seg_hist's:
// out float32 or int64 [K, F, k_nodes, n_bins_tot, 2]
extern "C" int mallorn_hist(const int16_t* binned, const int32_t* node_q, const float* gh,
                            void* out, int K, int F, int N, int k_nodes, int n_bins_tot,
                            int group, int tile_rows, int chunk_nodes, const float* maxabs,
                            int log2n, void* stream) {
  if (k_nodes <= 0 || n_bins_tot <= 0) return 0;
  const long long n_seg = static_cast<long long>(k_nodes) * n_bins_tot;
  if (n_seg > 0x7fffffffLL || chunk_nodes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool chunked = chunk_nodes < k_nodes;
  const auto launch =
      maxabs ? (chunked ? launch_group<true, true, true> : launch_group<true, false, true>)
             : (chunked ? launch_group<true, true, false> : launch_group<true, false, false>);
  return launch(binned, node_q, gh, out, K, F, N, static_cast<int>(n_seg), k_nodes,
                chunk_nodes, n_bins_tot, group, tile_rows, maxabs, log2n, stream);
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
