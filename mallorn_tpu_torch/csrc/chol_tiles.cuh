// Tile machinery shared by the Cholesky kernels: the blocked kernel
// (chol_inv_blocked.cu, one CTA per matrix, T <= 320), the cluster kernel
// (chol_inv_cluster.cu, one thread-block cluster per matrix,
// 320 < T <= 784) and the tiled kernel's diagonal step (chol_tiled.cu,
// T > 784, one 64 x 64 tile per matrix).
//
// A tile is nb x nb = 16 x 16 floats, row-major, its float4 chunks swizzled
// by row (chunk_off), so the rows a quarter warp reads at once fall in
// distinct banks without padding. A tile is 1 KB and 16-byte aligned, so a
// flat copy of its 64 float4s keeps the layout.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kNb = 16;
constexpr int kTile = kNb * kNb;
constexpr unsigned kFullMask = 0xffffffffu;

// word offset of float4 chunk q (columns 4q .. 4q+3) of row r in a tile
__device__ __forceinline__ int chunk_off(int r, int q) {
  return r * kNb + (((q ^ (r >> 1)) & 3) << 2);
}

__device__ __forceinline__ int elem_off(int r, int c) {
  return chunk_off(r, c >> 2) + (c & 3);
}

__device__ __forceinline__ float4 load4(const float* t, int r, int q) {
  return *reinterpret_cast<const float4*>(t + chunk_off(r, q));
}

__device__ __forceinline__ void load_row(const float* t, int r, float (&x)[kNb]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = load4(t, r, q);
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void store_row(float* t, int r, const float (&x)[kNb]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    *reinterpret_cast<float4*>(t + chunk_off(r, q)) =
        make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// (a) the diagonal tile's Cholesky-inverse by one warp, with no block
// barrier: lane i (and i + 16) factors row i in registers, pivots and
// columns travel by shuffles (with the inverse, logdet gains log(pivot)
// column by column); L goes to w with 1 / L[i, i] on its diagonal, and lane
// k then forms column k of Linv_kk by forward substitution, reading L as
// broadcasts. Leaves Linv_kk in w, zeros above its diagonal. K2 passes
// w = t; K6 passes another tile and keeps L_kk in t (L[i, i] =
// pivot * rsqrt(pivot), entries above the diagonal unread).
template <bool kInverse>
__device__ void diag_chol_inv(float* t, float* w, float& ld, int lane) {
  const int i = lane & (kNb - 1);
  float a[kNb];
  load_row(t, i, a);
  float dinv = 0.0f;
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    const float piv = __shfl_sync(kFullMask, a[j], j);
    const float d = rsqrtf(piv);
    if (kInverse) ld += logf(piv);
    dinv = (i == j) ? d : dinv;
    const float lij = a[j] * d;  // L[i, j] (L[j, j] on lane j)
    a[j] = lij;
    // rows i > j: the trailing update; rows i <= j change only entries
    // above their diagonal, which nothing reads
#pragma unroll
    for (int c = j + 1; c < kNb; ++c)
      a[c] = fmaf(-lij, __shfl_sync(kFullMask, lij, c), a[c]);
  }
  if (!kInverse && lane < kNb) store_row(t, i, a);
#pragma unroll
  for (int c = 0; c < kNb; ++c) a[c] = (c == i) ? dinv : a[c];
  if (lane < kNb) store_row(w, i, a);
  __syncwarp();
  // x = column k of Linv_kk: x[r] = (delta_rk - sum_{m<r} L[r, m] x[m]) / L[r, r]
  const int k = i;
  float x[kNb];
#pragma unroll
  for (int r = 0; r < kNb; ++r) {
    float acc = (r == k) ? 1.0f : 0.0f;
    float diag = 0.0f;
#pragma unroll
    for (int q = 0; q <= r / 4; ++q) {
      const float4 v = load4(w, r, q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * q + e < r) acc = fmaf(-comp(v, e), x[4 * q + e], acc);
        if (4 * q + e == r) diag = comp(v, e);
      }
    }
    x[r] = acc * diag;
  }
  __syncwarp();
  if (lane < kNb) {
#pragma unroll
    for (int r = 0; r < kNb; ++r) w[elem_off(r, k)] = x[r];
  }
}

// row r of tile t times D^T (transpose = true) or D, D = the diagonal tile
// of Linv (zeros above its diagonal), in place: (b) and the inverse's W
template <bool kTranspose>
__device__ __forceinline__ void row_times_diag(float* t, int r, const float* D) {
  float x[kNb], y[kNb];
  load_row(t, r, x);
  if (kTranspose) {
    // y[c] = sum_{m <= c} x[m] D[c, m]
#pragma unroll
    for (int c = 0; c < kNb; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q <= c / 4; ++q) {
        const float4 v = load4(D, c, q);
        acc = fmaf(x[4 * q], v.x, acc);
        acc = fmaf(x[4 * q + 1], v.y, acc);
        acc = fmaf(x[4 * q + 2], v.z, acc);
        acc = fmaf(x[4 * q + 3], v.w, acc);
      }
      y[c] = acc;
    }
  } else {
    // y[c] = sum_{m >= c} x[m] D[m, c]
#pragma unroll
    for (int c = 0; c < kNb; ++c) y[c] = 0.0f;
#pragma unroll
    for (int m = 0; m < kNb; ++m) {
#pragma unroll
      for (int q = 0; q <= m / 4; ++q) {
        const float4 v = load4(D, m, q);
        y[4 * q] = fmaf(x[m], v.x, y[4 * q]);
        y[4 * q + 1] = fmaf(x[m], v.y, y[4 * q + 1]);
        y[4 * q + 2] = fmaf(x[m], v.z, y[4 * q + 2]);
        y[4 * q + 3] = fmaf(x[m], v.w, y[4 * q + 3]);
      }
    }
  }
  store_row(t, r, y);
}

// (c) one task of the trailing update: C -= LI LJ^T on 4 x 4 elements of
// the tile C, rows ra + 4u and columns cb + 4v (ra = sub / 4, cb = sub % 4),
// streaming float4 fragments of the two panel tiles (2 FMAs per float
// loaded)
__device__ __forceinline__ void update_tile(const float* LI, const float* LJ, float* C,
                                            int sub) {
  const int ra = (sub >> 2) & 3;
  const int cb = sub & 3;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = C[elem_off(ra + 4 * u, cb + 4 * v)];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float4 li[4], lj[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      li[u] = load4(LI, ra + 4 * u, q);
      lj[u] = load4(LJ, cb + 4 * u, q);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          acc[u][v] = fmaf(-comp(li[u], e), comp(lj[v], e), acc[u][v]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) C[elem_off(ra + 4 * u, cb + 4 * v)] = acc[u][v];
}

// the inverse's product step: acc += LI WM on rows ra + 4u of LI and the
// four columns of chunk cb of WM (one term M of
// Linv[I, J] = -sum_M Linv[I, M] W[M, J])
__device__ __forceinline__ void inv_accumulate(float (&acc)[4][4], const float* LI,
                                               const float* WM, int ra, int cb) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float4 li[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) li[u] = load4(LI, ra + 4 * u, q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 x = load4(WM, 4 * q + e, cb);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float l = comp(li[u], e);
        acc[u][0] = fmaf(l, x.x, acc[u][0]);
        acc[u][1] = fmaf(l, x.y, acc[u][1]);
        acc[u][2] = fmaf(l, x.z, acc[u][2]);
        acc[u][3] = fmaf(l, x.w, acc[u][3]);
      }
    }
  }
}

// -acc into rows ra + 4u, chunk cb of tile C
__device__ __forceinline__ void store_neg(float* C, const float (&acc)[4][4], int ra, int cb) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    *reinterpret_cast<float4*>(C + chunk_off(ra + 4 * u, cb)) =
        make_float4(-acc[u][0], -acc[u][1], -acc[u][2], -acc[u][3]);
}

}  // namespace
