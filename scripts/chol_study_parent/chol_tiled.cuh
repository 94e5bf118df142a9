// Tiled Cholesky factorize-and-solve of one SPD system in shared memory.
//
// Device routines of kernel K2 (chol_solve.cu) and of the solve pass of
// kernels K4 (gather_solve.cu) and K7 (gather_solve_ring.cu), through
// gather_solve.cuh's tail_solve_kernel.  One thread block owns one system;
// every routine is called by all its threads.
//
// Layout: the lower triangle of the system padded to T = ceil(r/32) tiles
// a side, as its T(T+1)/2 tiles of 32 x 32 (tile (I, J), I >= J, at
// tile_index(I, J)).  A tile is column-major with a column stride of
// kLd = 36 floats: lane i of a warp reading row i of one column touches
// consecutive words (no bank conflict), a column is 16-byte aligned for
// float4 loads, and a row walk (the backward substitution) is 4-way
// rather than 32-way conflicted.  The padding is the identity (1 on the
// diagonal, 0 elsewhere): it leaves L and x on the real rows exactly as
// the unpadded recurrence gives them, and solves to 0.  Rank 128: 10
// tiles, 46 KB; rank 256: 36 tiles, 167 KB.  inv_j (below) follows the
// tiles, 32 floats a block column.
//
// Arithmetic: right-looking by block columns of 32.  For block column k:
//   1. the diagonal tile, by one warp with a row a lane in registers:
//      column j's pivot d, inv_j = rsqrt(max(d, 1e-30)), L[i][j] =
//      a[i][j]·inv_j, then a[i][c] -= L[i][j]·L[c][j] for j < c <= i —
//      shuffles, no barrier;
//   2. the panel below it, a row a thread in registers: for j in order,
//      L[i][j] = a[i][j]·inv_j, then a[i][c] -= L[i][j]·L[c][j] for the
//      tile's later columns c;
//   3. the trailing tiles (I, J), k < J <= I: Z -= Σ_q P_I[:, q] P_J[:, q]ᵀ
//      over the panel's 32 columns q in order, a 4 x 4 register tile a
//      thread (two float4 loads feed 16 multiply-adds), then subtracted.
// Three block barriers a block column.  Then the substitutions by one
// warp, a tile at a time: forward L y = b column by column (y_j = res_j
// / L_jj, then res_i -= y_j·L[i][j] for i > j), backward Lᵀ x = y (x_j =
// res_j / L_jj, then res_i -= x_j·L[j][i] for i < j), the order of
// chol_blocked.cuh's substitutions; no block barrier.  f32 throughout,
// no tensor cores, so no TF32 rounding.  The plain version is
// tpu_als_torch/ops/cuda_lanes.py::chol_solve_plain.

#pragma once

namespace cholt {

constexpr int kNB = 32;                 // tile side
constexpr int kLd = 36;                 // a tile's column stride
constexpr int kTileFloats = kNB * kLd;  // 1,152
constexpr float kPivotFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int tiles(int r) { return (r + kNB - 1) / kNB; }
__host__ __device__ inline int tile_index(int I, int J) {
  return I * (I + 1) / 2 + J;
}
// floats of shared memory at rank r: the tiles, then inv [32·T] (the
// pivots' scales), rcp [32·T] (1 / L_jj) and the substitutions' vector
// [32·T]
__host__ __device__ inline int smem_floats(int r) {
  const int T = tiles(r);
  return T * (T + 1) / 2 * kTileFloats + 3 * kNB * T;
}
// the tile row I of tile index t = tile_index(I, J), t < 36 (8 tiles a
// side, rank 256): a warp's index is uniform, so a constant-cache read
constexpr int kMaxTiles = 8;
__constant__ unsigned char kTileRow[kMaxTiles * (kMaxTiles + 1) / 2] = {
    0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 4, 5, 5, 5,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7};
// threads a block: 8 warps up to 4 tiles a side (rank 128), 16 above
__host__ __device__ constexpr int threads(int max_tiles) {
  return max_tiles <= 4 ? 256 : 512;
}

__device__ __forceinline__ float* tile(float* S, int I, int J) {
  return S + tile_index(I, J) * kTileFloats;
}
__device__ __forceinline__ float* inv_of(float* S, int T) {
  return S + T * (T + 1) / 2 * kTileFloats;
}

// Row i and column c of lane `lane` in unit u (one row of one tile).
__device__ __forceinline__ void unit_rc(int u, int lane, int& i, int& c) {
  const int t = u >> 5, I = kTileRow[t];
  i = I * kNB + (u & 31);
  c = (t - I * (I + 1) / 2) * kNB + lane;
}

// x / d, correctly rounded, from rd = 1/d correctly rounded: the product
// and one correction by a multiply-add (Markstein), in the normal range
// (no overflow or underflow), as the division instruction gives it but
// without the division's latency on a substitution's chain
__device__ __forceinline__ float div_rn(float x, float d, float rd) {
  const float q = x * rd;
  return fmaf(fmaf(-q, d, x), rd, q);
}

// Fill the tiles of rank r from the row-major r x r matrix A (plus `add`
// when kAdd), then tail(i, c, a) on every entry c <= i < r; the padding
// is the identity and the upper triangle of the diagonal tiles 0.  A unit
// is one row of one tile: warp w takes units w, w + nw, ..., kBatch of
// them at a time, each lane one column.  The reads are unconditional (the
// index clamped into A), so a lane has kBatch of them in flight,
// coalesced across the warp, before it stores any.  No barrier.
template <bool kAdd, typename Tail>
__device__ __forceinline__ void fill(float* S, int r,
                                     const float* __restrict__ A,
                                     const float* __restrict__ add,
                                     Tail tail) {
  constexpr int kBatch = 8;
  const int T = tiles(r), units = T * (T + 1) / 2 * kNB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int u0 = warp; u0 < units; u0 += nw * kBatch) {
    float v[kBatch], w[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      int i, c;
      unit_rc(min(u0 + q * nw, units - 1), lane, i, c);
      const int e = min(i, r - 1) * r + min(c, r - 1);
      v[q] = A[e];
      w[q] = kAdd ? add[e] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int u = u0 + q * nw;
      if (u < units) {
        int i, c;
        unit_rc(u, lane, i, c);
        float a;
        if (i < r && c < r)
          a = c <= i ? tail(i, c, kAdd ? v[q] + w[q] : v[q]) : 0.f;
        else
          a = i == c ? 1.f : 0.f;
        S[(u >> 5) * kTileFloats + lane * kLd + (u & 31)] = a;
      }
    }
  }
}

// The diagonal tile k, by one warp: lane i holds row i in registers;
// column j's pivot comes by shuffle from lane j, L[c][j] from lane c.
// Writes inv[j] = rsqrt(max(pivot_j, 1e-30)) and rcp[j] = 1 / L_jj.
__device__ __forceinline__ void diagonal(float* S, float* inv, float* rcp,
                                         int k) {
  const int lane = threadIdx.x & 31;
  float* Dk = tile(S, k, k);
  float a[kNB];
#pragma unroll
  for (int c = 0; c < kNB; ++c) a[c] = c <= lane ? Dk[c * kLd + lane] : 0.f;
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const float d = __shfl_sync(kFull, a[j], j);
    const float iv = rsqrtf(fmaxf(d, kPivotFloor));
    const float l = a[j] * iv;  // 0 on the lanes above the diagonal
    a[j] = l;
#pragma unroll
    for (int c = j + 1; c < kNB; ++c) {
      const float lc = __shfl_sync(kFull, l, c);
      if (c <= lane) a[c] -= l * lc;
    }
    if (lane == 0) inv[k * kNB + j] = iv;
    if (lane == j) rcp[k * kNB + j] = __frcp_rn(l);
  }
#pragma unroll
  for (int c = 0; c < kNB; ++c)
    if (c <= lane) Dk[c * kLd + lane] = a[c];
}

// The panel below diagonal tile k (its m tiles): a thread a row, in
// registers, for j in order L[i][j] = a[i][j]·inv_j, then a[i][c] -=
// L[i][j]·L[c][j] for the tile's later columns c.
__device__ __forceinline__ void panel(float* S, const float* inv, int k,
                                      int m) {
  const float* Dk = tile(S, k, k);
  const float* ik = inv + k * kNB;
  for (int t = threadIdx.x; t < m * kNB; t += blockDim.x) {
    float* P = tile(S, k + 1 + (t >> 5), k);
    const int rho = t & 31;
    float a[kNB];
#pragma unroll
    for (int c = 0; c < kNB; ++c) a[c] = P[c * kLd + rho];
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      const float l = a[j] * ik[j];
      a[j] = l;
#pragma unroll
      for (int c = j + 1; c < kNB; ++c) a[c] -= l * Dk[j * kLd + c];
    }
#pragma unroll
    for (int c = 0; c < kNB; ++c) P[c * kLd + rho] = a[c];
  }
}

// The trailing update of block column k, Z -= Σ_q P_I[:, q] P_J[:, q]ᵀ,
// on the tiles (I, J) = (k+1+ii, k+1+jj), jj <= ii < m: 64 register
// tiles of 4 x 4 a tile; a warp takes 32 of them, lanes over its rows
// (a4) and 4 column groups (b4).
__device__ __forceinline__ void trailing(float* S, int k, int m) {
  const int pairs = m * (m + 1) / 2;
  for (int s = threadIdx.x; s < pairs * 64; s += blockDim.x) {
    const int p = s >> 6, a4 = s & 7, b4 = (s >> 3) & 7;
    const int ii = kTileRow[p], jj = p - ii * (ii + 1) / 2;
    if (ii == jj && b4 > a4) continue;  // wholly above the diagonal
    const int I = k + 1 + ii, J = k + 1 + jj;
    const float* X = tile(S, I, k) + 4 * a4;
    const float* Y = tile(S, J, k) + 4 * b4;
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
#pragma unroll 8
    for (int q = 0; q < kNB; ++q) {
      const float4 xv = *reinterpret_cast<const float4*>(X + q * kLd);
      const float4 yv = *reinterpret_cast<const float4*>(Y + q * kLd);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] += xs[x] * ys[y];
    }
    float* Z = tile(S, I, J) + 4 * a4;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      float4* zp = reinterpret_cast<float4*>(Z + (4 * b4 + y) * kLd);
      float4 z = *zp;
      z.x -= acc[0][y];
      z.y -= acc[1][y];
      z.z -= acc[2][y];
      z.w -= acc[3][y];
      *zp = z;
    }
  }
}

// In place: the tiles hold A on entry, L (A = L Lᵀ) on exit in their
// lower triangle; inv and rcp as diagonal() writes them.  T <= kMaxTiles
// tiles a side.  Three barriers a block column.  Opens and closes with a
// barrier.
__device__ __forceinline__ void factorize(float* S, int T) {
  float* inv = inv_of(S, T);
  float* rcp = inv + kNB * T;
  __syncthreads();
  for (int k = 0; k < T; ++k) {
    if (threadIdx.x < 32) diagonal(S, inv, rcp, k);
    __syncthreads();
    const int m = T - 1 - k;  // tiles below the diagonal one
    if (m == 0) break;
    panel(S, inv, k, m);
    __syncthreads();
    trailing(S, k, m);
    __syncthreads();
  }
}

// Solve L Lᵀ x = b with the tiles from factorize() (whose closing
// barrier the caller has passed), by warp 0; b [r] and x [r] in any
// memory; the other warps return at once.  The residual lives in shared
// memory.  Each diagonal tile's triangular solve runs in every lane's
// registers at once (the tile's 32 residuals, L read by broadcast), so a
// step's chain is a division (div_rn: a product and two multiply-adds)
// and one multiply-add, with no shuffle; then lane i updates the
// residual rows 32I + i of the other tiles.
__device__ __forceinline__ void substitute(float* S, int T, int r,
                                           const float* __restrict__ b,
                                           float* __restrict__ x) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const float* rcp = inv_of(S, T) + kNB * T;
  float* res = inv_of(S, T) + 2 * kNB * T;
  for (int i = lane; i < kNB * T; i += kNB) res[i] = i < r ? b[i] : 0.f;
  __syncwarp();
  float y[kNB];
  // L y = b
  for (int k = 0; k < T; ++k) {
    const float* Dk = tile(S, k, k);
#pragma unroll
    for (int j = 0; j < kNB; ++j) y[j] = res[k * kNB + j];
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      y[j] = div_rn(y[j], Dk[j * kLd + j], rcp[k * kNB + j]);
#pragma unroll
      for (int i = j + 1; i < kNB; ++i) y[i] -= y[j] * Dk[j * kLd + i];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kNB; ++j)
      if (lane == j) res[k * kNB + j] = y[j];
    for (int I = k + 1; I < T; ++I) {
      const float* L = tile(S, I, k) + lane;
      float acc = res[I * kNB + lane];
#pragma unroll
      for (int j = 0; j < kNB; ++j) acc -= y[j] * L[j * kLd];
      res[I * kNB + lane] = acc;
    }
    __syncwarp();
  }
  // Lᵀ x = y
  for (int k = T - 1; k >= 0; --k) {
    const float* Dk = tile(S, k, k);
#pragma unroll
    for (int j = 0; j < kNB; ++j) y[j] = res[k * kNB + j];
#pragma unroll
    for (int j = kNB - 1; j >= 0; --j) {
      y[j] = div_rn(y[j], Dk[j * kLd + j], rcp[k * kNB + j]);
#pragma unroll
      for (int i = 0; i < j; ++i) y[i] -= y[j] * Dk[i * kLd + j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kNB; ++j)
      if (lane == j) res[k * kNB + j] = y[j];
    for (int I = 0; I < k; ++I) {
      const float* L = tile(S, k, I) + lane * kLd;
      float acc = res[I * kNB + lane];
#pragma unroll
      for (int j = kNB - 1; j >= 0; --j) acc -= y[j] * L[j];
      res[I * kNB + lane] = acc;
    }
    __syncwarp();
  }
  for (int i = lane; i < r; i += kNB) x[i] = res[i];
}

}  // namespace cholt
