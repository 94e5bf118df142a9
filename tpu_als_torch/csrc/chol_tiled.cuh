// Tiled Cholesky factorization and solve of SPD systems, one thread block
// a system.
//
// Device routines of kernels K2 (chol_solve.cu), K1 (chol_blocked.cu),
// K6 (chol_lanes_blocked.cu) and of the solve pass of kernels K4 and K7
// (gather_solve.cuh's tail_solve_kernel, and above rank 288
// chol_cluster.cuh's cluster solve); K1's and K6's kernels are at the end
// of this file.  Every routine is called by all the block's
// threads unless it says otherwise.
//
// On chip (up to kMaxTiles = 9 tiles a side, rank 288): the lower
// triangle of the system padded to T = ceil(r/32) tiles a side, as its
// T(T+1)/2 tiles of 32 x 32 (tile (I, J), I >= J, at tile_index(I, J)).
// A tile is column-major with a column stride of kLd = 36 floats: lane i
// of a warp reading row i of one column touches consecutive words (no
// bank conflict), a column is 16-byte aligned for float4 loads, and a row
// walk (the backward substitution) is 4-way rather than 32-way
// conflicted.  The padding is the identity (1 on the diagonal, 0
// elsewhere): it leaves L and x on the real rows exactly as the unpadded
// recurrence gives them, and solves to 0.  Rank 128: 10 tiles, 46 KB;
// rank 256: 36 tiles, 167 KB; rank 288: 45 tiles, 206 KB.  inv_j and
// rcp_j (below) follow the tiles, 32 floats a block column each, then the
// substitutions' vector.
//
// Arithmetic: right-looking by block columns of 32.  For block column k:
//   1. the diagonal tile, by one warp with a row a lane in registers:
//      column j's pivot d, inv_j = rsqrt(max(d, 1e-30)), L[i][j] =
//      a[i][j]·inv_j, then a[i][c] -= L[i][j]·L[c][j] for j < c <= i —
//      shuffles, no barrier; the next pivot is formed on its own lane
//      before the shuffles of the update, so a column's chain holds one
//      shuffle, and no predicate or branch sits on it;
//   2. the panel below it, a row a thread in registers: for j in order,
//      L[i][j] = a[i][j]·inv_j (kDiv: a[i][j] / max(L_jj, 1e-30)), then
//      a[i][c] -= L[i][j]·L[c][j] for the tile's later columns c;
//   3. the trailing tiles (I, J), k < J <= I: Z -= Σ_q P_I[:, q] P_J[:, q]ᵀ
//      over the panel's 32 columns q in order, a 4 x 4 register tile a
//      thread (two float4 loads feed 16 multiply-adds), then subtracted.
// Three block barriers a block column.  Then the substitutions by one
// warp, a tile at a time: forward L y = b column by column (y_j = res_j
// / L_jj, then res_i -= y_j·L[i][j] for i > j), backward Lᵀ x = y (x_j =
// res_j / L_jj, then res_i -= x_j·L[j][i] for i < j), a tile's solve
// across the lanes (lane i holds res_i); kDiv divides by max(L_jj,
// 1e-30).  No block barrier.  K1 and K6 run the forward one in the
// block's last warp beside the factorization (factorize<kDiv, true>).  f32 throughout, no tensor cores,
// so no TF32 rounding.  The plain versions are
// tpu_als_torch/ops/cuda_lanes.py::factorize_plain and substitute_plain
// (divide=kDiv).
//
// Two pivot rules.  kDiv = false (K1, K2, K4, K7; the reference's
// pallas_solve and pallas_lanes): the whole block column is scaled by
// inv_j.  kDiv = true (K6; the reference's pallas_lanes_blocked): the
// diagonal tiles as above, the tiles below and the substitutions divide
// by max(L_jj, 1e-30).
//
// Streamed (above kMaxTiles tiles, stream_solve): the same arithmetic in
// the same order, left-looking: block column k's tiles are formed from A
// minus, for each earlier block column m in order, the same 32-term
// products, read back from the L this block has already written over A
// (Z -= Σ_q over each m: the sums the right-looking trailing update
// forms, in the same order), a group of kGroup tiles at a time in shared
// memory (23 KB at any rank); the forward substitution runs with each
// block column, the backward one reads L's rows back.  K1's and K6's path
// above rank 288, and the card-side anchor of K4's and K7's cluster solve
// (chol_cluster.cuh), which gives the same x bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
// the tile row I of tile index t = tile_index(I, J), t < 45 (9 tiles a
// side, rank 288, the most one block's shared memory holds): a warp's
// index is uniform, so a constant-cache read
constexpr int kMaxTiles = 9;
__constant__ unsigned char kTileRow[kMaxTiles * (kMaxTiles + 1) / 2] = {
    0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 6, 6,
    6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7, 8, 8, 8, 8, 8, 8, 8, 8, 8};
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

// the divisor of column j given L_jj
template <bool kDiv>
__device__ __forceinline__ float divisor(float l) {
  return kDiv ? fmaxf(l, kPivotFloor) : l;
}

// Row i and column c of lane `lane` in unit u (one row of one tile).
__device__ __forceinline__ void unit_rc(int u, int lane, int& i, int& c) {
  const int t = u >> 5, I = kTileRow[t];
  i = I * kNB + (u & 31);
  c = (t - I * (I + 1) / 2) * kNB + lane;
}

// Row i and first column c of lane `lane` in part p (0..7) of tile (I,
// J): 16 rows x 8 columns, lane l on row 16·(p & 1) + (l >> 1) and
// columns 4·(2·(p >> 1) + (l & 1)) + 0..3.  A warp's 16-byte accesses
// to the row-major matrix fill whole 32-byte sectors, and its four
// scalar accesses to the column-major tile each fall in 32 banks.
__device__ __forceinline__ void part_rc(int p, int lane, int I, int J,
                                        int& i, int& c) {
  i = I * kNB + 16 * (p & 1) + (lane >> 1);
  c = J * kNB + 4 * (2 * (p >> 1) + (lane & 1));
}

// rsqrt(d) for a normal d (here d >= 1e-30): the multi-function unit's
// approximation, as rsqrtf gives it, without the scaling rsqrtf wraps
// around it for subnormal inputs (three instructions on a pivot's chain)
__device__ __forceinline__ float rsqrt_normal(float d) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(d));
  return y;
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

// fill() of A's lower triangle as it is; with vec (r a multiple of 4, A
// 16-byte aligned) by 16-byte loads instead, a unit being one part of one
// tile (part_rc), kBatch loads in flight a lane.  No barrier.
__device__ __forceinline__ void load_lower(float* S, int r, const float* A,
                                           bool vec) {
  if (!vec) {
    fill<false>(S, r, A, nullptr, [](int, int, float a) { return a; });
    return;
  }
  constexpr int kBatch = 8;
  const int T = tiles(r), units = T * (T + 1) / 2 * 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int u0 = warp; u0 < units; u0 += nw * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int u = min(u0 + q * nw, units - 1), t = u >> 3;
      const int I = kTileRow[t];
      int i, c;
      part_rc(u & 7, lane, I, t - I * (I + 1) / 2, i, c);
      v[q] = *reinterpret_cast<const float4*>(A + min(i, r - 1) * r +
                                              min(c, r - 4));
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int u = u0 + q * nw, t = u >> 3;
      if (u < units) {
        const int I = kTileRow[t];
        int i, c;
        part_rc(u & 7, lane, I, t - I * (I + 1) / 2, i, c);
        const float e[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
        float* dst = S + t * kTileFloats + (c & 31) * kLd + (i & 31);
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int cy = c + y;
          dst[y * kLd] = (i < r && cy < r) ? (cy <= i ? e[y] : 0.f)
                                           : (i == cy ? 1.f : 0.f);
        }
      }
    }
  }
}

// Write L from the tiles over the row-major r x r matrix A, with 0 above
// the diagonal, by the warps w0, w0 + 1, ... of the block: with vec by
// 16-byte stores, a unit one part of one of the T x T tiles; else a unit
// is one row of one tile, a lane a column.  No barrier.
__device__ __forceinline__ void store_lower(const float* S, int r, float* A,
                                            bool vec, int w0) {
  const int T = tiles(r);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - w0;
  const int nw = (blockDim.x >> 5) - w0;
  if (vec) {
    for (int u = warp; u < T * T * 8; u += nw) {
      const int t = u >> 3, I = t / T, J = t - I * T;
      int i, c;
      part_rc(u & 7, lane, I, J, i, c);
      if (i >= r || c >= r) continue;
      float e[4] = {0.f, 0.f, 0.f, 0.f};
      if (J <= I) {
        const float* src = S + tile_index(I, J) * kTileFloats +
                           (c & 31) * kLd + (i & 31);
#pragma unroll
        for (int y = 0; y < 4; ++y)
          if (c + y <= i) e[y] = src[y * kLd];
      }
      *reinterpret_cast<float4*>(A + i * r + c) =
          make_float4(e[0], e[1], e[2], e[3]);
    }
  } else {
    for (int u = warp; u < T * T * kNB; u += nw) {
      const int t = u >> 5, I = t / T, J = t - I * T;
      const int i = I * kNB + (u & 31), c = J * kNB + lane;
      if (i < r && c < r)
        A[i * r + c] = (J <= I && c <= i)
                           ? S[tile_index(I, J) * kTileFloats + lane * kLd +
                               (u & 31)]
                           : 0.f;
    }
  }
}

// A diagonal tile Dk, by one warp: lane i holds row i in registers;
// column j's pivot comes by shuffle from lane j, L[c][j] from lane c.
// Writes ik[j] = rsqrt(max(pivot_j, 1e-30)) and rk[j] = 1 / divisor(L_jj).
// Lane j + 1 forms its next pivot from its own L[j+1][j] before the
// update's shuffles (the same multiply-add the update gives it), so a
// column's chain holds one shuffle.  Every lane updates its whole row:
// the entries above the diagonal take values that are never read into
// the lower ones (a lower entry's update reads only lower entries) and
// are not written back, and no update waits on a predicate.  The
// reciprocals follow the loop, a lane each, off the chain.
template <bool kDiv>
__device__ __forceinline__ void diagonal_tile(float* Dk, float* ik,
                                              float* rk) {
  const int lane = threadIdx.x & 31;
  float a[kNB];
#pragma unroll
  for (int c = 0; c < kNB; ++c) a[c] = c <= lane ? Dk[c * kLd + lane] : 0.f;
  float piv = a[0];  // lane j's value is column j's pivot at step j
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const float d = __shfl_sync(kFull, piv, j);
    const float iv = rsqrt_normal(fmaxf(d, kPivotFloor));
    const float l = a[j] * iv;
    a[j] = l;
    if (j + 1 < kNB) piv = fmaf(-l, l, a[j + 1]);
#pragma unroll
    for (int c = j + 1; c < kNB; ++c)
      a[c] = fmaf(-l, __shfl_sync(kFull, l, c), a[c]);
    if (lane == 0) ik[j] = iv;
  }
#pragma unroll
  for (int c = 0; c < kNB; ++c)
    if (c <= lane) Dk[c * kLd + lane] = a[c];
  __syncwarp();
  rk[lane] = __frcp_rn(divisor<kDiv>(Dk[lane * kLd + lane]));
}

// The m tiles below the diagonal tile Dk (tile_at(0..m-1)), by the
// first nt threads: a thread a row, in registers, for j in order L[i][j] = a[i][j]·ik[j] (kDiv:
// a[i][j] / max(L_jj, 1e-30)), then a[i][c] -= L[i][j]·L[c][j] for the
// tile's later columns c.
template <bool kDiv, typename TileAt>
__device__ __forceinline__ void panel(TileAt tile_at, const float* Dk,
                                      const float* ik, const float* rk,
                                      int m, int nt) {
  for (int t = threadIdx.x; t < m * kNB; t += nt) {
    float* P = tile_at(t >> 5);
    const int rho = t & 31;
    float a[kNB];
#pragma unroll
    for (int c = 0; c < kNB; ++c) a[c] = P[c * kLd + rho];
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      const float l =
          kDiv ? div_rn(a[j], divisor<true>(Dk[j * kLd + j]), rk[j])
               : a[j] * ik[j];
      a[j] = l;
#pragma unroll
      for (int c = j + 1; c < kNB; ++c) a[c] -= l * Dk[j * kLd + c];
    }
#pragma unroll
    for (int c = 0; c < kNB; ++c) P[c * kLd + rho] = a[c];
  }
}

// One 4 x 4 register tile of a trailing update: Z[x][y] -= Σ_q X[x][q]
// Y[y][q], X and Y column-major at kLd (rows x, y = 0..3), Z's column y
// at Z + y·kLd; the 32 products q summed in order first, then subtracted
// (the sums stream_solve's schur_tile forms and subtracts the same way).
__device__ __forceinline__ void sub_products(const float* X, const float* Y,
                                             float* Z) {
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
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    float4* zp = reinterpret_cast<float4*>(Z + y * kLd);
    float4 z = *zp;
    z.x -= acc[0][y];
    z.y -= acc[1][y];
    z.z -= acc[2][y];
    z.w -= acc[3][y];
    *zp = z;
  }
}

// The trailing update of block column k, Z -= Σ_q P_I[:, q] P_J[:, q]ᵀ,
// on the tiles (I, J) = (k+1+ii, k+1+jj), jj <= ii < m: 64 register
// tiles of 4 x 4 a tile; a warp takes 32 of them, lanes over its rows
// (a4) and 4 column groups (b4); the first nt threads share them.
__device__ __forceinline__ void trailing(float* S, int k, int m, int nt) {
  const int pairs = m * (m + 1) / 2;
  for (int s = threadIdx.x; s < pairs * 64; s += nt) {
    const int p = s >> 6, a4 = s & 7, b4 = (s >> 3) & 7;
    const int ii = kTileRow[p], jj = p - ii * (ii + 1) / 2;
    if (ii == jj && b4 > a4) continue;  // wholly above the diagonal
    const int I = k + 1 + ii, J = k + 1 + jj;
    sub_products(tile(S, I, k) + 4 * a4, tile(S, J, k) + 4 * b4,
                 tile(S, I, J) + 4 * a4 + 4 * b4 * kLd);
  }
}

// y := Dk⁻¹ y with lane i holding y_i (returned): y_j divided on lane
// j, broadcast by shuffle, and lane i > j subtracts y_j·L[i][j], its own
// entry of column j (read ahead): a step's chain is a division (div_rn:
// a product and two multiply-adds), a shuffle and a multiply-add.
template <bool kDiv>
__device__ __forceinline__ float forward_lanes(const float* Dk,
                                               const float* rk, float yi) {
  const int lane = threadIdx.x & 31;
  float lc[kNB];
#pragma unroll
  for (int j = 0; j < kNB; ++j) lc[j] = Dk[j * kLd + lane];
  const float dl = divisor<kDiv>(Dk[lane * kLd + lane]), rl = rk[lane];
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    if (lane == j) yi = div_rn(yi, dl, rl);
    const float yj = __shfl_sync(kFull, yi, j);
    if (lane > j) yi -= yj * lc[j];
  }
  return yi;
}

// y := Dkᵀ⁻¹ y, likewise: lane i < j subtracts x_j·L[j][i] (its column
// of Dk, read by 16-byte loads)
template <bool kDiv>
__device__ __forceinline__ float backward_lanes(const float* Dk,
                                                const float* rk, float yi) {
  const int lane = threadIdx.x & 31;
  float lr[kNB];
#pragma unroll
  for (int q = 0; q < kNB; q += 4) {
    const float4 v = *reinterpret_cast<const float4*>(Dk + lane * kLd + q);
    lr[q] = v.x;
    lr[q + 1] = v.y;
    lr[q + 2] = v.z;
    lr[q + 3] = v.w;
  }
  const float dl = divisor<kDiv>(Dk[lane * kLd + lane]), rl = rk[lane];
#pragma unroll
  for (int j = kNB - 1; j >= 0; --j) {
    if (lane == j) yi = div_rn(yi, dl, rl);
    const float xj = __shfl_sync(kFull, yi, j);
    if (lane < j) yi -= xj * lr[j];
  }
  return yi;
}

// res_I -= L_Ik y for the tiles I = k+1 .. T-1 below tile k, y broadcast
// in every lane's registers, lane i on row i of each (one warp)
__device__ __forceinline__ void forward_rest(float* S, int T, int k,
                                             float* res, const float (&y)[kNB]) {
  const int lane = threadIdx.x & 31;
  for (int I = k + 1; I < T; ++I) {
    const float* L = tile(S, I, k) + lane;
    float acc = res[I * kNB + lane];
#pragma unroll
    for (int j = 0; j < kNB; ++j) acc -= y[j] * L[j * kLd];
    res[I * kNB + lane] = acc;
  }
}

// In place: the tiles hold A on entry, L (A = L Lᵀ) on exit in their
// lower triangle; inv and rcp as diagonal_tile() writes them.  T <=
// kMaxTiles tiles a side.  Three barriers a block column.  Opens and
// closes with a barrier.  With kFwd the block's last warp runs the
// forward substitution L y = b [r] alongside, into the substitutions'
// vector: tile k's solve during block column k's panel, the residual
// rows below it during its trailing update, which the other warps
// share; substitute<kDiv, true>() then runs the backward one.
template <bool kDiv = false, bool kFwd = false>
__device__ __forceinline__ void factorize(float* S, int T, int r = 0,
                                          const float* b = nullptr) {
  float* inv = inv_of(S, T);
  float* rcp = inv + kNB * T;
  float* res = rcp + kNB * T;
  const int lane = threadIdx.x & 31;
  const bool solver = kFwd && threadIdx.x >= blockDim.x - 32;
  const int nt = kFwd ? blockDim.x - 32 : blockDim.x;
  if (solver)
    for (int i = lane; i < kNB * T; i += kNB) res[i] = i < r ? b[i] : 0.f;
  float y[kNB];
  __syncthreads();
  for (int k = 0; k < T; ++k) {
    float* Dk = tile(S, k, k);
    if (threadIdx.x < 32)
      diagonal_tile<kDiv>(Dk, inv + k * kNB, rcp + k * kNB);
    __syncthreads();
    if (solver) {
      const float yi =
          forward_lanes<kDiv>(Dk, rcp + k * kNB, res[k * kNB + lane]);
      res[k * kNB + lane] = yi;
#pragma unroll
      for (int j = 0; j < kNB; ++j) y[j] = __shfl_sync(kFull, yi, j);
    }
    const int m = T - 1 - k;  // tiles below the diagonal one
    if (m == 0) break;
    if (!solver)
      panel<kDiv>([&](int i) { return tile(S, k + 1 + i, k); }, Dk,
                  inv + k * kNB, rcp + k * kNB, m, nt);
    __syncthreads();
    if (solver)
      forward_rest(S, T, k, res, y);
    else
      trailing(S, k, m, nt);
    __syncthreads();
  }
  if (kFwd) __syncthreads();
}

// Solve L Lᵀ x = b with the tiles from factorize() (whose closing
// barrier the caller has passed), by warp 0; b [r] and x [r] in any
// memory; the other warps return at once.  The residual lives in shared
// memory, lane i owning the entries i mod 32.  Each diagonal tile's
// triangular solve runs across the lanes (forward_lanes,
// backward_lanes), then lane i updates the residual rows 32I + i of the
// other tiles.  kFwdDone: factorize<kDiv, true>() has left y there, and
// only the backward substitution runs.
template <bool kDiv = false, bool kFwdDone = false>
__device__ __forceinline__ void substitute(float* S, int T, int r,
                                           const float* __restrict__ b,
                                           float* __restrict__ x) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const float* rcp = inv_of(S, T) + kNB * T;
  float* res = inv_of(S, T) + 2 * kNB * T;
  float y[kNB];
  if (!kFwdDone) {
    for (int i = lane; i < kNB * T; i += kNB) res[i] = i < r ? b[i] : 0.f;
    for (int k = 0; k < T; ++k) {  // L y = b
      const float yi = forward_lanes<kDiv>(tile(S, k, k), rcp + k * kNB,
                                           res[k * kNB + lane]);
      res[k * kNB + lane] = yi;
#pragma unroll
      for (int j = 0; j < kNB; ++j) y[j] = __shfl_sync(kFull, yi, j);
      forward_rest(S, T, k, res, y);
    }
  }
  for (int k = T - 1; k >= 0; --k) {  // Lᵀ x = y
    const float xi = backward_lanes<kDiv>(tile(S, k, k), rcp + k * kNB,
                                          res[k * kNB + lane]);
    res[k * kNB + lane] = xi;
#pragma unroll
    for (int j = 0; j < kNB; ++j) y[j] = __shfl_sync(kFull, xi, j);
    for (int I = 0; I < k; ++I) {
      const float* L = tile(S, k, I) + lane * kLd;
      float acc = res[I * kNB + lane];
#pragma unroll
      for (int j = kNB - 1; j >= 0; --j) acc -= y[j] * L[j];
      res[I * kNB + lane] = acc;
    }
  }
  for (int i = lane; i < r; i += kNB) x[i] = res[i];
}

// ---- streamed: ranks above kMaxTiles tiles --------------------------------

constexpr int kGroup = 4;                 // tiles below, formed at a time
constexpr int kStreamThreads = 64 * kGroup;  // 64 threads form a tile
// floats of shared memory stream_solve() needs at any rank: the diagonal
// tile, kGroup tiles below it, inv, rcp and a block column's y (or x)
constexpr int kStreamSmemFloats = (1 + kGroup) * kTileFloats + 3 * kNB;

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  return vec ? *reinterpret_cast<const float4*>(p)
             : make_float4(p[0], p[1], p[2], p[3]);
}

// Tile (I, k) of the system at A (row-major, L already written over its
// block columns m < k) into dst, column-major: A's entries minus, for
// each block column m < k in order, Σ_q L[i][32m + q]·L[j][32m + q] over
// q in order (the sums trailing() subtracts); the identity in the
// padding, 0 above the diagonal.  By the 64 threads t of a group:
// thread t holds rows 32I + (t & 7) + 8x and columns 32k + (t >> 3) + 8y
// of the tile, and reads L's rows by 16-byte loads when vec.
__device__ __forceinline__ void schur_tile(const float* A, int r, int I,
                                           int k, float* dst, int t,
                                           bool vec) {
  const int a = t & 7, bq = t >> 3;
  int ri[4], cj[4];
  const float* X[4];
  const float* Y[4];
  float z[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    ri[x] = I * kNB + a + 8 * x;
    cj[x] = k * kNB + bq + 8 * x;
    X[x] = A + min(ri[x], r - 1) * r;
    Y[x] = A + min(cj[x], r - 1) * r;
  }
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
      z[x][y] = (ri[x] < r && cj[y] <= ri[x]) ? X[x][cj[y]] : 0.f;
  for (int m = 0; m < k; ++m) {
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
#pragma unroll 2
    for (int q4 = 0; q4 < kNB; q4 += 4) {
      float xs[4][4], ys[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 v = load4(X[x] + m * kNB + q4, vec);
        xs[x][0] = v.x; xs[x][1] = v.y; xs[x][2] = v.z; xs[x][3] = v.w;
        const float4 w = load4(Y[x] + m * kNB + q4, vec);
        ys[x][0] = w.x; ys[x][1] = w.y; ys[x][2] = w.z; ys[x][3] = w.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] += xs[x][q] * ys[y][q];
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) z[x][y] -= acc[x][y];
  }
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int i = ri[x], j = cj[y];
      dst[(j & 31) * kLd + (i & 31)] =
          (i < r && j < r) ? (j <= i ? z[x][y] : 0.f) : (i == j ? 1.f : 0.f);
    }
}

// Tile (I, J) of L, column-major in src, into the row-major A (0 above
// the diagonal, nothing past r), by threads t, t + nt, ...
__device__ __forceinline__ void put_tile(const float* src, float* A, int r,
                                         int I, int J, bool vec, int t,
                                         int nt) {
  if (vec) {
    for (int e = t; e < 8 * kNB; e += nt) {
      int i, c;
      part_rc(e >> 5, e & 31, I, J, i, c);
      if (i >= r || c >= r) continue;
      const float* s = src + (c & 31) * kLd + (i & 31);
      float v[4];
#pragma unroll
      for (int y = 0; y < 4; ++y) v[y] = c + y <= i ? s[y * kLd] : 0.f;
      *reinterpret_cast<float4*>(A + i * r + c) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int e = t; e < kNB * kNB; e += nt) {
      const int i = I * kNB + (e >> 5), c = J * kNB + (e & 31);
      if (i < r && c < r)
        A[i * r + c] = c <= i ? src[(e & 31) * kLd + (e >> 5)] : 0.f;
    }
  }
}

// Tile (I, J) of the row-major L in A into dst, column-major, the
// identity in the padding, 0 above the diagonal; by threads t, t + nt, ...
__device__ __forceinline__ void get_tile(const float* A, int r, int I, int J,
                                         float* dst, bool vec, int t,
                                         int nt) {
  if (vec) {
    for (int e = t; e < 8 * kNB; e += nt) {
      int i, c;
      part_rc(e >> 5, e & 31, I, J, i, c);
      const float4 v = *reinterpret_cast<const float4*>(
          A + min(i, r - 1) * r + min(c, r - 4));
      const float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int cy = c + y;
        dst[(cy & 31) * kLd + (i & 31)] =
            (i < r && cy < r) ? (cy <= i ? s[y] : 0.f) : (i == cy ? 1.f : 0.f);
      }
    }
  } else {
    for (int e = t; e < kNB * kNB; e += nt) {
      const int i = I * kNB + (e >> 5), c = J * kNB + (e & 31);
      dst[(e & 31) * kLd + (e >> 5)] =
          (i < r && c < r) ? (c <= i ? A[i * r + c] : 0.f)
                           : (i == c ? 1.f : 0.f);
    }
  }
}

// Factor the system at A (row-major r x r) and write L over it, 0 above
// the diagonal; with kSolve also x = A⁻¹ b (x [r] holds the residual
// meanwhile).  kStreamThreads threads, kStreamSmemFloats of smem.  Per
// block column k: the diagonal tile by group 0 (schur_tile), factorized
// by warp 0, which also solves y_k; then the tiles below, kGroup at a
// time: formed, solved against the diagonal tile (panel), written, and
// the residual rows below updated with y_k.  Then the backward
// substitution, block column by block column from the last: the diagonal
// tile read back, x_k solved by warp 0, and every thread updates one
// residual row above it from L's rows 32k.. (read in order of j from 31
// down, as substitute() does).
template <bool kDiv, bool kSolve>
__device__ __forceinline__ void stream_solve(float* A, int r, const float* b,
                                             float* x, float* smem,
                                             bool vec) {
  float* D = smem;
  float* P = D + kTileFloats;            // kGroup tiles
  float* ik = P + kGroup * kTileFloats;  // the block column's inv_j
  float* rk = ik + kNB;                  // ... and rcp_j
  float* yk = rk + kNB;                  // ... and y_j (then x_j)
  const int T = tiles(r), tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, grp = tid >> 6;
  if (kSolve)
    for (int i = tid; i < r; i += nt) x[i] = b[i];
  for (int k = 0; k < T; ++k) {
    // the previous block column's writes and residual updates have
    // landed, and D and P are free
    __syncthreads();
    if (grp == 0) schur_tile(A, r, k, k, D, tid & 63, vec);
    __syncthreads();
    if (warp == 0) {
      diagonal_tile<kDiv>(D, ik, rk);
      if (kSolve) {  // lane i owns entry 32k + i of y
        const int i = k * kNB + lane;
        const float yi = forward_lanes<kDiv>(D, rk, i < r ? x[i] : 0.f);
        yk[lane] = yi;
        if (i < r) x[i] = yi;
      }
    }
    __syncthreads();
    put_tile(D, A, r, k, k, vec, tid, nt);
    for (int e = tid; e < k * kNB * kNB; e += nt) {  // 0 above it
      const int i = e >> 5, c = k * kNB + (e & 31);
      if (c < r) A[i * r + c] = 0.f;
    }
    for (int I0 = k + 1; I0 < T; I0 += kGroup) {
      const int g = min(kGroup, T - I0);
      if (grp < g) schur_tile(A, r, I0 + grp, k, P + grp * kTileFloats,
                              tid & 63, vec);
      __syncthreads();
      panel<kDiv>([&](int i) { return P + i * kTileFloats; }, D, ik, rk, g,
                  nt);
      __syncthreads();
      for (int s = 0; s < g; ++s)
        put_tile(P + s * kTileFloats, A, r, I0 + s, k, vec, tid, nt);
      if (kSolve && warp < g) {  // res_I -= L_Ik y_k
        const int i = (I0 + warp) * kNB + lane;
        const float* L = P + warp * kTileFloats + lane;
        float acc = i < r ? x[i] : 0.f;
#pragma unroll
        for (int j = 0; j < kNB; ++j) acc -= yk[j] * L[j * kLd];
        if (i < r) x[i] = acc;
      }
      __syncthreads();
    }
  }
  if (!kSolve) return;
  for (int k = T - 1; k >= 0; --k) {
    __syncthreads();
    get_tile(A, r, k, k, D, vec, tid, nt);
    __syncthreads();
    if (warp == 0) {
      rk[lane] = __frcp_rn(divisor<kDiv>(D[lane * kLd + lane]));
      __syncwarp();
      const int i = k * kNB + lane;
      const float xi = backward_lanes<kDiv>(D, rk, i < r ? x[i] : 0.f);
      yk[lane] = xi;
      if (i < r) x[i] = xi;
    }
    __syncthreads();
    const int jn = min(kNB, r - k * kNB);  // L's real rows in this tile
    for (int e = tid; e < k * kNB; e += nt) {  // res_I -= L_kIᵀ x_k
      const float* L = A + k * kNB * r + e;
      float acc = x[e];
      for (int j = jn - 1; j >= 0; --j) acc -= yk[j] * L[j * r];
      x[e] = acc;
    }
  }
}

// ---- the kernels of K1 and K6 ----------------------------------------------

// One block of kThreads threads a system of rank <= 288, in shared
// memory: L loaded once by 16-byte loads (when vec), factorized (with
// kSolve, the last warp running the forward substitution alongside),
// then warp 0 runs the backward substitution while the other warps
// write L over A (kStore; all warps when there is no solve).
template <bool kDiv, bool kSolve, bool kStore, int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads <= 256 ? 3 : 1)
onchip_kernel(float* A, const float* b, float* x, int r, int vec) {
  extern __shared__ __align__(16) float smem[];
  const long long sys = blockIdx.x;
  float* Ag = A + sys * r * r;
  load_lower(smem, r, Ag, vec);
  const int T = tiles(r);
  // opens and closes with a barrier
  factorize<kDiv, kSolve>(smem, T, r, kSolve ? b + sys * r : nullptr);
  if (kSolve && threadIdx.x < 32)
    substitute<kDiv, true>(smem, T, r, nullptr, x + sys * r);
  else if (kStore)
    store_lower(smem, r, Ag, vec, kSolve ? 1 : 0);
}

template <bool kDiv, bool kSolve>
__global__ void __launch_bounds__(kStreamThreads, 2)
stream_kernel(float* A, const float* b, float* x, int r, int vec) {
  extern __shared__ __align__(16) float smem[];
  const long long sys = blockIdx.x;
  stream_solve<kDiv, kSolve>(A + sys * r * r, r,
                             kSolve ? b + sys * r : nullptr,
                             kSolve ? x + sys * r : nullptr, smem, vec);
}

template <typename Kernel>
inline int launch_kernel(Kernel kernel, unsigned blocks, int threads,
                         int smem, cudaStream_t stream, float* A,
                         const float* b, float* x, int r, int vec) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, threads, smem, stream>>>(A, b, x, r, vec);
  return static_cast<int>(cudaGetLastError());
}

// Launch one of them on n systems of rank r: on chip up to kMaxTiles
// tiles a side, streamed above (always writing L over A there).  On chip
// the block's size follows n: a launch with no more systems than the
// card has SMs (the fit's wide buckets) gives each system 16 warps, for
// the latency of one; a larger one at rank <= 128 gives it 8, three
// blocks an SM, for throughput.  Returns cudaGetLastError() after the
// launch.
template <bool kDiv, bool kSolve, bool kStore>
inline int launch(float* A, const float* b, float* x, long long n, int r,
                  cudaStream_t stream) {
  if (n <= 0) return 0;
  if (r < 1 || r > 46340 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = r % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const unsigned blocks = static_cast<unsigned>(n);
  if (tiles(r) > kMaxTiles)
    return launch_kernel(stream_kernel<kDiv, kSolve>, blocks, kStreamThreads,
                         kStreamSmemFloats * sizeof(float), stream, A, b, x,
                         r, vec);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = smem_floats(r) * static_cast<int>(sizeof(float));
  if (tiles(r) <= 4 && n > sms)
    return launch_kernel(onchip_kernel<kDiv, kSolve, kStore, 256>, blocks,
                         256, smem, stream, A, b, x, r, vec);
  return launch_kernel(onchip_kernel<kDiv, kSolve, kStore, 512>, blocks, 512,
                       smem, stream, A, b, x, r, vec);
}

}  // namespace cholt
