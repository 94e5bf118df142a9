// The solve pass of kernels K4 and K7 above rank 288: each row's system
// held in the distributed shared memory of a thread-block cluster,
// factored right-looking, and solved; only x leaves the chip.
//
// Serves the solve pass of tpu_als/ops/pallas_gather_ne.py::gather_solve
// (:396 · pallas_call :446) and ::gather_solve_ring (:708 · :783) for
// every rank 289 <= r <= 512 (gather_solve.cuh's tail_cluster_kernel
// calls solve(); up to rank 288 one block holds a system, chol_tiled.cuh).
//
// What bounds it on this card: operations.  A row of rank r takes r³/3 +
// 2r² flops at the FP32 rate (67 TFLOP/s; perf/roofline.py::solve_bound)
// against r·r/2 floats of A read once and r of x written: at rank 512
// about 45 MFLOP against 0.5 MB, 0.67 µs of the card's FLOPs a row.
//
// What the design does about it.  A rank-512 system's lower triangle is
// T(T+1)/2 = 136 tiles of 32 x 36 floats (626,688 B, T = ceil(r/32)), more
// than one SM's shared memory (232,448 B a block at most), so a cluster
// of C blocks (2, 4 or 8, the fewest whose largest share fits:
// cluster_size) holds it, C neighbouring SMs reading each other's shared
// memory:
//   1. the tile rows are dealt to the C blocks from the last row up in a
//      snake (rows T-1 .. T-C to blocks 0 .. C-1, the next C rows back
//      to block 0, ...): the tile counts balance, and so does each block
//      column's trailing work, which falls on the rows below it;
//   2. each block forms its tiles of A straight from the row's Gram in
//      device memory: every row of every tile copied as it lies by
//      cp.async (16-byte copies where r % 4 == 0, else 4-byte), all in
//      flight at once and no register held, then a warp a tile reads it
//      back, adds YᵀY (gather_solve.cuh's tail: S + YᵀY, the ridge, the
//      jitter, the empty-row guard), and writes it transposed into the
//      column-major tiles of chol_tiled.cuh, the identity in the padding.
//      A's lower triangle is read once; nothing is written back but x
//      (stream_solve wrote L over A, 1 MiB a row at rank 512, and read it
//      back for every later block column);
//   3. right-looking by block columns of 32, chol_tiled.cuh's factorize()
//      arithmetic: for block column k the owner of tile row k factors the
//      diagonal tile (diagonal_tile, one warp) and hands it out; the
//      owners of the rows below solve their panel tiles against it
//      (panel) and hand those out; every block then updates its trailing
//      tiles (I, J), k < J <= I, Z -= Σ_q P_I[:, q] P_J[:, q]ᵀ, the
//      q-sum formed in order in registers and then subtracted
//      (sub_products, as trailing() does).  A tile handed out is pushed
//      by 16-byte stores into every other block's buffer, so all reads
//      are local; two cluster barriers a block column.  One step of
//      lookahead: the owner of row k + 1 updates tile (k + 1, k + 1)
//      first (warps 0 and 1), and its warp 0 factors it while warps 1 ..
//      15 finish block column k's update; it is handed out at the start
//      of block column k + 1.  The forward
//      substitution runs beside it (the owner's last warp solves y_k,
//      each block's last warp updates its rows below), the backward one
//      after it, one cluster barrier a block column (each warp reads the
//      tile L_kI of its row I < k from row k's owner before the barrier,
//      so the read overlaps the wait).
// Each entry takes the same operations in the same order as
// stream_solve()'s (left-looking: each tile minus, for each earlier block
// column in order, the same 32-term sums), so x is bit for bit the same.
// The blocks are 16 warps (one per SM: a share is above half of an SM's
// shared memory at every rank here).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chol_tiled.cuh"
#include "tf32.cuh"

namespace ccl {

namespace cg = cooperative_groups;
using cholt::kLd;
using cholt::kNB;
using cholt::kTileFloats;

constexpr int kThreads = 512;              // 16 warps a block
constexpr int kMaxT = 16;                  // tile rows up to rank 512
constexpr int kMaxC = 8;                   // the portable cluster size
constexpr int kSmemLimit = 232448;         // a block's shared memory
constexpr int kTableInts = 3 * kMaxT + kMaxC * kMaxT + 64;

// the block of the C that owns tile row I of T: a snake from the last
// row up
__host__ __device__ inline int owner(int I, int T, int C) {
  const int p = (T - 1 - I) % (2 * C);
  return p < C ? p : 2 * C - 1 - p;
}

// tiles and tile rows of block c
__host__ __device__ inline int tiles_of(int c, int T, int C) {
  int n = 0;
  for (int I = 0; I < T; ++I)
    if (owner(I, T, C) == c) n += I + 1;
  return n;
}
__host__ __device__ inline int rows_of(int c, int T, int C) {
  int n = 0;
  for (int I = 0; I < T; ++I) n += owner(I, T, C) == c;
  return n;
}

// Every block's layout, in floats (the same in all, so a peer's buffer
// sits at the same offset): its tiles, the slots for the panel tiles it
// is handed (one a tile row it does not own), the diagonal tile it is
// handed, inv [32], rcp [32], y [32], the residual [32·T], x [32·T], then
// the tables (ints).
struct Layout {
  int tiles, slots;  // the largest of any block
};
__host__ __device__ inline Layout layout(int T, int C) {
  Layout l{0, 0};
  for (int c = 0; c < C; ++c) {
    const int t = tiles_of(c, T, C), s = T - rows_of(c, T, C);
    l.tiles = t > l.tiles ? t : l.tiles;
    l.slots = s > l.slots ? s : l.slots;
  }
  return l;
}
__host__ __device__ inline long long smem_bytes(int T, int C) {
  const Layout l = layout(T, C);
  return (static_cast<long long>(l.tiles + l.slots + 1) * kTileFloats +
          3 * kNB + 2 * kNB * T + kTableInts) * 4;
}
// the cluster size at rank r: the fewest of 2, 4, 8 blocks whose share
// fits in a block's shared memory (0: none does)
__host__ __device__ inline int cluster_size(int r) {
  const int T = cholt::tiles(r);
  for (int C = 2; C <= kMaxC; C *= 2)
    if (C <= T && smem_bytes(T, C) <= kSmemLimit) return C;
  return 0;
}

// Z -= X Yᵀ on one 4 x 4 register tile, the products over the 32 columns
// q summed in order first (cholt::sub_products)
using cholt::sub_products;

// Asynchronous copies into shared memory (cp.async: 16 bytes, both
// addresses 16-byte aligned, or 4), and the wait for all of a thread's
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src));
}
// A barrier of warps 0 and 1 alone (named barrier 1)
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 1, 64;" ::: "memory");
}
__device__ __forceinline__ void copies_done() {
  tc::commit();
  tc::wait_pending<0>();
}

// Solve the row's system from its Gram: tile (I, J) of A is tail(i, c,
// A[i][c] (+ add[i][c] when kAdd)) for c <= i < r (A and add row-major r x
// r, only their lower triangles read; vec: r % 4 == 0 and both 16-byte
// aligned), the identity in the padding; b [r] in device memory; x [r]
// written by the owners.  Called by all kThreads threads of every block
// of a cluster of cluster_size(r) blocks, smem as smem_bytes() lays out.
template <bool kAdd, typename Tail>
__device__ __forceinline__ void solve(const float* __restrict__ A, int r,
                                      const float* __restrict__ add,
                                      const float* __restrict__ b,
                                      float* __restrict__ x, float* smem,
                                      bool vec, Tail tail) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int me = static_cast<int>(cl.block_rank());
  const int T = cholt::tiles(r), tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const Layout lay = layout(T, C);
  float* tl = smem;                                 // my tiles
  float* sl = tl + lay.tiles * kTileFloats;         // handed panel tiles
  float* Db = sl + lay.slots * kTileFloats;         // handed D_k
  float* ik = Db + kTileFloats;                     // inv_j of column k
  float* rk = ik + kNB;                             // rcp_j (ik's neighbour)
  float* yb = rk + kNB;                             // y_k
  float* res = yb + kNB;                            // the residual [32T]
  float* xa = res + kNB * T;                        // x [32T]
  int* own = reinterpret_cast<int*>(xa + kNB * T);  // owner of row I
  int* tbase = own + kMaxT;     // row I's first tile in its owner's tiles
  int* slot = tbase + kMaxT;    // [c][J]: block c's slot of row J
  int* mine = slot + kMaxC * kMaxT;  // my rows ascending, then trow
  int* trow = mine + kMaxT;          // my tile t's row
  if (tid < T) {
    const int I = tid;
    own[I] = owner(I, T, C);
    int base = 0;
    for (int q = 0; q < I; ++q)
      if (owner(q, T, C) == own[I]) base += q + 1;
    tbase[I] = base;
    for (int c = 0; c < C; ++c) {
      int s = 0;
      for (int q = 0; q < I; ++q) s += owner(q, T, C) != c;
      slot[c * kMaxT + I] = s;
    }
  }
  int nmine = 0;  // my rows, the same in every thread
  for (int I = 0; I < T; ++I) nmine += owner(I, T, C) == me;
  if (tid == 0) {
    int m = 0, t = 0;
    for (int I = 0; I < T; ++I)
      if (owner(I, T, C) == me) {
        mine[m++] = I;
        for (int J = 0; J <= I; ++J) trow[t++] = I;
      }
  }
  __syncthreads();
  const int ntiles = tiles_of(me, T, C);
  auto tile = [&](int I, int J) { return tl + (tbase[I] + J) * kTileFloats; };

  // A's tiles: (1) every row of every tile copied as it lies in A (row
  // i of tile (I, J) at i·kLd: 16-byte cp.async with vec, else 4-byte),
  // all copies in flight at once and no register held; (2) a warp a tile
  // reads it back, adds its rows of `add` (coalesced loads), applies the
  // tail, and writes it transposed (column-major), the identity in the
  // padding and 0 above the diagonal
  if (vec) {
    for (int e = tid; e < ntiles * kNB * 8; e += nt) {
      const int t = e >> 8, i = trow[t] * kNB + ((e >> 3) & 31);
      const int c = (t - tbase[trow[t]]) * kNB + 4 * (e & 7);
      if (i < r && c < r)
        copy16(tl + t * kTileFloats + ((e >> 3) & 31) * kLd + 4 * (e & 7),
               A + i * r + c);
    }
  } else {
    for (int e = tid; e < ntiles * kNB * kNB; e += nt) {
      const int t = e >> 10, i = trow[t] * kNB + ((e >> 5) & 31);
      const int c = (t - tbase[trow[t]]) * kNB + (e & 31);
      if (i < r && c < r)
        copy4(tl + t * kTileFloats + ((e >> 5) & 31) * kLd + (e & 31),
              A + i * r + c);
    }
  }
  copies_done();
  __syncthreads();
  for (int t = warp; t < ntiles; t += nw) {
    const int I = trow[t], c = (t - tbase[I]) * kNB + lane;
    float* S = tl + t * kTileFloats;
    float v[kNB], w[kNB];
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      const int gi = I * kNB + i;
      v[i] = S[i * kLd + lane];
      w[i] = kAdd && gi < r && c <= gi ? add[gi * r + c] : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      const int gi = I * kNB + i;
      S[lane * kLd + i] =
          (gi < r && c < r)
              ? (c <= gi ? tail(gi, c, kAdd ? v[i] + w[i] : v[i]) : 0.f)
              : (gi == c ? 1.f : 0.f);
    }
  }
  for (int i = tid; i < kNB * T; i += nt)
    if (own[i >> 5] == me) res[i] = i < r ? b[i] : 0.f;
  // every block has started (its shared memory may be written) and
  // formed its tiles
  cl.sync();

  // float4 copies of n4 float4 from src to the same place in block c
  auto push = [&](int c, const float* src, float* dst_local, int f) {
    reinterpret_cast<float4*>(cl.map_shared_rank(dst_local, c))[f] =
        reinterpret_cast<const float4*>(src)[f];
  };
  constexpr int kTile4 = kTileFloats / 4;  // 288
  constexpr int kD4 = kTile4 + 2 * kNB / 4;  // a diagonal tile, inv, rcp
  for (int k = 0; k < T; ++k) {
    const int ok = own[k];
    const float* Dk = ok == me ? tile(k, k) : Db;
    int f = 0;  // my rows at or above k
    while (f < nmine && mine[f] <= k) ++f;
    const int m = nmine - f;  // my rows below k
    // (A) the owner hands out the diagonal tile, with inv and rcp; it
    // factored it (diagonal_tile) in the previous block column's update
    if (ok == me) {
      if (k == 0 && warp == 0) cholt::diagonal_tile<false>(tile(0, 0), ik, rk);
      __syncthreads();
      for (int e = tid; e < (C - 1) * kD4; e += nt) {
        const int d = e / kD4, q = e - d * kD4;
        const int c = d < me ? d : d + 1;
        if (q < kTile4)
          push(c, Dk, Db, q);
        else
          push(c, ik, ik, q - kTile4);
      }
    }
    cl.sync();  // D_k, inv and rcp in every block
    // (B) my panel tiles (I, k), I > k, by warps 0 .. nw-2; the owner's
    // last warp solves y_k (forward_lanes) and hands it out
    if (warp < nw - 1)
      cholt::panel<false>([&](int i) { return tile(mine[f + i], k); }, Dk,
                          ik, rk, m, nt - 32);
    else if (ok == me) {
      const float yi = cholt::forward_lanes<false>(Dk, rk, res[k * kNB + lane]);
      res[k * kNB + lane] = yi;
      for (int c = 0; c < C; ++c)
        cl.map_shared_rank(yb, c)[lane] = yi;
    }
    __syncthreads();
    for (int e = tid; e < (C - 1) * m * kTile4; e += nt) {
      const int q = e / kTile4, g = e - q * kTile4;
      const int d = q / m, i = q - d * m;
      const int c = d < me ? d : d + 1, I = mine[f + i];
      push(c, tile(I, k), sl + slot[c * kMaxT + I] * kTileFloats, g);
    }
    cl.sync();  // the panel tiles and y_k in every block
    // (C) the last warp: res_I -= L_Ik y_k on my rows below k
    // (forward_rest); then every thread: the trailing update of my tiles
    if (warp == nw - 1) {
      float y[kNB];
#pragma unroll
      for (int j = 0; j < kNB; ++j) y[j] = yb[j];
      for (int i = 0; i < m; ++i) {
        const int I = mine[f + i];
        const float* L = tile(I, k) + lane;
        float acc = res[I * kNB + lane];
#pragma unroll
        for (int j = 0; j < kNB; ++j) acc -= y[j] * L[j * kLd];
        res[I * kNB + lane] = acc;
      }
    }
    // the owner of row k + 1 takes tile (k + 1, k + 1) first (warps 0 and
    // 1, items 0 .. 63); its warp 0 then factors it while warps 1 .. nw-1
    // share the rest (the peers read the handed D_k no more: the barrier
    // above)
    const bool ahead = k + 1 < T && own[k + 1] == me;
    int pairs = 0;
    for (int i = 0; i < m; ++i) pairs += mine[f + i] - k;
    const int s0 = ahead && tid >= 32 ? 64 + tid - 32 : tid;
    const int ds = ahead ? nt - 32 : nt;
    for (int s = ahead && tid < 64 ? tid : s0; s < pairs * 64;
         s = s < 64 && ahead ? (warp == 0 ? pairs * 64 : s0) : s + ds) {
      int p = s >> 6, i = f;
      while (p >= mine[i] - k) p -= mine[i++] - k;
      const int I = mine[i], J = k + 1 + p;
      const int a4 = s & 7, b4 = (s >> 3) & 7;
      if (I != J || b4 <= a4) {  // else wholly above the diagonal
        const float* Y = own[J] == me
                             ? tile(J, k)
                             : sl + slot[me * kMaxT + J] * kTileFloats;
        sub_products(tile(I, k) + 4 * a4, Y + 4 * b4,
                     tile(I, J) + 4 * a4 + 4 * b4 * kLd);
      }
      if (ahead && s < 64) {  // tile (k + 1, k + 1) is final
        pair_sync();
        if (warp == 0)
          cholt::diagonal_tile<false>(tile(k + 1, k + 1), ik, rk);
      }
    }
    __syncthreads();
  }

  // the backward substitution: row k's owner solves x_k and hands it out;
  // every block then takes L_kIᵀ x_k off its rows I < k, reading the
  // tiles (k, I) from row k's owner (its real rows only, as stream_solve)
  for (int k = T - 1; k >= 0; --k) {
    const int ok = own[k];
    int nb = 0;  // my rows above k
    while (nb < nmine && mine[nb] < k) ++nb;
    // warp w's row I (its w-th above k): tile (k, I)'s column `lane`,
    // read from row k's owner before the barrier (L is final)
    float lv[kNB];
    if (warp < nb) {
      const float* L =
          cl.map_shared_rank(tl + (tbase[k] + mine[warp]) * kTileFloats, ok) +
          lane * kLd;
#pragma unroll
      for (int q = 0; q < kNB; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(L + q);
        lv[q] = v.x;
        lv[q + 1] = v.y;
        lv[q + 2] = v.z;
        lv[q + 3] = v.w;
      }
    }
    if (ok == me && warp == 0) {
      const float* Dk = tile(k, k);
      rk[lane] = __frcp_rn(Dk[lane * kLd + lane]);
      __syncwarp();
      const int i = k * kNB + lane;
      const float xi = cholt::backward_lanes<false>(Dk, rk, res[i]);
      if (i < r) x[i] = xi;
      for (int c = 0; c < C; ++c) cl.map_shared_rank(xa, c)[i] = xi;
    }
    cl.sync();  // x_k in every block
    if (warp < nb) {
      const int I = mine[warp];
      const int jn = min(kNB, r - k * kNB);  // L's real rows in this tile
      float acc = res[I * kNB + lane];
#pragma unroll
      for (int j = kNB - 1; j >= 0; --j)
        if (j < jn) acc -= xa[k * kNB + j] * lv[j];
      res[I * kNB + lane] = acc;
    }
    __syncthreads();
  }
  cl.sync();  // no block leaves while a peer may read its tiles
}

}  // namespace ccl
