// The gathered weighted Gram of one width chunk, for Hopper (sm_90a).
//
// The block body of kernel K3 (gather_gram.cu) and of the first pass of
// kernels K4 (gather_solve.cu) and K7 (gather_solve_ring.cu).  For the
// entries [w0, w1) of one row of an entry source (gram.cuh's RowEntries,
// or K7's ring source):
//
//   S = Σ (aw·v) (aw·v)ᵀ   (two-sided)   or   Σ (aw·v) vᵀ   (one-sided)
//   b = Σ bw·v             cnt = Σ cw      with v the entry's factor row
//
// aw·v is formed in f32 (exact for a bf16 table and bf16 weights: the
// reference's XLA lowering keeps that product in f32 too), everything
// accumulates in f32.  The design:
//
// - Async gather.  The rows of kT entries at a time are copied into a
//   ring of kStages stages in shared memory by cp.async (16 bytes a lane
//   where the row allows, cp.async.cg), in the table's own type; the
//   entries' row handles and weights are loaded two stages ahead of the
//   copies.  Stage k's math overlaps the copies of stages k+1 .. k+3:
//   one cp.async wait and one block barrier a stage.  A stage whose
//   weights are all zero adds nothing and is skipped: the padding of a
//   bucket's rows (a quarter to three quarters of the entries of a
//   power-law catalog's wide buckets, more in a ring grid) is neither
//   gathered nor multiplied.
// - Raw rows only.  The stage holds v; aw·v is formed in registers while
//   the operands are built.
// - Tensor cores at f32 accuracy (3xTF32).  Each operand x is split into
//   two TF32 values, x = big + small (split_tf32: < 2^-21 |x| left out),
//   and mma.sync m16n8k8 accumulates small·big + big·small + big·big in
//   f32 (the small·small term, < 2^-22 of a product, is dropped).  A warp owns one 32x32 tile of
//   the lower triangle (2 x 4 mma tiles; on the diagonal the two tiles
//   wholly above it are skipped); its sums stay in registers.  The
//   tensor cores' f32 accumulation truncates, so each stage's 12 mma
//   steps go into a zeroed partial that is then added to the running
//   sums with round-to-nearest f32 adds: two-level sums, so a long row's
//   running sums see w/kT additions rather than w.
// - Rank <= 256 in one instantiation.  The triangle has T(T+1)/2 warp
//   tiles, T = ceil(r/32): 10 at rank 128, 36 at rank 256.  A block has
//   at most kMaxWarps = 12 warps; a larger triangle is cut over `parts`
//   blocks (grid z), each gathering the rows again and computing 12 of
//   the tiles (3 parts at ranks 200 and 256).  Sixty-four accumulator
//   registers a thread (partial and running) leave room for the
//   operands at 384 threads; holding three warp tiles in one warp would
//   not, and a running triangle in shared memory would put
//   shared-memory traffic back into the hot loop.
//   Part 0 also sums b (a thread per column) and the count.  Above rank
//   256 the kernels run gram_strips.cuh's body instead.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram.cuh"
#include "tf32.cuh"

namespace g90 {

using tc::commit;
using tc::mma_tf32;
using tc::smem_addr;
using tc::split_tf32;
using tc::wait_pending;

constexpr int kT = 32;          // entries per stage (4 mma k-steps)
constexpr int kStages = 4;      // staged rows in flight
constexpr int kMeta = 8;        // staged handles and weights (>= kStages+4)
constexpr int kMaxWarps = 12;   // warps per block, one warp tile each
constexpr int kMaxThreads = 32 * kMaxWarps;
static_assert(kT == 32, "one warp loads a stage's handles and weights");

__host__ __device__ inline int side_tiles(int r) { return (r + 31) / 32; }
__host__ __device__ inline int warp_tiles(int r) {
  const int t = side_tiles(r);
  return t * (t + 1) / 2;
}
// warps per block and blocks per chunk for rank r
__host__ __device__ inline int warps(int r) {
  return warp_tiles(r) < kMaxWarps ? warp_tiles(r) : kMaxWarps;
}
__host__ __device__ inline int parts(int r) {
  return (warp_tiles(r) + kMaxWarps - 1) / kMaxWarps;
}
// a staged row's stride in elements: 32T + 8 keeps the fragment loads of
// one warp on 32 distinct banks (f32) or distinct words (bf16)
__host__ __device__ inline int row_stride(int r) {
  return 32 * side_tiles(r) + 8;
}
// per staged slot: kT handles, aw, bw and cw; then kMeta live flags
__host__ __device__ inline int meta_bytes() {
  return kMeta * 4 * kT * 4 + kMeta * 4;
}
template <typename T>
__host__ __device__ inline size_t smem_bytes(int r) {
  return meta_bytes() +
         static_cast<size_t>(kStages) * kT * row_stride(r) * sizeof(T);
}
// bytes per copy instruction: the largest of 16, 8, 4 dividing a row (2:
// a bf16 row of odd rank, copied by plain loads and stores)
template <typename T>
__host__ __device__ inline int copy_bytes(int r) {
  const int rb = r * static_cast<int>(sizeof(T));
  return rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : rb % 4 == 0 ? 4 : 2;
}

__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else
    *static_cast<unsigned short*>(dst) =
        *static_cast<const unsigned short*>(src);
}

struct Acc {
  float s[2][4][4];  // the warp tile's running sums (mma C layout)
  int ti, tj;        // the warp tile: rows 32ti.., columns 32tj..
  bool math;         // this warp owns a tile
  float b;           // b[threadIdx.x] (part 0, threadIdx.x < r)
  float cnt;         // Σ cw (part 0, thread 0)
};

// Accumulate entries [w0, w1) of one row of `src` into `acc`: the warp
// tiles of blocks' part `part`, and (part 0) b and the count.  Called by
// every thread of a block of 32·warps(r) threads; smem: smem_bytes<T>(r)
// bytes, 16-byte aligned.
template <typename T, bool kTwoSided, typename Src>
__device__ __forceinline__ void gram(const Src& src, int r, long long w0,
                                     long long w1, int part,
                                     unsigned char* smem, Acc& acc) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int ld = row_stride(r);
  const int cb = copy_bytes<T>(r);
  const int cpr = r * static_cast<int>(sizeof(T)) / cb;  // copies a row
  float* meta = reinterpret_cast<float*>(smem);  // [kMeta][4][kT]
  int* live = reinterpret_cast<int*>(meta + kMeta * 4 * kT);  // [kMeta]
  T* rows = reinterpret_cast<T*>(smem + meta_bytes());  // [kStages][kT][ld]
  const int nst = static_cast<int>((w1 - w0 + kT - 1) / kT);

  const int t = part * kMaxWarps + warp;
  acc.math = t < warp_tiles(r);
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  acc.ti = ti;
  acc.tj = t - ti * (ti + 1) / 2;
  const bool diag = acc.ti == acc.tj;
  const int i0 = 32 * acc.ti, j0 = 32 * acc.tj;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc.s[m][n][q] = 0.f;
  acc.b = 0.f;
  acc.cnt = 0.f;
  const bool lead = part == 0;

  // the columns [r, ld) are read as zeros and never copied
  {
    float* words = reinterpret_cast<float*>(rows);
    const int nwords = kStages * kT * ld * static_cast<int>(sizeof(T)) / 4;
    for (int i = tid; i < nwords; i += nthr) words[i] = 0.f;
  }
  auto slot = [&](int s) { return meta + (s % kMeta) * 4 * kT; };
  // an entry past the chunk gathers row handle 0 with zero weights
  auto load = [&](int s, int& h, float& a, float& bb, float& c) {
    h = 0;
    a = bb = c = 0.f;
    const long long pos = w0 + static_cast<long long>(s) * kT + tid;
    if (s < nst && pos < w1) src.load(pos, h, a, bb, c);
  };
  // called by warp 0: a stage whose weights are all zero (padding: a
  // padded row, or a source's slice past its degree) adds nothing, and
  // is neither copied nor computed
  auto store = [&](int s, int h, float a, float bb, float c) {
    float* m = slot(s);
    reinterpret_cast<int*>(m)[tid] = h;
    m[kT + tid] = a;
    m[2 * kT + tid] = bb;
    m[3 * kT + tid] = c;
    const unsigned any =
        __ballot_sync(0xffffffffu, a != 0.f || bb != 0.f || c != 0.f);
    if (tid == 0) live[s % kMeta] = any != 0u;
  };
  // a warp per entry, its lanes over the row's copies
  auto issue = [&](int s) {
    if (s < nst && live[s % kMeta]) {
      const int* hs = reinterpret_cast<const int*>(slot(s));
      T* dst = rows + (s % kStages) * kT * ld;
      for (int e = warp; e < kT; e += nthr >> 5) {
        const char* g = reinterpret_cast<const char*>(src.row(hs[e]));
        char* d = reinterpret_cast<char*>(dst + e * ld);
        for (int c = lane; c < cpr; c += 32)
          copy_async(d + c * cb, g + c * cb, cb);
      }
    }
    commit();  // one group a stage, empty or not: the wait counts on it
  };

  // the handles and weights of stage s are loaded into registers an
  // iteration before they are stored (the load's latency hides behind a
  // stage of math), and stored a stage before their copies are issued
  int h = 0;
  float a = 0.f, bb = 0.f, c = 0.f;
  if (tid < kT) {
    for (int s = 0; s < kStages; ++s) {
      load(s, h, a, bb, c);
      store(s, h, a, bb, c);
    }
    load(kStages, h, a, bb, c);
  }
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int k = 0; k < nst; ++k) {
    if (tid < kT) {
      store(k + kStages, h, a, bb, c);  // its slot held stage k - 4
      load(k + kStages + 1, h, a, bb, c);
    }
    wait_pending<kStages - 2>();  // this thread's copies of stage k
    __syncthreads();  // everyone's copies landed; stage k-1 is consumed
    issue(k + kStages - 1);  // into stage k-1's slot

    const float* m = slot(k);
    const float* aw_s = m + kT;
    const T* st = rows + (k % kStages) * kT * ld;
    const bool on = live[k % kMeta];
    if (acc.math && on) {
      float p[2][4][4];
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) p[mm][n][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kT / 8; ++kk) {
        const int e = kk * 8 + tig;
        const T* r0 = st + e * ld;  // entry e (k = tig)
        const T* r1 = r0 + 4 * ld;  // entry e + 4 (k = tig + 4)
        const float a0 = aw_s[e], a1 = aw_s[e + 4];
        uint32_t ab[2][4], as[2][4], bb_[4][2], bs[4][2];
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          const int i = i0 + 16 * mm + gid;
          split_tf32(gram::to_f(r0[i]) * a0, ab[mm][0], as[mm][0]);
          split_tf32(gram::to_f(r0[i + 8]) * a0, ab[mm][1], as[mm][1]);
          split_tf32(gram::to_f(r1[i]) * a1, ab[mm][2], as[mm][2]);
          split_tf32(gram::to_f(r1[i + 8]) * a1, ab[mm][3], as[mm][3]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int j = j0 + 8 * n + gid;
          float v0 = gram::to_f(r0[j]), v1 = gram::to_f(r1[j]);
          if (kTwoSided) {
            v0 *= a0;
            v1 *= a1;
          }
          split_tf32(v0, bb_[n][0], bs[n][0]);
          split_tf32(v1, bb_[n][1], bs[n][1]);
        }
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            if (diag && mm == 0 && n >= 2) continue;  // above the diagonal
            mma_tf32(p[mm][n], as[mm], bb_[n]);
            mma_tf32(p[mm][n], ab[mm], bs[n]);
            mma_tf32(p[mm][n], ab[mm], bb_[n]);
          }
      }
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc.s[mm][n][q] += p[mm][n][q];
    }
    if (lead && on) {
      const float* bw_s = m + 2 * kT;
      const float* cw_s = m + 3 * kT;
      if (tid < r) {
        float tb = 0.f;
#pragma unroll 8
        for (int e = 0; e < kT; ++e)
          tb += bw_s[e] * gram::to_f(st[e * ld + tid]);
        acc.b += tb;
      }
      if (tid == 0) {
        float tc = 0.f;
#pragma unroll 8
        for (int e = 0; e < kT; ++e) tc += cw_s[e];
        acc.cnt += tc;
      }
    }
  }
  wait_pending<0>();
}

// Write what gram() accumulated: the warp tiles' entries of the lower
// triangle to So [r, r] at (i, j) and (j, i); part 0 writes b to bo [r]
// and, when co is not null, the count to *co.
__device__ __forceinline__ void store(const Acc& acc, int r, int part,
                                      float* __restrict__ So,
                                      float* __restrict__ bo,
                                      float* __restrict__ co) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  if (acc.math) {
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 32 * acc.ti + 16 * mm + gid + 8 * (q >> 1);
          const int j = 32 * acc.tj + 8 * n + 2 * tig + (q & 1);
          if (i < r && j <= i) {
            So[i * r + j] = acc.s[mm][n][q];
            So[j * r + i] = acc.s[mm][n][q];
          }
        }
  }
  if (part == 0) {
    if (threadIdx.x < r) bo[threadIdx.x] = acc.b;
    if (threadIdx.x == 0 && co != nullptr) *co = acc.cnt;
  }
}

// out[row, e] = Σ_k part[row, k, e] for k = 0 .. nchunk-1 in order: the
// width chunks' partials summed deterministically, without atomics.
// Grid (rows, ceil(E / blockDim.x)).
__global__ void sum_chunks(const float* __restrict__ part,
                           float* __restrict__ out, long long E,
                           int nchunk) {
  const long long row = blockIdx.x;
  const long long e =
      static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const float* p = part + row * nchunk * E + e;
  float s = 0.f;
  for (int k = 0; k < nchunk; ++k) s += p[k * E];
  out[row * E + e] = s;
}

// launch sum_chunks on `rows` rows of E elements
inline cudaError_t launch_sum(const float* part, float* out, long long rows,
                              long long E, int nchunk, cudaStream_t stream) {
  constexpr int kThreads = 256;
  dim3 grid(static_cast<unsigned>(rows),
            static_cast<unsigned>((E + kThreads - 1) / kThreads));
  sum_chunks<<<grid, kThreads, 0, stream>>>(part, out, E, nchunk);
  return cudaGetLastError();
}

}  // namespace g90
