// What the gathered Gram kernels share: the table's element types and
// the entry source of one padded CSR row.
//
// Used by gram_sm90.cuh (the tensor-core Gram of kernels K3, K4 and K7),
// by K3 (gather_gram.cu) and K4 (gather_solve.cu), whose rows are the
// entries of one padded CSR row, and by the tail of K4 and K7
// (gather_solve.cuh), which rounds the ridge in the weight type.  K7
// (gather_solve_ring.cu) has an entry source of its own whose entries
// walk S shards.  The table is f32 or bf16; everything accumulates in
// f32.

#pragma once

#include <cuda_bf16.h>

namespace gram {

// gram_sm90.cuh's largest rank; above it gram_strips.cuh's body
constexpr int kRankLimit = 256;
// K3's largest rank: S's entries indexed by int (r·r < 2^31)
constexpr int kGramRankLimit = 46340;
// K4's and K7's largest rank, the reference's fused solve's: its row
// tile's cap 2^17 / (32·r_pad) falls below 8 rows above r_pad = 512
// (TileBudgetError)
constexpr int kSolveRankLimit = 512;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an f32 value to the table's type, back in f32
template <typename T> __device__ __forceinline__ float round_w(float v);
template <> __device__ __forceinline__ float round_w<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_w<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The entries of one padded CSR row of a table V [N, r]: entry `pos`
// gathers V[cols[pos]] with weights aw/bw/cw[pos] (cw may be null: no
// count).  An entry source gives the Gram, per entry, a row handle and
// its weights (load) and, per handle, the row (row).
template <typename T>
struct RowEntries {
  const T* __restrict__ V;
  const int* __restrict__ cols;  // the row's first entry
  const T* __restrict__ aw;
  const T* __restrict__ bw;
  const T* __restrict__ cw;
  int r;
  __device__ __forceinline__ void load(long long pos, int& h, float& a,
                                       float& b, float& c) const {
    h = cols[pos];
    a = to_f(aw[pos]);
    b = to_f(bw[pos]);
    c = cw != nullptr ? to_f(cw[pos]) : 0.f;
  }
  __device__ __forceinline__ const T* row(int h) const {
    return V + static_cast<size_t>(h) * r;
  }
};

}  // namespace gram
