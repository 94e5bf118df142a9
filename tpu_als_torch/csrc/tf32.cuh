// What the tensor-core bodies share: the cp.async group primitives and
// the 3xTF32 form of an f32 product (the split of an operand into two
// TF32 values, and one m16n8k8 TF32 product with f32 accumulation).
// Used by gram_sm90.cuh (kernels K3, K4, K7) and topk.cuh (K5, K8).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// x = big + small, both TF32: big is x rounded to TF32's 10 mantissa bits
// (to nearest, ties away from zero, by integer add and mask: the
// conversion instruction runs at a quarter of the rate), small = x - big
// (exact in f32) with its low 13 bits cleared, so |x - big - small| <
// 2^-21 |x|.  Finite x only (|x| near FLT_MAX would round to infinity).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// d += a · b, one m16n8k8 TF32 product, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace tc
