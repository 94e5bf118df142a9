// What a cluster barrier and a push into peers' shared memory cost on the
// card, the two costs of each block column of K4's and K7's cluster solve
// pass (tpu_als_torch/csrc/chol_cluster.cuh): 32 clusters of C = 2 and 4
// blocks of 512 threads; clock64 cycles of one cluster.sync() (mean of
// 2,000), and of pushing a step-0 panel's 3,456 float4 (55 KB) into each
// peer's shared memory followed by a cluster.sync() (mean of 20).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o /tmp/cluster_probe \
//        scripts/cluster_probe.cu && /tmp/cluster_probe
#include <cooperative_groups.h>
#include <cstdio>
namespace cg = cooperative_groups;
__global__ void __launch_bounds__(512, 1) k(long long* out, int iters) {
  extern __shared__ float4 sm[];
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) cl.sync();
  long long t1 = clock64();
  // push 3 x 55 KB to the peers, as a step-0 panel push does
  const int me = cl.block_rank(), C = cl.num_blocks();
  for (int rep = 0; rep < iters / 100; ++rep) {
    for (int e = threadIdx.x; e < (C - 1) * 3456; e += blockDim.x) {
      const int d = e / 3456, q = e % 3456;
      const int c = d < me ? d : d + 1;
      cl.map_shared_rank(sm, c)[q] = sm[q];
    }
    cl.sync();
  }
  long long t2 = clock64();
  if (threadIdx.x == 0) {
    out[blockIdx.x * 2] = (t1 - t0) / iters;
    out[blockIdx.x * 2 + 1] = (t2 - t1) / (iters / 100);
  }
}
int main() {
  long long* d;
  cudaMalloc(&d, 1 << 20);
  for (int C = 2; C <= 4; C += 2) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 200000);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C * 32); cfg.blockDim = dim3(512); cfg.dynamicSmemBytes = 200000;
    cudaLaunchAttribute a; a.id = cudaLaunchAttributeClusterDimension;
    a.val.clusterDim.x = C; a.val.clusterDim.y = 1; a.val.clusterDim.z = 1;
    cfg.attrs = &a; cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, k, d, 2000);
    cudaDeviceSynchronize();
    long long h[8];
    cudaMemcpy(h, d, sizeof h, cudaMemcpyDeviceToHost);
    printf("C=%d err=%d: cluster.sync %lld cycles; push 3x55KB + sync %lld cycles (block 0), %lld (block 1)\n",
           C, (int)e, h[0], h[1], h[3]);
  }
  return 0;
}
