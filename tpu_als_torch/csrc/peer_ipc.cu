// Device buffers shared between the processes of one group on one card:
// the transport of kernels K7 and K8 across processes (host code, no
// kernel).
//
// Replaces no TPU kernel.  On the TPU, K7 (pallas_gather_ne.py::
// gather_solve_ring) and K8 (pallas_topk.py::topk_merge_ring) move the
// factor shards and the candidate sets between chips by remote DMA from
// inside the kernel.  Here every process of a multi-process mesh holds
// its shards (or its candidate sets) in one buffer allocated by
// peer_alloc, exports it once (peer_export: a cudaIpcMemHandle_t of 64
// bytes, exchanged over the group's gloo transport), and maps its peers'
// buffers into its own address space (peer_open).  The kernels then read
// a peer's rows through that mapping, as they read their own: no byte
// goes through host memory.  NCCL refuses two ranks on one card; legacy
// CUDA IPC does not.
//
// The buffer is cudaMalloc'd here, outside PyTorch's caching allocator:
// a handle names the base of an allocation, so the mapped pointer is the
// buffer itself (no offset into a larger cached block), and the
// allocator's expandable segments (which legacy IPC cannot export) never
// hold it.  The order at teardown is the caller's: every peer closes its
// mapping (peer_close) before the exporter frees the buffer (peer_free).
//
// Every entry returns the cudaError_t of its call (0: success).

#include <cuda_runtime.h>
#include <string.h>

extern "C" int peer_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

extern "C" int peer_alloc(long long bytes, void** out) {
  *out = nullptr;
  if (bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMalloc(out, static_cast<size_t>(bytes)));
}

extern "C" int peer_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

// handle: sizeof(cudaIpcMemHandle_t) bytes, written
extern "C" int peer_export(void* ptr, unsigned char* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return static_cast<int>(e);
}

// A peer's buffer mapped into this process; never this process's own
// handle (CUDA refuses it)
extern "C" int peer_open(const unsigned char* handle, void** out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  *out = nullptr;
  return static_cast<int>(
      cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int peer_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}
