// Per half-edge hook proposal for connectivity's hooking round.
//   ru = rep[src[e]], rv = rep[dst[e]], lo = min(ru, rv), hi = max(ru, rv)
//   min-hooking: tgt = hi, val = lo;  max-hooking: tgt = lo, val = hi
//   tgt = n_nodes where ru == rv (the edge does not cross components)
//
// Replaces the TPU kernel `_hook_edges_kernel` / `hook_edges_pallas` in
// src/repro/kernels/hook_edges/hook_edges.py (the JAX connectivity loop
// inlines the same computation; the port calls this kernel from it). The
// stage-1 scatter-min/max stays outside the kernel, as on the TPU, as one
// `scatter_reduce_` in core/connectivity.py; min and max do not depend on
// order, so the result is bit-equal to the reference.
//
// Bound on the H100: memory. Per half-edge: two coalesced 4-byte reads
// (src, dst), two random 4-byte gathers from rep (a 32-byte sector per
// miss; rep is 4n bytes and stays largely in the 50 MB L2 for n up to a
// few million) and two coalesced 4-byte writes. One half-edge per thread
// and many blocks in flight keep enough gathers outstanding. No padding:
// the grid masks the ragged end, so the TPU's self-loop pad edges are not
// needed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void hook_edges_kernel(const int32_t* __restrict__ src,
                                  const int32_t* __restrict__ dst,
                                  const int32_t* __restrict__ rep,
                                  int32_t* __restrict__ tgt,
                                  int32_t* __restrict__ val,
                                  int64_t n_edges, int32_t n_nodes,
                                  bool use_min) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  const int32_t ru = __ldg(rep + __ldg(src + e));
  const int32_t rv = __ldg(rep + __ldg(dst + e));
  const int32_t lo = min(ru, rv);
  const int32_t hi = max(ru, rv);
  tgt[e] = ru != rv ? (use_min ? hi : lo) : n_nodes;
  val[e] = use_min ? lo : hi;
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// src, dst, tgt, val: int32[n_edges]; rep: int32[n_nodes]; all on `device`,
// src/dst entries in [0, n_nodes). Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int hook_edges(const void* src, const void* dst, const void* rep,
                          void* tgt, void* val, int64_t n_edges, int n_nodes,
                          int use_min, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto blocks = static_cast<unsigned>((n_edges + kThreads - 1) / kThreads);
  hook_edges_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(rep), static_cast<int32_t*>(tgt),
      static_cast<int32_t*>(val), n_edges, n_nodes, use_min != 0);
  return cudaGetLastError();
}
