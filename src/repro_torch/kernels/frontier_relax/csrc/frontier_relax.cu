// BFS frontier expansion mask for one level:
//   mask[e] = (dist[src[e]] == level) && (dist[dst[e]] == INT32_MAX)
//
// Replaces the TPU kernel `_frontier_relax_kernel` / `frontier_relax_pallas`
// in src/repro/kernels/frontier_relax/frontier_relax.py. That kernel holds
// the whole dist table in VMEM, walks the edge list in (8, 128) tiles padded
// with vertex-0 edges, and writes an int32 mask that its wrapper casts to
// bool and slices. Here one thread handles one half-edge and writes a byte
// (a torch.bool), and the grid masks the ragged end, so no pad edge exists.
// The deterministic parent scatter-min stays outside the kernel, as on the
// TPU (core/bfs.py).
//
// Bound on the H100: memory. Per half-edge: two coalesced 4-byte reads
// (src, dst), one random 4-byte gather of dist[src] (a 32-byte sector per
// miss; dist is 4n bytes and stays largely in the 50 MB L2 for n up to a
// few million) and one coalesced 1-byte write. The dist[dst] gather is
// issued only where the source is on the frontier, which on a BFS level is
// a small share of the edges; the dst read itself is coalesced either way.
// `level` comes by value from the host: no device scalar, no extra copy.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void frontier_relax_kernel(const int32_t* __restrict__ src,
                                      const int32_t* __restrict__ dst,
                                      const int32_t* __restrict__ dist,
                                      uint8_t* __restrict__ mask,
                                      int64_t n_edges, int32_t level) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  const int32_t d_src = __ldg(dist + __ldg(src + e));
  const int32_t v = __ldg(dst + e);
  mask[e] = d_src == level && __ldg(dist + v) == INT_MAX;
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// src, dst: int32[n_edges] with entries in [0, n) of dist: int32[n];
// mask: 1-byte bool[n_edges]; all on `device`. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int frontier_relax(const void* src, const void* dst,
                              const void* dist, void* mask, int64_t n_edges,
                              int level, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto blocks = static_cast<unsigned>((n_edges + kThreads - 1) / kThreads);
  frontier_relax_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(dist), static_cast<uint8_t*>(mask), n_edges,
      level);
  return cudaGetLastError();
}
