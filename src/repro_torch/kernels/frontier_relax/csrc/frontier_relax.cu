// Two entries for the edge-centric BFS:
//   frontier_relax: the expansion mask of one level,
//     mask[e] = (dist[src[e]] == level) && (dist[dst[e]] == INT32_MAX);
//   bfs_level: the whole level, the parent scatter-min fused in.
//
// frontier_relax replaces the TPU kernel `_frontier_relax_kernel` /
// `frontier_relax_pallas` in src/repro/kernels/frontier_relax/frontier_relax.py.
// That kernel holds the whole dist table in VMEM, walks the edge list in
// (8, 128) tiles padded with vertex-0 edges, and writes an int32 mask that its
// wrapper casts to bool and slices. Here one thread handles one half-edge and
// writes a byte (a torch.bool), and the grid masks the ragged end, so no pad
// edge exists.
//
// Bound on the H100: memory. Per half-edge: two coalesced 4-byte reads
// (src, dst), one random 4-byte gather of dist[src] (a 32-byte sector per
// miss; dist is 4n bytes and stays largely in the 50 MB L2 for n up to a
// few million) and one coalesced 1-byte write. The dist[dst] gather is
// issued only where the source is on the frontier, which on a BFS level is
// a small share of the edges; the dst read itself is coalesced either way.
// `level` comes by value from the host: no device scalar, no extra copy.
//
// bfs_level does what the TPU path leaves to XLA around that kernel (the
// mask, a scatter-min of the proposals, the parent and dist updates and the
// "anything discovered" reduction) in two launches and no temporary:
//   * edge pass: for every half-edge with dist[src] == level and
//     dist[dst] == INT32_MAX, atomicMin(&cand[dst], src). No thread writes
//     dist during the pass, and min does not depend on the order of the
//     atomics, so each vertex gets the smallest proposing source: the
//     reference's scatter-min, bit for bit. cand[dst] is read first and the
//     atomic skipped when it is already <= src, since a power-law hub can be
//     the destination of ~10^5 proposals in one level. dst is loaded only
//     for the threads whose source is on the frontier: inactive threads of a
//     warp fetch no sector of it, so on a high-diameter graph a level reads
//     src and the dist gathers and little else of the edges;
//   * vertex pass: every v with dist[v] == INT32_MAX and cand[v] != INT32_MAX
//     gets dist = level + 1 and parent = cand[v]; a warp that discovers any
//     vertex stores level + 1 into the flag word. The host reads that word
//     once a level, the same round trip as the reference's while_loop.
// cand (int32[n], INT32_MAX at the start of a BFS) is kept across levels: a
// vertex receives proposals only in the level that discovers it, because
// from then on its dist is no longer INT32_MAX, so no reset is needed. The
// flag needs no reset either: it holds the last level + 1 that discovered
// anything. The launch boundary between the passes is the grid-wide barrier
// (one cooperative launch with a grid.sync() there instead was slower on
// grid2d(4096) and faster on rmat(20, 16): PERF.md, PR 16).
// Bound: memory, src and dst read once (8E bytes) and dist, cand and the
// vertex pass (12n bytes), less where a pass reads only what the data needs.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEdgesPerThread = 4;
constexpr int kVerticesPerThread = 4;

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

// kEdgesPerThread half-edges a thread, a block's worth apart, so that each
// load instruction of a warp is coalesced and a thread has that many
// gathers in flight.
__global__ void bfs_edge_pass(const int32_t* __restrict__ src,
                              const int32_t* __restrict__ dst,
                              const int32_t* __restrict__ dist,
                              int32_t* cand, int64_t n_edges, int32_t level) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * blockDim.x * kEdgesPerThread +
      threadIdx.x;
  int32_t s[kEdgesPerThread];
  bool on[kEdgesPerThread];
#pragma unroll
  for (int u = 0; u < kEdgesPerThread; ++u) {
    const int64_t e = base + u * blockDim.x;
    s[u] = e < n_edges ? __ldg(src + e) : -1;
  }
#pragma unroll
  for (int u = 0; u < kEdgesPerThread; ++u)
    on[u] = s[u] >= 0 && __ldg(dist + s[u]) == level;
#pragma unroll
  for (int u = 0; u < kEdgesPerThread; ++u) {
    if (!on[u]) continue;
    const int32_t v = __ldg(dst + base + u * blockDim.x);
    // cand is written by this launch's atomics: a plain load. A stale value
    // is never below the current one (values only fall), so the skip stays
    // right.
    if (__ldg(dist + v) == INT_MAX && cand[v] > s[u]) atomicMin(cand + v, s[u]);
  }
}

// kVerticesPerThread vertices a thread, a block's worth apart, so that a
// thread has that many loads in flight; cand is read only where dist is
// INT32_MAX.
__global__ void bfs_vertex_pass(int32_t* __restrict__ dist,
                                int32_t* __restrict__ parent,
                                const int32_t* __restrict__ cand,
                                int32_t* __restrict__ flag, int32_t n,
                                int32_t level) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * blockDim.x * kVerticesPerThread +
      threadIdx.x;
  int32_t c[kVerticesPerThread];
#pragma unroll
  for (int u = 0; u < kVerticesPerThread; ++u) {
    const int64_t v = base + u * blockDim.x;
    c[u] = v < n && dist[v] == INT_MAX ? cand[v] : INT_MAX;
  }
  bool found = false;
#pragma unroll
  for (int u = 0; u < kVerticesPerThread; ++u) {
    if (c[u] == INT_MAX) continue;
    const int64_t v = base + u * blockDim.x;
    dist[v] = level + 1;
    parent[v] = c[u];
    found = true;
  }
  if (__ballot_sync(0xffffffffu, found) != 0 && (threadIdx.x & 31) == 0)
    *flag = level + 1;
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

// One BFS level in place. src, dst: int32[n_edges] with entries in [0, n);
// dist, parent: int32[n]; cand: int32[n + 1], slots [0, n) INT32_MAX at the
// BFS's start and kept across its levels, slot n the flag word (level + 1
// after a level that discovered a vertex); all on `device`, 1 <= n < 2^31.
// Two launches on `stream` (the edge pass only when n_edges > 0). Returns
// the first CUDA error (0 on success).
extern "C" int bfs_level(const void* src, const void* dst, void* dist,
                         void* parent, void* cand, int64_t n_edges, int n,
                         int level, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* dist_arg = static_cast<int32_t*>(dist);
  auto* cand_arg = static_cast<int32_t*>(cand);
  if (n_edges > 0) {
    const int64_t per_block = int64_t{kThreads} * kEdgesPerThread;
    const auto blocks = static_cast<unsigned>((n_edges + per_block - 1) / per_block);
    bfs_edge_pass<<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
        dist_arg, cand_arg, n_edges, level);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t per_block = int64_t{kThreads} * kVerticesPerThread;
  const auto blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  bfs_vertex_pass<<<blocks, kThreads, 0, s>>>(
      dist_arg, static_cast<int32_t*>(parent), cand_arg, cand_arg + n, n,
      level);
  return cudaGetLastError();
}

