// Two entries over a whole int32 parent table:
//   pointer_jump_double: k doubling steps `t = t[t]`;
//   pointer_jump_chain:  `n_jumps + 1` hops against one fixed table,
//                        out[i] = p^(n_jumps+1)(i).
//
// pointer_jump_double replaces the TPU kernel `_pointer_jump_double_kernel` /
// `pointer_jump_double_pallas` in src/repro/kernels/pointer_jump/pointer_jump.py.
// That kernel holds the whole table in VMEM and runs the k steps in one
// grid=1 launch. On the H100 blocks run in no order, so a step that reads
// the previous step's whole table needs a grid-wide barrier: here each
// step is its own launch on one stream, ping-ponging between `out` and
// `scratch`, and the input table is never written. k launches per call
// keep the engine's sync count exact (an in-place racy update would also
// converge, in fewer checks, and so break the count).
//
// Bound on the H100: memory. Each element is one coalesced 4-byte read,
// one random 4-byte gather (a 32-byte sector per miss) and one coalesced
// 4-byte write; there is no arithmetic to speak of. The design keeps one
// element per thread and many blocks in flight so that enough independent
// gathers are outstanding to cover device-memory latency; `__ldg` routes
// both reads through the read-only path. No padding: the grid masks the
// ragged end, so the TPU's (8, 128) tile rule is not needed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void pointer_jump_double_step(const int32_t* __restrict__ in,
                                         int32_t* __restrict__ out,
                                         int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __ldg(in + __ldg(in + i));
}

__global__ void pointer_jump_chain_kernel(const int32_t* __restrict__ p,
                                          int32_t* __restrict__ out,
                                          int64_t n, int n_jumps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t idx = __ldg(p + i);
  for (int j = 0; j < n_jumps; ++j) idx = __ldg(p + idx);
  out[i] = idx;
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table, out, scratch: int32[n] on `device`; out and scratch distinct from
// table and from each other (scratch is unused when n_jumps == 1).
// Returns cudaGetLastError() after the last launch (0 on success).
extern "C" int pointer_jump_double(const void* table, void* out, void* scratch,
                                   int64_t n, int n_jumps, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const int32_t* src = static_cast<const int32_t*>(table);
  for (int j = 0; j < n_jumps; ++j) {
    // The last step always lands in `out`.
    int32_t* dst = static_cast<int32_t*>(((n_jumps - 1 - j) % 2 == 0) ? out : scratch);
    pointer_jump_double_step<<<blocks, kThreads, 0, s>>>(src, dst, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

// pointer_jump_chain replaces the TPU kernel `_pointer_jump_kernel` /
// `pointer_jump_pallas` in the same file: the paper's literal "several jumps
// per thread". Each block there reads its tile and the whole VMEM-resident
// table; here one launch runs one thread per element, each following
// `idx = p[idx]` n_jumps times from idx = p[i]. The table is never written,
// so no step waits for another and no grid-wide barrier is needed. Bound:
// memory, 8n bytes (p read once, out written once); each hop is a dependent
// random 4-byte gather, so the kernel is latency-bound in practice, and one
// element per thread with many blocks in flight keeps gathers outstanding.
//
// table, out: distinct int32[n] on `device`, entries of table in [0, n).
// One launch. Returns cudaGetLastError() after it (0 on success).
extern "C" int pointer_jump_chain(const void* table, void* out, int64_t n,
                                  int n_jumps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  pointer_jump_chain_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out), n, n_jumps);
  return cudaGetLastError();
}
