// k pointer-doubling steps `t = t[t]` over a whole int32 parent table.
//
// Replaces the TPU kernel `_pointer_jump_double_kernel` /
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
