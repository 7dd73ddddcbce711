// k Wyllie list-ranking doubling steps on (succ, dist), -1 ends a list:
//   has  = succ[i] != -1
//   dist = dist[i] + (has ? dist[succ[i]] : 0)
//   succ = has ? succ[succ[i]] : -1
//
// Replaces the TPU kernel `_list_rank_double_kernel` /
// `list_rank_double_pallas` in src/repro/kernels/list_rank/list_rank.py.
// That kernel holds both tables in VMEM and runs the k steps in one grid=1
// launch. Every step reads both tables as the previous step left them, and
// blocks on the H100 run in no order, so each step is its own launch on
// one stream, ping-ponging both tables between the output and scratch
// pair; the inputs are never written. k launches per call keep the
// engine's sync count exact.
//
// Bound on the H100: memory. Per element: two coalesced 4-byte reads, two
// random 4-byte gathers from the same index (two 32-byte sectors per miss)
// and two coalesced 4-byte writes. One element per thread and many blocks
// in flight keep enough gathers outstanding; list ends (succ == -1) issue
// no gather. No padding: the grid masks the ragged end, so the TPU's
// (8, 128) tile and its inert pad slots are not needed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kNoSucc = -1;

__global__ void list_rank_double_step(const int32_t* __restrict__ succ_in,
                                      const int32_t* __restrict__ dist_in,
                                      int32_t* __restrict__ succ_out,
                                      int32_t* __restrict__ dist_out,
                                      int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t s = __ldg(succ_in + i);
  int32_t d = __ldg(dist_in + i);
  if (s != kNoSucc) {
    d += __ldg(dist_in + s);
    s = __ldg(succ_in + s);
  }
  succ_out[i] = s;
  dist_out[i] = d;
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All six buffers int32[n] on `device` and pairwise distinct (the scratch
// pair is unused when n_steps == 1). Returns cudaGetLastError() after the
// last launch (0 on success).
extern "C" int list_rank_double(const void* succ, const void* dist,
                                void* succ_out, void* dist_out,
                                void* succ_scratch, void* dist_scratch,
                                int64_t n, int n_steps, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const int32_t* s_in = static_cast<const int32_t*>(succ);
  const int32_t* d_in = static_cast<const int32_t*>(dist);
  for (int j = 0; j < n_steps; ++j) {
    // The last step always lands in the output pair.
    const bool to_out = (n_steps - 1 - j) % 2 == 0;
    int32_t* s_dst = static_cast<int32_t*>(to_out ? succ_out : succ_scratch);
    int32_t* d_dst = static_cast<int32_t*>(to_out ? dist_out : dist_scratch);
    list_rank_double_step<<<blocks, kThreads, 0, s>>>(s_in, d_in, s_dst, d_dst, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    s_in = s_dst;
    d_in = d_dst;
  }
  return cudaSuccess;
}
