// Four entries over a whole int32 parent table:
//   pointer_jump_double:          k doubling steps `t = t[t]` in one
//                                 cooperative launch, with the convergence
//                                 flag `any(out != table)` fused in;
//   pointer_jump_double_stepwise: the same k steps as k launches (the
//                                 previous design, kept as a yardstick);
//   pointer_jump_chain:           `n_jumps + 1` hops against one fixed
//                                 table, out[i] = p^(n_jumps+1)(i), composed
//                                 from squarings in one cooperative launch;
//   pointer_jump_chain_previous:  the same hops, one thread an element
//                                 following the table (the previous design,
//                                 kept as a yardstick).
//
// pointer_jump_double replaces the TPU kernel `_pointer_jump_double_kernel` /
// `pointer_jump_double_pallas` in src/repro/kernels/pointer_jump/pointer_jump.py.
// That kernel holds the whole table in VMEM and runs the k steps in one
// grid=1 launch. Each step reads the previous step's whole table, so on the
// H100 the steps need a grid-wide barrier. The engine's sync count also
// needs every step to compute exactly `t = t[t]` on the previous table (an
// in-place racy update would converge in fewer checks and break the count).
//
// Bound on the H100: memory. A call must read the table once and write the
// result once (8n bytes); each step is a coalesced 4-byte read, a random
// 4-byte gather (a 32-byte sector per miss) and a coalesced 4-byte write.
// With one launch per step (the stepwise design) every step paid a launch,
// and the convergence check was a further pass over both tables. Here:
//   * one cooperative launch runs all k steps, a `grid.sync()` between
//     them; the grid is at most the co-resident block count, so the launch
//     cannot deadlock, and a larger grid is refused by the runtime;
//   * the table ping-pongs between `out` and `scratch`, the last step lands
//     in `out` and the input is never written, so each step is exactly the
//     doubling step of the reference;
//   * blocks of 1024 threads, two to an SM at 32 registers: the barrier's
//     cost grows with the number of blocks that arrive at it;
//   * each thread owns a grid-stride set of entries and keeps kUnroll
//     independent gathers in flight, so the co-resident grid has as many
//     loads outstanding as a grid of one thread per entry;
//   * the last step compares each result with the input entry; a warp vote
//     and one atomicOr per warp set the flag, which replaces the separate
//     `any(q2 != q)` pass.
// Coherence: a buffer written in step j is read in step j + 1. `__ldg`
// reads through the non-coherent path, which is correct only for data no
// thread writes during the launch, so only the input table uses it. Reads
// of `out` and `scratch` are plain loads: `grid.sync()` orders every write
// before it with every read after it across the grid (a release at the
// arrival, an acquire at the wait, which also invalidates the SM's L1),
// and as a compiler barrier it keeps the loads after it. `ld.global.cg`
// (L2 only) is also correct, but its random gathers were slower than
// L1-cached loads at L2-resident sizes (PERF.md, Findings).
// Indices are 32-bit: an int32 table has n <= 2^31 entries.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCoopThreads = 1024;
constexpr int kUnroll = 4;
// The chain kernels' elements in flight a thread: their passes stream
// faster at 2 than at 4 or 8, and their gathers are no slower (PERF.md).
constexpr int kChainUnroll = 2;
constexpr int kMaxDevices = 64;
constexpr int kMaxPasses = 32;
constexpr int kMaxTerms = 128;

// The pass plan of a pointer_jump_chain launch, passed by value. Pass p
// maps entry i through the tables term[end[p-1] .. end[p]) (end[-1] = 0):
// the first is read at i, each further one gathered at the entry reached.
// Table 0 is the input, table j >= 1 the one pass j wrote.
struct ChainSchedule {
  int passes;
  uint8_t end[kMaxPasses];
  uint8_t term[kMaxTerms];
};

// Parses the host plan `spec` of `len` ints, each pass as its term count
// followed by its tables (repro_torch/kernels/hops.py::hop_schedule).
// False if it is empty, too long, or a pass reads a table not yet written.
bool parse_schedule(const int32_t* spec, int len, ChainSchedule* s) {
  s->passes = 0;
  int terms = 0;
  for (int i = 0; i < len;) {
    const int count = spec[i++];
    if (count < 1 || s->passes == kMaxPasses || terms + count > kMaxTerms ||
        i + count > len)
      return false;
    for (int t = 0; t < count; ++t) {
      const int tab = spec[i++];
      if (tab < 0 || tab > s->passes) return false;
      s->term[terms++] = static_cast<uint8_t>(tab);
    }
    s->end[s->passes++] = static_cast<uint8_t>(terms);
  }
  return s->passes > 0;
}

// The co-resident block count of the cooperative `kernel` at kCoopThreads
// threads a block on `device` (cached in resident[device]), or fewer when
// n needs fewer blocks of one entry per thread.
template <typename Kernel>
cudaError_t coop_blocks(Kernel kernel, int* resident, int device, int64_t n,
                        int* blocks) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kCoopThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    resident[device] = per_sm * sms;
  }
  const int64_t need = (n + kCoopThreads - 1) / kCoopThreads;
  *blocks = static_cast<int>(need < resident[device] ? need : resident[device]);
  return cudaSuccess;
}

template <bool kFromInput>
__device__ __forceinline__ int32_t load_tab(const int32_t* p) {
  return kFromInput ? __ldg(p) : *p;
}

// One doubling step over this thread's entries, src -> dst. In the last
// step (kLast) it also returns whether any of its results differs from the
// call's input `table`.
template <bool kFromInput, bool kLast>
__device__ __forceinline__ bool double_step(const int32_t* src, int32_t* dst,
                                            const int32_t* __restrict__ table,
                                            uint32_t n) {
  const uint32_t stride = gridDim.x * blockDim.x;
  bool changed = false;
  for (uint32_t base = blockIdx.x * blockDim.x + threadIdx.x; base < n;
       base += stride * kUnroll) {
    int32_t hop[kUnroll], orig[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = base + u * stride;
      hop[u] = i < n ? load_tab<kFromInput>(src + i) : 0;
      if (kLast) orig[u] = i < n ? __ldg(table + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * stride < n) hop[u] = load_tab<kFromInput>(src + hop[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = base + u * stride;
      if (i < n) {
        dst[i] = hop[u];
        if (kLast) changed |= hop[u] != orig[u];
      }
    }
  }
  return changed;
}

__global__ void __launch_bounds__(kCoopThreads)
pointer_jump_double_coop(const int32_t* __restrict__ table, int32_t* out,
                         int32_t* scratch, uint32_t n, int n_jumps,
                         int32_t* changed) {
  cg::grid_group grid = cg::this_grid();
  const int32_t* src = table;
  bool diff = false;
  for (int j = 0; j < n_jumps; ++j) {
    // The last step always lands in `out`.
    int32_t* dst = ((n_jumps - 1 - j) % 2 == 0) ? out : scratch;
    const bool last = j == n_jumps - 1;
    if (j == 0) {
      diff = last ? double_step<true, true>(src, dst, table, n)
                  : double_step<true, false>(src, dst, table, n);
    } else {
      diff = last ? double_step<false, true>(src, dst, table, n)
                  : double_step<false, false>(src, dst, table, n);
    }
    if (!last) grid.sync();
    src = dst;
  }
  if (__ballot_sync(0xffffffffu, diff) != 0 && (threadIdx.x & 31) == 0)
    atomicOr(changed, 1);
}

__global__ void pointer_jump_double_step(const int32_t* __restrict__ in,
                                         int32_t* __restrict__ out,
                                         int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __ldg(in + __ldg(in + i));
}

// Entry x of table `tab`: the input through the read-only path, a table
// written earlier in the launch with a plain load.
__device__ __forceinline__ int32_t chain_entry(
    const int32_t* __restrict__ table, const int32_t* scratch, uint32_t n,
    int tab, uint32_t x) {
  return tab == 0 ? __ldg(table + x)
                  : scratch[static_cast<size_t>(tab - 1) * n + x];
}

// Pass p writes table p + 1 (scratch slot p), the last pass `out`.
__global__ void __launch_bounds__(kCoopThreads)
pointer_jump_chain_coop(const int32_t* __restrict__ table, int32_t* out,
                        int32_t* scratch, uint32_t n, ChainSchedule s) {
  cg::grid_group grid = cg::this_grid();
  const uint32_t stride = gridDim.x * blockDim.x;
  int first = 0;
  for (int p = 0; p < s.passes; ++p) {
    const int end = s.end[p];
    int32_t* dst = p == s.passes - 1 ? out : scratch + static_cast<size_t>(p) * n;
    for (uint32_t base = blockIdx.x * blockDim.x + threadIdx.x; base < n;
         base += stride * kChainUnroll) {
      int32_t idx[kChainUnroll];
      const int head = s.term[first];
#pragma unroll
      for (int u = 0; u < kChainUnroll; ++u) {
        const uint32_t i = base + u * stride;
        idx[u] = i < n ? chain_entry(table, scratch, n, head, i) : 0;
      }
      for (int t = first + 1; t < end; ++t) {
        const int tab = s.term[t];
#pragma unroll
        for (int u = 0; u < kChainUnroll; ++u) {
          if (base + u * stride < n)
            idx[u] = chain_entry(table, scratch, n, tab, idx[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kChainUnroll; ++u) {
        const uint32_t i = base + u * stride;
        if (i < n) dst[i] = idx[u];
      }
    }
    first = end;
    if (p + 1 < s.passes) grid.sync();
  }
}

__global__ void pointer_jump_chain_previous_kernel(
    const int32_t* __restrict__ p, int32_t* __restrict__ out, int64_t n,
    int n_jumps) {
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

// The grid of a pointer_jump_double launch over n entries: the co-resident
// block count of the cooperative kernel (blocks per SM at kCoopThreads
// threads times the SM count, computed once per device), or fewer when n
// needs fewer blocks of one entry per thread. Writes it to *blocks; returns a
// CUDA error code (0 on success).
extern "C" int pointer_jump_double_blocks(int device, int64_t n, int* blocks) {
  static int resident[kMaxDevices];
  return coop_blocks(pointer_jump_double_coop, resident, device, n, blocks);
}

// table, out, scratch: int32[n] on `device`, 1 <= n <= 2^31, n_jumps >= 1;
// out and scratch distinct from table and from each other (scratch is
// unused when n_jumps == 1). changed: one int32 on `device`, zeroed here on `stream`,
// then set to 1 if out differs from table anywhere. blocks: the grid,
// 0 for pointer_jump_double_blocks'; a grid larger than the co-resident
// count is refused (cudaErrorCooperativeLaunchTooLarge). One cooperative
// launch. Returns the first CUDA error (0 on success).
extern "C" int pointer_jump_double(const void* table, void* out, void* scratch,
                                   void* changed, int64_t n, int n_jumps,
                                   int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(changed, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return err;
  const int32_t* table_arg = static_cast<const int32_t*>(table);
  int32_t* out_arg = static_cast<int32_t*>(out);
  int32_t* scratch_arg = static_cast<int32_t*>(scratch);
  int32_t* changed_arg = static_cast<int32_t*>(changed);
  uint32_t n_arg = static_cast<uint32_t>(n);
  void* args[] = {&table_arg, &out_arg, &scratch_arg, &n_arg, &n_jumps,
                  &changed_arg};
  if (blocks <= 0) {
    err = static_cast<cudaError_t>(pointer_jump_double_blocks(device, n, &blocks));
    if (err != cudaSuccess) return err;
  }
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pointer_jump_double_coop), dim3(blocks),
      dim3(kCoopThreads), args, 0, s);
  // Clear the runtime's last error, so that a refused launch is reported
  // here and not again by the next call that reads it.
  cudaGetLastError();
  return err;
}

// The previous design, kept only as a yardstick for the cooperative one:
// each step its own launch, one thread per entry, both reads through
// `__ldg` (correct because a launch never reads what it writes). Same
// buffer contract as pointer_jump_double, no flag. Returns
// cudaGetLastError() after the last launch (0 on success).
extern "C" int pointer_jump_double_stepwise(const void* table, void* out,
                                            void* scratch, int64_t n,
                                            int n_jumps, int device,
                                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const int32_t* src = static_cast<const int32_t*>(table);
  for (int j = 0; j < n_jumps; ++j) {
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
// per thread", out[i] = p^(n_jumps+1)(i) against the fixed table p. Each
// block there reads its tile and the whole VMEM-resident table.
//
// Bound on the H100: memory, 8n bytes (p read once, out written once), but
// no design reaches it: each hop is a random 4-byte gather, one 32-byte
// sector, and a 2^24 table (64 MB) does not fit in the 50 MB L2. So the
// cost is the number of random gathers an element makes. The previous
// design, one thread an element following `idx = p[idx]`, makes n_jumps of
// them, dependent ones. Here the hops are composed from squarings (powers
// of one map commute, and composing integer maps is exact):
//   * the plan comes from the host (hops.py::hop_schedule): passes over the
//     whole table, each writing one table; a pass reads its first table at
//     i and gathers once from each further one, so k + 1 hops cost 3
//     gathers at k = 5 (p^2 = p[p], then p^6 = p^2[p^2[p^2]]) and 5 at
//     k = 31 (five squarings), where the chain paid k;
//   * one cooperative launch runs the passes, a `grid.sync()` between them,
//     on at most the co-resident grid (a larger one is refused), as
//     pointer_jump_double does; each thread owns a grid-stride set of
//     entries with kChainUnroll independent gathers in flight;
//   * a pass's table goes to its own slot of `scratch`, the last pass's to
//     `out`; the input is never written. n_jumps <= 0 is one pass that
//     copies the input.
// Coherence: as pointer_jump_double, only the input is read with `__ldg`;
// the scratch tables, written in earlier passes, with plain loads after
// `grid.sync()`.
//
// The grid of a pointer_jump_chain launch over n entries, as
// pointer_jump_double_blocks gives it for its own kernel.
extern "C" int pointer_jump_chain_blocks(int device, int64_t n, int* blocks) {
  static int resident[kMaxDevices];
  return coop_blocks(pointer_jump_chain_coop, resident, device, n, blocks);
}

// table, out: distinct int32[n] on `device`, 1 <= n <= 2^31, entries of
// table in [0, n). schedule: host int32[schedule_len], the plan (see
// parse_schedule); an invalid one returns cudaErrorInvalidValue. scratch:
// int32[(passes - 1) * n] on `device`, distinct from both (unused with one
// pass). blocks: the grid, 0 for pointer_jump_chain_blocks'. One
// cooperative launch. Returns the first CUDA error (0 on success).
extern "C" int pointer_jump_chain(const void* table, void* out, void* scratch,
                                  const void* schedule, int schedule_len,
                                  int64_t n, int blocks, int device,
                                  void* stream) {
  ChainSchedule plan;
  if (!parse_schedule(static_cast<const int32_t*>(schedule), schedule_len,
                      &plan))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int32_t* table_arg = static_cast<const int32_t*>(table);
  int32_t* out_arg = static_cast<int32_t*>(out);
  int32_t* scratch_arg = static_cast<int32_t*>(scratch);
  uint32_t n_arg = static_cast<uint32_t>(n);
  void* args[] = {&table_arg, &out_arg, &scratch_arg, &n_arg, &plan};
  if (blocks <= 0) {
    err = static_cast<cudaError_t>(pointer_jump_chain_blocks(device, n, &blocks));
    if (err != cudaSuccess) return err;
  }
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pointer_jump_chain_coop), dim3(blocks),
      dim3(kCoopThreads), args, 0, static_cast<cudaStream_t>(stream));
  // Clear the runtime's last error, so that a refused launch is reported
  // here and not again by the next call that reads it.
  cudaGetLastError();
  return err;
}

// The previous design of pointer_jump_chain, kept only as a yardstick: one
// launch with no barrier, one thread an element following `idx = p[idx]`
// n_jumps times from idx = p[i] (n_jumps dependent random gathers; the
// table is never written, so every read uses `__ldg`).
//
// table, out: distinct int32[n] on `device`, entries of table in [0, n).
// One launch. Returns cudaGetLastError() after it (0 on success).
extern "C" int pointer_jump_chain_previous(const void* table, void* out,
                                           int64_t n, int n_jumps, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  pointer_jump_chain_previous_kernel<<<blocks, kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out), n, n_jumps);
  return cudaGetLastError();
}
