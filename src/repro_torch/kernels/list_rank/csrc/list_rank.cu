// Four entries on (succ, dist), -1 ends a list:
//   list_rank_double:          k Wyllie doubling steps, each on the previous
//                              step's tables, in one cooperative launch,
//                              with the flag `any(succ_out != -1)` fused in;
//   list_rank_double_stepwise: the same k steps as k launches (the previous
//                              design, kept as a yardstick);
//   list_rank_chain:           k steps against one snapshot of the input
//                              tables, the (k+1)-hop chain prefix sums
//                              dist'[i] = sum_{j<=k} dist[s^j(i)],
//                              succ'[i] = s^(k+1)(i), composed from
//                              squarings in one cooperative launch;
//   list_rank_chain_previous:  the same, one thread an element taking the
//                              k steps (the previous design, kept as a
//                              yardstick).
// One step:
//   has  = succ[i] != -1
//   dist = dist[i] + (has ? dist[succ[i]] : 0)
//   succ = has ? succ[succ[i]] : -1
//
// list_rank_double replaces the TPU kernel `_list_rank_double_kernel` /
// `list_rank_double_pallas` in src/repro/kernels/list_rank/list_rank.py.
// That kernel holds both tables in VMEM and runs the k steps in one grid=1
// launch. Every step reads both tables as the previous step left them, so
// on the H100 the steps need a grid-wide barrier, and the engine's sync
// count needs each step to be exactly the reference's.
//
// Bound on the H100: memory. A call must read two int32 tables and write
// two (16N bytes). The stepwise design launched once per step, and each
// step did two coalesced reads, two random 4-byte gathers from the same
// index (two 32-byte sectors per miss) and two coalesced writes; the
// "any list open" check was a further pass. Here:
//   * one cooperative launch runs all k steps, a `grid.sync()` between
//     them, on at most the co-resident grid (a larger one is refused), in
//     blocks of 1024 threads, one to an SM at its register count: the
//     barrier's cost grows with the number of blocks;
//   * inside the launch (succ, dist) lives as one 8-byte pair (int2) in a
//     packed ping-pong scratch pair, so a step is one coalesced 8-byte
//     read, one 8-byte gather from one sector, and one 8-byte write; the
//     first step reads the two int32 inputs and the last writes the two
//     int32 outputs, and the inputs are never written;
//   * each thread owns a grid-stride set of entries and keeps kUnroll
//     independent gathers in flight; list ends issue no gather;
//   * the last step ORs `succ_out != -1` into a flag (a warp vote, one
//     atomicOr per warp), which replaces the separate `any` pass.
// Coherence: a packed buffer written in one step is read in the next.
// `__ldg` reads through the non-coherent path, which is correct only for
// data no thread writes during the launch, so only the inputs use it.
// Reads of the scratch pair are plain loads: `grid.sync()` orders every
// write before it with every read after it across the grid (a release at
// the arrival, an acquire at the wait, which also invalidates the SM's
// L1), and as a compiler barrier it keeps the loads after it.
// `ld.global.cg` (L2 only) is also correct, but its random gathers were
// slower than L1-cached loads at L2-resident sizes (PERF.md, Findings).
// Indices are 32-bit: an int32 successor table has N <= 2^31 entries.
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
constexpr int32_t kNoSucc = -1;
constexpr int kMaxPasses = 32;
constexpr int kMaxTerms = 128;

// The pass plan of a list_rank_chain launch, passed by value (the same as
// pointer_jump.cu's; each source builds alone). Pass p maps entry i
// through the tables term[end[p-1] .. end[p]) (end[-1] = 0): the first is
// read at i, each further one gathered at the successor reached. Table 0
// is the input, table j >= 1 the one pass j wrote.
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

// (succ, dist) of entry i, x = succ and y = dist: from the two int32
// inputs (kFromInput), else from the packed pair `src`.
template <bool kFromInput>
__device__ __forceinline__ int2 load_pair(const int32_t* __restrict__ succ,
                                          const int32_t* __restrict__ dist,
                                          const int2* src, uint32_t i) {
  return kFromInput ? make_int2(__ldg(succ + i), __ldg(dist + i)) : src[i];
}

// One Wyllie step over this thread's entries. kFromInput: read the int32
// inputs, else the packed `src`. kToOutput: write the int32 outputs and
// return whether any of this thread's lists is still open, else write the
// packed `dst`.
template <bool kFromInput, bool kToOutput>
__device__ __forceinline__ bool wyllie_step(
    const int32_t* __restrict__ succ, const int32_t* __restrict__ dist,
    const int2* src, int2* dst, int32_t* __restrict__ succ_out,
    int32_t* __restrict__ dist_out, uint32_t n) {
  const uint32_t stride = gridDim.x * blockDim.x;
  bool open = false;
  for (uint32_t base = blockIdx.x * blockDim.x + threadIdx.x; base < n;
       base += stride * kUnroll) {
    int2 e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = base + u * stride;
      e[u] = i < n ? load_pair<kFromInput>(succ, dist, src, i)
                   : make_int2(kNoSucc, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e[u].x != kNoSucc) {
        const int2 next = load_pair<kFromInput>(succ, dist, src, e[u].x);
        e[u] = make_int2(next.x, e[u].y + next.y);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = base + u * stride;
      if (i < n) {
        if (kToOutput) {
          succ_out[i] = e[u].x;
          dist_out[i] = e[u].y;
          open |= e[u].x != kNoSucc;
        } else {
          dst[i] = e[u];
        }
      }
    }
  }
  return open;
}

// Step j reads the inputs (j == 0) or pair[(j - 1) % 2], and writes the
// outputs (the last step) or pair[j % 2].
__global__ void __launch_bounds__(kCoopThreads)
list_rank_double_coop(const int32_t* __restrict__ succ,
                      const int32_t* __restrict__ dist,
                      int32_t* __restrict__ succ_out,
                      int32_t* __restrict__ dist_out, int2* pair_a,
                      int2* pair_b, uint32_t n, int n_steps, int32_t* open) {
  cg::grid_group grid = cg::this_grid();
  bool any_open = false;
  for (int j = 0; j < n_steps; ++j) {
    const int2* src = (j % 2 == 1) ? pair_a : pair_b;
    int2* dst = (j % 2 == 0) ? pair_a : pair_b;
    const bool last = j == n_steps - 1;
    if (j == 0) {
      any_open = last ? wyllie_step<true, true>(succ, dist, src, dst, succ_out,
                                                dist_out, n)
                      : wyllie_step<true, false>(succ, dist, src, dst,
                                                 succ_out, dist_out, n);
    } else {
      any_open = last ? wyllie_step<false, true>(succ, dist, src, dst,
                                                 succ_out, dist_out, n)
                      : wyllie_step<false, false>(succ, dist, src, dst,
                                                  succ_out, dist_out, n);
    }
    if (!last) grid.sync();
  }
  if (__ballot_sync(0xffffffffu, any_open) != 0 && (threadIdx.x & 31) == 0)
    atomicOr(open, 1);
}

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

// Entry x of table `tab` as (succ, dist): the two int32 inputs through the
// read-only path, or a packed table written earlier in the launch with a
// plain load.
__device__ __forceinline__ int2 chain_entry(const int32_t* __restrict__ succ,
                                            const int32_t* __restrict__ dist,
                                            const int2* scratch, uint32_t n,
                                            int tab, uint32_t x) {
  return tab == 0 ? make_int2(__ldg(succ + x), __ldg(dist + x))
                  : scratch[static_cast<size_t>(tab - 1) * n + x];
}

// Pass p writes packed table p + 1 (scratch slot p), the last pass the two
// int32 outputs. A hop from a list's end (-1) issues no gather and adds
// nothing; distances add as uint32, so they wrap as int32 sums do in torch
// and jnp, whatever the grouping.
__global__ void __launch_bounds__(kCoopThreads)
list_rank_chain_coop(const int32_t* __restrict__ succ,
                     const int32_t* __restrict__ dist,
                     int32_t* __restrict__ succ_out,
                     int32_t* __restrict__ dist_out, int2* scratch,
                     uint32_t n, ChainSchedule s) {
  cg::grid_group grid = cg::this_grid();
  const uint32_t stride = gridDim.x * blockDim.x;
  int first = 0;
  for (int p = 0; p < s.passes; ++p) {
    const int end = s.end[p];
    const bool last = p == s.passes - 1;
    int2* dst = last ? nullptr : scratch + static_cast<size_t>(p) * n;
    for (uint32_t base = blockIdx.x * blockDim.x + threadIdx.x; base < n;
         base += stride * kChainUnroll) {
      int2 e[kChainUnroll];
      const int head = s.term[first];
#pragma unroll
      for (int u = 0; u < kChainUnroll; ++u) {
        const uint32_t i = base + u * stride;
        e[u] = i < n ? chain_entry(succ, dist, scratch, n, head, i)
                     : make_int2(kNoSucc, 0);
      }
      for (int t = first + 1; t < end; ++t) {
        const int tab = s.term[t];
#pragma unroll
        for (int u = 0; u < kChainUnroll; ++u) {
          if (e[u].x != kNoSucc) {
            const int2 next = chain_entry(succ, dist, scratch, n, tab, e[u].x);
            e[u] = make_int2(next.x, static_cast<int32_t>(
                static_cast<uint32_t>(e[u].y) + static_cast<uint32_t>(next.y)));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kChainUnroll; ++u) {
        const uint32_t i = base + u * stride;
        if (i < n) {
          if (last) {
            succ_out[i] = e[u].x;
            dist_out[i] = e[u].y;
          } else {
            dst[i] = e[u];
          }
        }
      }
    }
    first = end;
    if (!last) grid.sync();
  }
}

// The previous design of the chain: one thread per element; the tables are
// never written, so the k steps of every element run back to back with no
// barrier.
__global__ void list_rank_chain_previous_kernel(
    const int32_t* __restrict__ succ_tab, const int32_t* __restrict__ dist_tab,
    int32_t* __restrict__ succ_out, int32_t* __restrict__ dist_out, int64_t n,
    int n_steps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t s = __ldg(succ_tab + i);
  int32_t d = __ldg(dist_tab + i);
  for (int j = 0; j < n_steps && s != kNoSucc; ++j) {
    d += __ldg(dist_tab + s);
    s = __ldg(succ_tab + s);
  }
  succ_out[i] = s;
  dist_out[i] = d;
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The grid of a list_rank_double launch over n entries: the co-resident
// block count of the cooperative kernel at kCoopThreads threads a block
// (computed once per device), or fewer when n needs fewer blocks of one
// entry per thread. Writes it to
// *blocks; returns a CUDA error code (0 on success).
extern "C" int list_rank_double_blocks(int device, int64_t n, int* blocks) {
  static int resident[kMaxDevices];
  return coop_blocks(list_rank_double_coop, resident, device, n, blocks);
}

// succ, dist, succ_out, dist_out: int32[n] on `device`, 1 <= n <= 2^31,
// n_steps >= 1, the outputs distinct from the inputs. pair_a, pair_b:
// packed int2[n] scratch (8-byte aligned), distinct; pair_a is used when
// n_steps >= 2, pair_b when n_steps >= 3. open: one int32 on `device`,
// zeroed here on `stream`, then set to 1 if any succ_out entry is not -1.
// blocks: the grid, 0 for list_rank_double_blocks'; a grid larger than
// the co-resident count is refused (cudaErrorCooperativeLaunchTooLarge).
// One cooperative launch. Returns the first CUDA error (0 on success).
extern "C" int list_rank_double(const void* succ, const void* dist,
                                void* succ_out, void* dist_out, void* pair_a,
                                void* pair_b, void* open, int64_t n,
                                int n_steps, int blocks, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(open, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return err;
  const int32_t* succ_arg = static_cast<const int32_t*>(succ);
  const int32_t* dist_arg = static_cast<const int32_t*>(dist);
  int32_t* succ_out_arg = static_cast<int32_t*>(succ_out);
  int32_t* dist_out_arg = static_cast<int32_t*>(dist_out);
  int2* pair_a_arg = static_cast<int2*>(pair_a);
  int2* pair_b_arg = static_cast<int2*>(pair_b);
  int32_t* open_arg = static_cast<int32_t*>(open);
  uint32_t n_arg = static_cast<uint32_t>(n);
  void* args[] = {&succ_arg, &dist_arg, &succ_out_arg, &dist_out_arg,
                  &pair_a_arg, &pair_b_arg, &n_arg, &n_steps, &open_arg};
  if (blocks <= 0) {
    err = static_cast<cudaError_t>(list_rank_double_blocks(device, n, &blocks));
    if (err != cudaSuccess) return err;
  }
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(list_rank_double_coop), dim3(blocks),
      dim3(kCoopThreads), args, 0, s);
  // Clear the runtime's last error, so that a refused launch is reported
  // here and not again by the next call that reads it.
  cudaGetLastError();
  return err;
}

// The previous design, kept only as a yardstick for the cooperative one:
// each step its own launch, one thread per entry, reads through `__ldg`
// (correct because a launch never reads what it writes), both tables
// ping-ponging between the output and an int32 scratch pair. All six
// buffers int32[n] and pairwise distinct (the scratch pair is unused when
// n_steps == 1); no flag. Returns cudaGetLastError() after the last launch
// (0 on success).
extern "C" int list_rank_double_stepwise(const void* succ, const void* dist,
                                         void* succ_out, void* dist_out,
                                         void* succ_scratch,
                                         void* dist_scratch, int64_t n,
                                         int n_steps, int device,
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

// list_rank_chain replaces the TPU kernel `_list_rank_kernel` /
// `list_rank_pallas` in the same file, whose blocks each read their tile and
// both whole VMEM-resident tables. The k steps against one snapshot give
// T^(k+1), where T^(a+b)(e) = T^a(e) if its successor is -1, else
// (S_b[S_a(e)], D_a(e) + D_b[S_a(e)]): powers of one map, which commute.
//
// Bound on the H100: memory, 16n bytes (two tables read once, two written
// once), but no design reaches it: each hop is a random gather, and a 2^24
// list's tables (128 MB) do not fit in the 50 MB L2. So the cost is the
// random sectors an element fetches. The previous design, one thread an
// element taking the k steps, fetched two a step (dist_tab[s] and
// succ_tab[s]) and diverged where lists end. Here:
//   * the plan comes from the host (hops.py::hop_schedule with
//     pack_input), as in pointer_jump_chain: passes over the whole table,
//     each writing one table, a pass reading its first table at i and
//     gathering once from each further one; k + 1 hops cost 3 gathers at
//     k = 5 (T^2, then T^6 = T^2∘T^2∘T^2) and 5 at k = 31, where the chain
//     paid k;
//   * the tables a pass writes hold (succ, dist) as one packed int2, as
//     list_rank_double's do, so a gather from them is one 8-byte load from
//     one sector; the plan's first pass only packs the two int32 inputs
//     (a coalesced read and write), so no gather touches them (a gather
//     from the inputs fetches two sectors, and one fewer pass did not pay
//     for that on the 2^24 forest; PERF.md); the last pass writes the two
//     int32 outputs, and the inputs are never written;
//   * one cooperative launch, a `grid.sync()` between the passes, on at
//     most the co-resident grid (a larger one is refused); kChainUnroll
//     independent elements a thread; list ends issue no gather.
//     n_steps <= 0 is one pass that copies the inputs.
// Coherence: only the inputs are read with `__ldg`; the packed tables,
// written in earlier passes, with plain loads after `grid.sync()`.
//
// The grid of a list_rank_chain launch over n entries, as
// list_rank_double_blocks gives it for its own kernel.
extern "C" int list_rank_chain_blocks(int device, int64_t n, int* blocks) {
  static int resident[kMaxDevices];
  return coop_blocks(list_rank_chain_coop, resident, device, n, blocks);
}

// succ, dist, succ_out, dist_out: int32[n] on `device`, 1 <= n <= 2^31, the
// outputs distinct from the inputs; succ entries -1 or in [0, n).
// schedule: host int32[schedule_len], the plan (see parse_schedule); an
// invalid one returns cudaErrorInvalidValue. scratch: packed int2[(passes -
// 1) * n] (8-byte aligned) on `device` (unused with one pass). blocks: the
// grid, 0 for list_rank_chain_blocks'. One cooperative launch. Returns the
// first CUDA error (0 on success).
extern "C" int list_rank_chain(const void* succ, const void* dist,
                               void* succ_out, void* dist_out, void* scratch,
                               const void* schedule, int schedule_len,
                               int64_t n, int blocks, int device,
                               void* stream) {
  ChainSchedule plan;
  if (!parse_schedule(static_cast<const int32_t*>(schedule), schedule_len,
                      &plan))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int32_t* succ_arg = static_cast<const int32_t*>(succ);
  const int32_t* dist_arg = static_cast<const int32_t*>(dist);
  int32_t* succ_out_arg = static_cast<int32_t*>(succ_out);
  int32_t* dist_out_arg = static_cast<int32_t*>(dist_out);
  int2* scratch_arg = static_cast<int2*>(scratch);
  uint32_t n_arg = static_cast<uint32_t>(n);
  void* args[] = {&succ_arg, &dist_arg, &succ_out_arg, &dist_out_arg,
                  &scratch_arg, &n_arg, &plan};
  if (blocks <= 0) {
    err = static_cast<cudaError_t>(list_rank_chain_blocks(device, n, &blocks));
    if (err != cudaSuccess) return err;
  }
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(list_rank_chain_coop), dim3(blocks),
      dim3(kCoopThreads), args, 0, static_cast<cudaStream_t>(stream));
  // Clear the runtime's last error, so that a refused launch is reported
  // here and not again by the next call that reads it.
  cudaGetLastError();
  return err;
}

// The previous design of list_rank_chain, kept only as a yardstick: one
// launch with no barrier (the snapshot is fixed), one thread an element
// taking the k steps, each a pair of dependent random gathers from one
// index.
//
// succ, dist, succ_out, dist_out: int32[n] on `device`, the outputs distinct
// from the inputs. One launch. Returns cudaGetLastError() after it (0 on
// success).
extern "C" int list_rank_chain_previous(const void* succ, const void* dist,
                                        void* succ_out, void* dist_out,
                                        int64_t n, int n_steps, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  list_rank_chain_previous_kernel<<<blocks, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(succ), static_cast<const int32_t*>(dist),
      static_cast<int32_t*>(succ_out), static_cast<int32_t*>(dist_out), n,
      n_steps);
  return cudaGetLastError();
}
