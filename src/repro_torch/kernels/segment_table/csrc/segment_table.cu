// Doubling sparse table for idempotent range reductions (min or max):
//   table[0]        = values
//   table[k + 1][i] = op(table[k][i], table[k][i + 2^k])   if i + 2^k < n
//                   = table[k][i]                          otherwise
// so row k holds op over values[i : min(i + 2^k, n)].
//
// Replaces the TPU kernel `_segment_table_kernel` / `segment_table_pallas` in
// src/repro/kernels/segment_table/segment_table.py. That kernel runs with
// grid=(1,) and keeps the whole [levels + 1, n] table resident in VMEM,
// building every level by shifted slices padded with the op's identity. On
// the H100 the table does not fit in any on-chip memory (at n = 2^24 it is
// 1.68 GB), so it is built in device memory, each row written once:
//
//   * tile launch: a block owns 2^K outputs (K = 13, or 11 where n is below
//     264 tiles of 2^13, so that the grid still fills the 132 SMs twice) and
//     loads them with a halo of up to 2^K more values into shared memory
//     (8 << K bytes), slots past n holding the op's identity. It builds rows
//     0..min(levels, K) there in place (every thread reads its operands into
//     registers, a barrier, then writes) and stores each row once, 16 bytes a
//     thread where n % 4 == 0;
//   * upper launch: rows K + 1.. read only row K at a stride of 2^K. For one
//     residue r, x_m = rowK[r + m 2^K] is a list of len = ceil(n / 2^K)
//     values, and row (K + j) at r + m 2^K is level j of a plain sparse table
//     over x. A block takes a group of consecutive residues (16, or fewer so
//     that group x len fits in 64 KB and the grid has 256 blocks) with their
//     whole lists, builds every upper level in shared memory the same way
//     and stores each row once: group x 4 contiguous bytes per list entry (a
//     32-byte sector at n = 2^24). Where even one residue's list does not fit
//     (n > 2^27), the upper rows run as one launch per level instead;
//   * segment_table_stepwise, the previous design, kept as a yardstick: a
//     device copy and one launch per level, each reading row k twice.
// Every launch combines the same pairs in the same operand order,
// op(row_k[i], row_k[i + 2^k]), and combine(a, identity) returns a with its
// bits (NaN and -0.0 included; identity itself where a is it), so the
// identity slots give exactly the "keep table[k][i] past the end" rule: the
// three designs agree bit for bit.
//
// Bound on the H100: memory. The function reads values once and writes
// (levels + 1) rows of n elements: 4n(levels + 2) bytes. The two-launch
// design moves about 4n(levels + 4): values twice (tile and halo), the
// rows once, row K once more. The stepwise design moves ~12n a level.
//
// Float min/max propagate NaN as torch.minimum/torch.maximum do (fminf and
// fmaxf drop it), so the compare is written by hand; a tie of +0.0 and -0.0
// gives -0.0 for min and +0.0 for max, as torch.minimum/maximum on the card
// and jnp.minimum/maximum (the reference) order them.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// The tile's levels K: 13, or 11 below kSmallTileBelow values.
constexpr int kTileLevels = 13;
constexpr int kSmallTileLevels = 11;
constexpr int64_t kSmallTileBelow = int64_t{264} << kTileLevels;
// Entries a thread stages a level in; a tile block holds 2^(K + 1) entries,
// so it has 2^(K + 1) / kPerThread threads (1024 at K = 13).
constexpr int kPerThread = 16;
constexpr int kBlockThreads = 1024;
// Shared-memory entries an upper block holds at most (64 KB of int32).
constexpr int kBlockEntries = kPerThread * kBlockThreads;
// At most 16 residues a block of the upper launch: 64-byte runs a row; and
// at least 256 blocks where the tile allows.
constexpr int kMaxGroupShift = 4;
constexpr int kMinUpperBlocksShift = 8;

template <bool kMax>
__device__ __forceinline__ int32_t combine(int32_t a, int32_t b) {
  return kMax ? (a < b ? b : a) : (b < a ? b : a);
}

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  if (a != a) return a;  // NaN
  if (b != b) return b;
  if (a == b) return signbit(a) != kMax ? a : b;  // -0.0 below +0.0
  return kMax ? (a < b ? b : a) : (b < a ? b : a);
}

template <typename T, bool kMax> __device__ __forceinline__ T identity();
template <> __device__ __forceinline__ int32_t identity<int32_t, false>() { return INT_MAX; }
template <> __device__ __forceinline__ int32_t identity<int32_t, true>() { return INT_MIN; }
template <> __device__ __forceinline__ float identity<float, false>() { return __int_as_float(0x7f800000); }
template <> __device__ __forceinline__ float identity<float, true>() { return __int_as_float(static_cast<int>(0xff800000u)); }

template <typename T> struct Vec4;
template <> struct Vec4<int32_t> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

template <int kLevels>
struct Tile {
  static constexpr int kSize = 1 << kLevels;
  static constexpr int kThreads = 2 * kSize / kPerThread;
};

// Store buf[0, 2^K) as row `row` at [base, base + 2^K) ∩ [0, n). With
// `vec` (n % 4 == 0, so every row starts 16-byte aligned) 16 bytes a thread.
template <int kLevels, typename T>
__device__ __forceinline__ void store_tile_row(const T* buf, T* row,
                                               int64_t base, int64_t n,
                                               bool vec) {
  using V = typename Vec4<T>::type;
  constexpr int kSize = Tile<kLevels>::kSize;
  constexpr int kBlock = Tile<kLevels>::kThreads;
  if (vec) {
#pragma unroll
    for (int q = 0; q < kSize / 4 / kBlock; ++q) {
      const int i = 4 * (threadIdx.x + q * kBlock);
      if (base + i < n)
        *reinterpret_cast<V*>(row + base + i) =
            *reinterpret_cast<const V*>(buf + i);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kSize / kBlock; ++q) {
      const int i = threadIdx.x + q * kBlock;
      if (base + i < n) row[base + i] = buf[i];
    }
  }
}

// Rows 0..levels (levels <= K) of the 2^K outputs of one block. Row k is
// needed at buffer positions i < 2^K + 2^levels - 2^k (the windows of the
// outputs of the rows above), all inside the loaded span.
template <typename T, bool kMax, int kLevels>
__global__ void __launch_bounds__(Tile<kLevels>::kThreads)
segment_table_tile(const T* __restrict__ values, T* __restrict__ table,
                   int64_t n, int levels) {
  constexpr int kTile = Tile<kLevels>::kSize;
  constexpr int kBlock = Tile<kLevels>::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int span = kTile + (1 << levels) - 1;
  const bool vec = n % 4 == 0;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int i = threadIdx.x + q * kBlock;
    buf[i] = i < span && base + i < n ? __ldg(values + base + i)
                                      : identity<T, kMax>();
  }
  __syncthreads();
  store_tile_row<kLevels>(buf, table, base, n, vec);
  T r[kPerThread];
  for (int k = 1; k <= levels; ++k) {
    const int h = 1 << (k - 1);
    const int lim = kTile + (1 << levels) - (1 << k);
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = threadIdx.x + q * kBlock;
      if (i < lim) r[q] = combine<kMax>(buf[i], buf[i + h]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = threadIdx.x + q * kBlock;
      if (i < lim) buf[i] = r[q];
    }
    __syncthreads();
    store_tile_row<kLevels>(buf, table + k * n, base, n, vec);
  }
}

// Rows tile_levels + 1 .. levels for the residues [r0, r0 + group) of
// 2^tile_levels, group a power of two <= 2^kMaxGroupShift. Entry idx of the
// buffer is list entry m = idx / group of residue r0 + idx % group, at table
// position r0 + idx % group + m 2^tile_levels.
template <typename T, bool kMax>
__global__ void __launch_bounds__(kBlockThreads)
segment_table_upper(T* __restrict__ table, int64_t n, int tile_levels,
                    int levels, int group_shift, int len) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  const int group = 1 << group_shift;
  const int total = group * len;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * group;
  const T* row_top = table + tile_levels * n;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int idx = threadIdx.x + q * kBlockThreads;
    if (idx < total) {
      const int64_t pos = r0 + (idx & (group - 1)) +
                          (static_cast<int64_t>(idx >> group_shift) << tile_levels);
      buf[idx] = pos < n ? __ldg(row_top + pos) : identity<T, kMax>();
    }
  }
  __syncthreads();
  T r[kPerThread];
  for (int k = tile_levels + 1; k <= levels; ++k) {
    const int64_t h = int64_t{1} << (k - tile_levels - 1);  // in list entries
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int idx = threadIdx.x + q * kBlockThreads;
      if (idx < total && (idx >> group_shift) + h < len)
        r[q] = combine<kMax>(buf[idx], buf[idx + (h << group_shift)]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int idx = threadIdx.x + q * kBlockThreads;
      if (idx < total && (idx >> group_shift) + h < len) buf[idx] = r[q];
    }
    __syncthreads();
    T* row = table + k * n;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int idx = threadIdx.x + q * kBlockThreads;
      if (idx < total) {
        const int64_t pos = r0 + (idx & (group - 1)) +
                            (static_cast<int64_t>(idx >> group_shift) << tile_levels);
        if (pos < n) row[pos] = buf[idx];
      }
    }
  }
}

template <typename T, bool kMax>
__global__ void segment_table_level(const T* __restrict__ in,
                                    T* __restrict__ out, int64_t n,
                                    int64_t shift) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T a = in[i];
  out[i] = i + shift < n ? combine<kMax>(a, in[i + shift]) : a;
}

// Four neighbours a thread; rows 16-byte aligned (n % 4 == 0).
template <typename T, bool kMax>
__global__ void segment_table_level_x4(const T* __restrict__ in,
                                       T* __restrict__ out, int64_t n,
                                       int64_t shift) {
  using V = typename Vec4<T>::type;
  const int64_t i =
      4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const V va = *reinterpret_cast<const V*>(in + i);
  const T a[4] = {va.x, va.y, va.z, va.w};
  T b[4];
  if (shift % 4 == 0 && i + shift + 4 <= n) {
    const V vb = *reinterpret_cast<const V*>(in + i + shift);
    b[0] = vb.x; b[1] = vb.y; b[2] = vb.z; b[3] = vb.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = i + j + shift < n ? in[i + j + shift] : a[j];
  }
  T r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    r[j] = i + j + shift < n ? combine<kMax>(a[j], b[j]) : a[j];
  V vr;
  vr.x = r[0]; vr.y = r[1]; vr.z = r[2]; vr.w = r[3];
  *reinterpret_cast<V*>(out + i) = vr;
}

// Levels from + 1 .. levels, one launch each, from row `from` of the table.
template <typename T, bool kMax>
cudaError_t per_level(T* table, int64_t n, int from, int levels,
                      cudaStream_t s) {
  const bool x4 = n % 4 == 0;
  const int64_t threads = x4 ? n / 4 : n;
  const auto blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  for (int k = from; k < levels; ++k) {
    const T* in = table + k * n;
    T* out = table + (k + 1) * n;
    if (x4) {
      segment_table_level_x4<T, kMax><<<blocks, kThreads, 0, s>>>(
          in, out, n, int64_t{1} << k);
    } else {
      segment_table_level<T, kMax><<<blocks, kThreads, 0, s>>>(
          in, out, n, int64_t{1} << k);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// How a call of n values and `levels` levels runs: the tile's levels K,
// log2 of the upper launch's residues a block (-1: the upper rows run one
// launch per level), the length of a residue's list, and the launches.
struct Plan {
  int tile_levels;
  int group_shift;
  int len;
  int launches;
};

Plan plan(int64_t n, int levels) {
  const int tile = n < kSmallTileBelow ? kSmallTileLevels : kTileLevels;
  Plan p{tile, 0, 0, 1};
  if (levels <= tile) return p;
  const int64_t len = (n + (int64_t{1} << tile) - 1) >> tile;
  if (len > kBlockEntries) {
    p.group_shift = -1;
    p.launches = 1 + levels - tile;
    return p;
  }
  int shift = kMaxGroupShift < tile - kMinUpperBlocksShift
                  ? kMaxGroupShift : tile - kMinUpperBlocksShift;
  while (shift > 0 && (int64_t{1} << shift) * len > kBlockEntries) --shift;
  p.group_shift = shift;
  p.len = static_cast<int>(len);
  p.launches = 2;
  return p;
}

template <typename T, bool kMax, int kLevels>
cudaError_t launch_tile(const T* values, T* table, int64_t n, int levels,
                        cudaStream_t s) {
  constexpr int kSize = Tile<kLevels>::kSize;
  const int smem = 2 * kSize * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      segment_table_tile<T, kMax, kLevels>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const auto tiles = static_cast<unsigned>((n + kSize - 1) / kSize);
  segment_table_tile<T, kMax, kLevels>
      <<<tiles, Tile<kLevels>::kThreads, smem, s>>>(
          values, table, n, levels < kLevels ? levels : kLevels);
  return cudaGetLastError();
}

template <typename T, bool kMax>
cudaError_t build_table(const T* values, T* table, int64_t n, int levels,
                        cudaStream_t s) {
  const Plan p = plan(n, levels);
  cudaError_t err =
      p.tile_levels == kTileLevels
          ? launch_tile<T, kMax, kTileLevels>(values, table, n, levels, s)
          : launch_tile<T, kMax, kSmallTileLevels>(values, table, n, levels, s);
  if (err != cudaSuccess || levels <= p.tile_levels) return err;
  if (p.group_shift < 0)
    return per_level<T, kMax>(table, n, p.tile_levels, levels, s);
  const int upper_smem = (p.len << p.group_shift) * static_cast<int>(sizeof(T));
  err = cudaFuncSetAttribute(segment_table_upper<T, kMax>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             upper_smem);
  if (err != cudaSuccess) return err;
  segment_table_upper<T, kMax>
      <<<(1 << p.tile_levels) >> p.group_shift, kBlockThreads, upper_smem, s>>>(
          table, n, p.tile_levels, levels, p.group_shift, p.len);
  return cudaGetLastError();
}

template <typename T, bool kMax>
cudaError_t build_table_stepwise(const T* values, T* table, int64_t n,
                                 int levels, cudaStream_t s) {
  cudaError_t err = cudaMemcpyAsync(table, values, n * sizeof(T),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  return per_level<T, kMax>(table, n, 0, levels, s);
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launches a segment_table call of n >= 1 values and `levels` levels
// makes: 1 (the tile launch) where levels <= K (13, or 11 below 264 tiles of
// 2^13 values), else 2, or 1 + levels - K where a residue's list does not
// fit in a block (n > 2^27). Writes it to *launches; returns 0.
extern "C" int segment_table_launches(int64_t n, int levels, int* launches) {
  *launches = plan(n, levels).launches;
  return 0;
}

// values: int32[n] (is_float == 0) or float32[n] (is_float != 0), n >= 1;
// table: the same type, [levels + 1, n] row-major, 16-byte aligned, distinct
// from values; both on `device`. is_max selects max, else min. The launches
// segment_table_launches gives, on `stream`; returns the first CUDA error
// (0 on success).
extern "C" int segment_table(const void* values, void* table, int64_t n,
                             int levels, int is_float, int is_max, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_float) {
    const auto* v = static_cast<const float*>(values);
    auto* t = static_cast<float*>(table);
    return is_max ? build_table<float, true>(v, t, n, levels, s)
                  : build_table<float, false>(v, t, n, levels, s);
  }
  const auto* v = static_cast<const int32_t*>(values);
  auto* t = static_cast<int32_t*>(table);
  return is_max ? build_table<int32_t, true>(v, t, n, levels, s)
                : build_table<int32_t, false>(v, t, n, levels, s);
}

// The previous design, kept only as a yardstick: a device copy of values
// and one launch per level. Same contract as segment_table; `levels`
// launches.
extern "C" int segment_table_stepwise(const void* values, void* table,
                                      int64_t n, int levels, int is_float,
                                      int is_max, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_float) {
    const auto* v = static_cast<const float*>(values);
    auto* t = static_cast<float*>(table);
    return is_max ? build_table_stepwise<float, true>(v, t, n, levels, s)
                  : build_table_stepwise<float, false>(v, t, n, levels, s);
  }
  const auto* v = static_cast<const int32_t*>(values);
  auto* t = static_cast<int32_t*>(table);
  return is_max ? build_table_stepwise<int32_t, true>(v, t, n, levels, s)
                : build_table_stepwise<int32_t, false>(v, t, n, levels, s);
}
