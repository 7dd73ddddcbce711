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
// 1.74 GB), and level k + 1 reads all of level k, which blocks running in no
// order cannot share without a grid-wide barrier. So each doubling level is
// its own launch over n threads on one stream, reading row k at i and at
// i + 2^k and writing row k + 1; row 0 is a device-to-device copy of
// `values`. A call makes `levels` launches and no host read. Positions past
// the end are not folded at all, which is what folding the identity does
// for every finite value and what the reference's clamped plain path does.
//
// Bound on the H100: memory. The function reads values once and writes
// (levels + 1) rows of n elements: 4n(levels + 2) bytes. This design reads
// row k twice and writes row k + 1 on every level, ~12n bytes a level, all
// coalesced, so it is expected near 3x its bound. Where n is a multiple of
// 4 (every row then starts 16-byte aligned) a thread handles 4 neighbours
// with 16-byte loads and stores; the shifted read is a 16-byte load too
// once 2^k >= 4. A faster design builds the first log2(tile) levels of a
// tile in shared memory.
//
// Float min/max propagate NaN as torch.minimum/torch.maximum do (fminf and
// fmaxf drop it), so the compare is written by hand; ties keep the first
// operand, as std::min/std::max do.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kMax>
__device__ __forceinline__ int32_t combine(int32_t a, int32_t b) {
  return kMax ? (a < b ? b : a) : (b < a ? b : a);
}

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  if (a != a) return a;  // NaN
  if (b != b) return b;
  return kMax ? (a < b ? b : a) : (b < a ? b : a);
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

template <typename T> struct Vec4;
template <> struct Vec4<int32_t> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

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

template <typename T, bool kMax>
cudaError_t build_table(const T* values, T* table, int64_t n, int levels,
                        cudaStream_t s) {
  cudaError_t err = cudaMemcpyAsync(table, values, n * sizeof(T),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  const bool x4 = n % 4 == 0;
  const int64_t threads = x4 ? n / 4 : n;
  const auto blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  for (int k = 0; k < levels; ++k) {
    const T* in = table + k * n;
    T* out = table + (k + 1) * n;
    if (x4) {
      segment_table_level_x4<T, kMax><<<blocks, kThreads, 0, s>>>(
          in, out, n, int64_t{1} << k);
    } else {
      segment_table_level<T, kMax><<<blocks, kThreads, 0, s>>>(
          in, out, n, int64_t{1} << k);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// values: int32[n] (is_float == 0) or float32[n] (is_float != 0); table:
// the same type, [levels + 1, n] row-major, 16-byte aligned, distinct from
// values; both on `device`. is_max selects max, else min. One copy and `levels` launches
// on `stream`; returns the first CUDA error (0 on success).
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
