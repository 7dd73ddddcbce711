// Embedding bag with a fixed number of indices a bag:
//   out[b, :] = sum_h w[b, h] * table[idx[b, h], :]
// and, for mean, divided once by max(sum_h w[b, h], 1e-9).
//
// Replaces the TPU kernel `_embed_bag_kernel` / `embed_bag_pallas` in
// src/repro/kernels/embed_bag/embed_bag.py. That kernel tiles 8 bags by 128
// features, pads D up to 128 and keeps the table's whole 128-wide column
// tile in VMEM. DIEN's D is 18, so on this card that padding would move 7x
// the bytes, and no table of the model fits in shared memory. So nothing is
// padded or staged: a group of D / V threads serves one bag, each thread V
// neighbouring features, looping over the bag's `hot` indices and reading
// each row straight from device memory (L2 holds the user table, 7.2 MB).
// Consecutive threads cover consecutive features of one row and then of the
// next bag, so the row reads are contiguous runs and the output stores are
// fully coalesced.
//
// Indices follow PyTorch's rule for `table[idx]`, the plain version: one in
// [-rows, 0) counts from the end, and one outside [-rows, rows) stops the
// kernel with `__trap()`, so the next call that synchronises raises, as a
// device-side assert does for `table[idx]` on the card (the CUDA context is
// then lost, in both). The check costs no host read.
//
// Bound on the H100: memory. The function reads idx (and weights) once,
// the gathered rows (at most the table), and writes out once; it does 2
// operations an element gathered. At the serve_bulk shape that is about
// 35 MB, ~0.01 ms at 3.35 TB/s; at serve_p99 the launch sets the time.
//
// Arithmetic: as in the reference kernel, each weight is cast to the
// table's type and each product w * row rounded to it (exact products of
// two bf16 values, rounded once); the sum is kept in float32 whatever the
// table's type, the mean divides once by the float32 sum of the weights,
// and the value is rounded to the table's type at the store (round to
// nearest even for bf16). Without weights (`weights` null) the kernel reads
// no weights array: every weight is 1, so every product is the row itself
// and sum_h w = hot, which float32 holds exactly.
//
// Vector width V: a row of D elements starts at a multiple of D * size
// bytes, so V-wide loads are aligned only when D % V == 0 and the table and
// output pointers are aligned to V * size. The host entry takes the widest
// V of at most 16 bytes that satisfies both (float32 D = 18: 8-byte
// loads, since a 72-byte row is not 16-byte aligned).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V, bool kWeighted>
__global__ void embed_bag_kernel(const int32_t* __restrict__ idx,
                                 const float* __restrict__ weights,
                                 const T* __restrict__ table,
                                 T* __restrict__ out, int64_t n_bags,
                                 int64_t rows, int hot, int dim, bool mean) {
  const int per_bag = dim / V;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n_bags * per_bag) return;
  const int64_t b = g / per_bag;
  const int d = static_cast<int>(g - b * per_bag) * V;
  const int32_t* bag = idx + b * hot;
  const float* w = kWeighted ? weights + b * hot : nullptr;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  float w_sum = 0.f;
  for (int h = 0; h < hot; ++h) {
    int64_t row = __ldg(bag + h);
    if (row < 0) row += rows;
    if (row < 0 || row >= rows) __trap();
    const Pack<T, V> r =
        *reinterpret_cast<const Pack<T, V>*>(table + row * dim + d);
    if (kWeighted) {
      const float wf = __ldg(w + h);
      const float wh = to_float(from_float<T>(wf));
      w_sum += wf;
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[j] += to_float(from_float<T>(__fmul_rn(wh, to_float(r.v[j]))));
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += to_float(r.v[j]);
    }
  }
  if (mean) {
    const float denom = fmaxf(kWeighted ? w_sum : static_cast<float>(hot),
                              1e-9f);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] /= denom;
  }
  Pack<T, V> o;
#pragma unroll
  for (int j = 0; j < V; ++j) o.v[j] = from_float<T>(acc[j]);
  *reinterpret_cast<Pack<T, V>*>(out + b * dim + d) = o;
}

template <typename T, int V>
cudaError_t launch(const int32_t* idx, const float* weights, const T* table,
                   T* out, int64_t n_bags, int64_t rows, int hot, int dim,
                   bool mean, cudaStream_t s) {
  const int64_t threads = n_bags * (dim / V);
  const auto blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (weights != nullptr) {
    embed_bag_kernel<T, V, true><<<blocks, kThreads, 0, s>>>(
        idx, weights, table, out, n_bags, rows, hot, dim, mean);
  } else {
    embed_bag_kernel<T, V, false><<<blocks, kThreads, 0, s>>>(
        idx, weights, table, out, n_bags, rows, hot, dim, mean);
  }
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The widest V (a power of two, V * sizeof(T) <= 16) with dim % V == 0 and
// both row bases aligned to V * sizeof(T).
template <typename T>
int vector_width(const void* table, const void* out, int dim) {
  for (int v = 16 / static_cast<int>(sizeof(T)); v > 1; v /= 2) {
    const int bytes = v * static_cast<int>(sizeof(T));
    if (dim % v == 0 && aligned(table, bytes) && aligned(out, bytes)) return v;
  }
  return 1;
}

template <typename T>
cudaError_t dispatch(const int32_t* idx, const float* weights, const T* table,
                     T* out, int64_t n_bags, int64_t rows, int hot, int dim,
                     bool mean, cudaStream_t s) {
  const int v = vector_width<T>(table, out, dim);
  if constexpr (sizeof(T) == 2) {
    if (v == 8)
      return launch<T, 8>(idx, weights, table, out, n_bags, rows, hot,
                            dim, mean, s);
  }
  if (v == 4)
    return launch<T, 4>(idx, weights, table, out, n_bags, rows, hot,
                            dim, mean, s);
  if (v == 2)
    return launch<T, 2>(idx, weights, table, out, n_bags, rows, hot,
                            dim, mean, s);
  return launch<T, 1>(idx, weights, table, out, n_bags, rows, hot,
                            dim, mean, s);
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// idx: int32[n_bags, hot], every entry in [-rows, rows) (the kernel traps
// otherwise); weights: float32[n_bags, hot], or null for all ones; table:
// float32 (is_bf16 == 0) or bf16 [rows, dim]; out: the table's type,
// [n_bags, dim]. All row-major and contiguous on `device`; n_bags, rows,
// hot, dim > 0. One launch on `stream`; returns the CUDA error of the launch
// (0 on success).
extern "C" int embed_bag(const void* idx, const void* weights,
                         const void* table, void* out, int64_t n_bags,
                         int64_t rows, int hot, int dim, int is_bf16, int mean,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const float*>(weights);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(
        i, w, static_cast<const __nv_bfloat16*>(table),
        static_cast<__nv_bfloat16*>(out), n_bags, rows, hot, dim, mean != 0,
        s);
  }
  return dispatch<float>(i, w, static_cast<const float*>(table),
                         static_cast<float*>(out), n_bags, rows, hot, dim,
                         mean != 0, s);
}
