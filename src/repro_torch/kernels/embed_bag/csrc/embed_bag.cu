// Embedding bag with a fixed number of indices a bag:
//   out[b, :] = sum_h w[b, h] * table[idx[b, h], :]
// and, for mean, divided once by max(sum_h w[b, h], 1e-9).
//
// C entries:
//   embed_bag:           the kernel (below);
//   embed_bag_previous:  the previous design, one thread a (bag, V-wide
//                        feature chunk) loading and checking one index and
//                        then its row, index by index; kept only as a
//                        yardstick.
//
// Replaces the TPU kernel `_embed_bag_kernel` / `embed_bag_pallas` in
// src/repro/kernels/embed_bag/embed_bag.py. That kernel tiles 8 bags by 128
// features, pads D up to 128 and keeps the table's whole 128-wide column
// tile in VMEM. DIEN's D is 18, so on this card that padding would move 7x
// the bytes, and no table of the model fits in shared memory. So nothing is
// padded or staged: each row is read straight from device memory (L2 holds
// the user table, 7.2 MB).
//
// Bound on the H100: memory. The function reads idx (and weights) once,
// the gathered rows (at most the table), and writes out once; it does 2
// operations an element gathered. At the serve_bulk shape that is about
// 35 MB, ~0.01 ms at 3.35 TB/s. But a gathered float32 row of 18 (72 bytes
// at a multiple of 8) always spans three 32-byte sectors, so the gathers
// alone fetch 96 bytes a row: 201 MB at serve_bulk, from L2 for the user
// table and from device memory for the item table's size. Those sectors,
// not latency, set the time: on the card the user table's come at about
// 5.6 TB/s from L2, the item table's at about 80 % of the device memory's
// rate (PERF.md §6). At serve_p99 (512 bags) and in retrieval (1 bag) the
// launch sets the time.
//
// Design. Thread g serves V-wide feature chunk g % (D / V) of bag
// g / (D / V). Consecutive threads cover consecutive chunks of one row and
// then of the next bag, so a warp's row loads are contiguous runs and its
// output stores fully coalesced (fewer threads a bag, each with several
// chunks, were slower on the card at DIEN's width). A thread loads its
// bag's indices (and weights) itself, 16 bytes at a time where
// hot % 4 == 0 and the bases are 16-byte aligned: the lanes of one bag load
// the same bytes in the same instruction, which the card serves as one
// request a bag. It range-checks the indices, issues every row load on a
// clamped index, and only then traps if one was out of range, so all of a
// bag's row loads are in flight together (the previous kernel waited for
// each index before its row). hot 8 (dien) and 4 (dien-smoke) are unrolled
// at compile time; any other hot runs in rounds of 8 indices. Sharing the
// indices through shared memory or warp shuffles instead was slower on the
// card (scripts/embed_bag_plans.py times both).
//
// Indices follow PyTorch's rule for `table[idx]`, the plain version: one in
// [-rows, 0) counts from the end, and one outside [-rows, rows) stops the
// kernel with `__trap()`, so the next call that synchronises raises, as a
// device-side assert does for `table[idx]` on the card (the CUDA context is
// then lost, in both). The check costs no host read.
//
// Arithmetic (both kernels, bit for bit): as in the reference kernel, each
// weight is cast to the table's type and each product w * row rounded to it
// (exact products of two bf16 values, rounded once); the sum is kept in
// float32 whatever the table's type, in the order h = 0 .. hot - 1, the mean
// divides once by the float32 sum of the weights, and the value is rounded
// to the table's type at the store (round to nearest even for bf16).
// Without weights (`weights` null) no weights array is read: every weight
// is 1, so every product is the row itself and sum_h w = hot, which float32
// holds exactly.
//
// Vector width V: a row of D elements starts at a multiple of D * size
// bytes, so V-wide loads are aligned only when D % V == 0 and the table and
// output pointers are aligned to V * size. The widest V of at most 16 bytes
// that satisfies both is chosen by the host (float32 D = 18: 8-byte loads,
// since a 72-byte row is not 16-byte aligned); `embed_bag` checks the plan
// it is given, `embed_bag_previous` chooses its own.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Threads a block, of both kernels.
constexpr int kThreads = 256;
// Indices a round where hot is neither 4 nor 8.
constexpr int kRound = 8;

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

// What the kernel reads.
template <typename T>
struct Bags {
  const int32_t* idx;
  const float* weights;  // null: all ones
  const T* table;
  T* out;
  int64_t n_bags, rows;
  int hot, dim;
  bool vec_idx, mean;
};

// Row `x` of the table as an in-range row, and whether `x` was out of
// [-rows, rows) (then row 0, so the load stays inside the table).
__device__ __forceinline__ int64_t clamp_row(int64_t x, int64_t rows,
                                             bool& bad) {
  if (x < 0) x += rows;
  const bool out = x < 0 || x >= rows;
  bad |= out;
  return out ? 0 : x;
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_chunk(const T* table, int64_t row,
                                                 int dim, int chunk) {
  return *reinterpret_cast<const Pack<T, V>*>(table + row * dim + chunk * V);
}

// acc += w * row, the product rounded to T (the reference's order).
template <typename T, int V, bool kWeighted>
__device__ __forceinline__ void accumulate(float (&acc)[V],
                                           const Pack<T, V>& r, float w) {
  if (kWeighted) {
    const float wh = to_float(from_float<T>(w));
#pragma unroll
    for (int j = 0; j < V; ++j)
      acc[j] += to_float(from_float<T>(__fmul_rn(wh, to_float(r.v[j]))));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += to_float(r.v[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_chunk(T* out, int64_t bag, int dim,
                                            int chunk, float (&acc)[V],
                                            bool mean, float w_sum) {
  if (mean) {
    const float denom = fmaxf(w_sum, 1e-9f);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] /= denom;
  }
  Pack<T, V> o;
#pragma unroll
  for (int j = 0; j < V; ++j) o.v[j] = from_float<T>(acc[j]);
  *reinterpret_cast<Pack<T, V>*>(out + bag * dim + chunk * V) = o;
}

// One round of up to N of a bag's indices (m of them live, m <= N; N is 4
// or 8) for feature chunk `chunk`: every index (and weight) loaded, 16
// bytes at a time where a.vec_idx, then every row load issued on a clamped
// index, then one trap if any index was out of range, then the products
// added in order.
template <typename T, int V, int N, bool kWeighted>
__device__ __forceinline__ void gather_round(const Bags<T>& a,
                                             const int32_t* idx,
                                             const float* w, int m, int chunk,
                                             float (&acc)[V], float& w_sum) {
  int32_t x[N];
  float wt[N];
#pragma unroll
  for (int h = 0; h < N; ++h) {
    x[h] = 0;
    wt[h] = 1.f;
  }
  if (a.vec_idx) {  // hot % 4 == 0 and 16-byte bases: m is 4 or 8
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      if (4 * q < m) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(idx) + q);
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
        if (kWeighted) {
          const float4 u = __ldg(reinterpret_cast<const float4*>(w) + q);
          wt[4 * q] = u.x;
          wt[4 * q + 1] = u.y;
          wt[4 * q + 2] = u.z;
          wt[4 * q + 3] = u.w;
        }
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < N; ++h) {
      if (h < m) {
        x[h] = __ldg(idx + h);
        if (kWeighted) wt[h] = __ldg(w + h);
      }
    }
  }
  bool bad = false;
  Pack<T, V> r[N];
#pragma unroll
  for (int h = 0; h < N; ++h)
    if (h < m)
      r[h] = load_chunk<T, V>(a.table, clamp_row(x[h], a.rows, bad), a.dim,
                              chunk);
  if (bad) __trap();
#pragma unroll
  for (int h = 0; h < N; ++h) {
    if (h < m) {
      accumulate<T, V, kWeighted>(acc, r[h], wt[h]);
      w_sum += wt[h];
    }
  }
}

// Thread g serves chunk g % (dim / V) of bag g / (dim / V). HOT > 0: hot ==
// HOT, one round; HOT == 0: any hot, rounds of kRound.
template <typename T, int V, int HOT, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    embed_bag_kernel(const Bags<T> a) {
  const int chunks = a.dim / V;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t bag = g / chunks;
  if (bag >= a.n_bags) return;
  const int c = static_cast<int>(g - bag * chunks);
  const int32_t* idx = a.idx + bag * a.hot;
  const float* w = kWeighted ? a.weights + bag * a.hot : nullptr;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  float w_sum = 0.f;
  if constexpr (HOT > 0) {
    gather_round<T, V, HOT, kWeighted>(a, idx, w, HOT, c, acc, w_sum);
  } else {
    for (int h0 = 0; h0 < a.hot; h0 += kRound)
      gather_round<T, V, kRound, kWeighted>(
          a, idx + h0, kWeighted ? w + h0 : nullptr,
          a.hot - h0 < kRound ? a.hot - h0 : kRound, c, acc, w_sum);
  }
  store_chunk<T, V>(a.out, bag, a.dim, c, acc, a.mean, w_sum);
}

template <typename T, int V, int HOT>
cudaError_t launch_hot(const Bags<T>& a, unsigned blocks, cudaStream_t s) {
  if (a.weights != nullptr) {
    embed_bag_kernel<T, V, HOT, true><<<blocks, kThreads, 0, s>>>(a);
  } else {
    embed_bag_kernel<T, V, HOT, false><<<blocks, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch(const Bags<T>& a, cudaStream_t s) {
  const int64_t blocks = (a.n_bags * (a.dim / V) + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const auto grid = static_cast<unsigned>(blocks);
  if (a.hot == 8) return launch_hot<T, V, 8>(a, grid, s);
  if (a.hot == 4) return launch_hot<T, V, 4>(a, grid, s);
  return launch_hot<T, V, 0>(a, grid, s);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Checks the host's plan (`vector`, `vec_idx`) against the
// pointers and shapes, then launches.
template <typename T>
cudaError_t dispatch(const Bags<T>& a, int vector, cudaStream_t s) {
  const int bytes = vector * static_cast<int>(sizeof(T));
  const bool ok =
      (vector == 1 || vector == 2 || vector == 4 || vector == 8) &&
      bytes <= 16 && a.dim % vector == 0 && aligned(a.table, bytes) &&
      aligned(a.out, bytes) &&
      (!a.vec_idx || (a.hot % 4 == 0 && aligned(a.idx, 16) &&
                      (a.weights == nullptr || aligned(a.weights, 16))));
  if (!ok) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (vector == 8) return launch<T, 8>(a, s);
  }
  if (vector == 4) return launch<T, 4>(a, s);
  if (vector == 2) return launch<T, 2>(a, s);
  return launch<T, 1>(a, s);
}

// ---- The previous design, kept only as a yardstick. ----

template <typename T, int V, bool kWeighted>
__global__ void embed_bag_previous_kernel(const int32_t* __restrict__ idx,
                                          const float* __restrict__ weights,
                                          const T* __restrict__ table,
                                          T* __restrict__ out, int64_t n_bags,
                                          int64_t rows, int hot, int dim,
                                          bool mean) {
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
cudaError_t previous_launch(const int32_t* idx, const float* weights,
                            const T* table, T* out, int64_t n_bags,
                            int64_t rows, int hot, int dim, bool mean,
                            cudaStream_t s) {
  const int64_t threads = n_bags * (dim / V);
  const auto blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (weights != nullptr) {
    embed_bag_previous_kernel<T, V, true><<<blocks, kThreads, 0, s>>>(
        idx, weights, table, out, n_bags, rows, hot, dim, mean);
  } else {
    embed_bag_previous_kernel<T, V, false><<<blocks, kThreads, 0, s>>>(
        idx, weights, table, out, n_bags, rows, hot, dim, mean);
  }
  return cudaGetLastError();
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
cudaError_t previous_dispatch(const int32_t* idx, const float* weights,
                              const T* table, T* out, int64_t n_bags,
                              int64_t rows, int hot, int dim, bool mean,
                              cudaStream_t s) {
  const int v = vector_width<T>(table, out, dim);
  if constexpr (sizeof(T) == 2) {
    if (v == 8)
      return previous_launch<T, 8>(idx, weights, table, out, n_bags, rows,
                                   hot, dim, mean, s);
  }
  if (v == 4)
    return previous_launch<T, 4>(idx, weights, table, out, n_bags, rows, hot,
                                 dim, mean, s);
  if (v == 2)
    return previous_launch<T, 2>(idx, weights, table, out, n_bags, rows, hot,
                                 dim, mean, s);
  return previous_launch<T, 1>(idx, weights, table, out, n_bags, rows, hot,
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
// hot, dim > 0. The plan: `vector` elements a load (dim % vector == 0,
// table and out aligned to it, at most 16 bytes), and `vec_idx` for 16-byte
// index and weight loads (hot % 4 == 0, idx and weights 16-byte aligned);
// a plan that breaks one of these is refused (cudaErrorInvalidValue). One
// launch on `stream`; returns the CUDA error of the launch (0 on success).
extern "C" int embed_bag(const void* idx, const void* weights,
                         const void* table, void* out, int64_t n_bags,
                         int64_t rows, int hot, int dim, int is_bf16, int mean,
                         int vector, int vec_idx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const float*>(weights);
  if (is_bf16) {
    const Bags<__nv_bfloat16> a{
        i, w, static_cast<const __nv_bfloat16*>(table),
        static_cast<__nv_bfloat16*>(out), n_bags, rows, hot, dim,
        vec_idx != 0, mean != 0};
    return dispatch(a, vector, s);
  }
  const Bags<float> a{i, w, static_cast<const float*>(table),
                      static_cast<float*>(out), n_bags, rows, hot, dim,
                      vec_idx != 0, mean != 0};
  return dispatch(a, vector, s);
}

// The previous design, with the arguments of `embed_bag` before the plan;
// it chooses its own vector width.
extern "C" int embed_bag_previous(const void* idx, const void* weights,
                                  const void* table, void* out,
                                  int64_t n_bags, int64_t rows, int hot,
                                  int dim, int is_bf16, int mean, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const float*>(weights);
  if (is_bf16) {
    return previous_dispatch<__nv_bfloat16>(
        i, w, static_cast<const __nv_bfloat16*>(table),
        static_cast<__nv_bfloat16*>(out), n_bags, rows, hot, dim, mean != 0,
        s);
  }
  return previous_dispatch<float>(i, w, static_cast<const float*>(table),
                                  static_cast<float*>(out), n_bags, rows, hot,
                                  dim, mean != 0, s);
}
