// Designs of the embed_bag kernel that were timed and not kept, built and
// timed only by scripts/embed_bag_plans.py. Each computes what the kernel
// in src/repro_torch/kernels/embed_bag/csrc/embed_bag.cu computes for its
// timed case (mean, no weights, hot 8, 2-element loads, every index in
// range), bit for bit:
//   0 staged:   a block of floor(256 / L) bags of L = dim / 2 threads copies
//               its bags' indices into shared memory (16-byte loads), and
//               after a barrier each thread reads its bag's 8 from there;
//   1 shuffle:  floor(32 / L) bags a warp, never split across warps; lanes
//               0..7 of a bag's group load its 8 indices and share them by
//               warp shuffles;
//   2 l2_only:  the kernel's mapping, the row loads cached in L2 only
//               (ld.global.cg);
//   3 lanes:    `lanes` threads a bag (at most dim / 2), thread l of a bag
//               serving its 2-element chunks l, l + lanes, ... in a loop
//               (the kernel's mapping is lanes = dim / 2 without the loop).
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHot = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

// Two neighbouring elements of a row, as the kernel loads them.
template <typename T, bool kL2Only>
__device__ __forceinline__ void load2(const T* p, float& a, float& b) {
  using Raw = typename std::conditional<sizeof(T) == 4, uint2, unsigned>::type;
  const Raw r = kL2Only ? __ldcg(reinterpret_cast<const Raw*>(p))
                        : *reinterpret_cast<const Raw*>(p);
  T v[2];
  memcpy(v, &r, sizeof(v));
  a = to_float(v[0]);
  b = to_float(v[1]);
}

// The bag's 8 rows at chunk c, summed in order, the mean stored.
template <typename T, bool kL2Only>
__device__ __forceinline__ void bag_chunk(const int32_t (&x)[kHot],
                                          const T* table, T* out, int64_t bag,
                                          int64_t rows, int dim, int c) {
  bool bad = false;
  float a[kHot], b[kHot];
#pragma unroll
  for (int h = 0; h < kHot; ++h) {
    int64_t row = x[h];
    if (row < 0) row += rows;
    const bool o = row < 0 || row >= rows;
    bad |= o;
    load2<T, kL2Only>(table + (o ? 0 : row) * dim + 2 * c, a[h], b[h]);
  }
  if (bad) __trap();
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int h = 0; h < kHot; ++h) {
    s0 += a[h];
    s1 += b[h];
  }
  const float denom = fmaxf(static_cast<float>(kHot), 1e-9f);
  store2(out + bag * dim + 2 * c, s0 / denom, s1 / denom);
}

template <typename T>
__global__ void staged_kernel(const int32_t* __restrict__ idx,
                              const T* __restrict__ table, T* __restrict__ out,
                              int64_t n_bags, int64_t rows, int dim) {
  extern __shared__ __align__(16) int32_t staged[];
  const int lanes = dim / 2;
  const int per_block = blockDim.x / lanes;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t left = n_bags - first;
  const int n = static_cast<int>(left < per_block ? left : per_block) * kHot;
  for (int q = threadIdx.x; q < n / 4; q += blockDim.x)
    reinterpret_cast<int4*>(staged)[q] =
        __ldg(reinterpret_cast<const int4*>(idx + first * kHot) + q);
  __syncthreads();
  const int local = threadIdx.x / lanes;
  const int64_t bag = first + local;
  if (bag >= n_bags) return;
  int32_t x[kHot];
#pragma unroll
  for (int q = 0; q < kHot / 4; ++q) {
    const int4 v = reinterpret_cast<const int4*>(staged + local * kHot)[q];
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
  bag_chunk<T, false>(x, table, out, bag, rows, dim,
                      threadIdx.x - local * lanes);
}

template <typename T>
__global__ void shuffle_kernel(const int32_t* __restrict__ idx,
                               const T* __restrict__ table,
                               T* __restrict__ out, int64_t n_bags,
                               int64_t rows, int dim) {
  const int lanes = dim / 2;
  const int per_warp = 32 / lanes;
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int group = lane / lanes;
  const int c = lane - group * lanes;
  const int64_t bag = warp * per_warp + group;
  const bool live = group < per_warp && bag < n_bags;
  const int32_t mine = live && c < kHot ? __ldg(idx + bag * kHot + c) : 0;
  int32_t x[kHot];
#pragma unroll
  for (int h = 0; h < kHot; ++h)
    x[h] = __shfl_sync(0xffffffffu, mine, (live ? group : 0) * lanes + h);
  if (live) bag_chunk<T, false>(x, table, out, bag, rows, dim, c);
}

template <typename T>
__global__ void l2_only_kernel(const int32_t* __restrict__ idx,
                               const T* __restrict__ table,
                               T* __restrict__ out, int64_t n_bags,
                               int64_t rows, int dim) {
  const int lanes = dim / 2;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t bag = g / lanes;
  if (bag >= n_bags) return;
  int32_t x[kHot];
#pragma unroll
  for (int q = 0; q < kHot / 4; ++q) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(idx + bag * kHot) + q);
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
  bag_chunk<T, true>(x, table, out, bag, rows, dim,
                     static_cast<int>(g - bag * lanes));
}

template <typename T>
__global__ void lanes_kernel(const int32_t* __restrict__ idx,
                             const T* __restrict__ table, T* __restrict__ out,
                             int64_t n_bags, int64_t rows, int dim,
                             int lanes) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t bag = g / lanes;
  if (bag >= n_bags) return;
  int32_t x[kHot];
#pragma unroll
  for (int q = 0; q < kHot / 4; ++q) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(idx + bag * kHot) + q);
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
  for (int c = static_cast<int>(g - bag * lanes); c < dim / 2; c += lanes)
    bag_chunk<T, false>(x, table, out, bag, rows, dim, c);
}

template <typename T>
int run(int variant, const int32_t* idx, const T* table, T* out,
        int64_t n_bags, int64_t rows, int dim, int lanes_asked,
        cudaStream_t s) {
  const int lanes = dim / 2;
  if (dim % 2 != 0 || lanes > 32) return cudaErrorInvalidValue;
  if (variant == 0) {
    const int per_block = kThreads / lanes;
    const auto blocks =
        static_cast<unsigned>((n_bags + per_block - 1) / per_block);
    staged_kernel<T><<<blocks, per_block * lanes,
                        per_block * kHot * sizeof(int32_t), s>>>(
        idx, table, out, n_bags, rows, dim);
  } else if (variant == 1) {
    const int64_t warps = (n_bags + 32 / lanes - 1) / (32 / lanes);
    const auto blocks =
        static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
    shuffle_kernel<T><<<blocks, kThreads, 0, s>>>(idx, table, out, n_bags,
                                                  rows, dim);
  } else if (variant == 2) {
    const auto blocks =
        static_cast<unsigned>((n_bags * lanes + kThreads - 1) / kThreads);
    l2_only_kernel<T><<<blocks, kThreads, 0, s>>>(idx, table, out, n_bags,
                                                  rows, dim);
  } else if (variant == 3 && lanes_asked >= 1 && lanes_asked <= lanes) {
    const auto blocks = static_cast<unsigned>(
        (n_bags * lanes_asked + kThreads - 1) / kThreads);
    lanes_kernel<T><<<blocks, kThreads, 0, s>>>(idx, table, out, n_bags, rows,
                                                dim, lanes_asked);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// idx: int32[n_bags, 8], 16-byte aligned, every entry in [-rows, rows);
// table and out: float32 (is_bf16 == 0) or bf16, [rows, dim] and
// [n_bags, dim], 2-element aligned, dim even and at most 64; `lanes` for
// design 3 only. One launch of design `variant` on `stream`; returns the
// CUDA error of the launch.
extern "C" int embed_bag_variant(int variant, const void* idx,
                                 const void* table, void* out, int64_t n_bags,
                                 int64_t rows, int dim, int is_bf16, int lanes,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int32_t*>(idx);
  if (is_bf16)
    return run(variant, i, static_cast<const __nv_bfloat16*>(table),
               static_cast<__nv_bfloat16*>(out), n_bags, rows, dim, lanes, s);
  return run(variant, i, static_cast<const float*>(table),
             static_cast<float*>(out), n_bags, rows, dim, lanes, s);
}
