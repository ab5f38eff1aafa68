// Shared helpers for the port's Hopper kernels: element-type conversion
// and warp/block reductions. Every kernel is templated on float and
// __nv_bfloat16 so that the f32 instantiation can be checked tightly
// against its plain PyTorch twin.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace spt {

// dtype codes shared with the Python wrappers (_build.DTYPE_CODES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch/XLA
}

// round a float to T's precision and back (the "astype(dtype)" of the
// JAX kernels)
template <typename T> __device__ __forceinline__ float rt(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; `red` is >= 32 floats of shared scratch. Every
// thread of the block must call, and gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];  // fixed order: deterministic
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < nw; ++i) t = fmaxf(t, red[i]);
  return t;
}

// (value, index) argmax step: larger value wins, ties go to the lower index
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// d += a b, one warp: a 16 x 16 bf16 tile (row-major fragments), b 16 x 8
// (column-major: stored [n][k]), f32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace spt
