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

// two floats rounded to bf16 and packed as one mma operand register (lo in
// the low half: the lower column of the pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8 x 8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the
// row addresses of matrix i; r[i] holds (row lane / 4, columns 2 (lane % 4)
// and +1) of matrix i, or with .trans (rows 2 (lane % 4) and +1, column
// lane / 4)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// 16 bytes global -> shared without passing through registers (L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// cp_async16 of the first `n` bytes (0 or 16) of src, the rest zero-filled:
// src is not read when n is 0
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

// cp_async16_zfill with a hint to fetch the 256-byte L2 sector group: for
// weight streams whose neighbouring copies read the rest of it
__device__ __forceinline__ void cp_async16_zfill_l2(void* dst, const void* src,
                                                    int n) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

// 4 bytes global -> shared, zero-filled when `n` is 0 (src then not read)
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared-memory offset (elements) of this lane's ldmatrix row address:
// an A operand [16 rows][16 k] at (r0, k0) of a row-major tile
__device__ __forceinline__ int a_off(int r0, int k0, int kRow) {
  const int lane = threadIdx.x & 31;
  return (r0 + (lane & 15)) * kRow + k0 + (lane >> 4) * 8;
}

// two n8 B operands [16 k][8 n] stored [n][k] (the contraction along the
// row), n from n0: registers 0-1 for n0.., 2-3 for n0 + 8..
__device__ __forceinline__ int bt_off(int n0, int k0, int kRow) {
  const int lane = threadIdx.x & 31;
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * kRow + k0
         + ((lane >> 3) & 1) * 8;
}

// two n8 B operands stored [k][n] (read with .trans), k from k0 and n
// from n0: registers 0-1 for n0.., 2-3 for n0 + 8..
__device__ __forceinline__ int bn_off(int k0, int n0, int kRow) {
  const int lane = threadIdx.x & 31;
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow + n0
         + (lane >> 4) * 8;
}

// an A operand [16 m][16 k] at (m0, k0) of a tile stored [k][m] (the
// contraction along the rows; read with .trans)
__device__ __forceinline__ int at_off(int m0, int k0, int kRow) {
  const int lane = threadIdx.x & 31;
  return (k0 + (lane & 7) + (lane >> 4) * 8) * kRow + m0
         + ((lane >> 3) & 1) * 8;
}

}  // namespace spt
