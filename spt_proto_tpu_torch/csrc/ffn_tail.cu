// Fused decode FFN tail at skinny m (the decode batch), with the fc1 hidden
// values kept in f32:
//   fp weights:    out = res + relu(x @ w1 + b1) @ w2 + b2
//   int8 weights:  out = res + b2 + (relu((x @ w1q) * s1 + b1) @ w2q) * s2
//
// Replaces the TPU kernels spt_proto_tpu/ops/pallas/ffn_tail.py ffn_tail
// (_ffn_kernel) and ffn_tail_int8 (_ffn_int8_kernel).
//
// Bound on the H100: memory. The work streams both weight matrices once:
// OPT-125M 2 x 768 x 3072 bf16 = 9.4 MB, 2.8 us at 3.35 TB/s (int8: 4.7 MB,
// 1.4 us); OPT-1.3B 67 MB, 20 us (int8: 34 MB, 10 us). At m = 8 the products
// are 2 x 8 x D x F x 2 operations, far below the tensor-core line.
//
// Design: the TPU kernels walk d_ff tiles in order and carry an f32
// accumulator across grid steps; CTAs run in no order, so the work splits
// in two launches. ffn_partial_kernel: one CTA per (d_ff slice of FT
// columns, block of 8 rows) computes h = relu(x @ w1[:, slice] (* s1) + b1)
// in f32 (K split over thread groups, summed in a fixed order), then that
// slice's f32 contribution h @ w2[slice, :] to all D outputs (unscaled for
// int8 weights), and stores it as a partial [slice, m, D]. The reduce
// kernel adds the partials in slice order, so the result does not change
// from run to run (no atomics), and casts to x's dtype once: the fp form
// seeds the sum with res + b2, the int8 form sums the partials and then
// takes res + b2 + sum * s2 (the TPU kernel's order). int8 weights are read
// with their padded row strides (LD1 = F_pad, LD2 = D_pad); only the true
// F and D columns are touched.
#include <type_traits>

#include "common.cuh"

namespace spt {

constexpr int kFfnRows = 8;      // rows of x per CTA
constexpr int kFfnThreads = 256;

// W is T (fp weights, s1 unused) or int8_t (int8 weights, s1 the fc1
// scales)
template <typename T, typename W>
__global__ void __launch_bounds__(kFfnThreads) ffn_partial_kernel(
    const T* __restrict__ x, const W* __restrict__ w1,
    const float* __restrict__ s1, const T* __restrict__ b1,
    const W* __restrict__ w2, float* __restrict__ part, int M, int D, int F,
    int LD1, int LD2, int FT) {
  const int s = blockIdx.x, m0 = blockIdx.y * kFfnRows;
  const int rows = min(kFfnRows, M - m0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int f0 = s * FT, ksplit = nthr / FT;

  extern __shared__ float sm[];
  float* xs = sm;                                 // [rows][D]
  float* hp = xs + kFfnRows * D;                  // [ksplit][rows][FT]
  float* hs = hp + ksplit * kFfnRows * FT;        // [rows][FT] hidden, f32

  for (int i = tid; i < kFfnRows * D; i += nthr) {
    const int r = i / D;
    xs[i] = r < rows ? to_f(x[(size_t)(m0 + r) * D + i % D]) : 0.f;
  }
  __syncthreads();

  // ---- fc1 over this CTA's FT columns, K split over ksplit groups
  {
    const int c = tid % FT, kp = tid / FT;
    const int i0 = kp * D / ksplit, i1 = (kp + 1) * D / ksplit;
    float a[kFfnRows];
#pragma unroll
    for (int r = 0; r < kFfnRows; ++r) a[r] = 0.f;
    for (int i = i0; i < i1; ++i) {
      const float wv = to_f(w1[(size_t)i * LD1 + f0 + c]);
#pragma unroll
      for (int r = 0; r < kFfnRows; ++r) a[r] += xs[r * D + i] * wv;
    }
#pragma unroll
    for (int r = 0; r < kFfnRows; ++r) hp[(kp * kFfnRows + r) * FT + c] = a[r];
  }
  __syncthreads();
  for (int i = tid; i < kFfnRows * FT; i += nthr) {
    const int r = i / FT, c = i % FT;
    float a = 0.f;
    for (int kp = 0; kp < ksplit; ++kp) a += hp[(kp * kFfnRows + r) * FT + c];
    if (std::is_same<W, int8_t>::value) a *= s1[f0 + c];
    hs[i] = fmaxf(a + to_f(b1[f0 + c]), 0.f);
  }
  __syncthreads();

  // ---- this slice's share of fc2 for every output column
  for (int d = tid; d < D; d += nthr) {
    float a[kFfnRows];
#pragma unroll
    for (int r = 0; r < kFfnRows; ++r) a[r] = 0.f;
    for (int c = 0; c < FT; ++c) {
      const float wv = to_f(w2[(size_t)(f0 + c) * LD2 + d]);
#pragma unroll
      for (int r = 0; r < kFfnRows; ++r) a[r] += hs[r * FT + c] * wv;
    }
    for (int r = 0; r < rows; ++r)
      part[((size_t)s * M + m0 + r) * D + d] = a[r];
  }
}

// s2 null: fp form, the sum starts from res + b2; else int8 form,
// res + b2 + (sum of the unscaled partials) * s2
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ part,
                                  const T* __restrict__ res,
                                  const T* __restrict__ b2,
                                  const float* __restrict__ s2,
                                  T* __restrict__ out, int M, int D, int NS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * D) return;
  const float seed = to_f(res[i]) + to_f(b2[i % D]);
  float a = s2 == nullptr ? seed : 0.f;
  for (int s = 0; s < NS; ++s) a += part[(size_t)s * M * D + i];
  if (s2 != nullptr) a = seed + a * s2[i % D];
  out[i] = from_f<T>(a);
}

template <typename T, typename W>
int launch_ffn_tail(const void* x, const void* res, const void* w1,
                    const float* s1, const void* b1, const void* w2,
                    const float* s2, const void* b2, float* part, void* out,
                    int M, int D, int F, int LD1, int LD2, int FT,
                    cudaStream_t stream) {
  const int ns = F / FT;
  const size_t smem = sizeof(float) * ((size_t)kFfnRows * D +
                                       (size_t)kFfnThreads * kFfnRows +
                                       kFfnRows * FT);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ffn_partial_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(ns, (M + kFfnRows - 1) / kFfnRows);
  ffn_partial_kernel<T, W><<<grid, kFfnThreads, smem, stream>>>(
      (const T*)x, (const W*)w1, s1, (const T*)b1, (const W*)w2, part, M, D,
      F, LD1, LD2, FT);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ffn_reduce_kernel<T><<<(M * D + 255) / 256, 256, 0, stream>>>(
      part, (const T*)res, (const T*)b2, s2, (T*)out, M, D, ns);
  return (int)cudaGetLastError();
}

}  // namespace spt

extern "C" int spt_ffn_tail(int dtype, const void* x, const void* res,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* part, void* out, int M,
                            int D, int F, int FT, void* stream) {
  auto f = dtype == spt::kBF16
               ? spt::launch_ffn_tail<__nv_bfloat16, __nv_bfloat16>
               : spt::launch_ffn_tail<float, float>;
  return f(x, res, w1, nullptr, b1, w2, nullptr, b2, (float*)part, out, M, D,
           F, F, D, FT, (cudaStream_t)stream);
}

extern "C" int spt_ffn_tail_int8(int dtype, const void* x, const void* res,
                                 const void* w1q, const void* s1,
                                 const void* b1, const void* w2q,
                                 const void* s2, const void* b2, void* part,
                                 void* out, int M, int D, int F, int LD1,
                                 int LD2, int FT, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_ffn_tail<__nv_bfloat16, int8_t>
                               : spt::launch_ffn_tail<float, int8_t>;
  return f(x, res, w1q, (const float*)s1, b1, w2q, (const float*)s2, b2,
           (float*)part, out, M, D, F, LD1, LD2, FT, (cudaStream_t)stream);
}
