// Fused decode FFN tail: out = res + relu(x @ w1 + b1) @ w2 + b2 at skinny
// m (the decode batch), with the fc1 hidden values kept in f32.
//
// Replaces the TPU kernel spt_proto_tpu/ops/pallas/ffn_tail.py ffn_tail
// (_ffn_kernel).
//
// Bound on the H100: memory. The work streams both weight matrices once:
// OPT-125M 2 x 768 x 3072 bf16 = 9.4 MB, 2.8 us at 3.35 TB/s; OPT-1.3B
// 67 MB, 20 us. At m = 8 the products are 2 x 8 x D x F x 2 operations,
// far below the tensor-core line.
//
// Design: the TPU kernel walks d_ff tiles in order and carries an f32
// accumulator across grid steps; CTAs run in no order, so the work splits
// in two launches. ffn_partial_kernel: one CTA per (d_ff slice of FT
// columns, block of 8 rows) computes h = relu(x @ w1[:, slice] + b1) in
// f32 (K split over thread groups, summed in a fixed order), then that
// slice's f32 contribution h @ w2[slice, :] to all D outputs, and stores
// it as a partial [slice, m, D]. ffn_reduce_kernel seeds each output with
// res + b2 and adds the partials in slice order, so the result does not
// change from run to run (no atomics), and casts to x's dtype once.
#include "common.cuh"

namespace spt {

constexpr int kFfnRows = 8;      // rows of x per CTA
constexpr int kFfnThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kFfnThreads) ffn_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2,
    float* __restrict__ part, int M, int D, int F, int FT) {
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
      const float wv = to_f(w1[(size_t)i * F + f0 + c]);
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
    hs[i] = fmaxf(a + to_f(b1[f0 + c]), 0.f);
  }
  __syncthreads();

  // ---- this slice's share of fc2 for every output column
  for (int d = tid; d < D; d += nthr) {
    float a[kFfnRows];
#pragma unroll
    for (int r = 0; r < kFfnRows; ++r) a[r] = 0.f;
    for (int c = 0; c < FT; ++c) {
      const float wv = to_f(w2[(size_t)(f0 + c) * D + d]);
#pragma unroll
      for (int r = 0; r < kFfnRows; ++r) a[r] += hs[r * FT + c] * wv;
    }
    for (int r = 0; r < rows; ++r)
      part[((size_t)s * M + m0 + r) * D + d] = a[r];
  }
}

template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ part,
                                  const T* __restrict__ res,
                                  const T* __restrict__ b2,
                                  T* __restrict__ out, int M, int D, int NS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * D) return;
  float a = to_f(res[i]) + to_f(b2[i % D]);
  for (int s = 0; s < NS; ++s) a += part[(size_t)s * M * D + i];
  out[i] = from_f<T>(a);
}

template <typename T>
int launch_ffn_tail(const void* x, const void* res, const void* w1,
                    const void* b1, const void* w2, const void* b2,
                    float* part, void* out, int M, int D, int F, int FT,
                    cudaStream_t stream) {
  const int ns = F / FT;
  const size_t smem = sizeof(float) * ((size_t)kFfnRows * D +
                                       (size_t)kFfnThreads * kFfnRows +
                                       kFfnRows * FT);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ffn_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(ns, (M + kFfnRows - 1) / kFfnRows);
  ffn_partial_kernel<T><<<grid, kFfnThreads, smem, stream>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, part, M, D, F,
      FT);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ffn_reduce_kernel<T><<<(M * D + 255) / 256, 256, 0, stream>>>(
      part, (const T*)res, (const T*)b2, (T*)out, M, D, ns);
  return (int)cudaGetLastError();
}

}  // namespace spt

extern "C" int spt_ffn_tail(int dtype, const void* x, const void* res,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* part, void* out, int M,
                            int D, int F, int FT, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_ffn_tail<__nv_bfloat16>
                               : spt::launch_ffn_tail<float>;
  return f(x, res, w1, b1, w2, b2, (float*)part, out, M, D, F, FT,
           (cudaStream_t)stream);
}
