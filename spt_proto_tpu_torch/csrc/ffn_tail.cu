// Fused decode FFN tail at skinny m (the decode batch), with the hidden
// values kept in f32:
//   fp weights:    out = res + relu(x @ w1 + b1) @ w2 + b2
//   int8 weights:  out = res + b2 + (relu((x @ w1q) * s1 + b1) @ w2q) * s2
//   gated (SwiGLU), fp:   out = res + (silu(x @ wg) * (x @ ws)) @ wd
//   gated, int8:          out = res + ((silu((x @ wgq) * sg)
//                                       * ((x @ wsq) * ss)) @ wdq) * sd
//
// Replaces the TPU kernels spt_proto_tpu/ops/pallas/ffn_tail.py ffn_tail
// (_ffn_kernel), ffn_tail_int8 (_ffn_int8_kernel), ffn_tail_gated
// (_gated_kernel) and ffn_tail_gated_int8 (_gated_int8_kernel).
//
// Bound on the H100: memory. The work streams the weight matrices once:
// OPT-125M 2 x 768 x 3072 bf16 = 9.4 MB, 2.8 us at 3.35 TB/s (int8: 4.7 MB,
// 1.4 us); OPT-1.3B 67 MB, 20 us (int8: 34 MB, 10 us); the gated form at
// LLaMA-7B 3 x 4096 x 11008 bf16 = 271 MB, 81 us (int8 40 us), at
// Llama-3-8B (d_ff 14336) 352 MB, 105 us (int8 53 us). At m = 8 the
// products are 2-3 x 2 x 8 x D x F operations, far below the tensor-core
// line.
//
// Design: the TPU kernels walk d_ff tiles in order and carry an f32
// accumulator across grid steps; CTAs run in no order, so the work splits
// in two launches. ffn_partial_kernel: one CTA per (d_ff slice of FT
// columns, block of 8 rows) computes the slice's hidden values in f32 (K
// split over thread groups, summed in a fixed order): h = relu(x @ w1 (*
// s1) + b1), or for the gated form h = silu(x @ wg (* sg)) * (x @ ws (*
// ss)), both products read in one pass over K. Then it computes that
// slice's f32 contribution h @ w2[slice, :] to all D outputs (unscaled for
// int8 weights) and stores it as a partial [slice, m, D]. The reduce kernel
// adds the partials in slice order, so the result does not change from run
// to run (no atomics), and casts to x's dtype once: the fp forms seed the
// sum with res (+ b2), the int8 forms sum the partials and then take res
// (+ b2) + sum * s2 (the TPU kernels' order). int8 weights are read with
// their padded row strides (LD1 = F_pad, LD2 = D_pad); only the true F and
// D columns are touched.
#include <type_traits>

#include "common.cuh"

namespace spt {

constexpr int kFfnRows = 8;      // rows of x per CTA
constexpr int kFfnThreads = 256;

// the kFfnRows values of x at one K index, staged [D][kFfnRows] in x's own
// dtype: one 16-byte shared load (bf16) or two (f32) feed all rows
__device__ __forceinline__ void load_rows(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load_rows(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// W is T (fp weights, s1/s3 unused) or int8_t (int8 weights, s1/s3 the
// per-column scales of w1/w3). GATED: w1 is the gate, w3 the side (same
// row stride LD1), b1 unused; else w1 is fc1 with bias b1 and w3 unused.
template <typename T, typename W, bool GATED>
__global__ void __launch_bounds__(kFfnThreads) ffn_partial_kernel(
    const T* __restrict__ x, const W* __restrict__ w1,
    const float* __restrict__ s1, const T* __restrict__ b1,
    const W* __restrict__ w3, const float* __restrict__ s3,
    const W* __restrict__ w2, float* __restrict__ part, int M, int D, int F,
    int LD1, int LD2, int FT) {
  constexpr bool kInt8 = std::is_same<W, int8_t>::value;
  const int s = blockIdx.x, m0 = blockIdx.y * kFfnRows;
  const int rows = min(kFfnRows, M - m0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int f0 = s * FT, ksplit = nthr / FT;

  // x's rows first (16-byte aligned), in x's own dtype (exact; in bf16
  // that halves the largest buffer, 64 KB at D = 4096, so more CTAs fit an
  // SM), then the f32 scratch
  extern __shared__ __align__(16) float sm[];
  T* xs = reinterpret_cast<T*>(sm);                        // [D][rows]
  float* hp = reinterpret_cast<float*>(xs + (size_t)kFfnRows * D);
                                                  // [ksplit][rows][FT]
  float* hp3 = hp + ksplit * kFfnRows * FT;       // gated: the side's
  float* hs = hp3 + (GATED ? ksplit * kFfnRows * FT : 0);  // [rows][FT]

  for (int i = tid; i < kFfnRows * D; i += nthr) {
    const int r = i / D, k = i % D;
    xs[k * kFfnRows + r] =
        r < rows ? x[(size_t)(m0 + r) * D + k] : from_f<T>(0.f);
  }
  __syncthreads();

  // ---- fc1 (or gate and side) over this CTA's FT columns, K split over
  // ksplit groups
  {
    const int c = tid % FT, kp = tid / FT;
    const int i0 = kp * D / ksplit, i1 = (kp + 1) * D / ksplit;
    float a[kFfnRows], a3[kFfnRows];
#pragma unroll
    for (int r = 0; r < kFfnRows; ++r) a[r] = a3[r] = 0.f;
    for (int i = i0; i < i1; ++i) {
      const float wv = to_f(w1[(size_t)i * LD1 + f0 + c]);
      const float wv3 = GATED ? to_f(w3[(size_t)i * LD1 + f0 + c]) : 0.f;
      float xv[kFfnRows];
      load_rows(xs + (size_t)i * kFfnRows, xv);
#pragma unroll
      for (int r = 0; r < kFfnRows; ++r) {
        a[r] += xv[r] * wv;
        if (GATED) a3[r] += xv[r] * wv3;
      }
    }
#pragma unroll
    for (int r = 0; r < kFfnRows; ++r) {
      hp[(kp * kFfnRows + r) * FT + c] = a[r];
      if (GATED) hp3[(kp * kFfnRows + r) * FT + c] = a3[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < kFfnRows * FT; i += nthr) {
    const int r = i / FT, c = i % FT;
    float a = 0.f, a3 = 0.f;
    for (int kp = 0; kp < ksplit; ++kp) {
      a += hp[(kp * kFfnRows + r) * FT + c];
      if (GATED) a3 += hp3[(kp * kFfnRows + r) * FT + c];
    }
    if (kInt8) a *= s1[f0 + c];
    if (GATED) {
      if (kInt8) a3 *= s3[f0 + c];
      // silu(a) = a * sigmoid(a), the sigmoid as 1 / (1 + exp(-a))
      hs[i] = a * (1.f / (1.f + expf(-a))) * a3;
    } else {
      hs[i] = fmaxf(a + to_f(b1[f0 + c]), 0.f);
    }
  }
  __syncthreads();

  // ---- this slice's share of fc2 (down) for every output column
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

// s2 null: fp forms, the sum starts from res (+ b2); else int8 forms,
// res (+ b2) + (sum of the unscaled partials) * s2. b2 null: gated, no bias
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ part,
                                  const T* __restrict__ res,
                                  const T* __restrict__ b2,
                                  const float* __restrict__ s2,
                                  T* __restrict__ out, int M, int D, int NS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * D) return;
  const float seed = b2 == nullptr ? to_f(res[i])
                                   : to_f(res[i]) + to_f(b2[i % D]);
  float a = s2 == nullptr ? seed : 0.f;
  for (int s = 0; s < NS; ++s) a += part[(size_t)s * M * D + i];
  if (s2 != nullptr) a = seed + a * s2[i % D];
  out[i] = from_f<T>(a);
}

template <typename T, typename W, bool GATED>
int launch_ffn_tail(const void* x, const void* res, const void* w1,
                    const float* s1, const void* b1, const void* w3,
                    const float* s3, const void* w2, const float* s2,
                    const void* b2, float* part, void* out, int M, int D,
                    int F, int LD1, int LD2, int FT, cudaStream_t stream) {
  const int ns = F / FT;
  const size_t hp_n = (size_t)kFfnThreads * kFfnRows;   // ksplit * FT rows
  const size_t smem = sizeof(float) * ((GATED ? 2 : 1) * hp_n +
                                       kFfnRows * FT) +
                      sizeof(T) * (size_t)kFfnRows * D;
  auto kernel = ffn_partial_kernel<T, W, GATED>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(ns, (M + kFfnRows - 1) / kFfnRows);
  kernel<<<grid, kFfnThreads, smem, stream>>>(
      (const T*)x, (const W*)w1, s1, (const T*)b1, (const W*)w3, s3,
      (const W*)w2, part, M, D, F, LD1, LD2, FT);
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
               ? spt::launch_ffn_tail<__nv_bfloat16, __nv_bfloat16, false>
               : spt::launch_ffn_tail<float, float, false>;
  return f(x, res, w1, nullptr, b1, nullptr, nullptr, w2, nullptr, b2,
           (float*)part, out, M, D, F, F, D, FT, (cudaStream_t)stream);
}

extern "C" int spt_ffn_tail_int8(int dtype, const void* x, const void* res,
                                 const void* w1q, const void* s1,
                                 const void* b1, const void* w2q,
                                 const void* s2, const void* b2, void* part,
                                 void* out, int M, int D, int F, int LD1,
                                 int LD2, int FT, void* stream) {
  auto f = dtype == spt::kBF16
               ? spt::launch_ffn_tail<__nv_bfloat16, int8_t, false>
               : spt::launch_ffn_tail<float, int8_t, false>;
  return f(x, res, w1q, (const float*)s1, b1, nullptr, nullptr, w2q,
           (const float*)s2, b2, (float*)part, out, M, D, F, LD1, LD2, FT,
           (cudaStream_t)stream);
}

extern "C" int spt_ffn_tail_gated(int dtype, const void* x, const void* res,
                                  const void* wg, const void* ws,
                                  const void* wd, void* part, void* out,
                                  int M, int D, int F, int FT, void* stream) {
  auto f = dtype == spt::kBF16
               ? spt::launch_ffn_tail<__nv_bfloat16, __nv_bfloat16, true>
               : spt::launch_ffn_tail<float, float, true>;
  return f(x, res, wg, nullptr, nullptr, ws, nullptr, wd, nullptr, nullptr,
           (float*)part, out, M, D, F, F, D, FT, (cudaStream_t)stream);
}

extern "C" int spt_ffn_tail_gated_int8(
    int dtype, const void* x, const void* res, const void* wgq,
    const void* sg, const void* wsq, const void* ss, const void* wdq,
    const void* sd, void* part, void* out, int M, int D, int F, int LD1,
    int LD2, int FT, void* stream) {
  auto f = dtype == spt::kBF16
               ? spt::launch_ffn_tail<__nv_bfloat16, int8_t, true>
               : spt::launch_ffn_tail<float, int8_t, true>;
  return f(x, res, wgq, (const float*)sg, nullptr, wsq, (const float*)ss,
           wdq, (const float*)sd, nullptr, (float*)part, out, M, D, F, LD1,
           LD2, FT, (cudaStream_t)stream);
}
