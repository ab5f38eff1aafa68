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
// into launches.
//
// bf16 (the serving dtype): tensor-core weight streams (csrc/weight_stream
// .cuh, the greedy head's design), each weight read from device memory once
// whatever m is (all of x's rows ride in one CTA's B operand, in row
// groups; narrower column tiles for larger m):
// - ffn_up_kernel: h = relu(x @ w1 (* s1) + b1), or silu(x @ wg (* sg)) *
//   (x @ ws (* ss)) with both weights streamed side by side; W^T is the A
//   operand (int8 widened to bf16 in registers), x's rows B, f32 sums (bf16
//   x bf16 and int8 x bf16 products are exact). h stays f32 in value: it is
//   written as two bf16 terms, hi = bf16(h) and lo = bf16(h - hi) [m][F]
//   (relative residual ~2^-16), so that the down product can take it as a
//   tensor-core operand without a bf16 rounding of h. Where d_ff alone
//   gives few CTAs (int8 rows are half the bytes), K splits into ordered
//   slices whose f32 sums ffn_act_kernel adds in slice order before the
//   activation.
// - ffn_down_kernel: out = h @ w2 with W2^T as A and hi, lo as two B
//   operands (twice the mma count; the work is far below the tensor-core
//   line). A CTA owns a slice of D and walks d_ff in ascending order; where
//   D alone gives too few CTAs, d_ff splits into ordered slices whose f32
//   partials [slice, m, D] ffn_reduce_kernel adds in slice order. One slice
//   writes the output itself: res (+ b2) + sum for the fp forms, res (+ b2)
//   + sum * s2 for the int8 forms (the unscaled sum over d_ff, then s2).
// The tiles, row groups, ring depth and splits come from ops/ffn_tail.py
// ffn_tail_plan (sweeps on the H100 in PERF.md). No atomics: the same
// result every run.
//
// f32 (the parity dtype) keeps the CUDA-core pair: ffn_partial_kernel, one
// CTA per (d_ff slice of FT columns, block of 8 rows), computes the slice's
// hidden values in f32 (K split over thread groups, summed in a fixed
// order) and the slice's f32 contribution h @ w2[slice, :] to all D
// outputs, stored as a partial [slice, m, D]; ffn_reduce_kernel adds the
// partials in slice order (no atomics) and casts once: the fp forms seed
// the sum with res (+ b2), the int8 forms sum the partials and then take
// res (+ b2) + sum * s2 (the TPU kernels' order). int8 weights are read
// with their padded row strides (LD1 = F_pad, LD2 = D_pad); only the true
// F and D columns are used.
#include <type_traits>

#include "common.cuh"
#include "weight_stream.cuh"

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


// ---------------------------------------------------------------------------
// bf16: the tensor-core weight streams
// ---------------------------------------------------------------------------
using bf16_t = __nv_bfloat16;

// the hidden value of one d_ff lane from its unscaled sums: g (the gate,
// or fc1) and sv (the side, gated only), as the TPU kernels order it
template <bool GATED, bool INT8>
__device__ __forceinline__ float ffn_hidden(float g, float sv, int col,
                                            const float* __restrict__ s1,
                                            const float* __restrict__ s3,
                                            const bf16_t* __restrict__ b1) {
  if constexpr (INT8) g *= s1[col];
  if constexpr (GATED) {
    if constexpr (INT8) sv *= s3[col];
    // silu(g) = g * sigmoid(g), the sigmoid as 1 / (1 + exp(-g))
    return g * (1.f / (1.f + expf(-g))) * sv;
  } else {
    return fmaxf(g + to_f(b1[col]), 0.f);
  }
}

__device__ __forceinline__ void store_hi_lo(float h, bf16_t* hi, bf16_t* lo,
                                            size_t o) {
  const bf16_t hh = __float2bfloat16(h);
  hi[o] = hh;
  lo[o] = __float2bfloat16(h - to_f(hh));
}

// the CTA's columns of d_ff over its K slice (blockIdx.y): W is the gate
// (w[0]) and the side (w[1]) when GATED, else fc1 with bias b1. One slice
// writes h as hi + lo; several write their unscaled f32 sums [slice][NW]
// [m][F] to part for ffn_act_kernel.
template <typename W, bool GATED, int NG, int S>
__global__ void __launch_bounds__(kWsThreads) ffn_up_kernel(
    WsArgs<W, GATED ? 2 : 1, 1> a, const float* __restrict__ s1,
    const float* __restrict__ s3, const bf16_t* __restrict__ b1,
    bf16_t* __restrict__ hi, bf16_t* __restrict__ lo,
    float* __restrict__ part, int F) {
  constexpr int NW = GATED ? 2 : 1;
  constexpr bool kInt8 = std::is_same<W, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float acc[NW][NG][4] = {};
  ws_mainloop<W, NW, 1, NG, S>(a, smem, acc);
  const int wid = threadIdx.x >> 5, ctile = wid % a.cw;
  const int rs = wid / a.cw, nrs = 8 / a.cw, ngt = (a.m + 7) / 8;
  const int c0 = blockIdx.x * 16 * a.cw;
  const size_t mf = (size_t)a.m * F;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int ng = rs + i * nrs;
    if (ng >= ngt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = ws_row(ng, e), col = c0 + ws_col<W>(ctile, e);
      if (row >= a.m || col >= F) continue;
      const size_t o = (size_t)row * F + col;
      if (gridDim.y > 1) {
#pragma unroll
        for (int nw = 0; nw < NW; ++nw)
          part[(blockIdx.y * NW + nw) * mf + o] = acc[nw][i][e];
        continue;
      }
      store_hi_lo(ffn_hidden<GATED, kInt8>(acc[0][i][e], acc[NW - 1][i][e],
                                           col, s1, s3, b1),
                  hi, lo, o);
    }
  }
}

// the up product's K-slice sums added in slice order, then the hidden value
// as hi + lo
template <bool GATED, bool INT8>
__global__ void ffn_act_kernel(const float* __restrict__ part, int ns,
                               const float* __restrict__ s1,
                               const float* __restrict__ s3,
                               const bf16_t* __restrict__ b1,
                               bf16_t* __restrict__ hi,
                               bf16_t* __restrict__ lo, int M, int F) {
  constexpr int NW = GATED ? 2 : 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * F) return;
  const size_t mf = (size_t)M * F;
  float g = 0.f, sv = 0.f;
  for (int s = 0; s < ns; ++s) {
    g += part[s * NW * mf + i];
    if constexpr (GATED) sv += part[(s * NW + 1) * mf + i];
  }
  store_hi_lo(ffn_hidden<GATED, INT8>(g, sv, i % F, s1, s3, b1), hi, lo, i);
}

// out = seed + h @ w2 over the CTA's columns of D and its slice of d_ff
// (blockIdx.y); several slices write f32 partials for ffn_reduce_kernel
template <typename W, int NG, int S>
__global__ void __launch_bounds__(kWsThreads) ffn_down_kernel(
    WsArgs<W, 1, 2> a, const bf16_t* __restrict__ res,
    const bf16_t* __restrict__ b2, const float* __restrict__ s2,
    bf16_t* __restrict__ out, float* __restrict__ part, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  float acc[1][NG][4] = {};
  ws_mainloop<W, 1, 2, NG, S>(a, smem, acc);
  const int wid = threadIdx.x >> 5, ctile = wid % a.cw;
  const int rs = wid / a.cw, nrs = 8 / a.cw, ngt = (a.m + 7) / 8;
  const int c0 = blockIdx.x * 16 * a.cw;
  const bool split = gridDim.y > 1;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int ng = rs + i * nrs;
    if (ng >= ngt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = ws_row(ng, e), col = c0 + ws_col<W>(ctile, e);
      if (row >= a.m || col >= D) continue;
      const size_t o = (size_t)row * D + col;
      if (split) {
        part[(size_t)blockIdx.y * a.m * D + o] = acc[0][i][e];
        continue;
      }
      const float seed = b2 == nullptr ? to_f(res[o])
                                       : to_f(res[o]) + to_f(b2[col]);
      out[o] = __float2bfloat16(s2 == nullptr ? seed + acc[0][i][e]
                                              : seed + acc[0][i][e] * s2[col]);
    }
  }
}

// kernel pointers by (NG, S): S = 4 with NG 1, 2 or 4, S = 3 (wide stages:
// two CTAs an SM) with NG 1, S = 2 (wide m) with NG 4
template <typename W, bool GATED>
auto up_kernel(int ng, int s) -> decltype(&ffn_up_kernel<W, GATED, 1, 4>) {
  if (s == 3) return ng == 1 ? &ffn_up_kernel<W, GATED, 1, 3> : nullptr;
  if (s == 2) return ng == 4 ? &ffn_up_kernel<W, GATED, 4, 2> : nullptr;
  if (s != 4) return nullptr;
  return ng == 1 ? &ffn_up_kernel<W, GATED, 1, 4>
         : ng == 2 ? &ffn_up_kernel<W, GATED, 2, 4>
         : ng == 4 ? &ffn_up_kernel<W, GATED, 4, 4> : nullptr;
}

template <typename W>
auto down_kernel(int ng, int s) -> decltype(&ffn_down_kernel<W, 1, 4>) {
  if (s == 3) return ng == 1 ? &ffn_down_kernel<W, 1, 3> : nullptr;
  if (s == 2) return ng == 4 ? &ffn_down_kernel<W, 4, 2> : nullptr;
  if (s != 4) return nullptr;
  return ng == 1 ? &ffn_down_kernel<W, 1, 4>
         : ng == 2 ? &ffn_down_kernel<W, 2, 4>
         : ng == 4 ? &ffn_down_kernel<W, 4, 4> : nullptr;
}

constexpr int kMaxSmem = 232448;   // the H100's opt-in limit a block

// a (cw, NG) pair covers m rows: 8 / cw row sets of NG n8 groups
inline bool ws_covers(int m, int cw, int ng) {
  return (cw == 1 || cw == 2 || cw == 4 || cw == 8) &&
         ((m + 7) / 8 + 8 / cw - 1) / (8 / cw) <= ng;
}

template <typename W, bool GATED>
int launch_ffn_tc(const void* x, const void* res, const void* w1,
                  const float* s1, const void* b1, const void* w3,
                  const float* s3, const void* w2, const float* s2,
                  const void* b2, bf16_t* hbuf, float* work, void* out,
                  int M, int D, int F, int LD1, int LD2, int up_cw,
                  int up_ng, int up_s, int up_kslice, int dn_cw, int dn_ng,
                  int dn_s, int dn_kslice, cudaStream_t stream) {
  constexpr int NW = GATED ? 2 : 1;
  constexpr bool kInt8 = std::is_same<W, int8_t>::value;
  auto up = up_kernel<W, GATED>(up_ng, up_s);
  auto down = down_kernel<W>(dn_ng, dn_s);
  const int up_smem = up_s * ws_stage_bytes<W, NW, 1>(up_cw, M);
  const int dn_smem = dn_s * ws_stage_bytes<W, 1, 2>(dn_cw, M);
  const int up_ns = up_kslice > 0 ? (D + up_kslice - 1) / up_kslice : 0;
  const int dn_ns = dn_kslice > 0 ? (F + dn_kslice - 1) / dn_kslice : 0;
  if (up == nullptr || down == nullptr || !ws_covers(M, up_cw, up_ng) ||
      !ws_covers(M, dn_cw, dn_ng) || up_ns == 0 || dn_ns == 0 ||
      up_kslice % kWsK != 0 || dn_kslice % kWsK != 0 ||
      up_smem > kMaxSmem || dn_smem > kMaxSmem || D % 8 != 0 ||
      F % 8 != 0 || ((up_ns > 1 || dn_ns > 1) && work == nullptr))
    return (int)cudaErrorInvalidValue;
  WsArgs<W, NW, 1> ua;
  ua.w[0] = (const W*)w1;
  if constexpr (GATED) ua.w[1] = (const W*)w3;
  ua.x[0] = (const bf16_t*)x;
  ua.ldw = LD1, ua.ldx = D, ua.m = M, ua.K = D, ua.cw = up_cw;
  ua.kslice = up_kslice;
  bf16_t* hi = hbuf;
  bf16_t* lo = hbuf + (size_t)M * F;
  cudaError_t e = cudaFuncSetAttribute(
      up, cudaFuncAttributeMaxDynamicSharedMemorySize, up_smem);
  if (e != cudaSuccess) return (int)e;
  dim3 ugrid((F + 16 * up_cw - 1) / (16 * up_cw), up_ns);
  up<<<ugrid, kWsThreads, up_smem, stream>>>(
      ua, s1, s3, (const bf16_t*)b1, hi, lo, work, F);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (up_ns > 1) {   // the slices' sums, then h (work is free after)
    ffn_act_kernel<GATED, kInt8><<<(M * F + 255) / 256, 256, 0, stream>>>(
        work, up_ns, s1, s3, (const bf16_t*)b1, hi, lo, M, F);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  WsArgs<W, 1, 2> da;
  da.w[0] = (const W*)w2;
  da.x[0] = hi, da.x[1] = lo;
  da.ldw = LD2, da.ldx = F, da.m = M, da.K = F, da.cw = dn_cw;
  da.kslice = dn_kslice;
  e = cudaFuncSetAttribute(down, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dn_smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((D + 16 * dn_cw - 1) / (16 * dn_cw), dn_ns);
  down<<<grid, kWsThreads, dn_smem, stream>>>(
      da, (const bf16_t*)res, (const bf16_t*)b2, s2, (bf16_t*)out, work, D);
  e = cudaGetLastError();
  if (e != cudaSuccess || dn_ns == 1) return (int)e;
  ffn_reduce_kernel<bf16_t><<<(M * D + 255) / 256, 256, 0, stream>>>(
      work, (const bf16_t*)res, (const bf16_t*)b2, s2, (bf16_t*)out, M, D,
      dn_ns);
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

// bf16, the tensor-core streams. form: 0 ffn_tail, 1 ffn_tail_int8, 2
// ffn_tail_gated, 3 ffn_tail_gated_int8 (w1 / w3 the gate / side there; s*
// null for the fp forms, b* null for the gated ones). hbuf [2][M][F] bf16
// (h as hi, lo); work f32 scratch for the split products' partials, the up
// product's [D / up_kslice][1 or 2][M][F] and then the down product's
// [F / dn_kslice][M][D] (null when neither splits). The plan (cw, NG,
// stages, slice of each product) is ops/ffn_tail.py ffn_tail_plan's.
extern "C" int spt_ffn_tail_tc(
    int form, const void* x, const void* res, const void* w1, const void* s1,
    const void* b1, const void* w3, const void* s3, const void* w2,
    const void* s2, const void* b2, void* hbuf, void* work, void* out, int M,
    int D, int F, int LD1, int LD2, int up_cw, int up_ng, int up_s,
    int up_kslice, int dn_cw, int dn_ng, int dn_s, int dn_kslice,
    void* stream) {
  using spt::bf16_t;
  auto f = form == 0 ? spt::launch_ffn_tc<bf16_t, false>
           : form == 1 ? spt::launch_ffn_tc<int8_t, false>
           : form == 2 ? spt::launch_ffn_tc<bf16_t, true>
           : form == 3 ? spt::launch_ffn_tc<int8_t, true> : nullptr;
  if (f == nullptr) return (int)cudaErrorInvalidValue;
  return f(x, res, w1, (const float*)s1, b1, w3, (const float*)s3, w2,
           (const float*)s2, b2, (spt::bf16_t*)hbuf, (float*)work, out, M, D,
           F, LD1, LD2, up_cw, up_ng, up_s, up_kslice, dn_cw, dn_ng, dn_s,
           dn_kslice, (cudaStream_t)stream);
}
