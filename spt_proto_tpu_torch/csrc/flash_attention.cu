// Dense causal flash attention: the forward (o and the softmax statistics
// l, m the backward needs) and the two backward kernels, dq and dk/dv.
//
// Replaces the stock TPU kernel jax/experimental/pallas/ops/tpu/
// flash_attention.py (jax 0.9.0), which spt_proto_tpu/layers/attention.py:75
// calls for every dense causal attention under attn_impl='pallas':
//   flash_fwd_kernel  <- _flash_attention_kernel (:331, :342), launched by
//                        _flash_attention_impl (:589, pallas_call :758)
//   flash_dkv_kernel  <- _flash_attention_dkv_kernel (:796), launched by
//                        _flash_attention_bwd_dkv (:941, pallas_call :1121)
//   flash_dq_kernel   <- _flash_attention_dq_kernel (:1146), launched by
//                        _flash_attention_bwd_dq (:1287, pallas_call :1456)
// The stock kernel's block sizes (128 everywhere), its 128-lane broadcast
// of l and m and its optional attention bias / segment ids / ds output are
// TPU layout or unused by the layer: l and m are [BH, S] f32 here.
//
// Numerics follow the stock kernel: logits s = (q k^T) * scale in f32, the
// mask value -0.7 * FLT_MAX added where col > row (DEFAULT_MASK_VALUE,
// :29, :434), online softmax in f32 with the unnormalised p rounded to v's
// dtype before the PV product (:471); the backward recomputes
// p = exp(s - m) * (1 / l) (:897), di = sum(o * do) comes from the caller
// (plain torch, as the stock VJP computes it outside its kernels, :271),
// ds = (do v^T - di) * p * scale, and
//   dv = p^T do   (p rounded to do's dtype, :900)
//   dk = ds^T q   (ds rounded to do's dtype, :918)
//   dq = ds k     (ds rounded to k's dtype, :1258).
//
// Bound on the H100: at OPT-125M's training shape (8 x 12 heads, S 512,
// d 64, bf16) the forward reads q, k, v and writes o, l, m: 6.3 MB, 1.9 us;
// its causal products are 2 * 96 * 512^2 * 64 = 3.2 GFLOP, 3.3 us at the
// bf16 tensor-core peak, so a tensor-core kernel would be compute-bound at
// S >= 512 (the backward does 2.5x the products over 2x the bytes).
// These kernels compute in f32 on the CUDA cores (67 TFLOP/s peak), the
// structure of csrc/block_sparse_attention.cu with the causal walk in place
// of a selection list; mma.sync / wgmma tiles come in a later change.
//
// Design. Forward: one CTA per (batch*head, 64-query sub-tile); it walks
// the 128-key tiles from 0 to the one holding its last row (tiles wholly
// above the diagonal skipped, the stock's below_or_on_diag, :325), stages
// K^T and V in shared memory as f32, and keeps m, l and the output rows in
// registers (256 threads: 4 rows x 8 score columns and 4 x D/16 output
// columns each); the P tile reuses the K^T buffer. dq: one CTA per
// (batch*head, 64-query sub-tile), the same walk, S and dP micro-tiles in
// registers, dS through the V^T buffer, dq accumulated in registers. dk/dv:
// one CTA per (batch*head, 128-key tile), walking the query rows from the
// tile's first row to S in chunks of 32 (rows before the tile see none of
// it), dk and dv in registers (8 keys x D/16 columns a thread). Every output
// element is written by one thread once: no atomics, runs are
// deterministic.
#include "common.cuh"

#include <cfloat>

namespace spt {
namespace flash {

constexpr int kSub = 64;                  // query rows per CTA (fwd, dq)
constexpr int kBK = 128;                  // key rows per tile
constexpr int kPad = kBK + 4;             // padded row of a transposed tile
constexpr int kR = 32;                    // query rows per dk/dv chunk
constexpr float kMask = -0.7f * FLT_MAX;  // DEFAULT_MASK_VALUE

// scaled logit with the mask value added (the stock kernel adds it; at
// this magnitude the sum rounds to the mask value itself)
__device__ __forceinline__ float logit(float dot, float scale, bool valid) {
  const float s = dot * scale;
  return valid ? s : s + kMask;
}

template <typename T, int D>
__global__ void __launch_bounds__(256) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ l_out,
    float* __restrict__ m_out, int S, float scale) {
  constexpr int DJ = D / 16;              // output columns per thread
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                         // [kSub][D]
  float* kt = qs + kSub * D;              // [D][kPad]  K^T, then P [kSub][kPad]
  float* vs = kt + D * kPad;              // [kBK][D]

  const int bh = blockIdx.y, row0 = blockIdx.x * kSub;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t off = (size_t)bh * S * D;

  for (int i = tid; i < kSub * D; i += blockDim.x)
    qs[i] = to_f(q[off + (size_t)row0 * D + i]);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int col0 = 0; col0 <= row0 + kSub - 1; col0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * D; i += blockDim.x) {
      const int c = i / D, d = i % D;
      kt[d * kPad + c] = to_f(k[off + (size_t)(col0 + c) * D + d]);
      vs[i] = to_f(v[off + (size_t)col0 * D + i]);
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * D + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = kt[d * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += qv[i] * kv[j];
    }
    __syncthreads();    // K^T is read out; its buffer now takes P

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = logit(s[i][j], scale, col0 + tx + 16 * j <= r);
        mx = fmaxf(mx, s[i][j]);
      }
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - mn);
        rs += p;
        kt[(ty * 4 + i) * kPad + tx + 16 * j] = rt<T>(p);
      }
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o2);
      l[i] = alpha * l[i] + rs;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = kt[(ty * 4 + i) * kPad + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l[i];
    const size_t r = (size_t)(row0 + ty * 4 + i);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[off + r * D + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    if (tx == 0) {
      l_out[(size_t)bh * S + r] = l[i];
      m_out[(size_t)bh * S + r] = m[i];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ l_in, const float* __restrict__ m_in,
    const float* __restrict__ di, T* __restrict__ dq, int S, float scale) {
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                         // [kSub][D]
  float* gs = qs + kSub * D;              // [kSub][D]   do
  float* kt = gs + kSub * D;              // [D][kPad]   K^T
  float* vt = kt + D * kPad;              // [D][kPad]   V^T, then dS [kSub][kPad]
  float* ms = vt + D * kPad;              // [kSub]      m
  float* il = ms + kSub;                  // [kSub]      1 / l
  float* dis = il + kSub;                 // [kSub]      di

  const int bh = blockIdx.y, row0 = blockIdx.x * kSub;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t off = (size_t)bh * S * D;

  for (int i = tid; i < kSub * D; i += blockDim.x) {
    qs[i] = to_f(q[off + (size_t)row0 * D + i]);
    gs[i] = to_f(g[off + (size_t)row0 * D + i]);
  }
  if (tid < kSub) {
    const size_t r = (size_t)bh * S + row0 + tid;
    ms[tid] = m_in[r];
    il[tid] = 1.f / l_in[r];
    dis[tid] = di[r];
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int col0 = 0; col0 <= row0 + kSub - 1; col0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * D; i += blockDim.x) {
      const int c = i / D, d = i % D;
      const size_t src = off + (size_t)(col0 + c) * D + d;
      kt[d * kPad + c] = to_f(k[src]);
      vt[d * kPad + c] = to_f(v[src]);
    }
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * D + d];
        gv[i] = gs[(ty * 4 + i) * D + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = kt[d * kPad + tx + 16 * j];
        vv[j] = vt[d * kPad + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += gv[i] * vv[j];
        }
    }
    __syncthreads();    // V^T is read out; its buffer now takes dS

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty * 4 + i, r = row0 + rl;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = logit(s[i][j], scale, col0 + tx + 16 * j <= r);
        const float p = expf(x - ms[rl]) * il[rl];
        vt[rl * kPad + tx + 16 * j] =
            rt<T>((dp[i][j] - dis[rl]) * p * scale);
      }
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = vt[(ty * 4 + i) * kPad + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = kt[(tx + 16 * j) * kPad + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += dsv[i] * kv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = (size_t)(row0 + ty * 4 + i);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[off + r * D + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ l_in, const float* __restrict__ m_in,
    const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
    int S, float scale) {
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* kt = sm;                         // [D][kPad]   K^T
  float* vt = kt + D * kPad;              // [D][kPad]   V^T
  float* qs = vt + D * kPad;              // [kR][D]
  float* gs = qs + kR * D;                // [kR][D]     do
  float* ps = gs + kR * D;                // [kR][kPad]  p in do's dtype
  float* dss = ps + kR * kPad;            // [kR][kPad]  ds in do's dtype
  float* ms = dss + kR * kPad;            // [kR]        m
  float* il = ms + kR;                    // [kR]        1 / l
  float* dis = il + kR;                   // [kR]        di

  const int bh = blockIdx.y, col0 = blockIdx.x * kBK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t off = (size_t)bh * S * D;

  for (int i = tid; i < kBK * D; i += blockDim.x) {
    const int c = i / D, d = i % D;
    const size_t src = off + (size_t)(col0 + c) * D + d;
    kt[d * kPad + c] = to_f(k[src]);
    vt[d * kPad + c] = to_f(v[src]);
  }

  // keys ty * 8 + i, columns tx + 16 j
  float adk[8][DJ], adv[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int r0 = col0; r0 < S; r0 += kR) {
    __syncthreads();
    for (int i = tid; i < kR * D; i += blockDim.x) {
      qs[i] = to_f(q[off + (size_t)r0 * D + i]);
      gs[i] = to_f(g[off + (size_t)r0 * D + i]);
    }
    if (tid < kR) {
      const size_t r = (size_t)bh * S + r0 + tid;
      ms[tid] = m_in[r];
      il[tid] = 1.f / l_in[r];
      dis[tid] = di[r];
    }
    __syncthreads();

    // rows ty * 2 + i, keys tx + 16 j
    float s[2][8], dp[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[2], gv[2], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qv[i] = qs[(ty * 2 + i) * D + d];
        gv[i] = gs[(ty * 2 + i) * D + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = kt[d * kPad + tx + 16 * j];
        vv[j] = vt[d * kPad + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += gv[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = logit(s[i][j], scale, col0 + tx + 16 * j <= r0 + rl);
        const float p = expf(x - ms[rl]) * il[rl];
        ps[rl * kPad + tx + 16 * j] = rt<T>(p);
        dss[rl * kPad + tx + 16 * j] =
            rt<T>((dp[i][j] - dis[rl]) * p * scale);
      }
    }
    __syncthreads();

    for (int r = 0; r < kR; ++r) {
      float pv[8], dsv[8], gv[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        pv[i] = ps[r * kPad + ty * 8 + i];
        dsv[i] = dss[r * kPad + ty * 8 + i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        gv[j] = gs[r * D + tx + 16 * j];
        qv[j] = qs[r * D + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          adv[i][j] += pv[i] * gv[j];
          adk[i][j] += dsv[i] * qv[j];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t c = (size_t)(col0 + ty * 8 + i);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + c * D + tx + 16 * j] = from_f<T>(adk[i][j]);
      dv[off + c * D + tx + 16 * j] = from_f<T>(adv[i][j]);
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* l, float* m, int BH, int S, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kSub * D + D * kPad + kBK * D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_kernel<T, D><<<dim3(S / kSub, BH), 256, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, l, m, S, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* g,
               const float* l, const float* m, const float* di, void* dq,
               void* dk, void* dv, int BH, int S, float scale,
               cudaStream_t stream) {
  cudaError_t e;
  if (dq != nullptr) {
    const size_t smem =
        sizeof(float) * (2 * kSub * D + 2 * D * kPad + 3 * kSub);
    e = cudaFuncSetAttribute(flash_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_dq_kernel<T, D><<<dim3(S / kSub, BH), 256, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)g, l, m, di,
        (T*)dq, S, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (dk != nullptr) {
    const size_t smem = sizeof(float) *
        (2 * D * kPad + 2 * kR * D + 2 * kR * kPad + 3 * kR);
    e = cudaFuncSetAttribute(flash_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_dkv_kernel<T, D><<<dim3(S / kBK, BH), 256, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)g, l, m, di,
        (T*)dk, (T*)dv, S, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace spt

// q, k, v, o [BH, S, D] contiguous, D 64 or 128, S a multiple of 128,
// causal; l and m [BH, S] f32.
extern "C" int spt_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* o, void* l, void* m,
                             int BH, int S, int D, float scale,
                             void* stream) {
  using namespace spt::flash;
  auto f = dtype == spt::kBF16
               ? (D == 64 ? launch_fwd<__nv_bfloat16, 64>
                          : launch_fwd<__nv_bfloat16, 128>)
               : (D == 64 ? launch_fwd<float, 64> : launch_fwd<float, 128>);
  return f(q, k, v, o, (float*)l, (float*)m, BH, S, scale,
           (cudaStream_t)stream);
}

// The backward: dq when `dq` is not null, dk and dv when `dk` is not null.
// `g` is the output gradient, l, m and di [BH, S] f32.
extern "C" int spt_flash_bwd(int dtype, const void* q, const void* k,
                             const void* v, const void* g, const void* l,
                             const void* m, const void* di, void* dq,
                             void* dk, void* dv, int BH, int S, int D,
                             float scale, void* stream) {
  using namespace spt::flash;
  auto f = dtype == spt::kBF16
               ? (D == 64 ? launch_bwd<__nv_bfloat16, 64>
                          : launch_bwd<__nv_bfloat16, 128>)
               : (D == 64 ? launch_bwd<float, 64> : launch_bwd<float, 128>);
  return f(q, k, v, g, (const float*)l, (const float*)m, (const float*)di,
           dq, dk, dv, BH, S, scale, (cudaStream_t)stream);
}
