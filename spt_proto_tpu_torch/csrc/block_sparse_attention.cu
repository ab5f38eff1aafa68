// Block-sparse causal attention over PQ-selected key tiles: the forward
// (with the per-row log-sum-exp the backward needs) and the two backward
// kernels, dq and dk/dv.
//
// Forward. Replaces the TPU kernels spt_proto_tpu/ops/pallas/
// block_sparse_attention.py _fwd_v3 (_fwd_kernel_v3), _fwd (_fwd_kernel and,
// with_lse=True, _fwd_kernel_lse) and _fwd_dma (_fwd_kernel_dma, whose
// double-buffered DMA is TPU mechanics): all compute the same function, the
// TPU picks one by whether K+V fit VMEM.
//
// Bound on the H100: memory. Per launch at OPT-125M prefill (96 heads x 2048
// x 64, bf16) it must read q, k and v and write o: 4 x 25 MB = 100 MB,
// 30 us at 3.35 TB/s. With 2 selected 128-key tiles per 256-query tile the
// products are 2 x 2 x 96 x 2048 x 256 x 64 = 13 GFLOP (13 us at the bf16
// tensor-core peak), so even a tensor-core kernel stays memory-bound.
// This kernel computes in f32 on the CUDA cores and is far from that bound;
// wgmma tiles come in a later change.
//
// Design: one CTA per (batch*head, 64-query sub-tile of a q tile). It walks
// the parent q tile's `sel` entries, skips -1 and tiles wholly after its
// rows, stages each 128-key K (transposed) and V tile in shared memory, and
// runs online softmax in f32: logits scaled then clamped to +-clamp, causal
// mask col <= row, probabilities rounded to the input dtype before the PV
// product (as the TPU kernel feeds its MXU), output acc / max(l, 1e-9).
// 256 threads hold a 4-row x 8-column score micro-tile and a 4 x 4 output
// micro-tile each; the P tile reuses the K tile's shared memory. With an
// `lse` pointer it also writes m + log(max(l, 1e-9)) per row in f32 from the
// running max m and sum l it keeps anyway (_fwd_kernel_lse).
//
// Backward. Replaces _bwd_kernels_v3 (_bwd_dq_kernel_v3, _bwd_dkv_kernel_v3)
// and _bwd_kernels (_bwd_dq_kernel, _bwd_dkv_kernel): the split is a VMEM
// budget, one pair serves both here. With dd = sum(do * o) per row (plain
// torch, as JAX computes it outside its kernels), s = clip(scale q k^T),
// p = exp(s - lse) on col <= row, ds = p (do v^T - dd), zeroed where
// |scale q k^T| > clamp (clip passes no gradient; equality passes):
//   dq = scale sum_sel ds k          (ds rounded to k's dtype)
//   dv = sum p^T do                  (p rounded to do's dtype)
//   dk = scale sum ds^T q            (ds rounded to q's dtype)
// Bound: memory, as the forward; the training shape (96 x 512 x 64, the
// diagonal tiles only) reads q, k, v, do and writes dq, dk, dv: a few MB,
// a few us, against 3 (dq) and 4 (dk/dv) products per selected element.
// dq: one CTA per (batch*head, 64-row sub-tile), walking the q tile's `sel`
// as the forward does; S and dP micro-tiles in registers, dS through the V
// tile's shared memory, dq accumulated in registers.
// dk/dv: one CTA per (batch*head, 128-key tile), walking its row of the
// reverse table (the q tiles that selected it, ascending, -1 padded; built
// on the device in plain torch, as JAX builds it outside its kernel) in
// chunks of 32 query rows, chunks wholly before the tile skipped; dk and dv
// accumulate in registers (8 keys x D/16 columns a thread). Each output
// element is written by one thread once: no atomics, so a run is
// deterministic. A tile nobody selected gets zeros.
#include "common.cuh"

#include <cfloat>

namespace spt {

constexpr int kSub = 64;                 // query rows per CTA
constexpr int kBK = 128;                 // key rows per tile
constexpr int kPad = kBK + 4;            // padded row of the K^T / P tile
constexpr float kMask = -0.7f * FLT_MAX; // the TPU kernel's MASK_VALUE

template <typename T, int D>
__global__ void __launch_bounds__(256) block_sparse_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ sel,
    T* __restrict__ o, float* __restrict__ lse, int S, int NQT, int NSEL,
    int BQ, float scale, float clamp, int has_clamp) {
  constexpr int DJ = D / 16;             // output columns per thread
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                        // [kSub][D]
  float* kt = qs + kSub * D;             // [D][kPad]   K^T, then P [kSub][kPad]
  float* vs = kt + D * kPad;             // [kBK][D]

  const int bh = blockIdx.y, row0 = blockIdx.x * kSub;
  const int qt = row0 / BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t off = (size_t)bh * S * D;

  for (int i = tid; i < kSub * D; i += blockDim.x)
    qs[i] = to_f(q[off + (size_t)row0 * D + i]);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int* srow = sel + ((size_t)bh * NQT + qt) * NSEL;
  for (int si = 0; si < NSEL; ++si) {
    const int tile = srow[si];
    const int col0 = tile * kBK;
    if (tile < 0 || col0 > row0 + kSub - 1) continue;   // uniform per CTA
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
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = s[i][j] * scale;
        if (has_clamp) x = fminf(fmaxf(x, -clamp), clamp);
        s[i][j] = col0 + tx + 16 * j <= r ? x : kMask;
        mx = fmaxf(mx, s[i][j]);
      }
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = col0 + tx + 16 * j <= r ? expf(s[i][j] - mn) : 0.f;
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
    const float den = fmaxf(l[i], 1e-9f);
    const size_t r = (size_t)(row0 + ty * 4 + i);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[off + r * D + tx + 16 * j] = from_f<T>(acc[i][j] / den);
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * S + r] = m[i] + logf(den);
  }
}

template <typename T, int D>
int launch_bsa(const void* q, const void* k, const void* v, const void* sel,
               void* o, float* lse, int BH, int S, int NQT, int NSEL, int BQ,
               float scale, float clamp, int has_clamp, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kSub * D + D * kPad + kBK * D);
  cudaError_t e = cudaFuncSetAttribute(
      block_sparse_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(S / kSub, BH);
  block_sparse_fwd_kernel<T, D><<<grid, 256, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)sel, (T*)o, lse, S,
      NQT, NSEL, BQ, scale, clamp, has_clamp);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// p and ds of one score element (the JAX kernels' numerics): sp = scale q.k,
// s = clip(sp), p = exp(s - lse) on col <= row, ds = p (dp - dd), zeroed where
// |sp| > clamp.
__device__ __forceinline__ void bwd_element(float dot, float dp, bool valid,
                                            float lse, float dd, float scale,
                                            float clamp, int has_clamp,
                                            float* p, float* ds) {
  const float sp = dot * scale;
  const float x = has_clamp ? fminf(fmaxf(sp, -clamp), clamp) : sp;
  *p = valid ? expf(x - lse) : 0.f;
  *ds = (has_clamp && fabsf(sp) > clamp) ? 0.f : *p * (dp - dd);
}

template <typename T, int D>
__global__ void __launch_bounds__(256) block_sparse_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ dd,
    const int* __restrict__ sel, T* __restrict__ dq, int S, int NQT,
    int NSEL, int BQ, float scale, float clamp, int has_clamp) {
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                        // [kSub][D]
  float* gs = qs + kSub * D;             // [kSub][D]   do
  float* kt = gs + kSub * D;             // [D][kPad]   K^T
  float* vt = kt + D * kPad;             // [D][kPad]   V^T, then dS [kSub][kPad]
  float* ls = vt + D * kPad;             // [kSub]      lse
  float* ds_row = ls + kSub;             // [kSub]      dd

  const int bh = blockIdx.y, row0 = blockIdx.x * kSub;
  const int qt = row0 / BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t off = (size_t)bh * S * D;

  for (int i = tid; i < kSub * D; i += blockDim.x) {
    qs[i] = to_f(q[off + (size_t)row0 * D + i]);
    gs[i] = to_f(g[off + (size_t)row0 * D + i]);
  }
  if (tid < kSub) {
    ls[tid] = lse[(size_t)bh * S + row0 + tid];
    ds_row[tid] = dd[(size_t)bh * S + row0 + tid];
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int* srow = sel + ((size_t)bh * NQT + qt) * NSEL;
  for (int si = 0; si < NSEL; ++si) {
    const int tile = srow[si];
    const int col0 = tile * kBK;
    if (tile < 0 || col0 > row0 + kSub - 1) continue;   // uniform per CTA
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
        float p, ds;
        bwd_element(s[i][j], dp[i][j], col0 + tx + 16 * j <= r, ls[rl],
                    ds_row[rl], scale, clamp, has_clamp, &p, &ds);
        vt[rl * kPad + tx + 16 * j] = rt<T>(ds);
      }
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float dv_[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv_[i] = vt[(ty * 4 + i) * kPad + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = kt[(tx + 16 * j) * kPad + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += dv_[i] * kv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = (size_t)(row0 + ty * 4 + i);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[off + r * D + tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

constexpr int kR = 32;                   // query rows per dk/dv chunk

template <typename T, int D>
__global__ void __launch_bounds__(256) block_sparse_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ dd,
    const int* __restrict__ rsel, T* __restrict__ dk, T* __restrict__ dv,
    int S, int NKT, int NQT, int BQ, float scale, float clamp,
    int has_clamp) {
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* kt = sm;                        // [D][kPad]   K^T
  float* vt = kt + D * kPad;             // [D][kPad]   V^T
  float* qs = vt + D * kPad;             // [kR][D]
  float* gs = qs + kR * D;               // [kR][D]     do
  float* ps = gs + kR * D;               // [kR][kPad]  p in do's dtype
  float* dss = ps + kR * kPad;           // [kR][kPad]  ds in q's dtype
  float* ls = dss + kR * kPad;           // [kR]
  float* dds = ls + kR;                  // [kR]

  const int bh = blockIdx.y, kti = blockIdx.x, col0 = kti * kBK;
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

  const int* rrow = rsel + ((size_t)bh * NKT + kti) * NQT;
  for (int hi = 0; hi < NQT; ++hi) {
    const int qt = rrow[hi];
    if (qt < 0) break;                   // ascending, -1 padded
    for (int r0 = qt * BQ; r0 < qt * BQ + BQ; r0 += kR) {
      if (r0 + kR - 1 < col0) continue;  // every row before the tile
      __syncthreads();
      for (int i = tid; i < kR * D; i += blockDim.x) {
        qs[i] = to_f(q[off + (size_t)r0 * D + i]);
        gs[i] = to_f(g[off + (size_t)r0 * D + i]);
      }
      if (tid < kR) {
        ls[tid] = lse[(size_t)bh * S + r0 + tid];
        dds[tid] = dd[(size_t)bh * S + r0 + tid];
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
          float p, ds;
          bwd_element(s[i][j], dp[i][j], col0 + tx + 16 * j <= r0 + rl,
                      ls[rl], dds[rl], scale, clamp, has_clamp, &p, &ds);
          ps[rl * kPad + tx + 16 * j] = rt<T>(p);
          dss[rl * kPad + tx + 16 * j] = rt<T>(ds);
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
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t c = (size_t)(col0 + ty * 8 + i);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + c * D + tx + 16 * j] = from_f<T>(adk[i][j] * scale);
      dv[off + c * D + tx + 16 * j] = from_f<T>(adv[i][j]);
    }
  }
}

template <typename T, int D>
int launch_bsa_bwd(const void* q, const void* k, const void* v,
                   const void* g, const float* lse, const float* dd,
                   const void* sel, const void* rsel, void* dq, void* dk,
                   void* dv, int BH, int S, int NQT, int NSEL, int BQ,
                   float scale, float clamp, int has_clamp,
                   cudaStream_t stream) {
  const size_t smem_q =
      sizeof(float) * (2 * kSub * D + 2 * D * kPad + 2 * kSub);
  cudaError_t e = cudaFuncSetAttribute(
      block_sparse_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  const size_t smem_kv = sizeof(float) *
      (2 * D * kPad + 2 * kR * D + 2 * kR * kPad + 2 * kR);
  e = cudaFuncSetAttribute(block_sparse_dkv_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  if (dq != nullptr) {
    block_sparse_dq_kernel<T, D><<<dim3(S / kSub, BH), 256, smem_q, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)g, lse, dd,
        (const int*)sel, (T*)dq, S, NQT, NSEL, BQ, scale, clamp, has_clamp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (dk != nullptr) {
    block_sparse_dkv_kernel<T, D><<<dim3(S / kBK, BH), 256, smem_kv,
                                     stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)g, lse, dd,
        (const int*)rsel, (T*)dk, (T*)dv, S, S / kBK, NQT, BQ, scale, clamp,
        has_clamp);
  }
  return (int)cudaGetLastError();
}

}  // namespace spt

// D is 64 (every OPT size up to 1.3B) or 128.
// `lse` may be null (no log-sum-exp output).
extern "C" int spt_block_sparse_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* sel, void* o,
                                    void* lse, int BH, int S, int D, int NQT,
                                    int NSEL, int BQ, float scale, float clamp,
                                    int has_clamp, void* stream) {
  auto f = dtype == spt::kBF16
               ? (D == 64 ? spt::launch_bsa<__nv_bfloat16, 64>
                          : spt::launch_bsa<__nv_bfloat16, 128>)
               : (D == 64 ? spt::launch_bsa<float, 64>
                          : spt::launch_bsa<float, 128>);
  return f(q, k, v, sel, o, (float*)lse, BH, S, NQT, NSEL, BQ, scale, clamp,
           has_clamp, (cudaStream_t)stream);
}

// The backward: dq when `dq` is not null (walking `sel` [BH, NQT, NSEL]),
// dk and dv when `dk` is not null (walking `rsel` [BH, S/128, NQT]). `g` is
// the output gradient, lse and dd [BH, S] f32.
extern "C" int spt_block_sparse_bwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* g,
                                    const void* lse, const void* dd,
                                    const void* sel, const void* rsel,
                                    void* dq, void* dk, void* dv, int BH,
                                    int S, int D, int NQT, int NSEL, int BQ,
                                    float scale, float clamp, int has_clamp,
                                    void* stream) {
  auto f = dtype == spt::kBF16
               ? (D == 64 ? spt::launch_bsa_bwd<__nv_bfloat16, 64>
                          : spt::launch_bsa_bwd<__nv_bfloat16, 128>)
               : (D == 64 ? spt::launch_bsa_bwd<float, 64>
                          : spt::launch_bsa_bwd<float, 128>);
  return f(q, k, v, g, (const float*)lse, (const float*)dd, sel, rsel, dq, dk,
           dv, BH, S, NQT, NSEL, BQ, scale, clamp, has_clamp,
           (cudaStream_t)stream);
}
