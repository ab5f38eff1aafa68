// Dense causal flash attention: the forward (o and the softmax statistics
// l, m the backward needs) and the two backward kernels, dq and dk/dv.
//
// Replaces the stock TPU kernel jax/experimental/pallas/ops/tpu/
// flash_attention.py (jax 0.9.0), which spt_proto_tpu/layers/attention.py:75
// calls for every dense causal attention under attn_impl='pallas':
//   flash_fwd_kernel (f32), flash_fwd_kernel_tc (bf16)
//                     <- _flash_attention_kernel (:331, :342), launched by
//                        _flash_attention_impl (:589, pallas_call :758)
//   flash_dkv_kernel (f32), flash_dkv_kernel_tc (bf16)
//                     <- _flash_attention_dkv_kernel (:796), launched by
//                        _flash_attention_bwd_dkv (:941, pallas_call :1121)
//   flash_dq_kernel (f32), flash_dq_kernel_tc (bf16)
//                     <- _flash_attention_dq_kernel (:1146), launched by
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
// Bound on the H100 at OPT-125M's training shape (8 x 12 heads, S 512,
// d 64, bf16): the forward reads q, k, v and writes o, l, m: 25.6 MB,
// 7.6 us; its causal products are 2 * 96 * 512^2 * 64 = 3.2 GFLOP, 3.3 us
// at the bf16 tensor-core peak (989 TFLOP/s); at S 2048 52 us of products
// against 25 us of bytes. The backward pair does 3.5x the forward's
// products (dq: S, dP and dS K; dk/dv: S, dP, P^T dO and dS^T Q, so S and
// dP are computed twice) where one fused kernel with atomics on dq would
// do 2.5x: at S 2048 its bound is 182 us of products (a fused backward's
// 130 us). Every kernel here is compute-bound at S >= 512 in bf16.
//
// f32: the products on the CUDA cores (67 TFLOP/s peak), the structure of
// csrc/block_sparse_attention.cu with the causal walk in place of a
// selection list; the f32 backward sums in cuBLAS SGEMM's order and is
// bit-equal to its twin. Forward: one CTA
// per (batch*head, 64-query sub-tile); it walks the 128-key tiles from 0
// to the one holding its last row (tiles wholly above the diagonal
// skipped, the stock's below_or_on_diag, :325), stages K^T and V in shared
// memory as f32, and keeps m, l and the output rows in registers (256
// threads: 4 rows x 8 score columns and 4 x D/16 output columns each); the
// P tile reuses the K^T buffer. f32 dq: one CTA per (batch*head, 64-query
// sub-tile), the same walk, S and dP micro-tiles in registers, dS through
// the V^T buffer. f32 dk/dv: one CTA per (batch*head, 128-key tile),
// walking the query rows from the tile's first row to S in chunks of 32
// (rows before the tile see none of it), dk and dv in registers.
//
// bf16 (flash_fwd_kernel_tc, flash_dq_kernel_tc, flash_dkv_kernel_tc) runs
// every product on the tensor cores: mma.sync m16n8k16, bf16 operands, f32
// accumulators (common.cuh), operands read from shared memory by ldmatrix
// (.trans for the operand read along its rows). mma.sync and not wgmma:
// its fragments live in one warp's registers, so the repack of P and dS
// from the accumulator layout into the A operand of the next product (two
// n8 accumulator tiles are one k16 A fragment) is a register move, with no
// shared-memory round trip and no warpgroup descriptors; wgmma is for a
// later change. Tiles are bf16 in shared memory, rows padded by 8 elements
// (16 B) so that the 8 row addresses of an ldmatrix fall in distinct
// banks, filled by cp.async (16 B a thread, global to shared without
// registers) into a ring of stages: the next tile's copy is in flight
// while the current one is computed. q, k, v and do are read in place
// through their (batch, head, row) strides, the layer's [B, S, H, d]
// projections transposed, and o, dq, dk, dv written in the same layout: no
// contiguous copy.
//   forward: one CTA per (batch*head, 64 query rows), 4 warps of 16 rows.
// Each warp loads its Q fragments into registers once and walks the key
// tiles (64 keys at d 64, 32 at d 128) from 0 up to the diagonal through a
// 2-stage K/V ring: S = Q K^T, the row max and sum over the 4 lanes of a
// quad (a thread holds rows gr and gr + 8), the O accumulators rescaled by
// exp(m_old - m_new), p = exp(s - m) in f32 summed into l before it is
// rounded to bf16 and repacked as the A operand of O += P V (V through
// ldmatrix.trans); at the end o = O * (1 / l) through the warp's shared
// rows, and l and m. Registers: 167 a thread at d 64, 168 at d 128 (its 64
// f32 accumulators and 32 Q registers beside 32-key tiles), no spills.
//   dq: one CTA per (batch*head, 64 query rows), 4 warps of 16 rows. Each
// warp loads its Q and dO fragments into registers once, m, 1/l and di of
// its thread's two rows too, and walks the 32-key tiles up to the diagonal
// through a 2-stage K/V ring: S = Q K^T and dP = dO V^T, then P and dS in
// registers, dS rounded to bf16 and repacked for dq += dS K (K through
// ldmatrix.trans).
//   dk/dv: one CTA per (batch*head, 64 keys), 4 warps of 16 keys; K and V
// stay in shared memory. It walks the 32-row query tiles from its first
// key to S through a 3-stage ring of Q, dO and the rows' 1/l, m, di: S^T =
// K Q^T and dP^T = V dO^T leave P^T and dS^T in the accumulator layout,
// repacked as the A operands of dV += P^T dO and dK += dS^T Q (dO and Q
// through ldmatrix.trans).
//   Registers bound them: at d 64 dq takes 128 a thread (4 CTAs an SM),
// dk/dv 164 (3); at d 128 the f32 accumulators (dq 64 a thread, dk and dv
// 128) bring both to ~245 (2 CTAs an SM), with no spills (nvcc -Xptxas
// -v). Capping them lower spilled and ran slower.
//   Only tiles that reach across the diagonal are masked, and a warp skips
// a tile wholly on the masked side of its rows (its terms are zeros). All
// three launch the longest walks first (the last query tiles, the first key
// tiles). The sums run in the tensor cores' order, not the twin's: the
// bf16 results agree with the twin within a bf16 step.
//
// Every output element is written once (the bf16 kernels stage a warp's
// tile through its own shared rows for 16-byte stores): no atomics, runs
// are deterministic.
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

template <int D>
__global__ void __launch_bounds__(256) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ l_out,
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
    qs[i] = q[off + (size_t)row0 * D + i];

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
      kt[d * kPad + c] = k[off + (size_t)(col0 + c) * D + d];
      vs[i] = v[off + (size_t)col0 * D + i];
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
        kt[(ty * 4 + i) * kPad + tx + 16 * j] = p;
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
      o[off + r * D + tx + 16 * j] = acc[i][j] * inv;
    if (tx == 0) {
      l_out[(size_t)bh * S + r] = l[i];
      m_out[(size_t)bh * S + r] = m[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ l_in, const float* __restrict__ m_in,
    const float* __restrict__ di, float* __restrict__ dq, int S,
    float scale) {
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
    qs[i] = q[off + (size_t)row0 * D + i];
    gs[i] = g[off + (size_t)row0 * D + i];
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
      kt[d * kPad + c] = k[src];
      vt[d * kPad + c] = v[src];
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
        vt[rl * kPad + tx + 16 * j] = (dp[i][j] - dis[rl]) * p * scale;
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
      dq[off + r * D + tx + 16 * j] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ l_in, const float* __restrict__ m_in,
    const float* __restrict__ di, float* __restrict__ dk,
    float* __restrict__ dv,
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
    kt[d * kPad + c] = k[src];
    vt[d * kPad + c] = v[src];
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
      qs[i] = q[off + (size_t)r0 * D + i];
      gs[i] = g[off + (size_t)r0 * D + i];
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
        ps[rl * kPad + tx + 16 * j] = p;
        dss[rl * kPad + tx + 16 * j] = (dp[i][j] - dis[rl]) * p * scale;
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
      dk[off + c * D + tx + 16 * j] = adk[i][j];
      dv[off + c * D + tx + 16 * j] = adv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 backward on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcPad = kTilePad;   // bf16 elements of padding a shared row
constexpr int kTcWarps = 4;   // warps a CTA, 16 query rows or keys each
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;   // query rows (dq) / keys (dk/dv)
constexpr int kDkvStages = 3;            // the dk/dv kernel's query-tile ring
// keys a dq tile and query rows a dk/dv tile (at d 64, 64 of each took
// 176 and 236 registers a thread, so 2 CTAs an SM, and ran 1.25x and
// 1.16x slower: kernel_ab.py --flash)
constexpr int kDqKeys = 32;
constexpr int kDkvRows = 32;
// keys a forward tile by d and the depth of its K/V ring (kernel_ab.py
// --flash, H100: 64 keys at d 64, S 2048 281 us against 288 with 32; 32 at
// d 128, S 512 59 us against 62 with 64; 3 stages no faster)
template <int D> constexpr int kFwdKeys = D == 64 ? 64 : 32;
constexpr int kFwdStages = 2;

// element strides of a [B, H, S, D] operand whose d stride is 1
struct Strides {
  long long b, h, s;
};

struct BwdArgs {
  const bf16 *q, *k, *v, *g;
  const float *l, *m, *di;
  bf16 *dq, *dk, *dv;
  Strides sq, sk, sv, sg, sdq, sdk, sdv;
  int H, S;
  float scale;
};

__device__ __forceinline__ const bf16* head(const bf16* t, Strides st,
                                            int b, int h) {
  return t + b * st.b + h * st.h;
}

struct FwdArgs {
  const bf16 *q, *k, *v;
  bf16* o;
  float *l, *m;
  Strides sq, sk, sv, so;
  int H, S;
  float scale;
};

// The bf16 forward: one CTA per (batch*head, 64 query rows), 4 warps of 16
// rows; kN-key tiles of K and V walked in ascending order through a
// kStages-deep cp.async ring (tile 0 holds col 0 <= row, so every m is
// finite before a masked logit is seen)
template <int D, int kN, int kStages>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_kernel_tc(
    const FwdArgs a) {
  constexpr int kM = kTcRows, kRow = D + kTcPad, kNT = kN / 8;
  constexpr int kStage = 2 * kN * kRow;   // elements of a stage's K and V
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [kM][kRow] Q, then o
  bf16* ring = qs + kM * kRow;                // [kStages][K, V][kN][kRow]

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kM;  // longest walks first
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gr = lane >> 2, tig = lane & 3;
  const bf16* k = head(a.k, a.sk, b, h);
  const bf16* v = head(a.v, a.sv, b, h);
  const int n_tiles = (row0 + kM - 1) / kN + 1;

  copy_rows<D, kM>(qs, head(a.q, a.sq, b, h) + row0 * a.sq.s, a.sq.s);
  cp_async_commit();
  auto load_kv = [&](int j) {
    bf16* st = ring + (j % kStages) * kStage;
    copy_rows<D, kN>(st, k + (long long)j * kN * a.sk.s, a.sk.s);
    copy_rows<D, kN>(st + kN * kRow, v + (long long)j * kN * a.sv.s,
                     a.sv.s);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  const int wr0 = row0 + 16 * w;   // the warp's first row
  cp_async_wait<kStages - 1>();    // Q has landed
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], qs + a_off(16 * w, kk * 16, kRow));

  // the thread's rows gr and gr + 8: running max, sum and output columns
  float mr[2] = {-INFINITY, -INFINITY}, lr[2] = {0.f, 0.f};
  float acc[D / 8][4] = {};
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();   // key tile j has landed
    __syncthreads();                // ... for every thread; j - 1 read out
    if (j + kStages - 1 < n_tiles) load_kv(j + kStages - 1);
    cp_async_commit();
    const int col0 = j * kN;
    if (col0 > wr0 + 15) continue;   // every key lies past the warp's rows
    const bf16* ks = ring + (j % kStages) * kStage;
    const bf16* vs = ks + kN * kRow;

    float s[kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + bt_off(np * 16, kk * 16, kRow));
        mma_bf16_16816(s[2 * np], qf[kk], kb);
        mma_bf16_16816(s[2 * np + 1], qf[kk], kb + 2);
      }
    }
    // logits (masked only on a tile that crosses the diagonal) and the new
    // row max, over the 4 lanes of a quad
    const bool diag = col0 + kN - 1 > wr0;
    float mx[2] = {mr[0], mr[1]};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, r = wr0 + gr + 8 * i;
        const int c = col0 + nt * 8 + tig * 2 + (e & 1);
        s[nt][e] = logit(s[nt][e], a.scale, !diag || c <= r);
        mx[i] = fmaxf(mx[i], s[nt][e]);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(mr[i] - mx[i]);
      mr[i] = mx[i];
    }
    // p = exp(s - m) in f32, summed before it is rounded to bf16 and
    // repacked as the A operand of the PV product
    uint32_t pa[kN / 16][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[nt][e] - mx[e >> 1]);
        rs[e >> 1] += p[e];
      }
      to_a<kNT>(pa, nt, p);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      lr[i] = alpha[i] * lr[i] + rs[i];
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
#pragma unroll
    for (int t = 0; t < kN / 16; ++t) {
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + bn_off(t * 16, n2 * 16, kRow));
        mma_bf16_16816(acc[2 * n2], pa[t], vb);
        mma_bf16_16816(acc[2 * n2 + 1], pa[t], vb + 2);
      }
    }
  }
  cp_async_wait<0>();
  const float inv[2] = {1.f / lr[0], 1.f / lr[1]};
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    acc[nt][0] *= inv[0];
    acc[nt][1] *= inv[0];
    acc[nt][2] *= inv[1];
    acc[nt][3] *= inv[1];
  }
  bf16* o = a.o + b * a.so.b + h * a.so.h;
  store_tile<D>(o + (long long)wr0 * a.so.s, a.so.s, qs + 16 * w * kRow,
                acc);
  if (tig == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t r = (size_t)bh * a.S + wr0 + gr + 8 * i;
      a.l[r] = lr[i];
      a.m[r] = mr[i];
    }
  }
}

template <int D, int kN>
__global__ void __launch_bounds__(kTcThreads) flash_dq_kernel_tc(
    const BwdArgs a) {
  constexpr int kM = kTcRows, kRow = D + kTcPad, kNT = kN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [kM][kRow] Q, then dq
  bf16* gs = qs + kM * kRow;                  // [kM][kRow] dO
  bf16* ring = gs + kM * kRow;                // [2][K, V][kN][kRow]

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kM;  // longest walks first
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gr = lane >> 2, tig = lane & 3;
  const bf16* k = head(a.k, a.sk, b, h);
  const bf16* v = head(a.v, a.sv, b, h);
  const int n_tiles = (row0 + kM - 1) / kN + 1;

  copy_rows<D, kM>(qs, head(a.q, a.sq, b, h) + row0 * a.sq.s, a.sq.s);
  copy_rows<D, kM>(gs, head(a.g, a.sg, b, h) + row0 * a.sg.s, a.sg.s);
  cp_async_commit();
  auto load_kv = [&](int j) {
    bf16* st = ring + (j & 1) * 2 * kN * kRow;
    copy_rows<D, kN>(st, k + (long long)j * kN * a.sk.s, a.sk.s);
    copy_rows<D, kN>(st + kN * kRow, v + (long long)j * kN * a.sv.s,
                     a.sv.s);
  };
  load_kv(0);
  cp_async_commit();

  const int wr0 = row0 + 16 * w;   // the warp's first row
  float mr[2], il[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = (size_t)bh * a.S + wr0 + gr + 8 * i;
    mr[i] = a.m[r];
    il[i] = 1.f / a.l[r];
    dr[i] = a.di[r];
  }
  cp_async_wait<1>();   // Q and dO have landed
  __syncthreads();
  uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm_x4(qf[kk], qs + a_off(16 * w, kk * 16, kRow));
    ldsm_x4(gf[kk], gs + a_off(16 * w, kk * 16, kRow));
  }

  float acc[D / 8][4] = {};
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();   // key tile j has landed
    __syncthreads();      // ... for every thread; tile j - 1 is read out
    if (j + 1 < n_tiles) load_kv(j + 1);
    cp_async_commit();
    const int col0 = j * kN;
    if (col0 > wr0 + 15) continue;   // every key lies past the warp's rows
    const bf16* ks = ring + (j & 1) * 2 * kN * kRow;
    const bf16* vs = ks + kN * kRow;

    float s[kNT][4] = {}, dp[kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        const int off = bt_off(np * 16, kk * 16, kRow);
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, ks + off);
        ldsm_x4(vb, vs + off);
        mma_bf16_16816(s[2 * np], qf[kk], kb);
        mma_bf16_16816(s[2 * np + 1], qf[kk], kb + 2);
        mma_bf16_16816(dp[2 * np], gf[kk], vb);
        mma_bf16_16816(dp[2 * np + 1], gf[kk], vb + 2);
      }
    }
    const bool diag = col0 + kN - 1 > wr0;
    uint32_t dsa[kN / 16][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, r = wr0 + gr + 8 * i;
        const int c = col0 + nt * 8 + tig * 2 + (e & 1);
        const float x = logit(s[nt][e], a.scale, !diag || c <= r);
        const float p = expf(x - mr[i]) * il[i];
        ds[e] = (dp[nt][e] - dr[i]) * p * a.scale;
      }
      to_a<kNT>(dsa, nt, ds);
    }
#pragma unroll
    for (int t = 0; t < kN / 16; ++t) {
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, ks + bn_off(t * 16, n2 * 16, kRow));
        mma_bf16_16816(acc[2 * n2], dsa[t], kb);
        mma_bf16_16816(acc[2 * n2 + 1], dsa[t], kb + 2);
      }
    }
  }
  cp_async_wait<0>();
  bf16* dq = a.dq + b * a.sdq.b + h * a.sdq.h;
  store_tile<D>(dq + (long long)wr0 * a.sdq.s, a.sdq.s, qs + 16 * w * kRow,
                acc);
}

template <int D, int kQ>
__global__ void __launch_bounds__(kTcThreads) flash_dkv_kernel_tc(
    const BwdArgs a) {
  constexpr int kK = kTcRows, kRow = D + kTcPad, kNT = kQ / 8;
  constexpr int kStages = kDkvStages;
  constexpr int kStage = 2 * kQ * kRow;   // elements of a stage's Q and dO
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [kK][kRow] K, then dk
  bf16* vs = ks + kK * kRow;                  // [kK][kRow] V, then dv
  bf16* ring = vs + kK * kRow;                // [kStages][Q, dO][kQ][kRow]
  float* stats = reinterpret_cast<float*>(ring + kStages * kStage);
                                              // [kStages][1/l, m, di][kQ]

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kK;   // the first key tiles walk the most rows
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gr = lane >> 2, tig = lane & 3;
  const bf16* q = head(a.q, a.sq, b, h);
  const bf16* g = head(a.g, a.sg, b, h);
  const size_t srow = (size_t)bh * a.S;
  const int n_tiles = (a.S - k0) / kQ;   // rows before k0 see none of it

  copy_rows<D, kK>(ks, head(a.k, a.sk, b, h) + k0 * a.sk.s, a.sk.s);
  copy_rows<D, kK>(vs, head(a.v, a.sv, b, h) + k0 * a.sv.s, a.sv.s);
  cp_async_commit();
  auto load_q = [&](int j) {
    const int r0 = k0 + j * kQ, st = j % kStages;
    bf16* qs = ring + st * kStage;
    copy_rows<D, kQ>(qs, q + (long long)r0 * a.sq.s, a.sq.s);
    copy_rows<D, kQ>(qs + kQ * kRow, g + (long long)r0 * a.sg.s, a.sg.s);
    // m and di by cp.async; 1/l computed once a row here (per score it cost
    // 7% of the kernel at S 2048: kernel_ab.py --flash)
    constexpr int kC = kQ / 4;   // 16-byte copies a statistic
    if (threadIdx.x < 2 * kC) {
      const int t = threadIdx.x / kC + 1, c = threadIdx.x % kC;
      const float* src = t == 1 ? a.m : a.di;
      cp_async16(stats + (st * 3 + t) * kQ + c * 4, src + srow + r0 + c * 4);
    } else if (threadIdx.x < 2 * kC + kQ) {
      const int i = threadIdx.x - 2 * kC;
      stats[st * 3 * kQ + i] = __frcp_rn(a.l[srow + r0 + i]);
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_q(j);
    cp_async_commit();
  }

  const int wk0 = k0 + 16 * w;   // the warp's first key
  float adk[D / 8][4] = {}, adv[D / 8][4] = {};
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();   // K, V and query tile j have landed
    __syncthreads();                // ... for every thread; j - 1 read out
    if (j + kStages - 1 < n_tiles) load_q(j + kStages - 1);
    cp_async_commit();
    const int r0 = k0 + j * kQ;
    if (r0 + kQ - 1 < wk0) continue;   // every row lies before the keys
    const int st = j % kStages;
    const bf16* qs = ring + st * kStage;
    const bf16* gs = qs + kQ * kRow;
    const float* sil = stats + st * 3 * kQ;
    const float* sm = sil + kQ;
    const float* sd = sm + kQ;

    float s[kNT][4] = {}, dp[kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, ks + a_off(16 * w, kk * 16, kRow));
      ldsm_x4(va, vs + a_off(16 * w, kk * 16, kRow));
#pragma unroll
      for (int np = 0; np < kQ / 16; ++np) {
        const int off = bt_off(np * 16, kk * 16, kRow);
        uint32_t qb[4], gb[4];
        ldsm_x4(qb, qs + off);
        ldsm_x4(gb, gs + off);
        mma_bf16_16816(s[2 * np], ka, qb);
        mma_bf16_16816(s[2 * np + 1], ka, qb + 2);
        mma_bf16_16816(dp[2 * np], va, gb);
        mma_bf16_16816(dp[2 * np + 1], va, gb + 2);
      }
    }
    const bool diag = r0 < wk0 + 15;
    uint32_t pa[kQ / 16][4], dsa[kQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = wk0 + gr + 8 * (e >> 1);
        const int ql = nt * 8 + tig * 2 + (e & 1);
        const float x = logit(s[nt][e], a.scale, !diag || key <= r0 + ql);
        p[e] = expf(x - sm[ql]) * sil[ql];
        ds[e] = (dp[nt][e] - sd[ql]) * p[e] * a.scale;
      }
      to_a<kNT>(pa, nt, p);
      to_a<kNT>(dsa, nt, ds);
    }
#pragma unroll
    for (int t = 0; t < kQ / 16; ++t) {
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        const int off = bn_off(t * 16, n2 * 16, kRow);
        uint32_t gb[4], qb[4];
        ldsm_x4_trans(gb, gs + off);
        ldsm_x4_trans(qb, qs + off);
        mma_bf16_16816(adv[2 * n2], pa[t], gb);
        mma_bf16_16816(adv[2 * n2 + 1], pa[t], gb + 2);
        mma_bf16_16816(adk[2 * n2], dsa[t], qb);
        mma_bf16_16816(adk[2 * n2 + 1], dsa[t], qb + 2);
      }
    }
  }
  cp_async_wait<0>();
  bf16* dk = a.dk + b * a.sdk.b + h * a.sdk.h;
  bf16* dv = a.dv + b * a.sdv.b + h * a.sdv.h;
  store_tile<D>(dk + (long long)wk0 * a.sdk.s, a.sdk.s, ks + 16 * w * kRow,
                adk);
  store_tile<D>(dv + (long long)wk0 * a.sdv.s, a.sdv.s, vs + 16 * w * kRow,
                adv);
}

template <int D>
int launch_bwd_tc(const BwdArgs& a, int BH, bool dq, bool dkv,
                  cudaStream_t stream) {
  constexpr int kN = kDqKeys, kQ = kDkvRows, kRow = D + kTcPad;
  const dim3 grid(BH, a.S / kTcRows);
  cudaError_t e;
  if (dq) {
    const size_t smem = sizeof(bf16) * (2 * kTcRows + 4 * kN) * kRow;
    auto kern = flash_dq_kernel_tc<D, kN>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kTcThreads, smem, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (dkv) {
    const size_t smem = sizeof(bf16) * (2 * kTcRows + kDkvStages * 2 * kQ)
                        * kRow + sizeof(float) * kDkvStages * 3 * kQ;
    auto kern = flash_dkv_kernel_tc<D, kQ>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kTcThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd_tc(const FwdArgs& a, int BH, cudaStream_t stream) {
  constexpr int kN = kFwdKeys<D>, kRow = D + kTcPad;
  const size_t smem =
      sizeof(bf16) * (kTcRows + kFwdStages * 2 * kN) * kRow;
  auto kern = flash_fwd_kernel_tc<D, kN, kFwdStages>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(BH, a.S / kTcRows), kTcThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* l, float* m, int BH, int S, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kSub * D + D * kPad + kBK * D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_kernel<D><<<dim3(S / kSub, BH), 256, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, l, m, S,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* g,
               const float* l, const float* m, const float* di, void* dq,
               void* dk, void* dv, int BH, int S, float scale,
               cudaStream_t stream) {
  cudaError_t e;
  if (dq != nullptr) {
    const size_t smem =
        sizeof(float) * (2 * kSub * D + 2 * D * kPad + 3 * kSub);
    e = cudaFuncSetAttribute(flash_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_dq_kernel<D><<<dim3(S / kSub, BH), 256, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)g, l,
        m, di, (float*)dq, S, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (dk != nullptr) {
    const size_t smem = sizeof(float) *
        (2 * D * kPad + 2 * kR * D + 2 * kR * kPad + 3 * kR);
    e = cudaFuncSetAttribute(flash_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_dkv_kernel<D><<<dim3(S / kBK, BH), 256, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)g, l,
        m, di, (float*)dk, (float*)dv, S, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace spt

// The forward: o, and l and m [B*H, S] f32 contiguous; D 64 or 128, S a
// multiple of 128, causal. `strides` holds the (batch, head, row) element
// strides of q, k, v and o (12 values; each d stride is 1): bf16 reads and
// writes them in place (16-byte aligned rows: the strides multiples of 8);
// f32 takes contiguous [B, H, S, D] only and refuses other strides.
extern "C" int spt_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* o, void* l, void* m, int B,
                             int H, int S, int D, float scale,
                             const long long* strides, void* stream) {
  using namespace spt::flash;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == spt::kBF16) {
    Strides s[4];
    for (int i = 0; i < 4; ++i)
      s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    const FwdArgs a{(const bf16*)q, (const bf16*)k, (const bf16*)v,
                    (bf16*)o, (float*)l, (float*)m, s[0], s[1], s[2], s[3],
                    H, S, scale};
    return D == 64 ? launch_fwd_tc<64>(a, B * H, st)
                   : launch_fwd_tc<128>(a, B * H, st);
  }
  for (int i = 0; i < 4; ++i)
    if (strides[3 * i] != (long long)H * S * D ||
        strides[3 * i + 1] != (long long)S * D || strides[3 * i + 2] != D)
      return (int)cudaErrorInvalidValue;
  auto f = D == 64 ? launch_fwd<64> : launch_fwd<128>;
  return f(q, k, v, o, (float*)l, (float*)m, B * H, S, scale, st);
}

// The backward: dq when `dq` is not null, dk and dv when `dk` is not null.
// `g` is the output gradient, l, m and di [B*H, S] f32 contiguous.
// `strides` holds the (batch, head, row) element strides of q, k, v, g,
// dq, dk and dv (21 values; each operand's d stride is 1): bf16 reads and
// writes them in place (16-byte aligned rows: the strides multiples of 8);
// f32 takes contiguous [B, H, S, D] only and refuses other strides.
extern "C" int spt_flash_bwd(int dtype, const void* q, const void* k,
                             const void* v, const void* g, const void* l,
                             const void* m, const void* di, void* dq,
                             void* dk, void* dv, int B, int H, int S, int D,
                             float scale, const long long* strides,
                             void* stream) {
  using namespace spt::flash;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == spt::kBF16) {
    Strides s[7];
    for (int i = 0; i < 7; ++i)
      s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    const BwdArgs a{(const bf16*)q, (const bf16*)k, (const bf16*)v,
                    (const bf16*)g, (const float*)l, (const float*)m,
                    (const float*)di, (bf16*)dq, (bf16*)dk, (bf16*)dv,
                    s[0], s[1], s[2], s[3], s[4], s[5], s[6], H, S, scale};
    return D == 64 ? launch_bwd_tc<64>(a, B * H, dq != nullptr, dk != nullptr,
                                       st)
                   : launch_bwd_tc<128>(a, B * H, dq != nullptr,
                                        dk != nullptr, st);
  }
  const void* ops[7] = {q, k, v, g, dq, dk, dv};
  for (int i = 0; i < 7; ++i)
    if (ops[i] != nullptr &&
        (strides[3 * i] != (long long)H * S * D ||
         strides[3 * i + 1] != (long long)S * D || strides[3 * i + 2] != D))
      return (int)cudaErrorInvalidValue;
  auto f = D == 64 ? launch_bwd<64> : launch_bwd<128>;
  return f(q, k, v, g, (const float*)l, (const float*)m, (const float*)di,
           dq, dk, dv, B * H, S, scale, st);
}
