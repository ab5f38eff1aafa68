// Block-sparse causal attention forward over PQ-selected key tiles.
//
// Replaces the TPU kernels spt_proto_tpu/ops/pallas/block_sparse_attention.py
// _fwd_v3 (_fwd_kernel_v3) and _fwd (_fwd_kernel): both compute the same
// function, the TPU picks one by whether K+V fit VMEM. Forward only.
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
// micro-tile each; the P tile reuses the K tile's shared memory.
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
    T* __restrict__ o, int S, int NQT, int NSEL, int BQ, float scale,
    float clamp, int has_clamp) {
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
  }
}

template <typename T, int D>
int launch_bsa(const void* q, const void* k, const void* v, const void* sel,
               void* o, int BH, int S, int NQT, int NSEL, int BQ,
               float scale, float clamp, int has_clamp, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kSub * D + D * kPad + kBK * D);
  cudaError_t e = cudaFuncSetAttribute(
      block_sparse_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(S / kSub, BH);
  block_sparse_fwd_kernel<T, D><<<grid, 256, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)sel, (T*)o, S, NQT,
      NSEL, BQ, scale, clamp, has_clamp);
  return (int)cudaGetLastError();
}

}  // namespace spt

// D is 64 (every OPT size up to 1.3B) or 128.
extern "C" int spt_block_sparse_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* sel, void* o,
                                    int BH, int S, int D, int NQT, int NSEL,
                                    int BQ, float scale, float clamp,
                                    int has_clamp, void* stream) {
  auto f = dtype == spt::kBF16
               ? (D == 64 ? spt::launch_bsa<__nv_bfloat16, 64>
                          : spt::launch_bsa<__nv_bfloat16, 128>)
               : (D == 64 ? spt::launch_bsa<float, 64>
                          : spt::launch_bsa<float, 128>);
  return f(q, k, v, sel, o, BH, S, NQT, NSEL, BQ, scale, clamp, has_clamp,
           (cudaStream_t)stream);
}
