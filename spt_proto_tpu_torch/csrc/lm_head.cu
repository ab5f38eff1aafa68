// Fused lm_head + greedy argmax: next token = argmax_v (x @ W)[b, v],
// without storing the [B, V] logits.
//
// Replaces the TPU kernel spt_proto_tpu/ops/pallas/lm_head.py lm_head_argmax
// (_kernel).
//
// Bound on the H100: memory. Per launch at OPT-125M it must read W once:
// 768 x 50272 bf16 = 77 MB, 23 us at 3.35 TB/s; the 8 x 768 x 50272
// multiply-adds (0.6 GFLOP) are far below the tensor-core line.
//
// Design: the TPU kernel walks V-tiles in order and carries a running
// (max, argmax) across grid steps. CTAs on the H100 run in no order, so the
// carry becomes two passes: pass 1 gives each CTA one 128-wide V tile; each
// thread owns one vocabulary column and accumulates the f32 dot for up to 8
// rows at a time, the logit is rounded to the serving dtype (so the winner
// is the argmax of the unfused dtype logits), lanes >= V are skipped, and
// the CTA writes its per-row (max, lowest index). Pass 2 reduces the
// per-tile partials per row with the same rule: larger value, then lower
// index.
#include "common.cuh"

namespace spt {

constexpr int kHeadTile = 128;   // V columns per CTA (= threads; lm_head.py HEAD_TILE)
constexpr int kHeadRows = 8;     // rows accumulated per pass over W

template <typename T>
__global__ void __launch_bounds__(kHeadTile) lm_head_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    float* __restrict__ pval, int* __restrict__ pidx, int B, int D, int V) {
  extern __shared__ float xs[];                 // [kHeadRows][D]
  __shared__ float rv[kHeadTile / 32][kHeadRows];
  __shared__ int ri[kHeadTile / 32][kHeadRows];
  const int tile = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int col = tile * kHeadTile + tid;
  const bool live = col < V;
  for (int r0 = 0; r0 < B; r0 += kHeadRows) {
    const int nr = min(kHeadRows, B - r0);
    __syncthreads();
    for (int i = tid; i < nr * D; i += blockDim.x)
      xs[i] = to_f(x[(size_t)r0 * D + i]);
    __syncthreads();
    float acc[kHeadRows];
#pragma unroll
    for (int r = 0; r < kHeadRows; ++r) acc[r] = 0.f;
    if (live) {
      for (int i = 0; i < D; ++i) {
        const float wv = to_f(w[(size_t)i * V + col]);
#pragma unroll
        for (int r = 0; r < kHeadRows; ++r)
          if (r < nr) acc[r] += xs[r * D + i] * wv;
      }
    }
    for (int r = 0; r < nr; ++r) {
      float v = live ? rt<T>(acc[r]) : -INFINITY;
      int ix = live ? col : 0x7fffffff;
      for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, ix, o);
        if (better(v2, i2, v, ix)) { v = v2; ix = i2; }
      }
      if (lane == 0) { rv[wid][r] = v; ri[wid][r] = ix; }
    }
    __syncthreads();
    if (tid < nr) {
      float v = rv[0][tid];
      int ix = ri[0][tid];
      for (int k = 1; k < kHeadTile / 32; ++k)
        if (better(rv[k][tid], ri[k][tid], v, ix)) { v = rv[k][tid]; ix = ri[k][tid]; }
      pval[(size_t)tile * B + r0 + tid] = v;
      pidx[(size_t)tile * B + r0 + tid] = ix;
    }
  }
}

__global__ void __launch_bounds__(256) lm_head_reduce_kernel(
    const float* __restrict__ pval, const int* __restrict__ pidx,
    int* __restrict__ out, int B, int n_tiles) {
  __shared__ float sv[256];
  __shared__ int si[256];
  const int b = blockIdx.x, tid = threadIdx.x;
  float v = -INFINITY;
  int ix = 0x7fffffff;
  for (int t = tid; t < n_tiles; t += blockDim.x) {
    const float v2 = pval[(size_t)t * B + b];
    const int i2 = pidx[(size_t)t * B + b];
    if (better(v2, i2, v, ix)) { v = v2; ix = i2; }
  }
  sv[tid] = v;
  si[tid] = ix;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s && better(sv[tid + s], si[tid + s], sv[tid], si[tid])) {
      sv[tid] = sv[tid + s];
      si[tid] = si[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) out[b] = si[0];
}

template <typename T>
int launch_head(const void* x, const void* w, void* pval, void* pidx,
                void* out, int B, int D, int V, cudaStream_t stream) {
  const int n_tiles = (V + kHeadTile - 1) / kHeadTile;
  const size_t smem = sizeof(float) * kHeadRows * D;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lm_head_partial_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lm_head_partial_kernel<T><<<n_tiles, kHeadTile, smem, stream>>>(
      (const T*)x, (const T*)w, (float*)pval, (int*)pidx, B, D, V);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lm_head_reduce_kernel<<<B, 256, 0, stream>>>(
      (const float*)pval, (const int*)pidx, (int*)out, B, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace spt

extern "C" int spt_lm_head_argmax(int dtype, const void* x, const void* w,
                                  void* pval, void* pidx, void* out, int B,
                                  int D, int V, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_head<__nv_bfloat16>
                               : spt::launch_head<float>;
  return f(x, w, pval, pidx, out, B, D, V, (cudaStream_t)stream);
}
