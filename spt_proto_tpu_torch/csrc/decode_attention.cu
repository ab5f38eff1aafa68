// int8-KV sparse decode attention over per-(slot, kv-head) tile tables,
// with the new token's k8/v8/codes/scales appended to the caches in place.
//
// Replaces the TPU kernels spt_proto_tpu/ops/pallas/decode_attention.py
// decode_attention_rows_q_ms (_rows_kernel_q_ms) and decode_attention_rows_q
// (_rows_kernel_q): the two differ only in how the TPU launches them (all
// slots in one program vs one program per slot), so one kernel serves both.
//
// Bound on the H100: memory. Per launch at OPT-125M (B=8, ctx 2048, 3 tiles
// per table) it must read 96 tables x 3 tiles x 128 x 64 B of int8 K and V
// (4.7 MB) plus their per-token f32 scales (0.3 MB): ~5 MB, 1.5 us at
// 3.35 TB/s. The math is 2 x 96 x 3 x 128 x 64 multiply-adds, negligible.
//
// Design: one CTA per (slot, kv head), one thread per token lane of a tile.
// The CTA first writes the new token into its write tile (the caches are
// updated in place: the counterpart of the TPU kernel's
// input_output_aliases), synchronises, then walks the table: each K tile is
// staged in shared memory with 16-byte loads, scores are
// (q . k8) * scale * kscale, clamped to +-clamp, and masked to the tokens
// that exist (full tiles below the write tile, the write tile up to the new
// token, nothing past it; -1 entries and entries at or past n_tiles are
// empty). The softmax is exact (two passes over at most a few tiles of
// scores kept in shared memory); the value dequant folds into the
// probabilities: o = sum_p (e_p * vscale_p) v8_p / sum_p e_p.
#include "common.cuh"

namespace spt {

__device__ __forceinline__ void stage_tile(int8_t* dst, const int8_t* src,
                                           int nbytes) {
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x) d4[i] = s4[i];
}

template <typename T>
__global__ void decode_attention_q_kernel(
    // the caches are read after this CTA writes them: no __restrict__
    const T* __restrict__ q, int8_t* kc, int8_t* vc, int* cc, float* ksc,
    float* vsc,
    const int* __restrict__ tables, const int* __restrict__ n_tiles,
    const int* __restrict__ pos, const int8_t* __restrict__ kn,
    const int8_t* __restrict__ vn, const int* __restrict__ cn,
    const float* __restrict__ ksn, const float* __restrict__ vsn,
    const int* __restrict__ tile_base, T* __restrict__ o, int KV, int G,
    int D, int NTALL, int W, int KVP, int TM, int PS, float scale,
    float clamp) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;   // blockDim.x == PS
  const size_t bh = (size_t)b * KV + h;

  // the int8 tile buffer comes first so its 16-byte stores stay aligned
  extern __shared__ __align__(16) float sm[];
  int8_t* tile = reinterpret_cast<int8_t*>(sm);          // [D][PS]
  float* qs = sm + D * PS / 4;             // [G][D]
  float* sc = qs + G * D;                  // [G][TM][PS] scores, then e*vs
  float* acc = sc + (size_t)G * TM * PS;   // [G][D]
  float* red = acc + G * D;                // [32]
  int* nv = reinterpret_cast<int*>(red + 32);            // [TM]
  int* tid_t = nv + TM;                                  // [TM]

  // ---- append the new token in place
  const int p = pos[b];
  const int wt = tile_base[b] + p / PS, wc = p % PS;
  for (int d = tid; d < D; d += blockDim.x) {
    const size_t at = ((bh * NTALL + wt) * D + d) * PS + wc;
    kc[at] = kn[bh * D + d];
    vc[at] = vn[bh * D + d];
  }
  for (int s = tid; s < W; s += blockDim.x)
    cc[((bh * NTALL + wt) * W + s) * PS + wc] = cn[bh * W + s];
  if (tid == 0) {
    const size_t at = (((size_t)b * NTALL + wt) * KVP + h) * PS + wc;
    ksc[at] = ksn[bh];
    vsc[at] = vsn[bh];
  }
  for (int i = tid; i < G * D; i += blockDim.x)
    qs[i] = to_f(q[bh * G * D + i]);
  if (tid < TM) {
    const int e = tables[bh * TM + tid];
    const bool ok = e >= 0 && e < NTALL && tid < n_tiles[b];
    nv[tid] = !ok ? 0 : (e == wt ? wc + 1 : (e < wt ? PS : 0));
    tid_t[tid] = e;
  }
  __syncthreads();

  // ---- scores
  for (int t = 0; t < TM; ++t) {
    const int n = nv[t];
    if (n == 0) {
      for (int g = 0; g < G; ++g) sc[((size_t)g * TM + t) * PS + tid] = kNeg;
      continue;
    }
    const int e = tid_t[t];
    stage_tile(tile, kc + (bh * NTALL + e) * D * PS, D * PS);
    __syncthreads();
    const float kscale = ksc[(((size_t)b * NTALL + e) * KVP + h) * PS + tid];
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qs[g * D + d] * (float)tile[d * PS + tid];
      float s = dot * scale * kscale;
      if (clamp > 0.f) s = fminf(fmaxf(s, -clamp), clamp);
      sc[((size_t)g * TM + t) * PS + tid] = tid < n ? s : kNeg;
    }
    __syncthreads();
  }

  // ---- softmax statistics per query row; fold the value scales into e
  float lsum[8];
  for (int g = 0; g < G; ++g) {
    float m = kNeg;
    for (int t = 0; t < TM; ++t) m = fmaxf(m, sc[((size_t)g * TM + t) * PS + tid]);
    m = block_max(m, red);
    float l = 0.f;
    for (int t = 0; t < TM; ++t) {
      float* sp = &sc[((size_t)g * TM + t) * PS + tid];
      float e = 0.f;
      if (tid < nv[t]) {
        e = expf(*sp - m);
        const int te = tid_t[t];
        *sp = e * vsc[(((size_t)b * NTALL + te) * KVP + h) * PS + tid];
      } else {
        *sp = 0.f;
      }
      l += e;
    }
    lsum[g] = block_sum(l, red);
  }
  for (int i = tid; i < G * D; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  // ---- o = sum over lanes of (e * vscale) v8; lane order rotated per d so
  // the byte reads of one warp fall in distinct shared-memory banks
  for (int t = 0; t < TM; ++t) {
    if (nv[t] == 0) continue;
    stage_tile(tile, vc + (bh * NTALL + tid_t[t]) * D * PS, D * PS);
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      const float* ev = sc + ((size_t)g * TM + t) * PS;
      const int8_t* vrow = tile + d * PS;
      float a = 0.f;
      for (int j = 0; j < PS; ++j) {
        const int pp = (j + 4 * d) % PS;
        a += ev[pp] * (float)vrow[pp];
      }
      acc[i] += a;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D;
    o[bh * G * D + i] = from_f<T>(acc[i] / fmaxf(lsum[g], 1e-30f));
  }
}

template <typename T>
int launch_attention(const void* q, void* kc, void* vc, void* cc, void* ksc,
                     void* vsc, const void* tables, const void* n_tiles,
                     const void* pos, const void* kn, const void* vn,
                     const void* cn, const void* ksn, const void* vsn,
                     const void* tile_base, void* o, int B, int KV, int G,
                     int D, int NTALL, int W, int KVP, int TM, int PS,
                     float scale, float clamp, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * G * D + (size_t)G * TM * PS + 32) +
                      sizeof(int) * 2 * TM + (size_t)D * PS;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_q_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(KV, B);
  decode_attention_q_kernel<T><<<grid, PS, smem, stream>>>(
      (const T*)q, (int8_t*)kc, (int8_t*)vc, (int*)cc, (float*)ksc,
      (float*)vsc, (const int*)tables, (const int*)n_tiles, (const int*)pos,
      (const int8_t*)kn, (const int8_t*)vn, (const int*)cn,
      (const float*)ksn, (const float*)vsn, (const int*)tile_base, (T*)o,
      KV, G, D, NTALL, W, KVP, TM, PS, scale, clamp);
  return (int)cudaGetLastError();
}

}  // namespace spt

extern "C" int spt_decode_attention_q(
    int dtype, const void* q, void* kc, void* vc, void* cc, void* ksc,
    void* vsc, const void* tables, const void* n_tiles, const void* pos,
    const void* kn, const void* vn, const void* cn, const void* ksn,
    const void* vsn, const void* tile_base, void* o, int B, int KV, int G,
    int D, int NTALL, int W, int KVP, int TM, int PS, float scale,
    float clamp, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_attention<__nv_bfloat16>
                               : spt::launch_attention<float>;
  return f(q, kc, vc, cc, ksc, vsc, tables, n_tiles, pos, kn, vn, cn, ksn,
           vsn, tile_base, o, B, KV, G, D, NTALL, W, KVP, TM, PS, scale,
           clamp, (cudaStream_t)stream);
}
