// Decode attention over tile tables, with the new token's k/v/codes (and,
// for an int8 cache, its scales) appended to the caches in place. Two
// kernels share one table walk:
//
//   decode_attention_kernel   bf16/f32 cache. Replaces the TPU kernels
//     spt_proto_tpu/ops/pallas/decode_attention.py decode_attention_rows
//     (_rows_kernel) and decode_attention_rows_ms (_rows_kernel_ms).
//   decode_attention_q_kernel int8 cache with per-token f32 scales.
//     Replaces decode_attention_rows_q (_rows_kernel_q) and
//     decode_attention_rows_q_ms (_rows_kernel_q_ms).
//
// Each TPU pair differs only in how the TPU launches it (one program per
// slot vs one program for all slots), so one kernel serves both.
//
// Bound on the H100: memory. Per launch at OPT-125M (B=8, ctx 2048):
// dense bf16 reads K+V of 96 (slot, head) rows x 2048 tokens x 64 x 2 B =
// 50.3 MB, 15 us at 3.35 TB/s; sparse bf16 (3 tiles a row) 9.4 MB, 2.8 us;
// sparse int8 4.7 MB of K/V plus 0.3 MB of scales, 1.5 us. The math is
// 2 x 2 x 64 multiply-adds per token, far below the tensor-core line.
//
// Design: one CTA per (slot, kv head), one thread per token lane of a tile.
// The CTA first writes the new token into its write tile (the counterpart
// of the TPU kernels' input_output_aliases), synchronises, then walks its
// table row (head h reads row h / (KV / N_TAB)): entry t covers the TPS
// tiles [tables[t], tables[t] + TPS), so the walk is over j = t * TPS + u.
// The TPU's supertile DMAs and head chunking exist for VMEM and are not
// carried over. Each K tile is staged in shared memory with 16-byte loads,
// scores are masked to the tokens that exist (full tiles below the write
// tile, the write tile up to the new token, nothing past it; -1 entries and
// entries at or past n_tiles are empty), and the softmax is exact: two
// passes over the scores kept in shared memory. Numerics follow the TPU
// kernels: f32 scores from f32-cast q and k, clamp only when > 0, and
// o = sum_p e_p v_p / sum_p e_p with e_p = exp(s_p - max). The bf16/f32
// kernel rounds the unnormalised e_p to the cache dtype before the PV
// product; the int8 kernel folds the value scales into e_p instead.
#include "common.cuh"

namespace spt {

// Copy nbytes (a multiple of 16) with 16-byte loads, eight in flight per
// thread before the stores.
__device__ __forceinline__ void stage_tile(void* dst, const void* src,
                                           int nbytes) {
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  const int n = nbytes / 16;
  for (int i0 = threadIdx.x; i0 < n; i0 += 8 * blockDim.x) {
    int4 r[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) r[u] = s4[i];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) d4[i] = r[u];
    }
  }
}

// Per walk step j = t * TPS + u: its physical tile and how many of its
// token lanes count (0 = empty).
__device__ __forceinline__ void table_walk(
    const int* tables, const int* n_tiles, int b, int h, int KV, int NTAB,
    int TM, int TPS, int NTALL, int PS, int wt, int wc, int* nv, int* tile) {
  const int* tab = tables + ((size_t)b * NTAB + h / (KV / NTAB)) * TM;
  const int n_t = n_tiles[b];
  for (int j = threadIdx.x; j < TM * TPS; j += blockDim.x) {
    const int t = j / TPS, e = tab[t];
    const int gt = e + j % TPS;
    const bool ok = e >= 0 && t < n_t && gt < NTALL;
    nv[j] = !ok ? 0 : (gt == wt ? wc + 1 : (gt < wt ? PS : 0));
    tile[j] = gt;
  }
}

// ---------------------------------------------------------------------------
// bf16 / f32 cache
// ---------------------------------------------------------------------------

template <typename T>
__global__ void decode_attention_kernel(
    // the caches are read after this CTA writes them: no __restrict__
    const T* __restrict__ q, T* kc, T* vc, int* cc,
    const int* __restrict__ tables, const int* __restrict__ n_tiles,
    const int* __restrict__ pos, const T* __restrict__ kn,
    const T* __restrict__ vn, const int* __restrict__ cn,
    const int* __restrict__ tile_base, T* __restrict__ o, int KV, int G,
    int D, int NTALL, int W, int NTAB, int TM, int TPS, int PS, float scale,
    float clamp) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;   // blockDim.x == PS
  const size_t bh = (size_t)b * KV + h;
  const int NE = TM * TPS;
  // lane rotation per value row so one warp's reads hit distinct banks
  constexpr int kRot = 4 / (int)sizeof(T);

  // the tile buffer comes first so its 16-byte stores stay aligned
  extern __shared__ __align__(16) float sm[];
  T* tile = reinterpret_cast<T*>(sm);                     // [D][PS]
  float* qs = sm + (size_t)D * PS * sizeof(T) / 4;        // [G][D]
  float* sc = qs + G * D;                  // [G][NE][PS] scores, then e
  float* acc = sc + (size_t)G * NE * PS;   // [G][D]
  float* red = acc + G * D;                // [32]
  int* nv = reinterpret_cast<int*>(red + 32);            // [NE]
  int* gtile = nv + NE;                                  // [NE]

  // ---- append the new token in place (codes only when w > 1, as the TPU
  // kernel: a dense cache keeps its one zero column)
  const int p = pos[b];
  const int wt = tile_base[b] + p / PS, wc = p % PS;
  for (int d = tid; d < D; d += blockDim.x) {
    const size_t at = ((bh * NTALL + wt) * D + d) * PS + wc;
    kc[at] = kn[bh * D + d];
    vc[at] = vn[bh * D + d];
  }
  if (W > 1)
    for (int s = tid; s < W; s += blockDim.x)
      cc[((bh * NTALL + wt) * W + s) * PS + wc] = cn[bh * W + s];
  for (int i = tid; i < G * D; i += blockDim.x)
    qs[i] = to_f(q[bh * G * D + i]);
  table_walk(tables, n_tiles, b, h, KV, NTAB, TM, TPS, NTALL, PS, wt, wc, nv,
             gtile);
  __syncthreads();

  // ---- scores
  for (int j = 0; j < NE; ++j) {
    const int n = nv[j];
    if (n == 0) {
      for (int g = 0; g < G; ++g) sc[((size_t)g * NE + j) * PS + tid] = kNeg;
      continue;
    }
    stage_tile(tile, kc + (bh * NTALL + gtile[j]) * D * PS,
               D * PS * (int)sizeof(T));
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qs[g * D + d] * to_f(tile[d * PS + tid]);
      float s = dot * scale;
      if (clamp > 0.f) s = fminf(fmaxf(s, -clamp), clamp);
      sc[((size_t)g * NE + j) * PS + tid] = tid < n ? s : kNeg;
    }
    __syncthreads();
  }

  // ---- softmax statistics per query row; e rounded to the cache dtype
  float lsum[8];
  for (int g = 0; g < G; ++g) {
    float m = kNeg;
    for (int j = 0; j < NE; ++j) m = fmaxf(m, sc[((size_t)g * NE + j) * PS + tid]);
    m = block_max(m, red);
    float l = 0.f;
    for (int j = 0; j < NE; ++j) {
      float* sp = &sc[((size_t)g * NE + j) * PS + tid];
      const float e = tid < nv[j] ? expf(*sp - m) : 0.f;
      *sp = rt<T>(e);
      l += e;
    }
    lsum[g] = block_sum(l, red);
  }
  for (int i = tid; i < G * D; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  // ---- o = sum over lanes of e v
  for (int j = 0; j < NE; ++j) {
    if (nv[j] == 0) continue;
    stage_tile(tile, vc + (bh * NTALL + gtile[j]) * D * PS,
               D * PS * (int)sizeof(T));
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      const float* ev = sc + ((size_t)g * NE + j) * PS;
      const T* vrow = tile + d * PS;
      float a = 0.f;
      for (int k = 0; k < PS; ++k) {
        const int pp = (k + kRot * d) % PS;
        a += ev[pp] * to_f(vrow[pp]);
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
int launch_attention(const void* q, void* kc, void* vc, void* cc,
                     const void* tables, const void* n_tiles, const void* pos,
                     const void* kn, const void* vn, const void* cn,
                     const void* tile_base, void* o, int B, int KV, int G,
                     int D, int NTALL, int W, int NTAB, int TM, int TPS,
                     int PS, float scale, float clamp, cudaStream_t stream) {
  const int NE = TM * TPS;
  const size_t smem = sizeof(T) * (size_t)D * PS +
                      sizeof(float) * (2 * G * D + (size_t)G * NE * PS + 32) +
                      sizeof(int) * 2 * NE;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(KV, B);
  decode_attention_kernel<T><<<grid, PS, smem, stream>>>(
      (const T*)q, (T*)kc, (T*)vc, (int*)cc, (const int*)tables,
      (const int*)n_tiles, (const int*)pos, (const T*)kn, (const T*)vn,
      (const int*)cn, (const int*)tile_base, (T*)o, KV, G, D, NTALL, W, NTAB,
      TM, TPS, PS, scale, clamp);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 cache
// ---------------------------------------------------------------------------

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
    int D, int NTALL, int W, int KVP, int NTAB, int TM, int TPS, int PS,
    float scale, float clamp) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;   // blockDim.x == PS
  const size_t bh = (size_t)b * KV + h;
  const int NE = TM * TPS;

  // the int8 tile buffer comes first so its 16-byte stores stay aligned
  extern __shared__ __align__(16) float sm[];
  int8_t* tile = reinterpret_cast<int8_t*>(sm);          // [D][PS]
  float* qs = sm + D * PS / 4;             // [G][D]
  float* sc = qs + G * D;                  // [G][NE][PS] scores, then e*vs
  float* acc = sc + (size_t)G * NE * PS;   // [G][D]
  float* red = acc + G * D;                // [32]
  int* nv = reinterpret_cast<int*>(red + 32);            // [NE]
  int* gtile = nv + NE;                                  // [NE]

  // ---- append the new token in place
  const int p = pos[b];
  const int wt = tile_base[b] + p / PS, wc = p % PS;
  for (int d = tid; d < D; d += blockDim.x) {
    const size_t at = ((bh * NTALL + wt) * D + d) * PS + wc;
    kc[at] = kn[bh * D + d];
    vc[at] = vn[bh * D + d];
  }
  if (W > 1)
    for (int s = tid; s < W; s += blockDim.x)
      cc[((bh * NTALL + wt) * W + s) * PS + wc] = cn[bh * W + s];
  if (tid == 0) {
    const size_t at = (((size_t)b * NTALL + wt) * KVP + h) * PS + wc;
    ksc[at] = ksn[bh];
    vsc[at] = vsn[bh];
  }
  for (int i = tid; i < G * D; i += blockDim.x)
    qs[i] = to_f(q[bh * G * D + i]);
  table_walk(tables, n_tiles, b, h, KV, NTAB, TM, TPS, NTALL, PS, wt, wc, nv,
             gtile);
  __syncthreads();

  // ---- scores
  for (int j = 0; j < NE; ++j) {
    const int n = nv[j];
    if (n == 0) {
      for (int g = 0; g < G; ++g) sc[((size_t)g * NE + j) * PS + tid] = kNeg;
      continue;
    }
    const int e = gtile[j];
    stage_tile(tile, kc + (bh * NTALL + e) * D * PS, D * PS);
    __syncthreads();
    const float kscale = ksc[(((size_t)b * NTALL + e) * KVP + h) * PS + tid];
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qs[g * D + d] * (float)tile[d * PS + tid];
      float s = dot * scale * kscale;
      if (clamp > 0.f) s = fminf(fmaxf(s, -clamp), clamp);
      sc[((size_t)g * NE + j) * PS + tid] = tid < n ? s : kNeg;
    }
    __syncthreads();
  }

  // ---- softmax statistics per query row; fold the value scales into e
  float lsum[8];
  for (int g = 0; g < G; ++g) {
    float m = kNeg;
    for (int j = 0; j < NE; ++j) m = fmaxf(m, sc[((size_t)g * NE + j) * PS + tid]);
    m = block_max(m, red);
    float l = 0.f;
    for (int j = 0; j < NE; ++j) {
      float* sp = &sc[((size_t)g * NE + j) * PS + tid];
      float e = 0.f;
      if (tid < nv[j]) {
        e = expf(*sp - m);
        *sp = e * vsc[(((size_t)b * NTALL + gtile[j]) * KVP + h) * PS + tid];
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
  for (int j = 0; j < NE; ++j) {
    if (nv[j] == 0) continue;
    stage_tile(tile, vc + (bh * NTALL + gtile[j]) * D * PS, D * PS);
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      const float* ev = sc + ((size_t)g * NE + j) * PS;
      const int8_t* vrow = tile + d * PS;
      float a = 0.f;
      for (int k = 0; k < PS; ++k) {
        const int pp = (k + 4 * d) % PS;
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
int launch_attention_q(const void* q, void* kc, void* vc, void* cc, void* ksc,
                       void* vsc, const void* tables, const void* n_tiles,
                       const void* pos, const void* kn, const void* vn,
                       const void* cn, const void* ksn, const void* vsn,
                       const void* tile_base, void* o, int B, int KV, int G,
                       int D, int NTALL, int W, int KVP, int NTAB, int TM,
                       int TPS, int PS, float scale, float clamp,
                       cudaStream_t stream) {
  const int NE = TM * TPS;
  const size_t smem = sizeof(float) * (2 * G * D + (size_t)G * NE * PS + 32) +
                      sizeof(int) * 2 * NE + (size_t)D * PS;
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
      KV, G, D, NTALL, W, KVP, NTAB, TM, TPS, PS, scale, clamp);
  return (int)cudaGetLastError();
}

}  // namespace spt

extern "C" int spt_decode_attention(
    int dtype, const void* q, void* kc, void* vc, void* cc,
    const void* tables, const void* n_tiles, const void* pos, const void* kn,
    const void* vn, const void* cn, const void* tile_base, void* o, int B,
    int KV, int G, int D, int NTALL, int W, int NTAB, int TM, int TPS, int PS,
    float scale, float clamp, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_attention<__nv_bfloat16>
                               : spt::launch_attention<float>;
  return f(q, kc, vc, cc, tables, n_tiles, pos, kn, vn, cn, tile_base, o, B,
           KV, G, D, NTALL, W, NTAB, TM, TPS, PS, scale, clamp,
           (cudaStream_t)stream);
}

extern "C" int spt_decode_attention_q(
    int dtype, const void* q, void* kc, void* vc, void* cc, void* ksc,
    void* vsc, const void* tables, const void* n_tiles, const void* pos,
    const void* kn, const void* vn, const void* cn, const void* ksn,
    const void* vsn, const void* tile_base, void* o, int B, int KV, int G,
    int D, int NTALL, int W, int KVP, int NTAB, int TM, int TPS, int PS,
    float scale, float clamp, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_attention_q<__nv_bfloat16>
                               : spt::launch_attention_q<float>;
  return f(q, kc, vc, cc, ksc, vsc, tables, n_tiles, pos, kn, vn, cn, ksn,
           vsn, tile_base, o, B, KV, G, D, NTALL, W, KVP, NTAB, TM, TPS, PS,
           scale, clamp, (cudaStream_t)stream);
}
