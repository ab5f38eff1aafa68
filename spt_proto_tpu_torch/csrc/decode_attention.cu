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
// decode_attention_walk_kernel computes either of the two on the two-pass
// walk of softmax_walk.cuh (the walk of csrc/paged_attention.cu), for
// tables whose scores do not fit in shared memory. A fourth kernel,
// verify_attention_kernel (the speculative block verify, replacing
// verify_attention_rows / _verify_kernel), shares the tile staging and
// keeps a two-pass walk of its own: each of its query rows sees a lane
// only up to its own block position, where the shared walk counts valid
// lanes per tile. The notes of both are at their definitions below.
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
#include "softmax_walk.cuh"

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


// ---------------------------------------------------------------------------
// two-pass walk (tables whose scores outgrow shared memory)
// ---------------------------------------------------------------------------
//
// decode_attention_walk_kernel computes what decode_attention_kernel (KT =
// T) and decode_attention_q_kernel (KT = int8_t) compute, for tables whose
// G x entries x PS f32 scores do not fit in shared memory (a dense
// Llama-3-8B table past 81 tiles in bf16). It runs the walk of
// softmax_walk.cuh with the one-pass kernels' numerics (kNormLast: one row
// max, then e, l, e v, and o = acc / l; int8 keys scaled per token after
// the dot product, the value scales folded into e); shared memory depends
// on G, D and PS only. The sums run in another order than the one-pass
// kernels' (an f32 rounding apart).

template <typename T, typename KT>
__global__ void __launch_bounds__(kWalkThreads) decode_attention_walk_kernel(
    // the caches are read after this CTA writes them: no __restrict__
    const T* __restrict__ q, KT* kc, KT* vc, int* cc, float* ksc, float* vsc,
    const int* __restrict__ tables, const int* __restrict__ n_tiles,
    const int* __restrict__ pos, const KT* __restrict__ kn,
    const KT* __restrict__ vn, const int* __restrict__ cn,
    const float* __restrict__ ksn, const float* __restrict__ vsn,
    const int* __restrict__ tile_base, T* __restrict__ o, int KV, int G,
    int D, int NTALL, int W, int KVP, int NTAB, int TM, int TPS, int PS,
    float scale, float clamp) {
  constexpr bool kQ = sizeof(KT) == 1;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * KV + h;

  extern __shared__ __align__(16) float sm[];
  const WalkSmem w = walk_smem(sm, G, D, PS, D * (PS + 1), kQ);

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
  if (kQ && tid == 0) {
    const size_t at = (((size_t)b * NTALL + wt) * KVP + h) * PS + wc;
    ksc[at] = ksn[bh];
    vsc[at] = vsn[bh];
  }
  for (int i = tid; i < G * D; i += blockDim.x) w.qs[i] = to_f(q[bh * G * D + i]);
  walk_init(w, G, D);
  __syncthreads();                   // the appended column is visible

  // entry j = t * TPS + u covers tile tables[t] + u; its valid lanes as
  // table_walk counts them
  const int* tab = tables + ((size_t)b * NTAB + h / (KV / NTAB)) * TM;
  const int n_t = n_tiles[b];
  auto tile_of = [&](int j) { return tab[j / TPS] + j % TPS; };
  auto nvalid = [&](int j) {
    const int t = j / TPS, e = tab[t], gt = e + j % TPS;
    const bool ok = e >= 0 && t < n_t && gt < NTALL;
    return !ok ? 0 : (gt == wt ? wc + 1 : (gt < wt ? PS : 0));
  };
  auto stage_k = [&](int j) {
    const int gt = tile_of(j);
    stage_f32<KT, T>(w.tile, kc + (bh * NTALL + gt) * D * PS, D, PS, nullptr);
    if constexpr (kQ) {
      const size_t at = (((size_t)b * NTALL + gt) * KVP + h) * PS;
      for (int t = tid; t < PS; t += blockDim.x) {
        w.ks[t] = ksc[at + t];
        w.vs[t] = vsc[at + t];
      }
    }
  };
  auto stage_v = [&](int j) {
    stage_f32<KT, T>(w.tile, vc + (bh * NTALL + tile_of(j)) * D * PS, D, PS,
                     nullptr);
  };
  softmax_walk<T, true>(w, TM * TPS, G, D, PS, 1, PS + 1, scale, clamp,
                        nvalid, stage_k, stage_v);
  for (int i = tid; i < G * D; i += blockDim.x)
    o[bh * G * D + i] = from_f<T>(w.acc[i]);
}

template <typename T, typename KT>
int launch_walk(const void* q, void* kc, void* vc, void* cc, void* ksc,
                void* vsc, const void* tables, const void* n_tiles,
                const void* pos, const void* kn, const void* vn,
                const void* cn, const void* ksn, const void* vsn,
                const void* tile_base, void* o, int B, int KV, int G, int D,
                int NTALL, int W, int KVP, int NTAB, int TM, int TPS, int PS,
                float scale, float clamp, cudaStream_t stream) {
  constexpr bool kQ = sizeof(KT) == 1;
  const size_t smem = walk_smem_bytes(G, D, PS, D * (PS + 1), kQ);
  auto kern = decode_attention_walk_kernel<T, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(KV, B);
  kern<<<grid, kWalkThreads, smem, stream>>>(
      (const T*)q, (KT*)kc, (KT*)vc, (int*)cc, (float*)ksc, (float*)vsc,
      (const int*)tables, (const int*)n_tiles, (const int*)pos,
      (const KT*)kn, (const KT*)vn, (const int*)cn, (const float*)ksn,
      (const float*)vsn, (const int*)tile_base, (T*)o, KV, G, D, NTALL, W,
      KVP, NTAB, TM, TPS, PS, scale, clamp);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// block verify (speculative decoding)
// ---------------------------------------------------------------------------
//
// verify_attention_kernel replaces the TPU kernel
// spt_proto_tpu/ops/pallas/decode_attention.py verify_attention_rows
// (_verify_kernel). It scores G*K query rows a (slot, kv head): K block
// columns of G query heads, row r being head r / K at block position
// j = r % K. It first appends the block's K new k/v columns (and codes when
// w > 1) where they land in the two write tiles, the table's last two
// entries, then attends over the table: an entry's lanes are visible to
// row r when its tile id is valid, bit j of its sel_mask entry is set, and
// the lane's position (tile - tile_base) * PS + lane is <= pos + j.
//
// Bound on the H100: memory at serving shapes. The tiles of the union
// table are read once (K and V) and the K new columns written; the math
// is 2 x 2 x D multiply-adds per (row, visible lane), GK times the decode
// step's, still far below the tensor-core line for GK <= 40.
//
// Design: one CTA per (slot, kv head), one thread per token lane. The TPU
// kernel's NBUF-deep per-head DMA ring and its tile-0 reads for -1
// entries exist for VMEM and are not carried over: the CTA walks only the
// valid entries. Scores are not kept: G*K rows x T entries x PS lanes of
// f32 outgrow shared memory at Llama-3-8B widths, so the walk is two
// passes over the K tiles. Pass 1 keeps each thread's running max of its
// lane per row; a warp reduction gives the row max. Pass 2 computes the
// scores again, e = exp(s - max) (the f32 sum l of the unrounded e kept
// per lane), stores e rounded to the cache dtype for this tile only, and
// adds e v over the staged V tile. The numerics are the TPU kernel's: the
// global row max before e is rounded, no rescaled online softmax, and
// o = pv / max(l, 1e-30).

constexpr int kVerifyRows = 8;   // query rows scored per pass over a K tile

template <typename T>
__global__ void verify_attention_kernel(
    // the caches are read after this CTA writes them: no __restrict__
    const T* __restrict__ q, T* kc, T* vc, int* cc,
    const int* __restrict__ tables, const int* __restrict__ selm,
    const int* __restrict__ pos, const T* __restrict__ kn,
    const T* __restrict__ vn, const int* __restrict__ cn,
    const int* __restrict__ tile_base, T* __restrict__ o, int KV, int GK,
    int KK, int D, int NTALL, int W, int TM, int PS, float scale,
    float clamp, int RC) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;   // blockDim.x == PS
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const size_t bh = (size_t)b * KV + h;
  // this CTA's query rows: [R0, R0 + NR) of the GK (one chunk: all)
  const int R0 = blockIdx.z * RC, NR = min(RC, GK - R0);
  const int GKP = (NR + kVerifyRows - 1) / kVerifyRows * kVerifyRows;
  constexpr int kRot = 4 / (int)sizeof(T);

  // the tile buffer comes first so its 16-byte stores stay aligned; q is
  // kept transposed, [D][GKP], so one float4 load gives four rows
  extern __shared__ __align__(16) float sm[];
  T* tile = reinterpret_cast<T*>(sm);                     // [D][PS]
  float* qT = sm + (size_t)D * PS * sizeof(T) / 4;        // [D][GKP]
  float* ev = qT + (size_t)D * GKP;      // [GKP][PS] lane max, then e
  float* lp = ev + (size_t)GKP * PS;     // [NR][PS] partial sums of e
  float* acc = lp + (size_t)NR * PS;     // [NR][D]
  float* rmax = acc + (size_t)NR * D;    // [GKP]
  float* rsum = rmax + GKP;              // [GKP]
  int* etile = reinterpret_cast<int*>(rsum + GKP);       // [TM]
  int* ebits = etile + TM;                               // [TM]

  // ---- append the block's K columns where they land in the write tiles
  // (chunk 0 only: the other chunks of a split block take the new columns
  // from kn / vn, see `overlay`, so no chunk reads a column mid-write)
  const int p = pos[b], base = tile_base[b];
  const int* tab = tables + bh * TM;
  const int w0 = max(tab[TM - 2], 0), w1 = max(tab[TM - 1], 0);
  const bool writer = blockIdx.z == 0;
  for (int i = tid; i < KK * D && writer; i += blockDim.x) {
    const int j = i / D, d = i % D;
    const int ti = base + (p + j) / PS, ci = (p + j) % PS;
    if ((ti == w0 || ti == w1) && ti < NTALL) {
      const size_t at = ((bh * NTALL + ti) * D + d) * PS + ci;
      kc[at] = kn[(bh * D + d) * KK + j];
      vc[at] = vn[(bh * D + d) * KK + j];
    }
  }
  if (W > 1 && writer) {   // codes: head 0's write tiles, as the TPU kernel
    const int* tab0 = tables + (size_t)b * KV * TM;
    const int c0 = max(tab0[TM - 2], 0), c1 = max(tab0[TM - 1], 0);
    for (int i = tid; i < KK * W; i += blockDim.x) {
      const int j = i / W, s = i % W;
      const int ti = base + (p + j) / PS, ci = (p + j) % PS;
      if ((ti == c0 || ti == c1) && ti < NTALL)
        cc[((bh * NTALL + ti) * W + s) * PS + ci] = cn[(bh * W + s) * KK + j];
    }
  }
  for (int i = tid; i < GKP * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    qT[d * GKP + r] = r < NR ? to_f(q[(bh * GK + R0 + r) * D + d]) : 0.f;
  }
  for (int e = tid; e < TM; e += blockDim.x) {
    const int t = tab[e], bits = selm[bh * TM + e];
    etile[e] = (t >= 0 && t < NTALL && bits != 0) ? t : -1;
    ebits[e] = bits;
  }
  for (int r = 0; r < GKP; ++r) ev[r * PS + tid] = r < NR ? kNeg : 0.f;
  for (int r = 0; r < NR; ++r) lp[r * PS + tid] = 0.f;
  for (int i = tid; i < NR * D; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  // a chunk other than 0 puts the block's new columns of staged tile t
  // into its shared copy, wherever chunk 0's append may not have landed
  auto overlay = [&](const T* src, int t) {
    if (writer || (t != w0 && t != w1)) return;   // uniform over the CTA
    for (int i = tid; i < KK * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      if (base + (p + j) / PS == t && t < NTALL)
        tile[d * PS + (p + j) % PS] = src[(bh * D + d) * KK + j];
    }
    __syncthreads();
  };

  // scaled, clamped scores of rows [r0, r0 + 8) at this thread's lane of
  // the staged K tile
  auto scores = [&](int r0, float* s) {
#pragma unroll
    for (int u = 0; u < kVerifyRows; ++u) s[u] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = to_f(tile[d * PS + tid]);
      const float4 a = *reinterpret_cast<const float4*>(qT + d * GKP + r0);
      const float4 c =
          *reinterpret_cast<const float4*>(qT + d * GKP + r0 + 4);
      s[0] += a.x * kd; s[1] += a.y * kd; s[2] += a.z * kd; s[3] += a.w * kd;
      s[4] += c.x * kd; s[5] += c.y * kd; s[6] += c.z * kd; s[7] += c.w * kd;
    }
#pragma unroll
    for (int u = 0; u < kVerifyRows; ++u) {
      s[u] *= scale;
      if (clamp > 0.f) s[u] = fminf(fmaxf(s[u], -clamp), clamp);
    }
  };

  // ---- pass 1: each row's max over its visible lanes
  for (int e = 0; e < TM; ++e) {
    const int t = etile[e];
    if (t < 0) continue;              // the same for every thread
    stage_tile(tile, kc + (bh * NTALL + t) * D * PS, D * PS * (int)sizeof(T));
    __syncthreads();
    overlay(kn, t);
    const int bits = ebits[e], gpos = (t - base) * PS + tid;
    for (int r0 = 0; r0 < NR; r0 += kVerifyRows) {
      float s[kVerifyRows];
      scores(r0, s);
#pragma unroll
      for (int u = 0; u < kVerifyRows; ++u) {
        const int r = r0 + u, j = (R0 + r) % KK;
        if (r < NR && ((bits >> j) & 1) && gpos <= p + j)
          ev[r * PS + tid] = fmaxf(ev[r * PS + tid], s[u]);
      }
    }
    __syncthreads();
  }
  for (int r = warp; r < NR; r += nw) {
    float m = kNeg;
    for (int k = lane; k < PS; k += 32) m = fmaxf(m, ev[r * PS + k]);
    m = warp_max(m);
    if (lane == 0) rmax[r] = m;
  }
  __syncthreads();

  // ---- pass 2: e, its sum, and o += e v, one tile at a time
  for (int e = 0; e < TM; ++e) {
    const int t = etile[e];
    if (t < 0) continue;
    stage_tile(tile, kc + (bh * NTALL + t) * D * PS, D * PS * (int)sizeof(T));
    __syncthreads();
    overlay(kn, t);
    const int bits = ebits[e], gpos = (t - base) * PS + tid;
    for (int r0 = 0; r0 < NR; r0 += kVerifyRows) {
      float s[kVerifyRows];
      scores(r0, s);
#pragma unroll
      for (int u = 0; u < kVerifyRows; ++u) {
        const int r = r0 + u, j = (R0 + r) % KK;
        if (r >= NR) continue;
        float x = 0.f;
        if (((bits >> j) & 1) && gpos <= p + j) {
          x = expf(s[u] - rmax[r]);
          lp[r * PS + tid] += x;
        }
        ev[r * PS + tid] = rt<T>(x);
      }
    }
    __syncthreads();
    stage_tile(tile, vc + (bh * NTALL + t) * D * PS, D * PS * (int)sizeof(T));
    __syncthreads();
    overlay(vn, t);
    // o += e v: a thread per d, rows in chunks of 8 so each value is read
    // once a chunk; lanes in an order rotated by d, so the reads of a warp
    // fall in distinct shared-memory banks (ev's pad rows are 0)
    for (int d = tid; d < D; d += blockDim.x) {
      const T* vrow = tile + d * PS;
      const int rot = (kRot * d) % PS;
      for (int r0 = 0; r0 < NR; r0 += kVerifyRows) {
        float a[kVerifyRows];
#pragma unroll
        for (int u = 0; u < kVerifyRows; ++u) a[u] = 0.f;
        for (int k = 0; k < PS; ++k) {
          int pp = k + rot;
          if (pp >= PS) pp -= PS;
          const float vv = to_f(vrow[pp]);
          const float* ec = ev + (size_t)r0 * PS + pp;
#pragma unroll
          for (int u = 0; u < kVerifyRows; ++u) a[u] += ec[u * PS] * vv;
        }
#pragma unroll
        for (int u = 0; u < kVerifyRows; ++u)
          if (r0 + u < NR) acc[(r0 + u) * D + d] += a[u];
      }
    }
    __syncthreads();
  }
  for (int r = warp; r < NR; r += nw) {
    float l = 0.f;
    for (int k = lane; k < PS; k += 32) l += lp[r * PS + k];
    l = warp_sum(l);
    if (lane == 0) rsum[r] = l;
  }
  __syncthreads();
  for (int i = tid; i < NR * D; i += blockDim.x)
    o[(bh * GK + R0) * D + i] =
        from_f<T>(acc[i] / fmaxf(rsum[i / D], 1e-30f));
}

template <typename T>
int launch_verify(const void* q, void* kc, void* vc, void* cc,
                  const void* tables, const void* selm, const void* pos,
                  const void* kn, const void* vn, const void* cn,
                  const void* tile_base, void* o, int B, int KV, int GK,
                  int KK, int D, int NTALL, int W, int TM, int PS,
                  float scale, float clamp, int RC, cudaStream_t stream) {
  // RC query rows a CTA: GK (one chunk), or fewer when the rows' buffers
  // outgrow shared memory (ops/decode_attention.py verify_rows_per_cta)
  const int GKP = (RC + kVerifyRows - 1) / kVerifyRows * kVerifyRows;
  // verify_attention_rows in ops/decode_attention.py computes the same
  const size_t smem = sizeof(T) * (size_t)D * PS +
                      sizeof(float) * ((size_t)D * GKP + (size_t)GKP * PS +
                                       (size_t)RC * PS + (size_t)RC * D +
                                       2 * GKP) +
                      sizeof(int) * 2 * TM;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        verify_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(KV, B, (GK + RC - 1) / RC);
  verify_attention_kernel<T><<<grid, PS, smem, stream>>>(
      (const T*)q, (T*)kc, (T*)vc, (int*)cc, (const int*)tables,
      (const int*)selm, (const int*)pos, (const T*)kn, (const T*)vn,
      (const int*)cn, (const int*)tile_base, (T*)o, KV, GK, KK, D, NTALL, W,
      TM, PS, scale, clamp, RC);
  return (int)cudaGetLastError();
}

}  // namespace spt

// two_pass: 0 = the one-pass kernel (scores kept in shared memory), 1 = the
// two-pass walk (ops/decode_attention.py chooses by shared memory)
extern "C" int spt_decode_attention(
    int dtype, int two_pass, const void* q, void* kc, void* vc, void* cc,
    const void* tables, const void* n_tiles, const void* pos, const void* kn,
    const void* vn, const void* cn, const void* tile_base, void* o, int B,
    int KV, int G, int D, int NTALL, int W, int NTAB, int TM, int TPS, int PS,
    float scale, float clamp, void* stream) {
  using bf = __nv_bfloat16;
  if (two_pass) {
    auto f = dtype == spt::kBF16 ? spt::launch_walk<bf, bf>
                                 : spt::launch_walk<float, float>;
    return f(q, kc, vc, cc, nullptr, nullptr, tables, n_tiles, pos, kn, vn,
             cn, nullptr, nullptr, tile_base, o, B, KV, G, D, NTALL, W, 0,
             NTAB, TM, TPS, PS, scale, clamp, (cudaStream_t)stream);
  }
  auto f = dtype == spt::kBF16 ? spt::launch_attention<bf>
                               : spt::launch_attention<float>;
  return f(q, kc, vc, cc, tables, n_tiles, pos, kn, vn, cn, tile_base, o, B,
           KV, G, D, NTALL, W, NTAB, TM, TPS, PS, scale, clamp,
           (cudaStream_t)stream);
}

extern "C" int spt_decode_attention_q(
    int dtype, int two_pass, const void* q, void* kc, void* vc, void* cc,
    void* ksc, void* vsc, const void* tables, const void* n_tiles,
    const void* pos, const void* kn, const void* vn, const void* cn,
    const void* ksn, const void* vsn, const void* tile_base, void* o, int B,
    int KV, int G, int D, int NTALL, int W, int KVP, int NTAB, int TM,
    int TPS, int PS, float scale, float clamp, void* stream) {
  using bf = __nv_bfloat16;
  auto f = two_pass
               ? (dtype == spt::kBF16 ? spt::launch_walk<bf, int8_t>
                                      : spt::launch_walk<float, int8_t>)
               : (dtype == spt::kBF16 ? spt::launch_attention_q<bf>
                                      : spt::launch_attention_q<float>);
  return f(q, kc, vc, cc, ksc, vsc, tables, n_tiles, pos, kn, vn, cn, ksn,
           vsn, tile_base, o, B, KV, G, D, NTALL, W, KVP, NTAB, TM, TPS, PS,
           scale, clamp, (cudaStream_t)stream);
}

extern "C" int spt_verify_attention(
    int dtype, const void* q, void* kc, void* vc, void* cc,
    const void* tables, const void* selm, const void* pos, const void* kn,
    const void* vn, const void* cn, const void* tile_base, void* o, int B,
    int KV, int GK, int KK, int D, int NTALL, int W, int TM, int PS,
    float scale, float clamp, int RC, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_verify<__nv_bfloat16>
                               : spt::launch_verify<float>;
  return f(q, kc, vc, cc, tables, selm, pos, kn, vn, cn, tile_base, o, B, KV,
           GK, KK, D, NTALL, W, TM, PS, scale, clamp, RC,
           (cudaStream_t)stream);
}
