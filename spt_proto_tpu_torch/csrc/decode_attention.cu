// Decode attention over tile tables, with the new token's k/v/codes (and,
// for an int8 cache, its scales) appended to the caches in place. Two
// kernels share one table walk:
//
//   decode_attention_kernel   bf16/f32 cache. Replaces the TPU kernels
//     spt_proto_tpu/ops/pallas/decode_attention.py decode_attention_rows
//     (_rows_kernel) and decode_attention_rows_ms (_rows_kernel_ms); in
//     bf16 (the serving dtype) decode_attention_split_kernel takes its
//     place and the walk's: each row's table split over a cluster of CTAs,
//     both products on the tensor cores (its notes are at its definition).
//   decode_attention_q_kernel int8 cache with per-token f32 scales.
//     Replaces decode_attention_rows_q (_rows_kernel_q) and
//     decode_attention_rows_q_ms (_rows_kernel_q_ms); in bf16 (the
//     serving dtype) decode_attention_q_split_kernel takes its place: each
//     row's table split over CTAs, both products on the tensor cores (its
//     notes are at its definition below).
//
// decode_attention_walk_kernel computes either of the two on the two-pass
// walk of softmax_walk.cuh (the walk of csrc/paged_attention.cu), for
// tables whose scores do not fit in shared memory. A fourth kernel,
// verify_attention_kernel (the speculative block verify, replacing
// verify_attention_rows / _verify_kernel), shares the tile staging and
// keeps a two-pass walk of its own: each of its query rows sees a lane
// only up to its own block position, where the shared walk counts valid
// lanes per tile; in bf16 (the serving dtype) verify_attention_split_kernel
// takes its place: each row's table split over a cluster of CTAs, both
// products on the tensor cores. The notes of each are at its definition.
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
#include <cooperative_groups.h>

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
    cudaError_t e =
        raise_smem((const void*)decode_attention_kernel<T>, (int)smem);
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
    cudaError_t e =
        raise_smem((const void*)decode_attention_q_kernel<T>, (int)smem);
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
// int8 cache, bf16 q: the split walk on the tensor cores
// ---------------------------------------------------------------------------
//
// decode_attention_q_split_kernel<D> computes what decode_attention_q_kernel
// computes for a bf16 q (the serving dtype), PS = 128 and d_head D = 64 or
// 128 (ops/decode_attention.py q_route), with the walk of each (slot, kv
// head) split over CTAs: the grid is (chunk, kv head, slot), a chunk being
// E consecutive entries j = t * TPS + u of the table row (q_split_entries).
//
// A CTA's 4 warps take 32 token lanes of every tile each. It issues all of
// its chunk's bytes at once (cp.async: the K tiles, their key scales and
// q as one group, the V tiles and their value scales as a second) into
// tiles of 144-byte rows (ldmatrix rows in distinct banks), then:
// - scores on mma.sync m16n8k16: the tile's tokens as the m16 side (the K
//   tile [D][PS] is W^T of the weight stream: ldmatrix.trans + the int8
//   pairs widened to bf16 in registers), the G <= 8 query rows as n8
//   (bf16 q, exact); s = dot * scale * kscale, clamped only when clamp > 0;
// - the chunk's row max over its valid lanes, e = exp(s - m), l = sum e, and
//   P = e * vscale (0 on masked lanes) through a per-warp shared buffer;
// - PV on mma.sync: o^T [D][G] += V [D][32 lanes] P [32 lanes][G], the V
//   tile's rows as A (ldmatrix of int8 quads widened in registers: the k16
//   order is permuted alike on both operands) and P as two bf16 terms, hi =
//   bf16(P) and lo = bf16(P - hi), so that the product keeps P's f32 value
//   to ~2^-16;
// - the 4 warps' sums are added in warp order. One chunk writes o = acc /
//   max(l, 1e-30); several keep (m, l, acc) rows and combine them in chunk
//   order: o = sum_c acc_c exp(m_c - M) / max(sum_c l_c exp(m_c - M),
//   1e-30), M = max_c m_c. A row of at most kSplitCluster chunks is one
//   cluster: the rows stay in each CTA's shared memory and every rank
//   combines a share of the outputs through distributed shared memory.
//   Past that they go to a work buffer, and the last CTA of the row to
//   finish (an atomic count a row, zeroed by the caller) combines them.
// Against the one-pass kernel only the order of the f32 sums changes (the
// split combine; the tensor cores' sums).
//
// The append: the new token's column (k8, v8, their scales, its codes) is
// staged in shared memory by the kernel's first copies. The CTA whose
// chunk the wrapper names (ops/decode_attention.py split_writer: the chunk
// holding the row's first valid entry on the write tile, chunk 0 when no
// entry covers it) writes it into the caches; every CTA that stages the
// write tile takes the new column from the staged one into its copy, so
// no CTA reads back a cache column another CTA of the launch writes.

constexpr int kSplitThreads = 128;   // 4 warps, 32 token lanes each
constexpr int kSplitPS = 128;        // the tile's token lanes
constexpr int kSplitRow = kSplitPS + 16;   // bytes a staged tile row
constexpr int kSplitPRow = 36;       // floats a row of a warp's P buffer
constexpr int kSplitCluster = 4;     // chunks a row combines in a cluster

// shared memory of a split CTA: K and V tiles, key and value scales, q,
// the warps' P buffers, row max / sum scratch, the new token's column (k8,
// v8, their scales, its W codes), the entries' info
__host__ __device__ inline int split_smem_bytes(int E, int D, int W) {
  return 2 * E * D * kSplitRow + 2 * E * kSplitPS * 4 + 8 * (D + 8) * 2 +
         4 * 8 * kSplitPRow * 4 + 2 * 4 * 8 * 4 + 2 * D + 8 + W * 4 +
         2 * E * 4 + 16;
}

// 4 int8 in one word (bytes k, k+1, k+2, k+3 along a row) -> the bf16 pairs
// (k, k+1) in a[0] and (k+2, k+3) in a[1] (the float trick of
// i8_pairs_to_bf16)
__device__ __forceinline__ void i8_quad_to_bf16(uint32_t w, uint32_t* a) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
        8388736.f);
  a[0] = __byte_perm(f[0], f[1], 0x7632);
  a[1] = __byte_perm(f[2], f[3], 0x7632);
}

template <int D>
__global__ void __launch_bounds__(kSplitThreads)
    decode_attention_q_split_kernel(
        // the caches are written by one CTA of the row: no __restrict__
        const __nv_bfloat16* __restrict__ q, int8_t* kc, int8_t* vc,
        int* cc, float* ksc, float* vsc, const int* __restrict__ tables,
        const int* __restrict__ n_tiles, const int* __restrict__ pos,
        const int8_t* __restrict__ kn, const int8_t* __restrict__ vn,
        const int* __restrict__ cn, const float* __restrict__ ksn,
        const float* __restrict__ vsn, const int* __restrict__ tile_base,
        const int64_t* __restrict__ writer, __nv_bfloat16* __restrict__ o,
        float* work, int* counters, int KV,
        int G, int NTALL, int W, int KVP, int NTAB, int TM, int TPS, int E,
        float scale, float clamp, int cluster_combine) {
  constexpr int PS = kSplitPS, QROW = D + 8, KB = D / 32, MD = D / 16;
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nch = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t bh = (size_t)b * KV + h;
  const int NE = TM * TPS, j0 = chunk * E, ne = min(E, NE - j0);

  extern __shared__ __align__(16) unsigned char smq[];
  int8_t* ktile = reinterpret_cast<int8_t*>(smq);          // [E][D][row]
  int8_t* vtile = ktile + E * D * kSplitRow;              // [E][D][row]
  float* kss = reinterpret_cast<float*>(vtile + E * D * kSplitRow);  // [E][PS]
  float* vss = kss + E * PS;                                // [E][PS]
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(vss + E * PS);  // [8][QROW]
  float* pbuf = reinterpret_cast<float*>(qs + 8 * QROW);   // [4][8][PROW]
  float* redm = pbuf + 4 * 8 * kSplitPRow;                  // [4][8]
  float* redl = redm + 32;                                  // [4][8]
  int8_t* kns = reinterpret_cast<int8_t*>(redl + 32);       // [D] new k8
  int8_t* vns = kns + D;                                    // [D] new v8
  float* ksns = reinterpret_cast<float*>(vns + D);          // new k scale
  float* vsns = ksns + 1;                                   // new v scale
  int* cns = reinterpret_cast<int*>(vsns + 1);              // [W] new codes
  int* env = cns + W;                                       // [E] valid lanes
  int* egt = env + E;                                       // [E] tile
  int* s_last = egt + E;
  float* accs = reinterpret_cast<float*>(smq);   // [4][8][D] over the K tiles

  // ---- the new token's column, in flight at once (the append and the
  // write tile's copies take it from here)
  for (int c = tid; c < D / 16; c += kSplitThreads) {
    cp_async16(kns + 16 * c, kn + bh * D + 16 * c);
    cp_async16(vns + 16 * c, vn + bh * D + 16 * c);
  }
  for (int c = tid; c < W; c += kSplitThreads)
    cp_async4_zfill(cns + c, cn + bh * W + c, 4);
  if (tid == 0) {
    cp_async4_zfill(ksns, ksn + bh, 4);
    cp_async4_zfill(vsns, vsn + bh, 4);
  }
  cp_async_commit();

  // ---- this chunk's entries
  const int p = pos[b];
  const int wt = tile_base[b] + p / PS, wc = p % PS;
  const int trow = b * NTAB + h / (KV / NTAB);
  const int* tab = tables + (size_t)trow * TM;
  const int n_t = n_tiles[b];
  for (int j = j0 + tid; j < j0 + ne; j += kSplitThreads) {
    const int t = j / TPS, e = tab[t], gt = e + j % TPS;
    const bool ok = e >= 0 && t < n_t && gt < NTALL;
    env[j - j0] = !ok ? 0 : (gt == wt ? wc + 1 : (gt < wt ? PS : 0));
    egt[j - j0] = gt;
  }
  __syncthreads();

  // ---- every byte of the chunk in flight: K tiles, key scales and q, then
  // V tiles and value scales
  for (int i = 0; i < ne; ++i) {
    if (env[i] == 0) continue;
    const int8_t* src = kc + (bh * NTALL + egt[i]) * D * PS;
    int8_t* dst = ktile + i * D * kSplitRow;
    for (int c = tid; c < D * (PS / 16); c += kSplitThreads) {
      const int r = c / (PS / 16), cb = (c % (PS / 16)) * 16;
      cp_async16(dst + r * kSplitRow + cb, src + r * PS + cb);
    }
    if (tid < PS / 4)
      cp_async16(kss + i * PS + 4 * tid,
                 ksc + (((size_t)b * NTALL + egt[i]) * KVP + h) * PS +
                     4 * tid);
  }
  for (int c = tid; c < G * (D / 8); c += kSplitThreads) {
    const int r = c / (D / 8), cb = (c % (D / 8)) * 8;
    cp_async16(qs + r * QROW + cb, q + (bh * G + r) * D + cb);
  }
  cp_async_commit();
  for (int i = 0; i < ne; ++i) {
    if (env[i] == 0) continue;
    const int8_t* src = vc + (bh * NTALL + egt[i]) * D * PS;
    int8_t* dst = vtile + i * D * kSplitRow;
    for (int c = tid; c < D * (PS / 16); c += kSplitThreads) {
      const int r = c / (PS / 16), cb = (c % (PS / 16)) * 16;
      cp_async16(dst + r * kSplitRow + cb, src + r * PS + cb);
    }
    if (tid < PS / 4)
      cp_async16(vss + i * PS + 4 * tid,
                 vsc + (((size_t)b * NTALL + egt[i]) * KVP + h) * PS +
                     4 * tid);
  }
  cp_async_commit();
  // the query rows past G are zero (their scores are never used)
  for (int i = tid; i < (8 - G) * QROW; i += kSplitThreads)
    qs[G * QROW + i] = __float2bfloat16(0.f);

  // ---- scores: the new column and the K group have landed; the write
  // tile's new column from the staged one
  cp_async_wait<1>();
  __syncthreads();
  for (int i = 0; i < ne; ++i) {
    if (env[i] == 0 || egt[i] != wt) continue;
    for (int d = tid; d < D; d += kSplitThreads)
      ktile[(i * D + d) * kSplitRow + wc] = kns[d];
    if (tid == 0) kss[i * PS + wc] = *ksns;
  }
  // the append in place (one CTA of the row)
  if (chunk == writer[trow]) {
    for (int d = tid; d < D; d += kSplitThreads) {
      const size_t at = ((bh * NTALL + wt) * D + d) * PS + wc;
      kc[at] = kns[d];
      vc[at] = vns[d];
    }
    if (W > 1)
      for (int s = tid; s < W; s += kSplitThreads)
        cc[((bh * NTALL + wt) * W + s) * PS + wc] = cns[s];
    if (tid == 0) {
      const size_t at = (((size_t)b * NTALL + wt) * KVP + h) * PS + wc;
      ksc[at] = *ksns;
      vsc[at] = *vsns;
    }
  }
  __syncthreads();
  uint32_t qf[KB][4];   // q as the B operand: two k16 steps a load
#pragma unroll
  for (int kb = 0; kb < KB; ++kb)
    ldsm_x4(qf[kb], qs + (lane & 7) * QROW + kb * 32 + (lane >> 3) * 8);
  float sreg[4][2][4];  // [entry][m16 tile][element], E <= 4
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= ne) break;
    const int nv = env[i];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const int tok0 = 32 * wid + 16 * mt;
      if (nv > 0) {
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          uint32_t raw[4], af[2][4];
          ldsm_x4_trans(raw, ktile + (i * D + kb * 32 + lane) * kSplitRow +
                                 tok0);
          i8_pairs_to_bf16(raw[0], af[0]);
          i8_pairs_to_bf16(raw[1], af[0] + 2);
          i8_pairs_to_bf16(raw[2], af[1]);
          i8_pairs_to_bf16(raw[3], af[1] + 2);
          mma_bf16_16816(acc, af[0], qf[kb]);
          mma_bf16_16816(acc, af[1], qf[kb] + 2);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // token lane (the int8 pairs' row order) and query row
        const int tok = tok0 + 2 * g8 + (e >> 1), n = 2 * t4 + (e & 1);
        float sv = acc[e] * scale * kss[i * PS + tok];
        if (clamp > 0.f) sv = fminf(fmaxf(sv, -clamp), clamp);
        sv = tok < nv && n < G ? sv : kNeg;
        sreg[i][mt][e] = sv;
        mx[e & 1] = fmaxf(mx[e & 1], sv);
      }
    }
  }
  // the chunk's row max: lanes of one t4 hold rows 2 t4 and 2 t4 + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    for (int off = 4; off < 32; off <<= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    if (g8 == 0) redm[wid * 8 + 2 * t4 + r] = mx[r];
  }

  // ---- e, l, P and PV: the V group has landed; the new column from vn
  cp_async_wait<0>();
  __syncthreads();
  for (int i = 0; i < ne; ++i) {
    if (env[i] == 0 || egt[i] != wt) continue;
    for (int d = tid; d < D; d += kSplitThreads)
      vtile[(i * D + d) * kSplitRow + wc] = vns[d];
    if (tid == 0) vss[i * PS + wc] = *vsns;
  }
  float m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = redm[2 * t4 + r];
    for (int w = 1; w < 4; ++w) m[r] = fmaxf(m[r], redm[w * 8 + 2 * t4 + r]);
  }
  __syncthreads();
  float* pw = pbuf + wid * 8 * kSplitPRow;   // [8 rows][32 lanes of the warp]
  float oacc[MD][4];
#pragma unroll
  for (int md = 0; md < MD; ++md)
    oacc[md][0] = oacc[md][1] = oacc[md][2] = oacc[md][3] = 0.f;
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= ne) break;
    const int nv = env[i];
    if (nv == 0) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lt = 16 * mt + 2 * g8 + (e >> 1), n = 2 * t4 + (e & 1);
        const int tok = 32 * wid + lt;
        const bool ok = tok < nv && n < G;
        const float ev = ok ? expf(sreg[i][mt][e] - m[e & 1]) : 0.f;
        lsum[e & 1] += ev;
        pw[n * kSplitPRow + lt] = ok ? ev * vss[i * PS + tok] : 0.f;
      }
    __syncwarp();
    // P^T as B, two k16 steps of the warp's 32 lanes, in the permuted k
    // order of the V quads: lanes 16 ks + 4 t4 .. + 3, query row g8
    uint32_t bh_[2][2], bl_[2][2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float4 pv = *reinterpret_cast<const float4*>(
          pw + g8 * kSplitPRow + 16 * ks + 4 * t4);
      const float hv[4] = {pv.x, pv.y, pv.z, pv.w};
      float lv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        lv[u] = hv[u] - __bfloat162float(__float2bfloat16(hv[u]));
      bh_[ks][0] = pack_bf16(hv[0], hv[1]);
      bh_[ks][1] = pack_bf16(hv[2], hv[3]);
      bl_[ks][0] = pack_bf16(lv[0], lv[1]);
      bl_[ks][1] = pack_bf16(lv[2], lv[3]);
    }
#pragma unroll
    for (int md = 0; md < MD; ++md) {
      // V rows md*16 .. +15 at this warp's lanes: matrices (rows 0-7, lanes
      // 0-15), (rows 8-15, 0-15), (rows 0-7, 16-31), (rows 8-15, 16-31);
      // a lane's word holds lanes 4 t4 .. + 3 of row g8 (or g8 + 8)
      uint32_t raw[4];
      ldsm_x4(raw, vtile + (i * D + md * 16 + (lane & 7) +
                            ((lane >> 3) & 1) * 8) * kSplitRow +
                       32 * wid + (lane >> 4) * 16);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t r0[2], r8[2], af[4];
        i8_quad_to_bf16(raw[2 * ks], r0);
        i8_quad_to_bf16(raw[2 * ks + 1], r8);
        af[0] = r0[0];
        af[1] = r8[0];
        af[2] = r0[1];
        af[3] = r8[1];
        mma_bf16_16816(oacc[md], af, bh_[ks]);
        mma_bf16_16816(oacc[md], af, bl_[ks]);
      }
    }
    __syncwarp();
  }

  // ---- the warps' sums in warp order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    for (int off = 4; off < 32; off <<= 1)
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], off);
    if (g8 == 0) redl[wid * 8 + 2 * t4 + r] = lsum[r];
  }
  __syncthreads();   // every warp is done with the K tiles: accs over them
#pragma unroll
  for (int md = 0; md < MD; ++md)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = md * 16 + g8 + 8 * (e >> 1), n = 2 * t4 + (e & 1);
      accs[(wid * 8 + n) * D + d] = oacc[md][e];
    }
  __syncthreads();
  // the chunk's (acc, m, l) rows [G][D + 2]: in the V tiles' space (read
  // out) when the chunks combine in a cluster, else in the work buffer
  float* cpart = cluster_combine ? reinterpret_cast<float*>(vtile)
                                 : work + (bh * nch + chunk) * G * (D + 2);
  for (int idx = tid; idx < G * D; idx += kSplitThreads) {
    const int n = idx / D, d = idx % D;
    float a = 0.f, l = 0.f;
    for (int w = 0; w < 4; ++w) {
      a += accs[(w * 8 + n) * D + d];
      l += redl[w * 8 + n];
    }
    if (nch == 1) {
      o[bh * G * D + idx] = __float2bfloat16(a / fmaxf(l, 1e-30f));
      continue;
    }
    float* dst = cpart + n * (D + 2);
    dst[d] = a;
    if (d == 0) {
      float mm = redm[n];
      for (int w = 1; w < 4; ++w) mm = fmaxf(mm, redm[w * 8 + n]);
      dst[D] = mm;
      dst[D + 1] = l;
    }
  }
  if (nch == 1) return;

  // ---- the chunks combined in chunk order: o = sum_c acc_c exp(m_c - M) /
  // max(sum_c l_c exp(m_c - M), 1e-30), M = max_c m_c
  // (other CTAs' rows: from L2 past L1 in the work buffer)
  auto ld = [&](const float* p) { return cluster_combine ? *p : __ldcg(p); };
  auto combine = [&](auto chunk_row, int first_idx, int step) {
    for (int idx = first_idx; idx < G * D; idx += step) {
      const int n = idx / D, d = idx % D;
      float mm = kNeg;
      for (int c = 0; c < nch; ++c) mm = fmaxf(mm, ld(chunk_row(c, n) + D));
      float num = 0.f, den = 0.f;
      for (int c = 0; c < nch; ++c) {
        const float* r = chunk_row(c, n);
        const float f = expf(ld(r + D) - mm);
        num += ld(r + d) * f;
        den += ld(r + D + 1) * f;
      }
      o[bh * G * D + idx] = __float2bfloat16(num / fmaxf(den, 1e-30f));
    }
  };
  if (cluster_combine) {
    // a cluster of the row's nch chunks: every rank combines a share of
    // the outputs from the ranks' shared memory
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    combine([&](int c, int n) -> const float* {
      return cluster.map_shared_rank(cpart, c) + n * (D + 2);
    }, (int)cluster.block_rank() * kSplitThreads + tid,
            nch * kSplitThreads);
    cluster.sync();   // no rank leaves while another reads its rows
    return;
  }
  // the last CTA of the row to finish combines (an atomic count a row)
  __threadfence();
  __syncthreads();
  if (tid == 0) *s_last = atomicAdd(&counters[bh], 1) == nch - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  combine([&](int c, int n) -> const float* {
    return work + ((bh * nch + c) * G + n) * (D + 2);
  }, tid, kSplitThreads);
}

int launch_attention_q_split(const void* q, void* kc, void* vc, void* cc,
                             void* ksc, void* vsc, const void* tables,
                             const void* n_tiles, const void* pos,
                             const void* kn, const void* vn, const void* cn,
                             const void* ksn, const void* vsn,
                             const void* tile_base, const void* writer,
                             void* o, int B, int KV, int G, int D, int NTALL,
                             int W, int KVP, int NTAB, int TM, int TPS,
                             int PS, float scale, float clamp, int E,
                             float* work, int* counters,
                             cudaStream_t stream) {
  const int NE = TM * TPS;
  if (PS != kSplitPS || (D != 64 && D != 128) || G < 1 || G > 8 || E < 1 ||
      E > 4 || NE < 1)
    return (int)cudaErrorInvalidValue;
  const int nch = (NE + E - 1) / E;
  if ((nch > kSplitCluster && (work == nullptr || counters == nullptr)) ||
      writer == nullptr)
    return (int)cudaErrorInvalidValue;
  auto kern = D == 64 ? decode_attention_q_split_kernel<64>
                      : decode_attention_q_split_kernel<128>;
  const int smem = split_smem_bytes(E, D, W);
  if (smem > 48 * 1024) {
    cudaError_t e = raise_smem((const void*)kern, smem);
    if (e != cudaSuccess) return (int)e;
  }
  // a row of 2 .. 4 chunks combines in a cluster (clusters of 8 ran the
  // dense OPT-125M table 4 us slower than the atomic combine, H100)
  const int cluster = nch >= 2 && nch <= kSplitCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nch, KV, B);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nch;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster;
  return (int)cudaLaunchKernelEx(
      &cfg, kern, (const __nv_bfloat16*)q, (int8_t*)kc, (int8_t*)vc,
      (int*)cc, (float*)ksc, (float*)vsc, (const int*)tables,
      (const int*)n_tiles, (const int*)pos, (const int8_t*)kn,
      (const int8_t*)vn, (const int*)cn, (const float*)ksn,
      (const float*)vsn, (const int*)tile_base, (const int64_t*)writer,
      (__nv_bfloat16*)o, work, counters, KV, G, NTALL, W, KVP, NTAB, TM, TPS,
      E, scale, clamp, cluster);
}

// ---------------------------------------------------------------------------
// bf16 cache: the split walk on the tensor cores
// ---------------------------------------------------------------------------
//
// decode_attention_split_kernel<D> computes what decode_attention_kernel
// computes for a bf16 cache (the TPU kernels _rows_kernel and
// _rows_kernel_ms), for PS = 128, d_head D = 64 or 128 and G <= 8
// (ops/decode_attention.py rows_route), at any table length: in bf16 it
// takes the place of the one-pass kernel and of the two-pass walk.
//
// Bound on the H100: memory, K and V of the covered tokens (2 x 2 x D
// bytes a token) against 2 x 2 x D x G operations a token. The one-pass
// kernel ran one CTA per (slot, kv head), 64-96 CTAs on 132 SMs, each
// walking its table serially with an f32 dot a token lane on the CUDA
// cores: 25-30x its bound.
//
// Design: the grid is (chunk, kv head, slot), a chunk being E consecutive
// entries j = t * TPS + u of the row (rows_split_plan: ~6 entries; fewer,
// longer chunks ran faster than many short ones, kernel_ab.py
// --attn-sweep), and the row's chunks (at most kRowsCluster) are one
// cluster. A CTA's 4 warps take 32 token lanes of every tile each. The CTA
// streams its chunk's K tiles, then its V tiles, through a ring of
// kRowsRing tile slots (cp.async, rows padded to 272 bytes: the 8 rows of
// an ldmatrix fall in distinct banks; 2 slots keep a CTA's shared memory
// small, so that several CTAs an SM overlap their loads), so that V is in
// flight while the scores are computed and exchanged:
// - scores on mma.sync m16n8k16: the tile's tokens as the m16 side (the K
//   tile [D][PS] is K^T stored [k][m]: ldmatrix.trans), the G <= 8 query
//   rows as n8 (bf16 q, exact in f32); s = dot * scale, clamped only when
//   clamp > 0, kept in f32 (in shared memory, or in a global buffer when
//   the chunk's scores outgrow it);
// - the TPU kernel rounds e = exp(s - M) to bf16 against the row's max M
//   over its whole table, and bf16(exp(s - m_c)) exp(m_c - M) is not
//   bf16(exp(s - M)): so no e is formed before M is known. Each CTA takes
//   its chunk's max per query row, the cluster's CTAs exchange them
//   through distributed shared memory (one cluster barrier, while the V
//   tiles land) and M is the max over the ranks;
// - PV on mma.sync: o^T [D][G] += V [D][32 lanes] P [32 lanes][G], the V
//   tile's rows as A (ldmatrix) and P = bf16(e) as B, built in registers
//   from the f32 scores; l = sum e of the unrounded e, in f32;
// - the 4 warps' sums are added in warp order, then the ranks' in chunk
//   order through distributed shared memory: o = sum_c acc_c /
//   max(sum_c l_c, 1e-30). Every chunk used the same M: nothing rescales.
// Against the one-pass kernel only the order of the f32 sums changes.
//
// The append follows decode_attention_q_split_kernel: the new token's k/v
// are read into shared memory first; the CTA whose chunk the wrapper names
// (split_writer: the chunk holding the row's first valid entry on the write
// tile, chunk 0 when none does) writes the caches; every CTA that stages
// the write tile overlays the new column on its copy, so no CTA reads back
// a column another CTA of the launch writes.

constexpr int kRowsCluster = 8;            // chunks a row (one cluster)
constexpr int kRowsRing = 2;               // tile slots a CTA
constexpr int kTileRow = kSplitPS + 8;     // bf16 a staged tile row (272 B)
constexpr int kScoreRow = kSplitPS + 4;    // floats a score row
constexpr int kRowsSmem = 227 * 1024;      // shared memory an H100 CTA may have

// shared memory of a split CTA: the tile slots, q, the chunk's combine rows
// (acc [8][D], l [8]), max / sum scratch and the chunk max [8], the scores
// [E][G][kScoreRow] unless they go to the global buffer, the new token's k
// and v, its W codes, the entries' info
__host__ __device__ inline int rows_split_smem_bytes(int E, int G, int D,
                                                     int W, bool scores) {
  return kRowsRing * D * kTileRow * 2 + 16 * (D + 8) + 32 * D + 320 +
         (scores ? E * G * kScoreRow * 4 : 0) + 4 * D + 4 * (W + 2 * E + 1);
}

// floats of global score buffer a split CTA needs: 0 when its scores fit in
// shared memory beside the rest, else E x G x kScoreRow (rows past ~40,000
// tokens at G = 8)
inline int rows_split_scores(int E, int G, int D, int W) {
  return rows_split_smem_bytes(E, G, D, W, true) > kRowsSmem
             ? E * G * kScoreRow
             : 0;
}

template <int D>
__global__ void __launch_bounds__(kSplitThreads)
    decode_attention_split_kernel(
        // the caches are written by one CTA of the row: no __restrict__
        const __nv_bfloat16* __restrict__ q, __nv_bfloat16* kc,
        __nv_bfloat16* vc, int* cc, const int* __restrict__ tables,
        const int* __restrict__ n_tiles, const int* __restrict__ pos,
        const __nv_bfloat16* __restrict__ kn,
        const __nv_bfloat16* __restrict__ vn, const int* __restrict__ cn,
        const int* __restrict__ tile_base, const int64_t* __restrict__ writer,
        __nv_bfloat16* __restrict__ o, float* scores, int KV, int G,
        int NTALL, int W, int NTAB, int TM, int TPS, int E, float scale,
        float clamp) {
  using bf16 = __nv_bfloat16;
  constexpr int PS = kSplitPS, QROW = D + 8, KB = D / 32, MD = D / 16;
  constexpr int ring = kRowsRing;
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nch = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t bh = (size_t)b * KV + h;
  const int NE = TM * TPS, j0 = chunk * E, ne = min(E, NE - j0);

  extern __shared__ __align__(16) unsigned char smr[];
  bf16* tiles = reinterpret_cast<bf16*>(smr);           // [ring][D][row]
  bf16* qs = tiles + (size_t)ring * D * kTileRow;        // [8][QROW]
  float* cpart = reinterpret_cast<float*>(qs + 8 * QROW);  // [8][D]
  float* cl = cpart + 8 * D;                             // [8]
  float* redm = cl + 8;                                  // [4][8]
  float* redl = redm + 32;                               // [4][8]
  float* cm = redl + 32;                                 // [8] chunk max
  float* scs = cm + 8;                                   // [E][G][kScoreRow]
  float* sc = scores != nullptr
                  ? scores + (bh * nch + chunk) * E * G * kScoreRow
                  : scs;
  bf16* kns = reinterpret_cast<bf16*>(
      scores != nullptr ? scs : scs + E * G * kScoreRow);  // [D] new k
  bf16* vns = kns + D;                                   // [D] new v
  int* cns = reinterpret_cast<int*>(vns + D);            // [W] new codes
  int* env = cns + W;                                    // [E] valid lanes
  int* egt = env + E;                                    // [E] tile
  float* accs = reinterpret_cast<float*>(smr);   // [4][8][D] over the slots

  // ---- this chunk's entries first (the tile copies wait on them)
  const int p = pos[b];
  const int wt = tile_base[b] + p / PS, wc = p % PS;
  const int trow = b * NTAB + h / (KV / NTAB);
  const int* tab = tables + (size_t)trow * TM;
  const int n_t = n_tiles[b];
  // the query rows past G are zero (their scores are never kept)
  for (int i = tid; i < (8 - G) * QROW; i += kSplitThreads)
    qs[G * QROW + i] = __float2bfloat16(0.f);
  for (int j = j0 + tid; j < j0 + ne; j += kSplitThreads) {
    const int t = j / TPS, e = tab[t], gt = e + j % TPS;
    const bool ok = e >= 0 && t < n_t && gt < NTALL;
    env[j - j0] = !ok ? 0 : (gt == wt ? wc + 1 : (gt < wt ? PS : 0));
    egt[j - j0] = gt;
  }
  __syncthreads();

  // ---- the ring: step t < ne stages entry t's K tile, step ne + i entry
  // i's V tile; one commit group a step (empty for an empty entry). The
  // first group also brings q, the new token's k / v and its codes.
  for (int c = tid; c < G * (D / 8); c += kSplitThreads) {
    const int r = c / (D / 8), cb = (c % (D / 8)) * 8;
    cp_async16(qs + r * QROW + cb, q + (bh * G + r) * D + cb);
  }
  for (int c = tid; c < D / 8; c += kSplitThreads) {
    cp_async16(kns + 8 * c, kn + bh * D + 8 * c);
    cp_async16(vns + 8 * c, vn + bh * D + 8 * c);
  }
  for (int c = tid; c < W; c += kSplitThreads)
    cp_async4_zfill(cns + c, cn + bh * W + c, 4);
  const int nt = 2 * ne;
  auto issue = [&](int t) {
    if (t < nt) {
      const int i = t < ne ? t : t - ne;
      if (env[i] > 0) {
        const bf16* src = (t < ne ? kc : vc) + (bh * NTALL + egt[i]) * D * PS;
        bf16* dst = tiles + (size_t)(t % ring) * D * kTileRow;
        for (int c = tid; c < D * (PS / 8); c += kSplitThreads) {
          const int r = c / (PS / 8), cb = (c % (PS / 8)) * 8;
          cp_async16(dst + r * kTileRow + cb, src + r * PS + cb);
        }
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < ring; ++t) issue(t);

  uint32_t qf[KB][4];           // q as the B operand: two k16 steps a load
  float mx[2] = {kNeg, kNeg};   // the chunk's max of rows 2 t4, 2 t4 + 1
  float mrow = kNeg;            // the row's max M of query row g8
  float lsum = 0.f;             // sum e of query row g8
  float oacc[MD][4];
#pragma unroll
  for (int md = 0; md < MD; ++md)
    oacc[md][0] = oacc[md][1] = oacc[md][2] = oacc[md][3] = 0.f;
  const bool appends = chunk == writer[trow];
  namespace cg = cooperative_groups;
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<ring - 1>();   // step t's tile has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
        ldsm_x4(qf[kb], qs + (lane & 7) * QROW + kb * 32 + (lane >> 3) * 8);
      // the append in place (one CTA of the row)
      if (appends) {
        for (int d = tid; d < D; d += kSplitThreads) {
          const size_t at = ((bh * NTALL + wt) * D + d) * PS + wc;
          kc[at] = kns[d];
          vc[at] = vns[d];
        }
        if (W > 1)
          for (int s = tid; s < W; s += kSplitThreads)
            cc[((bh * NTALL + wt) * W + s) * PS + wc] = cns[s];
      }
    }
    const int i = t < ne ? t : t - ne;
    const int nv = env[i];
    bf16* tile = tiles + (size_t)(t % ring) * D * kTileRow;
    if (nv > 0 && egt[i] == wt) {     // the write tile: the new column
      const bf16* col = t < ne ? kns : vns;
      for (int d = tid; d < D; d += kSplitThreads)
        tile[d * kTileRow + wc] = col[d];
      __syncthreads();
    }
    float* srow = sc + (size_t)i * G * kScoreRow;
    if (t < ne && nv > 0) {
      // ---- scores of the warp's 32 lanes: tokens as m16, query rows n8
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const int tok0 = 32 * wid + 16 * mt;
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          uint32_t a0[4], a1[4];
          ldsm_x4_trans(a0, tile + at_off(tok0, kb * 32, kTileRow));
          ldsm_x4_trans(a1, tile + at_off(tok0, kb * 32 + 16, kTileRow));
          mma_bf16_16816(acc, a0, qf[kb]);
          mma_bf16_16816(acc, a1, qf[kb] + 2);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = tok0 + g8 + 8 * (e >> 1), n = 2 * t4 + (e & 1);
          float sv = acc[e] * scale;
          if (clamp > 0.f) sv = fminf(fmaxf(sv, -clamp), clamp);
          const bool ok = tok < nv && n < G;
          if (n < G) srow[n * kScoreRow + tok] = ok ? sv : kNeg;
          if (ok) mx[e & 1] = fmaxf(mx[e & 1], sv);
        }
      }
    } else if (t >= ne && nv > 0) {
      // ---- P^T as B (query row g8; lanes 2 t4, +1, +8, +9 of each k16
      // step), e from the f32 scores against M; V's rows as A
      const float* sr = srow + g8 * kScoreRow;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int k0 = 32 * wid + 16 * ks;
        float ev[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int tok = k0 + 2 * t4 + (u & 1) + 8 * (u >> 1);
          ev[u] = g8 < G && tok < nv ? expf(sr[tok] - mrow) : 0.f;
          lsum += ev[u];
        }
        const uint32_t bfr[2] = {pack_bf16(ev[0], ev[1]),
                                 pack_bf16(ev[2], ev[3])};
#pragma unroll
        for (int md = 0; md < MD; ++md) {
          uint32_t a[4];
          ldsm_x4(a, tile + a_off(md * 16, k0, kTileRow));
          mma_bf16_16816(oacc[md], a, bfr);
        }
      }
    }
    if (t == ne - 1) {
      // ---- the chunk's max per query row, then the row's M over the
      // cluster's ranks (lanes of one t4 hold rows 2 t4 and 2 t4 + 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        for (int off = 4; off < 32; off <<= 1)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
        if (g8 == 0) redm[wid * 8 + 2 * t4 + r] = mx[r];
      }
      __syncthreads();
      if (tid < 8) {
        float m = redm[tid];
        for (int w = 1; w < 4; ++w) m = fmaxf(m, redm[w * 8 + tid]);
        cm[tid] = m;
      }
      if (nch > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        for (int c = 0; c < nch; ++c)
          mrow = fmaxf(mrow, cluster.map_shared_rank(cm, c)[g8]);
      } else {
        __syncthreads();
        mrow = cm[g8];
      }
    }
    __syncthreads();      // step t's slot is read out
    issue(t + ring);
  }
  cp_async_wait<0>();

  // ---- the warps' sums in warp order; l of row g8 over the lanes t4
  lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
  lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
  if (t4 == 0) redl[wid * 8 + g8] = lsum;
  __syncthreads();      // the slots are free: accs over them
#pragma unroll
  for (int md = 0; md < MD; ++md)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = md * 16 + g8 + 8 * (e >> 1), n = 2 * t4 + (e & 1);
      accs[(wid * 8 + n) * D + d] = oacc[md][e];
    }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kSplitThreads) {
    const int n = idx / D, d = idx % D;
    float a = 0.f, l = 0.f;
    for (int w = 0; w < 4; ++w) {
      a += accs[(w * 8 + n) * D + d];
      l += redl[w * 8 + n];
    }
    if (nch == 1) {
      o[bh * G * D + idx] = __float2bfloat16(a / fmaxf(l, 1e-30f));
      continue;
    }
    cpart[n * D + d] = a;
    if (d == 0) cl[n] = l;
  }
  if (nch == 1) return;

  // ---- the ranks' rows in chunk order: every rank combines a share
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int idx = (int)cluster.block_rank() * kSplitThreads + tid; idx < G * D;
       idx += nch * kSplitThreads) {
    const int n = idx / D, d = idx % D;
    float num = 0.f, den = 0.f;
    for (int c = 0; c < nch; ++c) {
      num += cluster.map_shared_rank(cpart, c)[n * D + d];
      den += cluster.map_shared_rank(cl, c)[n];
    }
    o[bh * G * D + idx] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
  cluster.sync();       // no rank leaves while another reads its rows
}

int launch_attention_split(const void* q, void* kc, void* vc, void* cc,
                           const void* tables, const void* n_tiles,
                           const void* pos, const void* kn, const void* vn,
                           const void* cn, const void* tile_base,
                           const void* writer, void* o, int B, int KV, int G,
                           int D, int NTALL, int W, int NTAB, int TM, int TPS,
                           int PS, float scale, float clamp, int E, int nch,
                           float* scores, cudaStream_t stream) {
  // nch chunks of E entries cover the row's NE entries, each once
  const int NE = TM * TPS;
  if (PS != kSplitPS || (D != 64 && D != 128) || G < 1 || G > 8 || E < 1 ||
      nch < 1 || nch > kRowsCluster || (nch - 1) * E >= NE || nch * E < NE ||
      writer == nullptr ||
      (rows_split_scores(E, G, D, W) > 0 && scores == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kern = D == 64 ? decode_attention_split_kernel<64>
                      : decode_attention_split_kernel<128>;
  const int smem =
      rows_split_smem_bytes(E, G, D, W, scores == nullptr);
  if (smem > 48 * 1024) {
    cudaError_t e = raise_smem((const void*)kern, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nch, KV, B);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nch;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = nch > 1;
  return (int)cudaLaunchKernelEx(
      &cfg, kern, (const __nv_bfloat16*)q, (__nv_bfloat16*)kc,
      (__nv_bfloat16*)vc, (int*)cc, (const int*)tables, (const int*)n_tiles,
      (const int*)pos, (const __nv_bfloat16*)kn, (const __nv_bfloat16*)vn,
      (const int*)cn, (const int*)tile_base, (const int64_t*)writer,
      (__nv_bfloat16*)o, scores, KV, G, NTALL, W, NTAB, TM, TPS, E, scale,
      clamp);
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
    cudaError_t e = raise_smem((const void*)kern, (int)smem);
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
    cudaError_t e =
        raise_smem((const void*)verify_attention_kernel<T>, (int)smem);
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


// ---------------------------------------------------------------------------
// block verify, bf16 cache: the split walk on the tensor cores
// ---------------------------------------------------------------------------
//
// verify_attention_split_kernel<D, NG> computes what verify_attention_kernel
// computes for a bf16 cache (the serving dtype), PS = 128, d_head D = 64 or
// 128, G <= 8 and K <= 30 (ops/decode_attention.py verify_route), at any
// table length.
//
// Bound on the H100: memory, K and V of the union table's entries read once
// (2 x 2 x D x 128 bytes an entry) against 2 x 2 x D operations a visible
// (row, lane) pair. The walk kernel ran one CTA per (slot, kv head), read
// every K tile twice and dotted on the CUDA cores: 11-26x its bound.
//
// Design: the grid is (chunk, kv head, slot x row group), a chunk being E
// consecutive table entries (verify_split_plan), a row group RC of the G*K
// query rows (all of them up to 64, else equal groups of at most 64), and
// a row group's chunks (at most kRowsCluster) are one cluster. A CTA's
// D / 16 warps (a d tile each in PV: 4 at D = 64 ran faster than 8, 8 at
// D = 128 faster than 4, kernel_ab.py --attn-sweep) stream its chunk's K
// tiles, then its V tiles, in halves of 64
// lanes through a ring of kVerifyRing slots of [D][72] (cp.async; 144-byte
// rows put the 8 rows of an ldmatrix in distinct banks; half tiles keep a
// CTA's shared memory small, so that several CTAs an SM overlap their loads
// and a cluster finds its SMs; deeper rings ran slower):
// - scores on mma.sync m16n8k16: the half's lanes as the m16 side (K^T
//   through ldmatrix.trans, 16 lanes a warp; at 8 warps, warps w and w + 4
//   split the n8 groups), the query rows as n8 groups;
//   s = dot * scale, clamped only when clamp > 0, f32, kept for the whole
//   chunk (in shared memory, or in a global buffer when they outgrow it).
//   Row r (block position j = r % K) sees a lane when bit j of its entry's
//   sel_mask is set and the lane's position is <= pos + j: the mask is
//   applied to the score fragments;
// - the contract rounds e = exp(s - M) to bf16 against the row's max M over
//   the whole table, so each CTA takes its chunk's max per row and the
//   cluster's CTAs exchange them through distributed shared memory before
//   any e is formed;
// - per V half, e is written once as bf16 [rows][lanes] (l, the f32 sum of
//   the unrounded e, added per row in a fixed order), and PV runs on
//   mma.sync: o^T [D][rows] += V [D][16 lanes] E^T [16 lanes][rows], a
//   warp a d tile;
// - the ranks' sums are added in chunk order through distributed shared
//   memory: o = sum_c pv_c / max(sum_c l_c, 1e-30).
// A row's arithmetic does not depend on its group's other rows, so any row
// grouping gives the same bits.
//
// The append: the CTA of row group 0 whose chunk the wrapper names writes
// the K new columns (verify_writer: the chunk that holds the row's two
// write entries, the table's last two, which the plan keeps in one chunk);
// every CTA that stages a tile the columns land in takes them from k_new /
// v_new into its copy, so no CTA reads back a column another CTA of the
// launch writes.

constexpr int kVerifyRowsMax = 64;        // query rows a split CTA at most
constexpr int kVerifyScoreRow = kSplitPS + 4;   // floats a score row
constexpr int kVerifyHalf = kSplitPS / 2;       // lanes a ring step
constexpr int kVerifyRow = kVerifyHalf + 8;     // bf16 a staged row (144 B)
constexpr int kVerifyRing = 2;                  // half-tile slots a CTA

// shared-memory layout of a verify split CTA (bytes): the ring of half
// tiles; q [RC8][D + 8] bf16; e [RC16][kVerifyRow] bf16; the chunk max, the
// row max M and the row sum l [RC16] f32 each, and each row's block
// position; the scores [E][RC8][kVerifyScoreRow] f32 unless they go to the
// global buffer; the entries' tiles, bits and lane offsets
struct VerifySmem {
  int ring, qs, eb, cm, mr, lr, rj, sc, ent, total;
};

__host__ __device__ inline VerifySmem verify_smem(int E, int RC, int D,
                                                  bool scores) {
  const int rc8 = (RC + 7) / 8 * 8, rc16 = (RC + 15) / 16 * 16;
  VerifySmem m;
  int at = 0;
  m.ring = at;
  at += kVerifyRing * D * kVerifyRow * 2;
  m.qs = at;
  at += rc8 * (D + 8) * 2;
  m.eb = at;
  at += rc16 * kVerifyRow * 2;
  m.cm = at;
  at += rc16 * 4;
  m.mr = at;
  at += rc16 * 4;
  m.lr = at;
  at += rc16 * 4;
  m.rj = at;
  at += rc16 * 4;
  m.sc = at;
  at += scores ? E * rc8 * kVerifyScoreRow * 4 : 0;
  m.ent = at;
  at += 3 * E * 4;
  m.total = at;
  return m;
}

// floats of global score buffer a verify split CTA needs: 0 when its scores
// fit in shared memory beside the rest, else E x RC8 x kVerifyScoreRow
inline int verify_split_scores(int E, int RC, int D) {
  return verify_smem(E, RC, D, true).total > kRowsSmem
             ? E * ((RC + 7) / 8 * 8) * kVerifyScoreRow
             : 0;
}

// NG: n8 row groups the PV accumulators cover (2, 4 or 8, the fewest that
// hold the CTA's rows, so that registers follow the rows)
template <int D, int NG>
__global__ void __launch_bounds__(D * 2)
    verify_attention_split_kernel(
        // the caches are written by one CTA of the row: no __restrict__
        const __nv_bfloat16* __restrict__ q, __nv_bfloat16* kc,
        __nv_bfloat16* vc, int* cc, const int* __restrict__ tables,
        const int* __restrict__ selm, const int* __restrict__ pos,
        const __nv_bfloat16* __restrict__ kn,
        const __nv_bfloat16* __restrict__ vn, const int* __restrict__ cn,
        const int* __restrict__ tile_base, __nv_bfloat16* __restrict__ o,
        float* scores, int KV, int GK, int KK, int NTALL, int W, int TM,
        int E, int RC, int NRG, int writer, float scale, float clamp) {
  using bf16 = __nv_bfloat16;
  constexpr int PS = kSplitPS, QROW = D + 8, KB = D / 32;
  constexpr int NW = D / 16, NT = NW * 32;   // a warp a d tile
  constexpr int HL = kVerifyHalf, VR = kVerifyRow;
  // QK: 4 m16 tiles a half, QW warps a tile splitting the n8 groups
  constexpr int QW = NW / 4;
  constexpr int ring = kVerifyRing;
  const int chunk = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / NRG, rg = blockIdx.z % NRG;
  const int nch = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t bh = (size_t)b * KV + h;
  const int R0 = rg * RC, NR = min(RC, GK - R0);
  const int rc8 = (RC + 7) / 8 * 8, rc16 = (RC + 15) / 16 * 16;
  const int ng8 = (NR + 7) / 8;             // n8 groups with rows
  const int j0 = chunk * E, ne = min(E, TM - j0);

  extern __shared__ __align__(16) unsigned char smv[];
  const VerifySmem L = verify_smem(E, RC, D, scores == nullptr);
  bf16* tiles = reinterpret_cast<bf16*>(smv + L.ring);  // [ring][D][VR]
  bf16* qs = reinterpret_cast<bf16*>(smv + L.qs);       // [rc8][QROW]
  bf16* eb = reinterpret_cast<bf16*>(smv + L.eb);       // [rc16][VR]
  float* cm = reinterpret_cast<float*>(smv + L.cm);     // [rc16]
  float* mr = reinterpret_cast<float*>(smv + L.mr);     // [rc16]
  float* lr = reinterpret_cast<float*>(smv + L.lr);     // [rc16]
  int* rj = reinterpret_cast<int*>(smv + L.rj);         // [rc16]
  float* sc = scores != nullptr
                  ? scores + ((size_t)blockIdx.z * KV * nch + h * nch + chunk) *
                                 E * rc8 * kVerifyScoreRow
                  : reinterpret_cast<float*>(smv + L.sc);
  int* etile = reinterpret_cast<int*>(smv + L.ent);     // [E], -1 = skip
  int* ebits = etile + E;                               // [E]
  int* elo = ebits + E;     // [E] pos - the entry's first position
  float* cpart = reinterpret_cast<float*>(smv + L.ring);  // [rc16][D]

  const int p = pos[b], base = tile_base[b];
  const int* tab = tables + bh * TM;
  const int w0 = max(tab[TM - 2], 0), w1 = max(tab[TM - 1], 0);
  const int t_first = base + p / PS, t_last = base + (p + KK - 1) / PS;
  // a tile some of the block's columns land in
  auto lands = [&](int t) {
    return t >= t_first && t <= t_last && (t == w0 || t == w1) && t < NTALL;
  };

  // ---- the append (one CTA of the row): k/v into the row's write tiles,
  // codes (w > 1) into head 0's
  if (chunk == writer && rg == 0) {
    for (int i = tid; i < KK * D; i += NT) {
      const int j = i / D, d = i % D;
      const int ti = base + (p + j) / PS, ci = (p + j) % PS;
      if ((ti == w0 || ti == w1) && ti < NTALL) {
        const size_t at = ((bh * NTALL + ti) * D + d) * PS + ci;
        kc[at] = kn[(bh * D + d) * KK + j];
        vc[at] = vn[(bh * D + d) * KK + j];
      }
    }
    if (W > 1) {
      const int* tab0 = tables + (size_t)b * KV * TM;
      const int c0 = max(tab0[TM - 2], 0), c1 = max(tab0[TM - 1], 0);
      for (int i = tid; i < KK * W; i += NT) {
        const int j = i / W, s = i % W;
        const int ti = base + (p + j) / PS, ci = (p + j) % PS;
        if ((ti == c0 || ti == c1) && ti < NTALL)
          cc[((bh * NTALL + ti) * W + s) * PS + ci] = cn[(bh * W + s) * KK + j];
      }
    }
  }

  // ---- the chunk's entries, the CTA's query rows (plain loads: q needs
  // no alignment; the rows past NR zero), the zero rows of e, the rows'
  // sums and block positions
  for (int i = tid; i < ne; i += NT) {
    const int t = tab[j0 + i], bits = selm[bh * TM + j0 + i];
    etile[i] = (t >= 0 && t < NTALL && bits != 0) ? t : -1;
    ebits[i] = bits;
    elo[i] = p - (t - base) * PS;
  }
  for (int i = tid; i < rc8 * D; i += NT) {
    const int r = i / D, d = i % D;
    qs[r * QROW + d] = r < NR ? q[(bh * GK + R0 + r) * D + d]
                              : __float2bfloat16(0.f);
  }
  for (int i = tid; i < (rc16 - NR) * VR; i += NT)
    eb[NR * VR + i] = __float2bfloat16(0.f);
  for (int r = tid; r < rc16; r += NT) {
    lr[r] = 0.f;
    rj[r] = (R0 + r) % KK;
  }
  __syncthreads();

  // ---- the ring: step t < 2 ne stages half t % 2 of entry t / 2's K
  // tile, step 2 ne + u the V tile's; one commit group a step (empty for a
  // skipped entry)
  const int nk = 2 * ne, nt = 4 * ne;
  auto issue = [&](int t) {
    if (t < nt) {
      const int i = (t % nk) / 2, hf = t % 2;
      if (etile[i] >= 0) {
        const bf16* src = (t < nk ? kc : vc) +
                          (bh * NTALL + etile[i]) * D * PS + hf * HL;
        bf16* dst = tiles + (size_t)(t % ring) * D * VR;
        for (int c = tid; c < D * (HL / 8); c += NT) {
          const int r = c / (HL / 8), cb = (c % (HL / 8)) * 8;
          cp_async16(dst + r * VR + cb, src + r * PS + cb);
        }
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < ring; ++t) issue(t);

  // the block's new columns of staged half hf of tile tl into its copy
  auto overlay = [&](bf16* tile, const bf16* src, int tl, int hf) {
    if (!lands(tl)) return;            // the same for every thread
    for (int i = tid; i < KK * D; i += NT) {
      const int j = i / D, d = i % D, col = (p + j) % PS;
      if (base + (p + j) / PS == tl && col / HL == hf)
        tile[d * VR + col % HL] = src[(bh * D + d) * KK + j];
    }
    __syncthreads();
  };
  // the last lane of entry i row r sees (-1: none): block position j sees
  // the lanes at positions <= pos + j of the entries whose bit j is set
  auto last_lane = [&](int r, int i) {
    const int j = rj[r];
    return ((ebits[i] >> j) & 1) ? elo[i] + j : -1;
  };

  float oacc[NG][4];
#pragma unroll
  for (int n = 0; n < NG; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  namespace cg = cooperative_groups;
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<ring - 1>();   // step t's half has landed
    const int i = (t % nk) / 2, hf = t % 2;
    const int tl = etile[i];
    bf16* tile = tiles + (size_t)(t % ring) * D * VR;
    if (t >= nk && tl >= 0) {
      // ---- e of entry i's half as bf16 [rows][lanes] against the row
      // max M; l adds the half's unrounded e per row (a warp a row, a
      // fixed order)
      for (int idx = tid; idx < NR * 32; idx += NT) {
        const int r = idx >> 5, kh = 2 * (idx & 31), k = hf * HL + kh;
        const float2 s2 = *reinterpret_cast<const float2*>(
            sc + ((size_t)i * rc8 + r) * kVerifyScoreRow + k);
        const float m = mr[r];
        const int lim = last_lane(r, i);
        const float e0 = k <= lim ? expf(s2.x - m) : 0.f;
        const float e1 = k + 1 <= lim ? expf(s2.y - m) : 0.f;
        *reinterpret_cast<uint32_t*>(eb + r * VR + kh) = pack_bf16(e0, e1);
        const float ls = warp_sum(e0 + e1);
        if (lane == 0) lr[r] += ls;
      }
    }
    __syncthreads();
    if (tl >= 0) overlay(tile, t < nk ? kn : vn, tl, hf);
    if (t < nk && tl >= 0) {
      // ---- scores of the warp's 16 lanes: tokens as m16, rows as n8
      float* srow = sc + (size_t)i * rc8 * kVerifyScoreRow;
      const int tl0 = 16 * (wid & 3), tok0 = hf * HL + tl0;
      uint32_t af[KB][2][4];
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        ldsm_x4_trans(af[kb][0], tile + at_off(tl0, kb * 32, VR));
        ldsm_x4_trans(af[kb][1], tile + at_off(tl0, kb * 32 + 16, VR));
      }
      for (int ng = wid >> 2; ng < ng8; ng += QW) {
        uint32_t qf[KB][4];
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
          ldsm_x4(qf[kb], qs + (ng * 8 + (lane & 7)) * QROW + kb * 32 +
                              (lane >> 3) * 8);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          mma_bf16_16816(acc, af[kb][0], qf[kb]);
          mma_bf16_16816(acc, af[kb][1], qf[kb] + 2);
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = ng * 8 + 2 * t4 + h2;
          const int lim = r < NR ? last_lane(r, i) : -1;
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int k = tok0 + g8 + 8 * v;
            float sv = acc[2 * v + h2] * scale;
            if (clamp > 0.f) sv = fminf(fmaxf(sv, -clamp), clamp);
            srow[r * kVerifyScoreRow + k] = k <= lim ? sv : kNeg;
          }
        }
      }
    } else if (t >= nk && tl >= 0) {
      // ---- PV: V's rows as A (the warp's d tile), E^T as B (two n8
      // groups a load)
#pragma unroll
      for (int ks = 0; ks < HL / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, tile + a_off(wid * 16, ks * 16, VR));
#pragma unroll
        for (int np = 0; np < NG / 2; ++np) {
          if (np * 16 >= NR) break;
          uint32_t bq[4];
          ldsm_x4(bq, eb + bt_off(np * 16, ks * 16, VR));
          mma_bf16_16816(oacc[2 * np], a, bq);
          mma_bf16_16816(oacc[2 * np + 1], a, bq + 2);
        }
      }
    }
    if (t == nk - 1) {
      // ---- the chunk's max per row, then the row's M over the cluster
      __syncthreads();
      for (int r = wid; r < NR; r += NW) {
        float m = kNeg;
        for (int ii = 0; ii < ne; ++ii) {
          if (etile[ii] < 0) continue;
          const float* sr = sc + ((size_t)ii * rc8 + r) * kVerifyScoreRow;
          for (int k = lane; k < PS; k += 32) m = fmaxf(m, sr[k]);
        }
        m = warp_max(m);
        if (lane == 0) cm[r] = m;
      }
      if (nch > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        for (int r = tid; r < NR; r += NT) {
          float m = kNeg;
          for (int c = 0; c < nch; ++c)
            m = fmaxf(m, cluster.map_shared_rank(cm, c)[r]);
          mr[r] = m;
        }
      } else {
        __syncthreads();
        for (int r = tid; r < NR; r += NT) mr[r] = cm[r];
      }
    }
    __syncthreads();      // step t's slot (and e) is read out
    issue(t + ring);
  }
  cp_async_wait<0>();
  __syncthreads();        // the walk is done: cpart over the ring

  // ---- o = pv / max(l, 1e-30), the ranks' sums in chunk order
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    if (n * 8 >= NR) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = wid * 16 + g8 + 8 * (e >> 1);
      const int r = n * 8 + 2 * t4 + (e & 1);
      if (r >= NR) continue;
      if (nch == 1)
        o[(bh * GK + R0 + r) * D + d] =
            __float2bfloat16(oacc[n][e] / fmaxf(lr[r], 1e-30f));
      else
        cpart[r * D + d] = oacc[n][e];
    }
  }
  if (nch == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int idx = (int)cluster.block_rank() * NT + tid; idx < NR * D;
       idx += nch * NT) {
    const int r = idx / D;
    float num = 0.f, den = 0.f;
    for (int c = 0; c < nch; ++c) {
      num += cluster.map_shared_rank(cpart, c)[idx];
      den += cluster.map_shared_rank(lr, c)[r];
    }
    o[(bh * GK + R0) * D + idx] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
  cluster.sync();         // no rank leaves while another reads its rows
}

// the instance for d_head D and NG n8 groups
template <int D>
const void* verify_kernel(int ng) {
  return ng == 2   ? (const void*)verify_attention_split_kernel<D, 2>
         : ng == 4 ? (const void*)verify_attention_split_kernel<D, 4>
                   : (const void*)verify_attention_split_kernel<D, 8>;
}

int launch_verify_split(const void* q, void* kc, void* vc, void* cc,
                        const void* tables, const void* selm, const void* pos,
                        const void* kn, const void* vn, const void* cn,
                        const void* tile_base, int writer, void* o, int B,
                        int KV, int GK, int KK, int D, int NTALL, int W,
                        int TM, int PS, float scale, float clamp, int E,
                        int nch, int RC, float* scores,
                        cudaStream_t stream) {
  // nch chunks of E entries cover the row's TM entries, each once, the
  // write entries (the last two) in the writer chunk; row groups of RC
  // rows cover GK
  const int nrg = RC > 0 ? (GK + RC - 1) / RC : 0;
  if (PS != kSplitPS || (D != 64 && D != 128) || KK < 1 || KK > 30 ||
      GK % KK != 0 || GK / KK > 8 || RC < 1 || RC > kVerifyRowsMax ||
      E < 1 || nch < 1 || nch > kRowsCluster || (nch - 1) * E >= TM ||
      nch * E < TM || TM < 2 || writer != (TM - 2) / E ||
      writer != (TM - 1) / E ||
      (verify_split_scores(E, RC, D) > 0 && scores == nullptr))
    return (int)cudaErrorInvalidValue;
  // the fewest n8 groups that hold RC rows
  const int ng = RC <= 16 ? 2 : RC <= 32 ? 4 : 8;
  const void* kern = D == 64 ? verify_kernel<64>(ng) : verify_kernel<128>(ng);
  const int smem = verify_smem(E, RC, D, scores == nullptr).total;
  if (smem > 48 * 1024) {
    cudaError_t e = raise_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nch, KV, B * nrg);
  cfg.blockDim = dim3(D * 2);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nch;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = nch > 1;
  using bf = __nv_bfloat16;
  const bf* q_ = (const bf*)q;
  bf *kc_ = (bf*)kc, *vc_ = (bf*)vc, *o_ = (bf*)o;
  int* cc_ = (int*)cc;
  const int *tab_ = (const int*)tables, *selm_ = (const int*)selm,
            *pos_ = (const int*)pos, *cn_ = (const int*)cn,
            *tb_ = (const int*)tile_base;
  const bf *kn_ = (const bf*)kn, *vn_ = (const bf*)vn;
  int nrg_ = nrg;
  void* args[] = {&q_, &kc_, &vc_, &cc_, &tab_, &selm_, &pos_, &kn_,
                  &vn_, &cn_, &tb_, &o_, &scores, &KV, &GK, &KK, &NTALL,
                  &W, &TM, &E, &RC, &nrg_, &writer, &scale, &clamp};
  return (int)cudaLaunchKernelExC(&cfg, kern, args);
}

}  // namespace spt

// floats of global score buffer a CTA of the split walk takes for chunks of
// E entries, G query rows, d_head D and W codes: 0 when its scores stay in
// shared memory
extern "C" int spt_rows_split_scores(int E, int G, int D, int W) {
  return spt::rows_split_scores(E, G, D, W);
}

// floats of global score buffer a CTA of the verify split walk takes for
// chunks of E entries, RC query rows and d_head D: 0 when its scores stay
// in shared memory
extern "C" int spt_verify_split_scores(int E, int RC, int D) {
  return spt::verify_split_scores(E, RC, D);
}

// walk (ops/decode_attention.py rows_route): 0 = the one-pass kernel
// (scores kept in shared memory), 1 = the two-pass walk, 2 (bf16) = the
// split walk, chunks of E entries a row (scores: null, or B * KV * chunks
// rows of spt_rows_split_scores floats when that is not 0; writer: [B,
// N_TAB] the chunk that appends, split_writer)
extern "C" int spt_decode_attention(
    int dtype, int walk, const void* q, void* kc, void* vc, void* cc,
    const void* tables, const void* n_tiles, const void* pos, const void* kn,
    const void* vn, const void* cn, const void* tile_base, void* o, int B,
    int KV, int G, int D, int NTALL, int W, int NTAB, int TM, int TPS, int PS,
    float scale, float clamp, int E, int chunks, void* scores,
    const void* writer, void* stream) {
  using bf = __nv_bfloat16;
  if (walk == 2) {
    if (dtype != spt::kBF16) return (int)cudaErrorInvalidValue;
    return spt::launch_attention_split(
        q, kc, vc, cc, tables, n_tiles, pos, kn, vn, cn, tile_base, writer, o,
        B, KV, G, D, NTALL, W, NTAB, TM, TPS, PS, scale, clamp, E, chunks,
        (float*)scores, (cudaStream_t)stream);
  }
  if (walk == 1) {
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

// walk 0: decode_attention_q_kernel; 1: the two-pass walk; 2 (bf16 q):
// the split kernel with E entries a chunk (past kSplitCluster chunks, work:
// [B * KV * chunks * G][D + 2] f32 partials and counters: B * KV zeroed
// ints; writer: [B, N_TAB] the chunk that appends, split_writer)
extern "C" int spt_decode_attention_q(
    int dtype, int walk, const void* q, void* kc, void* vc, void* cc,
    void* ksc, void* vsc, const void* tables, const void* n_tiles,
    const void* pos, const void* kn, const void* vn, const void* cn,
    const void* ksn, const void* vsn, const void* tile_base, void* o, int B,
    int KV, int G, int D, int NTALL, int W, int KVP, int NTAB, int TM,
    int TPS, int PS, float scale, float clamp, int E, void* work,
    void* counters, const void* writer, void* stream) {
  using bf = __nv_bfloat16;
  if (walk == 2) {
    if (dtype != spt::kBF16) return (int)cudaErrorInvalidValue;
    return spt::launch_attention_q_split(
        q, kc, vc, cc, ksc, vsc, tables, n_tiles, pos, kn, vn, cn, ksn, vsn,
        tile_base, writer, o, B, KV, G, D, NTALL, W, KVP, NTAB, TM, TPS, PS,
        scale, clamp, E, (float*)work, (int*)counters, (cudaStream_t)stream);
  }
  const bool two_pass = walk == 1;
  auto f = two_pass
               ? (dtype == spt::kBF16 ? spt::launch_walk<bf, int8_t>
                                      : spt::launch_walk<float, int8_t>)
               : (dtype == spt::kBF16 ? spt::launch_attention_q<bf>
                                      : spt::launch_attention_q<float>);
  return f(q, kc, vc, cc, ksc, vsc, tables, n_tiles, pos, kn, vn, cn, ksn,
           vsn, tile_base, o, B, KV, G, D, NTALL, W, KVP, NTAB, TM, TPS, PS,
           scale, clamp, (cudaStream_t)stream);
}

// split (ops/decode_attention.py verify_route): 0 = the walk kernel, RC
// query rows a CTA; 1 (bf16) = the split walk, nch chunks of E entries a
// row and groups of RC query rows (scores:
// null, or B * row groups * KV * nch rows of spt_verify_split_scores floats
// when that is not 0; writer: the chunk that appends, verify_writer)
extern "C" int spt_verify_attention(
    int dtype, int split, const void* q, void* kc, void* vc, void* cc,
    const void* tables, const void* selm, const void* pos, const void* kn,
    const void* vn, const void* cn, const void* tile_base, void* o, int B,
    int KV, int GK, int KK, int D, int NTALL, int W, int TM, int PS,
    float scale, float clamp, int RC, int E, int nch, void* scores,
    int writer, void* stream) {
  if (split) {
    if (dtype != spt::kBF16) return (int)cudaErrorInvalidValue;
    return spt::launch_verify_split(
        q, kc, vc, cc, tables, selm, pos, kn, vn, cn, tile_base, writer, o, B,
        KV, GK, KK, D, NTALL, W, TM, PS, scale, clamp, E, nch, RC,
        (float*)scores, (cudaStream_t)stream);
  }
  auto f = dtype == spt::kBF16 ? spt::launch_verify<__nv_bfloat16>
                               : spt::launch_verify<float>;
  return f(q, kc, vc, cc, tables, selm, pos, kn, vn, cn, tile_base, o, B, KV,
           GK, KK, D, NTALL, W, TM, PS, scale, clamp, RC,
           (cudaStream_t)stream);
}
