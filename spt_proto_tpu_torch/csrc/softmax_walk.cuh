// The two-pass softmax walk of the decode attention kernels whose shared
// memory must not grow with the context: paged_attention_kernel and
// tile_pool_attention_kernel (csrc/paged_attention.cu) and
// decode_attention_walk_kernel (csrc/decode_attention.cu).
//
// One CTA serves the G query rows of one (slot, kv head) or table row. A
// tile of PS tokens is staged into shared memory as f32 rows of stride
// cols + 1 (bank-conflict free for both the score and the PV loops).
// Shared memory holds one tile, q, the tile's probabilities, the output
// accumulator and, for int8 keys, the tile's per-token scales, so it
// depends on G, D and PS only. Pass 1 reads every K tile for the row
// statistics; pass 2 reads K again, computes the probabilities of the tile
// and adds p v over its staged V tile.
//
// The walk has two numerics, one for each family of TPU kernels it
// replaces (kNormLast):
//   false  the paged-attention oracle: pass 1 keeps each row's running max
//          and rescaled sum of exp (an online softmax over the statistics
//          only); pass 2 rounds p = exp(s - m) / l to T before the PV
//          product (normalise, then round).
//   true   the TPU decode_attention_rows kernels: pass 1 keeps the row max
//          only; pass 2 sums the unrounded e = exp(s - m) into l and uses
//          e rounded to T, or e times the token's value scale for int8
//          values (left unrounded), and o = acc / l at the end (round,
//          then divide).
// With per-token key scales (w.ks), the score of token t is
// dot * scale * ks[t], the int8 rows kernels' order.
#pragma once

#include "common.cuh"

namespace spt {

constexpr int kWalkThreads = 128;

// Stage a contiguous [rows][cols] tile of T into shared memory as f32 with
// row stride cols + 1, 16-byte loads. With row_scale (int8 pages), value x
// of row r becomes ((float)x * row_scale[r]) / 127.5 rounded to R.
template <typename T, typename R>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, int rows,
                                          int cols,
                                          const float* row_scale) {
  constexpr int N = 16 / (int)sizeof(T);
  const int nvec = rows * cols / N, ld = cols + 1;
  // plain (coherent) loads: the appending kernels read back what they wrote
  const int4* s4 = reinterpret_cast<const int4*>(src);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int4 raw = s4[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    const int r = i * N / cols, c = i * N % cols;
    float* out = dst + r * ld + c;
    if (row_scale != nullptr) {
      const float h = row_scale[r];
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = rt<R>((to_f(e[j]) * h) / 127.5f);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
    }
  }
}

struct WalkSmem {
  float* tile;   // one staged tile: [PS][D + 1] or [D][PS + 1]
  float* qs;     // [G][D]
  float* sc;     // [G][PS] scores, then probabilities
  float* acc;    // [G][D]
  float* mrow;   // [G] running max
  float* lrow;   // [G] sum of exp(s - max)
  float* ks;     // [PS] per-token key scales, or nullptr
  float* vs;     // [PS] per-token value scales, or nullptr
};

__device__ __forceinline__ WalkSmem walk_smem(float* sm, int G, int D,
                                              int PS, int tile_floats,
                                              bool scales) {
  WalkSmem w;
  w.tile = sm;
  w.qs = w.tile + tile_floats;
  w.sc = w.qs + G * D;
  w.acc = w.sc + G * PS;
  w.mrow = w.acc + G * D;
  w.lrow = w.mrow + G;
  w.ks = scales ? w.lrow + G : nullptr;
  w.vs = scales ? w.ks + PS : nullptr;
  return w;
}

// the Python wrappers compute the same for their envelope checks
__host__ __device__ inline size_t walk_smem_bytes(int G, int D, int PS,
                                                  int tile_floats,
                                                  bool scales) {
  return sizeof(float) * ((size_t)tile_floats + 2 * (size_t)G * D +
                          (size_t)G * PS + 2 * (size_t)G +
                          (scales ? 2 * (size_t)PS : 0));
}

__device__ __forceinline__ void walk_init(const WalkSmem& w, int G, int D) {
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) w.acc[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    w.mrow[g] = kNeg;
    w.lrow[g] = 0.f;
  }
}

// The walk over n_ent tiles of PS tokens for G query rows (q already in
// w.qs, and walk_init called). A staged tile's token t, dimension d sits at
// w.tile[t * st_t + d * st_d]. nvalid(j): entry j's valid lanes 0..n-1
// (0 = skip); stage_k(j) stages its K tile (and w.ks / w.vs when present),
// stage_v(j) its V tile only. Every thread of the block calls; w.acc holds
// the output when it returns.
template <typename T, bool kNormLast, typename NV, typename SK, typename SV>
__device__ void softmax_walk(const WalkSmem& w, int n_ent, int G, int D,
                             int PS, int st_t, int st_d, float scale,
                             float clamp, NV nvalid, SK stage_k,
                             SV stage_v) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  // scaled (clamped) scores of the staged K tile into w.sc
  auto scores = [&](int n) {
    for (int i = tid; i < G * PS; i += blockDim.x) {
      const int g = i / PS, t = i % PS;
      const float* qr = w.qs + g * D;
      const float* kr = w.tile + t * st_t;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d * st_d];
      float s = dot * scale;
      if (w.ks != nullptr) s *= w.ks[t];
      if (clamp > 0.f) s = fminf(fmaxf(s, -clamp), clamp);
      w.sc[i] = t < n ? s : kNeg;
    }
  };
  // ---- pass 1: each row's max (and, normalising first, its sum of exp)
  for (int j = 0; j < n_ent; ++j) {
    const int n = nvalid(j);
    if (n == 0) continue;            // the same for every thread
    stage_k(j);
    __syncthreads();
    scores(n);
    __syncthreads();
    for (int g = warp; g < G; g += nw) {
      float mp = kNeg;
      for (int t = lane; t < n; t += 32) mp = fmaxf(mp, w.sc[g * PS + t]);
      mp = warp_max(mp);
      const float m_old = w.mrow[g], m_new = fmaxf(m_old, mp);
      if (!kNormLast) {
        float l = 0.f;
        for (int t = lane; t < n; t += 32)
          l += expf(w.sc[g * PS + t] - m_new);
        l = warp_sum(l);
        if (lane == 0) w.lrow[g] = w.lrow[g] * expf(m_old - m_new) + l;
      }
      if (lane == 0) w.mrow[g] = m_new;
    }
    __syncthreads();
  }
  // ---- pass 2: the tile's probabilities, then o += p v
  for (int j = 0; j < n_ent; ++j) {
    const int n = nvalid(j);
    if (n == 0) continue;
    stage_k(j);
    __syncthreads();
    scores(n);
    __syncthreads();
    for (int g = warp; g < G; g += nw) {
      const float m = w.mrow[g];
      float l = 0.f;
      for (int t = lane; t < PS; t += 32) {
        float p = 0.f;
        if (t < n) {
          const float e = expf(w.sc[g * PS + t] - m);
          if (kNormLast) {
            l += e;
            p = w.vs != nullptr ? e * w.vs[t] : rt<T>(e);
          } else {
            p = rt<T>(e / w.lrow[g]);
          }
        }
        w.sc[g * PS + t] = p;
      }
      if (kNormLast) {
        l = warp_sum(l);
        if (lane == 0) w.lrow[g] += l;
      }
    }
    stage_v(j);                      // w.tile is no longer read above
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      const float* pr = w.sc + g * PS;
      const float* vr = w.tile + d * st_d;
      float a = 0.f;
      for (int t = 0; t < n; ++t) a += pr[t] * vr[t * st_t];
      w.acc[i] += a;
    }
    __syncthreads();
  }
  if (kNormLast) {
    for (int i = tid; i < G * D; i += blockDim.x)
      w.acc[i] /= fmaxf(w.lrow[i / D], 1e-30f);
    __syncthreads();
  }
}

}  // namespace spt
