// Fused sparse decode FRONT: norm1 (LayerNorm or RMSNorm) + QKV projection
// (+ bias) (+ RoPE) + int8 KV quantization + PQ encode of q and k + per-
// (slot, kv-head) tile selection with group-pooled scores, in one launch
// per decode layer.
//
// Replaces the TPU kernel spt_proto_tpu/ops/pallas/decode_front.py
// (decode_front / _front_kernel) in its four weight forms: the stacked fp
// QKV [3, D, D] (MHA), the column-packed int8 [D, 3D_pad] with per-column
// f32 scales (MHA, int8 weight-only serving), and the GQA triples: three
// fp kernels wq [D, H*dh], wk / wv [D, KV*dh], or three int8 parts, each
// N-padded to 256 on its own (so each has its own row stride) with its own
// scales. OPT takes LayerNorm and biases; LLaMA takes RMSNorm, no biases,
// and RoPE on q and k.
//
// Bound on the H100: memory. Per launch it must read the layer's QKV
// weights and the layer's int32 PQ code slab for the full tiles. OPT-125M
// (B=8, ctx 2048): 3 x 768 x 768 bf16 = 3.5 MB + 8 x 12 x 16 tiles x 8 x
// 128 x 4 B = 6.3 MB, 2.9 us at 3.35 TB/s. LLaMA-7B: 3 x 4096 x 4096 bf16 =
// 101 MB (int8 50 MB); Llama-3-8B (8 of 32 heads are kv heads): 4096 x
// 6144 bf16 = 50 MB (int8 25 MB). The arithmetic (a B x D x (H+2KV)dh GEMV
// plus the encode dots) is far below the tensor-core line.
//
// Design: one CTA per (kv head, slot), so no grid-wide synchronisation is
// needed: each CTA normalises its slot's row and computes only its kv
// head's NP = G + 2 projection columns of d_head each (the G query heads j*G
// .. j*G+G-1 of kv head j, then k, then v; the slots of a head re-read the
// same weight slice, from L2 where it fits). The weight forms differ only
// in where each part's columns start and in its row stride, so the entry
// takes a pointer and a stride per part. The GEMV walks one row pointer per
// part, G + 2 parts three at a time, with explicit read-only loads. The
// packed int8 form (MHA: its q, k and v D columns apart on one row) is a
// template instance of its own: G = 1 at compile time and one row pointer
// with the parts at fixed offsets from it. Both keep three loads in flight
// per row, unrolled 8 deep (the loop is bound by load latency, not bytes).
// It then rotates q and k (RoPE, in f32 on the
// dtype-rounded projections, rounded back to the dtype), quantises k and v,
// PQ-encodes the G query rows and k, and scans only its own (slot, kv head)
// code slab, counting matches of every group member's codes: the pooled
// score is count / (PS x G), exact in f32 as in the TPU kernel. Selection
// is a short serial loop (<= a few dozen tiles) that reproduces lax.top_k
// order: highest mean match first, lowest tile index on ties, then the
// current tile appended last.
//
// The int8 forms have int8_matmul's numerics: hn rounded to bf16, each K
// block of BK rows (256, or 128 when D is not a multiple of 256) summed in
// f32 by the ksplit thread groups into its own partial, the block partials
// added in ascending order, then the column's scale, a round to the serving
// dtype and the bias in that dtype.
#include <type_traits>

#include "common.cuh"

namespace spt {

constexpr int kFrontThreads = 256;

// INT8: the int8 weight forms (per-part scales, K blocks of BK rows); else
// fp weights in the serving dtype. PACKED (int8 only): the packed MHA form,
// G = 1 and the parts on the row stride ldq, poff elements apart (wk, wv
// unused in the GEMV); else one pointer and stride per part.
template <typename T, bool INT8, bool PACKED>
__global__ void __launch_bounds__(kFrontThreads) decode_front_kernel(
    const T* __restrict__ x, const T* __restrict__ nsc,
    const T* __restrict__ nbi,
    const void* __restrict__ wq_, const void* __restrict__ wk_,
    const void* __restrict__ wv_, int ldq, int ldk, int ldv, long poff,
    const float* __restrict__ sq, const float* __restrict__ sk,
    const float* __restrict__ sv, const T* __restrict__ bq,
    const T* __restrict__ bk, const T* __restrict__ bv,
    const float* __restrict__ bd, const float* __restrict__ cbn,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const int* __restrict__ c_cache, const int* __restrict__ pos, int base,
    T* __restrict__ q_out, T* __restrict__ k_out, T* __restrict__ v_out,
    int* __restrict__ c_new, int* __restrict__ tables,
    int8_t* __restrict__ k8, int8_t* __restrict__ v8,
    float* __restrict__ ks, float* __restrict__ vs, int D, int H, int KV,
    int DH, int NS, int NC, int W, int NTALL, int NT, int NSEL, int PS,
    int BK, float inv_pg, float eps, int rms, int quantized) {
  using Wt = typename std::conditional<INT8, int8_t, T>::type;
  const Wt* wq = static_cast<const Wt*>(wq_);
  const Wt* wk = static_cast<const Wt*>(wk_);
  const Wt* wv = static_cast<const Wt*>(wv_);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nwarps = nthr >> 5;
  // parts; encoded vectors. A fixed G = 1 halves the packed form's time;
  // the fp stack ran 1.6x slower with it (kernel_ab.py, H100), so MHA fp
  // weights take the general instance
  const int G = PACKED ? 1 : H / KV, NP = G + 2, NE = G + 1;
  const int ksplit = nthr / DH;
  const int F = NS * NC;
  const int nblk = INT8 ? D / BK : 1;

  extern __shared__ float sm[];
  float* hn = sm;                          // [D] normalised row
  float* part = hn + D;                    // [NP][nblk][ksplit][DH] partials
  float* qkv = part + (size_t)NP * nblk * ksplit * DH;  // [NP][DH]
  float* dots = qkv + NP * DH;             // [NE][F] encode scores
  float* tsc = dots + NE * F;              // [NT] tile scores
  float* red = tsc + NT;                   // [32] reduction scratch
  int* codes = reinterpret_cast<int*>(red + 32);   // [NE][NS] q rows, k

  // column of part t's output c within its part's weight, scale and bias
  auto col_of = [&](int t, int c) -> size_t {
    return t < G ? (size_t)(h * G + t) * DH + c : (size_t)h * DH + c;
  };

  // ---- norm1: f32 statistics, affine in the serving dtype
  const T* xr = x + (size_t)b * D;
  float s = 0.f;
  if (rms) {
    for (int i = tid; i < D; i += nthr) {
      const float v = to_f(xr[i]);
      s += v * v;
    }
    const float ms = block_sum(s, red) / (float)D;
    const float r = 1.0f / sqrtf(ms + eps);
    for (int i = tid; i < D; i += nthr) {
      const float v = rt<T>(to_f(nsc[i]) * rt<T>(to_f(xr[i]) * r));
      hn[i] = INT8 ? rt<__nv_bfloat16>(v) : v;   // int8: bf16 operand
    }
  } else {
    for (int i = tid; i < D; i += nthr) s += to_f(xr[i]);
    const float mu = block_sum(s, red) / (float)D;
    s = 0.f;
    for (int i = tid; i < D; i += nthr) {
      const float d = to_f(xr[i]) - mu;
      s += d * d;
    }
    const float var = block_sum(s, red) / (float)D;
    const float r = 1.0f / sqrtf(var + eps);
    for (int i = tid; i < D; i += nthr) {
      const float y = rt<T>((to_f(xr[i]) - mu) * r);
      const float v = rt<T>(rt<T>(y * to_f(nsc[i])) + to_f(nbi[i]));
      hn[i] = INT8 ? rt<__nv_bfloat16>(v) : v;
    }
  }
  __syncthreads();

  // ---- this kv head's NP projection columns: a GEMV over D rows, K split
  // over ksplit thread groups (int8: per K block), three parts at a time
  if (PACKED && tid < ksplit * DH) {
    // column h*DH + c of the three parts, poff elements apart on one row
    const int c = tid % DH, kp = tid / DH;
    const Wt* wc = wq + (size_t)h * DH + c;
    const size_t step = (size_t)nblk * ksplit * DH;   // one part
    for (int blk = 0; blk < nblk; ++blk) {
      const int i0 = blk * BK + kp * (BK / ksplit), i1 = i0 + BK / ksplit;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 8
      for (int i = i0; i < i1; ++i) {
        const float hv = hn[i];
        const Wt* wr = wc + (size_t)i * ldq;
        a0 += hv * to_f(wr[0]);
        a1 += hv * to_f(wr[poff]);
        a2 += hv * to_f(wr[2 * poff]);
      }
      float* dst = part + ((size_t)blk * ksplit + kp) * DH + c;
      dst[0] = a0;
      dst[step] = a1;
      dst[2 * step] = a2;
    }
  } else if (!PACKED && tid < ksplit * DH) {
    const int c = tid % DH, kp = tid / DH;
    // part t's column c: its weight pointer and row stride
    auto wcol = [&](int t) -> const Wt* {
      return (t < G ? wq : (t == G ? wk : wv)) + col_of(t, c);
    };
    auto wld = [&](int t) -> int {
      return t < G ? ldq : (t == G ? ldk : ldv);
    };
    for (int t0 = 0; t0 < NP; t0 += 3) {
      const int n3 = min(3, NP - t0);
      const int t1 = min(t0 + 1, NP - 1), t2 = min(t0 + 2, NP - 1);
      const Wt* __restrict__ p0 = wcol(t0);
      const Wt* __restrict__ p1 = wcol(t1);
      const Wt* __restrict__ p2 = wcol(t2);
      const int ld0 = wld(t0), ld1 = wld(t1), ld2 = wld(t2);
      for (int blk = 0; blk < nblk; ++blk) {
        const int i0 = INT8 ? blk * BK + kp * (BK / ksplit)
                            : (int)((long)kp * D / ksplit);
        const int i1 = INT8 ? i0 + BK / ksplit
                            : (int)((long)(kp + 1) * D / ksplit);
        // row pointers stepped by their strides: three loads in flight a
        // row (the parts past n3 re-read the last part's row, unused).
        // Explicit read-only loads: with the compiler's own choice of the
        // same load kind the loop ran 3.4x slower (kernel_ab.py, H100)
        const Wt* r0 = p0 + (size_t)i0 * ld0;
        const Wt* r1 = p1 + (size_t)i0 * ld1;
        const Wt* r2 = p2 + (size_t)i0 * ld2;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 8
        for (int i = i0; i < i1; ++i) {
          const float hv = hn[i];
          a0 += hv * to_f(__ldg(r0));
          a1 += hv * to_f(__ldg(r1));
          a2 += hv * to_f(__ldg(r2));
          r0 += ld0;
          r1 += ld1;
          r2 += ld2;
        }
        float* dst =
            part + (((size_t)t0 * nblk + blk) * ksplit + kp) * DH + c;
        const size_t step = (size_t)nblk * ksplit * DH;   // one part
        dst[0] = a0;
        if (n3 > 1) dst[step] = a1;
        if (n3 > 2) dst[2 * step] = a2;
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < NP * DH; j += nthr) {
    const int t = j / DH, c = j % DH;
    const size_t col = col_of(t, c);
    float a = 0.f;
    for (int blk = 0; blk < nblk; ++blk) {   // blocks in ascending order
      float pb = 0.f;
      for (int kp = 0; kp < ksplit; ++kp)
        pb += part[(((size_t)t * nblk + blk) * ksplit + kp) * DH + c];
      a += pb;
    }
    if (INT8) a *= (t < G ? sq : (t == G ? sk : sv))[col];
    // the dot rounds to the serving dtype BEFORE the dtype bias add
    float y = rt<T>(a);
    const T* bias = t < G ? bq : (t == G ? bk : bv);
    if (bias != nullptr) y = rt<T>(y + to_f(bias[col]));
    qkv[j] = y;
  }
  __syncthreads();

  // ---- RoPE (LLaMA) on the G query rows and k: rotate-half in f32 at the
  // slot's position, separate roundings (no fused multiply-add), back to
  // the dtype. The partial buffer is free now and holds the new values.
  if (cos_t != nullptr) {
    const int half = DH / 2;
    const float* cr = cos_t + (size_t)b * DH;
    const float* sr = sin_t + (size_t)b * DH;
    for (int j = tid; j < NE * DH; j += nthr) {
      const int t = j / DH, c = j % DH;
      const float xv = qkv[j];
      const float rv = c < half ? -qkv[t * DH + c + half]
                                : qkv[t * DH + c - half];
      part[j] = rt<T>(__fadd_rn(__fmul_rn(cr[c], xv), __fmul_rn(sr[c], rv)));
    }
    __syncthreads();
    for (int j = tid; j < NE * DH; j += nthr) qkv[j] = part[j];
    __syncthreads();
  }
  for (int j = tid; j < NP * DH; j += nthr) {
    const int t = j / DH, c = j % DH;
    if (t < G)
      q_out[(size_t)b * H * DH + col_of(t, c)] = from_f<T>(qkv[j]);
    else
      (t == G ? k_out : v_out)[(size_t)b * KV * DH + col_of(t, c)] =
          from_f<T>(qkv[j]);
  }

  // ---- int8 per-token quantisation of k (warp 0) and v (warp 1):
  // max-abs / 127, round half to even, clip +-127
  if (quantized && wid < 2) {
    const float* src = qkv + (G + wid) * DH;
    float amax = 0.f;
    for (int i = lane; i < DH; i += 32) amax = fmaxf(amax, fabsf(src[i]));
    amax = warp_max(amax);
    const float sc = fmaxf(amax, 1e-8f) / 127.0f;
    int8_t* dst = (wid == 0 ? k8 : v8) + (size_t)b * KV * DH + (size_t)h * DH;
    for (int i = lane; i < DH; i += 32) {
      const float qv = fminf(fmaxf(rintf(src[i] / sc), -127.f), 127.f);
      dst[i] = (int8_t)qv;
    }
    if (lane == 0) (wid == 0 ? ks : vs)[b * KV + h] = sc;
  }

  // ---- PQ encode the G query rows and k: score = |c|^2 - 2 z.c, argmin
  // per subspace
  for (int j = tid; j < NE * F; j += nthr) {
    const int vec = j / F, cc = j % F;
    const float* z = qkv + vec * DH;
    float dot = 0.f;
    for (int d = 0; d < DH; ++d) dot += z[d] * bd[(size_t)d * F + cc];
    dots[j] = cbn[cc] - 2.0f * dot;
  }
  __syncthreads();
  for (int j = tid; j < NE * NS; j += nthr) {
    const int vec = j / NS, sub = j % NS;
    const float* sc = dots + vec * F + sub * NC;
    int best = 0;
    float bv_ = sc[0];
    for (int c = 1; c < NC; ++c)   // strict <: lowest index wins ties
      if (sc[c] < bv_) { bv_ = sc[c]; best = c; }
    codes[vec * NS + sub] = best;
  }
  __syncthreads();
  for (int i = tid; i < W; i += nthr)
    c_new[((size_t)b * KV + h) * W + i] = i < NS ? codes[G * NS + i] : -2;

  // ---- group-pooled mean match of the query rows' codes against each
  // FULL tile of this layer
  const int cur = pos[b] / PS;
  const int nfull = min(cur, NT);
  for (int t = wid; t < NT; t += nwarps) {
    float score = kNeg;
    if (t < nfull) {
      const int* slab =
          c_cache + (((size_t)b * KV + h) * NTALL + base + t) * W * PS;
      int cnt = 0;
      for (int sub = 0; sub < NS; ++sub) {
        for (int p = lane; p < PS; p += 32) {
          const int cv = slab[sub * PS + p];
          for (int g = 0; g < G; ++g) cnt += cv == codes[g * NS + sub];
        }
      }
      cnt = warp_sum_int(cnt);
      score = (float)cnt * inv_pg;
    }
    if (lane == 0) tsc[t] = score;
  }
  __syncthreads();

  // ---- top NSEL-1 full tiles (lax.top_k order), current tile last
  if (tid == 0) {
    int* tab = tables + ((size_t)b * KV + h) * NSEL;
    for (int c = 0; c < NSEL - 1; ++c) {
      float val = tsc[0];
      int idx = 0;
      for (int t = 1; t < NT; ++t)
        if (tsc[t] > val) { val = tsc[t]; idx = t; }
      tab[c] = val > 0.5f * kNeg ? idx + base : -1;
      tsc[idx] = kNeg;
    }
    tab[NSEL - 1] = cur + base;
  }
}

// The packed layout of int8 parts: G = 1, one row stride, and wk / wv at
// one constant distance after wq / wk. Returns that distance in bytes (=
// elements), or 0 when the parts are laid out otherwise.
long packed_part_offset(const void* wq, const void* wk, const void* wv,
                        int ldq, int ldk, int ldv, int G) {
  const long dk = (long)((const char*)wk - (const char*)wq);
  const long dv = (long)((const char*)wv - (const char*)wk);
  return G == 1 && ldq == ldk && ldk == ldv && dk == dv && dk > 0 ? dk : 0;
}

template <typename T>
int launch_front(int int8w, const void* x, const void* nsc, const void* nbi,
                 const void* wq, const void* wk, const void* wv, int ldq,
                 int ldk, int ldv, const float* sq, const float* sk,
                 const float* sv, const void* bq, const void* bk,
                 const void* bv, const float* bd, const float* cbn,
                 const float* cos_t, const float* sin_t, const int* c_cache,
                 const int* pos, int base, void* q, void* k, void* v,
                 int* c_new, int* tables, int8_t* k8, int8_t* v8, float* ks,
                 float* vs, int B, int D, int H, int KV, int DH, int NS,
                 int NC, int W, int NTALL, int NT, int NSEL, int PS, int BK,
                 float inv_pg, float eps, int rms, int quantized,
                 cudaStream_t stream) {
  const int ksplit = kFrontThreads / DH;
  const int G = H / KV, NP = G + 2, NE = G + 1;
  const int nblk = int8w ? D / BK : 1;
  const size_t smem =
      sizeof(float) * (D + (size_t)NP * nblk * ksplit * DH + NP * DH +
                       NE * NS * NC + NT + 32 + NE * NS);
  const long poff =
      int8w ? packed_part_offset(wq, wk, wv, ldq, ldk, ldv, G) : 0;
  auto kernel = !int8w ? decode_front_kernel<T, false, false>
                       : (poff ? decode_front_kernel<T, true, true>
                               : decode_front_kernel<T, true, false>);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(KV, B);
  kernel<<<grid, kFrontThreads, smem, stream>>>(
      (const T*)x, (const T*)nsc, (const T*)nbi, wq, wk, wv, ldq, ldk, ldv,
      poff, sq, sk, sv, (const T*)bq, (const T*)bk, (const T*)bv, bd, cbn,
      cos_t, sin_t, c_cache, pos, base, (T*)q, (T*)k, (T*)v, c_new, tables,
      k8, v8, ks, vs, D, H, KV, DH, NS, NC, W, NTALL, NT, NSEL, PS, BK,
      inv_pg, eps, rms, quantized);
  return (int)cudaGetLastError();
}

}  // namespace spt

// One entry for every weight form: per part (q, k, v) a pointer to its
// first column for kv head 0, its row stride and, for int8 weights
// (int8w = 1), its per-column scales; the biases, the norm bias and the
// RoPE tables are null when absent. rms = 1 takes RMSNorm (LLaMA).
extern "C" int spt_decode_front(
    int dtype, int int8w, const void* x, const void* nsc, const void* nbi,
    const void* wq, const void* wk, const void* wv, int ldq, int ldk,
    int ldv, const void* sq, const void* sk, const void* sv, const void* bq,
    const void* bk, const void* bv, const void* bd, const void* cbn,
    const void* cos_t, const void* sin_t, const void* c_cache,
    const void* pos, int base, void* q, void* k, void* v, void* c_new,
    void* tables, void* k8, void* v8, void* ks, void* vs, int B, int D,
    int H, int KV, int DH, int NS, int NC, int W, int NTALL, int NT,
    int NSEL, int PS, int BK, float inv_pg, float eps, int rms,
    int quantized, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_front<__nv_bfloat16>
                               : spt::launch_front<float>;
  return f(int8w, x, nsc, nbi, wq, wk, wv, ldq, ldk, ldv, (const float*)sq,
           (const float*)sk, (const float*)sv, bq, bk, bv, (const float*)bd,
           (const float*)cbn, (const float*)cos_t, (const float*)sin_t,
           (const int*)c_cache, (const int*)pos, base, q, k, v, (int*)c_new,
           (int*)tables, (int8_t*)k8, (int8_t*)v8, (float*)ks, (float*)vs, B,
           D, H, KV, DH, NS, NC, W, NTALL, NT, NSEL, PS, BK, inv_pg, eps, rms,
           quantized, (cudaStream_t)stream);
}
