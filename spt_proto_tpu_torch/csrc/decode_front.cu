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
// Design. The serving dtype (bf16) runs three launches behind one entry,
// so that the QKV weights stream once for all B slots on the tensor cores;
// the second and third are programmatic dependents of the one before
// (they start while it runs and wait, griddepcontrol.wait, only where they
// read its output):
// 1. decode_front_norm_kernel: norm1 of each slot's row into hn [B, D]
//    bf16 (in bf16 hn is exactly a bf16 tensor in every weight form: the
//    dtype's affine, and the int8 forms round it to bf16 as well). Each
//    stream CTA normalising the rows itself would re-read B x D of x per
//    CTA for the whole row's statistics; one tiny launch reads them once,
//    and the stream's weight copies run beside it.
// 2. decode_front_stream_kernel<W, NG, S>: hn @ [wq | wk | wv] on the weight
//    stream of csrc/weight_stream.cuh (W^T as the mma A operand, int8
//    widened in registers, hn's B rows as B, a cp.async ring of 64-row K
//    chunks, the first stages' weight copies issued before hn is ready).
//    The grid spans the column tiles of the three parts in one launch (a
//    tile never straddles two parts); each CTA takes its part's pointer and
//    row stride, so every weight form streams in place: the stack's parts D
//    x D apart, the packed int8 parts D columns apart on one padded row,
//    the triples' three tensors with their own strides and padding. K
//    splits into ordered slices (blockIdx.y; whole multiples of the int8
//    forms' K block BK) that write f32 partials [slice, B, N]. Each weight
//    byte is read once a launch whatever B is.
// 3. decode_front_tail_kernel: a cluster of four CTAs per (kv head, slot)
//    adds its NP = G + 2 column blocks' slice partials in slice order,
//    scales (int8), rounds to the dtype and adds the bias in the dtype,
//    then RoPE, q / k / v out, int8 k / v and the PQ encode (front_codes,
//    a rank its rows), the tile counts (front_count, a rank its tiles) and
//    the selection (front_select, the leader).
// The tiles, ring and slices come from ops/decode_front.py front_plan.
//
// f32 (the parity dtype) and shapes off that rule keep the fused kernel,
// decode_front_kernel: one CTA per (kv head, slot) normalises its slot's
// row and computes only its kv head's NP projection columns of d_head
// each (the G query heads j*G .. j*G+G-1 of kv head j, then k, then v; the
// slots of a head re-read the same weight slice, from L2 where it fits).
// The GEMV walks one row pointer per part, G + 2 parts three at a time,
// with explicit read-only loads. The packed int8 form (MHA: its q, k and v
// D columns apart on one row) is a template instance of its own: G = 1 at
// compile time and one row pointer with the parts at fixed offsets from
// it. Both keep three loads in flight per row, unrolled 8 deep (the loop
// is bound by load latency, not bytes). It then runs front_codes,
// front_count and front_select over all its rows and tiles.
//
// front_codes rotates q and k (RoPE, in f32 on the dtype-rounded
// projections, rounded back to the dtype), quantises k and v and
// PQ-encodes the G query rows and k; front_count scans the (slot, kv
// head) code slab, a warp a (tile, subspace) row of codes, counting
// matches of every group member's codes: the pooled score is count / (PS
// x G), exact in f32 as in the TPU kernel. front_select is one warp's
// argmax a pick that reproduces lax.top_k order: highest mean match
// first, lowest tile index on ties, then the current tile appended last.
//
// The int8 forms have int8_matmul's numerics: hn rounded to bf16, each K
// block of BK rows (256, or 128 when D is not a multiple of 256) summed in
// f32 into its own partial (the fused kernel: by the ksplit thread groups;
// the stream: K slices of whole blocks), the partials added in ascending
// order, then the column's scale, a round to the serving dtype and the
// bias in that dtype. The fp forms differ from the twin's hn @ w only in
// the order of the f32 sums.
#include <climits>
#include <type_traits>

#include <cooperative_groups.h>

#include "common.cuh"
#include "weight_stream.cuh"

namespace spt {

constexpr int kFrontThreads = 256;

// norm1 of one row: f32 statistics, the affine in the serving dtype;
// store(i, v) takes hn[i] (a value of T's precision). Every thread of the
// block calls; red is >= 32 floats of shared scratch.
template <typename T, typename Store>
__device__ __forceinline__ void front_norm(const T* xr, const T* nsc,
                                           const T* nbi, int D, float eps,
                                           int rms, float* red,
                                           Store store) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  float s = 0.f;
  if (rms) {
    for (int i = tid; i < D; i += nthr) {
      const float v = to_f(xr[i]);
      s += v * v;
    }
    const float ms = block_sum(s, red) / (float)D;
    const float r = 1.0f / sqrtf(ms + eps);
    for (int i = tid; i < D; i += nthr)
      store(i, rt<T>(to_f(nsc[i]) * rt<T>(to_f(xr[i]) * r)));
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
      store(i, rt<T>(rt<T>(y * to_f(nsc[i])) + to_f(nbi[i])));
    }
  }
}

// column of part t's output c within its part's weight, scale and bias
__device__ __forceinline__ size_t front_col(int t, int c, int h, int G,
                                            int DH) {
  return t < G ? (size_t)(h * G + t) * DH + c : (size_t)h * DH + c;
}

// The front after the projection, for kv head h and slot b, on the rows
// v0, v0 + vs, ... < NP of qkv [NP][DH] (the G query rows, k, v as the
// dtype's values: the dot rounded, the bias added); cbs [DH][NC] holds the
// diagonal blocks of build_pq_bd's block-diagonal codebook (row d is zero
// outside the columns of its subspace d / DC). A __syncthreads has made
// both visible. RoPE, the rows out (q / k / v, int8 k / v), and the PQ
// codes of the rows below NE into codes [NE][NS] (visible on return; c_new
// with the k row). cbn: the codewords' squared norms [NS * NC]; cr / sr:
// slot b's RoPE rows [DH] (null: no RoPE). Shared memory: scratch >= NE *
// DH floats, dots NE * F.
template <typename T>
__device__ __forceinline__ void front_codes(
    float* qkv, float* scratch, const float* cbs, float* dots, int* codes,
    int v0, int vs_, int h, int b, int G, const float* cbn, const float* cr,
    const float* sr, T* __restrict__ q_out, T* __restrict__ k_out,
    T* __restrict__ v_out, int* __restrict__ c_new, int8_t* __restrict__ k8,
    int8_t* __restrict__ v8, float* __restrict__ ks, float* __restrict__ vs,
    int H, int KV, int DH, int NS, int NC, int W, int quantized) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int NP = G + 2, NE = G + 1, F = NS * NC, DC = DH / NS;
  const int dsh = __ffs(DH) - 1;   // DH divides 256: a power of 2
  // this call's rows: all of them (nr), those with codes (ne)
  const int nr = v0 < NP ? (NP - v0 + vs_ - 1) / vs_ : 0;
  const int ne = v0 < NE ? (NE - v0 + vs_ - 1) / vs_ : 0;
  auto row = [&](int k) { return v0 + k * vs_; };
  auto mine = [&](int v) { return v >= v0 && (v - v0) % vs_ == 0; };

  // ---- RoPE (LLaMA) on the query rows and k: rotate-half in f32 at the
  // slot's position, separate roundings (no fused multiply-add), back to
  // the dtype
  if (cr != nullptr) {
    const int half = DH / 2;
    for (int j = tid; j < ne * DH; j += nthr) {
      const int c = j & (DH - 1);
      const float* z = qkv + row(j >> dsh) * DH;
      const float rv = c < half ? -z[c + half] : z[c - half];
      scratch[j] =
          rt<T>(__fadd_rn(__fmul_rn(cr[c], z[c]), __fmul_rn(sr[c], rv)));
    }
    __syncthreads();
    for (int j = tid; j < ne * DH; j += nthr)
      qkv[row(j >> dsh) * DH + (j & (DH - 1))] = scratch[j];
    __syncthreads();
  }
  for (int j = tid; j < nr * DH; j += nthr) {
    const int t = row(j >> dsh), c = j & (DH - 1);
    const size_t col = front_col(t, c, h, G, DH);
    const T y = from_f<T>(qkv[t * DH + c]);
    if (t < G)
      q_out[(size_t)b * H * DH + col] = y;
    else
      (t == G ? k_out : v_out)[(size_t)b * KV * DH + col] = y;
  }

  // ---- int8 per-token quantisation of k (warp 0) and v (warp 1):
  // max-abs / 127, round half to even, clip +-127
  if (quantized && wid < 2 && mine(G + wid)) {
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

  // ---- PQ encode the query rows and k: score = |c|^2 - 2 z.c, argmin per
  // subspace (the lowest index wins ties). Column cc of bd is zero outside
  // rows [sub * DC, sub * DC + DC) (sub = cc / NC), so its f32 sum over
  // those rows in ascending order is the full column's sum exactly (the
  // others add exact zeros)
  if (NC == 16 && F % 32 == 0) {
    // a lane a codeword, a 16-lane group a (row, subspace): the argmin by
    // shuffles, the lower index on ties
    for (int j = tid; j < ne * F; j += nthr) {   // warp-uniform
      const int vec = row(j / F), sub = j % F >> 4, c = j & 15;
      const int d0 = sub * DC;
      const float* z = qkv + vec * DH + d0;
      const float* w = cbs + d0 * 16 + c;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DC; ++d) dot += z[d] * w[d * 16];
      float val = cbn[sub * 16 + c] - 2.0f * dot;
      int idx = c;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, val, o);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
        if (ov < val || (ov == val && oi < idx)) { val = ov; idx = oi; }
      }
      if (c == 0) codes[vec * NS + sub] = idx;
    }
  } else {
    for (int j = tid; j < ne * F; j += nthr) {
      const int vec = row(j / F), cc = j % F, c = cc % NC;
      const int d0 = cc / NC * DC;
      const float* z = qkv + vec * DH;
      float dot = 0.f;
      for (int d = d0; d < d0 + DC; ++d) dot += z[d] * cbs[d * NC + c];
      dots[j] = cbn[cc] - 2.0f * dot;
    }
    __syncthreads();
    for (int j = tid; j < ne * NS; j += nthr) {
      const int k = j / NS, sub = j % NS;
      const float* sc = dots + k * F + sub * NC;
      int best = 0;
      float bv_ = sc[0];
      for (int c = 1; c < NC; ++c)   // strict <: lowest index wins ties
        if (sc[c] < bv_) { bv_ = sc[c]; best = c; }
      codes[row(k) * NS + sub] = best;
    }
  }
  __syncthreads();
  if (mine(G))
    for (int i = tid; i < W; i += nthr)
      c_new[((size_t)b * KV + h) * W + i] = i < NS ? codes[G * NS + i] : -2;
}

// The group-pooled match counts of tiles [t0, t1): cnt[t] = how many of
// the tile's NS x PS codes equal the G query rows' codes of their subspace
// (codes [G][NS]; slab row (t, sub) at slab + ((t - ts) * slab_w + sub) *
// PS, global memory or shared); integer counts, each warp's kept apart in
// wcnt [warps][NT] (shared scratch) and added in warp order. Every thread
// calls; the caller synchronises after.
__device__ __forceinline__ void front_count(const int* slab, int slab_w,
                                            int ts, const int* codes,
                                            int* cnt, int* wcnt, int t0,
                                            int t1, int G, int NS, int NT,
                                            int PS) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nwarps = nthr >> 5;
  for (int i = tid; i < nwarps * NT; i += nthr) wcnt[i] = 0;
  __syncthreads();
  if (PS % 128 == 0 && ((uintptr_t)slab & 15) == 0) {
    // a warp takes the (tile, subspace) rows wid, wid + nwarps, ..., a
    // lane 16-byte chunks of 4 codes; a tile's counts are summed in the
    // warp (redux) before one shared atomic
    int t = t0 + wid / NS, sub = wid % NS, tc = t, n = 0;
    for (int r = wid; r < (t1 - t0) * NS; r += nwarps) {
      if (t != tc) {
        n = __reduce_add_sync(0xffffffffu, n);
        if (lane == 0) wcnt[wid * NT + tc] = n;
        n = 0;
        tc = t;
      }
      const int* row = slab + ((size_t)(t - ts) * slab_w + sub) * PS;
      for (int p = 4 * lane; p < PS; p += 128) {
        const int4 cv = *reinterpret_cast<const int4*>(row + p);
        for (int g = 0; g < G; ++g) {
          const int qc = codes[g * NS + sub];
          n += (cv.x == qc) + (cv.y == qc) + (cv.z == qc) + (cv.w == qc);
        }
      }
      for (sub += nwarps; sub >= NS; sub -= NS) ++t;   // the next row
    }
    n = __reduce_add_sync(0xffffffffu, n);
    if (lane == 0 && tc < t1) wcnt[wid * NT + tc] = n;
  } else {
    // one (tile, subspace) row of PS codes a warp step
    for (int i = wid; i < (t1 - t0) * NS; i += nwarps) {
      const int t = t0 + i / NS, sub = i % NS;
      const int* row = slab + ((size_t)(t - ts) * slab_w + sub) * PS;
      int n = 0;
      for (int p = lane; p < PS; p += 32) {
        const int cv = row[p];
        for (int g = 0; g < G; ++g) n += cv == codes[g * NS + sub];
      }
      n = __reduce_add_sync(0xffffffffu, n);
      if (lane == 0) wcnt[wid * NT + t] += n;
    }
  }
  __syncthreads();
  for (int t = t0 + tid; t < t1; t += nthr) {   // the warps in order
    int n = 0;
    for (int w = 0; w < nwarps; ++w) n += wcnt[w * NT + t];
    cnt[t] = n;
  }
}

// The selection from the counts cnt [NT] (visible): the pooled score of a
// FULL tile t < nfull is cnt / (PS x G) (exact in f32, as in the TPU
// kernel), others kNeg; the top NSEL-1 tiles in lax.top_k order (highest
// first, the lower tile on ties; -1 past the full ones), then the current
// tile cur. tsc: NT floats of shared scratch.
__device__ __forceinline__ void front_select(const int* cnt, float* tsc, int* tables, int h,
                            int b, int KV, int NT, int NSEL, int nfull,
                            int cur, int base, float inv_pg) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  for (int t = tid; t < NT; t += blockDim.x)
    tsc[t] = t < nfull ? (float)cnt[t] * inv_pg : kNeg;
  __syncthreads();
  // one warp, an argmax a pick (the larger score, the lower tile on ties)
  if (wid == 0) {
    int* tab = tables + ((size_t)b * KV + h) * NSEL;
    for (int c = 0; c < NSEL - 1; ++c) {
      float val = -INFINITY;
      int idx = INT_MAX;
      for (int t = lane; t < NT; t += 32)
        if (better(tsc[t], t, val, idx)) { val = tsc[t]; idx = t; }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, val, o);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
        if (better(ov, oi, val, idx)) { val = ov; idx = oi; }
      }
      if (lane == 0) {
        tab[c] = val > 0.5f * kNeg ? idx + base : -1;
        tsc[idx] = kNeg;
      }
      __syncwarp();
    }
    if (lane == 0) tab[NSEL - 1] = cur + base;
  }
}

// ---------------------------------------------------------------------------
// f32 and off-rule shapes: the fused kernel, one CTA per (kv head, slot)
// ---------------------------------------------------------------------------

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
  int* cnt = codes + NE * NS;              // [NT] tile match counts
  float* cbs = reinterpret_cast<float*>(cnt + NT);  // [DH][NC] codebook
  int* wcnt = reinterpret_cast<int*>(cbs + DH * NC);  // [warps][NT]

  // the codebook's diagonal blocks (front_codes); visible after the norm
  for (int i = tid; i < DH * NC; i += nthr) {
    const int d = i / NC;
    cbs[i] = bd[(size_t)d * F + d / (DH / NS) * NC + i % NC];
  }

  // ---- norm1
  front_norm<T>(x + (size_t)b * D, nsc, nbi, D, eps, rms, red,
                [&](int i, float v) {
                  hn[i] = INT8 ? rt<__nv_bfloat16>(v) : v;   // bf16 operand
                });
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
      return (t < G ? wq : (t == G ? wk : wv)) + front_col(t, c, h, G, DH);
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
    const size_t col = front_col(t, c, h, G, DH);
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
  // the partial buffer is free now: RoPE's scratch
  front_codes<T>(qkv, part, cbs, dots, codes, 0, 1, h, b, G, cbn,
                 cos_t ? cos_t + (size_t)b * DH : nullptr,
                 sin_t ? sin_t + (size_t)b * DH : nullptr, q_out, k_out,
                 v_out, c_new, k8, v8, ks, vs, H, KV, DH, NS, NC, W,
                 quantized);
  const int cur = pos[b] / PS, nfull = min(cur, NT);
  front_count(c_cache + (((size_t)b * KV + h) * NTALL + base) * W * PS, W,
              0, codes, cnt, wcnt, 0, nfull, G, NS, NT, PS);
  __syncthreads();
  front_select(cnt, tsc, tables, h, b, KV, NT, NSEL, nfull, cur, base,
               inv_pg);
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

size_t front_buffer_floats(int G, int DH, int NS, int NC, int NT) {
  // scratch (RoPE) and cbs are the caller's; dots, tsc, codes, cnt and
  // wcnt (ints)
  return (size_t)(G + 1) * NS * NC + NT + (size_t)(G + 1) * NS + NT +
         (size_t)(kFrontThreads / 32) * NT;
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
  const int G = H / KV, NP = G + 2;
  const int nblk = int8w ? D / BK : 1;
  const size_t smem =
      sizeof(float) * (D + (size_t)NP * nblk * ksplit * DH + NP * DH + 32 +
                       front_buffer_floats(G, DH, NS, NC, NT) +
                       (size_t)DH * NC);
  const long poff =
      int8w ? packed_part_offset(wq, wk, wv, ldq, ldk, ldv, G) : 0;
  auto kernel = !int8w ? decode_front_kernel<T, false, false>
                       : (poff ? decode_front_kernel<T, true, true>
                               : decode_front_kernel<T, true, false>);
  if (smem > 48 * 1024) {
    cudaError_t e = raise_smem((const void*)kernel, (int)smem);
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

// ---------------------------------------------------------------------------
// bf16: norm, one weight stream over q | k | v, then the per-head tail
// ---------------------------------------------------------------------------

// norm1 of slot blockIdx.x into hn [B, D] bf16: the row, the norm scale
// and bias staged in shared memory by one batch of 16-byte copies, the
// result staged there too (global stores among the loop's loads would keep
// them from running ahead)
template <typename T>
__global__ void __launch_bounds__(kFrontThreads) decode_front_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ nsc,
    const T* __restrict__ nbi, __nv_bfloat16* __restrict__ hn, int D,
    float eps, int rms) {
  grid_dep_launch();   // the stream may start streaming its weights
  extern __shared__ __align__(16) float hs[];   // [D], [32], then T [3][D]
  T* xs = reinterpret_cast<T*>(hs + D + 32);
  T* ss = xs + D;
  T* bs = ss + D;
  constexpr int kE = 16 / (int)sizeof(T);
  const T* xr = x + (size_t)blockIdx.x * D;
  for (int i = threadIdx.x * kE; i < D; i += blockDim.x * kE) {
    cp_async16(xs + i, xr + i);
    cp_async16(ss + i, nsc + i);
    if (nbi != nullptr) cp_async16(bs + i, nbi + i);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  front_norm<T>(xs, ss, nbi ? bs : nullptr, D, eps, rms, hs + D,
                [&](int i, float v) { hs[i] = v; });
  __syncthreads();
  __nv_bfloat16* row = hn + (size_t)blockIdx.x * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    row[i] = __float2bfloat16(hs[i]);
}

// the three parts of the projection as the stream sees them: part t's
// weight from its first column, its row stride, its first column tile in
// the grid (tile0[3]: all tiles) and its first column in the partials
struct FrontParts {
  const void* w[3];
  int ld[3];
  int tile0[4];
  int col0[3];
};

// hn [B, D] @ the CTA's C = 16 cw columns of one part over K slice
// blockIdx.y: the f32 sums into part [slice][B][NTOT]
template <typename W, int NG, int S>
__global__ void __launch_bounds__(kWsThreads) decode_front_stream_kernel(
    FrontParts fp, const __nv_bfloat16* __restrict__ hn,
    float* __restrict__ part, int B, int D, int NTOT, int cw, int kslice) {
  grid_dep_launch();   // the tail may start staging its inputs
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x;
  const int t = tile < fp.tile0[1] ? 0 : (tile < fp.tile0[2] ? 1 : 2);
  const int C = 16 * cw, c0 = (tile - fp.tile0[t]) * C;
  WsArgs<W, 1, 1> a;
  a.w[0] = static_cast<const W*>(fp.w[t]);
  a.x[0] = hn;
  a.ldw = fp.ld[t], a.ldx = D, a.m = B, a.K = D, a.cw = cw;
  a.kslice = kslice;
  float acc[1][NG][4] = {};
  ws_mainloop<W, 1, 1, NG, S, true>(a, smem, acc, c0);   // hn: the norm's
  const int wid = threadIdx.x >> 5, ctile = wid % cw;
  const int rs = wid / cw, nrs = 8 / cw, ngt = (B + 7) / 8;
  float* p = part + (size_t)blockIdx.y * B * NTOT + fp.col0[t] + c0;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int ng = rs + i * nrs;
    if (ng >= ngt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = ws_row(ng, e);
      if (row < B) p[(size_t)row * NTOT + ws_col<W>(ctile, e)] = acc[0][i][e];
    }
  }
}

// A cluster of kTailRanks CTAs per (kv head, slot) (grid (kTailRanks, KV,
// B)): the NP column blocks from the slices' partials (added in slice
// order), scaled (int8), rounded to the dtype, the bias added in the
// dtype; RoPE, the outputs and the codes; the tile counts; the selection.
// Rank r reduces its share of the columns into the rows' owners (row t:
// rank t % kTailRanks) through distributed shared memory, runs RoPE, the
// outputs, the int8 quantisation and the PQ encode of the rows it owns,
// hands the query rows' codes to every rank, counts the matches of its
// share of the full tiles and hands the counts to the leader (rank 0),
// which selects. Each rank first stages what it reads in shared memory by
// one batch of 16-byte copies: the codebook's diagonal blocks and norms,
// the RoPE rows, its tiles' code slab (when stage_slab) and, after
// griddepcontrol.wait, its partials. The kernel is launched as a
// programmatic dependent of the stream, so all but the partials are in
// flight while the stream ends; the work and the slab's bytes spread over
// kTailRanks SMs a (kv head, slot).
constexpr int kTailRanks = 4;

template <typename T, bool INT8>
__global__ void __cluster_dims__(kTailRanks, 1, 1)
    __launch_bounds__(kFrontThreads) decode_front_tail_kernel(
        const float* __restrict__ part, int ns, int NTOT,
        const float* __restrict__ sq, const float* __restrict__ sk,
        const float* __restrict__ sv, const T* __restrict__ bq,
        const T* __restrict__ bk, const T* __restrict__ bv,
        const float* __restrict__ bd, const float* __restrict__ cbn,
        const float* __restrict__ cos_t, const float* __restrict__ sin_t,
        const int* __restrict__ c_cache, const int* __restrict__ pos,
        int base, T* __restrict__ q_out, T* __restrict__ k_out,
        T* __restrict__ v_out, int* __restrict__ c_new,
        int* __restrict__ tables, int8_t* __restrict__ k8,
        int8_t* __restrict__ v8, float* __restrict__ ks,
        float* __restrict__ vs, int B, int H, int KV, int DH, int NS, int NC,
        int W, int NTALL, int NT, int NSEL, int PS, float inv_pg,
        int quantized, int stage_slab) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int G = H / KV, NP = G + 2, NE = G + 1, F = NS * NC, DC = DH / NS;
  const int NQ = H * DH, NK = KV * DH;
  // this rank's columns [c0, c1) of the NP * DH, and full tiles [t0, t1)
  const int cper = (NP * DH / 4 + kTailRanks - 1) / kTailRanks * 4;
  const int c0 = min(NP * DH, rank * cper), c1 = min(NP * DH, c0 + cper);
  const int tpr = (NT + kTailRanks - 1) / kTailRanks;
  const int cur = pos[b] / PS, nfull = min(cur, NT);
  const int per = (nfull + kTailRanks - 1) / kTailRanks;
  const int t0 = min(nfull, rank * per), t1 = min(nfull, t0 + per);

  extern __shared__ __align__(16) float sm[];
  float* pp = sm;                          // [ns][cper] partials
  float* cbs = pp + (size_t)ns * cper;     // [DH][NC]
  float* cbns = cbs + DH * NC;             // [F]
  float* crs = cbns + F;                   // [DH] cos row
  float* srs = crs + DH;                   // [DH] sin row
  int* slab_s = reinterpret_cast<int*>(srs + DH);   // [tpr][NS][PS]
  float* qkv = srs + DH + (stage_slab ? (size_t)tpr * NS * PS : 0);
  float* scratch = qkv + NP * DH;          // [NE][DH]
  float* dots = scratch + NE * DH;         // [NE][F]
  float* tsc = dots + NE * F;              // [NT]
  int* codes = reinterpret_cast<int*>(tsc + NT);   // [NE][NS]
  int* cnt = codes + NE * NS;              // [NT]
  int* wcnt = cnt + NT;                    // [warps][NT]

  const size_t bh = (size_t)b * KV + h;
  for (int i = tid; i < DH * NC / 4; i += nthr) {
    const int d = i / (NC / 4), c = i % (NC / 4) * 4;
    cp_async16(cbs + d * NC + c, bd + (size_t)d * F + d / DC * NC + c);
  }
  for (int i = tid; i < F / 4; i += nthr)
    cp_async16(cbns + 4 * i, cbn + 4 * i);
  if (cos_t != nullptr)
    for (int i = tid; i < DH / 4; i += nthr) {
      cp_async16(crs + 4 * i, cos_t + (size_t)b * DH + 4 * i);
      cp_async16(srs + 4 * i, sin_t + (size_t)b * DH + 4 * i);
    }
  const int* gslab = c_cache + (bh * NTALL + base) * W * PS;
  if (stage_slab)
    for (int i = tid; i < (t1 - t0) * NS * (PS / 4); i += nthr) {
      const int r = i / (PS / 4), p4 = i % (PS / 4) * 4;   // r = t NS + sub
      cp_async16(slab_s + (size_t)r * PS + p4,
                 gslab + ((size_t)(t0 + r / NS) * W + r % NS) * PS + p4);
    }
  // the partials once the stream has written them (the inputs above were
  // written before the front began)
  grid_dep_wait();
  const int nc4 = (c1 - c0) / 4;
  for (int i = tid; i < ns * nc4; i += nthr) {
    const int s = i / nc4, c = c0 + i % nc4 * 4;
    const int col = c < G * DH ? h * G * DH + c
                               : (c < (G + 1) * DH ? NQ + h * DH + c - G * DH
                                                   : NQ + NK + h * DH + c -
                                                         (G + 1) * DH);
    cp_async16(pp + (size_t)s * cper + c - c0,
               part + ((size_t)s * B + b) * NTOT + col);
  }
  cp_async_commit();
  // every rank of the cluster running before the first remote access
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cp_async_wait<0>();
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // ---- this rank's columns into the qkv rows of the ranks that own them
  // (row t: rank t % kTailRanks)
  for (int j = c0 + tid; j < c1; j += nthr) {
    const int t = j / DH, c = j % DH;
    const size_t col = front_col(t, c, h, G, DH);
    float a = 0.f;
    for (int s = 0; s < ns; ++s) a += pp[(size_t)s * cper + j - c0];
    if (INT8) a *= (t < G ? sq : (t == G ? sk : sv))[col];
    float y = rt<T>(a);
    const T* bias = t < G ? bq : (t == G ? bk : bv);
    if (bias != nullptr) y = rt<T>(y + to_f(bias[col]));
    cluster.map_shared_rank(qkv, t % kTailRanks)[j] = y;
  }
  cluster.sync();   // every row in its rank
  front_codes<T>(qkv, scratch, cbs, dots, codes, rank, kTailRanks, h, b, G,
                 cbns, cos_t ? crs : nullptr, srs, q_out, k_out, v_out, c_new,
                 k8, v8, ks, vs, H, KV, DH, NS, NC, W, quantized);
  // this rank's query rows' codes to every other rank
  for (int i = tid; i < G * NS; i += nthr) {
    const int v = i / NS;
    if (v % kTailRanks != rank) continue;
    for (int r = 0; r < kTailRanks; ++r)
      if (r != rank) cluster.map_shared_rank(codes, r)[i] = codes[i];
  }
  cluster.sync();   // every query row's codes in every rank

  // ---- this rank's tiles
  front_count(stage_slab ? slab_s : gslab, stage_slab ? NS : W,
              stage_slab ? t0 : 0, codes, cnt, wcnt, t0, t1, G, NS, NT, PS);
  __syncthreads();
  if (rank != 0) {
    int* cnt0 = cluster.map_shared_rank(cnt, 0);
    for (int t = t0 + tid; t < t1; t += nthr) cnt0[t] = cnt[t];
  }
  cluster.sync();   // every count in the leader
  if (rank == 0)
    front_select(cnt, tsc, tables, h, b, KV, NT, NSEL, nfull, cur, base,
                 inv_pg);
}

// stream kernel pointers by (NG, stages): the instances
// ops/weight_stream.py ring can name
template <typename W>
static auto front_stream_kernel(int ng, int s)
    -> decltype(&decode_front_stream_kernel<W, 1, 4>) {
  if (s == 3) return ng == 1 ? &decode_front_stream_kernel<W, 1, 3> : nullptr;
  if (s == 2) return ng == 4 ? &decode_front_stream_kernel<W, 4, 2> : nullptr;
  if (s != 4) return nullptr;
  return ng == 1 ? &decode_front_stream_kernel<W, 1, 4>
         : ng == 2 ? &decode_front_stream_kernel<W, 2, 4>
         : ng == 4 ? &decode_front_stream_kernel<W, 4, 4> : nullptr;
}

template <typename W>
int launch_front_tc(const void* x, const void* nsc, const void* nbi,
                    const void* wq, const void* wk, const void* wv, int ldq,
                    int ldk, int ldv, const float* sq, const float* sk,
                    const float* sv, const void* bq, const void* bk,
                    const void* bv, const float* bd, const float* cbn,
                    const float* cos_t, const float* sin_t,
                    const int* c_cache, const int* pos, int base, void* q,
                    void* k, void* v, int* c_new, int* tables, int8_t* k8,
                    int8_t* v8, float* ks, float* vs, int B, int D, int H,
                    int KV, int DH, int NS, int NC, int W_, int NTALL, int NT,
                    int NSEL, int PS, int BK, float inv_pg, float eps,
                    int rms, int quantized, int cw, int ng, int stages,
                    int kslice, __nv_bfloat16* hn, float* part,
                    cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr bool kInt8 = std::is_same<W, int8_t>::value;
  constexpr int kW = 16 / (int)sizeof(W);     // W elements a 16-byte copy
  auto kernel = front_stream_kernel<W>(ng, stages);
  const int C = 16 * cw, NQ = H * DH, NK = KV * DH;
  const int ns = kslice > 0 ? (D + kslice - 1) / kslice : 0;
  const int lds[3] = {ldq, ldk, ldv};
  const void* ws[3] = {wq, wk, wv};
  bool ok = kernel != nullptr && (cw == 1 || cw == 2 || cw == 4 ||
                                  cw == 8) &&
            ((B + 7) / 8 + 8 / cw - 1) / (8 / cw) <= ng && ns > 0 &&
            kslice % kWsK == 0 && (!kInt8 || kslice % BK == 0) &&
            NQ % C == 0 && NK % C == 0 && D % 8 == 0 &&
            hn != nullptr && part != nullptr;
  for (int t = 0; t < 3; ++t)
    ok = ok && lds[t] % kW == 0 && (uintptr_t)ws[t] % 16 == 0;
  const int smem = stages * ws_stage_bytes<W, 1, 1>(cw, B);
  if (!ok || smem > 232448) return (int)cudaErrorInvalidValue;

  const int nsmem = (D + 32) * (int)sizeof(float) + 3 * D * (int)sizeof(bf);
  cudaError_t e =
      raise_smem((const void*)decode_front_norm_kernel<bf>, nsmem);
  if (e != cudaSuccess) return (int)e;
  decode_front_norm_kernel<bf><<<B, kFrontThreads, nsmem, stream>>>(
      (const bf*)x, (const bf*)nsc, (const bf*)nbi, hn, D, eps, rms);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  FrontParts fp;
  fp.tile0[0] = 0;
  for (int t = 0; t < 3; ++t) {
    fp.w[t] = ws[t];
    fp.ld[t] = lds[t];
    fp.tile0[t + 1] = fp.tile0[t] + (t == 0 ? NQ : NK) / C;
    fp.col0[t] = t == 0 ? 0 : NQ + (t - 1) * NK;
  }
  const int NTOT = NQ + 2 * NK;
  e = raise_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  e = launch_dependent(kernel, dim3(fp.tile0[3], ns), dim3(kWsThreads), smem,
                       stream, fp, (const bf*)hn, part, B, D, NTOT, cw,
                       kslice);
  if (e != cudaSuccess) return (int)e;

  const int G = H / KV, NP = G + 2, NE = G + 1;
  if (NC % 4 != 0 || (uintptr_t)bd % 16 != 0 || (uintptr_t)cbn % 16 != 0 ||
      (uintptr_t)c_cache % 16 != 0 || PS % 4 != 0 ||
      (cos_t != nullptr &&
       ((uintptr_t)cos_t % 16 != 0 || (uintptr_t)sin_t % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  // the staged inputs, then front_codes', front_count's and front_select's
  // buffers; the code slab of a rank's tiles too when it fits
  const int cper = (NP * DH / 4 + kTailRanks - 1) / kTailRanks * 4;
  const int tpr = (NT + kTailRanks - 1) / kTailRanks;
  size_t tsmem = sizeof(float) * ((size_t)ns * cper + (size_t)DH * NC +
                                  NS * NC + 2 * DH + (size_t)(NP + NE) * DH +
                                  front_buffer_floats(G, DH, NS, NC, NT));
  const size_t slab = sizeof(int) * (size_t)tpr * NS * PS;
  const int stage_slab = tsmem + slab <= 200 * 1024;
  if (stage_slab) tsmem += slab;
  auto tail = decode_front_tail_kernel<bf, kInt8>;
  if (tsmem > 48 * 1024) {
    e = raise_smem((const void*)tail, (int)tsmem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_dependent(
      tail, dim3(kTailRanks, KV, B), dim3(kFrontThreads), tsmem, stream,
      (const float*)part, ns, NTOT, sq, sk, sv, (const bf*)bq, (const bf*)bk,
      (const bf*)bv, bd, cbn, cos_t, sin_t, c_cache, pos, base, (bf*)q,
      (bf*)k, (bf*)v, c_new, tables, k8, v8, ks, vs, B, H, KV, DH, NS, NC,
      W_, NTALL, NT, NSEL, PS, inv_pg, quantized, stage_slab);
}

}  // namespace spt

// One entry for every weight form: per part (q, k, v) a pointer to its
// first column for kv head 0, its row stride and, for int8 weights
// (int8w = 1), its per-column scales; the biases, the norm bias and the
// RoPE tables are null when absent. rms = 1 takes RMSNorm (LLaMA).
// route 0: the fused kernel (f32, and shapes off ops/decode_front.py
// front_plan); route 1 (bf16 only): the norm, stream and tail launches,
// with the plan's cw, ng, stages and K slice, hn [B, D] bf16 and part
// [slices, B, N_q + 2 N_kv] f32 as scratch.
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
    int quantized, int route, int cw, int ng, int stages, int kslice,
    void* hn, void* part, void* stream) {
  if (route == 1) {
    if (dtype != spt::kBF16) return (int)cudaErrorInvalidValue;
    auto f = int8w ? spt::launch_front_tc<int8_t>
                   : spt::launch_front_tc<__nv_bfloat16>;
    return f(x, nsc, nbi, wq, wk, wv, ldq, ldk, ldv, (const float*)sq,
             (const float*)sk, (const float*)sv, bq, bk, bv,
             (const float*)bd, (const float*)cbn, (const float*)cos_t,
             (const float*)sin_t, (const int*)c_cache, (const int*)pos, base,
             q, k, v, (int*)c_new, (int*)tables, (int8_t*)k8, (int8_t*)v8,
             (float*)ks, (float*)vs, B, D, H, KV, DH, NS, NC, W, NTALL, NT,
             NSEL, PS, BK, inv_pg, eps, rms, quantized, cw, ng, stages,
             kslice, (__nv_bfloat16*)hn, (float*)part,
             (cudaStream_t)stream);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
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

