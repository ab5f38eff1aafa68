// Decode attention over page tables, two kernels:
//
//   paged_attention_kernel      Replaces the stock Pallas paged_attention
//     that spt_proto_tpu/inference/paged.py:198 paged_attention_op calls
//     on the TPU (jax.experimental.pallas.ops.tpu.paged_attention, imported
//     at paged.py:209), over bf16/f32 pages or int8 pages with per-token
//     f32 scales (its QuantizedTensor form). Its contract is the non-TPU
//     branch of paged_attention_op: paged_attention_ref (paged.py:170) with
//     the int8 pages read back through _dequantize_pages (paged.py:162).
//   tile_pool_attention_kernel  Replaces
//     spt_proto_tpu/ops/pallas/decode_attention.py:156 decode_attention
//     (_kernel, :46): attention over a flat pool of token-minor tiles
//     addressed through a per-row table, appending the new token's k/v/codes
//     first. Its contract is decode_attention_ref (:234).
//
// Bound on the H100: memory. One paged decode step of OPT-125M (B=8, 12
// heads, context 2048, d_head 64) reads 8 x 12 x 2048 x 64 x 2 x 2 B =
// 50.3 MB of K and V in bf16, 15 us at 3.35 TB/s; the math is 2 x 2 x 64
// multiply-adds a token and query head, far below the tensor-core line.
//
// Design: one CTA per (slot, kv head) (tile pool: per table row) serves its
// G query heads from each page staged once; K/V are never repeated per
// group as the oracle repeats them. In bf16 (the serving dtype)
// paged_attention_split_kernel takes the paged kernel's place: each slot's
// pages split over a cluster of CTAs, both products on the tensor cores
// (its notes are at its definition). In f32 both kernels run the two-pass
// walk of
// softmax_walk.cuh with the oracle's numerics (normalise, then round to the
// V dtype): shared memory holds one page, so it does not grow with the
// context. int8 pages are dequantized while they are staged, as the oracle
// reads them: ((float)x * h) / 127.5 rounded to q's dtype. The stock
// kernel's pages_per_compute_block and its 128-lane head padding are TPU
// mechanics and are not carried over. Pages past a slot's length are not
// read.
#include <cooperative_groups.h>
#include <type_traits>

#include "softmax_walk.cuh"

namespace spt {

// ---------------------------------------------------------------------------
// paged attention (the stock kernel's contract)
// ---------------------------------------------------------------------------

// q [B, H, D] (head h = kv head h / G, query g = h % G); pages [KV, P, PS, D]
// of KT (T, or int8 with scales [KV, P, PS] f32); lengths [B]; pages ids
// [B, PPS] physical, -1 read as page 0 (the oracle's max(id, 0)); o
// [B, H, D]. Positions >= lengths[b] are masked. Instantiated for f32 (bf16
// runs paged_attention_split_kernel).
template <typename T, typename KT>
__global__ void __launch_bounds__(kWalkThreads) paged_attention_kernel(
    const T* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ lengths,
    const int* __restrict__ page_ids, T* __restrict__ o, int H, int KV,
    int D, int P, int PS, int PPS, float scale) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  extern __shared__ __align__(16) float sm[];
  const WalkSmem w = walk_smem(sm, G, D, PS, PS * (D + 1), false);
  const size_t qo = ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) w.qs[i] = to_f(q[qo + i]);
  walk_init(w, G, D);
  __syncthreads();
  const int len = lengths[b];
  const int n_pg = len > 0 ? min(PPS, (len + PS - 1) / PS) : 0;
  const int* row = page_ids + (size_t)b * PPS;
  auto page = [&](int j) {            // token offset of page j's first row
    return ((size_t)kh * P + max(row[j], 0)) * PS;
  };
  auto nvalid = [&](int j) { return min(PS, len - j * PS); };
  auto stage_k = [&](int j) {
    const size_t off = page(j);
    stage_f32<KT, T>(w.tile, kp + off * D, PS, D,
                     ksc != nullptr ? ksc + off : nullptr);
  };
  auto stage_v = [&](int j) {
    const size_t off = page(j);
    stage_f32<KT, T>(w.tile, vp + off * D, PS, D,
                     vsc != nullptr ? vsc + off : nullptr);
  };
  softmax_walk<T, false>(w, n_pg, G, D, PS, D + 1, 1, scale, 0.f, nvalid,
                         stage_k, stage_v);
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    o[qo + i] = from_f<T>(w.acc[i]);
}

template <typename T, typename KT>
int launch_paged(const void* q, const void* kp, const void* vp,
                 const void* ksc, const void* vsc, const void* lengths,
                 const void* page_ids, void* o, int B, int H, int KV, int D,
                 int P, int PS, int PPS, float scale, cudaStream_t stream) {
  const size_t smem = walk_smem_bytes(H / KV, D, PS, PS * (D + 1), false);
  auto kern = paged_attention_kernel<T, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(KV, B);
  kern<<<grid, kWalkThreads, smem, stream>>>(
      (const T*)q, (const KT*)kp, (const KT*)vp, (const float*)ksc,
      (const float*)vsc, (const int*)lengths, (const int*)page_ids, (T*)o, H,
      KV, D, P, PS, PPS, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 paged attention: the split walk on the tensor cores
// ---------------------------------------------------------------------------
//
// paged_attention_split_kernel<D, Q> computes what paged_attention_kernel
// computes for a bf16 q (the serving dtype) over bf16 pages (Q false) or
// int8 pages with per-token scales (Q true), pages of 16, 64 or 128 tokens,
// d_head D = 64 or 128 and G <= 8 (ops/paged_attention.py paged_route), at
// any slot length.
//
// Bound on the H100: memory, K and V of the slot's valid tokens (2 x 2 x D
// bytes a token and kv head, 2 x (D + 4) for int8 pages) against 2 x 2 x D
// x G operations. The walk ran one CTA per (slot, kv head), 64-96 CTAs on
// 132 SMs, reading every K page twice and dotting on the CUDA cores: 18-29x
// its bound.
//
// Design: the grid is (chunk, kv head, slot), a chunk being C steps of 64
// consecutive token positions of the slot (paged_split_plan: a step is 4
// pages of 16, a page of 64 or half a page of 128 tokens), and a slot's
// chunks (at most kPagedCluster) are one cluster. A CTA's 4 warps take 16
// token rows of every step each. The CTA streams its chunk's K steps, then
// its V steps, through a ring of kPagedRing step slots (cp.async; a row's
// page comes from the chunk's page ids, -1 read as page 0; rows at or past
// the slot's length are zero-filled, not read); int8 steps are converted in
// shared memory to a bf16 step as the oracle reads them, ((float)x * h) /
// 127.5 rounded, with a true division:
// - scores on mma.sync m16n8k16: the step's tokens as the m16 side (pages
//   are token-major, [tokens][D]: K is a row-major A, plain ldmatrix), the
//   G <= 8 query rows as n8 (bf16 q, exact in f32); s = dot * scale, kept in
//   f32 (in shared memory, or in a global buffer when the chunk's scores
//   outgrow it);
// - the oracle normalises, then rounds: p = bf16(exp(s - M) / L) with M the
//   slot's max and L its sum of exp(s - M), so no p is formed before both
//   are known. Each CTA takes its chunk's max m_c and sum l_c =
//   sum exp(s - m_c) per query row; the cluster's CTAs exchange them through
//   distributed shared memory (one cluster barrier, while the V steps land)
//   and every CTA forms M = max_c m_c and L = sum_c l_c exp(m_c - M), added
//   in chunk order;
// - PV on mma.sync: o^T [D][G] += V^T [D][16 tokens] P [16 tokens][G], the V
//   step's rows as A through ldmatrix.trans and P as B, built in registers
//   from the f32 scores;
// - the 4 warps' sums are added in warp order, then the ranks' in chunk
//   order through distributed shared memory; the output is rounded once.
// Against the walk only the order of the f32 sums changes.

// ((float)x * h) / 127.5 in f32, rounded as the true division rounds: q =
// y r with r = RN(1 / 127.5) is within an ulp of the quotient, and one
// correction with the exact remainder fma(-q, 127.5, y) rounds it
// correctly (Markstein's theorem); x, byte i of a word of four int8 XOR
// 0x80808080 (u), comes exact from the float trick of i8_pairs_to_bf16
__device__ __forceinline__ float dequant_page(uint32_t u, int i, float h) {
  const float x =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f;
  const float y = x * h;
  constexpr float r = 1.0f / 127.5f;
  const float q = y * r;
  return fmaf(fmaf(-q, 127.5f, y), r, q);
}

constexpr int kPagedThreads = 128;   // 4 warps, 16 token rows a step each
constexpr int kPagedStep = 64;       // token positions a ring step
constexpr int kPagedRing = 3;        // step slots a CTA
constexpr int kPagedCluster = 8;     // chunks a slot (one cluster)
constexpr int kPagedSmem = 227 * 1024;

// shared-memory layout of a split CTA (bytes): the ring of raw steps (bf16
// rows of 2 D + 16 bytes, ldmatrix rows in distinct banks; int8 rows of D),
// for int8 pages the steps' scales and the converted bf16 step; q [8][D +
// 8] bf16; the combine rows [8][D] f32; max / sum scratch, the chunk's max
// and sum [8] each; the scores [G][64 C + 4] unless they go to the global
// buffer; the chunk's page ids
struct PagedSmem {
  int ring, scl, work, qs, cpart, red, sc, pid, total;
};

__host__ __device__ inline PagedSmem paged_smem(int C, int G, int D, int PS,
                                                bool quant, bool scores) {
  PagedSmem m;
  int at = 0;
  m.ring = at;
  at += kPagedRing * kPagedStep * (quant ? D : 2 * D + 16);
  m.scl = at;
  at += quant ? kPagedRing * kPagedStep * 4 : 0;
  m.work = at;
  at += quant ? kPagedStep * (2 * D + 16) : 0;
  m.qs = at;
  at += 8 * (D + 8) * 2;
  m.cpart = at;
  at += 8 * D * 4;
  m.red = at;
  at += (32 + 8 + 8) * 4;
  m.sc = at;
  at += scores ? G * (C * kPagedStep + 4) * 4 : 0;
  m.pid = at;
  at += 4 * (C * kPagedStep / PS + 2);
  m.total = at;
  return m;
}

// floats of global score buffer a split CTA needs: 0 when its scores fit in
// shared memory beside the rest, else G x (64 C + 4)
inline int paged_split_scores(int C, int G, int D, int PS, bool quant) {
  return paged_smem(C, G, D, PS, quant, true).total > kPagedSmem
             ? G * (C * kPagedStep + 4)
             : 0;
}

template <int D, bool Q>
__global__ void __launch_bounds__(kPagedThreads) paged_attention_split_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kp_,
    const void* __restrict__ vp_, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ lengths,
    const int* __restrict__ page_ids, __nv_bfloat16* __restrict__ o,
    float* scores, int H, int KV, int P, int PS, int PPS, int C,
    float scale) {
  using bf16 = __nv_bfloat16;
  using KT = typename std::conditional<Q, int8_t, bf16>::type;
  constexpr int ROW = D + 8;            // bf16 a staged row
  constexpr int RAW = Q ? D : 2 * D + 16;  // bytes a raw ring row
  constexpr int CPR = D * (int)sizeof(KT) / 16;   // 16-byte copies a row
  constexpr int KB = D / 32, MD = D / 16;
  constexpr int ring = kPagedRing;
  const KT* kp = reinterpret_cast<const KT*>(kp_);
  const KT* vp = reinterpret_cast<const KT*>(vp_);
  const int chunk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int nch = gridDim.x, G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int pshift = __ffs(PS) - 1;
  const int CT = C * kPagedStep, CTP = CT + 4;
  // the chunk's valid token positions [tok_base, tok_base + lim)
  const int len = max(0, min(lengths[b], PPS * PS));
  const int tok_base = chunk * CT;
  const int lim = max(0, min(CT, len - tok_base));
  const int ns = (lim + kPagedStep - 1) / kPagedStep;   // steps read
  const int pg0 = tok_base >> pshift;
  const int npg = lim > 0 ? ((tok_base + lim - 1) >> pshift) - pg0 + 1 : 0;

  extern __shared__ __align__(16) unsigned char smp[];
  const PagedSmem L = paged_smem(C, G, D, PS, Q, scores == nullptr);
  unsigned char* rings = smp + L.ring;                   // [ring][64][RAW]
  float* scl = reinterpret_cast<float*>(smp + L.scl);    // [ring][64]
  bf16* work = reinterpret_cast<bf16*>(smp + L.work);    // [64][ROW]
  bf16* qs = reinterpret_cast<bf16*>(smp + L.qs);        // [8][ROW]
  float* cpart = reinterpret_cast<float*>(smp + L.cpart);  // [8][D]
  float* redm = reinterpret_cast<float*>(smp + L.red);   // [4][8]
  float* cm = redm + 32;                                  // [8] chunk max
  float* cl = cm + 8;                                     // [8] chunk sum
  float* sc = scores != nullptr
                  ? scores + (((size_t)b * KV + kh) * nch + chunk) * G * CTP
                  : reinterpret_cast<float*>(smp + L.sc);  // [G][CTP]
  int* pid = reinterpret_cast<int*>(smp + L.pid);         // [npg]
  float* accs = reinterpret_cast<float*>(smp + L.ring);   // [4][8][D]

  // ---- the chunk's page ids and q (plain loads: q needs no alignment);
  // the query rows past G are zero
  const int* row = page_ids + (size_t)b * PPS;
  for (int i = tid; i < npg; i += kPagedThreads) pid[i] = max(row[pg0 + i], 0);
  const size_t q0 = ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < 8 * D; i += kPagedThreads) {
    const int r = i / D, d = i % D;
    qs[r * ROW + d] = r < G ? q[q0 + (size_t)r * D + d] : __float2bfloat16(0.f);
  }
  if (tid < 8) {
    cm[tid] = kNeg;
    cl[tid] = 0.f;
  }
  __syncthreads();

  // ---- the ring: step t < ns stages K step t, step ns + i V step i; one
  // commit group a step
  const size_t head0 = (size_t)kh * P;
  auto issue = [&](int t) {
    if (t < 2 * ns) {
      const int st = t < ns ? t : t - ns;
      const KT* src = t < ns ? kp : vp;
      unsigned char* dst = rings + (size_t)(t % ring) * kPagedStep * RAW;
      for (int c = tid; c < kPagedStep * CPR; c += kPagedThreads) {
        const int r = c / CPR, cc = c % CPR;
        const int ci = st * kPagedStep + r, tp = tok_base + ci;
        const bool ok = ci < lim;
        const int pg = ok ? pid[(tp >> pshift) - pg0] : 0;
        const KT* s = src + ((head0 + pg) * PS + (tp & (PS - 1))) * D +
                      cc * (16 / (int)sizeof(KT));
        cp_async16_zfill(dst + r * RAW + cc * 16, ok ? s : src, ok ? 16 : 0);
      }
      if (Q && tid < kPagedStep) {
        const float* ss = t < ns ? ksc : vsc;
        const int ci = st * kPagedStep + tid, tp = tok_base + ci;
        const bool ok = ci < lim;
        const int pg = ok ? pid[(tp >> pshift) - pg0] : 0;
        cp_async4_zfill(scl + (t % ring) * kPagedStep + tid,
                        ok ? ss + (head0 + pg) * PS + (tp & (PS - 1)) : ss,
                        ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < ring; ++t) issue(t);

  uint32_t qf[KB][4];            // q as the B operand: two k16 steps a load
  float mx[2] = {kNeg, kNeg};    // the chunk's max of rows 2 t4, 2 t4 + 1
  float mrow = kNeg, lrow = 0.f;  // the slot's M and L of query row g8
  float oacc[MD][4];
#pragma unroll
  for (int md = 0; md < MD; ++md)
    oacc[md][0] = oacc[md][1] = oacc[md][2] = oacc[md][3] = 0.f;
  namespace cg = cooperative_groups;

  // the chunk's (max, sum) per query row, exchanged over the cluster
  auto exchange = [&]() {
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
    __syncthreads();
    // every position below lim is valid for every query row
    for (int g = wid; g < G; g += 4) {
      const float m = cm[g];
      float l = 0.f;
      for (int i = lane; i < lim; i += 32) l += expf(sc[g * CTP + i] - m);
      l = warp_sum(l);
      if (lane == 0) cl[g] = l;
    }
    if (nch > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      for (int c = 0; c < nch; ++c)
        mrow = fmaxf(mrow, cluster.map_shared_rank(cm, c)[g8]);
      for (int c = 0; c < nch; ++c)
        lrow += cluster.map_shared_rank(cl, c)[g8] *
                expf(cluster.map_shared_rank(cm, c)[g8] - mrow);
    } else {
      __syncthreads();
      mrow = cm[g8];
      lrow = cl[g8];
    }
  };
  // the exchange has one call site, between the K and the V steps (also
  // for a chunk with no steps: its ranks still take part)
  for (int t = 0; t <= 2 * ns; ++t) {
    if (t == ns) exchange();
    if (t == 2 * ns) break;
    cp_async_wait<ring - 1>();   // step t has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
        ldsm_x4(qf[kb], qs + (lane & 7) * ROW + kb * 32 + (lane >> 3) * 8);
    }
    const bf16* tile;
    if constexpr (Q) {
      // the int8 step as the oracle reads it: ((float)x * h) / 127.5,
      // rounded to bf16
      const int8_t* raw =
          reinterpret_cast<const int8_t*>(rings) + (t % ring) * kPagedStep * D;
      const float* hs = scl + (t % ring) * kPagedStep;
      for (int c = tid; c < kPagedStep * D / 16; c += kPagedThreads) {
        const int r = c / (D / 16), cb = (c % (D / 16)) * 16;
        const uint4 w = *reinterpret_cast<const uint4*>(raw + r * D + cb);
        const uint32_t wd[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                w.z ^ 0x80808080u, w.w ^ 0x80808080u};
        const float h = hs[r];
        uint32_t pk[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          pk[j] = pack_bf16(dequant_page(wd[j / 2], 2 * (j % 2), h),
                            dequant_page(wd[j / 2], 2 * (j % 2) + 1, h));
        int4* dst = reinterpret_cast<int4*>(work + r * ROW + cb);
        dst[0] = make_int4(pk[0], pk[1], pk[2], pk[3]);
        dst[1] = make_int4(pk[4], pk[5], pk[6], pk[7]);
      }
      __syncthreads();
      tile = work;
    } else {
      tile = reinterpret_cast<const bf16*>(
          rings + (size_t)(t % ring) * kPagedStep * RAW);
    }
    const int tok0 = 16 * wid;
    if (t < ns) {
      // ---- scores of the warp's 16 rows: tokens as m16, query rows n8
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, tile + a_off(tok0, kb * 32, ROW));
        ldsm_x4(a1, tile + a_off(tok0, kb * 32 + 16, ROW));
        mma_bf16_16816(acc, a0, qf[kb]);
        mma_bf16_16816(acc, a1, qf[kb] + 2);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 2 * t4 + (e & 1);
        const int ci = t * kPagedStep + tok0 + g8 + 8 * (e >> 1);
        const float sv = acc[e] * scale;
        const bool ok = ci < lim && n < G;
        if (n < G) sc[n * CTP + ci] = ok ? sv : kNeg;
        if (ok) mx[e & 1] = fmaxf(mx[e & 1], sv);
      }
    } else {
      // ---- P as B (query row g8; tokens 2 t4, +1, +8, +9 of the warp's
      // k16): p = bf16(exp(s - M) / L); V's rows as A^T
      const int ci0 = (t - ns) * kPagedStep + tok0;
      float pv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ci = ci0 + 2 * t4 + (u & 1) + 8 * (u >> 1);
        pv[u] = g8 < G && ci < lim
                    ? __fdiv_rn(expf(sc[g8 * CTP + ci] - mrow), lrow)
                    : 0.f;
      }
      const uint32_t bfr[2] = {pack_bf16(pv[0], pv[1]),
                               pack_bf16(pv[2], pv[3])};
#pragma unroll
      for (int md = 0; md < MD; ++md) {
        uint32_t a[4];
        ldsm_x4_trans(a, tile + at_off(md * 16, tok0, ROW));
        mma_bf16_16816(oacc[md], a, bfr);
      }
    }
    __syncthreads();      // step t's slot (and the work step) is read out
    issue(t + ring);
  }
  cp_async_wait<0>();
  __syncthreads();        // the ring is free: accs over it

  // ---- the warps' sums in warp order, then the ranks' in chunk order
#pragma unroll
  for (int md = 0; md < MD; ++md)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = md * 16 + g8 + 8 * (e >> 1), n = 2 * t4 + (e & 1);
      accs[(wid * 8 + n) * D + d] = oacc[md][e];
    }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kPagedThreads) {
    const int n = idx / D, d = idx % D;
    float a = 0.f;
    for (int w = 0; w < 4; ++w) a += accs[(w * 8 + n) * D + d];
    if (nch == 1)
      o[q0 + idx] = __float2bfloat16(a);
    else
      cpart[n * D + d] = a;
  }
  if (nch == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int idx = (int)cluster.block_rank() * kPagedThreads + tid; idx < G * D;
       idx += nch * kPagedThreads) {
    float a = 0.f;
    for (int c = 0; c < nch; ++c) a += cluster.map_shared_rank(cpart, c)[idx];
    o[q0 + idx] = __float2bfloat16(a);
  }
  cluster.sync();         // no rank leaves while another reads its rows
}

// chunks of C steps cover the slot's PPS x PS positions, each once
int launch_paged_split(bool quant, const void* q, const void* kp,
                       const void* vp, const void* ksc, const void* vsc,
                       const void* lengths, const void* page_ids, void* o,
                       int B, int H, int KV, int D, int P, int PS, int PPS,
                       float scale, int C, int nch, float* scores,
                       cudaStream_t stream) {
  const int NS = (PPS * PS + kPagedStep - 1) / kPagedStep;
  const int G = KV > 0 ? H / KV : 0;
  if ((PS != 16 && PS != 64 && PS != 128) || (D != 64 && D != 128) ||
      G < 1 || G > 8 || H != G * KV || C < 1 || nch < 1 ||
      nch > kPagedCluster || (nch - 1) * C >= NS || nch * C < NS ||
      (paged_split_scores(C, G, D, PS, quant) > 0 && scores == nullptr))
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  auto kern = quant ? (D == 64 ? paged_attention_split_kernel<64, true>
                               : paged_attention_split_kernel<128, true>)
                    : (D == 64 ? paged_attention_split_kernel<64, false>
                               : paged_attention_split_kernel<128, false>);
  const int smem = paged_smem(C, G, D, PS, quant, scores == nullptr).total;
  if (smem > 48 * 1024) {
    cudaError_t e = raise_smem((const void*)kern, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nch, KV, B);
  cfg.blockDim = dim3(kPagedThreads);
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
      &cfg, kern, (const bf*)q, kp, vp, (const float*)ksc,
      (const float*)vsc, (const int*)lengths, (const int*)page_ids, (bf*)o,
      scores, H, KV, P, PS, PPS, C, scale);
}

// ---------------------------------------------------------------------------
// tile-pool decode attention (decode_attention.py:156)
// ---------------------------------------------------------------------------

// q [BK, G, D]; pools [P, D, PS] (k, v) and [P, NSUB, PS] (codes), tokens on
// the minor axis; tables [BK, TM] of tile ids, a negative id wrapped into
// [0, P) as the oracle's gather wraps -1; entries t < n_tiles[i] count, the
// last with last_count[i] valid lanes, the others all PS. The new token's
// k/v/codes land at (write_tile[i], :, write_slot[i]) before the walk.
template <typename T>
__global__ void __launch_bounds__(kWalkThreads) tile_pool_attention_kernel(
    // the pools are read after this CTA writes them: no __restrict__
    const T* __restrict__ q, T* kp, T* vp, int* cp,
    const int* __restrict__ tables, const int* __restrict__ n_tiles,
    const int* __restrict__ last_count, const T* __restrict__ kn,
    const T* __restrict__ vn, const int* __restrict__ cn,
    const int* __restrict__ wtile, const int* __restrict__ wslot,
    T* __restrict__ o, int P, int G, int D, int NSUB, int TM, int PS,
    float scale, float clamp) {
  const int i = blockIdx.x, tid = threadIdx.x;
  extern __shared__ __align__(16) float sm[];
  const WalkSmem w = walk_smem(sm, G, D, PS, D * (PS + 1), false);
  const int wt = wtile[i], ws = wslot[i];
  for (int d = tid; d < D; d += blockDim.x) {
    kp[((size_t)wt * D + d) * PS + ws] = kn[(size_t)i * D + d];
    vp[((size_t)wt * D + d) * PS + ws] = vn[(size_t)i * D + d];
  }
  for (int s = tid; s < NSUB; s += blockDim.x)
    cp[((size_t)wt * NSUB + s) * PS + ws] = cn[(size_t)i * NSUB + s];
  const size_t qo = (size_t)i * G * D;
  for (int k = tid; k < G * D; k += blockDim.x) w.qs[k] = to_f(q[qo + k]);
  walk_init(w, G, D);
  __syncthreads();                   // the appended column is visible
  const int* tab = tables + (size_t)i * TM;
  const int n_t = n_tiles[i], last = last_count[i];
  auto nvalid = [&](int j) {
    return j == n_t - 1 ? max(0, min(last, PS)) : PS;
  };
  auto tile = [&](int j) { return (size_t)((tab[j] % P + P) % P) * D * PS; };
  auto stage_k = [&](int j) {
    stage_f32<T, T>(w.tile, kp + tile(j), D, PS, nullptr);
  };
  auto stage_v = [&](int j) {
    stage_f32<T, T>(w.tile, vp + tile(j), D, PS, nullptr);
  };
  softmax_walk<T, false>(w, max(0, min(n_t, TM)), G, D, PS, 1, PS + 1, scale,
                         clamp, nvalid, stage_k, stage_v);
  for (int k = tid; k < G * D; k += blockDim.x)
    o[qo + k] = from_f<T>(w.acc[k]);
}

template <typename T>
int launch_tile_pool(const void* q, void* kp, void* vp, void* cp,
                     const void* tables, const void* n_tiles,
                     const void* last_count, const void* kn, const void* vn,
                     const void* cn, const void* wtile, const void* wslot,
                     void* o, int BK, int P, int G, int D, int NSUB, int TM,
                     int PS, float scale, float clamp, cudaStream_t stream) {
  const size_t smem = walk_smem_bytes(G, D, PS, D * (PS + 1), false);
  auto kern = tile_pool_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<BK, kWalkThreads, smem, stream>>>(
      (const T*)q, (T*)kp, (T*)vp, (int*)cp, (const int*)tables,
      (const int*)n_tiles, (const int*)last_count, (const T*)kn,
      (const T*)vn, (const int*)cn, (const int*)wtile, (const int*)wslot,
      (T*)o, P, G, D, NSUB, TM, PS, scale, clamp);
  return (int)cudaGetLastError();
}

}  // namespace spt

// quant: 0 = pages in q's dtype, 1 = int8 pages with f32 scales. bf16 runs
// the split kernel with chunks of C steps (nch chunks a slot; scores: null,
// or B * KV * nch rows of spt_paged_split_scores floats when that is not
// 0), f32 the walk (C, nch and scores unused)
extern "C" int spt_paged_attention(
    int dtype, int quant, const void* q, const void* kp, const void* vp,
    const void* ksc, const void* vsc, const void* lengths,
    const void* page_ids, void* o, int B, int H, int KV, int D, int P, int PS,
    int PPS, float scale, int C, int nch, void* scores, void* stream) {
  if (dtype == spt::kBF16)
    return spt::launch_paged_split(quant != 0, q, kp, vp, ksc, vsc, lengths,
                                   page_ids, o, B, H, KV, D, P, PS, PPS,
                                   scale, C, nch, (float*)scores,
                                   (cudaStream_t)stream);
  auto f = quant ? spt::launch_paged<float, int8_t>
                 : spt::launch_paged<float, float>;
  return f(q, kp, vp, ksc, vsc, lengths, page_ids, o, B, H, KV, D, P, PS, PPS,
           scale, (cudaStream_t)stream);
}

// floats of global score buffer a CTA of the paged split walk takes for
// chunks of C steps, G query rows, d_head D, pages of PS tokens (quant:
// int8 pages): 0 when its scores stay in shared memory
extern "C" int spt_paged_split_scores(int C, int G, int D, int PS,
                                      int quant) {
  return spt::paged_split_scores(C, G, D, PS, quant != 0);
}

extern "C" int spt_tile_pool_attention(
    int dtype, const void* q, void* kp, void* vp, void* cp,
    const void* tables, const void* n_tiles, const void* last_count,
    const void* kn, const void* vn, const void* cn, const void* wtile,
    const void* wslot, void* o, int BK, int P, int G, int D, int NSUB,
    int TM, int PS, float scale, float clamp, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_tile_pool<__nv_bfloat16>
                               : spt::launch_tile_pool<float>;
  return f(q, kp, vp, cp, tables, n_tiles, last_count, kn, vn, cn, wtile,
           wslot, o, BK, P, G, D, NSUB, TM, PS, scale, clamp,
           (cudaStream_t)stream);
}
