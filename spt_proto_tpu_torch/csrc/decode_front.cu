// Fused sparse decode FRONT: norm1 + QKV projection + bias + int8 KV
// quantization + PQ encode of q and k + per-(slot, kv-head) tile
// selection, in one launch per decode layer.
//
// Replaces the TPU kernel spt_proto_tpu/ops/pallas/decode_front.py
// (decode_front / _front_kernel), for the OPT, MHA, stacked-QKV weight form.
//
// Bound on the H100: memory. Per launch at OPT-125M (B=8, ctx 2048) it must
// read the layer's QKV weights (3 x 768 x 768 bf16 = 3.5 MB) and the
// layer's int32 PQ code slab for the full tiles (8 slots x 12 heads x
// 16 tiles x 8 x 128 x 4 B = 6.3 MB): ~9.8 MB, 2.9 us at 3.35 TB/s. The
// arithmetic (a 8 x 768 x 2304 GEMV plus 2 x 64 x 128 encode dots per head)
// is far below the tensor-core line.
//
// Design: one CTA per (kv head, slot), 96 CTAs at the flagship shape, so no
// grid-wide synchronisation is needed: each CTA normalises its slot's row,
// computes only its head's 3 x d_head projection columns (the 8 slots of a
// head re-read the same weight slice, which then comes from L2), quantises
// and PQ-encodes its own k/q, and scans only its own (slot, head) code
// slab. Selection is a short serial loop (<= a few dozen tiles) that
// reproduces lax.top_k order: highest mean match first, lowest tile index
// on ties, then the current tile appended last.
#include "common.cuh"

namespace spt {

template <typename T>
__global__ void __launch_bounds__(256) decode_front_kernel(
    const T* __restrict__ x, const T* __restrict__ nsc,
    const T* __restrict__ nbi, const T* __restrict__ w,
    const T* __restrict__ bqkv, const float* __restrict__ bd,
    const float* __restrict__ cbn, const int* __restrict__ c_cache,
    const int* __restrict__ pos, int base, T* __restrict__ q_out,
    T* __restrict__ k_out, T* __restrict__ v_out, int* __restrict__ c_new,
    int* __restrict__ tables, int8_t* __restrict__ k8,
    int8_t* __restrict__ v8, float* __restrict__ ks, float* __restrict__ vs,
    int D, int KV, int DH, int NS, int NC, int W, int NTALL, int NT,
    int NSEL, int PS, float inv_pg, float eps, int quantized) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nwarps = nthr >> 5;
  const int ksplit = nthr / DH;
  const int F = NS * NC;

  extern __shared__ float sm[];
  float* hn = sm;                          // [D] normalised row
  float* part = hn + D;                    // [3][ksplit][DH] partial dots
  float* qkv = part + 3 * ksplit * DH;     // [3][DH] rounded projections
  float* dots = qkv + 3 * DH;              // [2][F] encode scores
  float* tsc = dots + 2 * F;               // [NT] tile scores
  float* red = tsc + NT;                   // [32] reduction scratch
  int* codes = reinterpret_cast<int*>(red + 32);   // [2][NS] q, k codes

  // ---- norm1: f32 statistics, affine in the serving dtype
  const T* xr = x + (size_t)b * D;
  float s = 0.f;
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
    hn[i] = rt<T>(rt<T>(y * to_f(nsc[i])) + to_f(nbi[i]));
  }
  __syncthreads();

  // ---- this head's q/k/v columns: GEMV over the [D, 3 x DH] weight slice,
  // K split over ksplit thread groups, reduced in a fixed order
  if (tid < ksplit * DH) {
    const int c = tid % DH, kp = tid / DH;
    const int i0 = (int)((long)kp * D / ksplit);
    const int i1 = (int)((long)(kp + 1) * D / ksplit);
    const size_t col = (size_t)h * DH + c;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int i = i0; i < i1; ++i) {
      const float hv = hn[i];
      a0 += hv * to_f(w[((size_t)0 * D + i) * D + col]);
      a1 += hv * to_f(w[((size_t)1 * D + i) * D + col]);
      a2 += hv * to_f(w[((size_t)2 * D + i) * D + col]);
    }
    part[(0 * ksplit + kp) * DH + c] = a0;
    part[(1 * ksplit + kp) * DH + c] = a1;
    part[(2 * ksplit + kp) * DH + c] = a2;
  }
  __syncthreads();
  for (int j = tid; j < 3 * DH; j += nthr) {
    const int t = j / DH, c = j % DH;
    float a = 0.f;
    for (int kp = 0; kp < ksplit; ++kp) a += part[(t * ksplit + kp) * DH + c];
    // the dot rounds to the serving dtype BEFORE the dtype bias add
    const size_t col = (size_t)h * DH + c;
    const float y = rt<T>(rt<T>(a) + to_f(bqkv[(size_t)t * D + col]));
    qkv[t * DH + c] = y;
    T* out = t == 0 ? q_out : (t == 1 ? k_out : v_out);
    out[(size_t)b * D + col] = from_f<T>(y);
  }
  __syncthreads();

  // ---- int8 per-token quantisation of k (warp 0) and v (warp 1):
  // max-abs / 127, round half to even, clip +-127
  if (quantized && wid < 2) {
    const float* src = qkv + (1 + wid) * DH;
    float amax = 0.f;
    for (int i = lane; i < DH; i += 32) amax = fmaxf(amax, fabsf(src[i]));
    amax = warp_max(amax);
    const float sc = fmaxf(amax, 1e-8f) / 127.0f;
    int8_t* dst = (wid == 0 ? k8 : v8) + (size_t)b * D + (size_t)h * DH;
    for (int i = lane; i < DH; i += 32) {
      const float qv = fminf(fmaxf(rintf(src[i] / sc), -127.f), 127.f);
      dst[i] = (int8_t)qv;
    }
    if (lane == 0) (wid == 0 ? ks : vs)[b * KV + h] = sc;
  }

  // ---- PQ encode q and k: score = |c|^2 - 2 z.c, argmin per subspace
  for (int j = tid; j < 2 * F; j += nthr) {
    const int vec = j / F, cc = j % F;
    const float* z = qkv + vec * DH;
    float dot = 0.f;
    for (int d = 0; d < DH; ++d) dot += z[d] * bd[(size_t)d * F + cc];
    dots[j] = cbn[cc] - 2.0f * dot;
  }
  __syncthreads();
  if (tid < 2 * NS) {
    const int vec = tid / NS, sub = tid % NS;
    const float* sc = dots + vec * F + sub * NC;
    int best = 0;
    float bv = sc[0];
    for (int c = 1; c < NC; ++c)   // strict <: lowest index wins ties
      if (sc[c] < bv) { bv = sc[c]; best = c; }
    codes[vec * NS + sub] = best;
  }
  __syncthreads();
  for (int i = tid; i < W; i += nthr)
    c_new[((size_t)b * KV + h) * W + i] = i < NS ? codes[NS + i] : -2;

  // ---- mean match of q's codes against each FULL tile of this layer
  const int cur = pos[b] / PS;
  const int nfull = min(cur, NT);
  for (int t = wid; t < NT; t += nwarps) {
    float score = kNeg;
    if (t < nfull) {
      const int* slab =
          c_cache + (((size_t)b * KV + h) * NTALL + base + t) * W * PS;
      int cnt = 0;
      for (int sub = 0; sub < NS; ++sub) {
        const int qc = codes[sub];
        for (int p = lane; p < PS; p += 32) cnt += slab[sub * PS + p] == qc;
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

template <typename T>
int launch_front(const void* x, const void* nsc, const void* nbi, const void* w,
           const void* bqkv, const float* bd, const float* cbn,
           const int* c_cache, const int* pos, int base, void* q, void* k,
           void* v, int* c_new, int* tables, int8_t* k8, int8_t* v8,
           float* ks, float* vs, int B, int D, int KV, int DH, int NS, int NC,
           int W, int NTALL, int NT, int NSEL, int PS, float inv_pg,
           float eps, int quantized, cudaStream_t stream) {
  const int threads = 256;
  const int ksplit = threads / DH;
  const size_t smem = sizeof(float) * (D + 3 * ksplit * DH + 3 * DH +
                                       2 * NS * NC + NT + 32 + 2 * NS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_front_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(KV, B);
  decode_front_kernel<T><<<grid, threads, smem, stream>>>(
      (const T*)x, (const T*)nsc, (const T*)nbi, (const T*)w,
      (const T*)bqkv, bd, cbn, c_cache, pos, base, (T*)q, (T*)k, (T*)v,
      c_new, tables, k8, v8, ks, vs, D, KV, DH, NS, NC, W, NTALL, NT, NSEL,
      PS, inv_pg, eps, quantized);
  return (int)cudaGetLastError();
}

}  // namespace spt

extern "C" int spt_decode_front(
    int dtype, const void* x, const void* nsc, const void* nbi,
    const void* w, const void* bqkv, const void* bd, const void* cbn,
    const void* c_cache, const void* pos, int base, void* q, void* k,
    void* v, void* c_new, void* tables, void* k8, void* v8, void* ks,
    void* vs, int B, int D, int KV, int DH, int NS, int NC, int W,
    int NTALL, int NT, int NSEL, int PS, float inv_pg, float eps,
    int quantized, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_front<__nv_bfloat16>
                               : spt::launch_front<float>;
  return f(x, nsc, nbi, w, bqkv, (const float*)bd, (const float*)cbn,
           (const int*)c_cache, (const int*)pos, base, q, k, v, (int*)c_new,
           (int*)tables, (int8_t*)k8, (int8_t*)v8, (float*)ks, (float*)vs, B,
           D, KV, DH, NS, NC, W, NTALL, NT, NSEL, PS, inv_pg, eps, quantized,
           (cudaStream_t)stream);
}
