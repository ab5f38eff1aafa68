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
// group as the oracle repeats them. Both kernels run the two-pass walk of
// softmax_walk.cuh with the oracle's numerics (normalise, then round to the
// V dtype): shared memory holds one page, so it does not grow with the
// context. int8 pages are dequantized while they are staged, as the oracle
// reads them: ((float)x * h) / 127.5 rounded to q's dtype. The stock
// kernel's pages_per_compute_block and its 128-lane head padding are TPU
// mechanics and are not carried over. Pages past a slot's length are not
// read.
#include "softmax_walk.cuh"

namespace spt {

// ---------------------------------------------------------------------------
// paged attention (the stock kernel's contract)
// ---------------------------------------------------------------------------

// q [B, H, D] (head h = kv head h / G, query g = h % G); pages [KV, P, PS, D]
// of KT (T, or int8 with scales [KV, P, PS] f32); lengths [B]; pages ids
// [B, PPS] physical, -1 read as page 0 (the oracle's max(id, 0)); o
// [B, H, D]. Positions >= lengths[b] are masked.
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

// quant: 0 = pages in q's dtype, 1 = int8 pages with f32 scales
extern "C" int spt_paged_attention(
    int dtype, int quant, const void* q, const void* kp, const void* vp,
    const void* ksc, const void* vsc, const void* lengths,
    const void* page_ids, void* o, int B, int H, int KV, int D, int P, int PS,
    int PPS, float scale, void* stream) {
  using bf = __nv_bfloat16;
  auto f = dtype == spt::kBF16
               ? (quant ? spt::launch_paged<bf, int8_t> : spt::launch_paged<bf, bf>)
               : (quant ? spt::launch_paged<float, int8_t>
                        : spt::launch_paged<float, float>);
  return f(q, kp, vp, ksc, vsc, lengths, page_ids, o, B, H, KV, D, P, PS, PPS,
           scale, (cudaStream_t)stream);
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
