// Fused lm_head + greedy argmax: next token = argmax_v (x @ W)[b, v],
// without storing the [B, V] logits.
//
// Replaces the TPU kernels spt_proto_tpu/ops/pallas/lm_head.py
// lm_head_argmax (_kernel) and lm_head_argmax_int8 (_kernel_int8).
//
// Bound on the H100: memory. Per launch it must read W once: d 4096 x
// 128,256 bf16 (Llama-3-8B) is 1.05 GB, 314 us at 3.35 TB/s (int8: 157
// us); OPT-125M's 768 x 50,272 is 77 MB, 23 us (int8 11.6 us). At B = 8
// the 8 d V multiply-adds are 4 a byte of bf16 W and 8 a byte of int8 W:
// ~27 TFMA/s at the int8 form's bandwidth, about all the CUDA cores' f32
// FMA rate, but little for the tensor cores.
//
// Design: the TPU kernel walks V-tiles in order and carries a running
// (max, argmax) across grid steps. CTAs on the H100 run in no order, so the
// carry becomes two passes: pass 1 gives each CTA one V tile and writes its
// per-row (max, lowest index); pass 2 (lm_head_reduce_kernel) reduces the
// per-tile partials per row with the same rule: larger value, then lower
// index. Each logit is rounded to the serving dtype before the compare, so
// the winner is the argmax of the unfused dtype logits; columns at or past
// the TRUE vocab V never win.
//
// bf16 (the serving dtype), lm_head_tc_kernel: a weight stream on the
// tensor cores. A CTA of 8 warps owns a tile of vocabulary columns (256,
// or 512 int8: 512 bytes of each W row) and up to 16 batch rows (NG n8
// groups; larger B runs row groups side by side, which read W from HBM
// once). A 3-stage cp.async ring carries W's 64-row K-chunks (16-byte
// copies, 33 KB a stage; 2 CTAs an SM keep ~130 KB in flight) and beside
// them the matching K-chunk of x, so shared memory does not grow with d.
// The products run on mma.sync m16n8k16 with W^T as the A operand (16
// vocabulary columns x 16 k, ldmatrix.trans from W's stored [k][v] layout)
// and x as B (n = 8 batch rows), so B <= 8 wastes nothing. The int8 form
// takes ldmatrix.trans of int8 pairs (16-bit elements): a thread then
// holds rows k, k+1 of columns 2c, 2c+1 and converts them to bf16 in
// registers (exact), the A tile's rows being the columns in the order 0, 2,
// 4, .., 14 then 1, 3, .., 15. Batch rows past B and k past d are
// zero-filled copies. The argmax runs in the epilogue: a thread's columns,
// then the 8 lanes sharing a batch row (shuffles), then the warps.
// The int8 form keeps int8_matmul's numerics: x is bf16, int8 -> bf16 is
// exact, f32 sums run over K chunks of BK (a fresh fragment each) added to
// the running sum in ascending order, then * scale, then the round.
//
// f32 (the parity runs), lm_head_partial_kernel: CUDA cores. Each thread
// owns one vocabulary column and accumulates the f32 dot for up to 8 rows
// from x staged in shared memory as f32 at full width (so d <= 6,400).
// The int8 form rounds x to bf16 and sums in BK-row chunks as above.
#include "common.cuh"

#include <type_traits>

namespace spt {

constexpr int kHeadTile = 128;   // V columns a CTA (lm_head.py HEAD_TILE)
constexpr int kHeadRows = 8;     // rows accumulated per pass over W (f32)

// W is T (fp head: scale null, LDW = V, BK = D) or int8_t (int8 head)
template <typename T, typename W>
__global__ void __launch_bounds__(kHeadTile) lm_head_partial_kernel(
    const T* __restrict__ x, const W* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ pval,
    int* __restrict__ pidx, int B, int D, int V, int LDW, int BK) {
  extern __shared__ float xs[];                 // [kHeadRows][D]
  __shared__ float rv[kHeadTile / 32][kHeadRows];
  __shared__ int ri[kHeadTile / 32][kHeadRows];
  const int tile = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int col = tile * kHeadTile + tid;
  const bool live = col < V;
  for (int r0 = 0; r0 < B; r0 += kHeadRows) {
    const int nr = min(kHeadRows, B - r0);
    __syncthreads();
    for (int i = tid; i < nr * D; i += blockDim.x) {
      const float xv = to_f(x[(size_t)r0 * D + i]);
      xs[i] = scale != nullptr ? rt<__nv_bfloat16>(xv) : xv;
    }
    __syncthreads();
    float acc[kHeadRows];
#pragma unroll
    for (int r = 0; r < kHeadRows; ++r) acc[r] = 0.f;
    if (live) {
      for (int k0 = 0; k0 < D; k0 += BK) {     // chunks in ascending order
        float part[kHeadRows];
#pragma unroll
        for (int r = 0; r < kHeadRows; ++r) part[r] = 0.f;
        const int k1 = min(k0 + BK, D);
        for (int i = k0; i < k1; ++i) {
          const float wv = to_f(w[(size_t)i * LDW + col]);
#pragma unroll
          for (int r = 0; r < kHeadRows; ++r)
            if (r < nr) part[r] += xs[r * D + i] * wv;
        }
#pragma unroll
        for (int r = 0; r < kHeadRows; ++r) acc[r] += part[r];
      }
    }
    const float sc = live && scale != nullptr ? scale[col] : 1.f;
    for (int r = 0; r < nr; ++r) {
      float v = live ? rt<T>(scale != nullptr ? acc[r] * sc : acc[r])
                     : -INFINITY;
      int ix = live ? col : 0x7fffffff;
      for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, ix, o);
        if (better(v2, i2, v, ix)) { v = v2; ix = i2; }
      }
      if (lane == 0) { rv[wid][r] = v; ri[wid][r] = ix; }
    }
    __syncthreads();
    if (tid < nr) {
      float v = rv[0][tid];
      int ix = ri[0][tid];
      for (int k = 1; k < kHeadTile / 32; ++k)
        if (better(rv[k][tid], ri[k][tid], v, ix)) { v = rv[k][tid]; ix = ri[k][tid]; }
      pval[(size_t)tile * B + r0 + tid] = v;
      pidx[(size_t)tile * B + r0 + tid] = ix;
    }
  }
}

__global__ void __launch_bounds__(256) lm_head_reduce_kernel(
    const float* __restrict__ pval, const int* __restrict__ pidx,
    int* __restrict__ out, int B, int n_tiles) {
  __shared__ float sv[256];
  __shared__ int si[256];
  const int b = blockIdx.x, tid = threadIdx.x;
  float v = -INFINITY;
  int ix = 0x7fffffff;
  for (int t = tid; t < n_tiles; t += blockDim.x) {
    const float v2 = pval[(size_t)t * B + b];
    const int i2 = pidx[(size_t)t * B + b];
    if (better(v2, i2, v, ix)) { v = v2; ix = i2; }
  }
  sv[tid] = v;
  si[tid] = ix;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s && better(sv[tid + s], si[tid + s], sv[tid], si[tid])) {
      sv[tid] = sv[tid + s];
      si[tid] = si[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) out[b] = si[0];
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core weight stream
// ---------------------------------------------------------------------------

// a CTA's vocabulary columns and warps, the K rows of a ring stage and the
// ring's depth (shared memory is the W stages, their rows padded by 16
// bytes so that ldmatrix's 8 row addresses fall in distinct banks, and x's).
// Chosen on the card (H100, kernel_ab.py --head and builds with one
// constant changed): wide tiles give long contiguous runs of each W row
// (512 bytes) and 2 CTAs an SM keep ~130 KB in flight; the int8 form wants
// the same bytes a stage, so twice the columns.
template <typename W> struct HeadCfg;
template <> struct HeadCfg<__nv_bfloat16> {   // 102 KB at NG = 1
  static constexpr int kTile = 256, kWarps = 8, kK = 64, kStages = 3;
};
template <> struct HeadCfg<int8_t> {          // 102 KB at NG = 1
  static constexpr int kTile = 512, kWarps = 8, kK = 64, kStages = 3;
};

template <typename W, int NG>
struct HeadSmem {
  using C = HeadCfg<W>;
  static constexpr int kTile = C::kTile, kWarps = C::kWarps, kK = C::kK;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMT = kTile / kWarps / 16;  // m16 tiles a warp
  static constexpr int kRowB = kTile * (int)sizeof(W) + 16;
  static constexpr int kRows = 8 * NG;           // batch rows a CTA
  static constexpr int kXRow = kK + 8;           // bf16 a staged x row
  static constexpr int kW = kK * kRowB;
  static constexpr int kStage = kW + kRows * kXRow * 2;
  static constexpr int kBytes = C::kStages * kStage;
  static_assert(kK % 32 == 0 && kStage % 16 == 0 && kMT % 2 == 0 &&
                kK * kTile * (int)sizeof(W) % (16 * kThreads) == 0,
                "stage layout");
};

// W's rows (LDW), x's rows (D) and both bases are 16-byte aligned
template <typename W, int NG>
__global__ void __launch_bounds__(HeadSmem<W, NG>::kThreads)
lm_head_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const W* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ pval,
    int* __restrict__ pidx, int B, int D, int V, int LDW, int BK) {
  using L = HeadSmem<W, NG>;
  using bf16 = __nv_bfloat16;
  constexpr bool kInt8 = std::is_same<W, int8_t>::value;
  constexpr int kK = L::kK, kStages = HeadCfg<W>::kStages;
  constexpr int kRowB = L::kRowB, kRows = L::kRows, kXRow = L::kXRow;
  constexpr int kTile = L::kTile, kWarps = L::kWarps, kMT = L::kMT;
  constexpr int kThreads = L::kThreads, kWarpCols = 16 * kMT;
  constexpr int kWE = 16 / sizeof(W);            // W elements a copy
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rv[kWarps][kRows];
  __shared__ int ri[kWarps][kRows];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.x * kRows;             // the CTA's batch rows
  const int tile = blockIdx.y, c0 = tile * kTile;
  const int n_steps = (D + kK - 1) / kK;

  auto load = [&](int j) {
    unsigned char* st = smem + (j % kStages) * L::kStage;
    const int k0 = j * kK;
    constexpr int kWCopies = kTile / kWE;        // copies a W row
#pragma unroll
    for (int it = 0; it < kK * kWCopies / kThreads; ++it) {
      const int i = it * kThreads + tid, r = i / kWCopies;
      const int c = (i % kWCopies) * kWE, k = k0 + r, col = c0 + c;
      const bool ok = k < D && col < LDW;   // then col + kWE <= LDW
      cp_async16_zfill_l2(st + r * kRowB + c * sizeof(W),
                          ok ? w + (size_t)k * LDW + col : w, ok ? 16 : 0);
    }
    unsigned char* xs = st + L::kW;
    constexpr int kXCopies = kK / 8;
    for (int i = tid; i < kRows * kXCopies; i += kThreads) {
      const int r = i / kXCopies, c = (i % kXCopies) * 8;
      const int row = r0 + r, k = k0 + c;
      const bool ok = row < B && k < D;
      cp_async16_zfill(xs + (r * kXRow + c) * 2,
                       ok ? x + (size_t)row * D + k : x, ok ? 16 : 0);
    }
  };

  // the running sums and, int8, the current K chunk's: [m16 tile][n8][4]
  float acc[kMT][NG][4] = {}, part[kMT][NG][4] = {};
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_steps) load(j);
    cp_async_commit();
  }
  for (int j = 0; j < n_steps; ++j) {
    cp_async_wait<kStages - 2>();   // stage j has landed ...
    __syncthreads();                // ... for every thread; j - 1 read out
    if (j + kStages - 1 < n_steps) load(j + kStages - 1);
    cp_async_commit();
    const unsigned char* ws = smem + (j % kStages) * L::kStage;
    const bf16* xs = reinterpret_cast<const bf16*>(ws + L::kW);
#pragma unroll
    for (int kk = 0; kk < kK; kk += 32) {
      // x fragments of two k16 steps: registers 0-1 for kk, 2-3 for kk + 16
      uint32_t xb[NG][4];
#pragma unroll
      for (int ng = 0; ng < NG; ++ng)
        ldsm_x4(xb[ng], xs + (ng * 8 + (lane & 7)) * kXRow + kk
                            + (lane >> 3) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k16 = kk + 16 * h;
        uint32_t a[kMT][4];
        if constexpr (kInt8) {
          // matrices: (k 0-7, columns 0-15), (k 8-15, 0-15), then 16-31
#pragma unroll
          for (int p = 0; p < kMT / 2; ++p) {
            uint32_t raw[4];
            ldsm_x4_trans(raw, ws + (k16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                        * kRowB
                                    + wid * kWarpCols + p * 32
                                    + (lane >> 4) * 16);
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              i8_pairs_to_bf16(raw[2 * h2], a[2 * p + h2]);
              i8_pairs_to_bf16(raw[2 * h2 + 1], a[2 * p + h2] + 2);
            }
          }
        } else {
          // matrices: (k 0-7, columns 0-7), (k 0-7, 8-15), (k 8-15, 0-7),
          // (k 8-15, 8-15) of the m16 tile
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            ldsm_x4_trans(a[mt], ws + (k16 + (lane & 7) + (lane >> 4) * 8)
                                          * kRowB
                                      + (wid * kWarpCols + mt * 16
                                         + ((lane >> 3) & 1) * 8) * 2);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int ng = 0; ng < NG; ++ng) {
            if constexpr (kInt8)
              mma_bf16_16816(part[mt][ng], a[mt], xb[ng] + 2 * h);
            else
              mma_bf16_16816(acc[mt][ng], a[mt], xb[ng] + 2 * h);
          }
      }
    }
    if constexpr (kInt8) {          // the K chunk ends: add it in order
      if (((j + 1) * kK) % BK == 0 || j + 1 == n_steps) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int ng = 0; ng < NG; ++ng)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[mt][ng][e] += part[mt][ng][e];
              part[mt][ng][e] = 0.f;
            }
      }
    }
  }
  cp_async_wait<0>();

  // argmax: fragment element e is (A row g + 8 (e / 2), batch row
  // 2 t4 + e % 2); A row r is column r (bf16) or 2 (r % 8) + r / 8 (int8)
#pragma unroll
  for (int ng = 0; ng < NG; ++ng)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      float v = -INFINITY;
      int ix = 0x7fffffff;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int col = c0 + wid * kWarpCols + mt * 16
                          + (kInt8 ? 2 * g + hr : g + 8 * hr);
          if (col < V) {
            float s = acc[mt][ng][2 * hr + e2];
            if constexpr (kInt8) s *= scale[col];
            const float lv = rt<bf16>(s);
            if (better(lv, col, v, ix)) { v = lv; ix = col; }
          }
        }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {   // the 8 lanes of one batch row
        const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, ix, o);
        if (better(v2, i2, v, ix)) { v = v2; ix = i2; }
      }
      if (g == 0) {
        rv[wid][ng * 8 + 2 * t4 + e2] = v;
        ri[wid][ng * 8 + 2 * t4 + e2] = ix;
      }
    }
  __syncthreads();
  if (tid < kRows && r0 + tid < B) {
    float v = rv[0][tid];
    int ix = ri[0][tid];
#pragma unroll
    for (int k = 1; k < kWarps; ++k)
      if (better(rv[k][tid], ri[k][tid], v, ix)) { v = rv[k][tid]; ix = ri[k][tid]; }
    pval[(size_t)tile * B + r0 + tid] = v;
    pidx[(size_t)tile * B + r0 + tid] = ix;
  }
}

template <typename W, int NG>
int launch_tc(const void* x, const void* w, const float* scale, float* pval,
              int* pidx, int B, int D, int V, int LDW, int BK,
              cudaStream_t stream) {
  using L = HeadSmem<W, NG>;
  constexpr int smem = L::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      lm_head_tc_kernel<W, NG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // row groups fastest: the CTAs of one V tile run side by side
  dim3 grid((B + L::kRows - 1) / L::kRows, (V + L::kTile - 1) / L::kTile);
  lm_head_tc_kernel<W, NG><<<grid, L::kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const W*)w, scale, pval, pidx, B, D, V, LDW,
      BK);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch_head(const void* x, const void* w, const float* scale, void* pval,
                void* pidx, void* out, int B, int D, int V, int LDW, int BK,
                cudaStream_t stream) {
  int n_tiles = (V + kHeadTile - 1) / kHeadTile;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    n_tiles = (V + HeadCfg<W>::kTile - 1) / HeadCfg<W>::kTile;
    // K chunks of whole stages (int8), or one chunk of all of d; 16-byte
    // aligned rows and bases (the wrappers check)
    if ((std::is_same<W, int8_t>::value && BK % HeadCfg<W>::kK != 0 &&
         BK < D) ||
        LDW % (16 / sizeof(W)) != 0 || D % 8 != 0 ||
        (uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0)
      return (int)cudaErrorInvalidValue;
    // past 16 rows, row groups of 16: a tile's CTAs run side by side and
    // read its W once from HBM, then from L2
    auto f = B <= 8 ? launch_tc<W, 1> : launch_tc<W, 2>;
    const int err = f(x, w, scale, (float*)pval, (int*)pidx, B, D, V, LDW,
                      BK, stream);
    if (err != 0) return err;
  } else {
    const size_t smem = sizeof(float) * kHeadRows * D;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          lm_head_partial_kernel<T, W>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    lm_head_partial_kernel<T, W><<<n_tiles, kHeadTile, smem, stream>>>(
        (const T*)x, (const W*)w, scale, (float*)pval, (int*)pidx, B, D, V,
        LDW, BK);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  lm_head_reduce_kernel<<<B, 256, 0, stream>>>(
      (const float*)pval, (const int*)pidx, (int*)out, B, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace spt

extern "C" int spt_lm_head_argmax(int dtype, const void* x, const void* w,
                                  void* pval, void* pidx, void* out, int B,
                                  int D, int V, void* stream) {
  auto f = dtype == spt::kBF16
               ? spt::launch_head<__nv_bfloat16, __nv_bfloat16>
               : spt::launch_head<float, float>;
  return f(x, w, nullptr, pval, pidx, out, B, D, V, V, D,
           (cudaStream_t)stream);
}

extern "C" int spt_lm_head_argmax_int8(int dtype, const void* x,
                                       const void* q, const void* scale,
                                       void* pval, void* pidx, void* out,
                                       int B, int D, int V, int LDW, int BK,
                                       void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_head<__nv_bfloat16, int8_t>
                               : spt::launch_head<float, int8_t>;
  return f(x, q, (const float*)scale, pval, pidx, out, B, D, V, LDW, BK,
           (cudaStream_t)stream);
}
