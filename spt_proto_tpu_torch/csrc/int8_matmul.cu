// int8 weight-only matmul with the dequantization fused in:
//   out[m, n] = (sum_k bf16(x[m, k]) * q[k, n]) * scale[n]   (0 for n >= N)
// x [M, K] f32/bf16, q [K, NP] int8 (NP = N padded at quantization time),
// scale [N] f32 per output column, out [M, NP] in x's dtype.
//
// Replaces the TPU kernel spt_proto_tpu/ops/pallas/int8_matmul.py
// int8_matmul (_kernel), with its numerics: x rounded to bf16 (also for an
// f32 x), bf16 x int8 products summed in f32 per BK-row chunk, the chunk
// partials added to the running sum in ascending order, then one scale
// multiply per column and the cast to x's dtype. BK is the TPU kernel's
// block_k: 256 when M < 64 and K % 256 == 0, else 128.
//
// Bound on the H100. Decode (M = 8): memory, the int8 weight streamed once
// (OPT-125M o 0.6 MB, qkv 1.8 MB: 0.2 / 0.5 us at 3.35 TB/s; OPT-1.3B qkv
// 12.6 MB, 3.8 us). Prefill (M = B x S = 16,384): operations, 2 M K N bf16
// products (OPT-125M fc1 77 GFLOP, 78 us at 989 TFLOP/s).
//
// Design: bf16 x (the serving and int8_base dtype) runs the tensor-core
// kernels of spt_int8_matmul_tc, f32 x and shapes off their rule (K % 8,
// 16-byte alignment; ops/int8_matmul.py int8_matmul_plan) the CUDA-core
// kernels of spt_int8_matmul:
// - m >= 64, int8_matmul_wgmma_kernel<BN>: out^T = q^T x^T on wgmma. A CTA
//   owns 128 weight columns x BN rows of x (128 or 256). One producer warp
//   keeps a 4-stage mbarrier ring of TMA loads in flight: the x tile
//   [BN][64] bf16 and the int8 q tile [64][128], both in the 128-byte
//   swizzle, q at half the bytes of bf16. Two consumer warpgroups (64
//   weight columns each, setmaxnreg 232 / producer 40) read their int8
//   A operand with ldmatrix.trans and widen it to bf16 pairs in registers
//   (i8_pairs_to_bf16), and x is B from shared memory through a K-major
//   descriptor: wgmma m64nBNk16, f32 accumulators in registers over all of
//   K (no chunk partials: the bf16 output's step hides the order). The
//   epilogue scales each column (an accumulator row), casts, and stages the
//   tile through shared memory for 16-byte stores; columns n >= N are 0.
//   A grouped raster (8 row tiles a column step) keeps a wave's x rows and
//   weight columns in L2.
// - m < 64, int8_matmul_stream_kernel<NG, S>: the tensor-core weight stream
//   of csrc/weight_stream.cuh (the greedy head's design): W^T as A through
//   ldmatrix.trans + i8_pairs_to_bf16, x's rows as B, a cp.async ring of
//   64-row K chunks. N alone gives few CTAs (768-14,336 columns, 128 a
//   CTA), so K splits into ordered slices (blockIdx.y) whose f32 partials
//   int8_matmul_reduce_kernel adds in slice order, then scales and casts:
//   no atomics, the same result every run. One slice writes the output
//   directly (scale, cast, 16-byte stores through shared memory).
// - f32, int8_matmul_skinny_kernel (m < 64): a weight stream on the CUDA
//   cores. Each CTA owns 32 output columns for a block of 8 rows; its 256
//   threads are 2 column groups of 16 (one 16-byte load of 16 int8 columns
//   per K row) by 128 K-lanes. Per chunk the x rows are staged bf16-rounded
//   in shared memory, each thread sums its rows of the chunk in registers,
//   the K-lanes of a warp are added with shuffles and the 8 warps in a
//   fixed order, and that chunk partial is added to the thread's running
//   sum: the TPU kernel's chunk partials, which the f32 bound needs.
// - f32, int8_matmul_tiled_kernel (m >= 64): 64 x 128 output tiles, 8
//   warps of 32 x 32, per 128-row chunk the x tile staged as bf16 and the
//   int8 tile converted to bf16 (exact) in shared memory, mma.sync m16n8k16
//   summing the chunk into a fresh fragment added to the running one.
#include <cuda.h>   // CUtensorMap (its encoder is fetched at run time)

#include "common.cuh"
#include "weight_stream.cuh"

namespace spt {

constexpr int kSkinnyM = 64;        // ops/int8_matmul.py SKINNY_M

constexpr int kSkRows = 8;          // rows per CTA
constexpr int kSkCols = 32;         // output columns per CTA
constexpr int kSkThreads = 256;
constexpr int kSkGroups = kSkCols / 16;              // column groups of 16
constexpr int kSkLanes = kSkThreads / kSkGroups;     // K-lanes
constexpr int kSkWarps = kSkThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kSkThreads) int8_matmul_skinny_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, T* __restrict__ out, int M, int K,
    int N, int NP, int BK) {
  extern __shared__ __align__(16) unsigned char smraw[];
  float* xs = reinterpret_cast<float*>(smraw);        // [kSkRows][BK]
  float* red = xs + kSkRows * BK;                      // [warps][rows][cols]
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int n0 = blockIdx.x * kSkCols, m0 = blockIdx.y * kSkRows;
  const int rows = min(kSkRows, M - m0);
  const int cg = tid % kSkGroups, kl = tid / kSkGroups;
  const int col0 = n0 + cg * 16;
  const bool live = col0 < NP;
  float acc = 0.f;          // output (tid / kSkCols, tid % kSkCols)

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < kSkRows * BK; i += kSkThreads) {
      const int r = i / BK, k = k0 + i % BK;
      xs[i] = r < rows && k < K
                  ? rt<__nv_bfloat16>(to_f(x[(size_t)(m0 + r) * K + k]))
                  : 0.f;
    }
    __syncthreads();
    float p[kSkRows][16];
#pragma unroll
    for (int r = 0; r < kSkRows; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) p[r][j] = 0.f;
    if (live) {
      for (int kk = kl; kk < BK && k0 + kk < K; kk += kSkLanes) {
        const int4 raw = *reinterpret_cast<const int4*>(
            q + (size_t)(k0 + kk) * NP + col0);
        const int8_t* wb = reinterpret_cast<const int8_t*>(&raw);
        float wv[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) wv[j] = to_f(wb[j]);
#pragma unroll
        for (int r = 0; r < kSkRows; ++r) {
          const float xv = xs[r * BK + kk];
#pragma unroll
          for (int j = 0; j < 16; ++j) p[r][j] += xv * wv[j];
        }
      }
    }
    // the warp's K-lanes of one column group differ in lane bits >= 1
#pragma unroll
    for (int r = 0; r < kSkRows; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float v = p[r][j];
#pragma unroll
        for (int o = kSkGroups; o < 32; o <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        p[r][j] = v;
      }
    if (lane < kSkGroups) {
#pragma unroll
      for (int r = 0; r < kSkRows; ++r)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          red[(wid * kSkRows + r) * kSkCols + cg * 16 + j] = p[r][j];
    }
    __syncthreads();
    float chunk = 0.f;                 // warps in a fixed order
    for (int w = 0; w < kSkWarps; ++w) chunk += red[w * kSkRows * kSkCols + tid];
    acc += chunk;
    __syncthreads();
  }
  const int r = tid / kSkCols, c = n0 + tid % kSkCols;
  if (r < rows && c < NP)
    out[(size_t)(m0 + r) * NP + c] =
        from_f<T>(acc * (c < N ? scale[c] : 0.f));
}

constexpr int kTM = 64, kTN = 128, kTK = 128;
constexpr int kTStride = kTK + 8;   // bf16 per shared row (conflict-free)

template <typename T>
__global__ void __launch_bounds__(256) int8_matmul_tiled_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, T* __restrict__ out, int M, int K,
    int N, int NP) {
  extern __shared__ __align__(16) unsigned char smraw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smraw);  // [TM][TK]
  __nv_bfloat16* bs = as + kTM * kTStride;      // [TN][TK]: n-major
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = wid % 2, wn = wid / 2;         // warp tile 32 x 32
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int i = tid; i < kTM * kTK; i += 256) {
      const int r = i / kTK, c = i % kTK;
      const float v = m0 + r < M && k0 + c < K
                          ? to_f(x[(size_t)(m0 + r) * K + k0 + c]) : 0.f;
      as[r * kTStride + c] = __float2bfloat16(v);
    }
    // int8 rows k, k+1 of 16 columns -> bf16 pairs at bs[n][k..k+1]
    for (int t = tid; t < (kTK / 2) * (kTN / 16); t += 256) {
      const int kp = t % (kTK / 2), cgp = t / (kTK / 2);
      const int k = k0 + 2 * kp, n = n0 + cgp * 16;
      int4 r0 = make_int4(0, 0, 0, 0), r1 = r0;
      if (n < NP) {
        if (k < K) r0 = *reinterpret_cast<const int4*>(q + (size_t)k * NP + n);
        if (k + 1 < K)
          r1 = *reinterpret_cast<const int4*>(q + (size_t)(k + 1) * NP + n);
      }
      const int8_t* w0 = reinterpret_cast<const int8_t*>(&r0);
      const int8_t* w1 = reinterpret_cast<const int8_t*>(&r1);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            bs + (cgp * 16 + j) * kTStride + 2 * kp) =
            __floats2bfloat162_rn(to_f(w0[j]), to_f(w1[j]));
    }
    __syncthreads();
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* ap =
            as + (wm * 32 + i * 16 + g) * kTStride + kk + tig * 2;
        af[i][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[i][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * kTStride);
        af[i][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * kTStride + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* bp =
            bs + (wn * 32 + j * 8 + g) * kTStride + kk + tig * 2;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(bp);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(bp + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(part[i][j], af[i], bf[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + i * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + j * 8 + tig * 2 + (e & 1);
        if (row < M && col < NP)
          out[(size_t)row * NP + col] =
              from_f<T>(acc[i][j][e] * (col < N ? scale[col] : 0.f));
      }
}

template <typename T>
int launch_int8_matmul(const void* x, const int8_t* q, const float* scale,
                       void* out, int M, int K, int N, int NP, int BK,
                       cudaStream_t stream) {
  if (M < kSkinnyM) {
    const size_t smem =
        sizeof(float) * ((size_t)kSkRows * BK + kSkWarps * kSkRows * kSkCols);
    dim3 grid((NP + kSkCols - 1) / kSkCols, (M + kSkRows - 1) / kSkRows);
    int8_matmul_skinny_kernel<T><<<grid, kSkThreads, smem, stream>>>(
        (const T*)x, q, scale, (T*)out, M, K, N, NP, BK);
    return (int)cudaGetLastError();
  }
  if (BK != kTK) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(__nv_bfloat16) * (kTM + kTN) * kTStride;
  cudaError_t e = cudaFuncSetAttribute(
      int8_matmul_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((NP + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  int8_matmul_tiled_kernel<T><<<grid, 256, smem, stream>>>(
      (const T*)x, q, scale, (T*)out, M, K, N, NP);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16, m >= 64: wgmma with the int8 A operand widened in registers
// ---------------------------------------------------------------------------
constexpr int kGwCols = 128;     // weight columns a CTA (2 warpgroups x 64)
constexpr int kGwK = 64;         // K a stage: one 128-byte row of x
constexpr int kGwStages = 4;
constexpr int kGwThreads = 384;  // consumer warpgroups 0-1, producer 2
constexpr int kGwGroup = 8;      // row tiles a raster group

template <int BN>
struct GwSmem {
  static constexpr int kX = BN * kGwK * 2;        // [BN][64] bf16
  static constexpr int kQ = kGwK * kGwCols;       // [64][128] int8
  static constexpr int kStage = kX + kQ;          // 1,024-byte multiples
  static constexpr int kRing = kGwStages * kStage;
  static constexpr int kOutRow = 64 + 8;          // a staged output row of
                                                  // a warpgroup (bf16)
  static constexpr int kOut = 2 * BN * kOutRow * 2;
  static constexpr int kBytes = kRing + 2 * kGwStages * 8 + 1024;
  static_assert(kOut <= kRing && kX % 1024 == 0, "layout");
};

template <int BN>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc) {
  if constexpr (BN == 128) wgmma_m64n128k16_rs(d, a, desc);
  else wgmma_m64n256k16_rs(d, a, desc);
}

template <int BN>
__global__ void __launch_bounds__(kGwThreads, 1) int8_matmul_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmap_x,
    const __grid_constant__ CUtensorMap tmap_q,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
    int M, int K, int N, int NP) {
  using L = GwSmem<BN>;
  extern __shared__ unsigned char smraw[];
  // the swizzled tiles want 1,024-byte alignment
  unsigned char* smem = smraw + ((1024 - (smem_addr(smraw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kRing);
  uint64_t* empty = full + kGwStages;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  // grouped raster: kGwGroup row tiles for each column tile in turn
  const int ntm = (M + BN - 1) / BN, ntn = (NP + kGwCols - 1) / kGwCols;
  const int per_group = kGwGroup * ntn, pid = blockIdx.x;
  const int first = pid / per_group * kGwGroup;
  const int gm = min(kGwGroup, ntm - first), idx = pid % per_group;
  const int m0 = (first + idx % gm) * BN, n0 = idx / gm * kGwCols;
  const int nk = (K + kGwK - 1) / kGwK;
  if (tid == 0) {
    for (int s = 0; s < kGwStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);      // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wid >= 8) {
    // producer warpgroup: one thread issues the TMA loads
    setmaxnreg_dec<40>();
    if (wid == 8 && lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kGwStages;
        if (kt >= kGwStages) mbar_wait(empty + s, (kt / kGwStages - 1) & 1);
        unsigned char* st = smem + s * L::kStage;
        mbar_expect_tx(full + s, L::kStage);
        tma_load_2d(st, &tmap_x, full + s, kt * kGwK, m0);
        tma_load_2d(st + L::kX, &tmap_q, full + s, n0, kt * kGwK);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = wid >> 2, wl = wid & 3, g = lane >> 2, t4 = lane & 3;
    const int chunk = wg * 4 + wl;   // the warp's 16 columns: a 16-byte
                                     // chunk of the 128-byte q rows
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kGwStages;
      mbar_wait(full + s, (kt / kGwStages) & 1);
      __syncwarp();
      const unsigned char* st = smem + s * L::kStage;
      const unsigned char* qs = st + L::kX;
      // A: int8 pairs by ldmatrix.trans (matrices k 0-7, .., 24-31 of the
      // warp's 16 columns; the swizzle moves chunk c of row k to c ^ k % 8)
      uint32_t af[4][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 32 * h + lane;
        uint32_t raw[4];
        ldsm_x4_trans(raw, qs + k * kGwCols + ((chunk ^ (k & 7)) << 4));
        i8_pairs_to_bf16(raw[0], af[2 * h]);
        i8_pairs_to_bf16(raw[1], af[2 * h] + 2);
        i8_pairs_to_bf16(raw[2], af[2 * h + 1]);
        i8_pairs_to_bf16(raw[3], af[2 * h + 1] + 2);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      wgmma_fence();
      const uint64_t desc = wgmma_desc_k128(st);
#pragma unroll
      for (int kk = 0; kk < kGwK / 16; ++kk)
        wgmma_rs<BN>(acc, af[kk], desc + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    // epilogue: accumulator (A row g / g + 8 = column 2g / 2g + 1 of the
    // warp's 16, x row 8j + 2 t4 + e % 2) * scale, cast, staged per
    // warpgroup [BN][64] through the ring, then 16-byte stores
    bar_sync(1, 256);   // both warpgroups are done with the ring
    __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem) +
                        wg * BN * L::kOutRow;
    const int lc = wl * 16 + 2 * g, col = n0 + wg * 64 + lc;
    const float s0 = col < N ? scale[col] : 0.f;
    const float s1 = col + 1 < N ? scale[col + 1] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int r = 8 * j + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(os + r * L::kOutRow + lc) =
          __floats2bfloat162_rn(acc[4 * j] * s0, acc[4 * j + 2] * s1);
      *reinterpret_cast<__nv_bfloat162*>(os + (r + 1) * L::kOutRow + lc) =
          __floats2bfloat162_rn(acc[4 * j + 1] * s0, acc[4 * j + 3] * s1);
    }
    bar_sync(2 + wg, 128);
    for (int i = tid & 127; i < BN * 8; i += 128) {
      const int r = i >> 3, c = (i & 7) * 8;
      const int row = m0 + r, cc = n0 + wg * 64 + c;
      if (row < M && cc < NP)
        *reinterpret_cast<uint4*>(out + (size_t)row * NP + cc) =
            *reinterpret_cast<const uint4*>(os + r * L::kOutRow + c);
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (the library links no libcuda)
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 2-d tensor map [rows][cols] (cols innermost, row stride ld elements)
// with a box of [box_rows][box_cols], 128-byte swizzle
static bool encode_2d(CUtensorMap* map, CUtensorMapDataType type,
                      int elem_bytes, const void* base, int rows, int cols,
                      int ld, int box_rows, int box_cols) {
  const EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)ld * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dim, stride, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_int8_matmul_wgmma(const void* x, const int8_t* q,
                             const float* scale, void* out, int M, int K,
                             int N, int NP, cudaStream_t stream) {
  using L = GwSmem<BN>;
  CUtensorMap tx, tq;
  if (!encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, K, BN,
                 kGwK) ||
      !encode_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, K, NP, NP, kGwK,
                 kGwCols))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      int8_matmul_wgmma_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((M + BN - 1) / BN) * ((NP + kGwCols - 1) / kGwCols);
  int8_matmul_wgmma_kernel<BN><<<tiles, kGwThreads, L::kBytes, stream>>>(
      tx, tq, scale, (__nv_bfloat16*)out, M, K, N, NP);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, m < 64: the tensor-core weight stream, K split into ordered slices
// ---------------------------------------------------------------------------
using I8Stream = WsArgs<int8_t, 1, 1>;

template <int NG, int S>
__global__ void __launch_bounds__(kWsThreads) int8_matmul_stream_kernel(
    I8Stream a, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part, int N,
    int NP) {
  extern __shared__ __align__(16) unsigned char smem[];
  float acc[1][NG][4] = {};
  ws_mainloop<int8_t, 1, 1, NG, S>(a, smem, acc);
  const int wid = threadIdx.x >> 5, ctile = wid % a.cw;
  const int rs = wid / a.cw, nrs = 8 / a.cw, ngt = (a.m + 7) / 8;
  const int C = 16 * a.cw, c0 = blockIdx.x * C;
  const int lc = ws_col<int8_t>(ctile, 0), col = c0 + lc;  // and col + 1
  if (gridDim.y > 1) {
    // a K slice: its f32 partial, added in slice order by the reduce
    float* p = part + (size_t)blockIdx.y * a.m * NP;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int ng = rs + i * nrs;
      if (ng >= ngt) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = ws_row(ng, e);
        if (row < a.m && col < NP)
          *reinterpret_cast<float2*>(p + (size_t)row * NP + col) =
              make_float2(acc[0][i][e], acc[0][i][e + 2]);
      }
    }
    return;
  }
  // one slice: scale, cast, 16-byte stores through shared memory
  __syncthreads();
  const int orow = C + 8;
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  const float s0 = col < N ? scale[col] : 0.f;
  const float s1 = col + 1 < N ? scale[col + 1] : 0.f;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int ng = rs + i * nrs;
    if (ng >= ngt) break;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<__nv_bfloat162*>(os + ws_row(ng, e) * orow + lc) =
          __floats2bfloat162_rn(acc[0][i][e] * s0, acc[0][i][e + 2] * s1);
  }
  __syncthreads();
  const int cc = C / 8;
  for (int i = threadIdx.x; i < 8 * ngt * cc; i += kWsThreads) {
    const int r = i / cc, c = (i % cc) * 8;
    if (r < a.m && c0 + c < NP)
      *reinterpret_cast<uint4*>(out + (size_t)r * NP + c0 + c) =
          *reinterpret_cast<const uint4*>(os + r * orow + c);
  }
}

// the K slices' partials [ns][M][NP] added in slice order, scaled and cast
__global__ void int8_matmul_reduce_kernel(const float* __restrict__ part,
                                          const float* __restrict__ scale,
                                          __nv_bfloat16* __restrict__ out,
                                          int M, int N, int NP, int ns) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * NP) return;
  const int col = i % NP;
  float a = 0.f;
  for (int s = 0; s < ns; ++s) a += part[(size_t)s * M * NP + i];
  out[i] = __float2bfloat16(a * (col < N ? scale[col] : 0.f));
}

// kernel pointers by NG; the ring is 4 stages deep (ops/weight_stream.py
// ring: m < 64 rows of x and one int8 weight never take another depth)
static auto stream_kernel(int ng, int s)
    -> decltype(&int8_matmul_stream_kernel<1, 4>) {
  if (s != 4) return nullptr;
  return ng == 1 ? &int8_matmul_stream_kernel<1, 4>
         : ng == 2 ? &int8_matmul_stream_kernel<2, 4>
         : ng == 4 ? &int8_matmul_stream_kernel<4, 4> : nullptr;
}

int launch_int8_matmul_stream(const void* x, const int8_t* q,
                              const float* scale, void* out, float* part,
                              int M, int K, int N, int NP, int cw, int ng,
                              int stages, int kslice, cudaStream_t stream) {
  const int ngt = (M + 7) / 8;
  auto kernel = stream_kernel(ng, stages);
  if (kernel == nullptr || (cw != 1 && cw != 2 && cw != 4 && cw != 8) ||
      (ngt + 8 / cw - 1) / (8 / cw) > ng || kslice <= 0 ||
      kslice % kWsK != 0)
    return (int)cudaErrorInvalidValue;
  I8Stream a;
  a.w[0] = q;
  a.x[0] = (const __nv_bfloat16*)x;
  a.ldw = NP, a.ldx = K, a.m = M, a.K = K, a.cw = cw, a.kslice = kslice;
  const int ns = (K + kslice - 1) / kslice;
  if (ns > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = stages * ws_stage_bytes<int8_t, 1, 1>(cw, M);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((NP + 16 * cw - 1) / (16 * cw), ns);
  kernel<<<grid, kWsThreads, smem, stream>>>(
      a, scale, (__nv_bfloat16*)out, part, N, NP);
  e = cudaGetLastError();
  if (e != cudaSuccess || ns == 1) return (int)e;
  int8_matmul_reduce_kernel<<<(M * NP + 255) / 256, 256, 0, stream>>>(
      part, scale, (__nv_bfloat16*)out, M, N, NP, ns);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8_matmul_t: the transposed form, the dx of a frozen int8 weight
//   out[m, k] = sum_n bf16(g[m, n] * scale[n]) * bf16(q[k, n])   (f32 sums)
// g [M, N] f32/bf16 (rows 16-byte aligned), q [K, NP] int8 in its stored
// layout, scale [NS] f32 (columns n >= NS count 0), out [M, K] in g's dtype.
//
// Replaces the TPU kernel spt_proto_tpu/ops/pallas/int8_matmul.py
// int8_matmul_t (_kernel_t), with its numerics: g scaled in f32 and rounded
// to bf16, q converted to bf16 (exact), f32 products summed per 256-column
// chunk of N (the TPU kernel's block_n), the chunk partials added to the
// running sum in ascending order, one cast to g's dtype at the end.
//
// Bound on the H100: operations, 2 M K N bf16 products (LLaMA-7B's gate dx
// at M = 2,048: 185 GFLOP, 187 us at 989 TFLOP/s); the int8 weight is read
// once per 128-row block of g, mostly from L2.
//
// Design: an "NT" product, the contraction index n contiguous in both g and
// q, so both tiles are copied as they are stored. CTA output tiles of 128
// rows of g x kK rows of q, 8 warps of 64 x kK / 4 with f32 accumulators
// in registers (one CTA an SM). A cp.async ring walks n in kN-column steps;
// a stage holds the raw g tile (g's dtype), the raw int8 q tile and the
// scale slice, zero-filled past M, K, N and NS. Each landed stage is
// converted in shared memory into bf16 operand tiles (g * scale rounded to
// bf16; int8 -> bf16, exact, by a byte permute) in one of two buffers while
// the warps run mma.sync m16n8k16 from ldmatrix on the other, in pieces
// between the step's k16 products: one __syncthreads a step. The output
// tile is staged through shared memory for 16-byte stores. Two
// configurations by g's dtype:
// - bf16 (the training path): kK 256, so a column of the tile costs
//   128 x 2 + 256 bytes of copies for 2 x 128 x 256 products, and warp
//   tiles of 64 x 64; the f32 sums run over all of N in one fragment. The
//   TPU kernel's 256-column chunk partials would double the accumulators;
//   without them the f32 sums part from the twin's by up to 7.4e-5 (the
//   f32 case below), far inside a bf16 step of the output.
// - f32: kK 128, warp tiles 64 x 32, and the chunk partials kept (a fresh
//   fragment per 256 columns added to the running one, as the twin): one
//   fragment over all of N parted from the twin by up to 7.4e-5 at
//   LLaMA-7B's gate shape, past the f32 bound (1e-5 + 1e-5 |x|).
constexpr int kXM = 128;             // CTA tile rows of g
constexpr int kXChunk = 256;         // int8_matmul.py block_n
constexpr int kXThreads = 256;       // 8 warps, 2 x 4

template <typename T> struct XCfg;
template <> struct XCfg<__nv_bfloat16> {   // shared memory 210 KB
  static constexpr int kK = 256, kN = 64, kStages = 3;
  static constexpr bool kChunked = false;
};
template <> struct XCfg<float> {           // shared memory 123 KB
  static constexpr int kK = 128, kN = 32, kStages = 4;
  static constexpr bool kChunked = true;
};

// byte layout of the kernel's dynamic shared memory
template <typename T>
struct XSmem {
  static constexpr int kK = XCfg<T>::kK, kN = XCfg<T>::kN;
  static constexpr int kStages = XCfg<T>::kStages;
  static constexpr int kRow = kN + 8;   // bf16 a converted row (ldmatrix
                                        // addresses in distinct banks)
  static constexpr int kOutRow = kK + 8;   // elements a staged output row
  static constexpr int kG = kXM * kN * (int)sizeof(T);   // raw g tile
  static constexpr int kQ = kK * kN;                      // raw q tile
  static constexpr int kStage = kG + kQ + kN * 4;         // + scale slice
  static constexpr int kRing = kStages * kStage;
  static constexpr int kConv = (kXM + kK) * kRow;         // bf16, a buffer
  static constexpr int kMain = kRing + 2 * kConv * 2;
  static constexpr int kOut = kXM * kOutRow * (int)sizeof(T);
  static constexpr int kBytes = kMain > kOut ? kMain : kOut;
  static_assert(kXChunk % kN == 0, "whole steps a chunk");
};

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

// four int8 (one word) -> two bf16x2, exactly: byte b becomes the f32
// 2^23 + (b ^ 0x80), less 2^23 + 128, an integer of at most 8 bits whose
// upper half is its bf16
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t* out) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
        8388736.f);
  out[0] = __byte_perm(f[0], f[1], 0x7632);
  out[1] = __byte_perm(f[2], f[3], 0x7632);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <bool kFirst, typename A>
__device__ __forceinline__ A& pick(A& a, A& b) {
  if constexpr (kFirst) return a;
  else return b;
}

template <typename T>
__global__ void __launch_bounds__(kXThreads) int8_matmul_t_kernel(
    const T* __restrict__ g, const int8_t* __restrict__ q,
    const float* __restrict__ scale, T* __restrict__ out, int M, int K,
    int N, int NS, int NP) {
  using L = XSmem<T>;
  using bf16 = __nv_bfloat16;
  constexpr int kXK = L::kK, kN = L::kN, kStages = L::kStages;
  constexpr int kRow = L::kRow, kXOut = L::kOutRow;
  constexpr int kWK = kXK / 4, kNT = kWK / 8;   // warp tile 64 x kWK
  constexpr int kGC = 16 / sizeof(T);   // g elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* conv = reinterpret_cast<bf16*>(smem + L::kRing);
                                        // [2][g, q][kXM + kXK][kRow]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gr = lane >> 2, tig = lane & 3;
  const int wm = w & 1, wk = w >> 1;
  const int m0 = blockIdx.y * kXM, k0 = blockIdx.x * kXK;
  const int n_steps = (N + kN - 1) / kN;

  auto load = [&](int j) {
    unsigned char* st = smem + (j % kStages) * L::kStage;
    const int n0 = j * kN;
    constexpr int kGRow = kN / kGC, kQRow = kN / 16;
    static_assert(kXM * kGRow % kXThreads == 0 &&
                  kXK * kQRow % kXThreads == 0, "whole copies a thread");
#pragma unroll
    for (int it = 0; it < kXM * kGRow / kXThreads; ++it) {
      const int i = it * kXThreads + tid, r = i / kGRow;
      const int c = (i % kGRow) * kGC;
      const bool ok = m0 + r < M && n0 + c < N;   // N % kGC == 0
      cp_async16_zfill(st + (r * kN + c) * sizeof(T),
                       ok ? g + (size_t)(m0 + r) * N + n0 + c : g,
                       ok ? 16 : 0);
    }
    // a 16-column run starting before N ends inside NP (NP % 16 == 0)
#pragma unroll
    for (int it = 0; it < kXK * kQRow / kXThreads; ++it) {
      const int i = it * kXThreads + tid, r = i / kQRow;
      const int c = (i % kQRow) * 16;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16_zfill(st + L::kG + r * kN + c,
                       ok ? q + (size_t)(k0 + r) * NP + n0 + c : q,
                       ok ? 16 : 0);
    }
    if (tid < kN) {
      const bool ok = n0 + tid < NS;
      cp_async4_zfill(st + L::kG + L::kQ + tid * 4,
                      ok ? scale + n0 + tid : scale, ok ? 4 : 0);
    }
  };

  // converts piece `piece` of stage j: the copies it of each loop with
  // it % (kN / 16) == part, so that a step's conversion interleaves with
  // its k16 products
  auto convert = [&](int j, int piece) {
    const unsigned char* st = smem + (j % kStages) * L::kStage;
    const T* gs = reinterpret_cast<const T*>(st);
    const int8_t* qs = reinterpret_cast<const int8_t*>(st + L::kG);
    const float* ss = reinterpret_cast<const float*>(st + L::kG + L::kQ);
    bf16* gb = conv + (j & 1) * L::kConv;
    bf16* qb = gb + kXM * kRow;
    constexpr int kG8 = kN / 8, kQ16 = kN / 16;
#pragma unroll
    for (int it = 0; it < kXM * kG8 / kXThreads; ++it) {
      if (it % (kN / 16) != piece) continue;
      const int i = it * kXThreads + tid, r = i / kG8, c = (i % kG8) * 8;
      float x[8], sc[8];
      load8(gs + r * kN + c, x);
      load8(ss + c, sc);
      uint4 pk;
      pk.x = pack_bf16(x[0] * sc[0], x[1] * sc[1]);
      pk.y = pack_bf16(x[2] * sc[2], x[3] * sc[3]);
      pk.z = pack_bf16(x[4] * sc[4], x[5] * sc[5]);
      pk.w = pack_bf16(x[6] * sc[6], x[7] * sc[7]);
      *reinterpret_cast<uint4*>(gb + r * kRow + c) = pk;
    }
#pragma unroll
    for (int it = 0; it < kXK * kQ16 / kXThreads; ++it) {
      if (it % (kN / 16) != piece) continue;
      const int i = it * kXThreads + tid, r = i / kQ16, c = (i % kQ16) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(qs + r * kN + c);
      uint32_t b[8];
      i8x4_to_bf16(raw.x, b);
      i8x4_to_bf16(raw.y, b + 2);
      i8x4_to_bf16(raw.z, b + 4);
      i8x4_to_bf16(raw.w, b + 6);
      *reinterpret_cast<uint4*>(qb + r * kRow + c) =
          make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(qb + r * kRow + c + 8) =
          make_uint4(b[4], b[5], b[6], b[7]);
    }
  };

  // the running sums and, chunked, the current chunk's
  float acc[4][kNT][4] = {}, part[4][kNT][4] = {};
  auto& sum = pick<XCfg<T>::kChunked>(part, acc);
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (j < n_steps) load(j);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();   // stage 0 has landed
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) convert(0, kk);
  for (int j = 0; j < n_steps; ++j) {
    cp_async_wait<kStages - 2>();   // stage j + 1 has landed
    __syncthreads();   // ... for every thread; stage j converted, j - 1's
                       // buffer and stage j's ring slot read out
    if (j + kStages < n_steps) load(j + kStages);
    cp_async_commit();
    const bf16* gb = conv + (j & 1) * L::kConv;
    const bf16* qb = gb + kXM * kRow;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      if (j + 1 < n_steps) convert(j + 1, kk);
      uint32_t af[4][4], bq[kNT / 2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(af[i], gb + a_off(wm * 64 + i * 16, kk * 16, kRow));
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np)
        ldsm_x4(bq[np], qb + bt_off(wk * kWK + np * 16, kk * 16, kRow));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          mma_bf16_16816(sum[i][2 * np], af[i], bq[np]);
          mma_bf16_16816(sum[i][2 * np + 1], af[i], bq[np] + 2);
        }
    }
    if constexpr (XCfg<T>::kChunked) {
      if ((j + 1) % (kXChunk / kN) == 0 || j + 1 == n_steps) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][jn][e] += part[i][jn][e];
              part[i][jn][e] = 0.f;
            }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring and the buffers
  T* os = reinterpret_cast<T*>(smem);   // [kXM][kXOut]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jn = 0; jn < kNT; ++jn) {
      const int r = wm * 64 + i * 16 + gr, c = wk * kWK + jn * 8 + tig * 2;
      store2(os + r * kXOut + c, acc[i][jn][0], acc[i][jn][1]);
      store2(os + (r + 8) * kXOut + c, acc[i][jn][2], acc[i][jn][3]);
    }
  __syncthreads();
  constexpr int kE = 16 / sizeof(T), kCR = kXK / kE;   // copies a row
  const bool vec = K % kE == 0;   // out's rows 16-byte aligned
  for (int i = tid; i < kXM * kCR; i += kXThreads) {
    const int r = i / kCR, c = (i % kCR) * kE;
    const int row = m0 + r, col = k0 + c;
    if (row >= M || col >= K) continue;
    T* dst = out + (size_t)row * K + col;
    const T* src = os + r * kXOut + c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kE && col + e < K; ++e) dst[e] = src[e];
    }
  }
}

template <typename T>
int launch_int8_matmul_t(const void* g, const int8_t* q, const float* scale,
                         void* out, int M, int K, int N, int NS, int NP,
                         cudaStream_t stream) {
  constexpr int smem = XSmem<T>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      int8_matmul_t_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int kXK = XCfg<T>::kK;
  dim3 grid((K + kXK - 1) / kXK, (M + kXM - 1) / kXM);
  int8_matmul_t_kernel<T><<<grid, kXThreads, smem, stream>>>(
      (const T*)g, q, scale, (T*)out, M, K, N, NS, NP);
  return (int)cudaGetLastError();
}

}  // namespace spt

extern "C" int spt_int8_matmul(int dtype, const void* x, const void* q,
                               const void* scale, void* out, int M, int K,
                               int N, int NP, int BK, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_int8_matmul<__nv_bfloat16>
                               : spt::launch_int8_matmul<float>;
  return f(x, (const int8_t*)q, (const float*)scale, out, M, K, N, NP, BK,
           (cudaStream_t)stream);
}

extern "C" int spt_int8_matmul_t(int dtype, const void* g, const void* q,
                                 const void* scale, void* out, int M, int K,
                                 int N, int NS, int NP, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_int8_matmul_t<__nv_bfloat16>
                               : spt::launch_int8_matmul_t<float>;
  return f(g, (const int8_t*)q, (const float*)scale, out, M, K, N, NS, NP,
           (cudaStream_t)stream);
}

// bf16 x only. route 1: int8_matmul_wgmma_kernel (m >= 64), p0 = BN (128 or
// 256); route 2: the weight stream (m < 64), p0 = cw, p1 = NG, p2 = the
// ring's stages, p3 = the K slice (part: [K / slice][M][NP] f32 when there
// are several). The plan is ops/int8_matmul.py int8_matmul_plan's. x's rows
// and q 16-byte aligned, K % 8 == 0, NP % 16 == 0 (the wrapper checks).
extern "C" int spt_int8_matmul_tc(const void* x, const void* q,
                                  const void* scale, void* out, void* part,
                                  int M, int K, int N, int NP, int route,
                                  int p0, int p1, int p2, int p3,
                                  void* stream) {
  if (K % 8 != 0 || NP % 16 != 0 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)q % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) {
    if (p0 == 128)
      return spt::launch_int8_matmul_wgmma<128>(
          x, (const int8_t*)q, (const float*)scale, out, M, K, N, NP, st);
    if (p0 == 256)
      return spt::launch_int8_matmul_wgmma<256>(
          x, (const int8_t*)q, (const float*)scale, out, M, K, N, NP, st);
    return (int)cudaErrorInvalidValue;
  }
  if (route == 2)
    return spt::launch_int8_matmul_stream(
        x, (const int8_t*)q, (const float*)scale, out, (float*)part, M, K, N,
        NP, p0, p1, p2, p3, st);
  return (int)cudaErrorInvalidValue;
}
