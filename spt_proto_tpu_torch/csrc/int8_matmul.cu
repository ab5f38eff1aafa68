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
// Design, two kernels behind one entry point:
// - skinny M (< 64), int8_matmul_skinny_kernel: a weight stream. Each CTA
//   owns 32 output columns for a block of 8 rows; its 256 threads are 2
//   column groups of 16 (one 16-byte load of 16 int8 columns per K row)
//   by 128 K-lanes. Per chunk the x rows are staged bf16-rounded in shared
//   memory, each thread sums its rows of the chunk in registers, the
//   K-lanes of a warp are added with shuffles and the 8 warps in a fixed
//   order, and that chunk partial is added to the thread's running sum.
// - large M, int8_matmul_tiled_kernel: 64 x 128 output tiles, 8 warps of
//   32 x 32, per 128-row chunk the x tile is staged as bf16 and the int8
//   tile converted to bf16 (exact) in shared memory, and warp-level
//   mma.sync m16n8k16 (bf16 in, f32 accumulate) sums the chunk into a
//   fresh fragment that is then added to the running one. No cp.async
//   pipeline, no TMA / wgmma yet: right first, fast in a later change.
#include "common.cuh"

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
