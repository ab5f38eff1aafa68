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

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

}  // namespace spt

extern "C" int spt_int8_matmul(int dtype, const void* x, const void* q,
                               const void* scale, void* out, int M, int K,
                               int N, int NP, int BK, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_int8_matmul<__nv_bfloat16>
                               : spt::launch_int8_matmul<float>;
  return f(x, (const int8_t*)q, (const float*)scale, out, M, K, N, NP, BK,
           (cudaStream_t)stream);
}
