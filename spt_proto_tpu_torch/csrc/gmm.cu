// Grouped matmuls over rows sorted by group (the routed FFN's
// flop-proportional dispatch, ffn_impl='gmm'):
//   gmm:  out[r, :] = lhs[r, :] @ rhs[g(r)]          rhs [G, K, N] (or the
//         transposed layout [G, N, K]: the wrapper passes element strides)
//   tgmm: out[g] = lhs[rows of g]^T @ rhs[rows of g]  -> [G, K, N] f32
// Rows are grouped by `sizes` [G] int32: group g owns rows
// [sum(sizes[:g]), sum(sizes[:g + 1])).
//
// Replaces the stock TPU kernels jax/experimental/pallas/ops/tpu/megablox
// gmm.py gmm and tgmm (the custom VJP of megablox ops.py), which
// spt_proto_tpu/ops/routed_ffn.py calls: f32 accumulation, the output in
// the caller's dtype (gmm) or f32 (tgmm).
//
// Bound on the H100: operations for the routed FFN's products (OPT-125M's
// tune shape: 8,192 sorted rows x 768 x 768 a product, 9.7 GFLOP, 9.8 us
// at 989 TFLOP/s in bf16); the LoRA products (k or n = 16) move more bytes
// than they multiply.
//
// Design. The tile schedule is built on the device from `sizes`, as
// megablox's make_group_metadata does, never read back to the host: the
// grid is an upper bound, ceil(M / 64) + G row tiles (each group boundary
// inside a tile adds one), and the first thread of each CTA walks the
// groups' cumulative sizes to find its (group, 64-row tile); CTAs past the
// last tile exit. A row tile may straddle two groups: each CTA loads and
// stores only its group's rows, so the two CTAs of a shared tile write
// disjoint rows. tgmm has one CTA per (group, 64-row k tile, 64-column n
// tile) that walks the group's rows in chunks of 32, so every output is
// written once: no atomics, deterministic; an empty group writes zeros.
// bf16 multiplies through warp-level mma.sync m16n8k16 (8 warps of 32 x
// 16), f32 through CUDA-core FMA (no TF32; 16 x 16 threads of 4 x 4),
// both from 64 x 32 tiles staged in shared memory; no cp.async pipeline,
// no TMA / wgmma yet: right first, fast in a later change.
#include "common.cuh"

namespace spt {

constexpr int kGM = 64, kGN = 64, kGK = 32, kGThreads = 256;

template <typename T>
__host__ __device__ constexpr int gstride() {  // per shared row, + pad
  return kGK + (sizeof(T) == 2 ? 8 : 1);
}

// acc[16] += As[kGM][kGK] @ Bs[kGN][kGK]^T (both stored row by output
// index, the contraction contiguous)
template <typename T>
__device__ __forceinline__ void tile_product(const T* As, const T* Bs,
                                             float* acc) {
  constexpr int S = gstride<T>();
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 2) {
    const int lane = tid & 31, wid = tid >> 5;
    const int gr = lane >> 2, tig = lane & 3;
    const int wm = wid % 2, wn = wid / 2;
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      uint32_t af[2][4], bf[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* ap = As + (wm * 32 + i * 16 + gr) * S + kk + tig * 2;
        af[i][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[i][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * S);
        af[i][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * S + 8);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const T* bp = Bs + (wn * 16 + j * 8 + gr) * S + kk + tig * 2;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(bp);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(bp + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mma_bf16_16816(acc + (i * 2 + j) * 4, af[i], bf[j]);
    }
  } else {
    const int tr = tid / 16, tc = tid % 16;
#pragma unroll 4
    for (int kk = 0; kk < kGK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = to_f(As[(tr * 4 + i) * S + kk]);
        b[i] = to_f(Bs[(tc * 4 + i) * S + kk]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i * 4 + j] = fmaf(a[i], b[j], acc[i * 4 + j]);
    }
  }
}

// (row, column) in the 64 x 64 tile of tile_product's accumulator idx
template <typename T>
__device__ __forceinline__ void tile_coord(int idx, int& r, int& c) {
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 2) {
    const int lane = tid & 31, wid = tid >> 5;
    const int gr = lane >> 2, tig = lane & 3;
    const int i = idx / 8, j = (idx / 4) % 2, e = idx % 4;
    r = (wid % 2) * 32 + i * 16 + gr + (e >= 2 ? 8 : 0);
    c = (wid / 2) * 16 + j * 8 + tig * 2 + (e & 1);
  } else {
    r = (tid / 16) * 4 + idx / 4;
    c = (tid % 16) * 4 + idx % 4;
  }
}

// rhs element (g, k, n) lies at g * s0 + k * sk + n * sn
template <typename T, typename O>
__global__ void __launch_bounds__(kGThreads) gmm_kernel(
    const T* __restrict__ lhs, const T* __restrict__ rhs,
    const int* __restrict__ sizes, O* __restrict__ out, int M, int KD,
    int N, int G, long long s0, long long sk, long long sn) {
  constexpr int S = gstride<T>();
  __shared__ __align__(16) T As[kGM * S];
  __shared__ __align__(16) T Bs[kGN * S];
  __shared__ int info[3];
  const int tid = threadIdx.x;
  if (tid == 0) {
    int t = blockIdx.x, start = 0, grp = -1, lo = 0, hi = 0, m0 = 0;
    for (int g = 0; g < G; ++g) {
      const int end = start + sizes[g];
      if (end > start) {
        const int first = start / kGM, cnt = (end - 1) / kGM - first + 1;
        if (t < cnt) {
          grp = g;
          m0 = (first + t) * kGM;
          lo = max(m0, start);
          hi = min(min(m0 + kGM, end), M);
          break;
        }
        t -= cnt;
      }
      start = end;
    }
    info[0] = grp < 0 || lo >= hi ? -1 : grp;
    info[1] = lo;
    info[2] = hi;
  }
  __syncthreads();
  const int grp = info[0], lo = info[1], hi = info[2];
  if (grp < 0) return;                         // past the last tile
  const int m0 = lo / kGM * kGM, n0 = blockIdx.y * kGN;
  const T* B = rhs + (long long)grp * s0;
  const T zero = from_f<T>(0.f);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < KD; k0 += kGK) {
    for (int i = tid; i < kGM * kGK; i += kGThreads) {
      const int r = i / kGK, c = i % kGK, row = m0 + r, k = k0 + c;
      As[r * S + c] = row >= lo && row < hi && k < KD
                          ? lhs[(long long)row * KD + k] : zero;
    }
    // read B along whichever of its indices is contiguous
    for (int i = tid; i < kGN * kGK; i += kGThreads) {
      const int c = sn == 1 ? i / kGN : i % kGK;
      const int nn = sn == 1 ? i % kGN : i / kGK;
      const int k = k0 + c, n = n0 + nn;
      Bs[nn * S + c] = k < KD && n < N ? B[k * sk + n * sn] : zero;
    }
    __syncthreads();
    tile_product<T>(As, Bs, acc);
    __syncthreads();
  }
#pragma unroll
  for (int idx = 0; idx < 16; ++idx) {
    int r, c;
    tile_coord<T>(idx, r, c);
    const int row = m0 + r, col = n0 + c;
    if (row >= lo && row < hi && col < N)
      out[(long long)row * N + col] = from_f<O>(acc[idx]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kGThreads) tgmm_kernel(
    const T* __restrict__ lhs, const T* __restrict__ rhs,
    const int* __restrict__ sizes, float* __restrict__ out, int M, int KD,
    int N) {
  constexpr int S = gstride<T>();
  __shared__ __align__(16) T As[kGM * S];     // [k][row]
  __shared__ __align__(16) T Bs[kGN * S];     // [n][row]
  __shared__ int info[2];
  const int tid = threadIdx.x, grp = blockIdx.z;
  const int k0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  if (tid == 0) {
    int start = 0;
    for (int g = 0; g < grp; ++g) start += sizes[g];
    info[0] = min(start, M);
    info[1] = min(start + sizes[grp], M);
  }
  __syncthreads();
  const int lo = info[0], hi = info[1];
  const T zero = from_f<T>(0.f);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int r0 = lo; r0 < hi; r0 += kGK) {
    for (int i = tid; i < kGM * kGK; i += kGThreads) {
      const int c = i / kGM, kk = i % kGM, row = r0 + c, k = k0 + kk;
      As[kk * S + c] = row < hi && k < KD ? lhs[(long long)row * KD + k]
                                          : zero;
    }
    for (int i = tid; i < kGN * kGK; i += kGThreads) {
      const int c = i / kGN, nn = i % kGN, row = r0 + c, n = n0 + nn;
      Bs[nn * S + c] = row < hi && n < N ? rhs[(long long)row * N + n]
                                         : zero;
    }
    __syncthreads();
    tile_product<T>(As, Bs, acc);
    __syncthreads();
  }
#pragma unroll
  for (int idx = 0; idx < 16; ++idx) {
    int r, c;
    tile_coord<T>(idx, r, c);
    const int k = k0 + r, n = n0 + c;
    if (k < KD && n < N) out[((long long)grp * KD + k) * N + n] = acc[idx];
  }
}

template <typename T, typename O>
int launch_gmm(const void* lhs, const void* rhs, const int* sizes, void* out,
               int M, int KD, int N, int G, long long s0, long long sk,
               long long sn, cudaStream_t stream) {
  dim3 grid((M + kGM - 1) / kGM + G, (N + kGN - 1) / kGN);
  gmm_kernel<T, O><<<grid, kGThreads, 0, stream>>>(
      (const T*)lhs, (const T*)rhs, sizes, (O*)out, M, KD, N, G, s0, sk, sn);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tgmm(const void* lhs, const void* rhs, const int* sizes,
                float* out, int M, int KD, int N, int G,
                cudaStream_t stream) {
  dim3 grid((N + kGN - 1) / kGN, (KD + kGM - 1) / kGM, G);
  tgmm_kernel<T><<<grid, kGThreads, 0, stream>>>(
      (const T*)lhs, (const T*)rhs, sizes, out, M, KD, N);
  return (int)cudaGetLastError();
}

}  // namespace spt

// dtype: the inputs' (lhs and rhs share it); out_f32: 1 = f32 output, 0 =
// the inputs' dtype
extern "C" int spt_gmm(int dtype, int out_f32, const void* lhs,
                       const void* rhs, const void* sizes, void* out, int M,
                       int KD, int N, int G, long long s0, long long sk,
                       long long sn, void* stream) {
  using bf = __nv_bfloat16;
  auto f = dtype == spt::kBF16
               ? (out_f32 ? spt::launch_gmm<bf, float>
                          : spt::launch_gmm<bf, bf>)
               : spt::launch_gmm<float, float>;
  return f(lhs, rhs, (const int*)sizes, out, M, KD, N, G, s0, sk, sn,
           (cudaStream_t)stream);
}

extern "C" int spt_tgmm(int dtype, const void* lhs, const void* rhs,
                        const void* sizes, void* out, int M, int KD, int N,
                        int G, void* stream) {
  auto f = dtype == spt::kBF16 ? spt::launch_tgmm<__nv_bfloat16>
                               : spt::launch_tgmm<float>;
  return f(lhs, rhs, (const int*)sizes, (float*)out, M, KD, N, G,
           (cudaStream_t)stream);
}
