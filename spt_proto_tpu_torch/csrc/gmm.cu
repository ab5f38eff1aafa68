// Grouped matmuls over rows sorted by group (the routed FFN's
// flop-proportional dispatch, ffn_impl='gmm'):
//   gmm:  out[r, :] = lhs[r, :] @ rhs[g(r)]          rhs [G, K, N] (or the
//         transposed layout [G, N, K]: the wrapper passes element strides)
//   tgmm: out[g] = lhs[rows of g]^T @ rhs[rows of g]  -> [G, K, N] f32
// Rows are grouped by `sizes` [G] int32: group g owns rows
// [sum(sizes[:g]), sum(sizes[:g + 1])), clipped to M as the twins clip.
//
// Replaces the stock TPU kernels jax/experimental/pallas/ops/tpu/megablox
// gmm.py gmm and tgmm (the custom VJP of megablox ops.py), which
// spt_proto_tpu/ops/routed_ffn.py calls: f32 accumulation, the output in
// the caller's dtype (gmm) or f32 (tgmm).
//
// Bound on the H100 at OPT-125M's tune shape (8,192 sorted rows, widths
// 768, LoRA rank 16): the wide products (x @ w1, h @ w2 and their dlhs,
// 9.7 GFLOP each) by operations, 9.8 us at 989 TFLOP/s in bf16; the LoRA
// products (n or k = 16) and both LoRA gradients (tgmm [4, 768, 16]) by
// bytes, the 12.6 MB of the 768-wide operand read or written once, 3.9 us
// at 3.35 TB/s.
//
// Every kernel builds its tile schedule on the device from `sizes`, as
// megablox's make_group_metadata does, never read back to the host: the
// grid is an upper bound, ceil(M / BM) + G row tiles (each group boundary
// inside a tile adds one), and the first thread of each CTA walks the
// groups' cumulative sizes to find its (group, BM-row tile). A row tile
// may straddle two groups: each CTA loads and stores only its group's
// rows, so the two CTAs of a shared tile write disjoint rows. Every output
// is written once, by one CTA: no atomics, deterministic.
//
// bf16 (the training path), on the tensor cores: mma.sync m16n8k16 with
// f32 sums, operands by ldmatrix from a ring of 16-byte cp.async copies
// (zero-filled past the group's rows, K and N).
// - gmm_tc_kernel<Tile, KMAJ>: lhs through ldmatrix; rhs either
//   N-contiguous ([k][n] tiles through ldmatrix.trans: x @ w1 through the
//   block view of fc1, h @ w2, h @ lora_left2) or K-contiguous ([n][k]
//   tiles through plain ldmatrix, KMAJ: transpose_rhs, so xl @
//   lora_right1^T and the backward's dlhs). The output tile goes through
//   shared memory to 16-byte stores of the group's own rows; rows past
//   every group are zeroed by the CTAs whose tiles hold them (the last
//   group's last tile, and the spare CTAs of the grid), so the output
//   needs no memset. Tile shapes, chosen by the wrapper from (K, N):
//   GmmNarrow16 / GmmNarrow32 for N <= 16 / 32 (64-row tiles N wide,
//   4 warps, a 6-stage ring: ~132 CTAs stream lhs once); GmmThin for
//   K <= 32 (one stage of 128 x 128 tiles; bound by writing the output);
//   GmmWide otherwise (96 x 128 tiles, 8 warps of 48 x 32, 64-deep
//   steps, 3 stages: two CTAs an SM, and at 8,192 rows 88 x 6 CTAs, two
//   full waves; it beat 128 x 128, 128 x 256, 256 x 128 and 64 x 128
//   tiles and 32-deep steps in trial builds on an H100).
// - tgmm_tc_kernel<Tile>: the contraction (the rows) split across CTAs.
//   Row tiles of R rows (the wrapper's choice) on the gmm schedule, a CTA
//   per (row tile, k tile, n tile) computing lhs[tile]^T @ rhs[tile]: A =
//   lhs^T by ldmatrix.trans from the row-major lhs tile (at_off), B = the
//   rhs tile by ldmatrix.trans, rows in 64- or 32-row steps through a
//   4-stage ring. A group of one tile is written to the output directly;
//   otherwise each tile writes an f32 partial [K, N] to a workspace
//   [tiles, K, N], and tgmm_reduce_kernel sums each group's partials in
//   tile order (and zeroes empty groups). TgmmNarrow16 / TgmmNarrow32 (64
//   x N output tiles, 4 warps) for N <= 16 / 32, TgmmWide (128 x 64, 4
//   warps of 64 x 32) otherwise.
//   R fills the card with the (k, n) tiles, or is a whole group where the
//   (k, n) tiles alone do (ops/gmm.py tgmm_plan).
// f32, and the shapes the bf16 kernels do not take (K or N not a multiple
// of 8, rhs strides or pointers not 16-byte aligned, an f32 output from
// bf16 inputs), run gmm_kernel / tgmm_kernel: 64 x 64 tiles staged one
// element a thread, CUDA-core FMA in f32 (no TF32; 16 x 16 threads of
// 4 x 4), mma.sync from 32-bit shared loads in bf16; tgmm_kernel a CTA
// per (group, 64-row k tile, 64-column n tile) walking the group's rows.
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

using bf16 = __nv_bfloat16;

// Tile shapes (ops/gmm.py names them by the codes of spt_gmm_tc /
// spt_tgmm_tc). gmm: BM x BN output tiles, BK-deep steps, warps of WM x WN.
struct GmmWide { static constexpr int kBM = 96, kBN = 128, kBK = 64,
                 kWM = 48, kWN = 32, kStages = 3; };
struct GmmNarrow16 { static constexpr int kBM = 64, kBN = 16, kBK = 64,
                     kWM = 16, kWN = 16, kStages = 6; };
struct GmmNarrow32 { static constexpr int kBM = 64, kBN = 32, kBK = 64,
                     kWM = 16, kWN = 32, kStages = 6; };
struct GmmThin { static constexpr int kBM = 128, kBN = 128, kBK = 32,
                 kWM = 64, kWN = 32, kStages = 1; };
// tgmm: BK x BN output tiles (k of lhs, n of rhs), BR rows a step, warps of
// WK x WN (ops/gmm.py TGMM_TILES mirrors BK, BN, BR)
struct TgmmWide { static constexpr int kBK = 128, kBN = 64, kBR = 32,
                  kWK = 64, kWN = 32, kStages = 3; };
struct TgmmNarrow16 { static constexpr int kBK = 64, kBN = 16, kBR = 64,
                      kWK = 16, kWN = 16, kStages = 4; };
struct TgmmNarrow32 { static constexpr int kBK = 64, kBN = 32, kBR = 64,
                      kWK = 16, kWN = 32, kStages = 4; };

template <class C> __host__ __device__ constexpr int gmm_threads() {
  return C::kBM / C::kWM * (C::kBN / C::kWN) * 32;
}
template <class C> __host__ __device__ constexpr int tgmm_threads() {
  return C::kBK / C::kWK * (C::kBN / C::kWN) * 32;
}

// gmm's dynamic shared memory: the ring of A [BM][BK] and B ([BN][BK]
// K-contiguous, [BK][BN] N-contiguous) tiles, rows padded by 8 elements
// (16 bytes) so that ldmatrix's eight row addresses fall in distinct banks;
// the output tile [BM][BN + 8] reuses it
template <class C, bool KMAJ>
struct GmmSmem {
  static constexpr int kARow = C::kBK + 8;
  static constexpr int kBRow = KMAJ ? C::kBK + 8 : C::kBN + 8;
  static constexpr int kA = C::kBM * kARow;
  static constexpr int kStage = kA + (KMAJ ? C::kBN : C::kBK) * kBRow;
  static constexpr int kORow = C::kBN + 8;
  static constexpr int kRing = C::kStages * kStage, kOut = C::kBM * kORow;
  static constexpr int kBytes = 2 * (kRing > kOut ? kRing : kOut);
};

// The group of row tile t: tiles of BM rows are counted group by group (a
// group's tiles are the BM-aligned tiles its rows touch)
struct RowTile {
  int grp;      // -1: past the last tile
  int lo, hi;   // the group's rows in the tile
  int cnt;      // the group's tiles
  int total;    // rows in all groups
  int n_tiles;  // tiles of all groups
};

__device__ RowTile find_row_tile(const int* sizes, int G, int M, int BM,
                                 int t) {
  RowTile rt{-1, 0, 0, 0, 0, 0};
  int start = 0, seen = 0;
  for (int g = 0; g < G; ++g) {
    const int end = min(start + sizes[g], M);
    if (end > start) {
      const int first = start / BM, cnt = (end - 1) / BM - first + 1;
      if (rt.grp < 0 && t >= seen && t < seen + cnt) {
        const int m0 = (first + t - seen) * BM;
        rt.grp = g;
        rt.lo = max(m0, start);
        rt.hi = min(m0 + BM, end);
        rt.cnt = cnt;
      }
      seen += cnt;
    }
    start = max(start, end);
  }
  rt.total = start;
  rt.n_tiles = seen;
  return rt;
}

// (index of its first tile, number of tiles) of group grp, as
// find_row_tile counts them
__device__ void group_tiles(const int* sizes, int M, int BM, int grp,
                            int& base, int& cnt) {
  int start = 0;
  base = cnt = 0;
  for (int g = 0; g <= grp; ++g) {
    const int end = min(start + sizes[g], M);
    const int c = end > start ? (end - 1) / BM - start / BM + 1 : 0;
    if (g == grp) cnt = c;
    else base += c;
    start = max(start, end);
  }
}

// rhs element (g, k, n) lies at g * s0 + k * sk + n * sn; KMAJ: sk == 1,
// else sn == 1. K, N, the other strides and the pointers are multiples of
// 16 bytes (the wrapper's rule).
template <class C, bool KMAJ>
__global__ void __launch_bounds__(gmm_threads<C>()) gmm_tc_kernel(
    const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
    const int* __restrict__ sizes, bf16* __restrict__ out, int M, int KD,
    int N, int G, long long s0, long long sk, long long sn) {
  using L = GmmSmem<C, KMAJ>;
  constexpr int BM = C::kBM, BN = C::kBN, BK = C::kBK, kS = C::kStages;
  constexpr int kThreads = gmm_threads<C>();
  constexpr int kMT = C::kWM / 16, kNP = C::kWN / 16;   // m16, n16 a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int info[5];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int wm = w % (BM / C::kWM), wn = w / (BM / C::kWM);
  if (tid == 0) {
    const RowTile rt = find_row_tile(sizes, G, M, BM, blockIdx.x);
    // rows past every group, zeroed here: after the last group's last
    // tile, by it; the tiles after that, by the spare CTAs in order
    int zlo = 0, zhi = 0;
    if (rt.grp < 0) {
      zlo = ((rt.total + BM - 1) / BM + (int)blockIdx.x - rt.n_tiles) * BM;
      zhi = min(zlo + BM, M);
    } else if (rt.hi == rt.total) {
      zlo = rt.hi;
      zhi = min(rt.lo / BM * BM + BM, M);
    }
    info[0] = rt.grp;
    info[1] = rt.lo;
    info[2] = rt.hi;
    info[3] = zlo;
    info[4] = zhi;
  }
  __syncthreads();
  const int grp = info[0], lo = info[1], hi = info[2];
  const int zlo = info[3], zhi = info[4];
  if (grp < 0 && zlo >= zhi) return;
  const int m0 = grp >= 0 ? lo / BM * BM : zlo, n0 = blockIdx.y * BN;
  constexpr int kORow = L::kORow;
  if (grp >= 0) {
    const bf16* B = rhs + (long long)grp * s0;
    const int n_steps = (KD + BK - 1) / BK;
    auto load = [&](int j) {
      bf16* as = smem + (j % kS) * L::kStage;
      bf16* bs = as + L::kA;
      const int k0 = j * BK;
      constexpr int kAC = BK / 8, kAN = BM * kAC;
#pragma unroll
      for (int it = 0; it < (kAN + kThreads - 1) / kThreads; ++it) {
        const int i = it * kThreads + tid;
        if (kAN % kThreads == 0 || i < kAN) {
          const int r = i / kAC, c = (i % kAC) * 8;
          const int row = m0 + r, k = k0 + c;
          const bool ok = row >= lo && row < hi && k < KD;
          cp_async16_zfill(as + r * L::kARow + c,
                           ok ? lhs + (long long)row * KD + k : lhs,
                           ok ? 16 : 0);
        }
      }
      // B along whichever of its indices is contiguous
      constexpr int kBC = (KMAJ ? BK : BN) / 8;
      constexpr int kBN_ = (KMAJ ? BN : BK) * kBC;
#pragma unroll
      for (int it = 0; it < (kBN_ + kThreads - 1) / kThreads; ++it) {
        const int i = it * kThreads + tid;
        if (kBN_ % kThreads == 0 || i < kBN_) {
          const int r = i / kBC, c = (i % kBC) * 8;
          const int k = k0 + (KMAJ ? c : r), n = n0 + (KMAJ ? r : c);
          const bool ok = k < KD && n < N;
          cp_async16_zfill(bs + r * L::kBRow + c,
                           ok ? B + (KMAJ ? n * sn + k : k * sk + n) : B,
                           ok ? 16 : 0);
        }
      }
    };
    float acc[kMT][2 * kNP][4] = {};
    auto compute = [&](int slot) {
      const bf16* as = smem + slot * L::kStage;
      const bf16* bs = as + L::kA;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[kMT][4], bq[kNP][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          ldsm_x4(af[i], as + a_off(wm * C::kWM + i * 16, kk * 16,
                                    L::kARow));
#pragma unroll
        for (int p = 0; p < kNP; ++p) {
          if constexpr (KMAJ)
            ldsm_x4(bq[p], bs + bt_off(wn * C::kWN + p * 16, kk * 16,
                                       L::kBRow));
          else
            ldsm_x4_trans(bq[p], bs + bn_off(kk * 16, wn * C::kWN + p * 16,
                                             L::kBRow));
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int p = 0; p < kNP; ++p) {
            mma_bf16_16816(acc[i][2 * p], af[i], bq[p]);
            mma_bf16_16816(acc[i][2 * p + 1], af[i], bq[p] + 2);
          }
      }
    };
#pragma unroll
    for (int s = 0; s < kS - 1; ++s) {
      if (s < n_steps) load(s);
      cp_async_commit();
    }
    for (int j = 0; j < n_steps; ++j) {
      if constexpr (kS > 1) {
        cp_async_wait<kS - 2>();   // step j has landed
        __syncthreads();   // ... for every thread; step j - 1's slot is
                           // read out
        if (j + kS - 1 < n_steps) load(j + kS - 1);
        cp_async_commit();
      } else {
        load(j);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      compute(j % kS);
      if constexpr (kS == 1) __syncthreads();
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with the ring
    const int gr = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int jn = 0; jn < 2 * kNP; ++jn) {
        const int r = wm * C::kWM + i * 16 + gr;
        const int c = wn * C::kWN + jn * 8 + tig * 2;
        *reinterpret_cast<uint32_t*>(smem + r * kORow + c) =
            pack_bf16(acc[i][jn][0], acc[i][jn][1]);
        *reinterpret_cast<uint32_t*>(smem + (r + 8) * kORow + c) =
            pack_bf16(acc[i][jn][2], acc[i][jn][3]);
      }
    __syncthreads();
  }
  constexpr int kOC = BN / 8;   // 16-byte stores a row
  for (int i = tid; i < BM * kOC; i += kThreads) {
    const int r = i / kOC, c = (i % kOC) * 8, row = m0 + r, col = n0 + c;
    if (col >= N) continue;
    uint4 v;
    if (row >= lo && row < hi)
      v = *reinterpret_cast<const uint4*>(smem + r * kORow + c);
    else if (row >= zlo && row < zhi)
      v = make_uint4(0u, 0u, 0u, 0u);
    else
      continue;
    *reinterpret_cast<uint4*>(out + (long long)row * N + col) = v;
  }
}

// lhs [M, K], rhs [M, N] contiguous, K and N multiples of 8, 16-byte
// aligned. Row tile t (blockIdx.x, R rows) of group g: out[g] directly if
// g has one tile, else the partial ws[t] [K, N].
template <class C>
__global__ void __launch_bounds__(tgmm_threads<C>()) tgmm_tc_kernel(
    const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
    const int* __restrict__ sizes, float* __restrict__ out,
    float* __restrict__ ws, int M, int KD, int N, int G, int R) {
  constexpr int BK = C::kBK, BN = C::kBN, BR = C::kBR, kS = C::kStages;
  constexpr int kThreads = tgmm_threads<C>();
  constexpr int kMT = C::kWK / 16, kNP = C::kWN / 16;
  constexpr int kARow = BK + 8, kBRow = BN + 8;   // [row][k], [row][n]
  constexpr int kA = BR * kARow, kStage = kA + BR * kBRow;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int info[4];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int wk = w % (BK / C::kWK), wn = w / (BK / C::kWK);
  if (tid == 0) {
    const RowTile rt = find_row_tile(sizes, G, M, R, blockIdx.x);
    info[0] = rt.grp;
    info[1] = rt.lo;
    info[2] = rt.hi;
    info[3] = rt.cnt;
  }
  __syncthreads();
  const int grp = info[0], lo = info[1], hi = info[2], cnt = info[3];
  if (grp < 0) return;                         // past the last tile
  const int k0 = blockIdx.y * BK, n0 = blockIdx.z * BN;
  const int n_steps = (hi - lo + BR - 1) / BR;
  auto load = [&](int j) {
    bf16* as = smem + (j % kS) * kStage;
    bf16* bs = as + kA;
    const int r0 = lo + j * BR;
    constexpr int kAC = BK / 8, kAN = BR * kAC;
#pragma unroll
    for (int it = 0; it < (kAN + kThreads - 1) / kThreads; ++it) {
      const int i = it * kThreads + tid;
      if (kAN % kThreads == 0 || i < kAN) {
        const int r = i / kAC, c = (i % kAC) * 8, row = r0 + r, k = k0 + c;
        const bool ok = row < hi && k < KD;
        cp_async16_zfill(as + r * kARow + c,
                         ok ? lhs + (long long)row * KD + k : lhs,
                         ok ? 16 : 0);
      }
    }
    constexpr int kBC = BN / 8, kBN_ = BR * kBC;
#pragma unroll
    for (int it = 0; it < (kBN_ + kThreads - 1) / kThreads; ++it) {
      const int i = it * kThreads + tid;
      if (kBN_ % kThreads == 0 || i < kBN_) {
        const int r = i / kBC, c = (i % kBC) * 8, row = r0 + r, n = n0 + c;
        const bool ok = row < hi && n < N;
        cp_async16_zfill(bs + r * kBRow + c,
                         ok ? rhs + (long long)row * N + n : rhs,
                         ok ? 16 : 0);
      }
    }
  };
  float acc[kMT][2 * kNP][4] = {};
  auto compute = [&](int slot) {
    const bf16* as = smem + slot * kStage;
    const bf16* bs = as + kA;
#pragma unroll
    for (int kr = 0; kr < BR / 16; ++kr) {
      uint32_t af[kMT][4], bq[kNP][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)   // lhs^T: m = k of lhs, contraction
        ldsm_x4_trans(af[i], as + at_off(wk * C::kWK + i * 16, kr * 16,
                                         kARow));
#pragma unroll
      for (int p = 0; p < kNP; ++p)
        ldsm_x4_trans(bq[p], bs + bn_off(kr * 16, wn * C::kWN + p * 16,
                                         kBRow));
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int p = 0; p < kNP; ++p) {
          mma_bf16_16816(acc[i][2 * p], af[i], bq[p]);
          mma_bf16_16816(acc[i][2 * p + 1], af[i], bq[p] + 2);
        }
    }
  };
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < n_steps) load(s);
    cp_async_commit();
  }
  for (int j = 0; j < n_steps; ++j) {
    cp_async_wait<kS - 2>();
    __syncthreads();
    if (j + kS - 1 < n_steps) load(j + kS - 1);
    cp_async_commit();
    compute(j % kS);
  }
  cp_async_wait<0>();
  float* dst = cnt == 1 ? out + (long long)grp * KD * N
                        : ws + (long long)blockIdx.x * KD * N;
  const int gr = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int jn = 0; jn < 2 * kNP; ++jn) {
      const int k = k0 + wk * C::kWK + i * 16 + gr;
      const int n = n0 + wn * C::kWN + jn * 8 + tig * 2;
      if (n >= N) continue;                    // N even: n + 1 < N too
      if (k < KD)
        *reinterpret_cast<float2*>(dst + (long long)k * N + n) =
            make_float2(acc[i][jn][0], acc[i][jn][1]);
      if (k + 8 < KD)
        *reinterpret_cast<float2*>(dst + (long long)(k + 8) * N + n) =
            make_float2(acc[i][jn][2], acc[i][jn][3]);
    }
}

// out[g] = the sum of group g's partials in tile order (g of two or more
// tiles), zeros for an empty group; a group of one tile was written
// directly. KN = K * N, a multiple of 4.
constexpr int kRThreads = 256;

__global__ void __launch_bounds__(kRThreads) tgmm_reduce_kernel(
    const float* __restrict__ ws, const int* __restrict__ sizes,
    float* __restrict__ out, int M, int KN, int R) {
  __shared__ int info[2];
  const int grp = blockIdx.y;
  if (threadIdx.x == 0) group_tiles(sizes, M, R, grp, info[0], info[1]);
  __syncthreads();
  const int base = info[0], cnt = info[1];
  const long long i = ((long long)blockIdx.x * kRThreads + threadIdx.x) * 4;
  if (cnt == 1 || i >= KN) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < cnt; ++t) {
    const float4 p =
        *reinterpret_cast<const float4*>(ws + (long long)(base + t) * KN + i);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  *reinterpret_cast<float4*>(out + (long long)grp * KN + i) = s;
}

template <class C, bool KMAJ>
int launch_gmm_tc(const void* lhs, const void* rhs, const int* sizes,
                  void* out, int M, int KD, int N, int G, long long s0,
                  long long sk, long long sn, cudaStream_t stream) {
  constexpr int smem = GmmSmem<C, KMAJ>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      gmm_tc_kernel<C, KMAJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((M + C::kBM - 1) / C::kBM + G, (N + C::kBN - 1) / C::kBN);
  gmm_tc_kernel<C, KMAJ><<<grid, gmm_threads<C>(), smem, stream>>>(
      (const bf16*)lhs, (const bf16*)rhs, sizes, (bf16*)out, M, KD, N, G, s0,
      sk, sn);
  return (int)cudaGetLastError();
}

template <class C>
int launch_tgmm_tc(const void* lhs, const void* rhs, const int* sizes,
                   float* out, float* ws, int M, int KD, int N, int G, int R,
                   cudaStream_t stream) {
  constexpr int smem =
      2 * C::kStages * C::kBR * (C::kBK + 8 + C::kBN + 8);
  cudaError_t e = cudaFuncSetAttribute(
      tgmm_tc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((M + R - 1) / R + G, (KD + C::kBK - 1) / C::kBK,
            (N + C::kBN - 1) / C::kBN);
  tgmm_tc_kernel<C><<<grid, tgmm_threads<C>(), smem, stream>>>(
      (const bf16*)lhs, (const bf16*)rhs, sizes, out, ws, M, KD, N, G, R);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int kn = KD * N;
  dim3 rgrid((kn / 4 + kRThreads - 1) / kRThreads, G);
  tgmm_reduce_kernel<<<rgrid, kRThreads, 0, stream>>>(ws, sizes, out, M, kn,
                                                      R);
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

// tile: 0 GmmWide, 1 GmmNarrow16, 2 GmmNarrow32, 3 GmmThin; kmaj: rhs
// K-contiguous (sk == 1) instead of N-contiguous (sn == 1). bf16 in and out.
extern "C" int spt_gmm_tc(int tile, int kmaj, const void* lhs,
                          const void* rhs, const void* sizes, void* out,
                          int M, int KD, int N, int G, long long s0,
                          long long sk, long long sn, void* stream) {
  using namespace spt;
  using F = int (*)(const void*, const void*, const int*, void*, int, int,
                    int, int, long long, long long, long long, cudaStream_t);
  static constexpr F fns[4][2] = {
      {launch_gmm_tc<GmmWide, false>, launch_gmm_tc<GmmWide, true>},
      {launch_gmm_tc<GmmNarrow16, false>, launch_gmm_tc<GmmNarrow16, true>},
      {launch_gmm_tc<GmmNarrow32, false>, launch_gmm_tc<GmmNarrow32, true>},
      {launch_gmm_tc<GmmThin, false>, launch_gmm_tc<GmmThin, true>}};
  if (tile < 0 || tile > 3) return (int)cudaErrorInvalidValue;
  return fns[tile][kmaj ? 1 : 0](lhs, rhs, (const int*)sizes, out, M, KD, N,
                                 G, s0, sk, sn, (cudaStream_t)stream);
}

// tile: 0 TgmmWide, 1 TgmmNarrow16, 2 TgmmNarrow32; R rows a row tile;
// ws: [ceil(M / R) + G, K, N] f32 (unused when R >= M)
extern "C" int spt_tgmm_tc(int tile, const void* lhs, const void* rhs,
                           const void* sizes, void* out, void* ws, int M,
                           int KD, int N, int G, int R, void* stream) {
  using namespace spt;
  auto f = tile == 1   ? launch_tgmm_tc<TgmmNarrow16>
           : tile == 2 ? launch_tgmm_tc<TgmmNarrow32>
                       : launch_tgmm_tc<TgmmWide>;
  if (tile < 0 || tile > 2 || R <= 0) return (int)cudaErrorInvalidValue;
  return f(lhs, rhs, (const int*)sizes, (float*)out, (float*)ws, M, KD, N,
           G, R, (cudaStream_t)stream);
}
