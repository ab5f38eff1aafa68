// A tensor-core weight stream for skinny products: a CTA owns C = 16 cw
// columns of one or two weights W [K][ldw] (bf16, or int8 widened to bf16
// in registers) and all m rows of one or two bf16 operands X [m][ldx], and
// walks a K slice (blockIdx.y) through a cp.async ring of 64-row chunks:
//
//   acc[nw](col, row) = sum_k W_nw[k][col] * (X_0[row][k] + X_1[row][k])
//
// The products run on mma.sync m16n8k16 with W^T as the A operand
// (ldmatrix.trans from W's stored [k][col] layout; int8 pairs through
// i8_pairs_to_bf16, which orders an m16 tile's rows as the columns 0, 2,
// .., 14, 1, 3, .., 15) and X's rows as B (n = 8 rows a group). The 8 warps
// split as cw column tiles of 16 by 8 / cw row sets: a warp owns one m16
// column tile and the n8 row groups rs, rs + 8 / cw, ..., at most NG of
// them, so every weight byte is read from device memory once whatever m is
// (large m takes narrow tiles). Bytes bound the work (m <= 256), so the
// ring keeps S chunks in flight (16-byte copies with the 256-byte L2 hint)
// and the X chunks ride beside the W chunks.
//
// Used by int8_matmul's skinny path (csrc/int8_matmul.cu) and the fused
// FFN tails' two products (csrc/ffn_tail.cu). Bf16 bf16 and int8 bf16
// products are exact in f32, so only the order of the f32 sums differs
// from the plain twins'.
//
// The greedy heads (csrc/lm_head.cu lm_head_tc_kernel) stream their weight
// the same way but keep a loop of their own, because the two differ where
// each was tuned on the card: a head warp owns 2 (bf16) or 4 (int8) m16
// tiles, so that a CTA covers 256 / 512 vocabulary columns (512-byte runs
// of each W row), takes every row group itself (at most 16 rows) and loads
// its A fragments one k16 step at a time, which keeps the int8 head with
// its 256-row chunk partials at 124 registers, two CTAs an SM. Here a warp
// owns one tile and loads the fragments of both k16 steps at once (one
// ldmatrix.x4 an int8 tile), and the warps split the rows, up to 256 of
// them, reading x one row group at a time. One loop for both would carry
// both fragment orders behind a template switch, or move the int8 head's
// registers past the two-CTA limit.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace spt {

constexpr int kWsThreads = 256;   // 8 warps
constexpr int kWsK = 64;          // K rows a ring stage
constexpr int kWsXRow = kWsK + 8; // bf16 a staged X row: 144 bytes, an odd
                                  // count of 16-byte slots (ldmatrix rows in
                                  // distinct banks)

// bytes of a staged W row of c columns, padded to an odd count of 16-byte
// slots for the same reason
template <typename W> __host__ __device__ constexpr int ws_row_bytes(int c) {
  return c * (int)sizeof(W) + ((c * (int)sizeof(W) / 16) % 2 == 0 ? 16 : 32);
}

// bytes of one ring stage
template <typename W, int NW, int NX>
__host__ __device__ constexpr int ws_stage_bytes(int cw, int m) {
  return NW * kWsK * ws_row_bytes<W>(16 * cw) +
         NX * ((m + 7) / 8) * 8 * kWsXRow * 2;
}

template <typename W, int NW, int NX>
struct WsArgs {
  const W* w[NW];                   // [K][ldw]
  const __nv_bfloat16* x[NX];       // [m][ldx]
  int ldw, ldx, m, K;
  int cw;                           // m16 column tiles a CTA
  int kslice;                       // K rows a blockIdx.y (multiple of kWsK)
};

// acc element (i, e) of a warp: its column (relative to the CTA's first)
// and its row
template <typename W>
__device__ __forceinline__ int ws_col(int cw_tile, int e) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  return cw_tile * 16 + (std::is_same<W, int8_t>::value ? 2 * g + (e >> 1)
                                                        : g + 8 * (e >> 1));
}

__device__ __forceinline__ int ws_row(int ng, int e) {
  return ng * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// the mainloop: fills acc[nw][i] (row group rs + i * (8 / cw) of the warp)
// for the C = 16 cw columns from c0 of the weights (blockIdx.x's tile when
// c0 is not given); leaves shared memory free for an epilogue after a
// __syncthreads. X_AFTER_DEP (a kernel launched as a programmatic
// dependent of the one that writes X): the first S - 1 stages' weight
// copies are issued before griddepcontrol.wait, X's after it.
template <typename W, int NW, int NX, int NG, int S, bool X_AFTER_DEP = false>
__device__ __forceinline__ void ws_mainloop(const WsArgs<W, NW, NX>& a,
                                            unsigned char* smem,
                                            float (&acc)[NW][NG][4],
                                            int c0 = -1) {
  constexpr bool kInt8 = std::is_same<W, int8_t>::value;
  constexpr int kWE = 16 / (int)sizeof(W);   // W elements a copy
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int C = 16 * a.cw, rowB = ws_row_bytes<W>(C);
  const int ngt = (a.m + 7) / 8, rows = 8 * ngt;
  const int wbytes = kWsK * rowB;
  const int stage = ws_stage_bytes<W, NW, NX>(a.cw, a.m);
  if (c0 < 0) c0 = blockIdx.x * C;
  const int kbeg = blockIdx.y * a.kslice;
  const int kend = min(a.K, kbeg + a.kslice);
  const int n_steps = (kend - kbeg + kWsK - 1) / kWsK;
  // copies a W row: a power of two (C = 16 cw, cw 1, 2, 4 or 8)
  const int wsh = __ffs(C / kWE) - 1, wcopies = 1 << wsh;

  auto load_w = [&](int j) {
    unsigned char* st = smem + (j % S) * stage;
    const int k0 = kbeg + j * kWsK;
#pragma unroll
    for (int nw = 0; nw < NW; ++nw)
      for (int i = tid; i < kWsK * wcopies; i += kWsThreads) {
        const int r = i >> wsh, c = (i & (wcopies - 1)) * kWE;
        const int k = k0 + r, col = c0 + c;
        const bool ok = k < kend && col + kWE <= a.ldw;
        cp_async16_zfill_l2(st + nw * wbytes + r * rowB + c * sizeof(W),
                            ok ? a.w[nw] + (size_t)k * a.ldw + col : a.w[nw],
                            ok ? 16 : 0);
      }
  };
  auto load_x = [&](int j) {
    unsigned char* xs = smem + (j % S) * stage + NW * wbytes;
    const int k0 = kbeg + j * kWsK;
#pragma unroll
    for (int nx = 0; nx < NX; ++nx)
      for (int i = tid; i < rows * (kWsK / 8); i += kWsThreads) {
        const int r = i / (kWsK / 8), c = (i % (kWsK / 8)) * 8;
        const int k = k0 + c;
        const bool ok = r < a.m && k < kend;   // kend % 8 == 0
        cp_async16_zfill(xs + ((nx * rows + r) * kWsXRow + c) * 2,
                         ok ? a.x[nx] + (size_t)r * a.ldx + k : a.x[nx],
                         ok ? 16 : 0);
      }
  };

  auto load = [&](int j) {
    load_w(j);
    load_x(j);
  };

  const int ctile = wid % a.cw, rs = wid / a.cw, nrs = 8 / a.cw;
  if constexpr (X_AFTER_DEP) {
    // groups 0 .. S-2 still hold stages 0 .. S-2 whole: group 0 takes the
    // early weight copies of every prologue stage
#pragma unroll
    for (int j = 0; j < S - 1; ++j)
      if (j < n_steps) load_w(j);
    grid_dep_wait();
#pragma unroll
    for (int j = 0; j < S - 1; ++j) {
      if (j < n_steps) load_x(j);
      cp_async_commit();
    }
  } else {
#pragma unroll
    for (int j = 0; j < S - 1; ++j) {
      if (j < n_steps) load(j);
      cp_async_commit();
    }
  }
  for (int j = 0; j < n_steps; ++j) {
    cp_async_wait<S - 2>();   // stage j has landed ...
    __syncthreads();          // ... for every thread; j - 1 read out
    if (j + S - 1 < n_steps) load(j + S - 1);
    cp_async_commit();
    const unsigned char* st = smem + (j % S) * stage;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(st + NW * wbytes);
#pragma unroll
    for (int kk = 0; kk < kWsK; kk += 32) {
      // A fragments of two k16 steps, per weight
      uint32_t af[NW][2][4];
#pragma unroll
      for (int nw = 0; nw < NW; ++nw) {
        const unsigned char* ws = st + nw * wbytes;
        if constexpr (kInt8) {
          // matrices: k 0-7, 8-15, 16-23, 24-31 of the tile's 16 columns
          uint32_t raw[4];
          ldsm_x4_trans(raw, ws + (kk + lane) * rowB + ctile * 16);
          i8_pairs_to_bf16(raw[0], af[nw][0]);
          i8_pairs_to_bf16(raw[1], af[nw][0] + 2);
          i8_pairs_to_bf16(raw[2], af[nw][1]);
          i8_pairs_to_bf16(raw[3], af[nw][1] + 2);
        } else {
          // matrices: (k 0-7, columns 0-7), (k 0-7, 8-15), (k 8-15, 0-7),
          // (k 8-15, 8-15)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ldsm_x4_trans(af[nw][h],
                          ws + (kk + 16 * h + (lane & 7) + (lane >> 4) * 8)
                                   * rowB
                             + (ctile * 16 + ((lane >> 3) & 1) * 8) * 2);
        }
      }
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int ng = rs + i * nrs;
        if (ng >= ngt) break;
#pragma unroll
        for (int nx = 0; nx < NX; ++nx) {
          // X fragments: registers 0-1 for k16 step 0, 2-3 for step 1
          uint32_t xb[4];
          ldsm_x4(xb, xs + (nx * rows + ng * 8 + (lane & 7)) * kWsXRow + kk
                          + (lane >> 3) * 8);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int nw = 0; nw < NW; ++nw)
              mma_bf16_16816(acc[nw][i], af[nw][h], xb + 2 * h);
        }
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace spt
