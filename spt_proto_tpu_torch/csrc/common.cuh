// Shared helpers for the port's Hopper kernels: element-type conversion
// and warp/block reductions. Every kernel is templated on float and
// __nv_bfloat16 so that the f32 instantiation can be checked tightly
// against its plain PyTorch twin.
#pragma once

#include <cmath>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace spt {

// dtype codes shared with the Python wrappers (_build.DTYPE_CODES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch/XLA
}

// round a float to T's precision and back (the "astype(dtype)" of the
// JAX kernels)
template <typename T> __device__ __forceinline__ float rt(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; `red` is >= 32 floats of shared scratch. Every
// thread of the block must call, and gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];  // fixed order: deterministic
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < nw; ++i) t = fmaxf(t, red[i]);
  return t;
}

// (value, index) argmax step: larger value wins, ties go to the lower index
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// d += a b, one warp: a 16 x 16 bf16 tile (row-major fragments), b 16 x 8
// (column-major: stored [n][k]), f32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16 and packed as one mma operand register (lo in
// the low half: the lower column of the pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8 x 8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the
// row addresses of matrix i; r[i] holds (row lane / 4, columns 2 (lane % 4)
// and +1) of matrix i, or with .trans (rows 2 (lane % 4) and +1, column
// lane / 4)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// 16 bytes global -> shared without passing through registers (L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// cp_async16 of the first `n` bytes (0 or 16) of src, the rest zero-filled:
// src is not read when n is 0
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

// cp_async16_zfill with a hint to fetch the 256-byte L2 sector group: for
// weight streams whose neighbouring copies read the rest of it
__device__ __forceinline__ void cp_async16_zfill_l2(void* dst, const void* src,
                                                    int n) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

// 4 bytes global -> shared, zero-filled when `n` is 0 (src then not read)
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared-memory offset (elements) of this lane's ldmatrix row address:
// an A operand [16 rows][16 k] at (r0, k0) of a row-major tile
__device__ __forceinline__ int a_off(int r0, int k0, int kRow) {
  const int lane = threadIdx.x & 31;
  return (r0 + (lane & 15)) * kRow + k0 + (lane >> 4) * 8;
}

// two n8 B operands [16 k][8 n] stored [n][k] (the contraction along the
// row), n from n0: registers 0-1 for n0.., 2-3 for n0 + 8..
__device__ __forceinline__ int bt_off(int n0, int k0, int kRow) {
  const int lane = threadIdx.x & 31;
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * kRow + k0
         + ((lane >> 3) & 1) * 8;
}

// two n8 B operands stored [k][n] (read with .trans), k from k0 and n
// from n0: registers 0-1 for n0.., 2-3 for n0 + 8..
__device__ __forceinline__ int bn_off(int k0, int n0, int kRow) {
  const int lane = threadIdx.x & 31;
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow + n0
         + (lane >> 4) * 8;
}

// an A operand [16 m][16 k] at (m0, k0) of a tile stored [k][m] (the
// contraction along the rows; read with .trans)
__device__ __forceinline__ int at_off(int m0, int k0, int kRow) {
  const int lane = threadIdx.x & 31;
  return (k0 + (lane & 7) + (lane >> 4) * 8) * kRow + m0
         + ((lane >> 3) & 1) * 8;
}


// The tensor-core attention kernels' tile helpers (csrc/flash_attention.cu,
// csrc/block_sparse_attention.cu): bf16 tiles in shared memory hold rows of
// D + kTilePad elements (16 B of padding put the 8 row addresses of an
// ldmatrix in distinct banks).
constexpr int kTilePad = 8;

// rows [0, N) of a D-wide bf16 operand (row stride ss elements) into shared
// rows of D + kTilePad elements, 16 B a cp.async, by the CTA's Threads
// threads
template <int D, int N, int Threads = 128>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss) {
  constexpr int kC = D / 8, kRow = D + kTilePad;
  static_assert((N * kC) % Threads == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < N * kC / Threads; ++it) {
    const int i = it * Threads + threadIdx.x, r = i / kC, c = i % kC;
    cp_async16(dst + r * kRow + c * 8, src + r * ss + c * 8);
  }
}

// a warp's f32 accumulator tile [16][D] as bf16 into rows [0, 16) of dst
// (row stride ss): through the warp's own 16 shared rows, then 16-byte
// stores
template <int D>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, long long ss,
                                           __nv_bfloat16* rows,
                                           const float (&acc)[D / 8][4]) {
  constexpr int kC = D / 8, kRow = D + kTilePad;
  const int lane = threadIdx.x & 31, gr = lane >> 2, tig = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + tig * 2;
    *reinterpret_cast<__nv_bfloat162*>(rows + gr * kRow + c) =
        __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<__nv_bfloat162*>(rows + (gr + 8) * kRow + c) =
        __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kC / 32; ++it) {
    const int i = it * 32 + lane, r = i / kC, c = i % kC;
    *reinterpret_cast<uint4*>(dst + r * ss + c * 8) =
        *reinterpret_cast<const uint4*>(rows + r * kRow + c * 8);
  }
}

// accumulator tile nt's four values (rows gr, gr + 8; columns 2 tig, +1)
// rounded to bf16 into the A operand of the next product: accumulator
// tiles 2t and 2t + 1 are k16 step t
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4], int nt,
                                     const float* x) {
  a[nt >> 1][(nt & 1) * 2] = pack_bf16(x[0], x[1]);
  a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
}

// one word of ldmatrix.trans over int8 pairs: bytes (k, c), (k, c + 1),
// (k + 1, c), (k + 1, c + 1) -> the A registers of rows c and c + 1, each
// the bf16 pair (k, k + 1): byte b becomes the f32 2^23 + (b ^ 0x80), less
// 2^23 + 128, an integer of at most 8 bits whose upper half is its bf16
__device__ __forceinline__ void i8_pairs_to_bf16(uint32_t w, uint32_t* a) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
        8388736.f);
  a[0] = __byte_perm(f[0], f[2], 0x7632);
  a[1] = __byte_perm(f[1], f[3], 0x7632);
}

// ---------------------------------------------------------------------------
// Hopper (sm_90a): mbarriers, TMA tile loads and warpgroup mma (wgmma)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also sets the bytes the phase waits for (a TMA load's)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
}

// TMA: the box of a 2-d tensor map (a __grid_constant__ CUtensorMap) at
// element coordinates (c0 innermost, c1) into shared memory; its bytes
// complete a transaction of `bar`. Elements outside the tensor come as 0.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start before the
// kernel ahead of it on the stream ends; grid_dep_wait blocks until that
// kernel has completed and its writes are visible, grid_dep_launch lets the
// next such kernel start once every CTA of this one has called it
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) only when `bytes` is
// more than `kernel` was last raised to on the current device: a decode
// step launches the same kernels every layer, and the attribute call is
// host time on each of them
inline cudaError_t raise_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> raised;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  int& have = raised[{kernel, dev}];
  if (bytes <= have) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) have = bytes;
  return e;
}

// launch `kernel` as a programmatic dependent of the kernel ahead of it
template <typename... KArgs, typename... Args>
cudaError_t launch_dependent(void (*kernel)(KArgs...), dim3 grid,
                             dim3 block, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

// named barrier over `n` threads (ids 1..15; 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// register budget of a warpgroup (all four warps execute it): producers
// give registers back, consumers take them
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// wgmma ordering: fence before the first wgmma that reads registers or
// shared memory written since; commit the issued ones as a group; wait
// until at most N groups are in flight
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma (before its fence, after its wait)
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// shared-memory matrix descriptor of a K-major bf16 tile in the 128-byte
// swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B): rows of 64 elements (128
// bytes), 8-row groups 1,024 bytes apart, the tile 1,024-byte aligned.
// Adding 2 (32 bytes) steps the start by one k16 slice inside the rows.
__device__ __forceinline__ uint64_t wgmma_desc_k128(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// D[64 x N] += A[64 x 16] B[16 x N], N = 128 or 256: A bf16 from registers
// (four words a thread: the warp's 16 rows in the mma.sync m16n8k16 A
// layout), B bf16 from shared memory through a K-major descriptor, D f32 in
// registers (N / 2 a thread, n8 tile j in d[4j .. 4j + 3], as mma.sync's C)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d,
                                                    const uint32_t* a,
                                                    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k16_rs(float* d,
                                                    const uint32_t* a,
                                                    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,"
      "%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,"
      "%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,"
      "%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,"
      "%120,%121,%122,%123,%124,%125,%126,%127"
      "}, {%128,%129,%130,%131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

}  // namespace spt
