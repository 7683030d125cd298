// Tensor-core main loop of the two int8 kernels (A: conv_int8.cu, B:
// upconv_int8.cu) on Hopper: the implicit GEMM of igemm_int8.cuh,
//
//   acc[m][n] = sum_k A[m][k] * B[n][k],   k = (tap, c) over ksize^2 * Ci
//   A[m][(tap, c)] = x[img, h + dy, w + dx, c]   (zero outside the image)
//   B[n][(tap, c)] = w[n][tap][c]                (K-contiguous weight rows)
//
// computed by wgmma.mma_async.m64nNk32.s32.s8.s8 with int32 accumulators
// in registers.  The int32 sums are exact, as __dp4a's are, so the codes
// after the shared epilogue equal the plain versions' bit for bit.
//
// Block: 128 output pixels x BN (64 or 128) output columns.  The 128 pixels
// are a rectangle of one image, bw columns x 128/bw rows (bw = 16 for
// every full-width site), so one tap's A tile is one TMA box of the 4-D
// tensor map over the NHWC activations, (C, W, H, N), at (c0, w0 + dx,
// h0 + dy, img).  TMA fills coordinates outside the tensor with zeros:
// that fill is the SAME padding, the channel tail (Ci not a multiple of
// 64) and the ragged edge of the image, with no bounds checks in the loop.
// B's tile is a box of the 3-D map over the weights, (Ci, taps, rows), at
// (c0, tap, n0), zero past Ci and past the last row.
//
// Warp roles: warps 0-7 are two consumer warpgroups, each owning 64 of the
// 128 rows; warp 8 is the producer, one of whose threads keeps a ring of
// STAGES shared-memory stages (97 KB with the barriers at BN = 128, so two
// blocks share an SM and one's loads overlap the other's epilogue) filled
// with TMA loads, each stage 64 codes of K (a 64-byte row, 64-byte swizzle,
// the layout the wgmma descriptors name) for A and B, signalled through a
// "full" mbarrier per stage.  A consumer
// warpgroup waits on a stage, issues two k32 wgmmas on it, keeps one
// wgmma group in flight, and releases the stage before through its
// "empty" mbarrier (one arrival per consumer warp) once that group is done.
// 64-code steps fit the Ci = 64 sites (enc1/Conv_1, enc2/Conv_0,
// dec1/Conv_1) without zero-padded halves.
//
// What this design leaves for later: one tile per block (no persistent
// schedule; two resident blocks an SM stand in for one), no split-K for
// the small-M sites, and 128 x BN tiles whose halo rows
// are fetched again (from L2) for each of the 9 taps.
//
// The GEMM form (namespace gemm, at the end; kernel A's 1x1 sites): a
// 1x1 conv is a plain GEMM, C[M x Co] = A[M x Ci] * W[Co x Ci]^T over the
// contiguous (M = N H W, Ci) codes, with its own main loop:
//   - 2-D tensor maps over the codes and the weights, 128-code K steps
//     (128-byte rows, the 128-byte swizzle): four k32 wgmmas a barrier
//     round trip instead of two; TMA's zero fill covers the M, Co and Ci
//     tails;
//   - persistent: one block an SM walks the 128 x 128 output tiles, along
//     Co first (the tiles in flight share their rows of A; the weights stay
//     in L2), a 6-stage ring of 32 KB filled by one producer thread across
//     tile boundaries;
//   - ping-pong: each consumer warpgroup owns alternate tiles, the whole
//     128 x 128 in its registers (232 of them, taken from the producer
//     warpgroup by setmaxnreg), and the two take the tensor cores in turn,
//     so one's epilogue (dequantization, GELU, stores straight from the
//     registers) runs under the other's main loop.  Measured against it,
//     a cooperative 128 x 256 tile (two warpgroups on one weight tile, as
//     the 3x3 loop shares its tile) kept its main loop at about 90 % of
//     the int8 rate but left the tensor cores idle through every epilogue:
//     0.47 ms at DiT's qkv (batch 32, on an H100) against 0.29 (PERF.md).
// A 2-block cluster multicasting the weight tile was 2-3x slower (the two
// blocks' turns coupled through their shared empty barriers).  Left for
// later: a TMA store of the epilogue, and split-K for sites with fewer
// tiles than SMs.
#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>

#include "igemm_int8.cuh"  // the shared epilogue: dequant, requant

namespace tc {

constexpr int BM = 128;                  // output pixels per block
constexpr int BK = 64;                   // K codes per stage (64-byte rows)
constexpr int STAGES = 6;                // depth of the ring
constexpr int MIN_BLOCKS = 2;            // blocks an SM holds at once
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int A_BYTES = BM * BK;
constexpr int SW_ATOM = 512;             // 8 rows x 64 B: one 64-byte swizzle atom

template <int BN>
struct Layout {
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE = A_BYTES + B_BYTES;  // a multiple of 1024
  static constexpr int RING = STAGES * STAGE;
  // epilogue staging, in the ring once the main loop is done: 64 rows per
  // warpgroup, float32 at worst; +16 bytes a row keeps rows 16-byte
  // aligned and off one bank
  static constexpr int PITCH_F32 = BN * 4 + 16;
  static constexpr int PITCH_I8 = BN + 16;
  static_assert(2 * 64 * PITCH_F32 <= RING, "staging must fit the ring");
  static constexpr int BARS = RING;
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;  // + alignment
  static_assert(MIN_BLOCKS * SMEM <= 227 * 1024, "shared memory per SM");
};

// The output rectangle of this block.  Row r of the tile is pixel
// (img, h0 + r / bw, w0 + r % bw).
struct Tile {
  int img, h0, w0, bw;
};

__device__ __forceinline__ Tile tile_of(int H, int W, int bw) {
  const int bh = BM / bw, tw = (W + bw - 1) / bw, th = (H + bh - 1) / bh;
  int t = blockIdx.x;
  Tile r;
  r.bw = bw;
  r.w0 = (t % tw) * bw;
  t /= tw;
  r.h0 = (t % th) * bh;
  r.img = t / th;
  return r;
}

__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ uint8_t dyn_smem[];
  const uintptr_t p = reinterpret_cast<uintptr_t>(dyn_smem);
  // the swizzle is a function of the address: align stages to 1024 bytes
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dyn_smem);
  return reinterpret_cast<uint8_t*>(p + ((1024 - (s & 1023)) & 1023));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed.  A ring that
// stops (a barrier phase that never completes) traps after about 2^34
// cycles, some 10 s, and fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// ---- TMA loads, completing on an mbarrier
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// ---- wgmma
// Shared-memory matrix descriptor of a K-major tile with 64-byte rows under
// the 64-byte swizzle: start address >> 4 (bits 0-13), leading offset 1
// (unused by swizzled K-major layouts, bits 16-29), stride between 8-row
// groups 512 B >> 4 (bits 32-45), swizzle mode 2 = 64 B (bits 62-63).
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(SW_ATOM >> 4) << 32) | ((uint64_t)2 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous wgmma (the registers belong to the tensor cores meanwhile).
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x N] += A[64 x 32] * B[N x 32]^T, s8 x s8 -> s32, both from shared
// memory.  Register i of thread l of warp w (in its warpgroup) is row
// 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (l & 3) + (i & 1).
__device__ __forceinline__ void wgmma_k32(int (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_k32(int (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The whole main loop, run by every thread of the block.  Returns true on
// the consumer threads, whose `acc` then holds their part of the 128 x BN
// tile (warpgroup g = threadIdx.x / 128 owns rows 64 g .. 64 g + 63), and
// false on the producer warp, whose `acc` is untouched.
template <int BN>
__device__ __forceinline__ bool mainloop(const CUtensorMap& mapA,
                                         const CUtensorMap& mapB,
                                         uint8_t* smem, const Tile& t,
                                         int Ci, int ksize, int n0,
                                         int (&acc)[BN / 2]) {
  using L = Layout<BN>;
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::BARS, empty = full + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int csteps = (Ci + BK - 1) / BK, pad = ksize / 2;
  const int steps = ksize * ksize * csteps;

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    if (threadIdx.x == CONSUMERS) {
      for (int ks = 0; ks < steps; ++ks) {
        const int s = ks % STAGES;
        if (ks >= STAGES) mbar_wait(empty + 8 * s, (ks / STAGES - 1) & 1);
        const int tap = ks / csteps, c0 = (ks - tap * csteps) * BK;
        const int dy = tap / ksize - pad, dx = tap % ksize - pad;
        const uint32_t a = base + s * L::STAGE;
        mbar_expect_tx(full + 8 * s, L::STAGE);
        tma_load_4d(a, &mapA, full + 8 * s, c0, t.w0 + dx, t.h0 + dy, t.img);
        tma_load_3d(a + A_BYTES, &mapB, full + 8 * s, c0, tap, n0);
      }
    }
    return false;
  }

  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  fence_acc(acc);
  for (int ks = 0; ks < steps; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(full + 8 * s, (ks / STAGES) & 1);
    __syncwarp();  // wgmma is .aligned: the warp issues it converged
    const uint32_t a = base + s * L::STAGE + wg * (64 * BK);
    const uint32_t b = base + s * L::STAGE + A_BYTES;
    wgmma_fence();
    wgmma_k32(acc, desc_sw64(a), desc_sw64(b));
    wgmma_k32(acc, desc_sw64(a + 32), desc_sw64(b + 32));
    wgmma_commit();
    wgmma_wait<1>();  // the group of step ks - 1 is done: free its stage
    if (ks > 0 && (threadIdx.x & 31) == 0)
      mbar_arrive(empty + 8 * ((ks - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  // both warpgroups are done with the ring before either stages its
  // epilogue there (barrier 3, the 256 consumer threads)
  asm volatile("bar.sync 3, %0;" ::"n"(CONSUMERS) : "memory");
  return true;
}

// Epilogue, first half: this consumer thread's accumulators through the
// shared epilogue (igemm_int8.cuh: dequant, optional ReLU, requant or
// float32) into its warpgroup's 64 x BN staging tile in shared memory
// (staging(smem), row pitch Layout<BN>::PITCH_F32 or PITCH_I8), then a
// barrier of the warpgroup's 128 threads.  Columns at or past `ncols` stage values the
// store skips.
template <int BN>
__device__ __forceinline__ uint8_t* staging(uint8_t* smem) {
  return smem + (threadIdx.x >> 7) * 64 * Layout<BN>::PITCH_F32;
}

template <int BN, bool OUT_FLOAT>
__device__ __forceinline__ void stage_tile(const int (&acc)[BN / 2],
                                           uint8_t* stg,
                                           const float* __restrict__ s,
                                           const float* __restrict__ b,
                                           int n0, int ncols, bool relu) {
  using L = Layout<BN>;
  const int t = threadIdx.x & 127, w = t >> 5, l = t & 31;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int col = 8 * (i >> 2) + 2 * (l & 3);
    const int row = 16 * w + (l >> 2) + 8 * ((i >> 1) & 1);
    float y[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + col + j;
      const bool ok = n < ncols;
      y[j] = igemm::dequant(acc[i + j], ok ? __ldg(s + n) : 0.f,
                            ok ? __ldg(b + n) : 0.f);
      if (relu) y[j] = fmaxf(y[j], 0.f);
    }
    if constexpr (OUT_FLOAT) {
      *reinterpret_cast<float2*>(stg + row * L::PITCH_F32 + col * 4) =
          make_float2(y[0], y[1]);
    } else {
      const unsigned q0 = (uint8_t)igemm::requant(y[0]);
      const unsigned q1 = (uint8_t)igemm::requant(y[1]);
      *reinterpret_cast<uint16_t*>(stg + row * L::PITCH_I8 + col) =
          (uint16_t)(q0 | (q1 << 8));
    }
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + (int)(threadIdx.x >> 7))
               : "memory");
}

// The GEMM form's GELU epilogue (conv_int8.cu: GemmStore): GELU's tanh
// form, 0.5 y (1 + tanh(k (y + 0.044715 y^3))), written as
// y / (1 + exp(-2 k (y + 0.044715 y^3))) (the same function: 1 + tanh(u)
// = 2 / (1 + exp(-2 u))) with the fast exponential and division: two
// special-function operations an element, about 1e-6 relative of
// torch's, so a code lies a boundary apart from the plain version's (the
// codes of torch's GELU) a few times in 1e5.  Where exp overflows the
// fast division gives 0, GELU's limit there.
__device__ __forceinline__ float gelu_tanh(float y) {
  constexpr float K2 = -2.0f * 0.7978845608028654f;  // -2 sqrt(2 / pi)
  const float u = K2 * fmaf(0.044715f * y, y * y, y);
  return __fdividef(y, 1.0f + __expf(u));
}

// ---- host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: looked up through the runtime,
// so the library links no libcuda.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device.  The attribute lasts as long as the process's context, so each
// kernel sets it once a device: `done` holds one bit a device.
inline int allow_smem(const void* kernel, int bytes,
                      std::atomic<uint64_t>& done) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// Width of the pixel rectangle: the smallest power of two >= W, at most 16.
inline int tile_width(int W) {
  int bw = 16;
  while (bw > 1 && bw / 2 >= W) bw /= 2;
  return bw;
}

// Error codes of the launchers past the CUDA runtime's: a tensor map that
// does not encode, and no encoder in the driver.
constexpr int ERR_ENCODE = 10001;
constexpr int ERR_NO_ENCODER = 10002;

// NHWC int8 activations as (C, W, H, N), box (64, bw, 128 / bw, 1).
inline int encode_act(CUtensorMap* m, const void* x, int N, int H, int W,
                      int C, int bw) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)N};
  const cuuint64_t stride[3] = {(cuuint64_t)C, (cuuint64_t)W * C,
                                (cuuint64_t)H * W * C};
  const cuuint32_t box[4] = {(cuuint32_t)BK, (cuuint32_t)bw,
                             (cuuint32_t)(BM / bw), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dim,
             stride, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : ERR_ENCODE;
}

// K-contiguous int8 weight rows (rows, taps, Ci) as (Ci, taps, rows), box
// (64, 1, bn).
inline int encode_weights(CUtensorMap* m, const void* w, int rows, int taps,
                          int Ci, int bn) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dim[3] = {(cuuint64_t)Ci, (cuuint64_t)taps,
                             (cuuint64_t)rows};
  const cuuint64_t stride[2] = {(cuuint64_t)Ci, (cuuint64_t)taps * Ci};
  const cuuint32_t box[3] = {(cuuint32_t)BK, 1, (cuuint32_t)bn};
  const cuuint32_t one[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w), dim,
             stride, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : ERR_ENCODE;
}

// Blocks of a launch: rectangles of every image, times column tiles.
inline dim3 grid_of(int N, int H, int W, int bw, int ncols, int bn) {
  const int bh = BM / bw;
  return dim3((unsigned)N * ((H + bh - 1) / bh) * ((W + bw - 1) / bw),
              (unsigned)((ncols + bn - 1) / bn));
}

// ---- the GEMM form: 1x1 sites as a persistent GEMM (see the head)
namespace gemm {

constexpr int BM = 128;        // rows (pixels) of a tile
constexpr int BN = 128;        // columns of a tile
constexpr int BK = 128;        // K codes a stage: 128-byte rows
constexpr int STAGE = (BM + BN) * BK;  // 32 KB, a multiple of 1024
constexpr int STAGES = 6;
constexpr int RING = STAGES * STAGE;
constexpr int BARS = RING;     // full[STAGES], empty[STAGES]
constexpr int SB = RING + 128;  // a tile's scale and bias: [warpgroup][2]
constexpr int SB_BYTES = 2 * 2 * 2 * BN * 4;  //  x [s | b][BN] float32
constexpr int SMEM = SB + SB_BYTES + 1024;    // + alignment
constexpr int SW_ATOM = 1024;  // 8 rows x 128 B: one 128-byte swizzle atom
static_assert(2 * STAGES * 8 <= SB - BARS && SMEM <= 227 * 1024,
              "shared memory per SM");
// two consumer warpgroups and a producer warpgroup, whose registers the
// consumers take (setmaxnreg): 128 x 40 + 256 x 232 <= 65,536
constexpr int THREADS = CONSUMERS + 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Descriptor of a K-major tile with 128-byte rows under the 128-byte
// swizzle: start address >> 4, leading offset 1 (unused), stride between
// 8-row groups 1024 B >> 4, swizzle mode 1 = 128 B.  A k32 step inside the
// row adds 32 bytes to the start address: the swizzle is a function of the
// address bits, so the stage must sit on a 1024-byte boundary.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(SW_ATOM >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma_k32 above (m64n128k32) with scale_d: 0 starts the sum (d is
// written, not read), 1 adds to it.
__device__ __forceinline__ void wgmma_k32(int (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The output tile of a launch's `t`-th tile: rows m0 .. m0 + 127, columns
// n0 .. n0 + 127.  Tiles are numbered along N first: the tiles that run at
// once share their A rows (read from device memory once), and every
// site's weights fit the L2 whole.
struct Tile {
  int m0, n0;
};

__device__ __forceinline__ Tile tile_at(int t, int ntiles_n) {
  return Tile{(t / ntiles_n) * BM, (t % ntiles_n) * BN};
}

// The persistent main loop, run by every thread of the block.  The block
// takes tiles blockIdx.x + i gridDim.x, i = 0, 1, ..., of the M x ncols
// output; warpgroup g (threads 128 g ..) computes those with i % 2 == g,
// the whole 128 x 128 tile in its registers (acc[h]: rows 64 h ..).  The
// producer thread loads the tiles' stages in the order of i, and a
// warpgroup starts tile i only once the other has issued its last step of
// tile i - 1 (named barriers 3 and 4), so the two main loops take the
// tensor cores in turn: one warpgroup runs its epilogue, epi(acc, tile,
// sb), while the other computes.  The turn also keeps a warpgroup from
// waiting on a stage whose previous use has not arrived (its barrier's
// parity would read that phase as this one).  sb holds the tile's 128
// scales, then its 128 biases (0 past ncols), staged from s and b by the
// warpgroup; epi must not touch the ring, and may overwrite acc (the next
// tile's first wgmma starts the sum afresh).
template <class Epi>
__device__ __forceinline__ void run(const CUtensorMap& mapA,
                                    const CUtensorMap& mapB,
                                    const float* __restrict__ s,
                                    const float* __restrict__ b, int M,
                                    int K, int ncols, Epi&& epi) {
  // smem_base()'s alignment, kept an offset into the shared array so that
  // the epilogue's reads of sb compile to shared-memory loads
  extern __shared__ uint8_t dyn_smem[];
  uint8_t* smem =
      dyn_smem + ((1024 - (smem_u32(dyn_smem) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + BARS, empty = full + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4);  // the four warps of one warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int ntn = (ncols + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * ntn;
  const int steps = (K + BK - 1) / BK;

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_at(t, ntn);
        for (int ks = 0; ks < steps; ++ks, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES)
            mbar_wait(empty + 8 * st, (it / STAGES - 1) & 1);
          const uint32_t a = base + st * STAGE;
          mbar_expect_tx(full + 8 * st, STAGE);
          tma_load_2d(a, &mapA, full + 8 * st, ks * BK, tl.m0);
          tma_load_2d(a + BM * BK, &mapB, full + 8 * st, ks * BK, tl.n0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127;
  float* sb = reinterpret_cast<float*>(smem + SB) + wg * 4 * BN;
  int acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0;
  for (int i = wg;; i += 2) {
    const int t = blockIdx.x + i * gridDim.x;
    if (t >= tiles) break;
    const Tile tl = tile_at(t, ntn);
    // this thread's column of the tile's scale and bias, loaded here and
    // staged after the main loop
    const int c = tl.n0 + tid;
    const float sv = c < ncols ? __ldg(s + c) : 0.f;
    const float bv = c < ncols ? __ldg(b + c) : 0.f;
    // the other warpgroup has issued tile i - 1 (barrier 4 - g)
    if (i > 0) asm volatile("bar.sync %0, 256;" ::"r"(4 - wg) : "memory");
    const bool next = t + gridDim.x < tiles;  // the other's turn follows
    int it = i * steps;
    for (int ks = 0; ks < steps; ++ks, ++it) {
      const int st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      __syncwarp();  // wgmma is .aligned: the warp issues it converged
      const uint32_t a = base + st * STAGE;
      const uint32_t bb = a + BM * BK;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint64_t db = desc_sw128(bb + 32 * kk);
        const int acc_in = ks > 0 || kk > 0;
        wgmma_k32(acc[0], desc_sw128(a + 32 * kk), db, acc_in);
        wgmma_k32(acc[1], desc_sw128(a + 64 * BK + 32 * kk), db, acc_in);
      }
      wgmma_commit();
      if (ks == steps - 1 && next)  // its turn: barrier 3 + g
        asm volatile("bar.arrive %0, 256;" ::"r"(3 + wg) : "memory");
      wgmma_wait<1>();  // the group of step it - 1 is done: free its stage
      if (ks > 0 && (threadIdx.x & 31) == 0)
        mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    // two slots a warpgroup, one a tile in turn: a slot is written again
    // only past the next tile's barrier, when every thread has read it
    float* slot = sb + ((i >> 1) & 1) * 2 * BN;
    slot[tid] = sv;
    slot[BN + tid] = bv;
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    epi(acc, tl, slot);
  }
}

// ---- host side
// Row-major int8 (rows, cols) as (cols, rows), box (BK, box_rows), the
// 128-byte swizzle: the codes (M, Ci) of a 1x1 site, or its weights
// (Co, Ci).
inline int encode_rows(CUtensorMap* m, const void* p, long long rows,
                       int cols, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dim,
             stride, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : ERR_ENCODE;
}

// The SMs of the current device, looked up once a device.
inline int sm_count() {
  static std::atomic<int> counts[64];  // zero: static storage
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                       dev) == cudaSuccess)
    counts[dev].store(n, std::memory_order_relaxed);
  return n;
}

// One block an SM, or one a tile when there are fewer tiles.
inline unsigned grid_of(long long M, int ncols) {
  const long long tiles = (M + BM - 1) / BM * ((ncols + BN - 1) / BN);
  const int sms = sm_count();
  return (unsigned)(sms > 0 && tiles > sms ? sms : tiles);
}

}  // namespace gemm

}  // namespace tc
