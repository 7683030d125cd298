// Shared __dp4a main loop of the two int8 kernels, and the epilogue
// arithmetic every path shares: an implicit GEMM on int8 codes with int32
// accumulation, for NHWC activations.
//
//   acc[m][n] = sum_k A[m][k] * B[n][k],   k = (tap, c) over ksize*ksize*Ci
//   A[m][(tap, c)] = x[img, h + dy, w + dx, c]   (zero outside the image:
//                                                 SAME padding)
//   B[n][(tap, c)] = w[n * K + tap * Ci + c]     (K-contiguous rows)
//
// m walks the output pixels (img, h, w) of the NHWC batch.  A block owns a
// 64-pixel x 64-column output tile; K is staged through shared memory 32
// codes (8 words) at a time.  The product is __dp4a: four int8 products
// summed into an int32 per instruction, on the integer pipes.
//
// The tensor-core loop (wgmma_int8.cuh) takes every shape whose Ci is a
// multiple of 16 (its TMA rows need 16-byte strides) and whose output is at
// least 8 columns wide (wgmma's narrowest N); this loop keeps the rest: at
// full width, enc1/Conv_0 (Ci = 2, 1.2 G operations at batch 8) and the
// final 1x1 conv (Co = 1, bound by the bytes of its input).  A stage holds
// 32 codes of the joint (tap, c) index, so enc1/Conv_0's 18 codes of K are
// one step instead of nine taps each padded from 2 codes to 32.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace igemm {

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // K codes per shared-memory stage
constexpr int KW = BK / 4;    // 32-bit words per staged row
constexpr int LDS = KW + 1;   // padded row: a column read hits 16 banks
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// acc[i][j] is output (m0 + ty + 16 i, n0 + tx + 16 j) of this thread.
__device__ __forceinline__ void mainloop(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, int N, int H,
    int W, int Ci, int ncols, int ksize, int m0, int n0, int (&acc)[4][4]) {
  __shared__ int As[BM][LDS];
  __shared__ int Bs[BN][LDS];
  // (dy, dx, c) of each code of the step, worked out once a step:
  // c | (dy + 8) << 16 | (dx + 8) << 24 (c < 2^16), or -1 past K
  __shared__ int kinfo[BK];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = N * H * W, K = ksize * ksize * Ci, pad = ksize / 2;
  const int word = tid % KW;  // this thread stages word `word` of rows
  const int row0 = tid / KW;  // row0 and row0 + 32 of both tiles
  int pimg[2], ph[2], pw[2];
  bool pok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int m = m0 + row0 + 32 * r;
    pok[r] = m < M;
    int t = pok[r] ? m : 0;
    pw[r] = t % W;
    t /= W;
    ph[r] = t % H;
    pimg[r] = t / H;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (tid < BK) {
      const int k = k0 + tid;
      int v = -1;
      if (k < K) {
        const int tap = k / Ci;
        v = (k - tap * Ci) | (tap / ksize - pad + 8) << 16 |
            (tap % ksize - pad + 8) << 24;
      }
      kinfo[tid] = v;
    }
    __syncthreads();
    // this thread's word of rows row0 and row0 + 32, one code at a time
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 32 * r, n = n0 + row;
      unsigned a = 0, bw = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = kinfo[4 * word + j];
        if (v < 0) break;
        const int hh = ph[r] + ((v >> 16) & 0xFF) - 8;
        const int ww = pw[r] + (v >> 24) - 8;
        if (pok[r] && hh >= 0 && hh < H && ww >= 0 && ww < W)
          a |= (unsigned)(uint8_t)x[((size_t)(pimg[r] * H + hh) * W + ww) *
                                        Ci + (v & 0xFFFF)] << (8 * j);
        if (n < ncols)
          bw |= (unsigned)(uint8_t)w[(size_t)n * K + k0 + 4 * word + j]
                << (8 * j);
      }
      As[row][word] = (int)a;
      Bs[row][word] = (int)bw;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// acc * s + b rounded twice, multiply then add, as the plain versions (and
// the reference's XLA epilogue) compute it.  The intrinsics keep nvcc from
// contracting the expression into one FMA: an FMA would move a value that
// sits at a .5 boundary by one int8 code, and in an 18-layer int8 network
// one such code per layer cascades into a few percent of the output
// (measured on the card, PERF.md).  With both roundings fixed the kernels'
// codes equal their plain versions' bit for bit.
__device__ __forceinline__ float dequant(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

// Round half to even (rintf, like jnp.round / torch.round), clip to +-127.
__device__ __forceinline__ int8_t requant(float y) {
  return (int8_t)fminf(fmaxf(rintf(y), -127.f), 127.f);
}

}  // namespace igemm
