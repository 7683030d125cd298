// Shared main loop of the two int8 kernels: an implicit GEMM on int8 codes
// with int32 accumulation, for NHWC activations.
//
//   acc[m][n] = sum_k A[m][k] * B[n][k],   k = (tap, c) over ksize*ksize*Ci
//   A[m][(tap, c)] = x[img, h + dy, w + dx, c]   (zero outside the image:
//                                                 SAME padding)
//   B[n][(tap, c)] = w[n * K + tap * Ci + c]     (K-contiguous rows)
//
// m walks the output pixels (img, h, w) of the NHWC batch.  A block owns a
// 64-pixel x 64-column output tile; K is staged through shared memory 32
// codes (8 words) at a time, zero-filled past Ci, so channel counts that are
// not a multiple of 4 (enc1's Ci=2) need no padded copy.  The product is
// __dp4a: four int8 products summed into an int32 per instruction.
//
// What this first design leaves on the table: __dp4a runs on the integer
// pipes, at a small fraction of the int8 tensor-core rate (1,979 dense TOP/s
// on H100 SXM); mma.sync.m16n8k32.s8 and then wgmma fed by TMA are the way
// there.  The staging loads are plain 4-byte loads with no cp.async
// pipelining, so the loads of one stage do not overlap the products of the
// previous one.
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

// Codes p[c..c+3] packed little-endian into one word; zero past `limit`.
// `vec` (limit % 4 == 0) makes the word 4-byte aligned and all-or-nothing.
__device__ __forceinline__ int load4(const int8_t* p, int c, int limit,
                                     bool vec) {
  if (vec) return c < limit ? __ldg(reinterpret_cast<const int*>(p + c)) : 0;
  unsigned v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < limit) v |= (unsigned)(uint8_t)p[c + j] << (8 * j);
  return (int)v;
}

// acc[i][j] is output (m0 + ty + 16 i, n0 + tx + 16 j) of this thread.
__device__ __forceinline__ void mainloop(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, int N, int H,
    int W, int Ci, int ncols, int ksize, int m0, int n0, int (&acc)[4][4]) {
  __shared__ int As[BM][LDS];
  __shared__ int Bs[BN][LDS];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = N * H * W, K = ksize * ksize * Ci, pad = ksize / 2;
  const bool vec = (Ci % 4) == 0;
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

  for (int tap = 0; tap < ksize * ksize; ++tap) {
    const int dy = tap / ksize - pad, dx = tap % ksize - pad;
    for (int c0 = 0; c0 < Ci; c0 += BK) {
      const int c = c0 + 4 * word;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 32 * r;
        const int hh = ph[r] + dy, ww = pw[r] + dx;
        int a = 0;
        if (pok[r] && hh >= 0 && hh < H && ww >= 0 && ww < W)
          a = load4(x + ((size_t)(pimg[r] * H + hh) * W + ww) * Ci, c, Ci,
                    vec);
        As[row][word] = a;
        const int n = n0 + row;
        Bs[row][word] =
            n < ncols ? load4(w + (size_t)n * K + (size_t)tap * Ci, c, Ci, vec)
                      : 0;
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
