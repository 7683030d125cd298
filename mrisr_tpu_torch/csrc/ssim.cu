// Kernel K1: mean SSIM per image, fused into one pass over x and y.
//
// Replaces the Pallas TPU kernel mrisr_tpu/ops/ssim_pallas.py
// (_ssim_pallas_batched / _make_kernel): skimage's structural_similarity
// defaults, a win x win uniform VALID window (7 by default), the five
// windowed moments of x, y, x*x, y*y and x*y, sample covariance
// NP / (NP - 1), C1 = (k1 R)^2, C2 = (k2 R)^2, and the mean of the
// (H - win + 1)(W - win + 1) map.  Forward only.
//
// What, not how: a Pallas program held one whole image pair in VMEM and
// read it from HBM once.  Here one warp owns a strip of 128 output columns
// (4 adjacent columns a lane) and walks a band of output rows down the
// image, reading each input row of its strip once (16-byte loads, 512
// contiguous bytes of x and of y a warp and row):
//   - each lane keeps the last win rows of x and y for its 4 columns in
//     registers (a ring, unrolled by win so every index is static), and
//     lanes 0 .. win-2 keep one column each of the (win - 1)-column halo
//     past the strip;
//   - the five vertical win-tap sums come from those registers, rows first
//     (oldest row first);
//   - the horizontal win-tap sums take the neighbours' vertical sums with
//     __shfl_sync (the halo's are first gathered, 4 a lane, into lanes 0 ..
//     ceil((win - 1) / 4) - 1, which then stand in for lanes 32, 33, ...);
//   - SSIM per pixel, summed in the lane, then a fixed shuffle tree.
// No shared memory at all: each warp writes its sum to partial[(image,
// strip, band)], and a second launch adds each image's partials in a fixed
// order (one warp an image, strided lanes, then a fixed shuffle tree).  No
// float atomics: the mean is the same bits on every run.  Only the strip
// halo (6 of 128 columns at win 7) and the band halo (6 rows a band: 7 % at
// N = 174, 256^2, three bands of 84 rows) are read twice, from L2.  The
// plan (ops/ssim_fused.py:plan) picks the bands that fill whole waves of
// the blocks an SM holds (ssim_blocks_per_sm).
//
// The window sums are direct sums in the order of the TPU kernel's _filt
// and of the plain version (ops/ssim.py): no running window or summed-area
// table, whose subtractions would cancel the digits that uxx - ux^2 needs.
// Products and the SSIM quotient use the _rn intrinsics, so nvcc cannot
// contract them into FMAs the plain version does not do.
//
// Bound on the card (H100 SXM): 8 N H W bytes read and 4 N written at
// 3.35 TB/s: 27 us at N = 174, 256^2.  The arithmetic of this exact order
// is about 5 (win - 1) vertical and 5 (win - 1) horizontal adds, 3 win
// products and about 30 operations of the quotient an output pixel, none of
// them fusable (the _rn intrinsics), plus about 12 shuffles: near 150
// issued instructions an output pixel, or ~50 us at N = 174 on 132 SMs.
// The ring of 2 x 4 x win rows keeps a lane at about 200 registers, two
// 4-warp blocks an SM (8 warps): too few to hide the adds' and shuffles'
// latencies, so this kernel runs at about 40 % of its issue rate.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int COLS = 4;            // output columns a lane
constexpr int STRIP = 32 * COLS;   // ops/ssim_fused.py:STRIP
constexpr int WARPS = 4;           // warps (strip x band tiles) a block
constexpr int THREADS = 32 * WARPS;
constexpr int FINISH_THREADS = 128;  // 4 warps, one image each
constexpr unsigned FULL = 0xffffffffu;

struct Consts {
  float inv;       // 1 / win^2
  float cov_norm;  // NP / (NP - 1)
  float c1, c2;
};

// One input row of the lane's 4 columns and of its halo column; zeros
// outside the image (only masked outputs ever use them).
struct Row {
  float x[COLS], y[COLS], hx, hy;
};

__device__ __forceinline__ void load_row(const float* xr, const float* yr,
                                         int col, int hcol, bool halo, int W,
                                         bool vec, Row& r) {
  if (vec && col < W) {  // W % 4 == 0: the 4 columns are in or out together
    const float4 a = __ldg(reinterpret_cast<const float4*>(xr + col));
    const float4 b = __ldg(reinterpret_cast<const float4*>(yr + col));
    r.x[0] = a.x; r.x[1] = a.y; r.x[2] = a.z; r.x[3] = a.w;
    r.y[0] = b.x; r.y[1] = b.y; r.y[2] = b.z; r.y[3] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const bool in = col + i < W;
      r.x[i] = in ? __ldg(xr + col + i) : 0.f;
      r.y[i] = in ? __ldg(yr + col + i) : 0.f;
    }
  }
  const bool in = halo && hcol < W;
  r.hx = in ? __ldg(xr + hcol) : 0.f;
  r.hy = in ? __ldg(yr + hcol) : 0.f;
}

// Vertical win-tap sum of moment M (0 x, 1 y, 2 xx, 3 yy, 4 xy) over ring
// slots Q + 1, Q + 2, ..., Q + WIN (mod WIN): the oldest row first.
template <int WIN, int Q, int M>
__device__ __forceinline__ float vsum(const float (&a)[WIN],
                                      const float (&b)[WIN]) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < WIN; ++d) {
    const int k = (Q + 1 + d) % WIN;
    const float v = M == 0 ? a[k] : M == 1 ? b[k] : M == 2 ? __fmul_rn(a[k], a[k])
                  : M == 3 ? __fmul_rn(b[k], b[k]) : __fmul_rn(a[k], b[k]);
    s = d == 0 ? v : __fadd_rn(s, v);
  }
  return s;
}

// Moment M's horizontal win-tap sums at the lane's 4 output columns, from
// the vertical sums of its columns, its right neighbours' and the halo's.
template <int WIN, int Q, int M>
__device__ __forceinline__ void moment(const float (&rx)[WIN][COLS],
                                       const float (&ry)[WIN][COLS],
                                       const float (&hx)[WIN],
                                       const float (&hy)[WIN], int lane,
                                       float (&out)[COLS]) {
  float w[COLS + WIN - 1];  // vertical sums at columns 4 lane + 0 .. + WIN+2
  float own[COLS];
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    float a[WIN], b[WIN];
#pragma unroll
    for (int k = 0; k < WIN; ++k) {
      a[k] = rx[k][i];
      b[k] = ry[k][i];
    }
    own[i] = vsum<WIN, Q, M>(a, b);
    w[i] = own[i];
  }
  // halo column j (lane j) gathered to lane j / 4, register j % 4
  const float hv = vsum<WIN, Q, M>(hx, hy);
  float h[COLS];
#pragma unroll
  for (int i = 0; i < COLS; ++i)
    h[i] = __shfl_sync(FULL, hv, (COLS * lane + i) & 31);
  // column 4 lane + q lives at lane + q / 4, register q % 4; past lane 31
  // it is the halo, which lanes < q / 4 send instead
#pragma unroll
  for (int q = COLS; q < COLS + WIN - 1; ++q) {
    const int d = q / COLS, i = q % COLS;
    const float send = lane >= d ? own[i] : h[i];
    w[q] = __shfl_sync(FULL, send, (lane + d) & 31);
  }
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    float s = w[i];
#pragma unroll
    for (int d = 1; d < WIN; ++d) s = __fadd_rn(s, w[i + d]);
    out[i] = s;
  }
}

__device__ __forceinline__ float ssim_px(float m0, float m1, float m2,
                                         float m3, float m4, const Consts& k) {
  const float ux = __fmul_rn(m0, k.inv), uy = __fmul_rn(m1, k.inv);
  const float uxx = __fmul_rn(m2, k.inv), uyy = __fmul_rn(m3, k.inv);
  const float uxy = __fmul_rn(m4, k.inv);
  const float uxux = __fmul_rn(ux, ux), uyuy = __fmul_rn(uy, uy);
  const float vx = __fmul_rn(k.cov_norm, __fsub_rn(uxx, uxux));
  const float vy = __fmul_rn(k.cov_norm, __fsub_rn(uyy, uyuy));
  const float vxy = __fmul_rn(k.cov_norm, __fsub_rn(uxy, __fmul_rn(ux, uy)));
  // 2 * ux * uy evaluated as (2 ux) uy, as the plain version does
  const float a1 = __fadd_rn(__fmul_rn(__fmul_rn(2.f, ux), uy), k.c1);
  const float a2 = __fadd_rn(__fmul_rn(2.f, vxy), k.c2);
  const float b1 = __fadd_rn(__fadd_rn(uxux, uyuy), k.c1);
  const float b2 = __fadd_rn(__fadd_rn(vx, vy), k.c2);
  return __fdiv_rn(__fmul_rn(a1, a2), __fmul_rn(b1, b2));
}

// Input row i of the band enters ring slot Q = i % WIN; from row WIN - 1 on,
// the ring holds the window of output row i - WIN + 1.
template <int WIN, int Q>
__device__ __forceinline__ void step(const Row& r, int i, int lane,
                                     float (&rx)[WIN][COLS],
                                     float (&ry)[WIN][COLS],
                                     float (&hx)[WIN], float (&hy)[WIN],
                                     bool ok0, int ncols, float& acc,
                                     const Consts& k) {
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    rx[Q][c] = r.x[c];
    ry[Q][c] = r.y[c];
  }
  hx[Q] = r.hx;
  hy[Q] = r.hy;
  if (i < WIN - 1) return;  // uniform across the warp
  float m[5][COLS];
  moment<WIN, Q, 0>(rx, ry, hx, hy, lane, m[0]);
  moment<WIN, Q, 1>(rx, ry, hx, hy, lane, m[1]);
  moment<WIN, Q, 2>(rx, ry, hx, hy, lane, m[2]);
  moment<WIN, Q, 3>(rx, ry, hx, hy, lane, m[3]);
  moment<WIN, Q, 4>(rx, ry, hx, hy, lane, m[4]);
  if (!ok0) return;
#pragma unroll
  for (int c = 0; c < COLS; ++c)
    if (c < ncols)
      acc = __fadd_rn(acc, ssim_px(m[0][c], m[1][c], m[2][c], m[3][c],
                                   m[4][c], k));
}

template <int WIN, int Q = 0>
__device__ __forceinline__ void steps(const float* xi, const float* yi,
                                      int r0, int base, int R, int W,
                                      int col, int hcol, bool halo, bool vec,
                                      int lane, Row& next,
                                      float (&rx)[WIN][COLS],
                                      float (&ry)[WIN][COLS],
                                      float (&hx)[WIN], float (&hy)[WIN],
                                      bool ok0, int ncols, float& acc,
                                      const Consts& k) {
  if constexpr (Q < WIN) {
    const int i = base + Q;
    if (i >= R) return;
    const Row cur = next;
    if (i + 1 < R) {  // load the next row while this one is summed
      const size_t off = (size_t)(r0 + i + 1) * W;
      load_row(xi + off, yi + off, col, hcol, halo, W, vec, next);
    }
    step<WIN, Q>(cur, i, lane, rx, ry, hx, hy, ok0, ncols, acc, k);
    steps<WIN, Q + 1>(xi, yi, r0, base, R, W, col, hcol, halo, vec, lane,
                      next, rx, ry, hx, hy, ok0, ncols, acc, k);
  }
}

template <int WIN>
__global__ void __launch_bounds__(THREADS)
    ssim_strip_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      float* __restrict__ partial, int n, int H, int W,
                      int strips, int bands, int band, int vec, Consts k) {
  const int lane = threadIdx.x & 31;
  const int tiles = strips * bands;
  const int wid = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (wid >= n * tiles) return;  // the whole warp
  const int img = wid / tiles, t = wid - img * tiles;
  const int s = t / bands, b = t - s * bands;
  const int vh = H - WIN + 1, vw = W - WIN + 1;
  const int c0 = s * STRIP, col = c0 + COLS * lane;
  const int o0 = b * band, o1 = min(o0 + band, vh);  // output rows
  const int R = o1 - o0 + WIN - 1;                    // input rows
  const int ncols = max(0, min(COLS, vw - col));      // valid output columns
  const bool halo = lane < WIN - 1;
  const int hcol = c0 + STRIP + lane;
  const float* xi = x + (size_t)img * H * W;
  const float* yi = y + (size_t)img * H * W;

  float rx[WIN][COLS], ry[WIN][COLS], hx[WIN], hy[WIN];
  Row next;
  load_row(xi + (size_t)o0 * W, yi + (size_t)o0 * W, col, hcol, halo, W,
           vec != 0, next);
  float acc = 0.f;
  for (int base = 0; base < R; base += WIN)
    steps<WIN>(xi, yi, o0, base, R, W, col, hcol, halo, vec != 0, lane, next,
               rx, ry, hx, hy, ncols > 0, ncols, acc, k);
  // the warp's sum, in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) partial[wid] = acc;
}

__global__ void __launch_bounds__(FINISH_THREADS)
    ssim_finish_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int n, int tiles,
                       float inv_count) {
  const int img = (blockIdx.x * FINISH_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (img >= n) return;  // uniform across the warp
  const float* p = partial + (size_t)img * tiles;
  float s = 0.f;
  for (int i = lane; i < tiles; i += 32) s += p[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) out[img] = s * inv_count;
}

template <int WIN>
void launch_strips(const float* x, const float* y, float* partial, int n,
                   int H, int W, int strips, int bands, int band, int vec,
                   const Consts& k, cudaStream_t stream) {
  const long long warps = (long long)n * strips * bands;
  ssim_strip_kernel<WIN><<<(unsigned)((warps + WARPS - 1) / WARPS), THREADS,
                           0, stream>>>(x, y, partial, n, H, W, strips, bands,
                                        band, vec, k);
}

}  // namespace

// Blocks of the strip kernel an SM holds at once for window `win` (the
// plan's wave size), 0 on an unsupported window.
extern "C" int ssim_blocks_per_sm(int win) {
  int n = 0;
  cudaError_t e = cudaErrorInvalidValue;
  switch (win) {
    case 3: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssim_strip_kernel<3>, THREADS, 0); break;
    case 5: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssim_strip_kernel<5>, THREADS, 0); break;
    case 7: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssim_strip_kernel<7>, THREADS, 0); break;
    case 9: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssim_strip_kernel<9>, THREADS, 0); break;
    case 11: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssim_strip_kernel<11>, THREADS, 0); break;
  }
  return e == cudaSuccess ? n : 0;
}

// x, y: (n, H, W) float32 contiguous; partial: (n, strips * bands) float32
// scratch; out: (n,) float32.  The tiling (ops/ssim_fused.py:plan): strips
// of 128 output columns, bands of `band` output rows, strips * 128 >=
// W - win + 1 and bands * band >= H - win + 1, neither with an empty tile.
// c1 = (k1 R)^2 and c2 = (k2 R)^2, computed by the caller in double as the
// plain version does.  win odd in [3, 11], H, W >= win, and n * strips *
// bands below 2^31 (the wrapper checks).  Returns cudaGetLastError() after
// both launches (0 = launched).
extern "C" int ssim_launch(const void* x, const void* y, void* partial,
                           void* out, int n, int H, int W, int win,
                           int strips, int bands, int band, float c1,
                           float c2, void* stream) {
  const int vh = H - win + 1, vw = W - win + 1;
  if (n < 1 || vh < 1 || vw < 1 || strips < 1 || bands < 1 || band < 1 ||
      (long long)(strips - 1) * STRIP >= vw ||
      (long long)strips * STRIP < vw || (long long)(bands - 1) * band >= vh ||
      (long long)bands * band < vh)
    return (int)cudaErrorInvalidValue;
  const double np_ = (double)win * win;
  Consts k;
  k.inv = (float)(1.0 / np_);
  k.cov_norm = (float)(np_ / (np_ - 1.0));
  k.c1 = c1;
  k.c2 = c2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* yp = static_cast<const float*>(y);
  float* pp = static_cast<float*>(partial);
  const int vec = W % 4 == 0 && reinterpret_cast<size_t>(xp) % 16 == 0 &&
                  reinterpret_cast<size_t>(yp) % 16 == 0;
  switch (win) {
    case 3: launch_strips<3>(xp, yp, pp, n, H, W, strips, bands, band, vec, k, s); break;
    case 5: launch_strips<5>(xp, yp, pp, n, H, W, strips, bands, band, vec, k, s); break;
    case 7: launch_strips<7>(xp, yp, pp, n, H, W, strips, bands, band, vec, k, s); break;
    case 9: launch_strips<9>(xp, yp, pp, n, H, W, strips, bands, band, vec, k, s); break;
    case 11: launch_strips<11>(xp, yp, pp, n, H, W, strips, bands, band, vec, k, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int tiles = strips * bands;
  const double count = (double)vh * vw;
  const unsigned blocks = (unsigned)(((long long)n * 32 + FINISH_THREADS - 1) /
                                     FINISH_THREADS);
  ssim_finish_kernel<<<blocks, FINISH_THREADS, 0, s>>>(
      pp, static_cast<float*>(out), n, tiles, (float)(1.0 / count));
  return (int)cudaGetLastError();
}
