// Kernel K1: mean SSIM per image, fused into one pass over x and y.
//
// Replaces the Pallas TPU kernel mrisr_tpu/ops/ssim_pallas.py
// (_ssim_pallas_batched / _make_kernel): skimage's structural_similarity
// defaults, a win x win uniform VALID window (7 by default), the five
// windowed moments of x, y, x*x, y*y and x*y, sample covariance
// NP / (NP - 1), C1 = (k1 R)^2, C2 = (k2 R)^2, and the mean of the
// (H - win + 1)(W - win + 1) map.  Forward only.
//
// What, not how: a Pallas program held one whole image in VMEM.  Here one
// block takes a TH x TW tile of the output map: it stages x and y with a
// (win - 1)-pixel halo in shared memory, forms the five vertical win-tap
// sums (rows first), then the horizontal win-tap sums (columns), computes
// SSIM per pixel, and reduces the tile's sum inside the block.  The window
// sums are direct sums in the order of the TPU kernel's _filt and of the
// plain version (ops/ssim.py): no running window or summed-area table,
// whose subtractions would cancel the digits that uxx - ux^2 needs.
// Products and the SSIM quotient use the _rn intrinsics, so nvcc cannot
// contract them into FMAs the plain version does not do.
//
// The cross-block reduction is deterministic: each block writes its tile
// sum to partial[(image, tile)], and a second launch sums each image's
// tiles in a fixed order (one warp per image, strided lanes, then a fixed
// shuffle tree).  No float atomics: the mean is the same on every run.
//
// Bound on the card (H100 SXM): 8 N H W bytes read and 4 N written at
// 3.35 TB/s, against about 86 fp32 operations per output pixel (5 x 2 (win-1)
// window adds, the scaling and the quotient) plus 3 products per input pixel
// at 67 TFLOP/s.  At 256^2 the bytes bound it, by about two to one.  This
// first design re-reads each tile's halo (22 x 70 staged for 16 x 64 out,
// mostly L2 hits) and keeps five vertical-sum maps in shared memory; a
// later version would slide the tile down the image in registers and read
// each input byte once.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TH = 16;       // output rows per block
constexpr int TW = 64;       // output columns per block
constexpr int THREADS = 256;
constexpr int FINISH_THREADS = 128;  // 4 warps, one image each

struct Consts {
  float inv;       // 1 / win^2
  float cov_norm;  // NP / (NP - 1)
  float c1, c2;
};

template <int WIN>
__global__ void __launch_bounds__(THREADS)
    ssim_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     float* __restrict__ partial, int H, int W, int tiles_x,
                     int tiles_per_img, Consts k) {
  constexpr int IH = TH + WIN - 1, IW = TW + WIN - 1;
  __shared__ float sx[IH][IW];
  __shared__ float sy[IH][IW];
  __shared__ float vs[5][TH][IW];
  __shared__ float warp_sums[THREADS / 32];

  const int bid = blockIdx.x;
  const int img = bid / tiles_per_img;
  const int t = bid - img * tiles_per_img;
  const int row0 = (t / tiles_x) * TH, col0 = (t % tiles_x) * TW;
  const int vh = H - WIN + 1, vw = W - WIN + 1;
  const size_t base = (size_t)img * H * W;
  const int tid = threadIdx.x;

  // stage the tile and its halo; outside the image reads as 0 (only
  // masked outputs ever use it)
  for (int i = tid; i < IH * IW; i += THREADS) {
    const int r = i / IW, c = i - r * IW;
    const int gr = row0 + r, gc = col0 + c;
    float a = 0.f, b = 0.f;
    if (gr < H && gc < W) {
      const size_t off = base + (size_t)gr * W + gc;
      a = __ldg(x + off);
      b = __ldg(y + off);
    }
    sx[r][c] = a;
    sy[r][c] = b;
  }
  __syncthreads();

  // vertical win-tap sums of the five moments
  for (int i = tid; i < TH * IW; i += THREADS) {
    const int r = i / IW, c = i - r * IW;
    float a = sx[r][c], b = sy[r][c];
    float s0 = a, s1 = b;
    float s2 = __fmul_rn(a, a), s3 = __fmul_rn(b, b), s4 = __fmul_rn(a, b);
#pragma unroll
    for (int d = 1; d < WIN; ++d) {
      a = sx[r + d][c];
      b = sy[r + d][c];
      s0 = __fadd_rn(s0, a);
      s1 = __fadd_rn(s1, b);
      s2 = __fadd_rn(s2, __fmul_rn(a, a));
      s3 = __fadd_rn(s3, __fmul_rn(b, b));
      s4 = __fadd_rn(s4, __fmul_rn(a, b));
    }
    vs[0][r][c] = s0;
    vs[1][r][c] = s1;
    vs[2][r][c] = s2;
    vs[3][r][c] = s3;
    vs[4][r][c] = s4;
  }
  __syncthreads();

  // horizontal win-tap sums, SSIM per pixel, this thread's share of the tile
  float local = 0.f;
  const int c = tid % TW;
  const bool col_ok = col0 + c < vw;
  for (int r = tid / TW; r < TH; r += THREADS / TW) {
    float m[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      float s = vs[q][r][c];
#pragma unroll
      for (int d = 1; d < WIN; ++d) s = __fadd_rn(s, vs[q][r][c + d]);
      m[q] = s;
    }
    if (!col_ok || row0 + r >= vh) continue;
    const float ux = __fmul_rn(m[0], k.inv), uy = __fmul_rn(m[1], k.inv);
    const float uxx = __fmul_rn(m[2], k.inv), uyy = __fmul_rn(m[3], k.inv);
    const float uxy = __fmul_rn(m[4], k.inv);
    const float uxux = __fmul_rn(ux, ux), uyuy = __fmul_rn(uy, uy);
    const float vx = __fmul_rn(k.cov_norm, __fsub_rn(uxx, uxux));
    const float vy = __fmul_rn(k.cov_norm, __fsub_rn(uyy, uyuy));
    const float vxy = __fmul_rn(k.cov_norm, __fsub_rn(uxy, __fmul_rn(ux, uy)));
    // 2 * ux * uy evaluated as (2 ux) uy, as the plain version does
    const float a1 = __fadd_rn(__fmul_rn(__fmul_rn(2.f, ux), uy), k.c1);
    const float a2 = __fadd_rn(__fmul_rn(2.f, vxy), k.c2);
    const float b1 = __fadd_rn(__fadd_rn(uxux, uyuy), k.c1);
    const float b2 = __fadd_rn(__fadd_rn(vx, vy), k.c2);
    local = __fadd_rn(local, __fdiv_rn(__fmul_rn(a1, a2), __fmul_rn(b1, b2)));
  }

  // the tile's sum, in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_xor_sync(0xffffffffu, local, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = local;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) s += warp_sums[i];
    partial[bid] = s;
  }
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
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[img] = s * inv_count;
}

template <int WIN>
void launch_tiles(const float* x, const float* y, float* partial, int n,
                  int H, int W, const Consts& k, cudaStream_t stream) {
  const int tiles_x = (W - WIN + 1 + TW - 1) / TW;
  const int tiles_y = (H - WIN + 1 + TH - 1) / TH;
  const int tiles = tiles_x * tiles_y;
  ssim_tile_kernel<WIN><<<(unsigned)(n * tiles), THREADS, 0, stream>>>(
      x, y, partial, H, W, tiles_x, tiles, k);
}

}  // namespace

// Number of partial sums per image: the wrapper allocates (N, this) scratch.
extern "C" int ssim_tiles(int H, int W, int win) {
  return ((W - win + 1 + TW - 1) / TW) * ((H - win + 1 + TH - 1) / TH);
}

// x, y: (n, H, W) float32 contiguous; partial: (n, ssim_tiles) float32
// scratch; out: (n,) float32.  c1 = (k1 R)^2 and c2 = (k2 R)^2, computed
// by the caller in double as the plain version does.  win odd in [3, 11],
// H, W >= win, and n * ssim_tiles below 2^31 (the wrapper checks).
// Returns cudaGetLastError() after both launches (0 = launched).
extern "C" int ssim_launch(const void* x, const void* y, void* partial,
                           void* out, int n, int H, int W, int win, float c1,
                           float c2, void* stream) {
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
  switch (win) {
    case 3: launch_tiles<3>(xp, yp, pp, n, H, W, k, s); break;
    case 5: launch_tiles<5>(xp, yp, pp, n, H, W, k, s); break;
    case 7: launch_tiles<7>(xp, yp, pp, n, H, W, k, s); break;
    case 9: launch_tiles<9>(xp, yp, pp, n, H, W, k, s); break;
    case 11: launch_tiles<11>(xp, yp, pp, n, H, W, k, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int tiles = ssim_tiles(H, W, win);
  const double count = (double)(H - win + 1) * (W - win + 1);
  const unsigned blocks = (unsigned)(((long long)n * 32 + FINISH_THREADS - 1) /
                                     FINISH_THREADS);
  ssim_finish_kernel<<<blocks, FINISH_THREADS, 0, s>>>(
      pp, static_cast<float*>(out), n, tiles, (float)(1.0 / count));
  return (int)cudaGetLastError();
}
