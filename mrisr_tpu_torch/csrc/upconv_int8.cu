// Kernel B: int8 ConvTranspose(k=2, s=2) with the requantizing epilogue and
// the decoder's skip concat fused into the output store.
//
// Replaces the Pallas TPU kernel mrisr_tpu/ops/upconv_pallas.py
// (upconv2x2_int8 / _upconv_call / _make_kernel).  With kernel == stride the
// transposed conv is one (N*H*W, C) @ (C, 4*Co) product: column
// n = (a*2 + b)*Co + co of input pixel (h, w) lands at output pixel
// (2h + a, 2w + b), channel co.  On the TPU that phase interleave was a
// relayout Mosaic could not compile; here it is only the store address.
// With `skip`, the same kernel writes skip's Cs channels into channels
// [Co, Co + Cs) of each output pixel, so the concatenated decoder input
// crosses device memory once.
//
// Bound on the card (H100 SXM): the larger of 2 * N*H*W * C * 4Co
// operations at the int8 tensor-core rate (1,979 TOP/s) and the bytes of x,
// w2t, skip and the output at 3.35 TB/s.  At the decoder's widths that is
// a few hundred operations per byte, below the ridge of about 590, so the
// bytes bound it (chip_smoke.py computes both).
//
// Two paths, chosen by shape alone (ops/upconv.py:upconv_path): the
// tensor-core main loop of kernel A (wgmma_int8.cuh, a 1x1 "conv" over the
// same 4-D tensor map) for C a multiple of 16 -- every UNet and Fast-DDPM
// site -- and the __dp4a loop (igemm_int8.cuh) for the rest.  The
// tensor-core epilogue stages the tile in shared memory and stores 16
// contiguous bytes of one output pixel's channels per thread where Co
// allows; the skip concat is shared by the column blocks of a pixel
// rectangle, 16 bytes a copy where the channel counts allow.
//
// Weights: w2t is (4*Co, C) int8, K-contiguous (ops/upconv.py:pack_upconv
// returns its (C, 4*Co) transpose view, the reference's layout).
// s4, b4: (4*Co,) float32, the per-channel factors tiled over the phases.
//
// Float mode (OUT_FLOAT): the epilogue stops at acc * s4 + b4 and writes
// float32, with no requant and no skip, as kernel A's float mode does.  The
// Fast-DDPM int8 sampler dequantizes its upconv3/upconv2 outputs into the
// float decoder this way (mrisr_tpu/serve/quant_diffusion.py:545-550).

#include "wgmma_int8.cuh"

using namespace igemm;

// Output pixel (flat index) of phase ph of input pixel (img, h, w).
__device__ __forceinline__ size_t out_pixel(int img, int h, int w, int ph,
                                            int H, int W) {
  return ((size_t)img * 2 * H + 2 * h + (ph >> 1)) * 2 * W + 2 * w + (ph & 1);
}

// Channels [Co, Co + Cs) of the 4 output pixels of each input pixel q =
// q0, q0 + qstep, ... < npix of the block, `pixel(q, img, h, w)` false
// past the image: `unit` bytes a copy.
template <class Pixel>
__device__ __forceinline__ void copy_skip(const int8_t* __restrict__ skip,
                                          int8_t* __restrict__ out, int q0,
                                          int qstep, int npix, int H, int W,
                                          int Co, int Cs, int unit,
                                          Pixel pixel) {
  const int per = Cs / unit, Ct = Co + Cs;
  const int nq = (npix - q0 + qstep - 1) / qstep;
  for (int e = threadIdx.x; e < nq * 4 * per; e += blockDim.x) {
    const int u = e % per, t = e / per;
    int img, h, w;
    if (!pixel(q0 + (t >> 2) * qstep, img, h, w)) continue;
    const size_t op = out_pixel(img, h, w, t & 3, H, W);
    const int8_t* src = skip + op * Cs + u * unit;
    int8_t* dst = out + op * Ct + Co + u * unit;
    if (unit == 16)
      *reinterpret_cast<int4*>(dst) = __ldg(reinterpret_cast<const int4*>(src));
    else if (unit == 4)
      *reinterpret_cast<int*>(dst) = __ldg(reinterpret_cast<const int*>(src));
    else
      *dst = *src;
  }
}

template <bool OUT_FLOAT>
__global__ void __launch_bounds__(THREADS)
    upconv_int8_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w2t,
                       const float* __restrict__ s4,
                       const float* __restrict__ b4,
                       const int8_t* __restrict__ skip,
                       void* __restrict__ out, int N, int H, int W, int C,
                       int Co, int Cs, int unit) {
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  int acc[4][4];
  mainloop(x, w2t, N, H, W, C, 4 * Co, 1, m0, n0, acc);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = N * H * W, Ct = Co + Cs;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const int w = m % W, t = m / W, h = t % H, img = t / H;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= 4 * Co) continue;
      const int ph = col / Co, co = col - ph * Co;
      const size_t op = out_pixel(img, h, w, ph, H, W);
      const float y = dequant(acc[i][j], s4[col], b4[col]);
      if constexpr (OUT_FLOAT)
        static_cast<float*>(out)[op * Ct + co] = y;
      else
        static_cast<int8_t*>(out)[op * Ct + co] = requant(y);
    }
  }
  if constexpr (OUT_FLOAT) return;
  if (Cs == 0 || blockIdx.y != 0) return;
  copy_skip(skip, static_cast<int8_t*>(out), 0, 1, BM, H, W, Co, Cs, unit,
            [&](int q, int& img, int& h, int& w) {
              const int m = m0 + q;
              if (m >= M) return false;
              w = m % W;
              const int t = m / W;
              h = t % H;
              img = t / H;
              return true;
            });
}

// The tensor-core path: `vec` = a 16-byte chunk of columns stays in one
// phase and lands 16-byte aligned (Co and Co + Cs multiples of 16 / element
// size).
template <int BN, bool OUT_FLOAT>
__global__ void __launch_bounds__(tc::THREADS, tc::MIN_BLOCKS)
    upconv_int8_tc_kernel(const __grid_constant__ CUtensorMap mapA,
                          const __grid_constant__ CUtensorMap mapB,
                          const float* __restrict__ s4,
                          const float* __restrict__ b4,
                          const int8_t* __restrict__ skip,
                          void* __restrict__ out, int H, int W, int C, int Co,
                          int Cs, int bw, int vec, int unit) {
  uint8_t* smem = tc::smem_base();
  const tc::Tile t = tc::tile_of(H, W, bw);
  const int n0 = blockIdx.y * BN, ncols = 4 * Co, Ct = Co + Cs;
  int acc[BN / 2];
  if (tc::mainloop<BN>(mapA, mapB, smem, t, C, 1, n0, acc)) {
    using L = tc::Layout<BN>;
    constexpr int ES = OUT_FLOAT ? 4 : 1;
    constexpr int CH = 16 / ES;
    constexpr int PITCH = OUT_FLOAT ? L::PITCH_F32 : L::PITCH_I8;
    const int wg = threadIdx.x >> 7;
    uint8_t* stg = tc::staging<BN>(smem);
    tc::stage_tile<BN, OUT_FLOAT>(acc, stg, s4, b4, n0, ncols, false);
    uint8_t* out8 = static_cast<uint8_t*>(out);
    for (int e = threadIdx.x & 127; e < 64 * (BN / CH); e += 128) {
      const int row = e / (BN / CH), col = (e % (BN / CH)) * CH;
      const int r = wg * 64 + row, n = n0 + col;
      const int h = t.h0 + r / bw, ww = t.w0 + r % bw;
      if (h >= H || ww >= W || n >= ncols) continue;
      const uint8_t* src = stg + row * PITCH + col * ES;
      if (vec) {
        const int ph = n / Co;
        const size_t o = out_pixel(t.img, h, ww, ph, H, W) * Ct + n - ph * Co;
        *reinterpret_cast<int4*>(out8 + o * ES) =
            *reinterpret_cast<const int4*>(src);
      } else {
        for (int j = 0; j < CH && n + j < ncols; ++j) {
          const int ph = (n + j) / Co;
          const size_t o =
              out_pixel(t.img, h, ww, ph, H, W) * Ct + n + j - ph * Co;
          if constexpr (OUT_FLOAT)
            reinterpret_cast<float*>(out8)[o] =
                reinterpret_cast<const float*>(src)[j];
          else
            out8[o] = src[j];
        }
      }
    }
  }
  // the concat: each column block copies every gridDim.y-th pixel's skip
  if constexpr (OUT_FLOAT) return;
  if (Cs == 0) return;
  copy_skip(skip, static_cast<int8_t*>(out), blockIdx.y, gridDim.y, tc::BM,
            H, W, Co, Cs, unit,
            [&](int q, int& img, int& h, int& w) {
              img = t.img;
              h = t.h0 + q / bw;
              w = t.w0 + q % bw;
              return h < H && w < W;
            });
}

template <int BN, bool OUT_FLOAT>
static int launch_tc(const int8_t* x, const int8_t* w2t, const float* s4,
                     const float* b4, const int8_t* skip, void* out, int N,
                     int H, int W, int C, int Co, int Cs, int unit,
                     cudaStream_t st) {
  const int bw = tc::tile_width(W);
  CUtensorMap mapA, mapB;
  int err = tc::encode_act(&mapA, x, N, H, W, C, bw);
  if (err == 0) err = tc::encode_weights(&mapB, w2t, 4 * Co, 1, C, BN);
  if (err != 0) return err;
  const int smem = tc::Layout<BN>::SMEM;
  static std::atomic<uint64_t> smem_set{0};
  err = tc::allow_smem(
      reinterpret_cast<const void*>(upconv_int8_tc_kernel<BN, OUT_FLOAT>),
      smem, smem_set);
  if (err != 0) return err;
  constexpr int CH = OUT_FLOAT ? 4 : 16;
  const int vec = Co % CH == 0 && (Co + Cs) % CH == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  upconv_int8_tc_kernel<BN, OUT_FLOAT>
      <<<tc::grid_of(N, H, W, bw, 4 * Co, BN), tc::THREADS, smem, st>>>(
          mapA, mapB, s4, b4, skip, out, H, W, C, Co, Cs, bw, vec, unit);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 = launched), or a
// tc::ERR_* code when a tensor map does not encode.  skip may be null
// (Cs = 0); out_float writes float32 and takes no skip.  path: 0 = dp4a,
// 1 = tensor cores (the caller checks C % 16 == 0 and 16-byte aligned x
// and w2t).
extern "C" int upconv_int8_launch(const void* x, const void* w2t,
                                  const void* s4, const void* b4,
                                  const void* skip, void* out, int N, int H,
                                  int W, int C, int Co, int Cs, int out_float,
                                  int path, void* stream) {
  if (out_float && Cs != 0) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xi = static_cast<const int8_t*>(x);
  const auto wi = static_cast<const int8_t*>(w2t);
  const auto sf = static_cast<const float*>(s4);
  const auto bf = static_cast<const float*>(b4);
  const auto sk = static_cast<const int8_t*>(skip);
  // widest copy of the skip concat that the channel counts and the two
  // pointers keep aligned
  const uintptr_t align = reinterpret_cast<uintptr_t>(skip) |
                          reinterpret_cast<uintptr_t>(out);
  const int unit = Co % 16 == 0 && Cs % 16 == 0 && align % 16 == 0 ? 16
                   : Co % 4 == 0 && Cs % 4 == 0 && align % 4 == 0   ? 4
                                                                    : 1;
  if (path == 1) {
    if (C % 16 != 0 || 4 * Co < 8) return (int)cudaErrorInvalidValue;
    if (4 * Co <= 64)
      return out_float ? launch_tc<64, true>(xi, wi, sf, bf, sk, out, N, H, W,
                                             C, Co, Cs, unit, st)
                       : launch_tc<64, false>(xi, wi, sf, bf, sk, out, N, H,
                                              W, C, Co, Cs, unit, st);
    return out_float ? launch_tc<128, true>(xi, wi, sf, bf, sk, out, N, H, W,
                                            C, Co, Cs, unit, st)
                     : launch_tc<128, false>(xi, wi, sf, bf, sk, out, N, H, W,
                                             C, Co, Cs, unit, st);
  }
  if (C >= 1 << 16) return (int)cudaErrorInvalidValue;  // mainloop's c field
  const long long M = (long long)N * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((4 * Co + BN - 1) / BN));
  if (out_float)
    upconv_int8_kernel<true><<<grid, THREADS, 0, st>>>(
        xi, wi, sf, bf, sk, out, N, H, W, C, Co, Cs, unit);
  else
    upconv_int8_kernel<false><<<grid, THREADS, 0, st>>>(
        xi, wi, sf, bf, sk, out, N, H, W, C, Co, Cs, unit);
  return (int)cudaGetLastError();
}
