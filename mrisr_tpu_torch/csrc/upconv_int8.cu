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
// bytes bound it (chip_smoke.py computes both).  This first design shares
// kernel A's __dp4a main loop (igemm_int8.cuh says what that leaves on the
// table).
//
// Weights: w2t is (4*Co, C) int8, K-contiguous (ops/upconv.py:pack_upconv
// returns its (C, 4*Co) transpose view, the reference's layout).
// s4, b4: (4*Co,) float32, the per-channel factors tiled over the phases.
//
// Float mode (OUT_FLOAT): the epilogue stops at acc * s4 + b4 and writes
// float32, with no requant and no skip, as kernel A's float mode does.  The
// Fast-DDPM int8 sampler dequantizes its upconv3/upconv2 outputs into the
// float decoder this way (mrisr_tpu/serve/quant_diffusion.py:545-550).

#include "igemm_int8.cuh"

using namespace igemm;

template <bool OUT_FLOAT>
__global__ void __launch_bounds__(THREADS)
    upconv_int8_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w2t,
                       const float* __restrict__ s4,
                       const float* __restrict__ b4,
                       const int8_t* __restrict__ skip,
                       void* __restrict__ out, int N, int H, int W, int C,
                       int Co, int Cs) {
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
      const size_t op =
          ((size_t)img * 2 * H + 2 * h + (ph >> 1)) * 2 * W + 2 * w + (ph & 1);
      const float y = dequant(acc[i][j], s4[col], b4[col]);
      if constexpr (OUT_FLOAT)
        static_cast<float*>(out)[op * Ct + co] = y;
      else
        static_cast<int8_t*>(out)[op * Ct + co] = requant(y);
    }
  }
  if constexpr (OUT_FLOAT) return;
  if (Cs == 0 || blockIdx.y != 0) return;
  int8_t* out8 = static_cast<int8_t*>(out);
  // fused concat: the column-0 blocks copy skip for the 4 output pixels of
  // each of their input pixels, 4 bytes at a time where alignment allows
  const bool vec = (Co % 4 == 0) && (Cs % 4 == 0);
  const int unit = vec ? 4 : 1, per = Cs / unit;
  for (int e = tid; e < BM * 4 * per; e += THREADS) {
    const int u = e % per, q = e / per;  // q = (local input pixel, phase)
    const int m = m0 + q / 4, ph = q % 4;
    if (m >= M) break;  // q grows with e
    const int w = m % W, t = m / W, h = t % H, img = t / H;
    const size_t op =
        ((size_t)img * 2 * H + 2 * h + (ph >> 1)) * 2 * W + 2 * w + (ph & 1);
    if (vec)
      *reinterpret_cast<int*>(out8 + op * Ct + Co + 4 * u) =
          __ldg(reinterpret_cast<const int*>(skip + op * Cs + 4 * u));
    else
      out8[op * Ct + Co + u] = skip[op * Cs + u];
  }
}

// Returns cudaGetLastError() after the launch (0 = launched).  skip may be
// null (Cs = 0); out_float writes float32 and takes no skip.
extern "C" int upconv_int8_launch(const void* x, const void* w2t,
                                  const void* s4, const void* b4,
                                  const void* skip, void* out, int N, int H,
                                  int W, int C, int Co, int Cs, int out_float,
                                  void* stream) {
  if (out_float && Cs != 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((4 * Co + BN - 1) / BN));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xi = static_cast<const int8_t*>(x);
  const auto wi = static_cast<const int8_t*>(w2t);
  const auto sf = static_cast<const float*>(s4);
  const auto bf = static_cast<const float*>(b4);
  const auto sk = static_cast<const int8_t*>(skip);
  if (out_float)
    upconv_int8_kernel<true><<<grid, THREADS, 0, st>>>(xi, wi, sf, bf, sk, out,
                                                       N, H, W, C, Co, Cs);
  else
    upconv_int8_kernel<false><<<grid, THREADS, 0, st>>>(
        xi, wi, sf, bf, sk, out, N, H, W, C, Co, Cs);
  return (int)cudaGetLastError();
}
