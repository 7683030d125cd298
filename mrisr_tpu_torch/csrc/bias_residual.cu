// A float conv's bias, and a residual block's closing add, in one pass:
// y = (y + b) + (r + rb), written in place into y, every sum rounded to
// y's type as torch rounds it.
//
// Replaces no Pallas kernel.  On the TPU, XLA fused a conv's bias into the
// conv and the residual add into whatever read it (mrisr_tpu/serve/
// quant_diffusion.py: the float sites' lax.conv_general_dilated + bias and
// the blocks' h + x).  On the card cuDNN runs a conv without its bias and
// torch adds the bias after it (output.add_(bias.reshape(1, C, 1, 1))): a
// broadcast add, which torch's vectorized elementwise kernel does not take,
// at about 1.3 TB/s over the full-size maps of every float conv; the
// block's h + x is a second pass over the same map.  Here the caller runs
// cuDNN without the bias and this kernel does both adds (and the shortcut
// conv's bias) in one read of y and r and one write of y:
//   bias only:        out = t(y + b)
//   with r:           out = t(t(y + b) + r)
//   with r and rb:    out = t(t(y + b) + t(r + rb))
// where t() rounds a float32 sum to y's type (round to nearest even, by the
// same cvt.rn instruction torch's bfloat16 conversion uses on sm_80+): torch's
// bias add, its add of the shortcut's bias and its h + x, bit for bit.
//
// Bound on the card (H100 SXM): bytes at 3.35 TB/s, 4 (bias only) or 6
// (with r) bytes an element in bfloat16; three float adds and conversions
// an element are far below the issue rate.  So the design is one
// streaming pass:
//   - a thread's unit is 16 bytes (8 bfloat16 or 4 float32 elements): one
//     16-byte load of y (and of r) and one 16-byte store; C % 8 == 0 keeps
//     a unit inside one pixel, so its bias is one 16-byte row slice;
//   - the bias rows (b, and rb) go to shared memory once a block, in y's
//     type; a thread tracks its unit's channel offset by adding the grid
//     stride modulo the row, no division a unit;
//   - each thread issues UNROLL units' loads before it adds and stores any
//     of them, and the grid is as many 512-thread blocks as the SMs hold at
//     once (or as the units need), striding over the map: no second wave;
//   - a scalar loop takes every element where y or r is not 16-byte
//     aligned.
//
// The gated form (gated_residual_launch), DiT's gated residual: x = t(x +
// f32(gate[b, c] * y)) in place into the residual stream x (bfloat16 or
// float32), y the float32 output of kernel A at a block's proj or fc2, the
// gate a float32 row an image (a slice of the adaLN rows, ld floats
// apart): one product and one sum an element, each rounded to float32
// (never contracted into an fma), then t(): torch's `x + gate * y` on
// float32 operands, bit for bit.  Its own kernel, with the same pass: a
// block takes one image (blockIdx.y), its gate row in shared memory, and
// strides over that image's 16-byte units of x (and 32 or 16 bytes of y);
// bytes at 3.35 TB/s bound it: 2 + 4 + 2 bytes an element in bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 2;
// the longest bias row: two rows of it in float32 fill 32 KB of shared
// memory, inside the default 48 KB a block
constexpr int MAX_C = 4096;

// bfloat16 -> float32 is exact: the 16 bits are the float's high half.
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Two bfloat16 lanes: bf16(f32(a) + f32(b)) each.
__device__ __forceinline__ uint32_t add_bf2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 s = __floats2bfloat162_rn(
      __fadd_rn(bf_lo(a), bf_lo(b)), __fadd_rn(bf_hi(a), bf_hi(b)));
  return *reinterpret_cast<const uint32_t*>(&s);
}

template <bool BF16>
struct Elem;

template <>
struct Elem<true> {
  static constexpr int PER_UNIT = 8;
  using T = uint16_t;
  static __device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
    return make_uint4(add_bf2(a.x, b.x), add_bf2(a.y, b.y),
                      add_bf2(a.z, b.z), add_bf2(a.w, b.w));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return static_cast<T>(add_bf2(a, b) & 0xffffu);
  }
};

template <>
struct Elem<false> {
  static constexpr int PER_UNIT = 4;
  using T = float;
  static __device__ __forceinline__ uint32_t add1(uint32_t a, uint32_t b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  static __device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
    return make_uint4(add1(a.x, b.x), add1(a.y, b.y), add1(a.z, b.z),
                      add1(a.w, b.w));
  }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
};

// y: n elements, rows of c channels (c % 8 == 0); b, rb: c elements; r: n
// elements or null.  units: whole 16-byte units of y (0 where y or r is not
// 16-byte aligned), the scalar loop takes the rest.
template <bool BF16, bool RES, bool RBIAS>
__global__ void __launch_bounds__(THREADS)
    bias_residual_kernel(void* __restrict__ y, const void* __restrict__ b,
                         const void* __restrict__ r,
                         const void* __restrict__ rb, long long n,
                         long long units, int c) {
  using E = Elem<BF16>;
  using T = typename E::T;
  extern __shared__ uint4 rows[];  // b's row, then rb's
  T* sb = reinterpret_cast<T*>(rows);
  T* srb = sb + c;  // c * sizeof(T) is a multiple of 16
  for (int i = threadIdx.x; i < c; i += THREADS) {
    sb[i] = static_cast<const T*>(b)[i];
    if (RBIAS) srb[i] = static_cast<const T*>(rb)[i];
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const int row = c / E::PER_UNIT;  // units a pixel
  const int step = static_cast<int>(stride % row);
  long long u = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  int k = static_cast<int>(u % row);  // u's unit within its pixel
  uint4* y4 = static_cast<uint4*>(y);
  const uint4* r4 = static_cast<const uint4*>(r);
  const uint4* b4 = reinterpret_cast<const uint4*>(sb);
  const uint4* rb4 = reinterpret_cast<const uint4*>(srb);
  auto next = [&](int kk) {
    kk += step;
    return kk >= row ? kk - row : kk;
  };
  auto finish = [&](uint4 v, uint4 w, int kk) {
    v = E::add(v, b4[kk]);
    if (RES) {
      if (RBIAS) w = E::add(w, rb4[kk]);
      v = E::add(v, w);
    }
    return v;
  };
  for (; u + (UNROLL - 1) * stride < units; u += UNROLL * stride) {
    uint4 v[UNROLL], w[UNROLL];
    int kk[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      kk[j] = k;
      k = next(k);
      v[j] = y4[u + j * stride];
      w[j] = RES ? __ldg(r4 + u + j * stride) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
      y4[u + j * stride] = finish(v[j], w[j], kk[j]);
  }
  for (; u < units; u += stride) {
    const uint4 w = RES ? __ldg(r4 + u) : make_uint4(0, 0, 0, 0);
    y4[u] = finish(y4[u], w, k);
    k = next(k);
  }
  T* ys = static_cast<T*>(y);
  const T* rs = static_cast<const T*>(r);
  for (long long i = units * E::PER_UNIT + blockIdx.x * THREADS + threadIdx.x;
       i < n; i += stride) {
    const int ch = static_cast<int>(i % c);
    T v = E::add(ys[i], sb[ch]);
    if (RES) v = E::add(v, RBIAS ? E::add(rs[i], srb[ch]) : rs[i]);
    ys[i] = v;
  }
}

template <bool BF16, bool RES, bool RBIAS>
int launch(void* y, const void* b, const void* r, const void* rb,
           long long n, int c, int sms, cudaStream_t s) {
  constexpr int per_unit = Elem<BF16>::PER_UNIT;
  constexpr size_t esize = sizeof(typename Elem<BF16>::T);
  const size_t smem = (RBIAS ? 2 : 1) * static_cast<size_t>(c) * esize;
  static int per_sm = 0;  // blocks an SM holds at once at the most shared
                          // memory a launch asks, asked once
  if (per_sm < 1) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bias_residual_kernel<BF16, RES, RBIAS>, THREADS,
        (RBIAS ? 2 : 1) * MAX_C * esize);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const bool aligned = reinterpret_cast<size_t>(y) % 16 == 0 &&
                       reinterpret_cast<size_t>(r) % 16 == 0;
  const long long units = aligned ? n / per_unit : 0;
  const long long work = units > 0 ? units : n;
  const long long blocks = (work + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * per_sm;
  bias_residual_kernel<BF16, RES, RBIAS>
      <<<static_cast<int>(blocks < cap ? blocks : cap), THREADS, smem, s>>>(
          y, b, r, rb, n, units, c);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int dispatch(void* y, const void* b, const void* r, const void* rb,
             long long n, int c, int sms, cudaStream_t s) {
  if (!r) return launch<BF16, false, false>(y, b, r, rb, n, c, sms, s);
  if (!rb) return launch<BF16, true, false>(y, b, r, rb, n, c, sms, s);
  return launch<BF16, true, true>(y, b, r, rb, n, c, sms, s);
}

// The gated form.  x: B images of T * c elements (bfloat16 or float32),
// in place; gate: B rows of c float32, ld floats apart; y: x's layout in
// float32.  x and y 16-byte aligned, c % 8 == 0.
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
    gated_residual_kernel(void* __restrict__ x,
                          const float* __restrict__ gate, long long ld,
                          const float* __restrict__ y, int T, int c) {
  constexpr int PER = Elem<BF16>::PER_UNIT;
  extern __shared__ uint4 rows[];
  float* g = reinterpret_cast<float*>(rows);
  const int img = blockIdx.y;
  for (int i = threadIdx.x; i < c; i += THREADS)
    g[i] = gate[static_cast<long long>(img) * ld + i];
  __syncthreads();

  const long long units = static_cast<long long>(T) * (c / PER);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const int row = c / PER;
  const int step = static_cast<int>(stride % row);
  long long u = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  int k = static_cast<int>(u % row);
  uint4* x4 = static_cast<uint4*>(x) + img * units;
  const float4* y4 = reinterpret_cast<const float4*>(y) +
                     img * units * (PER / 4);
  auto next = [&](int kk) {
    kk += step;
    return kk >= row ? kk - row : kk;
  };
  auto gated = [&](float xv, float yv, int ch) {
    return __fadd_rn(xv, __fmul_rn(g[ch], yv));
  };
  auto finish = [&](uint4 xv, const float4 (&yv)[PER / 4], int kk) {
    const int c0 = kk * PER;
    if constexpr (BF16) {
      const uint32_t w[4] = {xv.x, xv.y, xv.z, xv.w};
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4& q = yv[j / 2];
        const float y0 = (j & 1) ? q.z : q.x, y1 = (j & 1) ? q.w : q.y;
        const __nv_bfloat162 p = __floats2bfloat162_rn(
            gated(bf_lo(w[j]), y0, c0 + 2 * j),
            gated(bf_hi(w[j]), y1, c0 + 2 * j + 1));
        o[j] = *reinterpret_cast<const uint32_t*>(&p);
      }
      return make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      const float4& q = yv[0];
      return make_uint4(
          __float_as_uint(gated(__uint_as_float(xv.x), q.x, c0)),
          __float_as_uint(gated(__uint_as_float(xv.y), q.y, c0 + 1)),
          __float_as_uint(gated(__uint_as_float(xv.z), q.z, c0 + 2)),
          __float_as_uint(gated(__uint_as_float(xv.w), q.w, c0 + 3)));
    }
  };
  for (; u + (UNROLL - 1) * stride < units; u += UNROLL * stride) {
    uint4 v[UNROLL];
    float4 w[UNROLL][PER / 4];
    int kk[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      kk[j] = k;
      k = next(k);
      v[j] = x4[u + j * stride];
#pragma unroll
      for (int h = 0; h < PER / 4; ++h)
        w[j][h] = __ldcs(y4 + (u + j * stride) * (PER / 4) + h);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
      x4[u + j * stride] = finish(v[j], w[j], kk[j]);
  }
  for (; u < units; u += stride) {
    float4 w[PER / 4];
#pragma unroll
    for (int h = 0; h < PER / 4; ++h) w[h] = __ldcs(y4 + u * (PER / 4) + h);
    x4[u] = finish(x4[u], w, k);
    k = next(k);
  }
}

template <bool BF16>
int launch_gated(void* x, const float* gate, long long ld, const float* y,
                 int B, int T, int c, int sms, cudaStream_t s) {
  static int per_sm = 0;  // blocks an SM holds at once, asked once
  if (per_sm < 1) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gated_residual_kernel<BF16>, THREADS, MAX_C * 4);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long units =
      static_cast<long long>(T) * (c / Elem<BF16>::PER_UNIT);
  const long long need = (units + THREADS - 1) / THREADS;
  long long per_img = static_cast<long long>(sms) * per_sm / B;
  if (per_img < 1) per_img = 1;
  const dim3 grid(static_cast<unsigned>(need < per_img ? need : per_img), B);
  gated_residual_kernel<BF16><<<grid, THREADS, c * sizeof(float), s>>>(
      x, gate, ld, y, T, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The gated form: x (B images of T * c contiguous bfloat16 (bf16 = 1) or
// float32 elements) = x + gate[img] * y in place; gate: B rows of c
// float32, row i at gate + i * ld; y: x's layout in float32; x and y
// 16-byte aligned, c a multiple of 8 up to 4096; sms: the device's SM
// count.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gated_residual_launch(void* x, int bf16, const void* gate,
                                     long long ld, const void* y, long long n,
                                     int c, int B, int sms, void* stream) {
  if (n < 1 || c < 8 || c % 8 != 0 || c > MAX_C || B < 1 || B > 65535 ||
      n % (static_cast<long long>(B) * c) != 0 || ld < c || sms < 1 || !x ||
      !gate || !y ||
      (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(y)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long t = n / (static_cast<long long>(B) * c);
  if (t > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gate);
  const float* yf = static_cast<const float*>(y);
  return bf16 ? launch_gated<true>(x, g, ld, yf, B, static_cast<int>(t), c,
                                   sms, s)
              : launch_gated<false>(x, g, ld, yf, B, static_cast<int>(t), c,
                                    sms, s);
}

// y: n contiguous bfloat16 (bf16 = 1) or float32 elements, rows of c
// channels, updated in place; b: c elements of y's type; r: null or n
// elements of y's type (read only, not overlapping y); rb: null or c
// elements (r's bias; needs r); sms: the device's SM count.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int bias_residual_launch(void* y, int bf16, const void* b,
                                    const void* r, const void* rb,
                                    long long n, int c, int sms,
                                    void* stream) {
  if (n < 1 || c < 8 || c % 8 != 0 || c > MAX_C || n % c != 0 || sms < 1 ||
      !y || !b || (rb && !r))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<true>(y, b, r, rb, n, c, sms, s)
              : dispatch<false>(y, b, r, rb, n, c, sms, s);
}
