// Kernel L: a LayerNorm over each token's C channels (no affine), then
// DiT's modulation by per-image rows, in one pass:
//   y = ((x - mean) * rstd) * (1 + scale[b, c]) + shift[b, c]
// emitting the int8 codes of the next int8 site's input (clamp(rint(y /
// a), +-127), a = its per-step activation scale, read from the device) or
// y in x's type (the final layer, which stays float).
//
// Replaces no Pallas kernel: the JAX package serves no transformer.  K3
// (groupnorm_silu.cu) cannot take this norm: its statistics run over a
// GroupNorm's (H, W, C / G) of a whole map in one cooperative launch, and
// its scale-shift form applies guided-diffusion's (scale, shift) rows.
// Here the statistics are a row's: one token's C channels.
//
// Statistics: float64 sums of the row's values (a bfloat16 value, and its
// square, is exact in float64, and so are sums of a row's worth of them
// unless their magnitudes span about 2^13), then, with r = 1 / C,
//   mean = s r,  var = max(s2 r - mean^2, 0),  rstd = 1 / sqrt(var + eps)
// in float64, each rounded once to float32.  Exact sums do not depend on
// their order, so the plain version (ops/layernorm.py), which sums in
// torch's order, gets the same mean and rstd; every later operation is one
// IEEE-rounded float32 operation in a fixed order (no contraction into
// fma), and the codes take the quantizer's true division and ties-to-even
// rounding: the plain version's codes and bits.
//
// Bound on the card (H100 SXM): bytes at 3.35 TB/s: x read once (2 bytes
// an element in bfloat16), the codes (1) or y (2) written once, and the
// (B, 2 C) float32 rows read once.  The float64 sums (two operations an
// element, at half the float32 rate) and about fifteen float32 operations
// an element stay below the memory time.  So the design is one pass:
//   - one warp a token: each lane loads 16-byte units (8 bfloat16 or 4
//     float32 values) of the row into registers, MAXU units at the most
//     (the host picks MAXU from C), sums them, and the warp's butterfly
//     shuffles give every lane the row's sums; the row is normalized from
//     the registers, so x is read once; a warp takes 8 tokens one after
//     another and loads the next while it reduces and writes this one
//     (without that a warp waited on memory for each token in turn: 34-48
//     % of the byte bound at DiT's shape);
//   - a block (8 warps) takes 64 consecutive tokens of one image
//     (blockIdx.y): its (1 + scale) and shift rows go to shared memory
//     once, in float32, element j of every unit together ([j][unit]), so
//     the lanes, on consecutive units, read consecutive words (a unit's
//     8 consecutive floats would put 8 lanes on one bank);
//   - codes go out 8 (or 4) a store, a float row 16 bytes a store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 8;  // tokens a warp takes in its block's chunk
constexpr int MAX_C = 4096;
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23: rint by one add

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The quantizer's code of one value (csrc/quantize_int8.cu): true
// division, clamp, round half to even; NaN -> 0.
__device__ __forceinline__ uint32_t code(float v, float a) {
  const float q = __fdiv_rn(v, a);
  if (isnan(q)) return 0;
  const float c = fminf(fmaxf(q, -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(c, MAGIC)) & 0xffu;
}

// One 16-byte unit: its values as float32, and a store of PER results.
template <bool BF16>
struct Unit;

template <>
struct Unit<true> {
  static constexpr int PER = 8;
  static __device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
    f[0] = bf_lo(u.x), f[1] = bf_hi(u.x), f[2] = bf_lo(u.y),
    f[3] = bf_hi(u.y), f[4] = bf_lo(u.z), f[5] = bf_hi(u.z),
    f[6] = bf_lo(u.w), f[7] = bf_hi(u.w);
  }
  static __device__ __forceinline__ void store_codes(void* out, long long u,
                                                     const float (&y)[8],
                                                     float a) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= code(y[j], a) << (8 * j);
      hi |= code(y[4 + j], a) << (8 * j);
    }
    static_cast<uint2*>(out)[u] = make_uint2(lo, hi);
  }
  static __device__ __forceinline__ void store_float(void* out, long long u,
                                                     const float (&y)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&p);
    }
    static_cast<uint4*>(out)[u] = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Unit<false> {
  static constexpr int PER = 4;
  static __device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y),
    f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ void store_codes(void* out, long long u,
                                                     const float (&y)[4],
                                                     float a) {
    static_cast<uint32_t*>(out)[u] = code(y[0], a) | code(y[1], a) << 8 |
                                     code(y[2], a) << 16 |
                                     code(y[3], a) << 24;
  }
  static __device__ __forceinline__ void store_float(void* out, long long u,
                                                     const float (&y)[4]) {
    static_cast<float4*>(out)[u] = make_float4(y[0], y[1], y[2], y[3]);
  }
};

// x: B * T rows of C values, 16-byte aligned; ss: B rows of (shift C,
// scale C) float32, ld floats apart; qscale: the codes' activation scale
// (CODES); out: codes or x's type, x's layout.
template <bool BF16, bool CODES, int MAXU>
__global__ void __launch_bounds__(THREADS)
    layernorm_modulate_kernel(const void* __restrict__ x,
                              const float* __restrict__ ss, long long ld,
                              const float* __restrict__ qscale,
                              void* __restrict__ out, int T, int C,
                              double eps) {
  using U = Unit<BF16>;
  constexpr int PER = U::PER;
  extern __shared__ float rows[];
  float* opsc = rows;  // 1 + scale, [j][unit]
  float* shift = rows + C;
  const int b = blockIdx.y;
  const int units = C / PER, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* mod = ss + static_cast<long long>(b) * ld;
  for (int i = threadIdx.x; i < C; i += THREADS) {
    const int at = (i % PER) * units + i / PER;
    shift[at] = mod[i];
    opsc[at] = __fadd_rn(1.0f, mod[C + i]);
  }
  __syncthreads();
  const float a = CODES ? __ldg(qscale) : 0.0f;
  const uint4* x4 = static_cast<const uint4*>(x);
  const double inv_c = 1.0 / static_cast<double>(C);
  const int t0 = blockIdx.x * (WARPS * ROWS) + warp;
  auto load = [&](uint4(&v)[MAXU], int t) {
    const long long base = (static_cast<long long>(b) * T + t) * units;
#pragma unroll
    for (int k = 0; k < MAXU; ++k) {
      const int u = lane + 32 * k;
      if (u < units) v[k] = __ldcs(x4 + base + u);  // read once: stream it
    }
  };
  // the warp's next token is loaded while this one is reduced and written
  uint4 cur[MAXU], nxt[MAXU];
  if (t0 < T) load(cur, t0);
  for (int r = 0; r < ROWS; ++r) {
    const int t = t0 + r * WARPS;
    if (t >= T) break;
    if (r + 1 < ROWS && t + WARPS < T) load(nxt, t + WARPS);
    const long long base = (static_cast<long long>(b) * T + t) * units;
    double s = 0.0, s2 = 0.0;
#pragma unroll
    for (int k = 0; k < MAXU; ++k) {
      if (lane + 32 * k >= units) continue;
      float f[PER];
      U::unpack(cur[k], f);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const double d = f[j];
        s = __dadd_rn(s, d);
        s2 = __dadd_rn(s2, __dmul_rn(d, d));
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, m));
      s2 = __dadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, m));
    }
    const double mean = __dmul_rn(s, inv_c);
    double var = __dsub_rn(__dmul_rn(s2, inv_c), __dmul_rn(mean, mean));
    var = var > 0.0 ? var : 0.0;
    const float meanf = __double2float_rn(mean);
    const float rstd = __double2float_rn(
        __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(var, eps))));
#pragma unroll
    for (int k = 0; k < MAXU; ++k) {
      const int u = lane + 32 * k;
      if (u >= units) continue;
      float f[PER];
      U::unpack(cur[k], f);
#pragma unroll
      for (int j = 0; j < PER; ++j)
        f[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[j], meanf), rstd),
                                   opsc[j * units + u]),
                         shift[j * units + u]);
      if constexpr (CODES)
        U::store_codes(out, base + u, f, a);
      else
        U::store_float(out, base + u, f);
    }
#pragma unroll
    for (int k = 0; k < MAXU; ++k) cur[k] = nxt[k];
  }
}

template <bool BF16, bool CODES, int MAXU>
int launch(const void* x, const float* ss, long long ld, const float* q,
           void* out, int B, int T, int C, double eps, cudaStream_t s) {
  const dim3 grid((T + WARPS * ROWS - 1) / (WARPS * ROWS), B);
  layernorm_modulate_kernel<BF16, CODES, MAXU>
      <<<grid, THREADS, 2 * C * sizeof(float), s>>>(x, ss, ld, q, out, T, C,
                                                    eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16, bool CODES>
int by_units(const void* x, const float* ss, long long ld, const float* q,
             void* out, int B, int T, int C, double eps, cudaStream_t s) {
  const int per_lane = (C / Unit<BF16>::PER + 31) / 32;
  if (per_lane <= 4)
    return launch<BF16, CODES, 4>(x, ss, ld, q, out, B, T, C, eps, s);
  if (per_lane <= 5)  // DiT-XL's 1152 channels in bfloat16
    return launch<BF16, CODES, 5>(x, ss, ld, q, out, B, T, C, eps, s);
  if (per_lane <= 8)
    return launch<BF16, CODES, 8>(x, ss, ld, q, out, B, T, C, eps, s);
  return launch<BF16, CODES, 16>(x, ss, ld, q, out, B, T, C, eps, s);
}

}  // namespace

// x: B * T rows of C contiguous bfloat16 (bf16 = 1) or float32 values,
// 16-byte aligned, C a multiple of 8 up to 4096 (2048 in float32); ss: a
// device pointer to B rows of 2 C float32 (shift, then scale), row i at
// ss + i * ld; qscale: null (out in x's type) or a device pointer to one
// float32 (out int8 codes); out: 16-byte aligned.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int layernorm_modulate_launch(const void* x, int bf16,
                                         const void* ss, long long ld,
                                         const void* qscale, void* out, int B,
                                         int T, int C, double eps,
                                         void* stream) {
  const int per_unit = bf16 ? 8 : 4;
  if (B < 1 || T < 1 || C < 8 || C % 8 != 0 || C > (bf16 ? MAX_C : MAX_C / 2) ||
      ld < 2LL * C || !x || !ss || !out ||
      (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(out)) % 16 != 0 ||
      C % per_unit != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(ss);
  const float* q = static_cast<const float*>(qscale);
  if (bf16)
    return q ? by_units<true, true>(x, sp, ld, q, out, B, T, C, eps, s)
             : by_units<true, false>(x, sp, ld, q, out, B, T, C, eps, s);
  return q ? by_units<false, true>(x, sp, ld, q, out, B, T, C, eps, s)
           : by_units<false, false>(x, sp, ld, q, out, B, T, C, eps, s);
}
