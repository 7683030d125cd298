// The int8 activation quantizer: codes = clamp(rint(x / a), -127, 127), on
// a contiguous tensor of any shape (the int8 convs' NHWC inputs).
//
// Replaces no Pallas kernel.  On the TPU, XLA fused the quantizer into the
// int8 conv that reads its codes (mrisr_tpu/serve/quant.py:_quant_input,
// and qin_and_scale in mrisr_tpu/serve/quant_diffusion.py).  On the card the
// same expression in torch was five launches over every element (x.float(),
// the divide by the (1,) scale tensor, round, clamp, .to(int8)): 35 bytes
// of device traffic an element where one read of x and one write of the
// codes will do, 3 bytes an element from bfloat16 and 5 from float32.
//
// Bound on the card (H100 SXM): those bytes at 3.35 TB/s.  The arithmetic,
// one division, two compares and an add an element, is below the issue
// rate.  So the design is one streaming pass:
//   - a thread's unit is 16 bytes of x (8 bfloat16 or 4 float32 elements),
//     one 16-byte load, and its codes are one packed store (8 or 4 bytes):
//     a warp's load instruction reads 512 contiguous bytes and its store
//     writes 256 or 128;
//   - each thread issues UNROLL loads before it converts and stores any of
//     them (units UNROLL grid strides apart, so every instruction stays
//     coalesced), enough bytes in flight to cover the memory latency;
//   - the grid is as many 512-thread blocks as the SMs hold at once, by the
//     occupancy the kernel's registers allow (or as the units need), so
//     every block is resident from the start and strides over the tensor:
//     a second wave of blocks would leave most SMs idle behind it;
//   - no shared memory: the scale goes from its device pointer (one float,
//     the per-step activation scale) to a register once, with no host sync;
//   - a scalar loop takes the last n % (elements a unit) elements, and the
//     whole tensor where x is not 16-byte aligned.
//
// The codes are the torch chain's bit for bit: true division (div.rn, as
// torch's division by a CUDA tensor; never a multiply by 1 / a, which moves
// codes at ties), round half to even, clamp to +-127, and torch's code 0
// for NaN.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// 512 threads a block, 2 units in flight a thread: the best of 256 / 512
// threads by 2 / 4 / 8 units at the kernel table's shapes, by 1-4 % (the
// deeper unrolls' registers cost occupancy and gained nothing)
constexpr int THREADS = 512;
constexpr int UNROLL = 2;

// 1.5 * 2^23: a float in [-127, 127] plus MAGIC is rounded to an integer,
// ties to even (the sum's ulp is 1), whose two's complement is the sum's low
// byte.  That is rint and the int8 conversion in one full-rate add in place
// of two conversion instructions (FRND, F2I), which issue at a fraction of
// that rate, beside the division's reciprocal, at 1.1 G elements a ms.
// Clamping first and rounding after gives rint-then-clamp's codes: rint is
// monotonic and keeps +-127.
constexpr float MAGIC = 12582912.0f;

// The code of one element: 0 for NaN (torch's clamp passes NaN through and
// its int8 conversion makes it 0).
__device__ __forceinline__ uint32_t code(float v, float a) {
  const float q = __fdiv_rn(v, a);
  if (isnan(q)) return 0;
  const float c = fminf(fmaxf(q, -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(c, MAGIC)) & 0xffu;
}

__device__ __forceinline__ uint32_t pack4(float v0, float v1, float v2,
                                          float v3, float a) {
  return code(v0, a) | code(v1, a) << 8 | code(v2, a) << 16 |
         code(v3, a) << 24;
}

// bfloat16 -> float32 is exact: the 16 bits are the float's high half.
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// One unit's codes: 8 from bfloat16 (a uint2), 4 from float32 (a uint32).
template <bool BF16>
struct Unit;

template <>
struct Unit<true> {
  static constexpr int ELEMS = 8;
  using Out = uint2;
  static __device__ __forceinline__ Out quantize(uint4 u, float a) {
    return make_uint2(
        pack4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y), a),
        pack4(bf_lo(u.z), bf_hi(u.z), bf_lo(u.w), bf_hi(u.w), a));
  }
  static __device__ __forceinline__ float element(const void* x, long long i) {
    return bf_lo(static_cast<const uint16_t*>(x)[i]);
  }
};

template <>
struct Unit<false> {
  static constexpr int ELEMS = 4;
  using Out = uint32_t;
  static __device__ __forceinline__ Out quantize(uint4 u, float a) {
    return pack4(__uint_as_float(u.x), __uint_as_float(u.y),
                 __uint_as_float(u.z), __uint_as_float(u.w), a);
  }
  static __device__ __forceinline__ float element(const void* x, long long i) {
    return static_cast<const float*>(x)[i];
  }
};

// x: n elements (units whole 16-byte units of them, 0 where x is not
// 16-byte aligned, then the rest); out: n int8 codes.
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
    quantize_kernel(const void* __restrict__ x,
                    const float* __restrict__ scale, int8_t* __restrict__ out,
                    long long n, long long units) {
  using U = Unit<BF16>;
  using Out = typename U::Out;
  const float a = __ldg(scale);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  long long u = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const uint4* x4 = static_cast<const uint4*>(x);
  Out* o = reinterpret_cast<Out*>(out);
  for (; u + (UNROLL - 1) * stride < units; u += UNROLL * stride) {
    uint4 v[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) v[k] = __ldg(x4 + u + k * stride);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) o[u + k * stride] = U::quantize(v[k], a);
  }
  for (; u < units; u += stride) o[u] = U::quantize(__ldg(x4 + u), a);
  for (long long i = units * U::ELEMS + blockIdx.x * THREADS + threadIdx.x;
       i < n; i += stride)
    out[i] = static_cast<int8_t>(code(U::element(x, i), a));
}

template <bool BF16>
int launch(const void* x, const float* scale, int8_t* out, long long n,
           int sms, cudaStream_t s) {
  static int per_sm = 0;  // blocks an SM holds at once, asked once
  if (per_sm < 1) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quantize_kernel<BF16>, THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  constexpr int elems = Unit<BF16>::ELEMS;
  const long long units =
      reinterpret_cast<size_t>(x) % 16 == 0 ? n / elems : 0;
  const long long work = units > 0 ? units : n;
  const long long blocks = (work + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * per_sm;
  quantize_kernel<BF16><<<static_cast<int>(blocks < cap ? blocks : cap),
                          THREADS, 0, s>>>(x, scale, out, n, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n contiguous bfloat16 (bf16 = 1) or float32 elements; scale: a device
// pointer to one float32; out: n int8 codes, 8-byte aligned (a fresh
// allocation); sms: the device's SM count.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int quantize_int8_launch(const void* x, int bf16, const void* scale,
                                    void* out, long long n, int sms,
                                    void* stream) {
  if (n < 1 || sms < 1 || !x || !scale || !out ||
      reinterpret_cast<size_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  int8_t* op = static_cast<int8_t*>(out);
  return bf16 ? launch<true>(x, sp, op, n, sms, s)
              : launch<false>(x, sp, op, n, sms, s);
}
