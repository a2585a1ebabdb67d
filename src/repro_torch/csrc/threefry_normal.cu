// Threefry2x32 normal draw, fused: jax.random.normal's float32 bits in one
// launch.
//
// Replaces no TPU kernel.  The JAX package draws the scene noise and the
// codec noise with jax.random.normal, which XLA fuses into one loop; the
// port's plain version (repro_torch/common/prng.py: random_bits, uniform,
// erf_inv, log1p, log) emulates uint32 in int64 and float32 fused
// multiply-adds through float64, some 430 torch ops and ~7 GB of
// intermediates for one draw at the fleet's (16, 10, 96, 160).  This
// kernel does the whole draw per value in registers: the threefry2x32
// block on the counter (hi, lo) of the flat row-major index, x1 ^ x2, the
// mantissa trick to the uniform on [lo, 1), XLA's float32 erf_inv
// expansion with its log1p and log, and the optional sqrt(2) scale.
//
// What bounds it on the H100: operations.  It reads 16 bytes a key and
// writes 4 a value (9.8 MB at the fleet's shape, ~3 us at 3.35 TB/s); a
// value costs ~80 int32 operations of threefry and ~30 float64 fused
// steps, each with its float32 <-> float64 conversions, whose rate (16 a
// clock an SM) is the tightest.  Design: one thread per four consecutive
// values of the flat output (keys x counter), written with one 16-byte
// store; the key changes inside a thread's four values when the draw per
// key is not a multiple of four.  Branches are per value and take exactly
// the side the plain version's torch.where selects.
//
// Numerics follow prng.py operation by operation, so the bits equal the
// plain version's on the CPU: every float32 step is an explicit
// __f*_rn intrinsic in prng.py's order (nvcc would otherwise contract
// a * b + c into one FFMA), prng.fma is the float64 product of two float32
// values (exact) plus the float64 addend, rounded once to float32, and
// prng.sqrt is the correctly rounded float64 square root rounded to
// float32.  Constants are the float32 values prng.py uses, as hexadecimal
// literals.  The build must not use --use_fast_math.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;              // values a thread: one 16-byte store
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ int rotation(int g, int j) {
  // threefry2x32's rotations: (13, 15, 26, 6), (17, 29, 16, 24)
  return (g & 1) ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
                 : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}

// x1 ^ x2 of threefry2x32((k1, k2), (x1, x2)): five groups of four rounds
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, uint32_t k2,
                                                  uint32_t x1, uint32_t x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ kParity};
  uint32_t a = x1 + ks[0], b = x2 + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = __funnelshift_l(b, b, rotation(g, j)) ^ a;
    }
    a += ks[(g + 1) % 3];
    b += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  return a ^ b;
}

// prng.fma: float32 fused multiply-add through float64
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(a), static_cast<double>(b)),
      static_cast<double>(c)));
}

// prng.log: Cephes' logf as XLA's CPU backend expands it
__device__ __forceinline__ float log_f32(float v) {
  const float tiny = 0x1p-126f;
  v = v < tiny ? tiny : v;                      // torch.clamp(min=)
  const int bits = __float_as_int(v);
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 0x7F), 1.0f);
  float m = __int_as_float((bits & ~0x7F800000) | 0x3F000000);
  const bool small = m < 0x1.6a09e6p-1f;
  m = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(m, m);
  const float x3 = __fmul_rn(x2, m);
  float y = fma64(m, 0x1.204376p-4f, -0x1.d7a37p-4f);
  float y1 = fma64(m, -0x1.fcba9ep-4f, 0x1.23d37ep-3f);
  float y2 = fma64(m, 0x1.999d58p-3f, -0x1.fffff8p-3f);
  y = fma64(y, m, 0x1.de4a34p-4f);
  y1 = fma64(y1, m, -0x1.555cap-3f);
  y2 = fma64(y2, m, 0x1.555554p-2f);
  y = fma64(y, x3, y1);
  y = fma64(y, x3, y2);
  y = fma64(y, x3, __fmul_rn(e, -0x1.bd0106p-13f));
  m = fma64(x2, -0.5f, m);
  return fma64(e, 0x1.63p-1f, __fadd_rn(m, y));
}

// prng.log1p for x > -1: the Cephes rational for |x| < sqrt(2) - 1,
// log(1 + x) elsewhere
__device__ __forceinline__ float log1p_f32(float x) {
  if (!(fabsf(x) < 0x1.a8279ap-2f)) return log_f32(__fadd_rn(x, 1.0f));
  const float num_c[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f,
                          0x1.de9738p+4f, 0x1.e798ecp+5f, 0x1.c8e75ap+5f,
                          0x1.40a202p+4f};
  const float den_c[7] = {0x1p+0f, 0x1.e2035ap+3f, 0x1.4c30b6p+6f,
                          0x1.bb865ap+7f, 0x1.351946p+8f, 0x1.b0db14p+7f,
                          0x1.e0f304p+5f};
  float num = num_c[0], den = den_c[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    num = fma64(num, x, num_c[i]);
    den = fma64(den, x, den_c[i]);
  }
  const float x2 = __fmul_rn(x, x);
  const float s = fma64(x2, -0.5f,
                        __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den)));
  return __fadd_rn(x, s);
}

// prng.erf_inv: XLA's float32 expansion, +-inf at |x| == 1
__device__ __forceinline__ float erf_inv_f32(float x) {
  const float w = -log1p_f32(__fmul_rn(x, -x));
  float p;
  if (w < 5.0f) {
    const float c[9] = {0x1.e2cb1p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f,
                        -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
                        -0x1.11c9dep-8f, 0x1.f91ec6p-3f, 0x1.805c5ep+0f};
    const float ww = __fsub_rn(w, 2.5f);
    p = c[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = fma64(p, ww, c[i]);
  } else {
    const float c[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
                        -0x1.e17bcep-9f, 0x1.7824f6p-8f, -0x1.f38baep-8f,
                        0x1.354afcp-7f, 0x1.006db6p+0f, 0x1.6a9efcp+1f};
    const float ww = __fsub_rn(
        __double2float_rn(__dsqrt_rn(static_cast<double>(w))), 3.0f);
    p = c[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = fma64(p, ww, c[i]);
  }
  if (fabsf(x) == 1.0f) return __fmul_rn(x, __int_as_float(0x7F800000));
  return __fmul_rn(p, x);
}

// one value: the uniform on [lo, lo + span) of the counter's bits, its
// erf_inv, times sqrt(2) if scaled
__device__ __forceinline__ float draw(uint32_t k1, uint32_t k2, int64_t i,
                                      float lo, float span, bool scaled) {
  const uint32_t bits = threefry_bits(
      k1, k2, static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32),
      static_cast<uint32_t>(i));
  const float f =
      __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  float u = __fadd_rn(__fmul_rn(f, span), lo);
  u = u < lo ? lo : u;                          // torch.clamp(min=lo)
  const float e = erf_inv_f32(u);
  return scaled ? __fmul_rn(e, 0x1.6a09e6p+0f) : e;
}

__global__ void __launch_bounds__(kThreads) threefry_normal_kernel(
    const int64_t* __restrict__ keys, float* __restrict__ out, int64_t n,
    int64_t total, float lo, float span, int scaled) {
  const int64_t j0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPer;
  if (j0 >= total) return;
  int64_t key = j0 / n;
  int64_t i = j0 - key * n;
  uint32_t k1 = static_cast<uint32_t>(keys[2 * key]);
  uint32_t k2 = static_cast<uint32_t>(keys[2 * key + 1]);
  float v[kPer] = {};
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (j0 + q < total) {
      v[q] = draw(k1, k2, i, lo, span, scaled != 0);
      if (++i == n && j0 + q + 1 < total) {
        i = 0;
        ++key;
        k1 = static_cast<uint32_t>(keys[2 * key]);
        k2 = static_cast<uint32_t>(keys[2 * key + 1]);
      }
    }
  }
  if (j0 + kPer <= total) {
    *reinterpret_cast<float4*>(out + j0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (j0 + q < total) out[j0 + q] = v[q];
  }
}

}  // namespace

// keys (num_keys, 2) int64 holding uint32 values, contiguous; out
// (num_keys, n) float32, contiguous and 16-byte aligned; the uniform's lo
// and span as prng.uniform computes them; scaled != 0 multiplies by
// sqrt(2) (prng.normal), 0 leaves erf_inv(u) (prng.normal_erfinv).
// Returns the first failing cudaError_t, or 0.
extern "C" int threefry_normal_launch(const int64_t* keys, float* out,
                                      int64_t num_keys, int64_t n, float lo,
                                      float span, int scaled, void* stream) {
  const int64_t total = num_keys * n;
  if (total <= 0) return 0;
  const int64_t threads = (total + kPer - 1) / kPer;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  threefry_normal_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      keys, out, n, total, lo, span, scaled);
  return static_cast<int>(cudaGetLastError());
}
