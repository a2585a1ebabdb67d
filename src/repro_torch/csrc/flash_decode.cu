// Single-token GQA decode attention over the valid prefix of a KV cache,
// with the online-softmax statistics.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/flash_decode.py:
// flash_decode_pallas (body _fd_kernel).  For q (B, 1, H, hd) and a cache
// k, v (B, S, KV, hd), with G = H / KV query heads per kv head and a valid
// length n:
//
//   s[b,h,g,t] = q[b,h*G+g] . k[b,t,h] / sqrt(hd)   (t < n, else -1e30)
//   m = max_t s,  l = sum_t exp(s - m),
//   out = (sum_t exp(s - m) v[b,t,h]) / max(l, 1e-30)   (in q's dtype),
//
// m and l (B, KV, G, 1) in float32.  The -1e30 (never -inf) matters when
// n = 0: every position then weighs alike and out is the mean of V, with
// m = -1e30 and l = S, as on the TPU; the caller's merge with the fresh
// token then returns that token's value exactly.
//
// What bounds it on the H100: bytes.  Each K and V row below n is read
// once (2 * B * n * KV * hd elements); the work is 4 * B * H * n * hd
// flops, ~25 times under the float32 rate for the same time.  At the LM
// decode's shape (B=4, KV=8, hd=128, bf16) and n = 2048 that is 33.5 MB,
// 10 us at 3.35 TB/s.
//
// Design.  The TPU kernel walked S as a sequential grid axis with (m, l,
// acc) in VMEM scratch.  Here a block of 128 threads owns one (b, kv head)
// and a contiguous range of 32-position tiles: it keeps its G query rows
// and the (G, hd) float32 accumulator in shared memory, streams K and V
// tiles through a two-stage cp.async ring (16-byte copies), scores one
// position per lane with one row g per warp (chunks visited in a rotated
// order so the lanes of a quarter-warp hit distinct banks), updates
// (m, l) with warp shuffles, and adds p . V for four output columns per
// thread.  Positions at or past n are never loaded when n > 0: their
// exp(-1e30 - m) is exactly 0, so skipping them gives the same result;
// when n = 0 every position is scored -1e30 and weighs 1.  B * KV blocks
// are too few to fill 132 SMs (32 at the LM shape), so the wrapper splits
// the valid positions into ranges (~4 blocks per SM), one block each, and
// a second small kernel merges the per-range (m, l, acc) with the usual
// rescaling, one block per query row; with one range the first kernel
// writes the result itself.  The products run on the CUDA cores in
// float32, which at this shape costs about as much time as the bytes:
// moving them to the tensor cores is the next step.  Built without
// --use_fast_math: expf and IEEE division.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kTS = 32;          // positions per tile, one per lane
constexpr int kThreads = 128;    // four warps
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Num;
template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

// N consecutive elements of type T from an address aligned to their size
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&f)[N]) {
  struct alignas(sizeof(T) * N) Pack { T e[N]; };
  const Pack pk = *reinterpret_cast<const Pack*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = Num<T>::to_f(pk.e[i]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One block per (b * KV + h, range of tiles).  kFinal: a single range,
// write out/m/l; else write the range's (m, l, unnormalised acc).
template <typename T, bool kFinal>
__global__ void __launch_bounds__(kThreads) fd_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out, int S, int KV,
    int G, int hd, int valid_len, int n_pos, int tiles_per_split,
    float scale) {
  constexpr int VEC = 16 / sizeof(T);         // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = hd / VEC;
  const int tile_elems = kTS * hd;
  T* kv_s = reinterpret_cast<T*>(smem_raw);   // [2 stages][k, v][kTS][hd]
  T* q_s = kv_s + 4 * tile_elems;             // [G][hd]
  float* acc_s = reinterpret_cast<float*>(q_s + G * hd);   // [G][hd]
  float* p_s = acc_s + G * hd;                // [G][kTS + 1]
  float* m_s = p_s + G * (kTS + 1);
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int bh = blockIdx.y;
  const int b = bh / KV, h = bh % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p_begin = blockIdx.x * tiles_per_split * kTS;
  const int p_end = min(n_pos, p_begin + tiles_per_split * kTS);
  const int ntiles = (p_end - p_begin + kTS - 1) / kTS;
  const int64_t row = static_cast<int64_t>(KV) * hd;  // between positions
  const T* kb = k + (static_cast<int64_t>(b) * S * KV + h) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * S * KV + h) * hd;
  // heads h*G .. h*G+G-1 of batch b: (b*H + h*G) * hd = bh * G * hd
  const int64_t qo = static_cast<int64_t>(bh) * G * hd;

  for (int i = tid; i < G * nc; i += kThreads)
    *reinterpret_cast<uint4*>(q_s + i * VEC) =
        *reinterpret_cast<const uint4*>(q + qo + i * VEC);
  for (int i = tid; i < G * hd; i += kThreads) acc_s[i] = 0.0f;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.0f;
  }

  auto load_tile = [&](int tile, int stage) {
    T* ks = kv_s + stage * 2 * tile_elems;
    T* vs = ks + tile_elems;
    const int p0 = p_begin + tile * kTS;
    for (int i = tid; i < kTS * nc; i += kThreads) {
      const int t = i / nc, c = (i - t * nc) * VEC;
      if (p0 + t < p_end) {
        cp_async16(ks + t * hd + c, kb + (p0 + t) * row + c);
        cp_async16(vs + t * hd + c, vb + (p0 + t) * row + c);
      } else {  // past the range: zeros, so 0 * V stays finite
        *reinterpret_cast<uint4*>(ks + t * hd + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs + t * hd + c) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };

  load_tile(0, 0);
  const int c0 = lane % nc;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < ntiles) {
      load_tile(tile + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kv_s + stage * 2 * tile_elems;
    const T* vs = ks + tile_elems;
    const int p0 = p_begin + tile * kTS;
    const int pos = p0 + lane;
    for (int g = warp; g < G; g += kThreads / 32) {
      float s = -CUDART_INF_F;          // absent position: weight 0
      if (pos < p_end) {
        if (pos < valid_len) {
          const T* kr = ks + lane * hd;
          const T* qr = q_s + g * hd;
          // four partial sums: a chain of hd / 4 dependent fmas, not hd
          float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
          int c = c0;
#pragma unroll 4
          for (int cc = 0; cc < nc; ++cc) {
            float kf[VEC], qf[VEC];
            load_f<T, VEC>(kr + c * VEC, kf);
            load_f<T, VEC>(qr + c * VEC, qf);
#pragma unroll
            for (int j = 0; j < VEC; j += 4) {
              d0 = fmaf(qf[j], kf[j], d0);
              d1 = fmaf(qf[j + 1], kf[j + 1], d1);
              d2 = fmaf(qf[j + 2], kf[j + 2], d2);
              d3 = fmaf(qf[j + 3], kf[j + 3], d3);
            }
            c = (c + 1 == nc) ? 0 : c + 1;
          }
          s = ((d0 + d1) + (d2 + d3)) * scale;
        } else {
          s = kNeg;
        }
      }
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      p_s[g * (kTS + 1) + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    const int nq = hd / 4;
    const int nt = min(kTS, p_end - p0);
    for (int i = tid; i < G * nq; i += kThreads) {
      const int g = i / nq, d = (i - g * nq) * 4;
      const float* pr = p_s + g * (kTS + 1);
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 8
      for (int t = 0; t < nt; ++t) {
        const float pt = pr[t];
        float vf[4];
        load_f<T, 4>(vs + t * hd + d, vf);
        a0 = fmaf(pt, vf[0], a0);
        a1 = fmaf(pt, vf[1], a1);
        a2 = fmaf(pt, vf[2], a2);
        a3 = fmaf(pt, vf[3], a3);
      }
      float4* ap = reinterpret_cast<float4*>(acc_s + g * hd + d);
      const float alpha = a_s[g];
      float4 acc = *ap;
      acc.x = fmaf(acc.x, alpha, a0);
      acc.y = fmaf(acc.y, alpha, a1);
      acc.z = fmaf(acc.z, alpha, a2);
      acc.w = fmaf(acc.w, alpha, a3);
      *ap = acc;
    }
    __syncthreads();
  }

  if (kFinal) {
    for (int i = tid; i < G * hd; i += kThreads)
      out[qo + i] = Num<T>::from_f(acc_s[i] / fmaxf(l_s[i / hd], 1e-30f));
    for (int g = tid; g < G; g += kThreads) {
      m_out[bh * G + g] = m_s[g];
      l_out[bh * G + g] = l_s[g];
    }
  } else {
    const int64_t r = static_cast<int64_t>(bh) * gridDim.x + blockIdx.x;
    for (int i = tid; i < G * hd; i += kThreads)
      acc_out[r * G * hd + i] = acc_s[i];
    for (int g = tid; g < G; g += kThreads) {
      m_out[r * G + g] = m_s[g];
      l_out[r * G + g] = l_s[g];
    }
  }
}

// One block per (b * KV + h, g): merge the nsplit range partials of one
// query row.  Warp 0 finds the row's max and weights; every thread then
// sums its output columns over the ranges, four loads in flight.
template <typename T>
__global__ void __launch_bounds__(kThreads) fd_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int G, int hd,
    int nsplit) {
  extern __shared__ float w_s[];              // [nsplit] weights, then L
  const int bh = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(bh) * nsplit * G + g;  // stride G
  if (tid < 32) {
    float M = -CUDART_INF_F;
    for (int i = tid; i < nsplit; i += 32)
      M = fmaxf(M, part_m[r0 + static_cast<int64_t>(i) * G]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
    float L = 0.0f;
    for (int i = tid; i < nsplit; i += 32) {
      const int64_t r = r0 + static_cast<int64_t>(i) * G;
      const float w = expf(part_m[r] - M);
      w_s[i] = w;
      L = fmaf(part_l[r], w, L);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      L += __shfl_xor_sync(kFull, L, off);
    if (tid == 0) {
      w_s[nsplit] = L;
      m_out[bh * G + g] = M;
      l_out[bh * G + g] = L;
    }
  }
  __syncthreads();
  const float L = fmaxf(w_s[nsplit], 1e-30f);
  const int64_t step = static_cast<int64_t>(G) * hd;   // between ranges
  const float* pa = part_acc + r0 * hd;
  for (int d = tid; d < hd; d += blockDim.x) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    int i = 0;
    for (; i + 4 <= nsplit; i += 4) {
      a0 = fmaf(pa[i * step + d], w_s[i], a0);
      a1 = fmaf(pa[(i + 1) * step + d], w_s[i + 1], a1);
      a2 = fmaf(pa[(i + 2) * step + d], w_s[i + 2], a2);
      a3 = fmaf(pa[(i + 3) * step + d], w_s[i + 3], a3);
    }
    for (; i < nsplit; ++i) a0 = fmaf(pa[i * step + d], w_s[i], a0);
    out[(static_cast<int64_t>(bh) * G + g) * hd + d] =
        Num<T>::from_f(((a0 + a1) + (a2 + a3)) / L);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* m,
           float* l, float* part_m, float* part_l, float* part_acc, int B,
           int S, int KV, int G, int hd, int valid_len, int n_pos,
           int tiles_per_split, int nsplit, float scale,
           cudaStream_t stream) {
  const size_t smem = (4 * static_cast<size_t>(kTS) * hd +
                       static_cast<size_t>(G) * hd) * sizeof(T) +
                      4 * (static_cast<size_t>(G) * hd +
                           static_cast<size_t>(G) * (kTS + 1) + 3 * G);
  const dim3 grid(nsplit, B * KV);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  cudaError_t e;
  if (nsplit == 1) {
    e = cudaFuncSetAttribute(fd_partial_kernel<T, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    fd_partial_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, ot, m, l, nullptr, S, KV, G, hd, valid_len, n_pos,
        tiles_per_split, scale);
    return static_cast<int>(cudaGetLastError());
  }
  e = cudaFuncSetAttribute(fd_partial_kernel<T, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fd_partial_kernel<T, false><<<grid, kThreads, smem, stream>>>(
      qt, kt, vt, nullptr, part_m, part_l, part_acc, S, KV, G, hd,
      valid_len, n_pos, tiles_per_split, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t csmem = 4 * (static_cast<size_t>(nsplit) + 1);
  e = cudaFuncSetAttribute(fd_combine_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(csmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fd_combine_kernel<T><<<dim3(B * KV, G), kThreads, csmem, stream>>>(
      part_m, part_l, part_acc, ot, m, l, G, hd, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  q (B, 1, KV*G, hd), k and v (B, S, KV,
// hd), out like q, m and l (B, KV, G) float32, all contiguous on the card
// with 16-byte aligned rows (hd a multiple of 8 for bfloat16, 4 for
// float32).  The valid positions [0, n_pos) (n_pos = min(valid_len, S), or
// S when valid_len = 0) are cut into nsplit ranges of tiles_per_split
// 32-position tiles; with nsplit > 1, part_m and part_l (B*KV, nsplit, G)
// and part_acc (B*KV, nsplit, G, hd) float32 hold the partials.  Returns
// the first failing cudaError_t, or 0.
extern "C" int flash_decode_launch(int dtype, const void* q, const void* k,
                                   const void* v, void* out, float* m,
                                   float* l, float* part_m, float* part_l,
                                   float* part_acc, int B, int S, int KV,
                                   int G, int hd, int valid_len, int n_pos,
                                   int tiles_per_split, int nsplit,
                                   float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, m, l, part_m, part_l, part_acc, B, S,
                         KV, G, hd, valid_len, n_pos, tiles_per_split, nsplit,
                         scale, st);
  return launch<__nv_bfloat16>(q, k, v, out, m, l, part_m, part_l, part_acc,
                               B, S, KV, G, hd, valid_len, n_pos,
                               tiles_per_split, nsplit, scale, st);
}
