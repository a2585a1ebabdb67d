// Fused transmission-codec frame transform, camera-batched.
//
// Replaces the TPU kernel src/repro/kernels/tx_codec/tx_codec.py:
// tx_codec_pallas (body _tx_codec_kernel).  Per camera c it applies ONE
// resolution-blur branch, chosen per camera at run time by its pool factor
// kcam[c] (1 = identity; k = 2, 4 or 8: average-pool k x k, nearest
// upsample, tail rows/columns edge-padded), then quantises
// round(x*levels)/levels, adds sigma*noise and clips to [0, 1].
//
// What bounds it on the H100: bytes.  It reads frames and noise once and
// writes the decoded frames once (3 x C*N*H*W*4 bytes, ~9.2 MB at C=5,
// N=10, 96x160): about 2.75 us at 3.35 TB/s.  The arithmetic is a few
// flops per pixel.
//
// Design: one block per (band of rows, frame, camera); the band height is
// a multiple of 8, so of every pool factor, and a band's rows are one
// contiguous span of the frame.  Every global access is a 16-byte vector
// on a 16-byte boundary of the whole tensor, with scalar accesses only
// for the (at most three) elements at each end of a span that are not,
// so any W works.  The identity branch streams frames and noise straight
// to the output.  A blurred band first copies the input rows its cells
// need (for the edge-padded tail rows, the last whole cell row) into
// shared memory, then sums each pooled cell once, and every output pixel
// reads its cell's mean from shared memory: the row and column of a
// pixel cost one integer division per four pixels, the cell index a
// shift.  The per-camera levels, sigma and pool factor are read from
// device memory, so the caller never syncs to pick a branch.  Numerics
// follow the plain version exactly: each cell is summed in row-major
// order with __fadd_rn and then divided with __fdiv_rn (what XLA does for
// the JAX package's mean), rintf rounds half to even like jnp.round, the
// noise add is one fused multiply-add, and the build must not use
// --use_fast_math.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kBand = 8;     // rows per block: a multiple of every pool factor
constexpr int kPre = 4;      // chunks per thread whose noise is prefetched

__device__ __forceinline__ float codec(float x, float lv, float sg,
                                       float nz) {
  const float q = __fdiv_rn(rintf(__fmul_rn(x, lv)), lv);
  return fminf(fmaxf(__fmaf_rn(sg, nz, q), 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads) tx_codec_kernel(
    const float* __restrict__ frames, const float* __restrict__ noise,
    const float* __restrict__ levels, const float* __restrict__ sigma,
    const int* __restrict__ kcam, float* __restrict__ out, int N, int H,
    int W) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  const int c = blockIdx.z, n = blockIdx.y, tid = threadIdx.x;
  const int r0 = blockIdx.x * kBand, r1 = min(H, r0 + kBand);
  const int64_t base = (static_cast<int64_t>(c) * N + n) * H * W;
  const int k = kcam[c];
  const float lv = levels[c], sg = sigma[c];
  const int kl = __ffs(k) - 1;                    // k is a power of two
  const int Wk = W >> kl, Hk1 = (H >> kl) - 1, Wk1 = Wk - 1;
  // output span [s0, s1) in 4-element chunks aligned in the tensor; the
  // noise of a thread's first kPre chunks is loaded first, so that its
  // latency overlaps the staging of a blurred band
  const int64_t s0 = base + static_cast<int64_t>(r0) * W;
  const int64_t s1 = base + static_cast<int64_t>(r1) * W;
  const int64_t q0 = (s0 & ~static_cast<int64_t>(3)) + 4 * tid;
  float4 npre[kPre];
#pragma unroll
  for (int it = 0; it < kPre; ++it) {
    const int64_t q = q0 + 4 * kThreads * it;
    npre[it] = (q >= s0 && q + 4 <= s1)
                   ? *reinterpret_cast<const float4*>(noise + q)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  int cr_lo = 0;
  const float* pooled = nullptr;
  if (k > 1) {
    cr_lo = min(r0 >> kl, Hk1);
    const int cr_hi = min((r1 - 1) >> kl, Hk1);
    // input rows [cr_lo*k, (cr_hi+1)*k), one span, staged from a 16-byte
    // boundary a0 of the tensor
    const int64_t g0 = base + static_cast<int64_t>(cr_lo << kl) * W;
    const int64_t g1 = base + static_cast<int64_t>((cr_hi + 1) << kl) * W;
    const int64_t a0 = g0 & ~static_cast<int64_t>(3);
    const int off = static_cast<int>(g0 - a0);
    for (int64_t q = a0 + 4 * tid; q < g1; q += 4 * kThreads) {
      float* dst = stage + (q - a0);
      if (q >= g0 && q + 4 <= g1) {
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(frames + q);
      } else {
        for (int e = 0; e < 4; ++e)
          if (q + e >= g0 && q + e < g1) dst[e] = frames[q + e];
      }
    }
    __syncthreads();
    const int ncells = (cr_hi - cr_lo + 1) * Wk;
    const int span = static_cast<int>(g1 - a0);
    float* cells = stage + ((span + 3) & ~3);
    for (int i = tid; i < ncells; i += kThreads) {
      const int cr = i / Wk, cc = i - cr * Wk;
      const float* cell = stage + off + (cr << kl) * W + (cc << kl);
      float s = cell[0];
      for (int a = 0; a < k; ++a)
        for (int b = (a == 0 ? 1 : 0); b < k; ++b)
          s = __fadd_rn(s, cell[a * W + b]);
      cells[i] = __fdiv_rn(s, static_cast<float>(k * k));
    }
    __syncthreads();
    pooled = cells;
  }
  const int p_end = r1 * W;
  // one chunk: its noise (prefetched, or loaded here), its input (the
  // frames, or its cells' means), the codec, the store
  auto emit = [&](int64_t q, const float4* pre) {
    const bool full = q >= s0 && q + 4 <= s1;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f}, nz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (full) {
      const float4 nv =
          pre ? *pre : *reinterpret_cast<const float4*>(noise + q);
      nz[0] = nv.x; nz[1] = nv.y; nz[2] = nv.z; nz[3] = nv.w;
      if (k == 1) {
        const float4 fv = *reinterpret_cast<const float4*>(frames + q);
        x[0] = fv.x; x[1] = fv.y; x[2] = fv.z; x[3] = fv.w;
      }
    } else {
      for (int e = 0; e < 4; ++e)
        if (q + e >= s0 && q + e < s1) {
          nz[e] = noise[q + e];
          if (k == 1) x[e] = frames[q + e];
        }
    }
    if (k > 1) {
      // the chunk's first pixel inside the span, its row and column
      const int e0 = q >= s0 ? 0 : static_cast<int>(s0 - q);
      const int p0 = static_cast<int>(q - base) + e0;
      int r = p0 / W, col = p0 - r * W;
      for (int e = e0; e < 4 && p0 + e - e0 < p_end; ++e) {
        const int cr = min(r >> kl, Hk1) - cr_lo, cc = min(col >> kl, Wk1);
        x[e] = pooled[cr * Wk + cc];
        if (++col == W) {
          col = 0;
          ++r;
        }
      }
    }
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = codec(x[e], lv, sg, nz[e]);
    if (full) {
      *reinterpret_cast<float4*>(out + q) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      for (int e = 0; e < 4; ++e)
        if (q + e >= s0 && q + e < s1) out[q + e] = y[e];
    }
  };
#pragma unroll
  for (int it = 0; it < kPre; ++it) {
    const int64_t q = q0 + 4 * kThreads * it;
    if (q < s1) emit(q, &npre[it]);
  }
  for (int64_t q = q0 + 4 * kThreads * kPre; q < s1; q += 4 * kThreads)
    emit(q, nullptr);
}

// Shared memory one block needs: the staged input span (kBand * W
// elements, up to three more for its 16-byte start, rounded up to four)
// and the pooled cells (at most kBand/2 x W/2).
size_t smem_bytes(int W) {
  return 4 * (static_cast<size_t>(kBand) * W + 8 +
              static_cast<size_t>(kBand / 2) * (W / 2));
}

}  // namespace

// frames/noise/out (C, N, H, W) float32 contiguous and 16-byte aligned,
// H and W at least 8 (the largest pool factor); levels/sigma (C,)
// float32; kcam (C,) int32, each 1, 2, 4 or 8.  Returns the first failing
// cudaError_t, or 0.
extern "C" int tx_codec_launch(const float* frames, const float* noise,
                               const float* levels, const float* sigma,
                               const int* kcam, float* out, int C, int N,
                               int H, int W, void* stream) {
  const size_t smem = smem_bytes(W);
  if (smem > 48 * 1024) {
    // raised once per process, to the widest frames launched so far
    static size_t granted = 48 * 1024;
    if (smem > granted) {
      const cudaError_t e = cudaFuncSetAttribute(
          tx_codec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      granted = smem;
    }
  }
  const dim3 grid((H + kBand - 1) / kBand, N, C);
  tx_codec_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, noise, levels, sigma, kcam, out, N, H, W);
  return static_cast<int>(cudaGetLastError());
}
