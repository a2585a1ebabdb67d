// Fused transmission-codec frame transform, camera-batched.
//
// Replaces the TPU kernel src/repro/kernels/tx_codec/tx_codec.py:
// tx_codec_pallas (body _tx_codec_kernel).  Per camera c it applies ONE
// resolution-blur branch, chosen per camera at run time by its pool factor
// kcam[c] (1 = identity; k = 2 or 4: average-pool k x k, nearest upsample,
// tail rows/columns edge-padded), then quantises round(x*levels)/levels,
// adds sigma*noise and clips to [0, 1].
//
// What bounds it on the H100: bytes.  It reads frames and noise once and
// writes the decoded frames once (3 x C*N*H*W*4 bytes, ~9.2 MB at C=5,
// N=10, 96x160): about 2.75 us at 3.35 TB/s.  The arithmetic is a few
// flops per pixel.
//
// Design: grid (pixel tiles, frame, camera), one thread per output pixel;
// the per-camera levels, sigma and pool factor are read from device
// memory, so the caller never syncs to pick a branch.  A blurred pixel
// re-reads its k x k cell (the neighbouring threads share it through L1),
// which keeps every pixel independent.  Numerics follow the plain version
// exactly: the cell is summed in row-major order with __fadd_rn and then
// divided (what XLA does for the JAX package's mean), rintf rounds half to
// even like jnp.round, the noise add is one fused multiply-add, and the
// build must not use --use_fast_math.
#include <cuda_runtime.h>

namespace {

__global__ void tx_codec_kernel(const float* __restrict__ frames,
                                const float* __restrict__ noise,
                                const float* __restrict__ levels,
                                const float* __restrict__ sigma,
                                const int* __restrict__ kcam,
                                float* __restrict__ out, int N, int H,
                                int W) {
  const int c = blockIdx.z, n = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * W) return;
  const size_t base = (static_cast<size_t>(c) * N + n) * H * W;
  const float* f = frames + base;
  const int k = kcam[c];
  float x;
  if (k == 1) {
    x = f[p];
  } else {
    const int r = p / W, col = p % W;
    const int cr = min(r / k, H / k - 1), cc = min(col / k, W / k - 1);
    const float* cell = f + static_cast<size_t>(cr * k) * W + cc * k;
    float s = cell[0];
    for (int i = 0; i < k; ++i)
      for (int j = (i == 0 ? 1 : 0); j < k; ++j)
        s = __fadd_rn(s, cell[i * W + j]);
    x = __fdiv_rn(s, static_cast<float>(k * k));
  }
  const float lv = levels[c];
  const float q = __fdiv_rn(rintf(__fmul_rn(x, lv)), lv);
  const float y = __fmaf_rn(sigma[c], noise[base + p], q);
  out[base + p] = fminf(fmaxf(y, 0.0f), 1.0f);
}

}  // namespace

// frames/noise/out (C, N, H, W) float32 contiguous; levels/sigma (C,)
// float32; kcam (C,) int32.  Returns the launch's cudaError_t.
extern "C" int tx_codec_launch(const float* frames, const float* noise,
                               const float* levels, const float* sigma,
                               const int* kcam, float* out, int C, int N,
                               int H, int W, void* stream) {
  const int threads = 256;
  dim3 grid((H * W + threads - 1) / threads, N, C);
  tx_codec_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      frames, noise, levels, sigma, kcam, out, N, H, W);
  return static_cast<int>(cudaGetLastError());
}
