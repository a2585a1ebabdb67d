// Fused Sobel-edge + temporal XOR + block-sum motion scores for frame pairs.
//
// Replaces the TPU kernel src/repro/kernels/edge_motion/edge_motion.py:
// edge_motion_pallas (body _edge_motion_kernel).  For each consecutive
// frame pair (m, m+1) of each camera c it computes the 3x3 Sobel |g|^2 of
// both frames on edge-replicated borders, thresholds each against
// edge_thresh^2 into an edge map, XORs the two maps and sums the XOR over
// bs x bs blocks: out[c, m, by, bx] = count of changed edge pixels.
//
// What bounds it on the H100: bytes.  Each frame is read (about twice, as
// the second frame of one pair and the first of the next) and only the
// small score grid is written; there are a few dozen flops per pixel.  At
// the episode's shapes (C=5, 10 frames of 96x160) that is ~3 MB, under a
// microsecond of HBM time, so one launch is bounded by launch latency.
//
// Design: one thread block per (pair, block-row).  The TPU kernel needed
// pre-haloed overlapping row bands built in HBM (a VMEM artefact); here the
// block reads the (bs+2) x (W+2) halo rows of both frames straight from
// the (C, M, H, W) tensor into shared memory with clamped indices (the
// edge replication), ~13 KB at W=160.  Each thread owns image columns,
// counts its XOR bits over the bs rows into a per-column integer, and the
// block sums bs columns per output block: integer sums, so the counts are
// exact and independent of thread order.  Arithmetic follows the plain
// version's order with explicit IEEE intrinsics (no contraction into fused
// multiply-adds), so the edge maps are bitwise those of the plain version.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// squared Sobel magnitude at tile pixel (r, x); s holds rows r..r+2 of
// the haloed tile, row stride wp
__device__ __forceinline__ float sobel_mag2(const float* s, int r, int x,
                                            int wp) {
  const float* a = s + r * wp + x;
  const float* b = a + wp;
  const float* c = b + wp;
  float tl = a[0], tc = a[1], tr = a[2];
  float ml = b[0], mr = b[2];
  float bl = c[0], bc = c[1], br = c[2];
  float gx = __fsub_rn(__fadd_rn(__fadd_rn(tr, __fmul_rn(2.0f, mr)), br),
                       __fadd_rn(__fadd_rn(tl, __fmul_rn(2.0f, ml)), bl));
  float gy = __fsub_rn(__fadd_rn(__fadd_rn(bl, __fmul_rn(2.0f, bc)), br),
                       __fadd_rn(__fadd_rn(tl, __fmul_rn(2.0f, tc)), tr));
  return __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
}

__global__ void edge_motion_kernel(const float* __restrict__ frames,
                                   float* __restrict__ out, int M, int H,
                                   int W, int bs, float t2) {
  extern __shared__ float smem[];
  const int wp = W + 2, rows = bs + 2;
  float* s0 = smem;
  float* s1 = s0 + rows * wp;
  int* colcnt = reinterpret_cast<int*>(s1 + rows * wp);
  const int brow = blockIdx.x;
  const int pair = blockIdx.y;
  const int c = pair / (M - 1), m = pair % (M - 1);
  const size_t hw = static_cast<size_t>(H) * W;
  const float* f0 = frames + (static_cast<size_t>(c) * M + m) * hw;
  const float* f1 = f0 + hw;
  const int r0 = brow * bs;

  for (int i = threadIdx.x; i < rows * wp; i += blockDim.x) {
    int gr = clampi(r0 - 1 + i / wp, 0, H - 1);
    int gc = clampi(i % wp - 1, 0, W - 1);
    s0[i] = f0[static_cast<size_t>(gr) * W + gc];
    s1[i] = f1[static_cast<size_t>(gr) * W + gc];
  }
  __syncthreads();

  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    int cnt = 0;
    for (int r = 0; r < bs; ++r) {
      bool e0 = sobel_mag2(s0, r, x, wp) > t2;
      bool e1 = sobel_mag2(s1, r, x, wp) > t2;
      cnt += (e0 != e1);
    }
    colcnt[x] = cnt;
  }
  __syncthreads();

  const int nb = W / bs;
  float* o = out + (static_cast<size_t>(pair) * (H / bs) + brow) * nb;
  for (int bx = threadIdx.x; bx < nb; bx += blockDim.x) {
    int s = 0;
    for (int k = 0; k < bs; ++k) s += colcnt[bx * bs + k];
    o[bx] = static_cast<float>(s);
  }
}

}  // namespace

// frames (C, M, H, W) float32 contiguous -> out (C, M-1, H/bs, W/bs).
// Returns the launch's cudaError_t (0 on success).
extern "C" int edge_motion_launch(const float* frames, float* out, int C,
                                  int M, int H, int W, int bs, float t2,
                                  void* stream) {
  const int threads = W >= 256 ? 256 : ((W + 31) / 32) * 32;
  const size_t smem = (2 * static_cast<size_t>(bs + 2) * (W + 2)) *
                          sizeof(float) + static_cast<size_t>(W) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        edge_motion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(H / bs, C * (M - 1));
  edge_motion_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      frames, out, M, H, W, bs, t2);
  return static_cast<int>(cudaGetLastError());
}
