// Fused Sobel-edge + temporal XOR + block-sum motion scores for every
// consecutive frame pair of every camera.
//
// Replaces the TPU kernel src/repro/kernels/edge_motion/edge_motion.py:48
// (edge_motion_pallas, body _edge_motion_kernel).  For each pair (m, m+1)
// of camera c it computes the 3x3 Sobel |g|^2 of both frames on
// edge-replicated borders, thresholds each against edge_thresh^2 into an
// edge map, XORs the two maps and sums the XOR over bs x bs blocks:
// out[c, m, by, bx] = count of changed edge pixels.
//
// What bounds it on the H100: bytes.  Every frame is read once and only
// the small score grid is written (C*M*H*W*4 + C*(M-1)*(H/bs)*(W/bs)*4
// bytes: 3.1 MB at C=5, M=10, 96x160, 0.93 us at 3.35 TB/s); a pixel
// costs 14 float operations, far below the card's float32 rate.  At the
// main path's shapes a launch is short, so its time is one block's chain
// (copy round, stencil, popcounts) times the blocks an SM runs, plus the
// launch.
//
// Design, against the two costs of the first version (one block per
// (pair, band): every inner frame staged and Sobel'd twice, and a chain of
// dependent 4-byte loads per thread):
//  * A block owns one (camera, band of bs rows, column segment) and walks
//    the frames of one chunk of pairs (ops.plan picks the segment width
//    and the chunk; at the main path all pairs in one chunk).  Each frame
//    of the chunk is staged once and its edge map computed once; pair m
//    XORs the maps of frames m and m+1, which stay in shared memory.  A
//    chunk after the first recomputes its first frame's map.
//  * Staging: the band's bs+2 rows (rows outside the frame are the clamped
//    edge rows: edge replication on the row side) and the segment's
//    columns plus one halo column each side, widened to 4-column bounds,
//    of every frame of the chunk, all issued at once: one round of memory
//    per block.  When W % 4 == 0 and the base is 16-byte aligned each row
//    is one bulk copy by the TMA unit (cp.async.bulk), frame f's rows
//    completing on its own mbarrier, so a warp starts on frame f as soon
//    as it has landed; otherwise 4-byte cp.async copies and one barrier.
//    (One round of 16-byte cp.async with a single wait, the simpler
//    design, took 3-6% longer at C = 5 and 22% at C = 16: PERF.md.)
//    Columns outside the frame are replicated by clamping the stencil's
//    column index (edge replication on the column side).
//  * Edge maps as bits: each lane computes the Sobel |g|^2 of one pixel,
//    walking its column down the band so that each staged row is read,
//    doubled and combined into its gy term once for the three output rows
//    that use it; it compares |g|^2 with t2, and __ballot_sync packs 32
//    pixels of a row into one word.  XOR of two frames is one XOR per word;
//    a block's score is the __popc of its bs bits per row (a funnel shift
//    where a block straddles two words, since bs need not divide 32)
//    summed over bs rows.  The counts are integers, so they are exact and
//    independent of order.  bs = 8 (the system's) is unrolled.
//  * Each output store is one float per output block; a chunk's scores are
//    written by consecutive threads.
// The Sobel arithmetic is the plain version's, operation for operation and
// in its order, with explicit IEEE intrinsics (no contraction into fused
// multiply-adds), so the edge maps are bitwise those of the plain version.
// Build without --use_fast_math.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

// one contiguous span of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory by the TMA unit, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// floats of dynamic shared memory the per-frame mbarriers take (8 bytes
// each for ppc + 1 frames, rounded up to 16 bytes)
__host__ __device__ inline int bar_floats(int ppc) {
  return ((ppc + 1) * 8 + 15) / 16 * 4;
}

struct Args {
  const float* frames;
  float* out;
  int M, H, W, bs;
  int seg_blocks;   // output blocks per column segment
  int nseg;         // column segments per band
  int ppc;          // pairs per chunk
  int nchunk;       // chunks per camera
  int sw;           // staged row stride in floats (multiple of 4)
  int vec;          // 1: 16-byte copies
  float t2;
};

// One staged row of a lane's 3x3 window: its left and right values, the
// same doubled, and the row's horizontal term (l + 2c) + r of gy.
struct Row {
  float l, r, l2, r2, d;
};

__device__ __forceinline__ Row load_row(const float* s, int il, int ic,
                                        int ir) {
  Row w;
  w.l = s[il];
  w.r = s[ir];
  w.l2 = __fmul_rn(2.0f, w.l);
  w.r2 = __fmul_rn(2.0f, w.r);
  w.d = __fadd_rn(__fadd_rn(w.l, __fmul_rn(2.0f, s[ic])), w.r);
  return w;
}

// The band's edge map of one frame over 32 columns as bs bit words: lane l
// walks column x0 + 32 k + l down the band, one ballot per row.  Each
// staged row is read and its doubled values and gy term formed once, for
// the three output rows that use it; the operations and their order per
// pixel are those of the plain version's
//   gx = ((tr + 2 mr) + br) - ((tl + 2 ml) + bl)
//   gy = ((bl + 2 bc) + br) - ((tl + 2 tc) + tr),  |g|^2 = gx gx + gy gy.
// BS > 0 fixes bs at compile time (the rows unrolled); BS == 0 reads it
// from the arguments.
template <int BS>
__device__ __forceinline__ void edge_words(const float* s, uint32_t* wrow,
                                           int bs_rt, int sw, int nw,
                                           int il, int ic, int ir,
                                           bool valid, float t2, int lane) {
  const int bs = BS > 0 ? BS : bs_rt;
  Row top = load_row(s, il, ic, ir);
  Row mid = load_row(s + sw, il, ic, ir);
#pragma unroll
  for (int r = 0; r < bs; ++r) {
    const Row bot = load_row(s + (r + 2) * sw, il, ic, ir);
    const float gx = __fsub_rn(__fadd_rn(__fadd_rn(top.r, mid.r2), bot.r),
                               __fadd_rn(__fadd_rn(top.l, mid.l2), bot.l));
    const float gy = __fsub_rn(bot.d, top.d);
    const bool e =
        valid && __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)) > t2;
    const uint32_t word = __ballot_sync(0xffffffffu, e);
    if (lane == 0) wrow[r * nw] = word;
    top = mid;
    mid = bot;
  }
}

template <int BS>
__global__ void edge_motion_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int M = a.M, H = a.H, W = a.W, bs = BS > 0 ? BS : a.bs, sw = a.sw;
  const int nb = W / bs;
  const int seg = blockIdx.x % a.nseg, band = blockIdx.x / a.nseg;
  const int c = blockIdx.y / a.nchunk, chunk = blockIdx.y % a.nchunk;
  const int bx0 = seg * a.seg_blocks;
  const int nbx = min(a.seg_blocks, nb - bx0);
  const int x0 = bx0 * bs, x1 = x0 + nbx * bs;   // the segment's columns
  const int p0 = chunk * a.ppc;
  const int np = min(a.ppc, M - 1 - p0);
  const int nf = np + 1;                          // frames p0 .. p0 + np
  const int rows = bs + 2;
  const int r0 = band * bs;
  // staged columns [ca, cb): the segment and one halo column each side,
  // within the frame, widened to 4-column bounds
  const int ca = max(x0 - 1, 0) & ~3;
  const int cb = min((min(x1 + 1, W) + 3) & ~3, W);
  const int nw = (x1 - x0 + 31) >> 5;             // words per row
  // shared memory: one mbarrier per frame, the staged rows, the words
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);
  float* stage = reinterpret_cast<float*>(smem4) + bar_floats(a.ppc);
  uint32_t* words = reinterpret_cast<uint32_t*>(
      stage + static_cast<size_t>(a.ppc + 1) * rows * sw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* fr = a.frames + (static_cast<size_t>(c) * M + p0) * H * W;

  // -- one round of copies: every row of every frame of the chunk --------
  if (a.vec) {
    // each row one bulk copy by the TMA unit, frame f's rows completing on
    // bars[f]; the compute below waits for each frame on its own
    const int bytes = (cb - ca) * 4;
    for (int f = tid; f < nf; f += nt) {   // a chunk may hold more frames
      bar_init(smem_addr(bars + f));       // than the block has threads
      bar_expect_tx(smem_addr(bars + f), rows * bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
    for (int row_id = tid; row_id < nf * rows; row_id += nt) {
      const int f = row_id / rows, rr = row_id - f * rows;
      const int gr = clampi(r0 - 1 + rr, 0, H - 1);
      bulk_copy(stage + static_cast<size_t>(row_id) * sw,
                fr + (static_cast<size_t>(f) * H + gr) * W + ca, bytes,
                smem_addr(bars + f));
    }
  } else {
    // 4-byte copies, the threads striding over every staged value
    const int per_row = cb - ca;
    for (int i = tid; i < nf * rows * per_row; i += nt) {
      const int row_id = i / per_row, q = i - row_id * per_row;
      const int f = row_id / rows, rr = row_id - f * rows;
      const int gr = clampi(r0 - 1 + rr, 0, H - 1);
      cp_async4(stage + static_cast<size_t>(row_id) * sw + q,
                fr + (static_cast<size_t>(f) * H + gr) * W + ca + q);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // -- edge maps as bit words: one (frame, 32-column word) per warp item --
  {
    const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
    for (int it = warp; it < nf * nw; it += nwarp) {
      const int f = it / nw, k = it - f * nw;
      if (a.vec) bar_wait(smem_addr(bars + f));
      const int x = x0 + 32 * k + lane;
      const int xc = min(x, x1 - 1);
      edge_words<BS>(stage + static_cast<size_t>(f) * rows * sw,
                     words + static_cast<size_t>(f) * bs * nw + k, bs, sw,
                     nw, max(xc - 1, 0) - ca, xc - ca,
                     min(xc + 1, W - 1) - ca, x < x1, a.t2, lane);
    }
    __syncthreads();
  }

  // -- block scores: popcount of the XOR bits of each bs x bs block -------
  {
    const uint32_t mask = bs >= 32 ? 0xffffffffu : (1u << bs) - 1u;
    const int nbands = H / bs;
    for (int o = tid; o < np * nbx; o += nt) {
      const int p = o / nbx, j = o - p * nbx;
      const int lo = j * bs, k0 = lo >> 5, off = lo & 31;
      const bool straddle = off + bs > 32;
      const uint32_t* wa = words + static_cast<size_t>(p) * bs * nw + k0;
      const uint32_t* wb = wa + static_cast<size_t>(bs) * nw;
      int cnt = 0;
#pragma unroll
      for (int r = 0; r < bs; ++r) {
        const uint32_t d0 = wa[r * nw] ^ wb[r * nw];
        const uint32_t d1 = straddle ? wa[r * nw + 1] ^ wb[r * nw + 1] : 0u;
        cnt += __popc(__funnelshift_r(d0, d1, off) & mask);
      }
      a.out[((static_cast<size_t>(c) * (M - 1) + p0 + p) * nbands + band) *
                nb + bx0 + j] = static_cast<float>(cnt);
    }
  }
}

// Sets the instance's shared-memory limit once, then launches it.
template <int BS>
int launch(const Args& a, dim3 grid, int threads, int smem,
           cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      edge_motion_kernel<BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  edge_motion_kernel<BS><<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block: an mbarrier per frame, the staged
// rows of ppc + 1 frames and their edge-map words.
extern "C" int edge_motion_smem(int bs, int seg_blocks, int ppc) {
  const int ws = seg_blocks * bs;
  const int sw = (ws + 8 + 3) & ~3;
  const int nw = (ws + 31) / 32;
  return 4 * bar_floats(ppc) + (ppc + 1) * ((bs + 2) * sw + bs * nw) * 4;
}

// frames (C, M, H, W) float32 contiguous -> out (C, M-1, H/bs, W/bs), with
// the column segments of seg_blocks output blocks and the chunks of ppc
// pairs that ops.plan chose (1 <= bs <= 32).  Returns the launch's
// cudaError_t (0 on success).
extern "C" int edge_motion_launch(const float* frames, float* out, int C,
                                  int M, int H, int W, int bs, float t2,
                                  int seg_blocks, int ppc, void* stream) {
  Args a;
  a.frames = frames;
  a.out = out;
  a.M = M;
  a.H = H;
  a.W = W;
  a.bs = bs;
  a.seg_blocks = seg_blocks;
  const int nb = W / bs;
  a.nseg = (nb + seg_blocks - 1) / seg_blocks;
  a.ppc = ppc;
  a.nchunk = (M - 1 + ppc - 1) / ppc;
  a.sw = ((seg_blocks * bs) + 8 + 3) & ~3;
  a.vec = (W % 4 == 0) && (reinterpret_cast<uintptr_t>(frames) % 16 == 0);
  a.t2 = t2;
  const int smem = edge_motion_smem(bs, seg_blocks, ppc);
  const int nw = (seg_blocks * bs + 31) / 32;
  int warps = (ppc + 1) * nw;
  warps = warps < 4 ? 4 : (warps > 16 ? 16 : warps);
  const dim3 grid(a.nseg * (H / bs), C * a.nchunk);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bs == 8 ? launch<8>(a, grid, 32 * warps, smem, st)
                 : launch<0>(a, grid, 32 * warps, smem, st);
}
