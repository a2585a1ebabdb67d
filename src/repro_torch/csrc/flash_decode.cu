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
// flops.  At the LM decode's shape (B=4, KV=8, hd=128, bf16) and n = 2048
// that is 33.5 MB, 10 us at 3.35 TB/s.  At short valid lengths (528 there:
// 2.6 us of bytes) a call is bound instead by the latency of one block's
// chain: launch, the first tile's load, its products, the range merge.
//
// Design.  The TPU kernel walked S as a sequential grid axis with (m, l,
// acc) in VMEM scratch.  Here the valid positions [0, n_pos) are cut into
// ranges of whole 64-position tiles, one block per (range, b * KV + h),
// so that enough blocks run on the 132 SMs, and all of it is ONE launch:
//
//   * Tile ring.  One producer warp (one thread of it) streams the
//     range's K and V tiles into a ring of `stages` shared-memory stages
//     with TMA (cp.async.bulk.tensor on 4-D tensor maps of the cache,
//     encoded on the host), each stage guarded by a "full" mbarrier (the
//     copy's bytes) and an "empty" one (its consumer is done).  Positions
//     past S are zero-filled by the hardware and never read into the next
//     batch row.  bf16 tiles come in boxes of 64 positions x 64 columns
//     with the 128-byte swizzle (hd 112 zero-fills its tail); float32
//     tiles in one box of 64 x hd, unswizzled.
//   * Consumers.  Four consumer warps keep their own (m, l, acc), so no
//     warp waits on another inside the loop.  In bf16 they share every
//     tile, warp w owning its positions 16 w .. 16 w + 15, and a stage is
//     free when all four have arrived on its empty barrier; in float32
//     tile t goes to warp t % NC.  In bf16 both products run on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate), A and
//     B swapped for the small query group: S^T = K_tile . q^T with the 64
//     positions on M (K through ldmatrix from the swizzled stage; one
//     16-row m-tile per warp) and the
//     G query rows on N (ceil(G/8) zero-padded n-tiles), then
//     O^T += V_tile^T . P^T with V through ldmatrix.trans; P is rounded to
//     bf16 in registers and moved from the score fragment into the B
//     fragment with four warp shuffles per 16 positions, with no trip
//     through shared memory.  Row max and sum use shuffles on the
//     fragments.  In float32 (the smoke engine, held to 1e-5, where TF32
//     would not do) the products stay on the CUDA cores: lane t scores
//     positions t and t + 32 for all G rows, then owns output columns
//     t + 32 j for P.V.
//   * Merge.  The consumer warps merge through shared memory.  With one
//     range the block writes out, m and l.  Otherwise it writes its
//     range's (m, l, acc) to a persistent float32 workspace, and the last
//     block of each (b, kv head) to finish (an atomic counter, with
//     release and acquire order) merges them, writes out, m and l, and sets the
//     counter back to 0 for the next call (or a CUDA-graph replay).
//
// Semantics at the edges: positions past a range score -inf against
// zero-filled V rows (in bf16 each warp zeroes its rows of a range's last
// tile past the end; float32 skips them), so 0 * V stays finite; when
// n > 0 the ranges stop at n, and when n = 0 they cover all S positions,
// scored -1e30.  Built without --use_fast_math: expf and IEEE division.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kTile = 64;          // positions per tile
constexpr int kMaxConsumers = 4;   // consumer warps per block
constexpr int kMaxG = 16;          // query rows per kv head
constexpr int kMaxSplits = 128;    // ranges per (b, kv head)
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// -- shared-memory layout, shared by the host check and the kernel -------

struct Layout {
  int tile_bytes;    // one K (or V) tile
  int ring;          // offset 0: stages x (K tile, V tile); reused to merge
  int bars;          // 2 * stages mbarriers (full, then empty), stages <= 8
  int q;             // query rows: bf16 [16][hdp + 8] zero-padded, f32 [G][hd]
  int misc;          // merge scalars
  int p;             // float32 path: per-warp P rows [NC][64][16]
  int total;         // bytes from the 1024-aligned base
};

__host__ __device__ inline int hd_pad(bool bf16, int hd) {
  return bf16 ? (hd + 63) / 64 * 64 : (hd + 31) / 32 * 32;
}

__host__ __device__ inline Layout layout(bool bf16, int hd, int stages) {
  Layout L;
  const int hdp = hd_pad(bf16, hd);
  L.tile_bytes = bf16 ? (hdp / 64) * kTile * 64 * 2 : kTile * hd * 4;
  int region = stages * 2 * L.tile_bytes;
  const int merge = kMaxConsumers * kMaxG * hd * 4;
  const int weights = kMaxSplits * kMaxG * 8;
  region = region > merge ? region : merge;
  region = region > weights ? region : weights;
  L.ring = 0;
  L.bars = region;
  L.q = L.bars + 128;
  L.misc = L.q + kMaxG * (hdp + 8) * 4;
  L.p = L.misc + 1024;
  L.total = L.p + (bf16 ? 0 : kMaxConsumers * kTile * kMaxG * 4);
  return L;
}

// -- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate; not
// volatile: registers only, so the compiler may schedule it freely
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ int fetch_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// byte offset of the 16-byte chunk `chunk` (0..7) of row `row` in a
// 64-row x 128-byte box written by TMA with the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

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

// What a block knows of its range and the call.
struct Range {
  int p_begin, p_end;   // positions [p_begin, p_end) of this block
  int ntiles;
  int valid_len;
  float scale;
};

// Everything a launch passes besides the two tensor maps.
struct Args {
  const void* q;
  void* out;
  float* m;
  float* l;
  float* part_acc;   // (B*KV, nsplit, G, hd) range partials
  float* part_ml;    // (B*KV, nsplit, G, 2) their (m, l)
  int* counter;      // (B*KV,) ranges done; 0 between calls
  int KV, G, hd, valid_len, n_pos, per, nsplit, stages;
  float scale;
};

// -- the producer warp -----------------------------------------------------

// Streams the range's tiles through the ring: one thread, every tile's K
// and V boxes on the stage's full barrier, after its empty barrier says
// the tile `stages` earlier was consumed.
__device__ __forceinline__ void produce(const CUtensorMap* km,
                                        const CUtensorMap* vm,
                                        const Range& R, int b, int h,
                                        int stages, uint32_t ring,
                                        uint32_t bars, int tile_bytes,
                                        int nbox, int box_w) {
  const int box_bytes = tile_bytes / nbox;
  for (int t = 0; t < R.ntiles; ++t) {
    const int s = t % stages;
    if (t >= stages) bar_wait(bars + 8 * (stages + s), ((t / stages) & 1) ^ 1);
    const uint32_t full = bars + 8 * s;
    bar_expect_tx(full, 2 * tile_bytes);
    const uint32_t kdst = ring + s * 2 * tile_bytes;
    const int p0 = R.p_begin + t * kTile;
    for (int j = 0; j < nbox; ++j) {
      tma_load(kdst + j * box_bytes, km, j * box_w, h, p0, b, full);
      tma_load(kdst + tile_bytes + j * box_bytes, vm, j * box_w, h, p0, b,
               full);
    }
  }
}

// -- merge -----------------------------------------------------------------

// After the consumer warps stashed acc [nc][G][hd] (at the ring) and
// (m, l) [4][16][2] (at misc): merge them; with one range write out, m
// and l, else the range's partial, and let the last range of the
// (b, kv head) merge all partials.
template <typename T>
__device__ void finish(unsigned char* sm, const Layout& L, const Args& a,
                       int nc, int bh, int split) {
  const int G = a.G, hd = a.hd, nsplit = a.nsplit;
  const int tid = threadIdx.x, nthr = blockDim.x;
  float* acc = reinterpret_cast<float*>(sm + L.ring);
  float* ml = reinterpret_cast<float*>(sm + L.misc);   // [4][16][2]
  float* wts = ml + kMaxConsumers * kMaxG * 2;          // [4][16]
  float* fin = wts + kMaxConsumers * kMaxG;             // [16][2]
  int* flag = reinterpret_cast<int*>(fin + kMaxG * 2);
  T* out = static_cast<T*>(a.out);
  __syncthreads();
  if (tid < G) {
    float M = kNeg;
    for (int w = 0; w < nc; ++w) M = fmaxf(M, ml[(w * kMaxG + tid) * 2]);
    float Ls = 0.0f;
    for (int w = 0; w < nc; ++w) {
      const float wt = expf(ml[(w * kMaxG + tid) * 2] - M);
      wts[w * kMaxG + tid] = wt;
      Ls = fmaf(ml[(w * kMaxG + tid) * 2 + 1], wt, Ls);
    }
    fin[tid * 2] = M;
    fin[tid * 2 + 1] = Ls;
  }
  __syncthreads();
  const bool single = nsplit == 1;
  const int64_t r = static_cast<int64_t>(bh) * nsplit + split;
  for (int i = tid; i < G * hd; i += nthr) {
    const int g = i / hd;
    float s = 0.0f;
    for (int w = 0; w < nc; ++w)
      s = fmaf(acc[w * G * hd + i], wts[w * kMaxG + g], s);
    if (single)
      out[static_cast<int64_t>(bh) * G * hd + i] =
          Num<T>::from_f(s / fmaxf(fin[g * 2 + 1], 1e-30f));
    else
      a.part_acc[r * G * hd + i] = s;
  }
  if (tid < G) {
    if (single) {
      a.m[bh * G + tid] = fin[tid * 2];
      a.l[bh * G + tid] = fin[tid * 2 + 1];
    } else {
      a.part_ml[(r * G + tid) * 2] = fin[tid * 2];
      a.part_ml[(r * G + tid) * 2 + 1] = fin[tid * 2 + 1];
    }
  }
  if (single) return;
  // one thread announces the block's partial with a release (cumulative
  // over the block's writes, which the barrier orders before it) and
  // learns with the acquire whether every other range is in
  __syncthreads();
  if (tid == 0) *flag = fetch_add_acq_rel(a.counter + bh, 1) == nsplit - 1;
  __syncthreads();
  if (!*flag) return;
  // the last range of this (b, kv head): merge every range's partial.
  // Every (m, l) comes into shared memory in one round of loads, then the
  // weights replace the m's; the acc rows come as float4, four ranges'
  // loads in flight at a time.
  const int64_t r0 = static_cast<int64_t>(bh) * nsplit;
  float2* sml = reinterpret_cast<float2*>(acc);         // [nsplit][G]
  const float2* pml = reinterpret_cast<const float2*>(a.part_ml) + r0 * G;
  for (int i = tid; i < nsplit * G; i += nthr) sml[i] = __ldcg(pml + i);
  __syncthreads();
  if (tid < G) {
    float M = kNeg;
    for (int i = 0; i < nsplit; ++i) M = fmaxf(M, sml[i * G + tid].x);
    float Ls = 0.0f;
    for (int i = 0; i < nsplit; ++i) {
      const float wt = expf(sml[i * G + tid].x - M);
      sml[i * G + tid].x = wt;
      Ls = fmaf(sml[i * G + tid].y, wt, Ls);
    }
    fin[tid * 2] = M;
    fin[tid * 2 + 1] = Ls;
  }
  __syncthreads();
  const float4* pacc =
      reinterpret_cast<const float4*>(a.part_acc + r0 * G * hd);
  const int n4 = G * hd / 4;
  for (int i = tid; i < n4; i += nthr) {
    const int g = (4 * i) / hd;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int j = 0; j < nsplit; ++j) {
      const float4 v = __ldcg(pacc + static_cast<int64_t>(j) * n4 + i);
      const float w = sml[j * G + g].x;
      s.x = fmaf(v.x, w, s.x);
      s.y = fmaf(v.y, w, s.y);
      s.z = fmaf(v.z, w, s.z);
      s.w = fmaf(v.w, w, s.w);
    }
    const float inv = fmaxf(fin[g * 2 + 1], 1e-30f);
    T* o = out + static_cast<int64_t>(bh) * G * hd + 4 * i;
    o[0] = Num<T>::from_f(s.x / inv);
    o[1] = Num<T>::from_f(s.y / inv);
    o[2] = Num<T>::from_f(s.z / inv);
    o[3] = Num<T>::from_f(s.w / inv);
  }
  if (tid < G) {
    a.m[bh * G + tid] = fin[tid * 2];
    a.l[bh * G + tid] = fin[tid * 2 + 1];
  }
  if (tid == 0) a.counter[bh] = 0;
}

// -- the kernel ------------------------------------------------------------

// One block per (range, b * KV + h): nc consumer warps, then the producer
// warp.  T = __nv_bfloat16: tensor-core products, HDP = hd rounded up to
// 64, NT = ceil(G / 8) query n-tiles.  T = float: CUDA-core products,
// HDP = hd rounded up to 32.
template <typename T, int HDP, int NT>
__global__ void __launch_bounds__(32 * (kMaxConsumers + 1))
    fd_kernel(const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const Args a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L = layout(kBf16, a.hd, a.stages);
  const int G = a.G, hd = a.hd, stages = a.stages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = blockDim.x / 32 - 1;
  const int bh = blockIdx.y, b = bh / a.KV, h = bh - b * a.KV;
  const int split = blockIdx.x;
  Range R;
  R.p_begin = split * a.per * kTile;
  R.p_end = min(a.n_pos, R.p_begin + a.per * kTile);
  R.ntiles = (R.p_end - R.p_begin + kTile - 1) / kTile;
  R.valid_len = a.valid_len;
  R.scale = a.scale;
  const uint32_t ring = smem_u32(sm + L.ring);
  const uint32_t bars = smem_u32(sm + L.bars);
  float* ml = reinterpret_cast<float*>(sm + L.misc);   // [4][16][2]
  float* acc = reinterpret_cast<float*>(sm + L.ring);  // [nc][G][hd]

  const T* qg = static_cast<const T*>(a.q) + static_cast<int64_t>(bh) * G * hd;
  constexpr int QS = kBf16 ? HDP + 8 : 0;
  T* qs = reinterpret_cast<T*>(sm + L.q);
  // the G query rows: every thread loads its 16-byte chunks first (at
  // most kQPre each in one round), so their latency overlaps the barrier
  // set-up; bf16 rows are padded to 16 rows of HDP + 8 columns (so the
  // B-fragment loads hit distinct banks) with zeros
  {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int kQPre = 8;
    const int row = hd / VEC, nchunks = G * row;
    uint4 qv[kQPre];
#pragma unroll
    for (int j = 0; j < kQPre; ++j) {
      const int i = tid + j * blockDim.x;
      if (i < nchunks) qv[j] = reinterpret_cast<const uint4*>(qg)[i];
    }
    auto put = [&](int i, const uint4& x) {
      const int g = i / row, d = (i - g * row) * VEC;
      *reinterpret_cast<uint4*>(qs + g * (kBf16 ? QS : hd) + d) = x;
    };
#pragma unroll
    for (int j = 0; j < kQPre; ++j) {
      const int i = tid + j * blockDim.x;
      if (i < nchunks) put(i, qv[j]);
    }
    for (int i = tid + kQPre * blockDim.x; i < nchunks; i += blockDim.x)
      put(i, reinterpret_cast<const uint4*>(qg)[i]);
    if constexpr (kBf16) {
      for (int i = tid; i < kMaxG * (QS / 8); i += blockDim.x) {
        const int g = i / (QS / 8), d = (i - g * (QS / 8)) * 8;
        if (g >= G || d >= hd)
          *reinterpret_cast<uint4*>(qs + g * QS + d) = make_uint4(0, 0, 0, 0);
      }
    }
  }
  if (tid == 0) {
    // full: the producer's one arrival; empty: every consumer warp (bf16)
    // or the tile's one consumer warp (float32)
    for (int s = 0; s < 2 * stages; ++s)
      bar_init(bars + 8 * s, s < stages || !kBf16 ? 1 : nc);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == nc) {
    if (lane == 0)
      produce(&kmap, &vmap, R, b, h, stages, ring, bars, L.tile_bytes,
              kBf16 ? HDP / 64 : 1, kBf16 ? 64 : 0);
    __syncwarp();
    __syncthreads();
  } else if constexpr (kBf16) {
    constexpr int MT = HDP / 16;   // 16-column tiles of hd
    const int r = lane >> 2, c = lane & 3;
    const int ksteps = (hd + 15) / 16;
    float o[MT][NT][4];
    float mrow[NT][2], lsum[NT][2];
#pragma unroll
    for (int md = 0; md < MT; ++md)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[md][nt][i] = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mrow[nt][j] = kNeg;
        lsum[nt][j] = 0.0f;
      }
    // warp w owns rows [16 w, 16 w + 16) of every tile: its K rows are
    // the M side of the scores, its V rows the k-step of P.V
    const int mt = warp;
    const int a_row = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;   // K
    const int a_col = (lane >> 4) * 8;
    const int v_row = mt * 16 + (lane & 7) + (lane >> 4) * 8;         // V
    const int v_col = ((lane >> 3) & 1) * 8;
    // P^T fragment sources: this lane's B needs P[2c..2c+1 (+8)][r]
    const int src_a = 8 * c + (r >> 1), src_b = src_a + 4;
    const uint32_t sel = (r & 1) ? 0x7632u : 0x5410u;
    for (int t = 0; t < R.ntiles; ++t) {
      const int s = t % stages;
      bar_wait(bars + 8 * s, (t / stages) & 1);
      const uint32_t kt = ring + s * 2 * L.tile_bytes;
      const uint32_t vt = kt + L.tile_bytes;
      const int p0 = R.p_begin + t * kTile;
      const int nvalid = R.p_end - p0;   // rows of the range in this tile
      if (nvalid < mt * 16 + 16) {
        // this warp's V rows past the range: zeros, so 0 * V stays finite
        unsigned char* vp = sm + L.ring + s * 2 * L.tile_bytes + L.tile_bytes;
        const int r_lo = max(nvalid, mt * 16);
        const int per_box = (mt * 16 + 16 - r_lo) * 8;
        for (int i = lane; i < (HDP / 64) * per_box; i += 32) {
          const int box = i / per_box, rem = i - box * per_box;
          *reinterpret_cast<uint4*>(vp + box * 8192 +
                                    (r_lo + (rem >> 3)) * 128 +
                                    ((rem & 7) << 4)) = make_uint4(0, 0, 0, 0);
        }
        __syncwarp();
      }
      // scores S^T = K . q^T for the warp's 16 positions x NT n-tiles
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[nt][i] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < MT; ++ks) {
        if (ks < ksteps) {
          const int col = ks * 16 + a_col;
          uint32_t af[4];
          ldsm_x4(kt + (col >> 6) * 8192 + swz(a_row, (col & 63) >> 3), af);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const T* qr = qs + (nt * 8 + r) * QS + ks * 16 + 2 * c;
            mma_bf16(sc[nt], af, *reinterpret_cast<const uint32_t*>(qr),
                     *reinterpret_cast<const uint32_t*>(qr + 8));
          }
        }
      }
      // mask, then the online softmax per query column (2c + j of n-tile
      // nt); the warp's 16 positions of a column lie on lanes c, c+4, ...
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pos = p0 + mt * 16 + r + ((i & 2) ? 8 : 0);
          const float v = sc[nt][i] * R.scale;
          sc[nt][i] = pos >= R.p_end ? -CUDART_INF_F
                      : pos < R.valid_len ? v : kNeg;
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float mx = fmaxf(sc[nt][j], sc[nt][j + 2]);
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
          const float mn = fmaxf(mrow[nt][j], mx);
          const float alpha = expf(mrow[nt][j] - mn);
          mrow[nt][j] = mn;
          sc[nt][j] = expf(sc[nt][j] - mn);
          sc[nt][j + 2] = expf(sc[nt][j + 2] - mn);
          lsum[nt][j] = fmaf(lsum[nt][j], alpha, sc[nt][j] + sc[nt][j + 2]);
#pragma unroll
          for (int md = 0; md < MT; ++md) {
            o[md][nt][j] *= alpha;
            o[md][nt][j + 2] *= alpha;
          }
        }
      // O^T += V^T . P^T: one k-step over the warp's 16 positions
      uint32_t pb[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t lo = pack_bf16(sc[nt][0], sc[nt][1]);
        const uint32_t hi = pack_bf16(sc[nt][2], sc[nt][3]);
        const uint32_t la = __shfl_sync(kFull, lo, src_a);
        const uint32_t lb = __shfl_sync(kFull, lo, src_b);
        const uint32_t ha = __shfl_sync(kFull, hi, src_a);
        const uint32_t hb = __shfl_sync(kFull, hi, src_b);
        pb[nt][0] = __byte_perm(la, lb, sel);
        pb[nt][1] = __byte_perm(ha, hb, sel);
      }
#pragma unroll
      for (int md = 0; md < MT; ++md) {
        if (md < ksteps) {
          const int col = md * 16 + v_col;
          uint32_t af[4];
          ldsm_x4_t(vt + (col >> 6) * 8192 + swz(v_row, (col & 63) >> 3), af);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(o[md][nt], af, pb[nt][0], pb[nt][1]);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(bars + 8 * (stages + s));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = lsum[nt][j];
        v += __shfl_xor_sync(kFull, v, 4);
        v += __shfl_xor_sync(kFull, v, 8);
        v += __shfl_xor_sync(kFull, v, 16);
        lsum[nt][j] = v;
      }
    __syncthreads();   // every warp is done with the ring: stash there
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int g = nt * 8 + 2 * c + (i & 1);
        if (g < G) {
          if (r == 0 && i < 2) {
            ml[(warp * kMaxG + g) * 2] = mrow[nt][i];
            ml[(warp * kMaxG + g) * 2 + 1] = lsum[nt][i];
          }
#pragma unroll
          for (int md = 0; md < MT; ++md) {
            const int d = md * 16 + r + ((i & 2) ? 8 : 0);
            if (d < hd) acc[(warp * G + g) * hd + d] = o[md][nt][i];
          }
        }
      }
  } else {
    // float32: lane t scores positions t and t + 32 for every row g, then
    // owns output columns t + 32 j
    constexpr int NJ = HDP / 32;
    const float* qf = reinterpret_cast<const float*>(qs);
    float* ps = reinterpret_cast<float*>(sm + L.p) + warp * kTile * kMaxG;
    float o[kMaxG][NJ], mrow[kMaxG], lsum[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      mrow[g] = kNeg;
      lsum[g] = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[g][j] = 0.0f;
    }
    const int nq = hd / 4;                // 16-byte chunks of a row
    for (int t = warp; t < R.ntiles; t += nc) {
      const int s = t % stages;
      bar_wait(bars + 8 * s, (t / stages) & 1);
      const float* kt =
          reinterpret_cast<const float*>(sm + L.ring + s * 2 * L.tile_bytes);
      const float* vt = kt + kTile * hd;
      const int p0 = R.p_begin + t * kTile;
      const int nvalid = min(kTile, R.p_end - p0);
      float sc[2][kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) sc[0][g] = sc[1][g] = 0.0f;
      // chunks in a rotated order, so a quarter-warp hits distinct banks
      int ch = lane % nq;
      for (int cc = 0; cc < nq; ++cc) {
        const float4 k0 =
            *reinterpret_cast<const float4*>(kt + lane * hd + 4 * ch);
        const float4 k1 =
            *reinterpret_cast<const float4*>(kt + (lane + 32) * hd + 4 * ch);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qf + g * hd + 4 * ch);
            sc[0][g] = fmaf(qv.x, k0.x, sc[0][g]);
            sc[0][g] = fmaf(qv.y, k0.y, sc[0][g]);
            sc[0][g] = fmaf(qv.z, k0.z, sc[0][g]);
            sc[0][g] = fmaf(qv.w, k0.w, sc[0][g]);
            sc[1][g] = fmaf(qv.x, k1.x, sc[1][g]);
            sc[1][g] = fmaf(qv.y, k1.y, sc[1][g]);
            sc[1][g] = fmaf(qv.z, k1.z, sc[1][g]);
            sc[1][g] = fmaf(qv.w, k1.w, sc[1][g]);
          }
        }
        ch = (ch + 1 == nq) ? 0 : ch + 1;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pos = p0 + lane + 32 * e;
            const float v = sc[e][g] * R.scale;
            sc[e][g] = pos >= R.p_end ? -CUDART_INF_F
                       : pos < R.valid_len ? v : kNeg;
          }
          float mx = fmaxf(sc[0][g], sc[1][g]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
          const float mn = fmaxf(mrow[g], mx);
          const float alpha = expf(mrow[g] - mn);
          mrow[g] = mn;
          const float e0 = expf(sc[0][g] - mn), e1 = expf(sc[1][g] - mn);
          lsum[g] = fmaf(lsum[g], alpha, e0 + e1);
          ps[lane * kMaxG + g] = e0;
          ps[(lane + 32) * kMaxG + g] = e1;
#pragma unroll
          for (int j = 0; j < NJ; ++j) o[g][j] *= alpha;
        }
      }
      __syncwarp();
      // positions past the range weigh 0: skipped, V never read there
      for (int p = 0; p < nvalid; ++p) {
        const float* pr = ps + p * kMaxG;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          const float vv = d < hd ? vt[p * hd + d] : 0.0f;
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) o[g][j] = fmaf(pr[g], vv, o[g][j]);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(bars + 8 * (stages + s));
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        lsum[g] += __shfl_xor_sync(kFull, lsum[g], off);
    }
    __syncthreads();   // every warp is done with the ring: stash there
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        if (lane == 0) {
          ml[(warp * kMaxG + g) * 2] = mrow[g];
          ml[(warp * kMaxG + g) * 2 + 1] = lsum[g];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          if (d < hd) acc[(warp * G + g) * hd + d] = o[g][j];
        }
      }
    }
  }
  finish<T>(sm, L, a, nc, bh, split);
}

// -- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found once through the runtime's entry-point
// query (no link against libcuda)
EncodeTiled encoder(int* err) {
  static EncodeTiled fn = nullptr;
  static int status = -1;
  if (status < 0) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && (q != cudaDriverEntryPointSuccess || !p))
      e = cudaErrorSymbolNotFound;
    status = static_cast<int>(e);
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *err = status;
  return fn;
}

// Sets the instance's shared-memory limit once, then launches it.
template <typename T, int HDP, int NT>
int launch(const CUtensorMap& km, const CUtensorMap& vm, const Args& a,
           int B, size_t smem, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fd_kernel<T, HDP, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // bf16: four consumer warps share every tile; float32: tile t goes to
  // warp t % nc, which needs nc <= stages
  const int nc = sizeof(T) == 2 || a.stages >= kMaxConsumers ? kMaxConsumers
                                                             : a.stages;
  fd_kernel<T, HDP, NT><<<dim3(a.nsplit, B * a.KV), 32 * (nc + 1), smem,
                          st>>>(km, vm, a);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_bf16(const CUtensorMap& km, const CUtensorMap& vm, const Args& a,
                int B, size_t smem, cudaStream_t st) {
  return a.G <= 8 ? launch<__nv_bfloat16, HDP, 1>(km, vm, a, B, smem, st)
                  : launch<__nv_bfloat16, HDP, 2>(km, vm, a, B, smem, st);
}

}  // namespace

// Encodes the tensor map of a (B, S, KV, hd) cache (dtype 0: float32, box
// 64 positions x hd, no swizzle; 1: bfloat16, boxes of 64 positions x 64
// columns, 128-byte swizzle) into the 128 bytes at `map_out`.  Returns 0,
// a cudaError_t from finding the encoder, or 1000 + the CUresult.
extern "C" int flash_decode_encode_map(int dtype, const void* base, int B,
                                       int S, int KV, int hd,
                                       void* map_out) {
  int err = 0;
  const EncodeTiled encode = encoder(&err);
  if (err != 0) return err;
  const cuuint64_t esz = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {hd * esz, KV * hd * esz,
                                 static_cast<cuuint64_t>(S) * KV * hd * esz};
  const cuuint32_t box[4] = {dtype == 0 ? static_cast<cuuint32_t>(hd) : 64u,
                             1u, static_cast<cuuint32_t>(kTile), 1u};
  const cuuint32_t estr[4] = {1u, 1u, 1u, 1u};
  CUtensorMap map;
  const CUresult r = encode(
      &map,
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      dtype == 0 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  std::memcpy(map_out, &map, sizeof(map));
  return 0;
}

// Dynamic shared memory of one block (the layout plus 1024 bytes to align
// its base), as the wrapper plans with it.
extern "C" int flash_decode_smem(int dtype, int hd, int stages) {
  return layout(dtype != 0, hd, stages).total + 1024;
}

// dtype 0: float32, 1: bfloat16.  kmap and vmap: 128-byte maps from
// flash_decode_encode_map; q (B, 1, KV*G, hd), out like q, m and l
// (B, KV, G) float32, all contiguous on the card; G <= 16, hd a multiple
// of 16 (bf16, <= 256) or 4 (f32, <= 256).  The valid positions
// [0, n_pos) (n_pos = min(valid_len, S), or S when valid_len = 0) are cut
// into nsplit ranges of `per` 64-position tiles, streamed through
// `stages` ring stages; with nsplit > 1, part_acc (B*KV, nsplit, G, hd)
// and part_ml (B*KV, nsplit, G, 2) float32 hold the partials and counter
// (B*KV,) int32 must be 0.  Returns the first failing cudaError_t, or 0.
extern "C" int flash_decode_launch(int dtype, const void* kmap,
                                   const void* vmap, const void* q, void* out,
                                   float* m, float* l, float* part_acc,
                                   float* part_ml, int* counter, int B,
                                   int KV, int G, int hd, int valid_len,
                                   int n_pos, int per, int nsplit, int stages,
                                   float scale, void* stream) {
  if (G < 1 || G > kMaxG || hd < 4 || hd > 256 || stages < 1 ||
      stages > 8 || nsplit < 1 || nsplit > kMaxSplits ||
      hd % (dtype == 0 ? 4 : 16) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(flash_decode_smem(dtype, hd, stages));
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap km, vm;
  std::memcpy(&km, kmap, sizeof(km));
  std::memcpy(&vm, vmap, sizeof(vm));
  Args a;
  a.q = q;
  a.out = out;
  a.m = m;
  a.l = l;
  a.part_acc = part_acc;
  a.part_ml = part_ml;
  a.counter = counter;
  a.KV = KV;
  a.G = G;
  a.hd = hd;
  a.valid_len = valid_len;
  a.n_pos = n_pos;
  a.per = per;
  a.nsplit = nsplit;
  a.stages = stages;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hdp = hd_pad(dtype != 0, hd);
  if (dtype == 0) {
    switch (hdp) {
      case 32: return launch<float, 32, 1>(km, vm, a, B, smem, st);
      case 64: return launch<float, 64, 1>(km, vm, a, B, smem, st);
      case 96:
      case 128: return launch<float, 128, 1>(km, vm, a, B, smem, st);
      default: return launch<float, 256, 1>(km, vm, a, B, smem, st);
    }
  }
  switch (hdp) {
    case 64: return launch_bf16<64>(km, vm, a, B, smem, st);
    case 128: return launch_bf16<128>(km, vm, a, B, smem, st);
    case 192: return launch_bf16<192>(km, vm, a, B, smem, st);
    default: return launch_bf16<256>(km, vm, a, B, smem, st);
  }
}
