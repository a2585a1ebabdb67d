// Multiple-choice knapsack DP (paper section 5.2): the sweep, and the sweep
// with its bounded backtrack in the same launch.
//
// Replaces the TPU kernel src/repro/kernels/knapsack_dp/knapsack_dp.py:54
// (knapsack_dp_pallas, body _dp_kernel).  With V_0[w] = 0,
//
//   V_i[w] = max_j V_{i-1}[w - c_j] + u[i, j]     (w >= c_j, else NEG),
//
// ties to the lowest j.  knapsack_dp_launch writes the final value row V_I
// (W+1,) and the per-camera argmax table (I, W+1), what the TPU kernel
// computes.  knapsack_dp_solve_launch goes on in the same launch to what
// the allocators need: the best w <= Wg (first on ties, as torch.argmax),
// the total there, and the reverse walk w = max(w - c[choice[i, w]], 0)
// that yields one pick per camera; Wg is read from device memory, so the
// caller never syncs and the launch can be captured in a graph.  Before,
// the device solve was this sweep plus ~30 small PyTorch kernels of the
// backtrack (~85 at 16 cameras).
//
// What bounds it on the H100: latency, not bytes or operations.  One solve
// at the main path's shape (I=5, J=6, W+1=128) moves ~200 bytes and does
// ~11.5k operations, but camera i needs camera i-1's whole row, so the
// sweep is I dependent steps, and the walk I dependent reads.  The time is
// the launch, one round of loads, and those chains.
//
// Design: for W+1 <= 256 (the fleet's capacity buckets: 128 at the main
// path, 256 at the harness's pinned 8 Mbps) one warp does the sweep with
// the value row in registers, lane l holding w = l + 32 r for r < R (4 at
// W+1 <= 128, else 8).
// V[w - c] comes from lane (l - c) mod 32 by __shfl_sync, from register r
// or r - 1 by a select on the lane, after a rotation of the registers by
// c / 32 where some cost is >= 32 (uniform branches on its bits), so a
// camera's step never touches shared memory and needs no barrier.  The
// utilities and costs are loaded by the warp in one round; the first
// group of options (six for the fleet's six bitrates, else eight) keeps
// its costs in registers and is unrolled, so that its shuffles issue back
// to back.  One warp issues all of a camera's ~200 instructions itself,
// which is what a step costs; a four-warp variant with the row in shared
// memory and a barrier per camera was no faster.  Wider rows take the
// block sweep: 1024 threads stride over w with two value rows ping-ponged
// in shared memory and a __syncthreads() between cameras.  In the solve,
// the choice table stays in shared memory, one byte per entry (J <= 255,
// and when it fits); otherwise it goes to a device-memory scratch table
// that the walk reads back after a barrier.  The best w comes from a warp
// max (__reduce_max_sync) of order-preserving integer keys, then the
// lowest w holding it (__reduce_min_sync).  Per (i, w): best = NEG,
// arg = 0, and for j ascending the candidate __fadd_rn(V[w - c_j],
// u[i, j]) of a valid w - c_j (else NEG, as the plain version's where) is
// taken only if it is strictly greater, which keeps the lowest j
// (jnp.argmax's rule and the TPU kernel's).  Costs must be >= 0.  Build
// without --use_fast_math.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr int kWarpMax = 256;      // widest row the one-warp sweep takes
constexpr int kBlock = 1024;       // threads of the block sweep
constexpr int kJReg = 8;           // options whose costs stay in registers

struct Args {
  const float* util;   // (I, J)
  const int* costs;    // (J,)
  float* vals;         // (wp1,) sweep only
  int* choices;        // (I, wp1): the sweep's output, or the solve's
                       // scratch table when it is not in shared memory
  const int* wg;       // 0-d capacity of the solve, or null: wg_default
  int wg_default;
  int64_t* picks;      // (I,) solve only
  float* total;        // 0-d solve only
  int I, J, wp1;
  int table_smem;      // solve: the choice table is in shared memory
};

__host__ __device__ inline int base_smem(int I, int J, int wp1) {
  return 4 * (I * J + J) + (wp1 > kWarpMax ? 8 * wp1 : 0);
}

__host__ __device__ inline bool table_fits(int I, int J, int wp1) {
  return J <= 255 &&
         static_cast<int64_t>(base_smem(I, J, wp1)) +
                 static_cast<int64_t>(I) * wp1 <= kMaxSmem;
}

// (value, w) of the larger value, the lower w on ties
__device__ __forceinline__ void better(float& bv, int& bw, float ov, int ow) {
  if (ov > bv || (ov == bv && ow < bw)) {
    bv = ov;
    bw = ow;
  }
}

__device__ __forceinline__ void warp_best(float& bv, int& bw) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    better(bv, bw, __shfl_xor_sync(0xffffffffu, bv, o),
           __shfl_xor_sync(0xffffffffu, bw, o));
}

// The reverse walk from w, one thread: picks[i] = choice[i, w], then
// w = max(w - c, 0); the cost of j < JG comes from registers.
template <int JG>
__device__ void walk(const Args& a, const uint8_t* tsm, const int* sc,
                     const int (&creg)[JG], int w) {
  for (int i = a.I - 1; i >= 0; --i) {
    const size_t k = static_cast<size_t>(i) * a.wp1 + w;
    const int j = a.table_smem ? tsm[k] : a.choices[k];
    a.picks[i] = j;
    int c = j < JG ? 0 : sc[j];
#pragma unroll
    for (int jj = 0; jj < JG; ++jj) c = j == jj ? creg[jj] : c;
    w = max(w - c, 0);
  }
}

// The one-warp sweep: V_i from V_{i-1} for every camera, the value row in
// registers (lane l holds w = l + 32 r).  Options go in groups of JG,
// unrolled, so that a group's shuffles issue back to back; the first
// group's costs stay in registers (JG = 6 for the fleet's six bitrates
// wastes no slot).  Without kRot every cost is < 32: V[w - c] is in lane
// l - c of register r, or of r - 1 for l < c, and only r = 0 can fall
// below w = 0.  kRot: some cost is >= 32, the shuffled registers are
// rotated by c / 32 and every candidate checks w >= c.
template <int R, int JG, bool kRot, bool kSolve>
__device__ __forceinline__ void warp_sweep(const Args& a, float (&v)[R],
                                           const float* su, const int* sc,
                                           const int (&creg)[JG],
                                           uint8_t* tsm, int lane) {
  const int I = a.I, J = a.J, wp1 = a.wp1;
  for (int i = 0; i < I; ++i) {
    float best[R];
    int arg[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      best[r] = kNeg;
      arg[r] = 0;
    }
    for (int j0 = 0; j0 < J; j0 += JG) {
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) {
        const int j = j0 + jj;
        const bool open = j < J;
        const int c = j0 == 0 ? creg[jj] : (open ? sc[j] : 0);
        const float u = su[i * J + (open ? j : 0)];
        const int s = c & 31;
        float t[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          t[r] = __shfl_sync(0xffffffffu, v[r], (lane - s) & 31);
        if (kRot) {
          // t[r] <- t[r - q]: rows of V 32 q apart (uniform branches;
          // where q >= R every w < c, and no candidate is valid)
          const int q = c >> 5;
#pragma unroll
          for (int b = 1; b < R; b <<= 1) {
            if (q & b) {
#pragma unroll
              for (int r = R - 1; r >= b; --r) t[r] = t[r - b];
            }
          }
        }
        const bool from_prev = lane < s;   // w - c lies in register r - 1
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool valid =
              open && (kRot ? 32 * r + lane >= c : r > 0 || !from_prev);
          const float src = from_prev ? (r > 0 ? t[r - 1] : kNeg) : t[r];
          const float cand = valid ? __fadd_rn(src, u) : kNeg;
          if (cand > best[r]) {
            best[r] = cand;
            arg[r] = j;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = best[r];
      const int w = 32 * r + lane;
      if (w < wp1) {
        const size_t k = static_cast<size_t>(i) * wp1 + w;
        if (kSolve && a.table_smem)
          tsm[k] = static_cast<uint8_t>(arg[r]);
        else
          a.choices[k] = arg[r];
      }
    }
  }
}

// float -> int with the same order (finite values; -0 as +0)
__device__ __forceinline__ int order_key(float x) {
  const int k = __float_as_int(__fadd_rn(x, 0.0f));
  return k >= 0 ? k : k ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

template <int R, int JG, bool kSolve>
__global__ void __launch_bounds__(32) knapsack_dp_warp(const Args a) {
  extern __shared__ float4 smem4[];
  float* su = reinterpret_cast<float*>(smem4);          // (I, J)
  int* sc = reinterpret_cast<int*>(su + a.I * a.J);     // (J,)
  uint8_t* tsm = reinterpret_cast<uint8_t*>(sc + a.J);  // (I, wp1) bytes
  const int lane = threadIdx.x, I = a.I, J = a.J, wp1 = a.wp1;
  for (int k = lane; k < I * J; k += 32) su[k] = a.util[k];
  bool big = false;
  for (int k = lane; k < J; k += 32) {
    sc[k] = a.costs[k];
    big |= sc[k] >= 32;
  }
  const int wg = kSolve ? (a.wg ? *a.wg : a.wg_default) : 0;
  __syncwarp();
  int creg[JG];
#pragma unroll
  for (int jj = 0; jj < JG; ++jj) creg[jj] = jj < J ? sc[jj] : 0;

  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = 0.0f;
  if (__any_sync(0xffffffffu, big))
    warp_sweep<R, JG, true, kSolve>(a, v, su, sc, creg, tsm, lane);
  else
    warp_sweep<R, JG, false, kSolve>(a, v, su, sc, creg, tsm, lane);

  if (!kSolve) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (32 * r + lane < wp1) a.vals[32 * r + lane] = v[r];
    return;
  }
  // best w <= wg (values past wg masked to NEG, as backtrack_device does):
  // the largest value by a warp max of order keys, then its lowest w
  int key = -0x7fffffff - 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int w = 32 * r + lane;
    if (w < wp1) key = max(key, order_key(w <= wg ? v[r] : kNeg));
  }
  key = __reduce_max_sync(0xffffffffu, key);
  unsigned first = 0xffffffffu;
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int w = 32 * r + lane;
    if (w < wp1 && order_key(w <= wg ? v[r] : kNeg) == key) first = w;
  }
  first = __reduce_min_sync(0xffffffffu, first);
  __syncwarp();
  if (lane == 0) {
    *a.total = key_value(key);
    walk<JG>(a, tsm, sc, creg, static_cast<int>(first));
  }
}

// The block sweep: thread t holds w = t + k * blockDim.x; the rows of V
// ping-pong in shared memory with one barrier per camera.  The first JG
// costs stay in registers and a camera's options are unrolled, so that
// the loads of V[w - c] for all of them issue back to back.
template <int JG, bool kSolve>
__global__ void __launch_bounds__(kBlock) knapsack_dp_block(const Args a) {
  extern __shared__ float4 smem4[];
  const int I = a.I, J = a.J, wp1 = a.wp1;
  float* prev = reinterpret_cast<float*>(smem4);       // V_{i-1}
  float* cur = prev + wp1;                             // V_i
  float* su = cur + wp1;                               // (I, J)
  int* sc = reinterpret_cast<int*>(su + I * J);        // (J,)
  uint8_t* tsm = reinterpret_cast<uint8_t*>(sc + J);   // (I, wp1) bytes
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int w = tid; w < wp1; w += nt) prev[w] = 0.0f;
  for (int k = tid; k < I * J; k += nt) su[k] = a.util[k];
  for (int k = tid; k < J; k += nt) sc[k] = a.costs[k];
  const int wg = kSolve ? (a.wg ? *a.wg : a.wg_default) : 0;
  __syncthreads();
  int creg[JG];
#pragma unroll
  for (int jj = 0; jj < JG; ++jj) creg[jj] = jj < J ? sc[jj] : 0;
  for (int i = 0; i < I; ++i) {
    const float* ui = su + i * J;
    for (int w = tid; w < wp1; w += nt) {
      float best = kNeg;
      int arg = 0;
      for (int j0 = 0; j0 < J; j0 += JG) {
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) {
          const int j = j0 + jj;
          const bool open = j < J;
          const int c = j0 == 0 ? creg[jj] : (open ? sc[j] : 0);
          const float cand = open && w >= c
                                 ? __fadd_rn(prev[w - c], ui[j])
                                 : kNeg;
          if (cand > best) {
            best = cand;
            arg = j;
          }
        }
      }
      cur[w] = best;
      const size_t k = static_cast<size_t>(i) * wp1 + w;
      if (kSolve && a.table_smem)
        tsm[k] = static_cast<uint8_t>(arg);
      else
        a.choices[k] = arg;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }
  if (!kSolve) {
    for (int w = tid; w < wp1; w += nt) a.vals[w] = prev[w];
    return;
  }
  float bv = -INFINITY;
  int bw = 0x7fffffff;
  for (int w = tid; w < wp1; w += nt)
    better(bv, bw, w <= wg ? prev[w] : kNeg, w);
  warp_best(bv, bw);
  // the per-warp bests go through the spare row (cur)
  int* cw = reinterpret_cast<int*>(cur + 32);
  if ((tid & 31) == 0) {
    cur[tid >> 5] = bv;
    cw[tid >> 5] = bw;
  }
  __syncthreads();
  if (tid < 32) {
    bv = tid < (nt >> 5) ? cur[tid] : -INFINITY;
    bw = tid < (nt >> 5) ? cw[tid] : 0x7fffffff;
    warp_best(bv, bw);
    if (tid == 0) {
      *a.total = bv;
      walk<JG>(a, tsm, sc, creg, bw);
    }
  }
}

// Sets each instance's shared-memory limit once, then launches it.
template <int R, int JG, bool kSolve>
int launch_warp(const Args& a, int smem, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      knapsack_dp_warp<R, JG, kSolve>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  knapsack_dp_warp<R, JG, kSolve><<<1, 32, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Registers per lane: 4 at W+1 <= 128, else 8; six options (the fleet's
// bitrates) in one group of six, else groups of kJReg.
template <bool kSolve>
int launch_rows(const Args& a, int smem, cudaStream_t st) {
  if (a.J == 6)
    return a.wp1 <= 128 ? launch_warp<4, 6, kSolve>(a, smem, st)
                        : launch_warp<8, 6, kSolve>(a, smem, st);
  return a.wp1 <= 128 ? launch_warp<4, kJReg, kSolve>(a, smem, st)
                      : launch_warp<8, kJReg, kSolve>(a, smem, st);
}

template <int JG, bool kSolve>
int launch_block(const Args& a, int smem, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      knapsack_dp_block<JG, kSolve>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  knapsack_dp_block<JG, kSolve><<<1, kBlock, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSolve>
int launch(const Args& a, cudaStream_t st) {
  const int smem = base_smem(a.I, a.J, a.wp1) +
                   (kSolve && a.table_smem ? a.I * a.wp1 : 0);
  if (a.wp1 <= kWarpMax) return launch_rows<kSolve>(a, smem, st);
  return a.J == 6 ? launch_block<6, kSolve>(a, smem, st)
                  : launch_block<kJReg, kSolve>(a, smem, st);
}

}  // namespace

// Dynamic shared memory of one launch: the utilities and costs, the two
// value rows of the block sweep (W+1 > 256) and, for the solve, the
// one-byte choice table when it fits (kept in sync with ops.smem_bytes).
extern "C" int knapsack_dp_smem(int I, int J, int wp1, int solve) {
  return base_smem(I, J, wp1) +
         (solve && table_fits(I, J, wp1) ? I * wp1 : 0);
}

// util (I, J) float32 and costs (J,) int32 contiguous on the card; vals
// (wp1,) float32 and choices (I, wp1) int32 are written.  Returns the
// launch's cudaError_t (the attribute call's, if that fails first).
extern "C" int knapsack_dp_launch(const float* util, const int* costs,
                                  float* vals, int* choices, int I, int J,
                                  int wp1, void* stream) {
  Args a{};
  a.util = util;
  a.costs = costs;
  a.vals = vals;
  a.choices = choices;
  a.I = I;
  a.J = J;
  a.wp1 = wp1;
  return launch<false>(a, static_cast<cudaStream_t>(stream));
}

// The sweep at capacity wp1 - 1 and the backtrack bounded by *wg (a 0-d
// int32 on the card; wg_default when wg is null): picks (I,) int64 and
// total (0-d float32) are written.  `scratch` is an (I, wp1) int32 table
// the launch may use, needed only where knapsack_dp_smem says the table
// is not in shared memory (may be null otherwise).
extern "C" int knapsack_dp_solve_launch(const float* util, const int* costs,
                                        const int* wg, int wg_default,
                                        int64_t* picks, float* total,
                                        int* scratch, int I, int J, int wp1,
                                        void* stream) {
  Args a{};
  a.util = util;
  a.costs = costs;
  a.choices = scratch;
  a.wg = wg;
  a.wg_default = wg_default;
  a.picks = picks;
  a.total = total;
  a.I = I;
  a.J = J;
  a.wp1 = wp1;
  a.table_smem = table_fits(I, J, wp1);
  if (!a.table_smem && scratch == nullptr) return 1;  // cudaErrorInvalidValue
  return launch<true>(a, static_cast<cudaStream_t>(stream));
}
