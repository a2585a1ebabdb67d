// Multiple-choice knapsack DP sweep (paper section 5.2), one solve per
// launch.
//
// Replaces the TPU kernel src/repro/kernels/knapsack_dp/knapsack_dp.py:
// knapsack_dp_pallas (body _dp_kernel).  With V_0[w] = 0,
//
//   V_i[w] = max_j V_{i-1}[w - c_j] + u[i, j]     (w >= c_j, else NEG),
//
// ties to the lowest j; it writes the final value row V_I (W+1,) and the
// per-camera argmax table (I, W+1) the backtrack walks.
//
// What bounds it on the H100: latency, not bytes or operations.  One solve
// at the main path's shape (I=5, J=6, W+1=128) moves ~3.2 KB (~1 ns at
// 3.35 TB/s) and does ~11.5k operations, but camera i needs camera i-1's
// whole row, so the sweep is I dependent steps, each ending in a barrier.
// The time is the launch plus I short steps.
//
// Design: one block per solve; threads stride over w, so any W+1 works.
// The two value rows live in dynamic shared memory and ping-pong between
// cameras (no row ever touches device memory until the last one), with
// the util table and the costs beside them; a __syncthreads() separates
// cameras.  Per (i, w): best = NEG, arg = 0, and for j ascending the
// candidate __fadd_rn(V[w - c_j], u[i, j]) is taken only if it is strictly
// greater, which keeps the lowest j (jnp.argmax's rule and the TPU
// kernel's).  NEG + u rounds back to exactly NEG in float32 for every
// utility the system produces (dead-camera rows carry -1e9), as on the TPU,
// so no special case is needed.  Costs must be >= 0.  Build without
// --use_fast_math.
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;

__global__ void knapsack_dp_kernel(const float* __restrict__ util,
                                   const int* __restrict__ costs,
                                   float* __restrict__ vals,
                                   int* __restrict__ choices, int I, int J,
                                   int wp1) {
  extern __shared__ float smem[];
  float* prev = smem;                 // V_{i-1}
  float* cur = smem + wp1;            // V_i
  float* su = smem + 2 * wp1;         // (I, J) utilities
  int* sc = reinterpret_cast<int*>(su + I * J);  // (J,) costs
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int w = tid; w < wp1; w += nt) prev[w] = 0.0f;
  for (int k = tid; k < I * J; k += nt) su[k] = util[k];
  for (int k = tid; k < J; k += nt) sc[k] = costs[k];
  __syncthreads();
  for (int i = 0; i < I; ++i) {
    const float* ui = su + i * J;
    int* ch = choices + static_cast<size_t>(i) * wp1;
    for (int w = tid; w < wp1; w += nt) {
      float best = kNeg;
      int arg = 0;
      for (int j = 0; j < J; ++j) {
        const int c = sc[j];
        const float cand =
            (w >= c && w - c < wp1) ? __fadd_rn(prev[w - c], ui[j]) : kNeg;
        if (cand > best) {
          best = cand;
          arg = j;
        }
      }
      cur[w] = best;
      ch[w] = arg;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }
  for (int w = tid; w < wp1; w += nt) vals[w] = prev[w];
}

}  // namespace

// util (I, J) float32 and costs (J,) int32 contiguous on the card; vals
// (wp1,) float32 and choices (I, wp1) int32 are written.  Returns the
// launch's cudaError_t (the attribute call's, if that fails first).
extern "C" int knapsack_dp_launch(const float* util, const int* costs,
                                  float* vals, int* choices, int I, int J,
                                  int wp1, void* stream) {
  // two value rows, the util table and the costs (the wrapper checks the
  // total against the 227 KB a block may use)
  const size_t smem = 4 * (2 * static_cast<size_t>(wp1) +
                           static_cast<size_t>(I) * J + J);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knapsack_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int threads = ((wp1 + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  knapsack_dp_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      util, costs, vals, choices, I, J, wp1);
  return static_cast<int>(cudaGetLastError());
}
