// Connected-component labels of the block-motion grid, camera-batched.
//
// Replaces no TPU kernel: the JAX package computes this stage with a
// lax.while_loop in src/repro/core/cc.py:label_and_boxes (min-label
// propagation until the labels stop changing).  In eager PyTorch that
// loop needs a host read of the fixpoint flag every few sweeps, which
// forbids capturing the slot step in a CUDA graph; a fixed sweep count
// would put about M*N sweeps of five kernels each into the graph.  This
// kernel runs the whole loop on the card instead.
//
// Labels: a masked cell starts at its row-major index, a background cell
// at INF = 2^30.  Each pass gives every masked cell the minimum of its own
// label and its four neighbours' (out-of-grid neighbours count as INF),
// updated in place in shared memory; the block stops after the first pass
// in which no label changed (__syncthreads_or), and after M*N passes at
// most.  A cell's label only ever falls, and never below its component's
// least index, so reads of a neighbour that another thread is writing in
// the same pass see either value and both are valid.  The fixpoint is
// each component's least cell index whatever the order of the updates, so
// the labels are bitwise those of the JAX package's loop.  A fixpoint is
// reached within the component's diameter of passes (at most M*N - 1), so
// the pass that finds no change comes by pass M*N.
//
// What bounds it on the H100: neither bytes nor operations.  It reads the
// (C, M, N) mask once and writes the labels once (5 bytes a cell: 1.2 KB
// per camera at 12 x 20); the time is a chain of passes, each a few
// shared-memory loads per cell and one block-wide barrier, as many passes
// as the widest component's diameter plus one.
//
// Design: one block per camera holds the camera's whole (M, N) int32
// label grid in dynamic shared memory (the wrapper checks 4*M*N bytes
// against the card's opt-in limit, 227 KB on the H100: M*N <= 58,112,
// 68 x 120 at 1080p and 16-pixel blocks takes 32.6 KB); up to 1024
// threads stride over the cells.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kMaxThreads = 1024;

__global__ void cc_label_kernel(const uint8_t* __restrict__ mask,
                                int* __restrict__ labels, int M, int N) {
  extern __shared__ int smem[];
  volatile int* lab = smem;
  const int MN = M * N;
  const uint8_t* m = mask + static_cast<size_t>(blockIdx.x) * MN;
  for (int i = threadIdx.x; i < MN; i += blockDim.x) lab[i] = m[i] ? i : kInf;
  __syncthreads();
  for (int pass = 0; pass < MN; ++pass) {
    int changed = 0;
    for (int i = threadIdx.x; i < MN; i += blockDim.x) {
      const int cur = lab[i];
      if (cur == kInf) continue;  // background stays INF
      const int r = i / N;
      const int c = i - r * N;
      int best = cur;
      if (r > 0) best = min(best, lab[i - N]);
      if (r + 1 < M) best = min(best, lab[i + N]);
      if (c > 0) best = min(best, lab[i - 1]);
      if (c + 1 < N) best = min(best, lab[i + 1]);
      if (best < cur) {
        lab[i] = best;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  int* out = labels + static_cast<size_t>(blockIdx.x) * MN;
  for (int i = threadIdx.x; i < MN; i += blockDim.x) out[i] = lab[i];
}

}  // namespace

// The dynamic shared memory a block of this card may opt in to, in bytes
// (0 if the query fails).
extern "C" int cc_label_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

// mask (C, M, N) bool (one byte a cell) and labels (C, M, N) int32, both
// contiguous; 4*M*N bytes within cc_label_smem_limit().  Returns the first
// failing cudaError_t, or 0.
extern "C" int cc_label_launch(const uint8_t* mask, int* labels, int C, int M,
                               int N, void* stream) {
  const int MN = M * N;
  const size_t smem = static_cast<size_t>(MN) * sizeof(int);
  if (smem > 48 * 1024) {
    // raised once per process, to the largest grid launched so far
    static size_t granted = 48 * 1024;
    if (smem > granted) {
      const cudaError_t e = cudaFuncSetAttribute(
          cc_label_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      granted = smem;
    }
  }
  const int threads = MN < kMaxThreads ? (MN + 31) / 32 * 32 : kMaxThreads;
  cc_label_kernel<<<C, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      mask, labels, M, N);
  return static_cast<int>(cudaGetLastError());
}
