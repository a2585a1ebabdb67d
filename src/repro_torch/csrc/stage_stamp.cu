// Stage marks of the episode's CUDA graphs: one thread writes the card's
// %globaltimer (ns) into stamps[*counter, k].
//
// Replaces no TPU kernel.  Every kernel of a fleet slot runs inside one
// replay of a captured graph, so the card's records say nothing of which
// stage (synthesis, ROIDet, control, encode, the finish's detector and
// decode) a kernel belongs to.
// A CUDA event recorded inside a graph keeps only the last replay's time;
// this kernel, captured between two stages, keeps one time per replay:
// the row is the graph's slot counter, read on the card when the node
// runs, and the column k the mark's place in the slot.  Each k is its
// own instantiation, so the card's kernel records name the mark too.  A
// node of a stream's chain starts when the node before it has finished,
// so the difference of two marks of one stream is the device time of the
// work between them.  %globaltimer is not the host's clock: only
// differences mean anything.
//
// What bounds it: launch latency alone (one thread, one 8-byte read and
// one 8-byte write).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// one instantiation per mark, so that a profiler's kernel records name
// the mark (stage_stamp_kernel<k>) and split a stream's kernels by stage
template <int K>
__global__ void stage_stamp_kernel(int64_t* __restrict__ stamps,
                                   const int64_t* __restrict__ counter,
                                   int64_t rows, int cols) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const int64_t row = *counter;
  if (row >= 0 && row < rows) stamps[row * cols + K] = static_cast<int64_t>(t);
}

template <int K>
void launch(int64_t* stamps, const int64_t* counter, int64_t rows, int cols,
            cudaStream_t stream) {
  stage_stamp_kernel<K><<<1, 1, 0, stream>>>(stamps, counter, rows, cols);
}

}  // namespace

// stamps (rows, cols) int64 contiguous, counter a 0-d int64, both on the
// card; 0 <= k < min(cols, 9) (the episode's nine marks).  Returns the
// launch's cudaError_t, or 0 (cudaErrorInvalidValue for a k outside that
// range).
extern "C" int stage_stamp_launch(int64_t* stamps, const int64_t* counter,
                                  int64_t rows, int cols, int k,
                                  void* stream) {
  if (k < 0 || k >= cols || k >= 9)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 0: launch<0>(stamps, counter, rows, cols, s); break;
    case 1: launch<1>(stamps, counter, rows, cols, s); break;
    case 2: launch<2>(stamps, counter, rows, cols, s); break;
    case 3: launch<3>(stamps, counter, rows, cols, s); break;
    case 4: launch<4>(stamps, counter, rows, cols, s); break;
    case 5: launch<5>(stamps, counter, rows, cols, s); break;
    case 6: launch<6>(stamps, counter, rows, cols, s); break;
    case 7: launch<7>(stamps, counter, rows, cols, s); break;
    default: launch<8>(stamps, counter, rows, cols, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
