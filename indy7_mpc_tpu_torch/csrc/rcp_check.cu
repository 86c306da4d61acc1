// A checker of rbd.cuh's rcp_rn() against the compiler's `1.f / x`, not a
// kernel of the solve: no launch of K1 or K2 reaches it.
//
// rcp_rn() overlaps MUFU.RCP with the exponent test that rcp.rn.f32 runs
// first, and claims the same bits as `1.f / x` for every float.  This entry
// writes both for a chunk of consecutive bit patterns, so that a test can
// hold them equal over all 2^32 inputs (tests/test_torch_gpu.py).
#include <cuda_runtime.h>

#include "rbd.cuh"

namespace indy7 {

// x = the bit pattern first + i, for i < n: fast[i] = rcp_rn(x), ref[i] =
// 1.f / x.
__global__ void rcp_check_kernel(unsigned int first, unsigned int n, float* __restrict__ fast,
                                 float* __restrict__ ref) {
  const unsigned int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = __uint_as_float(first + i);
  fast[i] = rcp_rn(x);
  ref[i] = 1.f / x;
}

}  // namespace indy7

// Writes rcp_rn(x) to fast and 1.f / x to ref for the n = 2^log2n bit
// patterns from chunk * n on (log2n in 10..30, chunk < 2^(32 - log2n)), on
// `stream`.  Returns a CUDA error code.
extern "C" int indy7_rcp_check(int chunk, int log2n, float* fast, float* ref, void* stream) {
  if (log2n < 10 || log2n > 30 || chunk < 0 || chunk >= (1 << (32 - log2n)))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int n = 1u << log2n;
  const unsigned int first = static_cast<unsigned int>(chunk) << log2n;
  indy7::rcp_check_kernel<<<n / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(first, n, fast,
                                                                                  ref);
  return static_cast<int>(cudaGetLastError());
}
