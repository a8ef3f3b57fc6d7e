// The warp butterfly sum shared by the GMM likelihood (gmm_lik.cuh) and the
// NUTS tree (nuts_tree.cuh), and through them by their kernels.
#pragma once

#include <cuda_runtime.h>

namespace {

// v summed over the warp by xor shuffles 16 .. 1: every lane gets the same
// bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
