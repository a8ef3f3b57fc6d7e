// The random draws of one NUTS transition, for the fused NUTS kernels of
// the port (fused_nuts.cu, and fused_nuts_hier.cu through nuts_tree.cuh).
//
// A transition reads its randomness either from arrays drawn by the caller
// (the injected entries, fed by infer/mcmc/streams.nuts_streams or by a
// test) or from Philox keyed as nuts_streams keys it (the keyed entries):
//
//   word  = philox4x32_10(counter = (t, chain, lane, phase << 8 | kind),
//                         key = (seed_lo, seed_hi)),
//   kind  = 0 momentum (lane d < D), 1 direction, 2 merge (lane = doubling),
//           3 leaf (lane = leaf index of the tree, < 2^K),
//
// with `chain` the logical chain index.  Lanes count from 0 within each
// kind, so a draw does not depend on D or K, and the kernel draws a leaf's
// uniform only when it reaches that leaf.  The float recipes are those of
// streams.py, in the same float32 operations and order (logf, sqrtf, cosf,
// 2pi rounded to float32 times the uniform; built without fast-math), so
// on the card the keyed draws equal nuts_streams' bit for bit:
//   momentum  sqrt(-2 log(open_uniform(w0))) * cos(2pi uniform24(w1)),
//   direction +1 if the top bit of w0 is set, else -1,
//   merge and leaf uniforms  log(open_uniform(w0)), strictly negative.
#pragma once

#include <cstdint>

#include "kernel_common.cuh"

namespace {

constexpr uint32_t kMomentum = 0, kDirection = 1, kMerge = 2, kLeaf = 3;

// U(0, 1) from the top 23 bits of a word, never 0 and never 1.
__device__ __forceinline__ float open_uniform(uint32_t bits) {
  return (static_cast<float>(bits >> 9) + 0.5f) * (1.0f / 8388608.0f);
}

struct NutsDraws {
  // injected: (n, D), (n, K), (n, K), (n, 2^K) rows; keyed when mom is null
  const float *mom, *sign_dir, *log_u_acc, *log_u_leaf;
  uint32_t seed_lo, seed_hi, t, phase;
  int k;

  __device__ __forceinline__ bool keyed() const { return mom == nullptr; }

  __device__ __forceinline__ bt::U4 words(int chain, uint32_t lane,
                                          uint32_t kind) const {
    return bt::philox4x32_10(
        bt::U4{t, static_cast<uint32_t>(chain), lane,
               (phase << 8) | kind},
        seed_lo, seed_hi);
  }

  // momentum normal of element d of chain (before the mass scaling)
  __device__ __forceinline__ float momentum(int chain, int d, int dim) const {
    if (!keyed()) return mom[(size_t)chain * dim + d];
    const bt::U4 w = words(chain, static_cast<uint32_t>(d), kMomentum);
    return sqrtf(-2.0f * logf(open_uniform(w.x))) *
           cosf(6.2831853071795862f * bt::uniform24(w.y));
  }

  __device__ __forceinline__ bool go_right(int chain, int dstep) const {
    if (!keyed()) return sign_dir[(size_t)chain * k + dstep] > 0.f;
    return (words(chain, static_cast<uint32_t>(dstep), kDirection).x >> 31)
           == 1u;
  }

  __device__ __forceinline__ float merge_log_u(int chain, int dstep) const {
    if (!keyed()) return log_u_acc[(size_t)chain * k + dstep];
    return logf(open_uniform(
        words(chain, static_cast<uint32_t>(dstep), kMerge).x));
  }

  __device__ __forceinline__ float leaf_log_u(int chain, int leaf) const {
    if (!keyed()) return log_u_leaf[((size_t)chain << k) + leaf];
    return logf(open_uniform(
        words(chain, static_cast<uint32_t>(leaf), kLeaf).x));
  }
};

NutsDraws injected_draws(const float* mom, const float* sign_dir,
                         const float* log_u_acc, const float* log_u_leaf,
                         int k) {
  return NutsDraws{mom, sign_dir, log_u_acc, log_u_leaf, 0, 0, 0, 0, k};
}

NutsDraws keyed_draws(unsigned long long seed, unsigned phase, unsigned t,
                      int k) {
  return NutsDraws{nullptr, nullptr, nullptr, nullptr,
                   static_cast<uint32_t>(seed),
                   static_cast<uint32_t>(seed >> 32), t, phase, k};
}

// Writes the keyed draws of chains 0..n-1 to mom (n, D), sign (n, K),
// log_u_acc (n, K) and log_u_leaf (n, 2^K): the check entry's kernel.
__global__ void nuts_draws_kernel(NutsDraws dr, int n, int dim, float* mom,
                                  float* sign, float* lua, float* lul) {
  const int k = dr.k, per = dim + 2 * k + (1 << k);
  const size_t total = (size_t)n * per;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int chain = (int)(e / per), j = (int)(e % per);
    if (j < dim) {
      mom[(size_t)chain * dim + j] = dr.momentum(chain, j, dim);
    } else if (j < dim + k) {
      sign[(size_t)chain * k + j - dim] =
          dr.go_right(chain, j - dim) ? 1.f : -1.f;
    } else if (j < dim + 2 * k) {
      lua[(size_t)chain * k + j - dim - k] = dr.merge_log_u(chain,
                                                            j - dim - k);
    } else {
      lul[((size_t)chain << k) + j - dim - 2 * k] =
          dr.leaf_log_u(chain, j - dim - 2 * k);
    }
  }
}

}  // namespace
