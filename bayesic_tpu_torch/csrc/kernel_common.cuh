// Device helpers shared by the fused trainers: Philox4x32-10, the uniform
// and Box-Muller recipes, and the optax-equal Adam update of one element.
//
// Replaces bayesic_tpu/ops/_kernel_common.py (kernel_uniform, kernel_normal,
// adam_leaf), which drew from the TPU core PRNG.  Philox is counter based:
// every draw is a pure function of (key, counter), so a kernel needs no
// generator state and the plain twins in bayesic_tpu_torch/ops/
// _kernel_common.py rebuild the same bits on any device.
#pragma once

#include <cstdint>

namespace bt {

struct U4 {
  uint32_t x, y, z, w;
};

// Philox4x32-10 (Salmon et al., SC'11): ten rounds of two 32x32->64
// multiplies, key bumped by the Weyl constants between rounds.
__device__ __forceinline__ U4 philox4x32_10(U4 c, uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += W0;
    k1 += W1;
  }
  return c;
}

// U[0,1) from the top 24 bits of a word.
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

// One normal from two uniforms, u1 kept off zero (cosine branch only).
__device__ __forceinline__ float box_muller(uint32_t a, uint32_t b) {
  const float u1 = fmaxf(uniform24(a), 1e-7f);
  const float u2 = uniform24(b);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.2831853071795862f * u2);
}

// ln(0.9) and ln(0.999): bias corrections are 1 - exp(t ln b), as in the
// plain twin.
constexpr float kLnB1 = -0.10536051565782628f;
constexpr float kLnB2 = -0.0010005003335835335f;

// optax.adam(b1=.9, b2=.999, eps=1e-8) on loss = -elbo: g is d elbo.
__device__ __forceinline__ void adam_elem(float& p, float& m, float& v,
                                          float g, float bc1, float bc2,
                                          float lr) {
  g = -g;
  m = 0.9f * m + 0.1f * g;
  v = 0.999f * v + 0.001f * g * g;
  const float upd = (m / bc1) / (sqrtf(v / bc2) + 1e-8f);
  p = p - lr * upd;
}

}  // namespace bt
