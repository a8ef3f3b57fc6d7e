// The isotropic Gaussian-mixture likelihood shared by the GMM kernels
// (gmm_logprob.cu: forward, backward, value+grad; fused_smc_gmm.cu: the SMC
// mutation stage), fp32 SIMT on Hopper (sm_90a).  fused_nuts_hier.cu takes
// its SFU helpers and kChunk for its own log2-domain row loop.
//
// One particle holds K components: log-weights, means mu_k (D,) and scales
// s_k.  Over the points x_n (N, D) the likelihood and its parameter-space
// gradient are
//   ll = sum_n lse_k l_nk,   l_nk = c_k - h_k |x_n - mu_k|^2,
//   c_k = log w_k - D log s_k - (D/2) log 2pi,   h_k = 1 / (2 s_k^2),
//   d ll / d log w_k = sum_n r_nk,   d ll / d mu_k = sum_n r_nk dx_nk / s_k^2,
//   d ll / d s_k = (sum_n r_nk |dx_nk|^2 / s_k^2 - D sum_n r_nk) / s_k,
// with dx_nk = x_n - mu_k and the responsibilities r_nk = softmax_k l_nk.
// One warp evaluates W particles (one or two): its lanes stride over the
// points and keep each particle's running sums in registers (1 + 2K + K D,
// 13 at K = 3, D = 2, with value and gradient), then a butterfly of
// shuffles adds them across the lanes in a fixed order, so every lane ends
// with the same bits and a run repeats bit for bit.
//
// Replaces the arithmetic of bayesic_tpu/ops/gmm_logprob.py (_ll_terms,
// _streaming_lse) and of fused_smc_gmm.py:make_gmm_potential_flat.  The TPU
// forms are not ported: the squared distance is the difference squared, not
// |x|^2 - 2 mu.x + |mu|^2 as a bf16 hi/lo MXU product (it cancels when the
// component sits on the data); d ll / d mu_k sums r dx directly, not
// r x - mu r; and sum r |dx|^2 is summed directly, not recovered from
// sum r l (gmm_logprob.py:416-419), which cancels when ll is large.  Every
// product is an fp32 FFMA; D is 1-4, no matrix product.
//
// The point loop, points_log2, works in the log2 domain: log2 e is folded
// into each component's constants once per particle, so each component's
// exp is one ex2.approx of a non-positive argument (the largest is exactly
// 1), one rcp.approx gives the responsibilities, and the log of the sum is
// taken once per kChunk points, of their product (each sum lies in [1, K],
// so the product stays below 8^16 < 2^48), with the maxes summed apart.
// Two compile-time flags choose the sums it keeps: LL the value's (the
// product, the maxes' sum and the lg2), GRAD the gradient's (the rcp and
// the sums of r, r q and r dx).  A sum that is off is never touched, so it
// takes no register, no instruction and no part of the butterfly; the rest
// of the loop is one code in one order in every instance, so the sums it
// keeps have the same bits whichever flags are on.  At K = 3, D = 2 the
// loop takes 50 SASS instructions a (particle, point) with both flags on
// (the value+grad kernel and the SMC mutation), 34 with LL alone (the
// forward) and 48 with GRAD alone (the backward).  The PTX
// ISA's bounds (ex2 2 ulp, lg2 2^-22 absolute, rcp 1 ulp) are held against
// float64 by tests/test_torch_fused_smc_gmm.py and
// tests/test_torch_gmm_logprob.py, which emulate the loop in its order.
//
// What bounds it: per (particle, point) the SFU's K exps, the reciprocal
// (GRAD) and 1 / kChunk of a log (LL), 16 per SM per clock, and the issue
// of the ~6 K + 6 K D fp32 operations around them; the data (N D floats)
// sit in shared memory.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "warp_sum.cuh"

namespace {

constexpr float kHalfLog2Pi = 0.91893853320467274f;   // 0.5 ln 2pi
constexpr size_t kGmmMaxSmem = 232448;   // 227 KB, the per-block maximum
constexpr int GMM_MAXK = 8;              // most components
constexpr int GMM_MAXD = 4;              // most data dims
constexpr int kChunk = 16;            // points a lane multiplies before a log
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994531f;

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float lg2_approx(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// W particles' mixtures in the log2 domain: log2 of component k's weighted
// density at x is c_k - h_k |x - mu_k|^2.
template <int MK, int MD, int W>
struct Mix2 {
  float mu[W][MK][MD];
  float c[W][MK];   // log2 e (log w_k - D log s_k - D/2 log 2pi)
  float h[W][MK];   // log2 e / (2 s_k^2)
};

// W particles' per-lane sums over the points: with LL the value's, in log2
// units (the maxes plus the logs of the chunk products); with GRAD the
// gradient's.  The sums a flag turns off are never touched.
template <int MK, int MD, int W, bool LL, bool GRAD>
struct Acc2 {
  float ll[W];
  float r[W][MK], rq[W][MK], rdx[W][MK][MD];

  __device__ void zero() {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if constexpr (LL) ll[w] = 0.f;
      if constexpr (GRAD) {
#pragma unroll
        for (int k = 0; k < MK; ++k) {
          r[w][k] = rq[w][k] = 0.f;
#pragma unroll
          for (int j = 0; j < MD; ++j) rdx[w][k][j] = 0.f;
        }
      }
    }
  }

  // Add the sums across the warp: afterwards every lane holds the
  // particles' totals.
  __device__ void butterfly(int k, int d) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if constexpr (LL) ll[w] = warp_sum(ll[w]);
      if constexpr (GRAD) {
#pragma unroll
        for (int kk = 0; kk < MK; ++kk) {
          if (kk < k) {
            r[w][kk] = warp_sum(r[w][kk]);
            rq[w][kk] = warp_sum(rq[w][kk]);
#pragma unroll
            for (int j = 0; j < MD; ++j)
              if (j < d) rdx[w][kk][j] = warp_sum(rdx[w][kk][j]);
          }
        }
      }
    }
  }
};

// Add the points lane, lane + 32, ... < n of the row-major (n, d) array xs
// to the W particles' sums (k <= MK, d <= MD; EXACT: k = MK, d = MD), each
// lane's chunks of kChunk points closed by one lg2 of their sums' product
// (LL).
template <int MK, int MD, bool EXACT, int W, bool LL, bool GRAD>
__device__ __forceinline__ void points_log2(const Mix2<MK, MD, W>& m,
                                            const float* __restrict__ xs,
                                            int lane, int n, int k, int d,
                                            Acc2<MK, MD, W, LL, GRAD>& s) {
  for (int n0 = lane; n0 < n; n0 += 32 * kChunk) {
    const int n1 = min(n, n0 + 32 * kChunk);
    float prod[W];
#pragma unroll
    for (int w = 0; w < W; ++w) prod[w] = 1.f;
#pragma unroll 1
    for (int i = n0; i < n1; i += 32) {
      float xv[MD];
      if constexpr (EXACT && MD == 2) {
        const float2 v = reinterpret_cast<const float2*>(xs)[i];
        xv[0] = v.x;
        xv[1] = v.y;
      } else {
#pragma unroll
        for (int j = 0; j < MD; ++j) xv[j] = j < d ? xs[i * d + j] : 0.f;
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        float dx[MK][MD], qd[MK], e[MK];
        float mx = -INFINITY;
#pragma unroll
        for (int kk = 0; kk < MK; ++kk) {
          if (kk < k) {
            float qq = 0.f;
#pragma unroll
            for (int j = 0; j < MD; ++j) {
              dx[kk][j] = xv[j] - m.mu[w][kk][j];
              if (j < d) qq = fmaf(dx[kk][j], dx[kk][j], qq);
            }
            qd[kk] = qq;
            e[kk] = fmaf(-qq, m.h[w][kk], m.c[w][kk]);
            mx = fmaxf(mx, e[kk]);
          }
        }
        float se = 0.f;
#pragma unroll
        for (int kk = 0; kk < MK; ++kk) {
          if (kk < k) {
            e[kk] = ex2_approx(e[kk] - mx);
            se += e[kk];
          }
        }
        if constexpr (LL) {
          prod[w] *= se;
          s.ll[w] += mx;
        }
        if constexpr (GRAD) {
          const float inv = rcp_approx(se);
#pragma unroll
          for (int kk = 0; kk < MK; ++kk) {
            if (kk < k) {
              const float rr = e[kk] * inv;
              s.r[w][kk] += rr;
              s.rq[w][kk] = fmaf(rr, qd[kk], s.rq[w][kk]);
#pragma unroll
              for (int j = 0; j < MD; ++j)
                if (j < d)
                  s.rdx[w][kk][j] = fmaf(rr, dx[kk][j], s.rdx[w][kk][j]);
            }
          }
        }
      }
    }
    if constexpr (LL) {
#pragma unroll
      for (int w = 0; w < W; ++w) s.ll[w] += lg2_approx(prod[w]);
    }
  }
}

template <class Kernel>
cudaError_t gmm_prepare(Kernel kernel, size_t bytes) {
  if (bytes > kGmmMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
