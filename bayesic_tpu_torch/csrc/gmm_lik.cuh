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
// One warp evaluates one particle: its lanes stride over the points and
// keep the 1 + 2K + K D running sums in registers (13 at K = 3, D = 2),
// then a butterfly of shuffles adds them across the lanes in a fixed order,
// so every lane ends with the same bits and a run repeats bit for bit.
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
// Two point loops.  accumulate (the forward and backward kernels) takes per
// (particle, point) K accurate exps, one log (value) and one reciprocal
// (gradient).  points_log2 (the value+grad kernel and the SMC mutation)
// works in the log2 domain: log2 e is folded into each component's
// constants once per particle, so each component's exp is one ex2.approx
// of a non-positive argument (the largest is exactly 1), one rcp.approx
// gives the responsibilities, and the log of the sum is taken once per
// kChunk points, of their product (each sum lies in [1, K], so the product
// stays below 8^16 < 2^48), with the maxes summed apart: ~50 SASS
// instructions a (particle, point) at K = 3, D = 2 against ~118.  The PTX
// ISA's bounds (ex2 2 ulp, lg2 2^-22 absolute, rcp 1 ulp) are held against
// float64 by tests/test_torch_fused_smc_gmm.py and
// tests/test_torch_gmm_logprob.py, which emulate the loop in its order.
//
// What bounds it: per (particle, point) the SFU's exps, logs and
// reciprocals (16 per SM per clock) and the issue of the ~6 K + 6 K D fp32
// operations around them; the data (N D floats) sits in shared memory.
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

// One particle's mixture, in registers of every lane of its warp.
template <int MK, int MD>
struct Mix {
  float mu[MK][MD];
  float c[MK];   // log w_k - D log s_k - D/2 log 2pi
  float h[MK];   // 1 / (2 s_k^2)
};

// The per-particle sums over the points.
template <int MK, int MD>
struct Sums {
  float ll;
  float r[MK], rq[MK], rdx[MK][MD];

  __device__ void zero() {
    ll = 0.f;
#pragma unroll
    for (int k = 0; k < MK; ++k) {
      r[k] = rq[k] = 0.f;
#pragma unroll
      for (int j = 0; j < MD; ++j) rdx[k][j] = 0.f;
    }
  }
};

// Add the points n0, n0 + 32, ... < n1 of the row-major (., d) array xs to
// the sums.  LL: the value's sums; GRAD: the gradient's.  k <= MK, d <= MD
// (compile-time constants in the exact instantiations).
template <int MK, int MD, bool LL, bool GRAD>
__device__ __forceinline__ void accumulate(const Mix<MK, MD>& m,
                                           const float* xs, int n0, int n1,
                                           int k, int d, Sums<MK, MD>& s) {
  for (int n = n0; n < n1; n += 32) {
    float xv[MD];
#pragma unroll
    for (int j = 0; j < MD; ++j) xv[j] = j < d ? xs[n * d + j] : 0.f;
    float l[MK], q[MK], dx[MK][MD], e[MK];
    float mx = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < MK; ++kk) {
      if (kk < k) {
        float qq = 0.f;
#pragma unroll
        for (int j = 0; j < MD; ++j) {
          dx[kk][j] = xv[j] - m.mu[kk][j];
          if (j < d) qq = fmaf(dx[kk][j], dx[kk][j], qq);
        }
        q[kk] = qq;
        l[kk] = fmaf(-qq, m.h[kk], m.c[kk]);
        mx = fmaxf(mx, l[kk]);
      }
    }
    float se = 0.f;
#pragma unroll
    for (int kk = 0; kk < MK; ++kk) {
      if (kk < k) {
        e[kk] = expf(l[kk] - mx);
        se += e[kk];
      }
    }
    if (LL) s.ll += mx + logf(se);
    if (GRAD) {
      const float inv = __frcp_rn(se);
#pragma unroll
      for (int kk = 0; kk < MK; ++kk) {
        if (kk < k) {
          const float rr = e[kk] * inv;
          s.r[kk] += rr;
          s.rq[kk] = fmaf(rr, q[kk], s.rq[kk]);
#pragma unroll
          for (int j = 0; j < MD; ++j)
            if (j < d) s.rdx[kk][j] = fmaf(rr, dx[kk][j], s.rdx[kk][j]);
        }
      }
    }
  }
}

// Butterfly the sums across the warp: afterwards every lane holds the
// particle's totals.
template <int MK, int MD, bool LL, bool GRAD>
__device__ __forceinline__ void reduce(Sums<MK, MD>& s, int k, int d) {
  if (LL) s.ll = warp_sum(s.ll);
  if (GRAD) {
#pragma unroll
    for (int kk = 0; kk < MK; ++kk) {
      if (kk < k) {
        s.r[kk] = warp_sum(s.r[kk]);
        s.rq[kk] = warp_sum(s.rq[kk]);
#pragma unroll
        for (int j = 0; j < MD; ++j)
          if (j < d) s.rdx[kk][j] = warp_sum(s.rdx[kk][j]);
      }
    }
  }
}

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

// W particles' per-lane sums over the points; ll in log2 units (the maxes
// plus the logs of the chunk products).
template <int MK, int MD, int W>
struct Acc2 {
  float ll[W];
  float r[W][MK], rq[W][MK], rdx[W][MK][MD];

  __device__ void zero() {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      ll[w] = 0.f;
#pragma unroll
      for (int k = 0; k < MK; ++k) {
        r[w][k] = rq[w][k] = 0.f;
#pragma unroll
        for (int j = 0; j < MD; ++j) rdx[w][k][j] = 0.f;
      }
    }
  }

  // Add the sums across the warp: afterwards every lane holds the
  // particles' totals.
  __device__ void butterfly(int k, int d) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      ll[w] = warp_sum(ll[w]);
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
};

// Add the points lane, lane + 32, ... < n of the row-major (n, d) array xs
// to the W particles' sums (k <= MK, d <= MD; EXACT: k = MK, d = MD), each
// lane's chunks of kChunk points closed by one lg2 of their sums' product.
template <int MK, int MD, bool EXACT, int W>
__device__ __forceinline__ void points_log2(const Mix2<MK, MD, W>& m,
                                            const float* __restrict__ xs,
                                            int lane, int n, int k, int d,
                                            Acc2<MK, MD, W>& s) {
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
        prod[w] *= se;
        s.ll[w] += mx;
        const float inv = rcp_approx(se);
#pragma unroll
        for (int kk = 0; kk < MK; ++kk) {
          if (kk < k) {
            const float rr = e[kk] * inv;
            s.r[w][kk] += rr;
            s.rq[w][kk] = fmaf(rr, qd[kk], s.rq[w][kk]);
#pragma unroll
            for (int j = 0; j < MD; ++j)
              if (j < d) s.rdx[w][kk][j] = fmaf(rr, dx[kk][j], s.rdx[w][kk][j]);
          }
        }
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) s.ll[w] += lg2_approx(prod[w]);
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
