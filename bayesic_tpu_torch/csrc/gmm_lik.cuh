// The isotropic Gaussian-mixture likelihood shared by the GMM kernels
// (gmm_logprob.cu: forward, backward, value+grad; fused_smc_gmm.cu: the SMC
// mutation stage), fp32 SIMT on Hopper (sm_90a).
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
// What bounds it: per (particle, point) K exps, one log (value) and one
// reciprocal (gradient) on the SFU, 16 per SM per clock, and ~6 K + 6 K D
// fp32 operations besides; the data (N D floats) sits in shared memory.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr float kHalfLog2Pi = 0.91893853320467274f;   // 0.5 ln 2pi
constexpr size_t kGmmMaxSmem = 232448;   // 227 KB, the per-block maximum
constexpr int GMM_MAXK = 8;              // most components
constexpr int GMM_MAXD = 4;              // most data dims

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

template <class Kernel>
cudaError_t gmm_prepare(Kernel kernel, size_t bytes) {
  if (bytes > kGmmMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
