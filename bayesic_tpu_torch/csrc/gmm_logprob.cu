// Batched Gaussian-mixture log-likelihood kernels, Hopper (sm_90a), fp32
// SIMT: the forward (ll per particle), the backward (cotangent times the
// parameter gradient) and the one-launch value+grad.
//
// Replaces bayesic_tpu/ops/gmm_logprob.py:_fwd_kernel (reached through
// gmm_loglik), :_bwd_kernel (gmm_loglik's VJP) and :_vg_kernel
// (gmm_loglik_grad).  Their oracles are ops/gmm_logprob.py's
// gmm_loglik_reference and gmm_loglik_grad_reference.
//
// Inputs: x (N, D) row-major; per particle log w (K,), mu (K, D), s (K,).
// A block of 8 warps evaluates 8 particles, one warp each (gmm_lik.cuh):
// the lanes stride over the points, and the points come through shared
// memory in tiles of 8192 floats (all of N = 2000, D = 2 in one tile), so
// one block reads x from L2 once for 8 particles.  The TPU kernels' (D, N)
// transposed data, 512-lane blocks with masks, particle padding with s = 1
// and lifted-feature matmul are not ported: a warp runs to the end of its
// own points and a missing particle's warp only helps load the tiles.
//
// What bounds it: the SFU.  Per (particle, point) the forward takes K exps
// and a log, the backward K exps and a reciprocal, value+grad K exps, a log
// and a reciprocal, at 16 per SM per clock; the data are 16 KB.  At P =
// 8192, N = 2000, K = 3 that is 66-82 M SFU operations per call, ~16-20 us
// on 132 SMs at 1.98 GHz.
//
// K = 3, D = 2 (the GMM bench) runs an instantiation with both fixed at
// compile time; other K <= 8, D <= 4 run a general one.

#include <cuda_runtime.h>

#include <cstddef>

#include "gmm_lik.cuh"

namespace {

constexpr int GL_NT = 256;                // threads per block
constexpr int GL_WARPS = GL_NT / 32;      // particles per block
constexpr int TILE_FLOATS = 8192;         // shared floats of one x tile

enum Mode { FWD = 0, BWD = 1, VG = 2 };

template <int MK, int MD, bool EXACT, int MODE>
__global__ void __launch_bounds__(GL_NT)
    gmm_lik_kernel(const float* __restrict__ x, const float* __restrict__ logw,
                   const float* __restrict__ mus,
                   const float* __restrict__ sig,
                   const float* __restrict__ ct, float* __restrict__ ll_out,
                   float* __restrict__ dlogw, float* __restrict__ dmus,
                   float* __restrict__ dsig, int p, int n, int k_rt,
                   int d_rt) {
  constexpr bool LL = MODE != BWD, GRAD = MODE != FWD;
  const int k = EXACT ? MK : k_rt, d = EXACT ? MD : d_rt;
  __shared__ float xs[TILE_FLOATS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pi = blockIdx.x * GL_WARPS + warp;
  const bool live = pi < p;

  Mix<MK, MD> m;
  float sk[MK];
#pragma unroll
  for (int kk = 0; kk < MK; ++kk) {
    const bool on = live && kk < k;
    const float s = on ? sig[(size_t)pi * k + kk] : 1.f;
    const float lw = on ? logw[(size_t)pi * k + kk] : 0.f;
    sk[kk] = s;
    m.c[kk] = lw - (float)d * logf(s) - (float)d * kHalfLog2Pi;
    m.h[kk] = 0.5f / (s * s);
#pragma unroll
    for (int j = 0; j < MD; ++j)
      m.mu[kk][j] = on && j < d ? mus[((size_t)pi * k + kk) * d + j] : 0.f;
  }
  Sums<MK, MD> s;
  s.zero();
  const int tile = TILE_FLOATS / d;       // points per tile
  for (int t0 = 0; t0 < n; t0 += tile) {
    const int cnt = min(tile, n - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt * d; i += GL_NT)
      xs[i] = x[(size_t)t0 * d + i];
    __syncthreads();
    if (live) accumulate<MK, MD, LL, GRAD>(m, xs, lane, cnt, k, d, s);
  }
  if (!live) return;                       // whole warps only
  reduce<MK, MD, LL, GRAD>(s, k, d);
  if (lane != 0) return;
  if (LL) ll_out[pi] = s.ll;
  if (GRAD) {
    const float w = MODE == BWD ? ct[pi] : 1.f;
#pragma unroll
    for (int kk = 0; kk < MK; ++kk) {
      if (kk < k) {
        const float inv_s2 = 2.f * m.h[kk];
        const size_t o = (size_t)pi * k + kk;
        dlogw[o] = w * s.r[kk];
#pragma unroll
        for (int j = 0; j < MD; ++j)
          if (j < d) dmus[o * d + j] = w * (s.rdx[kk][j] * inv_s2);
        dsig[o] = w * ((s.rq[kk] * inv_s2 - (float)d * s.r[kk]) / sk[kk]);
      }
    }
  }
}

template <int MODE>
int launch(const float* x, const float* logw, const float* mus,
           const float* sig, const float* ct, float* ll, float* dlogw,
           float* dmus, float* dsig, int p, int n, int k, int d,
           void* stream_ptr) {
  if (p <= 0 || n <= 0 || k < 1 || k > GMM_MAXK || d < 1 || d > GMM_MAXD)
    return cudaErrorInvalidValue;
  const dim3 grid((p + GL_WARPS - 1) / GL_WARPS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (k == 3 && d == 2)
    gmm_lik_kernel<3, 2, true, MODE><<<grid, GL_NT, 0, st>>>(
        x, logw, mus, sig, ct, ll, dlogw, dmus, dsig, p, n, k, d);
  else
    gmm_lik_kernel<GMM_MAXK, GMM_MAXD, false, MODE><<<grid, GL_NT, 0, st>>>(
        x, logw, mus, sig, ct, ll, dlogw, dmus, dsig, p, n, k, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ll (p,) at x (n, d), logw (p, k), mus (p, k, d), sig (p, k).  Each entry
// returns a cudaError_t (0 on success); launches only, never synchronises.
int gmm_loglik_fwd(const float* x, const float* logw, const float* mus,
                   const float* sig, float* ll, int p, int n, int k, int d,
                   void* stream) {
  return launch<FWD>(x, logw, mus, sig, nullptr, ll, nullptr, nullptr,
                     nullptr, p, n, k, d, stream);
}

// ct (p,) times d ll / d (logw, mus, sig).
int gmm_loglik_bwd(const float* x, const float* logw, const float* mus,
                   const float* sig, const float* ct, float* dlogw,
                   float* dmus, float* dsig, int p, int n, int k, int d,
                   void* stream) {
  return launch<BWD>(x, logw, mus, sig, ct, nullptr, dlogw, dmus, dsig, p,
                     n, k, d, stream);
}

// ll and d ll / d (logw, mus, sig) in one launch.
int gmm_loglik_vg(const float* x, const float* logw, const float* mus,
                  const float* sig, float* ll, float* dlogw, float* dmus,
                  float* dsig, int p, int n, int k, int d, void* stream) {
  return launch<VG>(x, logw, mus, sig, nullptr, ll, dlogw, dmus, dsig, p, n,
                    k, d, stream);
}

}  // extern "C"
