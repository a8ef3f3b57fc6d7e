// Whole-run fused linear-regression SVI trainer for Hopper (sm_90a), fp32
// SIMT.
//
// Replaces bayesic_tpu/ops/fused_linreg.py:_train_kernel (reached through
// fused_train).  One launch runs every step of the call: the full-batch
// mean-field STL ELBO on the Gram matrix G = P^T P of the columns
// P = [x, 1, y] (ops/fused_linreg.py:_step_math), then Adam at the
// cosine-decayed rate, for `steps` steps.  Noise comes from Philox keyed by
// (seed, step) with the fused hier trainer's counter layout (lane 1 + p for
// parameter p; ops/_kernel_common.hier_streams rebuilds it) or is injected
// for the parity checks.
//
// Design: one persistent block of NT = 128 threads, as the TPU kernel runs
// one program (grid=(1,)).  G ((D+2)^2 floats, 17 KB at D = 64) stays in
// shared memory for the whole run; thread p < P = D + 1 owns parameter p,
// its loc, log-scale and both Adam moment pairs in registers.  A step is
//   1. owners draw eps[p] and write u[p] = z[p] to shared memory (u[P] = -1,
//      the y column);
//   2. thread r <= P forms (G u)[r] as one row dot, FFMA in column order (G
//      is exactly symmetric, so the column read G[c][r] is the row and
//      neighbouring threads read neighbouring words);
//   3. on the steps whose loss is written (the last of each thinning group)
//      a fixed-order block sum (warp butterfly, then the four warps in
//      order) gives u^T G u and the prior and log q terms;
//   4. owners form the STL gradient and run Adam.
// No atomics: a run repeats bit for bit.  u^T G u is a difference of large
// terms (y^T y ~ 1e6 against a residual ~ 4e3 at N = 16,384), so every
// product is an fp32 FFMA, never TF32; the tests hold it against a float64
// plain step.
//
// What bounds it: not operations or bytes.  A step is ~(D+2)^2 FMAs plus
// ~60 operations per parameter (Philox, Box-Muller, Adam), well under a
// microsecond of either; the step is a chain of two block barriers, one
// (D+2)-long dependent FFMA chain and the transcendental functions, so its
// time is the latency of that chain on one SM.  Several independent runs
// per launch (one block each) would use the other 131 SMs; one run cannot.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "kernel_common.cuh"

namespace {

constexpr int NT = 128;              // threads, one block
constexpr int NWARPS = NT / 32;
constexpr int MAXD2 = NT;            // D + 2 <= 128, the JAX cap
constexpr float kPi = 3.14159265358979323846f;

struct Args {
  const float* g;
  float *loc, *ls, *m1, *m2, *v1, *v2, *losses;
  const float* eps_in;    // null: Philox noise
  int d, steps, thin, lr_total;
  long long t0;
  float lr0, inv_s2, ll_const;   // ll_const = n (ln s + 0.5 ln 2pi)
  uint32_t k0, k1;
};

__global__ void __launch_bounds__(NT) linreg_train_kernel(Args A) {
  extern __shared__ float sm[];
  const int D2 = A.d + 2, P = A.d + 1;
  float* gs = sm;                    // D2 x D2
  float* us = gs + D2 * D2;          // D2
  __shared__ float red[NWARPS][2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool own = tid < P;
  for (int k = tid; k < D2 * D2; k += NT) gs[k] = A.g[k];
  float loc = 0.f, ls = 0.f, m1 = 0.f, m2 = 0.f, v1 = 0.f, v2 = 0.f;
  if (own) {
    loc = A.loc[tid]; ls = A.ls[tid];
    m1 = A.m1[tid]; m2 = A.m2[tid]; v1 = A.v1[tid]; v2 = A.v2[tid];
  }
  if (tid == P) us[P] = -1.f;

  for (int i = 0; i < A.steps; ++i) {
    const unsigned long long t = (unsigned long long)A.t0 + i;
    // -- 1. noise and z
    float eps = 0.f, z = 0.f;
    if (own) {
      if (A.eps_in) {
        eps = A.eps_in[(size_t)i * P + tid];
      } else {
        const bt::U4 w = bt::philox4x32_10(
            bt::U4{(uint32_t)t, 0u, (uint32_t)(1 + tid), (uint32_t)(t >> 32)},
            A.k0, A.k1);
        eps = bt::box_muller(w.x, w.y);
      }
      z = fmaf(expf(ls), eps, loc);
      us[tid] = z;
    }
    __syncthreads();

    // -- 2. (G u)[r], one row dot per thread
    float gu = 0.f;
    if (tid < D2) {
#pragma unroll 4
      for (int c = 0; c < D2; ++c) gu = fmaf(gs[c * D2 + tid], us[c], gu);
    }

    // -- 3. the loss, on the steps whose loss is kept
    const bool write = (i % A.thin == A.thin - 1) || i == A.steps - 1;
    if (write) {                       // uniform over the block
      float q = tid < D2 ? us[tid] * gu : 0.f;
      float pq = own ? (-0.5f * z * z) - (-ls - 0.5f * eps * eps) : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        q += __shfl_xor_sync(0xffffffffu, q, o);
        pq += __shfl_xor_sync(0xffffffffu, pq, o);
      }
      if (lane == 0) { red[warp][0] = q; red[warp][1] = pq; }
    }
    __syncthreads();                   // also guards us[] for the next step
    if (write && tid == 0) {
      float q = 0.f, pq = 0.f;
      for (int w = 0; w < NWARPS; ++w) { q += red[w][0]; pq += red[w][1]; }
      // -elbo = 0.5 q / s^2 + n (ln s + c) - sum(lp - logq)
      A.losses[i / A.thin] = 0.5f * A.inv_s2 * q + A.ll_const - pq;
    }

    // -- 4. STL gradient, Adam
    if (own) {
      const float g_z = fmaf(eps, expf(-ls), -A.inv_s2 * gu - z);
      const float g_ls = g_z * eps * expf(ls);
      const float frac = fminf((float)t / (float)A.lr_total, 1.f);
      const float lr = A.lr0 * 0.5f * (1.f + cosf(kPi * frac));
      const float tt = (float)(t + 1);
      const float bc1 = 1.f - expf(tt * bt::kLnB1);
      const float bc2 = 1.f - expf(tt * bt::kLnB2);
      bt::adam_elem(loc, m1, v1, g_z, bc1, bc2, lr);
      bt::adam_elem(ls, m2, v2, g_ls, bc1, bc2, lr);
    }
  }
  if (own) {
    A.loc[tid] = loc; A.ls[tid] = ls;
    A.m1[tid] = m1; A.m2[tid] = m2; A.v1[tid] = v1; A.v2[tid] = v2;
  }
}

}  // namespace

extern "C" {

// Runs `steps` steps on `stream`.  g: (D+2)^2 Gram matrix, row major and
// symmetric.  loc/ls/m1/m2/v1/v2: (D+1,) flat vectors, updated in place.
// eps: null for Philox noise keyed by `seed` with counter (t0+i, 0, 1+p,
// (t0+i) >> 32), else injected noise (steps*(D+1)).  losses[i / thin] =
// -elbo of the last step of each group of `thin`.  inv_s2 = 1/s^2, ll_const
// = n (ln s + 0.5 ln 2pi).  Returns a cudaError_t (0 on success); launches
// only, never synchronises.
int fused_linreg_train(const float* g, float* loc, float* ls, float* m1,
                       float* m2, float* v1, float* v2, float* losses,
                       const float* eps, int d, int steps, long long t0,
                       int thin, float lr0, int lr_total, float inv_s2,
                       float ll_const, unsigned long long seed,
                       void* stream_ptr) {
  if (d < 1 || d + 2 > MAXD2 || steps < 0 || thin < 1 || t0 < 0 ||
      lr_total < 1)
    return cudaErrorInvalidValue;
  if (steps == 0) return cudaSuccess;
  const int d2 = d + 2;
  const size_t bytes = sizeof(float) * (size_t)(d2 * d2 + d2);
  cudaError_t err = cudaFuncSetAttribute(
      linreg_train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  Args A{g, loc, ls, m1, m2, v1, v2, losses, eps, d, steps, thin, lr_total,
         t0, lr0, inv_s2, ll_const, (uint32_t)seed, (uint32_t)(seed >> 32)};
  linreg_train_kernel<<<1, NT, bytes,
                        static_cast<cudaStream_t>(stream_ptr)>>>(A);
  return cudaGetLastError();
}

}  // extern "C"
