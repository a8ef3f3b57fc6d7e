// Fused multinomial-NUTS transition for the hierarchical-logistic posterior,
// Hopper (sm_90a), fp32 SIMT.
//
// Replaces bayesic_tpu/ops/fused_nuts_hier.py:_kernel (reached through
// fused_hier_nuts_transition and make_batched_transition_hier).  The
// transition tree is nuts_tree.cuh's nuts_kernel (one thread block per
// chain, one launch per transition of every chain); this file gives it the
// HierPotential and the C entries: the injected one, which reads the
// transition's streams from arrays, and the keyed one, which makes the
// same draws in the kernel (nuts_draws.cuh).  Its oracle is
// ops/fused_nuts_hier.reference_transition.
//
// The posterior: the centered model of models/hier_logistic.py over
// q = (mu, u = log tau, theta[J], beta[F]), D = 2 + J + F, with
//   pe(q) = mu^2/50 + tau^2/8 + (J-1) u + |theta - mu|^2 / (2 tau^2)
//           + |beta|^2/2 + sum_n softplus(l_n) - y_n l_n + const,
//   l_n = theta[g_n] + x_n . beta,
// the density of the JAX package's make_hier_potential on its real lanes.
// The TPU kernel's 128-lane padding (redrawn auxiliary dims), design matrix
// and bf16 splits are not ported: the chain state is the real D dims, so
// the U-turn statistic covers every dim, and every product is fp32.
//
// Design of the potential.  The data (x, y, sorted by group, with CSR
// offsets) is read from device memory: ~240 KB at N = 10,000, F = 5, which
// all chains share and which stays in L2; a block keeps only the chain's
// state and tree in shared memory (under 10 KB), so the 128 chains of the
// bench are one wave on 132 SMs.  Warp w owns groups w, w + 8, ...; its
// lanes stride over a group's rows, and the group's gradient is a warp
// butterfly.  The beta gradient is summed per lane, reduced per warp, and
// the warps' partial sums added in warp order: no atomics, so a run
// repeats bit for bit.
//
// What bounds it: the likelihood, 4F + 14 operations for each of N rows
// (the logit's and the beta gradient's FFMAs, exp, log1p, a division, the
// sums): 0.34 M per chain-leaf at N = 10,000, F = 5, so 44 M per leaf step
// of 128 chains, 0.65 us at the 67 TFLOP/s FP32 peak; each chain also
// reads the 240 KB of rows per leaf from L2.  Measured: 0.163 ms per
// transition at 7 leapfrogs per chain, ~23 us per leaf step (chip_smoke.py
// phase 16, NVIDIA H100 80GB HBM3, 700 W).  With one 256-thread block per
// SM each thread walks ~40 rows per leaf with little latency hiding; what
// holds it is not measured.  More chains per SM, or fewer rows per
// thread, is the later fix.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "nuts_tree.cuh"

namespace {

constexpr int MAXF = 8;          // most features (ops/fused_nuts_hier.py)

struct HierPotential {
  const float *gx, *gy;          // device memory: sorted rows
  const int* goff;               // device memory: (J+1) group offsets
  int j, f;
  float cst;
  float *gth, *bpart;            // shared memory
  int* off;

  __host__ __device__ int dim() const { return 2 + j + f; }

  __host__ __device__ size_t smem_floats() const {
    // theta gradients, per-warp beta sums, the group offsets
    return (size_t)j + NWARPS * MAXF + (size_t)j + 1;
  }

  __device__ float* bind(float* s) {
    gth = s; s += j;
    bpart = s; s += NWARPS * MAXF;
    off = reinterpret_cast<int*>(s); s += j + 1;
    return s;
  }

  __device__ void load() {
    for (int o = threadIdx.x; o <= j; o += NT) off[o] = goff[o];
  }

  // q visible to the whole block.  Returns this thread's share of pe - cst
  // (its rows' likelihood; thread 0 adds the prior); writes grad[d] for
  // d = tid + k*NT.
  __device__ float eval(const float* q, float* grad) const {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int F = f, J = j;
    float bk[MAXF], gb[MAXF];
#pragma unroll
    for (int k = 0; k < MAXF; ++k) {
      bk[k] = k < F ? q[2 + J + k] : 0.f;
      gb[k] = 0.f;
    }
    float lik = 0.f;
    for (int g = warp; g < J; g += NWARPS) {
      const float th = q[2 + g];
      float s = 0.f;
      for (int r = off[g] + lane; r < off[g + 1]; r += 32) {
        const float* xr = gx + (size_t)r * F;
        float xv[MAXF];
        float l = th;
#pragma unroll
        for (int k = 0; k < MAXF; ++k) {
          xv[k] = k < F ? xr[k] : 0.f;
          l = fmaf(xv[k], bk[k], l);
        }
        const float yv = gy[r];
        const float e = expf(-fabsf(l));
        lik += fmaxf(l, 0.f) + log1pf(e) - yv * l;
        const float d = (l >= 0.f ? 1.f / (1.f + e) : e / (1.f + e)) - yv;
        s += d;
#pragma unroll
        for (int k = 0; k < MAXF; ++k) gb[k] = fmaf(d, xv[k], gb[k]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) gth[g] = s;
    }
#pragma unroll
    for (int k = 0; k < MAXF; ++k) {
      if (k < F) {
        float s = gb[k];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) bpart[warp * MAXF + k] = s;
      }
    }
    __syncthreads();
    const float mu = q[0], u = q[1];
    const float tau2 = expf(2.f * u), inv_t2 = expf(-2.f * u);
    float s1 = 0.f, s2 = 0.f;
    if (tid < 2) {                       // the mu and u owners
      for (int g = 0; g < J; ++g) {
        const float dt = q[2 + g] - mu;
        s1 += dt;
        s2 = fmaf(dt, dt, s2);
      }
    }
    for (int d = tid; d < 2 + J + F; d += NT) {
      float gd;
      if (d == 0) {
        gd = mu / 25.f - s1 * inv_t2;
      } else if (d == 1) {
        gd = 0.25f * tau2 + (float)(J - 1) - s2 * inv_t2;
      } else if (d < 2 + J) {
        gd = gth[d - 2] + (q[d] - mu) * inv_t2;
      } else {
        const int k = d - 2 - J;
        float sb = 0.f;
        for (int w = 0; w < NWARPS; ++w) sb += bpart[w * MAXF + k];
        gd = sb + q[d];
      }
      grad[d] = gd;
    }
    if (tid == 0) {
      float bb = 0.f;
      for (int k = 0; k < F; ++k) bb = fmaf(bk[k], bk[k], bb);
      lik += 0.5f * mu * mu / 25.f + 0.125f * tau2 + (float)(J - 1) * u +
             0.5f * s2 * inv_t2 + 0.5f * bb;
    }
    return lik;
  }
};

HierPotential make_hier(const float* x, const float* y, const int* offsets,
                        int j, int f) {
  HierPotential pot{};
  pot.gx = x; pot.gy = y; pot.goff = offsets;
  pot.j = j; pot.f = f;
  // mu ~ N(0, 5): ln 5 + c; tau ~ HalfNormal(2) under Exp: c; theta, beta:
  // c each (c = 0.5 ln 2pi)
  const double c = 0.5 * std::log(2.0 * 3.14159265358979323846);
  pot.cst = (float)(std::log(5.0) + c * (2 + j + f));
  return pot;
}

bool bad_shape(int n, int j, int f) {
  return n <= 0 || j < 1 || f < 1 || f > MAXF;
}

int launch_hier_transition(const float* q, const float* pe, const float* grad,
                           NutsDraws draws, const float* eps,
                           const float* inv_mass, const float* x,
                           const float* y, const int* offsets, float* q_out,
                           float* pe_out, float* g_out, float* acc_out,
                           float* div_out, float* depth_out, float* steps_out,
                           float* h0_out, int n, int j, int f, int k,
                           float div_threshold, void* stream_ptr) {
  if (bad_shape(n, j, f) || k < 1 || k > MAXK) return cudaErrorInvalidValue;
  const HierPotential pot = make_hier(x, y, offsets, j, f);
  const size_t bytes =
      4 * transition_smem_floats(pot.dim(), k, pot.smem_floats());
  cudaError_t err = prepare(nuts_kernel<HierPotential>, bytes);
  if (err != cudaSuccess) return err;
  TransitionArgs A{q, pe, grad, eps, inv_mass, draws, q_out, pe_out, g_out,
                   acc_out, div_out, depth_out, steps_out, h0_out, k,
                   div_threshold};
  nuts_kernel<HierPotential><<<n, NT, bytes,
                               static_cast<cudaStream_t>(stream_ptr)>>>(pot,
                                                                        A);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one transition block needs (0 = too many).
size_t fused_hier_nuts_smem_bytes(int j, int f, int k) {
  const HierPotential pot = make_hier(nullptr, nullptr, nullptr, j, f);
  const size_t b = 4 * transition_smem_floats(pot.dim(), k,
                                              pot.smem_floats());
  return b > kMaxSmem ? 0 : b;
}

// One NUTS transition for each of n chains (one block each) on `stream`.
// Per-chain inputs are rows of the (n, D) / (n, K) / (n, 2^K) arrays; eps
// is one float in device memory; x (N, F) and y (N,) sorted by group with
// offsets (J+1); outputs pe/acc/div/depth/steps/h0 are (n,) floats.
// Returns a cudaError_t (0 on success); launches only, never synchronises.
int fused_hier_nuts_transition(
    const float* q, const float* pe, const float* grad, const float* mom,
    const float* sign_dir, const float* log_u_acc, const float* log_u_leaf,
    const float* eps, const float* inv_mass, const float* x, const float* y,
    const int* offsets, float* q_out, float* pe_out, float* g_out,
    float* acc_out, float* div_out, float* depth_out, float* steps_out,
    float* h0_out, int n, int j, int f, int k, float div_threshold,
    void* stream_ptr) {
  return launch_hier_transition(
      q, pe, grad, injected_draws(mom, sign_dir, log_u_acc, log_u_leaf, k),
      eps, inv_mass, x, y, offsets, q_out, pe_out, g_out, acc_out, div_out,
      depth_out, steps_out, h0_out, n, j, f, k, div_threshold, stream_ptr);
}

// The same transition with its draws made in the kernel from Philox keyed
// by (seed, phase, t) and the chain index (nuts_draws.cuh): what
// make_batched_transition_hier runs.
int fused_hier_nuts_transition_keyed(
    const float* q, const float* pe, const float* grad, const float* eps,
    const float* inv_mass, const float* x, const float* y,
    const int* offsets, float* q_out, float* pe_out, float* g_out,
    float* acc_out, float* div_out, float* depth_out, float* steps_out,
    float* h0_out, int n, int j, int f, int k, float div_threshold,
    unsigned long long seed, unsigned phase, unsigned t, void* stream_ptr) {
  return launch_hier_transition(
      q, pe, grad, keyed_draws(seed, phase, t, k), eps, inv_mass, x,
      y, offsets, q_out, pe_out, g_out, acc_out, div_out, depth_out,
      steps_out, h0_out, n, j, f, k, div_threshold, stream_ptr);
}

// pe (n,) and grad (n, D) at q (n, D) with the transition's potential.
int fused_hier_nuts_potential(const float* q, const float* x, const float* y,
                              const int* offsets, float* pe_out, float* g_out,
                              int n, int j, int f, void* stream_ptr) {
  if (bad_shape(n, j, f)) return cudaErrorInvalidValue;
  const HierPotential pot = make_hier(x, y, offsets, j, f);
  const size_t bytes =
      4 * (pot.smem_floats() + 2 * (size_t)pot.dim() + NWARPS * MAXV);
  cudaError_t err = prepare(potential_kernel<HierPotential>, bytes);
  if (err != cudaSuccess) return err;
  potential_kernel<HierPotential><<<n, NT, bytes,
                                    static_cast<cudaStream_t>(stream_ptr)>>>(
      pot, q, pe_out, g_out);
  return cudaGetLastError();
}

}  // extern "C"
