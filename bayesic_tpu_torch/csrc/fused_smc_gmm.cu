// Fused SMC mutation stage for the Gaussian mixture model, Hopper (sm_90a),
// fp32 SIMT: one launch runs all K HMC transitions (L leapfrogs each) of a
// tempering stage for every particle.
//
// Replaces bayesic_tpu/ops/fused_smc_gmm.py:_kernel (reached through
// fused_gmm_mutate and make_batched_mutation).  Its oracle is
// ops/fused_smc_gmm.py:mutation_core over make_gmm_potential_flat.
//
// The target: p_beta(q) = prior(q) lik(q)^beta on the flat unconstrained
// particle q = (uw (K-1 stick-breaking coordinates), mu (K D), us (K log
// scales)) of models/gmm.make_model, with
//   pe = -log Dirichlet(1)(w) - ldj_SB(uw) + |mu|^2/50 + sum_k s_k^2/8
//        - sum_k us_k + const - beta ll,
// the density of build_logjoint, constants included.  ll and its parameter
// gradient are gmm_lik.cuh's; the pullback through the stick-breaking and
// exp transforms is written out below.
//
// Semantics kept from the TPU kernel: momenta (pre-scaled) and log-uniforms
// come in from outside; a transition accepts when log u < log a; the step
// size adapts by dual averaging (t0 = 2, gamma 0.05, kappa 0.75, mu = log of
// the carried step) on the mean accept probability of a block of 128
// particles, so one CUDA block owns one such block and the mean is summed
// in a fixed order (per warp, then over four warps), no atomics.  A last
// block that is not full is padded as the TPU wrapper pads it: the missing
// particles sit at q = 0 with zero momentum, are never accepted, and their
// accept probabilities count in the block's mean.  The next stage's step is
// the geometric mean of the blocks' averaged steps (taken by the wrapper).
// Not ported: the 128-lane padding of q, the (D, N) transposed data with
// masks, the column helpers and the (PB, 1) replicated step output.
//
// Layout: x (N D floats) and the block's state (q, grad, and the
// trajectory's q, p, grad: 5 x 128 x dim floats) live in shared memory,
// ~69 KB at N = 2000, D = 2, dim 11.  Each of the 16 warps evaluates 8
// particles per potential evaluation, one at a time, its lanes striding
// over the points; the leapfrog updates run over (particle, coordinate).
//
// What bounds it: the SFU, as gmm_lik.cuh says: K exps, a log and a
// reciprocal per (particle, point) and evaluation, K L + 1 evaluations per
// stage.  At P = 8192 there are 64 blocks for 132 SMs: the 128-particle
// block is the semantics of the adaptation, not a tuning knob, so half the
// card idles; splitting a block's points over a cluster is the later fix.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "gmm_lik.cuh"

namespace {

constexpr int MT_NT = 512;               // threads per block
constexpr int MT_WARPS = MT_NT / 32;
constexpr int PB = 128;                  // particles per adaptation block

struct MutateArgs {
  const float *q, *mom, *log_u, *m_inv, *x, *beta, *eps0;
  float *q_out, *ll_out, *acc_out, *eps_out;
  int p, n, k, d, kmut, lsteps;
  float target, cst;
};

__device__ __forceinline__ float softplus(float t) {
  return fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)));
}

// pe, grad and ll of every particle of the block at qs (PB, dim) in shared
// memory; ends with a barrier.
template <int MK, int MD>
__device__ void eval_block(const float* qs, float* gs, float* pes, float* lls,
                           const float* xs, float beta, const MutateArgs& A,
                           int k, int d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dim = (k - 1) + k * d + k, off_mu = k - 1, off_us = k - 1 + k * d;
  for (int i = warp; i < PB; i += MT_WARPS) {
    const float* qi = qs + i * dim;
    // stick breaking: log w_j = log z_j + sum_{i<j} log(1 - z_i), the last
    // weight the remainder; ldj = sum_j log z_j + log(1-z_j) + that sum
    float z[MK], logw[MK], sg[MK], inv_s2[MK];
    float cum = 0.f, ldj = 0.f;
#pragma unroll
    for (int j = 0; j < MK; ++j) {
      if (j < k - 1) {
        const float t = qi[j] - logf((float)(k - 1 - j));
        z[j] = 1.f / (1.f + expf(-t));
        const float lz = -softplus(-t), l1mz = -softplus(t);
        logw[j] = lz + cum;
        ldj += lz + l1mz + cum;
        cum += l1mz;
      } else if (j == k - 1) {
        logw[j] = cum;
      }
    }
    Mix<MK, MD> m;
#pragma unroll
    for (int kk = 0; kk < MK; ++kk) {
      const float us = kk < k ? qi[off_us + kk] : 0.f;
      sg[kk] = expf(us);
      inv_s2[kk] = 1.f / (sg[kk] * sg[kk]);
      m.c[kk] = kk < k ? logw[kk] - (float)d * us - (float)d * kHalfLog2Pi
                       : 0.f;
      m.h[kk] = 0.5f * inv_s2[kk];
#pragma unroll
      for (int j = 0; j < MD; ++j)
        m.mu[kk][j] = kk < k && j < d ? qi[off_mu + kk * d + j] : 0.f;
    }
    Sums<MK, MD> s;
    s.zero();
    accumulate<MK, MD, true, true>(m, xs, lane, A.n, k, d, s);
    reduce<MK, MD, true, true>(s, k, d);
    if (lane == 0) {
      float* gi = gs + i * dim;
      float pe = A.cst - ldj - beta * s.ll, suf = 0.f;
#pragma unroll
      for (int kk = MK - 1; kk >= 0; --kk) {
        if (kk < k) {
          if (kk < k - 1) {
            // d ll / d uw_j = r_j (1 - z_j) - z_j sum_{i>j} r_i;
            // d ldj / d uw_j = (1 - 2 z_j) - z_j (K - 2 - j)
            const float zj = z[kk];
            const float dll = s.r[kk] * (1.f - zj) - zj * suf;
            const float dldj = (1.f - 2.f * zj) - zj * (float)(k - 2 - kk);
            gi[kk] = -dldj - beta * dll;
          }
          suf += s.r[kk];
          const float us = qi[off_us + kk];
          pe += sg[kk] * sg[kk] * 0.125f - us;
          gi[off_us + kk] =
              sg[kk] * sg[kk] * 0.25f - 1.f -
              beta * (s.rq[kk] * inv_s2[kk] - (float)d * s.r[kk]);
#pragma unroll
          for (int j = 0; j < MD; ++j) {
            if (j < d) {
              const float mu = m.mu[kk][j];
              pe += mu * mu * 0.02f;
              gi[off_mu + kk * d + j] =
                  mu * 0.04f - beta * (s.rdx[kk][j] * inv_s2[kk]);
            }
          }
        }
      }
      pes[i] = pe;
      lls[i] = s.ll;
    }
  }
  __syncthreads();
}

template <int MK, int MD, bool EXACT>
__global__ void __launch_bounds__(MT_NT) smc_gmm_mutate_kernel(MutateArgs A) {
  extern __shared__ float sm[];
  const int k = EXACT ? MK : A.k, d = EXACT ? MD : A.d;
  const int dim = (k - 1) + k * d + k, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * PB, p = A.p, kmut = A.kmut;
  const int nf = PB * dim;
  float* xs = sm;
  float* q = xs + A.n * d;
  float* g = q + nf;
  float* qq = g + nf;
  float* pp = qq + nf;
  float* gg = pp + nf;
  float* minv = gg + nf;
  float* pe = minv + dim;
  float* ll = pe + PB;
  float* pen = ll + PB;
  float* lln = pen + PB;
  float* h0 = lln + PB;
  float* acc = h0 + PB;
  float* av = acc + PB;
  float* take = av + PB;
  float* part = take + PB;

  for (int i = tid; i < A.n * d; i += MT_NT) xs[i] = A.x[i];
  for (int j = tid; j < dim; j += MT_NT) minv[j] = A.m_inv[j];
  for (int e = tid; e < nf; e += MT_NT) {
    const int row = base + e / dim;
    q[e] = row < p ? A.q[(size_t)row * dim + e % dim] : 0.f;
  }
  for (int i = tid; i < PB; i += MT_NT) acc[i] = 0.f;
  const float beta = *A.beta;
  const float log_eps0 = logf(*A.eps0);
  __syncthreads();
  eval_block<MK, MD>(q, g, pe, ll, xs, beta, A, k, d);

  float log_step = log_eps0, log_avg = log_eps0, grad_avg = 0.f;
  for (int t = 0; t < kmut; ++t) {
    const float eps = expf(log_step);
    for (int e = tid; e < nf; e += MT_NT) {
      const int row = base + e / dim;
      pp[e] = row < p ? A.mom[((size_t)t * p + row) * dim + e % dim] : 0.f;
      qq[e] = q[e];
      gg[e] = g[e];
    }
    __syncthreads();
    for (int i = tid; i < PB; i += MT_NT) {
      float kin = 0.f;
      for (int j = 0; j < dim; ++j) {
        const float v = pp[i * dim + j];
        kin = fmaf(v * v, minv[j], kin);
      }
      h0[i] = pe[i] + 0.5f * kin;
    }
    __syncthreads();
    for (int l = 0; l < A.lsteps; ++l) {
      for (int e = tid; e < nf; e += MT_NT) {
        pp[e] -= 0.5f * eps * gg[e];
        qq[e] += eps * minv[e % dim] * pp[e];
      }
      __syncthreads();
      eval_block<MK, MD>(qq, gg, pen, lln, xs, beta, A, k, d);
      for (int e = tid; e < nf; e += MT_NT) pp[e] -= 0.5f * eps * gg[e];
      __syncthreads();
    }
    for (int i = tid; i < PB; i += MT_NT) {
      float kin = 0.f;
      for (int j = 0; j < dim; ++j) {
        const float v = pp[i * dim + j];
        kin = fmaf(v * v, minv[j], kin);
      }
      float delta = pen[i] + 0.5f * kin - h0[i];
      if (isnan(delta)) delta = INFINITY;
      const float log_a = fminf(0.f, -delta);
      const float a = expf(log_a);
      const int row = base + i;
      const float lu = row < p ? A.log_u[(size_t)row * kmut + t] : 0.f;
      const bool tk = lu < log_a;
      av[i] = a;
      acc[i] += a;
      take[i] = tk ? 1.f : 0.f;
      if (tk) {
        pe[i] = pen[i];
        ll[i] = lln[i];
      }
    }
    __syncthreads();
    for (int e = tid; e < nf; e += MT_NT) {
      if (take[e / dim] != 0.f) {
        q[e] = qq[e];
        g[e] = gg[e];
      }
    }
    if (warp < PB / 32) {
      const float v = warp_sum(av[warp * 32 + lane]);
      if (lane == 0) part[warp] = v;
    }
    __syncthreads();
    float a_sum = 0.f;
#pragma unroll
    for (int w = 0; w < PB / 32; ++w) a_sum += part[w];
    const float a_mean = a_sum / (float)PB;
    // dual averaging: Nesterov's, as infer/mcmc/adapt.da_update at t0 = 2
    const float t2 = (float)(t + 1);
    const float eta_h = 1.f / (t2 + 2.f);
    grad_avg = (1.f - eta_h) * grad_avg + eta_h * (A.target - a_mean);
    log_step = log_eps0 - sqrtf(t2) / 0.05f * grad_avg;
    const float eta_x = expf(-0.75f * logf(t2));
    log_avg = eta_x * log_step + (1.f - eta_x) * log_avg;
  }
  __syncthreads();
  for (int e = tid; e < nf; e += MT_NT) {
    const int row = base + e / dim;
    if (row < p) A.q_out[(size_t)row * dim + e % dim] = q[e];
  }
  for (int i = tid; i < PB; i += MT_NT) {
    const int row = base + i;
    if (row < p) {
      A.ll_out[row] = ll[i];
      A.acc_out[row] = acc[i] / (float)kmut;
    }
  }
  if (tid == 0) A.eps_out[blockIdx.x] = expf(log_avg);
}

size_t smem_bytes(int n, int k, int d) {
  const size_t dim = (k - 1) + k * d + k;
  return 4 * ((size_t)n * d + 5 * PB * dim + dim + 8 * PB + PB / 32);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (0 = too many).
size_t smc_gmm_mutate_smem_bytes(int n, int k, int d) {
  const size_t b = smem_bytes(n, k, d);
  return b > kGmmMaxSmem ? 0 : b;
}

// One SMC stage's mutation for p particles: q (p, dim), mom (kmut, p, dim)
// pre-scaled momenta, log_u (p, kmut) log-uniforms, m_inv (dim,), x (n, d),
// beta and eps0 one float each in device memory.  Writes q_out (p, dim),
// ll_out (p,), acc_out (p,) (each particle's mean accept probability) and
// eps_out (ceil(p / 128),) (each block's averaged step).  cst is the
// potential's constant.  Returns a cudaError_t (0 on success); launches
// only, never synchronises.
int smc_gmm_mutate(const float* q, const float* mom, const float* log_u,
                   const float* m_inv, const float* x, const float* beta,
                   const float* eps0, float* q_out, float* ll_out,
                   float* acc_out, float* eps_out, int p, int n, int k, int d,
                   int kmut, int lsteps, float target, float cst,
                   void* stream_ptr) {
  if (p <= 0 || n <= 0 || k < 2 || k > GMM_MAXK || d < 1 || d > GMM_MAXD ||
      kmut < 1 || lsteps < 1)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(n, k, d);
  const MutateArgs A{q, mom, log_u, m_inv, x, beta, eps0, q_out, ll_out,
                     acc_out, eps_out, p, n, k, d, kmut, lsteps, target, cst};
  const dim3 grid((p + PB - 1) / PB);
  const cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (k == 3 && d == 2) {
    err = gmm_prepare(smc_gmm_mutate_kernel<3, 2, true>, bytes);
    if (err != cudaSuccess) return err;
    smc_gmm_mutate_kernel<3, 2, true><<<grid, MT_NT, bytes, st>>>(A);
  } else {
    err = gmm_prepare(smc_gmm_mutate_kernel<GMM_MAXK, GMM_MAXD, false>,
                      bytes);
    if (err != cudaSuccess) return err;
    smc_gmm_mutate_kernel<GMM_MAXK, GMM_MAXD, false>
        <<<grid, MT_NT, bytes, st>>>(A);
  }
  return cudaGetLastError();
}

}  // extern "C"
