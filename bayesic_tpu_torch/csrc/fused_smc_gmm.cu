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
// gradient are gmm_lik.cuh's function; the pullback through the
// stick-breaking and exp transforms is written out below.
//
// Semantics kept from the TPU kernel: momenta (pre-scaled) and log-uniforms
// come in from outside; a transition accepts when log u < log a; the step
// size adapts by dual averaging (t0 = 2, gamma 0.05, kappa 0.75, mu = log of
// the carried step) on the mean accept probability of a block of 128
// particles.  A last block that is not full is padded as the TPU wrapper
// pads it: the missing particles sit at q = 0 with zero momentum, are never
// accepted, and their accept probabilities count in the block's mean.  The
// next stage's step is the geometric mean of the blocks' averaged steps
// (taken by the wrapper).  Not ported: the 128-lane padding of q, the
// (D, N) transposed data with masks, the column helpers and the (PB, 1)
// replicated step output.
//
// What bounds it: per (particle, point) and evaluation, K exps, the
// responsibilities' reciprocal and the ~40 fp32 operations around them, K L
// + 1 evaluations per stage: the SFU and the issue rate, not memory (the
// data, N D floats, sits in each block's shared memory).  The design:
//
// * A cluster of CL = 2 blocks per 128-particle adaptation block.  Each
//   block owns 64 particles and its own copy of x.  The one value that
//   crosses blocks is the adaptation block's mean accept, once per
//   transition: every warp writes the fixed-order sum of its particles'
//   accept probabilities into a slot of its block's shared memory (two
//   slots, by the parity of t), the cluster synchronises, and every warp of
//   every block reads all the slots through distributed shared memory and
//   adds them in one fixed order, so all hold the same bits of the mean and
//   of the adapted step; no atomics.  At P = 8192 that is 128 blocks, where
//   one block per adaptation block filled 64 of the 132 SMs.
// * Warp-owned particles: a warp owns PPW particles for the whole stage and
//   runs their leapfrogs, energies and MH decisions with __syncwarp only
//   (lane j holds coordinate j of each); the cluster barrier once per
//   transition is the only barrier between warps.  Their state lives in the
//   warp's rows of shared memory.  The K 3, D 2 instance runs 32 warps of
//   two particles at 64 registers a thread; the generic one 16 warps of
//   four, at 128 (its arrays spill at 64).
// * The per-point loop is gmm_lik.cuh's points_log2, shared with the
//   likelihood kernels of gmm_logprob.cu, here with the value's and the
//   gradient's sums both on: log2 e folded into each component's
//   constants once per evaluation, one ex2.approx a component, one
//   rcp.approx a point and one lg2.approx per kChunk points.  It can carry
//   W particles through each point a lane loads; W = 1 in both instances,
//   as two particles a group at 16 warps was slower than one at 32
//   (tools/smc_mutation_ablation.py times the alternatives).
// * No tensor cores: D <= 4 gives no product worth an mma, and the expanded
//   |x|^2 - 2 mu.x + |mu|^2 cancels when a component sits on the data.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "gmm_lik.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int PB = 128;               // particles per adaptation block
constexpr int CL = 2;                 // blocks per cluster (per PB)
constexpr int PPC = PB / CL;          // particles per block
// warps per block: the K 3, D 2 instance fits 64 registers a thread, the
// generic one's K <= 8, D <= 4 arrays need 128
constexpr int NW_EXACT = 32;
constexpr int NW_GENERIC = 16;

struct MutateArgs {
  const float *q, *mom, *log_u, *m_inv, *x, *beta, *eps0;
  float *q_out, *ll_out, *acc_out, *eps_out;
  int p, n, k, d, kmut, lsteps;
  float target, cst;
};

__device__ __forceinline__ float softplus(float t) {
  return fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)));
}

// One particle's transformed parameters: the stick-breaking z_j and log
// weights, its log-Jacobian, and the scales.
template <int MK>
struct Terms {
  float z[MK], logw[MK], sg[MK], inv_s2[MK];
  float ldj;
};

template <int MK>
__device__ __forceinline__ Terms<MK> particle_terms(const float* qi, int k,
                                                    int off_us) {
  // stick breaking: log w_j = log z_j + sum_{i<j} log(1 - z_i), the last
  // weight the remainder; ldj = sum_j log z_j + log(1-z_j) + that sum
  Terms<MK> t;
  float cum = 0.f;
  t.ldj = 0.f;
#pragma unroll
  for (int j = 0; j < MK; ++j) {
    t.z[j] = 0.f;
    t.logw[j] = 0.f;
    if (j < k - 1) {
      const float v = qi[j] - logf((float)(k - 1 - j));
      t.z[j] = 1.f / (1.f + expf(-v));
      const float lz = -softplus(-v), l1mz = -softplus(v);
      t.logw[j] = lz + cum;
      t.ldj += lz + l1mz + cum;
      cum += l1mz;
    } else if (j == k - 1) {
      t.logw[j] = cum;
    }
    const float us = j < k ? qi[off_us + j] : 0.f;
    t.sg[j] = expf(us);
    t.inv_s2[j] = 1.f / (t.sg[j] * t.sg[j]);
  }
  return t;
}

// pe, grad and ll of the W particles at qs (W rows of dim floats in shared
// memory): every lane computes the sums' totals and pe; lane j writes
// gradient coordinate j (and j + 32, ...); lane 0 writes pe and ll.
template <int MK, int MD, bool EXACT, int W>
__device__ __forceinline__ void eval_group(const float* qs, float* gs,
                                           float* pes, float* lls,
                                           const float* xs, float beta,
                                           const MutateArgs& A, int k, int d,
                                           int lane) {
  const int dim = (k - 1) + k * d + k, off_mu = k - 1, off_us = off_mu + k * d;
  Mix2<MK, MD, W> m;
  Acc2<MK, MD, W, true, true> s;   // value and gradient
  s.zero();
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const float* qi = qs + w * dim;
    const Terms<MK> t = particle_terms<MK>(qi, k, off_us);
#pragma unroll
    for (int kk = 0; kk < MK; ++kk) {
      const float us = kk < k ? qi[off_us + kk] : 0.f;
      m.c[w][kk] = kk < k ? kLog2e * (t.logw[kk] - (float)d * us -
                                      (float)d * kHalfLog2Pi)
                          : 0.f;
      m.h[w][kk] = kLog2e * 0.5f * t.inv_s2[kk];
#pragma unroll
      for (int j = 0; j < MD; ++j)
        m.mu[w][kk][j] = kk < k && j < d ? qi[off_mu + kk * d + j] : 0.f;
    }
  }
  points_log2<MK, MD, EXACT, W>(m, xs, lane, A.n, k, d, s);
  s.butterfly(k, d);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const float* qi = qs + w * dim;
    const Terms<MK> t = particle_terms<MK>(qi, k, off_us);
    const float ll = kLn2 * s.ll[w];
    float pe = A.cst - t.ldj - beta * ll;
#pragma unroll
    for (int kk = 0; kk < MK; ++kk) {
      if (kk < k) {
        pe += t.sg[kk] * t.sg[kk] * 0.125f - qi[off_us + kk];
#pragma unroll
        for (int j = 0; j < MD; ++j) {
          if (j < d) {
            const float mu = qi[off_mu + kk * d + j];
            pe += mu * mu * 0.02f;
          }
        }
      }
    }
    for (int e = lane; e < dim; e += 32) {
      float gv;
      if (e < off_mu) {
        // d ll / d uw_j = r_j (1 - z_j) - z_j sum_{i>j} r_i;
        // d ldj / d uw_j = (1 - 2 z_j) - z_j (K - 2 - j)
        float zj = 0.f, rj = 0.f, suf = 0.f;
#pragma unroll
        for (int kk = 0; kk < MK; ++kk) {
          if (kk == e) {
            zj = t.z[kk];
            rj = s.r[w][kk];
          } else if (kk > e && kk < k) {
            suf += s.r[w][kk];
          }
        }
        const float dll = rj * (1.f - zj) - zj * suf;
        const float dldj = (1.f - 2.f * zj) - zj * (float)(k - 2 - e);
        gv = -dldj - beta * dll;
      } else if (e < off_us) {
        float rdx = 0.f, inv_s2 = 0.f;
#pragma unroll
        for (int kk = 0; kk < MK; ++kk) {
#pragma unroll
          for (int j = 0; j < MD; ++j) {
            if (kk < k && j < d && off_mu + kk * d + j == e) {
              rdx = s.rdx[w][kk][j];
              inv_s2 = t.inv_s2[kk];
            }
          }
        }
        gv = qi[e] * 0.04f - beta * (rdx * inv_s2);
      } else {
        float r = 0.f, rq = 0.f, sg = 0.f, inv_s2 = 0.f;
#pragma unroll
        for (int kk = 0; kk < MK; ++kk) {
          if (off_us + kk == e) {
            r = s.r[w][kk];
            rq = s.rq[w][kk];
            sg = t.sg[kk];
            inv_s2 = t.inv_s2[kk];
          }
        }
        gv = sg * sg * 0.25f - 1.f - beta * (rq * inv_s2 - (float)d * r);
      }
      gs[w * dim + e] = gv;
    }
    if (lane == 0) {
      pes[w] = pe;
      lls[w] = ll;
    }
  }
}

// pe, grad and ll of the warp's PPW particles, W at a time; ends with a
// __syncwarp.
template <int MK, int MD, bool EXACT, int W, int PPW>
__device__ __forceinline__ void eval_warp(const float* qs, float* gs,
                                          float* pes, float* lls,
                                          const float* xs, float beta,
                                          const MutateArgs& A, int k, int d,
                                          int dim, int lane) {
  for (int i = 0; i < PPW; i += W)
    eval_group<MK, MD, EXACT, W>(qs + i * dim, gs + i * dim, pes + i, lls + i,
                                 xs, beta, A, k, d, lane);
  __syncwarp();
}

// sum_j v_j^2 m_inv_j over the lanes' coordinates; the same bits on every
// lane.
__device__ __forceinline__ float kinetic(const float* v, const float* minv,
                                         int dim, int lane) {
  float kin = 0.f;
  for (int e = lane; e < dim; e += 32) kin = fmaf(v[e] * v[e], minv[e], kin);
  return warp_sum(kin);
}

template <int MK, int MD, bool EXACT, int W, int NW>
__global__ void __launch_bounds__(NW * 32, 1)
    smc_gmm_mutate_kernel(MutateArgs A) {
  constexpr int NT = NW * 32, PPW = PPC / NW;
  static_assert(PPW * NW == PPC && PPW % W == 0,
                "a warp's particles split into groups of W");
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  cg::cluster_group cluster = cg::this_cluster();
  const int k = EXACT ? MK : A.k, d = EXACT ? MD : A.d;
  const int dim = (k - 1) + k * d + k, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = A.p, kmut = A.kmut, n = A.n;
  const int rank = (int)cluster.block_rank();
  const int blk = blockIdx.x / CL;           // the adaptation block
  const int row0 = blk * PB + rank * PPC;    // this block's first particle
  const int nf = PPC * dim;
  float* xs = sm;
  float* q = xs + ((n * d + 3) & ~3);
  float* g = q + nf;
  float* qq = g + nf;
  float* pp = qq + nf;
  float* gg = pp + nf;
  float* minv = gg + nf;
  float* pe = minv + dim;
  float* ll = pe + PPC;
  float* pen = ll + PPC;
  float* lln = pen + PPC;
  float* h0 = lln + PPC;
  float* acc = h0 + PPC;
  float* wpart = acc + PPC;                  // [2][NW]: by the parity of t

  for (int i = tid; i < n * d; i += NT) xs[i] = A.x[i];
  for (int j = tid; j < dim; j += NT) minv[j] = A.m_inv[j];
  for (int e = tid; e < nf; e += NT) {
    const int row = row0 + e / dim;
    q[e] = row < p ? A.q[(size_t)row * dim + e % dim] : 0.f;
  }
  for (int i = tid; i < PPC; i += NT) acc[i] = 0.f;
  const float beta = *A.beta;
  const float log_eps0 = logf(*A.eps0);
  __syncthreads();

  // the warp's particles: local rows i0 .. i0 + PPW - 1
  const int i0 = warp * PPW, f0 = i0 * dim;
  eval_warp<MK, MD, EXACT, W, PPW>(q + f0, g + f0, pe + i0, ll + i0, xs,
                                   beta, A, k, d, dim, lane);

  float log_step = log_eps0, log_avg = log_eps0, grad_avg = 0.f;
  for (int t = 0; t < kmut; ++t) {
    const float eps = expf(log_step);
    for (int i = 0; i < PPW; ++i) {
      const int row = row0 + i0 + i, f = f0 + i * dim;
      for (int e = lane; e < dim; e += 32) {
        pp[f + e] =
            row < p ? A.mom[((size_t)t * p + row) * dim + e] : 0.f;
        qq[f + e] = q[f + e];
        gg[f + e] = g[f + e];
      }
      const float kin = kinetic(pp + f, minv, dim, lane);
      if (lane == 0) h0[i0 + i] = pe[i0 + i] + 0.5f * kin;
    }
    for (int l = 0; l < A.lsteps; ++l) {
      for (int i = 0; i < PPW; ++i) {
        const int f = f0 + i * dim;
        for (int e = lane; e < dim; e += 32) {
          pp[f + e] -= 0.5f * eps * gg[f + e];
          qq[f + e] += eps * minv[e] * pp[f + e];
        }
      }
      __syncwarp();
      eval_warp<MK, MD, EXACT, W, PPW>(qq + f0, gg + f0, pen + i0, lln + i0,
                                       xs, beta, A, k, d, dim, lane);
      for (int i = 0; i < PPW; ++i) {
        const int f = f0 + i * dim;
        for (int e = lane; e < dim; e += 32)
          pp[f + e] -= 0.5f * eps * gg[f + e];
      }
    }
    // MH in log space; every lane reaches the same decision
    float a_warp = 0.f;
    for (int i = 0; i < PPW; ++i) {
      const int row = row0 + i0 + i, f = f0 + i * dim;
      const float kin = kinetic(pp + f, minv, dim, lane);
      float delta = pen[i0 + i] + 0.5f * kin - h0[i0 + i];
      if (isnan(delta)) delta = INFINITY;
      const float log_a = fminf(0.f, -delta);
      const float a = expf(log_a);
      const float lu = row < p ? A.log_u[(size_t)row * kmut + t] : 0.f;
      a_warp += a;
      if (lu < log_a) {
        for (int e = lane; e < dim; e += 32) {
          q[f + e] = qq[f + e];
          g[f + e] = gg[f + e];
        }
        if (lane == 0) {
          pe[i0 + i] = pen[i0 + i];
          ll[i0 + i] = lln[i0 + i];
        }
      }
      if (lane == 0) acc[i0 + i] += a;
    }
    __syncwarp();
    // the adaptation block's mean accept: each warp's sum, then every warp
    // adds all CL * NW of them in one fixed order
    float* slot = wpart + (t & 1) * NW;
    if (lane == 0) slot[warp] = a_warp;
    cluster.sync();
    float a_part = 0.f;
    for (int j = lane; j < CL * NW; j += 32)
      a_part += cluster.map_shared_rank(slot, j / NW)[j % NW];
    const float a_mean = warp_sum(a_part) / (float)PB;
    // dual averaging: Nesterov's, as infer/mcmc/adapt.da_update at t0 = 2
    const float t2 = (float)(t + 1);
    const float eta_h = 1.f / (t2 + 2.f);
    grad_avg = (1.f - eta_h) * grad_avg + eta_h * (A.target - a_mean);
    log_step = log_eps0 - sqrtf(t2) / 0.05f * grad_avg;
    const float eta_x = expf(-0.75f * logf(t2));
    log_avg = eta_x * log_step + (1.f - eta_x) * log_avg;
  }
  __syncwarp();
  for (int i = 0; i < PPW; ++i) {
    const int row = row0 + i0 + i, f = f0 + i * dim;
    if (row < p) {
      for (int e = lane; e < dim; e += 32)
        A.q_out[(size_t)row * dim + e] = q[f + e];
      if (lane == 0) {
        A.ll_out[row] = ll[i0 + i];
        A.acc_out[row] = acc[i0 + i] / (float)kmut;
      }
    }
  }
  if (rank == 0 && tid == 0) A.eps_out[blk] = expf(log_avg);
  // a peer may still be reading this block's slots
  cluster.sync();
}

bool exact_instance(int k, int d) { return k == 3 && d == 2; }

int warps(int k, int d) {
  return exact_instance(k, d) ? NW_EXACT : NW_GENERIC;
}

size_t smem_bytes(int n, int k, int d) {
  const size_t dim = (k - 1) + k * d + k;
  return 4 * ((((size_t)n * d + 3) & ~(size_t)3) + 5 * PPC * dim + dim +
              6 * PPC + 2 * warps(k, d));
}

// The launch: one cluster of CL blocks per adaptation block.
template <int MK, int MD, bool EXACT, int W, int NW>
cudaError_t launch(const MutateArgs& A, size_t bytes, cudaStream_t st,
                   int* max_clusters) {
  auto kernel = smc_gmm_mutate_kernel<MK, MD, EXACT, W, NW>;
  cudaError_t err = gmm_prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * ((A.p + PB - 1) / PB));
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, kernel,
                                                          &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, A);
}

cudaError_t dispatch(const MutateArgs& A, size_t bytes, cudaStream_t st,
                     int* max_clusters) {
  if (exact_instance(A.k, A.d))
    return launch<3, 2, true, 1, NW_EXACT>(A, bytes, st, max_clusters);
  return launch<GMM_MAXK, GMM_MAXD, false, 1, NW_GENERIC>(A, bytes, st,
                                                          max_clusters);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (0 = too many).
size_t smc_gmm_mutate_smem_bytes(int n, int k, int d) {
  const size_t b = smem_bytes(n, k, d);
  return b > kGmmMaxSmem ? 0 : b;
}

// The launch geometry at (n, k, d): out[0] blocks per cluster, out[1]
// threads per block, out[2] particles per warp, out[3] the clusters that
// can be resident at once (cudaOccupancyMaxActiveClusters).  Returns a
// cudaError_t.
int smc_gmm_mutate_geometry(int n, int k, int d, int* out) {
  if (n <= 0 || k < 2 || k > GMM_MAXK || d < 1 || d > GMM_MAXD)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(n, k, d);
  MutateArgs A{};
  A.p = PB;
  A.n = n;
  A.k = k;
  A.d = d;
  out[0] = CL;
  out[1] = 32 * warps(k, d);
  out[2] = PPC / warps(k, d);
  return dispatch(A, bytes, nullptr, &out[3]);
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
  const MutateArgs A{q, mom, log_u, m_inv, x, beta, eps0, q_out, ll_out,
                     acc_out, eps_out, p, n, k, d, kmut, lsteps, target, cst};
  const cudaError_t err = dispatch(A, smem_bytes(n, k, d),
                                   static_cast<cudaStream_t>(stream_ptr),
                                   nullptr);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
