// The multinomial-NUTS transition tree for Hopper (sm_90a), fp32 SIMT,
// of the hierarchical-logistic kernel (fused_nuts_hier.cu), which defines a
// Potential and its C entries and instantiates nuts_kernel /
// potential_kernel over it, and the tree's scalar decisions, which the
// DLGM kernel (fused_nuts.cu) shares: which checkpoint slots a leaf
// touches (leaf_slots), a leaf's weight, take and U-turn test
// (subtree_leaf), the biased merge (trajectory_merge) and the end of a
// doubling (trajectory_close).  The two trees differ only in where a
// chain's vectors live and which thread owns each element: here the block
// of one chain, element d = tid + k*NT, in shared memory; in fused_nuts.cu
// the lanes of the chain's warps, in registers and lane-owned memory.
//
// One launch runs one whole NUTS transition for every chain: momentum
// energy, up to K doublings of the trajectory with checkpoint U-turn slots,
// the in-subtree progressive multinomial take (first leaf always taken),
// the biased merge and the full-span U-turn.  The randomness comes from
// nuts_draws.cuh: read from arrays drawn by the caller (momentum normals,
// +-1 doubling signs, strictly negative log-uniforms) or drawn in the
// kernel from Philox keyed as infer/mcmc/streams.nuts_streams keys it, so
// the kernel is a deterministic function of its arguments, and its oracle
// is the plain PyTorch core (infer/mcmc/nuts.nuts_core) on those streams.
//
// Design: one thread block per chain.  Chains are independent, so a chain
// that stops early simply leaves its loops; that is the same transition as
// the JAX kernel's masked lockstep, where a masked iteration changes
// nothing for that chain.  The chain's state vectors (current, left and
// right edges, two proposals, K pairs of checkpoints) live in shared
// memory.  Every vector op is done by the thread that owns the element
// (d = tid + k*NT) in every pass, so those passes need no barrier; |p|^2,
// the potential's share and the U-turn dot products are block reductions
// in a fixed order (warp butterfly, then warps in order), so a run repeats
// bit for bit.  No atomics, no tensor cores: every product is fp32 FFMA.
//
// A Potential provides: dim(); smem_floats(); bind(float*) -> the rest of
// its shared memory; load() (cooperative copies, the caller syncs); a
// float member cst; and eval(q, grad), called by the whole block with q
// visible to it, which returns this thread's share of pe - cst and writes
// grad[d] for the elements d the thread owns.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "nuts_draws.cuh"

namespace {

constexpr int NT = 256;              // threads per block
constexpr int NWARPS = NT / 32;
constexpr int MAXK = 12;             // most doublings a launch takes
constexpr int MAXV = 2 + 2 * MAXK;   // values of one block reduction

// jnp.minimum semantics: NaN wins (fminf would drop it).
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}

// jnp.logaddexp: amax + log1p(exp(-|a-b|)), and a + b where a - b is NaN
// (both infinite).
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float d = a - b;
  if (isnan(d)) return a + b;
  return fmaxf(a, b) + log1pf(expf(-fabsf(d)));
}

// Sum the first n of v[] over the block; every thread gets the sums.
// Butterfly shuffles give all lanes the same bits; warps are then added in
// order 0..NWARPS-1.
__device__ __forceinline__ void block_sum(float (&v)[MAXV], int n,
                                          float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    if (k < n) {
      float x = v[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) red[warp * MAXV + k] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    if (k < n) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += red[w * MAXV + k];
      v[k] = s;
    }
  }
  __syncthreads();
}

// The checkpoint slots leaf i of a subtree touches (the JAX kernel's
// indexing): an even leaf stores its (q, M^-1 p) at slot pc; an odd leaf
// tests itself against the n_chk slots from idx_min.
struct LeafSlots {
  bool even;
  int pc, n_chk, idx_min;
};

__device__ __forceinline__ LeafSlots leaf_slots(int i) {
  LeafSlots s;
  s.even = (i & 1) == 0;
  s.pc = __popc(i);
  s.n_chk = s.even ? 0 : __popc(i ^ (i + 1)) - 1;
  s.idx_min = s.pc - s.n_chk;
  return s;
}

// One subtree's scalars: the log of its summed weight, its proposal's pe,
// the accept-stat sum, the leaf count, whether it turned or diverged.
struct Subtree {
  float logw, pe, acc, cnt;
  bool turn, div;

  __device__ __forceinline__ bool done() const { return turn || div; }
};

__device__ __forceinline__ Subtree subtree_start() {
  return Subtree{-INFINITY, 0.f, 0.f, 0.f, false, false};
}

// Folds in leaf `leaf` of the tree, at energy pe_new + ke/2 (ke = |p|^2
// under M^-1), whose U-turn dots against its n_chk checkpoints are
// v[2 + 2c], v[3 + 2c].  Returns whether the leaf is taken as the
// subtree's proposal (the caller copies its q and grad): the first leaf
// always is, a later one with its multinomial probability, its uniform
// drawn only then.
__device__ __forceinline__ bool subtree_leaf(
    Subtree& s, float pe_new, float ke, float h0, const float (&v)[MAXV],
    int n_chk, const NutsDraws& draws, int chain, int leaf,
    float div_threshold) {
  float delta = pe_new + 0.5f * ke - h0;
  if (isnan(delta)) delta = INFINITY;
  const float leaf_logw = -delta;
  const float new_logw = logaddexp(s.logw, leaf_logw);
  const bool take = s.logw < -1e37f ||
                    draws.leaf_log_u(chain, leaf) < leaf_logw - new_logw;
  if (take) s.pe = pe_new;
  s.acc += fminf(1.f, expf(-delta));
  s.cnt += 1.f;
  bool turn = false;
#pragma unroll
  for (int c = 0; c < MAXK; ++c)
    if (c < n_chk) turn = turn || jmin(v[2 + 2 * c], v[3 + 2 * c]) < 0.f;
  s.logw = new_logw;
  s.turn = s.turn || turn;
  s.div = s.div || delta > div_threshold;
  return take;
}

// The whole trajectory's scalars.
struct Trajectory {
  float h0, prop_pe, log_w, sum_acc, n_leaves, depth;
  bool turning, diverging;

  __device__ __forceinline__ bool more(int dstep, int k) const {
    return dstep < k && !turning && !diverging;
  }
};

__device__ __forceinline__ Trajectory trajectory_start(float pe0,
                                                       float h0) {
  return Trajectory{h0, pe0, 0.f, 0.f, 0.f, 0.f, false, false};
}

// The biased merge of a subtree that neither turned nor diverged, with
// the doubling's uniform: returns whether the subtree's proposal replaces
// the trajectory's.
__device__ __forceinline__ bool trajectory_merge(Trajectory& T,
                                                 const Subtree& s,
                                                 float log_u) {
  const bool take = log_u < jmin(0.f, s.logw - T.log_w);
  if (take) T.prop_pe = s.pe;
  T.log_w = logaddexp(T.log_w, s.logw);
  return take;
}

// The end of a doubling; full_turn is the full-span U-turn of a merged
// subtree (false when the subtree turned or diverged).
__device__ __forceinline__ void trajectory_close(Trajectory& T,
                                                 const Subtree& s,
                                                 bool full_turn) {
  T.turning = s.turn || (!s.done() && full_turn);
  T.diverging = s.div;
  T.sum_acc += s.acc;
  T.n_leaves += s.cnt;
  T.depth += 1.f;
}

// The chain's per-chain outputs (Args: pe_out, acc_out, div_out,
// depth_out, steps_out, h0_out).
template <class Args>
__device__ __forceinline__ void trajectory_write(const Args& A, int chain,
                                                 const Trajectory& T) {
  A.pe_out[chain] = T.prop_pe;
  A.acc_out[chain] = T.sum_acc / fmaxf(T.n_leaves, 1.f);
  A.div_out[chain] = T.diverging ? 1.f : 0.f;
  A.depth_out[chain] = T.depth;
  A.steps_out[chain] = T.n_leaves;
  A.h0_out[chain] = T.h0;
}

struct TransitionArgs {
  const float *q, *pe, *grad, *eps, *inv_mass;
  NutsDraws draws;
  float *q_out, *pe_out, *g_out, *acc_out, *div_out, *depth_out, *steps_out,
      *h0_out;
  int k;
  float div_threshold;
};

__host__ __device__ size_t transition_smem_floats(int dim, int k,
                                                  size_t pot_floats) {
  // 3 trajectory states (q, p, g), 2 proposals (q, g), K checkpoint pairs,
  // the inverse mass, the reduction scratch
  return pot_floats + (size_t)(9 + 4 + 2 * k + 1) * dim + NWARPS * MAXV;
}

// One NUTS transition of chain blockIdx.x (see the header comment).
template <class Potential>
__global__ void __launch_bounds__(NT)
nuts_kernel(Potential pot, TransitionArgs A) {
  extern __shared__ float smem[];
  const int chain = blockIdx.x, tid = threadIdx.x, K = A.k;
  const int D = pot.dim();
  float* s = pot.bind(smem);
  float *Q[3], *P[3], *G[3], *PQ[2], *PG[2];
  for (int b = 0; b < 3; ++b) {
    Q[b] = s; s += D;
    P[b] = s; s += D;
    G[b] = s; s += D;
  }
  for (int b = 0; b < 2; ++b) {
    PQ[b] = s; s += D;
    PG[b] = s; s += D;
  }
  float* ckq = s; s += (size_t)K * D;
  float* ckv = s; s += (size_t)K * D;
  float* invm = s; s += D;
  float* red = s;

  pot.load();
  const size_t row = (size_t)chain * D;
  const float eps = A.eps[0];
  float v[MAXV];
  v[0] = 0.f;
  for (int d = tid; d < D; d += NT) {
    const float im = A.inv_mass[d], qd = A.q[row + d], gd = A.grad[row + d];
    const float p0 = A.draws.momentum(chain, d, D) * rsqrtf(im);
    invm[d] = im;
    Q[0][d] = qd; P[0][d] = p0; G[0][d] = gd;
    PQ[0][d] = qd; PG[0][d] = gd;
    v[0] = fmaf(p0 * p0, im, v[0]);
  }
  block_sum(v, 1, red);     // its barriers also publish the loads above
  const float pe0 = A.pe[chain];
  Trajectory T = trajectory_start(pe0, pe0 + 0.5f * v[0]);

  int iL = 0, iR = 0, iP = 0;   // left/right edge and proposal buffers
  for (int dstep = 0; T.more(dstep, K); ++dstep) {
    const bool go_right = A.draws.go_right(chain, dstep);
    const float sign_w = go_right ? 1.f : -1.f, eps_w = sign_w * eps;
    const int iE = go_right ? iR : iL;
    int iC = 0;
    while (iC == iL || iC == iR) ++iC;
    float *q = Q[iC], *p = P[iC], *g = G[iC];
    for (int d = tid; d < D; d += NT) {
      q[d] = Q[iE][d]; p[d] = P[iE][d]; g[d] = G[iE][d];
    }
    const int n_sub = 1 << dstep, leaf_base = n_sub - 1, iS = 1 - iP;
    Subtree s = subtree_start();
    for (int i = 0; i < n_sub && !s.done(); ++i) {
      for (int d = tid; d < D; d += NT) {          // half kick, drift
        const float ph = p[d] - (0.5f * eps_w) * g[d];
        p[d] = ph;
        q[d] = q[d] + eps_w * (invm[d] * ph);
      }
      __syncthreads();
      float part = pot.eval(q, g);
      const LeafSlots ls = leaf_slots(i);
      float ke = 0.f;
#pragma unroll
      for (int c = 0; c < 2 * MAXK; ++c) v[2 + c] = 0.f;
      for (int d = tid; d < D; d += NT) {          // half kick, bookkeeping
        const float pn = p[d] - (0.5f * eps_w) * g[d];
        const float vn = invm[d] * pn, qd = q[d];
        p[d] = pn;
        ke = fmaf(pn * pn, invm[d], ke);
        if (ls.even) {
          ckq[(size_t)ls.pc * D + d] = qd;
          ckv[(size_t)ls.pc * D + d] = vn;
        } else {
#pragma unroll
          for (int c = 0; c < MAXK; ++c) {
            if (c < ls.n_chk) {
              const size_t o = (size_t)(ls.idx_min + c) * D + d;
              const float dq = (qd - ckq[o]) * sign_w;
              v[2 + 2 * c] = fmaf(dq, ckv[o], v[2 + 2 * c]);
              v[3 + 2 * c] = fmaf(dq, vn, v[3 + 2 * c]);
            }
          }
        }
      }
      v[0] = part;
      v[1] = ke;
      block_sum(v, 2 + 2 * ls.n_chk, red);
      if (subtree_leaf(s, v[0] + pot.cst, v[1], T.h0, v, ls.n_chk, A.draws,
                       chain, leaf_base + i, A.div_threshold)) {
        for (int d = tid; d < D; d += NT) {        // progressive take
          PQ[iS][d] = q[d];
          PG[iS][d] = g[d];
        }
      }
    }
    bool full_turn = false;
    if (!s.done()) {
      if (trajectory_merge(T, s, A.draws.merge_log_u(chain, dstep)))
        iP = iS;                                   // biased merge
      if (go_right) iR = iC; else iL = iC;
      v[0] = v[1] = 0.f;
      for (int d = tid; d < D; d += NT) {          // full-span U-turn
        const float dq = Q[iR][d] - Q[iL][d];
        v[0] = fmaf(dq, invm[d] * P[iL][d], v[0]);
        v[1] = fmaf(dq, invm[d] * P[iR][d], v[1]);
      }
      block_sum(v, 2, red);
      full_turn = jmin(v[0], v[1]) < 0.f;
    }
    trajectory_close(T, s, full_turn);
  }
  for (int d = tid; d < D; d += NT) {
    A.q_out[row + d] = PQ[iP][d];
    A.g_out[row + d] = PG[iP][d];
  }
  if (tid == 0) trajectory_write(A, chain, T);
}

// pe and grad of each chain with the kernel's own device function.
template <class Potential>
__global__ void __launch_bounds__(NT)
potential_kernel(Potential pot, const float* q, float* pe_out,
                 float* g_out) {
  extern __shared__ float smem[];
  const int D = pot.dim();
  float* s = pot.bind(smem);
  float* qs = s; s += D;
  float* gs = s; s += D;
  float* red = s;
  pot.load();
  const size_t row = (size_t)blockIdx.x * D;
  for (int d = threadIdx.x; d < D; d += NT) qs[d] = q[row + d];
  __syncthreads();
  float v[MAXV];
  v[0] = pot.eval(qs, gs);
  for (int d = threadIdx.x; d < D; d += NT) g_out[row + d] = gs[d];
  block_sum(v, 1, red);
  if (threadIdx.x == 0) pe_out[blockIdx.x] = v[0] + pot.cst;
}

constexpr size_t kMaxSmem = 232448;   // 227 KB, the per-block maximum

template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
