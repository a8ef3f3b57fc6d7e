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
// Design: one thread block per chain, of NT threads (a template argument
// of the kernels; the hier potential runs 512).  Chains are independent,
// so a chain that stops early simply leaves its loops; that is the same
// transition as the JAX kernel's masked lockstep, where a masked iteration
// changes nothing for that chain.  The chain's state vectors (current,
// left and right edges, two proposals, K pairs of checkpoints) live in
// shared memory.  The warps that own an element (d = tid + k*NT < D) run
// the tree; every vector op is done by the owning thread in every pass, so
// those passes need no barrier, and |p|^2, the U-turn dot products and the
// full-span U-turn are sums over the owner warps in a fixed order (warp
// butterfly, then the warps in order, one named barrier among them), so a
// run repeats bit for bit.  The other warps only help evaluate the
// potential: at each leaf they wait at the block barrier that publishes q
// (and which of the three states it is, or that the transition is over),
// run eval, and wait again, so the tree's scalar work and its registers
// stay on the owner warps.  No atomics, no tensor cores: every product is
// fp32 FFMA.  The transition's draws (K directions, K merge and 2^K leaf
// uniforms; a draw is a pure function of its indices, nuts_draws.cuh) are
// made into shared memory at the start by the threads that own no element,
// while the potential's copies are in flight; the tree reads each one when
// it reaches it.
//
// A Potential provides: dim(); smem_floats(); bind(float*) -> the rest of
// its shared memory; load(), which starts its copies into shared memory,
// and wait(), after which they have landed (every thread calls wait() after
// a barrier that follows load()); a float member cst; and eval(q, grad),
// called by the whole block with q visible to it (it may hold block
// barriers), which returns pe - cst on thread 0 and writes grad[d] for the
// elements d each owner thread owns.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "nuts_draws.cuh"
#include "warp_sum.cuh"

namespace {

constexpr int MAXK = 12;             // most doublings a launch takes
constexpr int MAXV = 2 + 2 * MAXK;   // a leaf's sums: pe, |p|^2, K dot pairs

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

// The warps of an NT-thread block that own an element of a D-vector.
template <int NT>
__host__ __device__ __forceinline__ int owner_warps(int dim) {
  return (dim + 31) / 32 < NT / 32 ? (dim + 31) / 32 : NT / 32;
}

// A barrier among the first nw warps (named barrier 1).
__device__ __forceinline__ void owner_sync(int nw) {
  asm volatile("bar.sync 1, %0;" ::"r"(nw * 32) : "memory");
}

// Sum v[] over the first nw warps (the owner warps, which all call it);
// each of them gets the sums.  Butterfly shuffles give all lanes the same
// bits; the warps are then added in order 0..nw-1.  red holds nw x N.
template <int N>
__device__ __forceinline__ void owner_sum(float (&v)[N], int nw, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float x = warp_sum(v[k]);
    if (lane == 0) red[warp * N + k] = x;
  }
  owner_sync(nw);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[w * N + k];
    v[k] = s;
  }
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
// under M^-1); turn: whether the leaf U-turned against one of its
// checkpoints.  Returns whether the leaf is taken as the subtree's proposal
// (the caller copies its q and grad): the first leaf always is, a later
// one with its multinomial probability, against the leaf's log-uniform
// log_u(), read only then.
template <class LogU>
__device__ __forceinline__ bool subtree_fold(Subtree& s, float pe_new,
                                             float ke, float h0, bool turn,
                                             LogU log_u,
                                             float div_threshold) {
  float delta = pe_new + 0.5f * ke - h0;
  if (isnan(delta)) delta = INFINITY;
  const float leaf_logw = -delta;
  const float new_logw = logaddexp(s.logw, leaf_logw);
  const bool take = s.logw < -1e37f || log_u() < leaf_logw - new_logw;
  if (take) s.pe = pe_new;
  s.acc += fminf(1.f, expf(-delta));
  s.cnt += 1.f;
  s.logw = new_logw;
  s.turn = s.turn || turn;
  s.div = s.div || delta > div_threshold;
  return take;
}

// The same for a leaf whose U-turn dots against its n_chk checkpoints are
// v[2 + 2c], v[3 + 2c], its uniform drawn only when it is read.
__device__ __forceinline__ bool subtree_leaf(
    Subtree& s, float pe_new, float ke, float h0, const float (&v)[MAXV],
    int n_chk, const NutsDraws& draws, int chain, int leaf,
    float div_threshold) {
  bool turn = false;
#pragma unroll
  for (int c = 0; c < MAXK; ++c)
    if (c < n_chk) turn = turn || jmin(v[2 + 2 * c], v[3 + 2 * c]) < 0.f;
  return subtree_fold(s, pe_new, ke, h0, turn,
                      [&] { return draws.leaf_log_u(chain, leaf); },
                      div_threshold);
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

// Floats of shared memory one transition block needs.
template <int NT>
__host__ __device__ size_t transition_smem_floats(int dim, int k,
                                                  size_t pot_floats) {
  // 3 trajectory states (q, p, g), 2 proposals (q, g), K checkpoint pairs,
  // the inverse mass; the owner warps' leaf and 2-value sums; the draws (K
  // directions, K merge and 2^K leaf log-uniforms); the helpers' word
  return pot_floats + (size_t)(9 + 4 + 2 * k + 1) * dim +
         (size_t)owner_warps<NT>(dim) * (MAXV + 2) + 2 * k +
         ((size_t)1 << k) + 1;
}

// One NUTS transition of chain blockIdx.x (see the header comment).
template <int NT, class Potential>
__global__ void __launch_bounds__(NT, 1)
nuts_kernel(Potential pot, TransitionArgs A) {
  extern __shared__ __align__(16) float smem[];
  const int chain = blockIdx.x, tid = threadIdx.x, K = A.k;
  const int lane = tid & 31, warp = tid >> 5;
  const int D = pot.dim(), nw = owner_warps<NT>(D);
  // state b of three is (q, p, g) at st + 3bD; proposal b of two is
  // (q, g) at pr + 2bD
  float* st = pot.bind(smem);
  float* pr = st + 9 * D;
  float* ckq = pr + 4 * D;
  float* ckv = ckq + (size_t)K * D;
  float* invm = ckv + (size_t)K * D;
  float* red = invm + D;              // nw x MAXV: a leaf's sums
  float* red2 = red + nw * MAXV;      // nw x 2: |p|^2, the full-span dots
  float* dir = red2 + 2 * nw;
  float* merge_u = dir + K;
  float* leaf_u = merge_u + K;
  // the state the helpers evaluate q at, or -1 when the transition is over
  int* helper_state = reinterpret_cast<int*>(leaf_u + (1 << K));

  pot.load();
  const int n_draws = 2 * K + (1 << K);
  for (int e = NT - 1 - tid; e < n_draws; e += NT) {
    if (e < K)
      dir[e] = A.draws.go_right(chain, e) ? 1.f : -1.f;
    else if (e < 2 * K)
      merge_u[e - K] = A.draws.merge_log_u(chain, e - K);
    else
      leaf_u[e - 2 * K] = A.draws.leaf_log_u(chain, e - 2 * K);
  }
  const size_t row = (size_t)chain * D;
  float m2[1] = {0.f};
  for (int d = tid; d < D; d += NT) {
    const float im = A.inv_mass[d], qd = A.q[row + d], gd = A.grad[row + d];
    const float p0 = A.draws.momentum(chain, d, D) * rsqrtf(im);
    invm[d] = im;
    st[d] = qd; st[D + d] = p0; st[2 * D + d] = gd;
    pr[d] = qd; pr[D + d] = gd;
    m2[0] = fmaf(p0 * p0, im, m2[0]);
  }
  __syncthreads();                    // publishes the draws and the state
  pot.wait();
  if (warp >= nw) {                   // a helper warp
    for (;;) {
      __syncthreads();
      const int b = *helper_state;
      if (b < 0) return;
      pot.eval(st + 3 * b * D, nullptr);
    }
  }

  owner_sum(m2, nw, red2);
  const float pe0 = A.pe[chain], eps = A.eps[0];
  Trajectory T = trajectory_start(pe0, pe0 + 0.5f * m2[0]);
  int iL = 0, iR = 0, iP = 0;   // left/right edge and proposal buffers
  for (int dstep = 0; T.more(dstep, K); ++dstep) {
    const bool go_right = dir[dstep] > 0.f;
    const float sign_w = go_right ? 1.f : -1.f, eps_w = sign_w * eps;
    const int iE = go_right ? iR : iL;
    int iC = 0;
    while (iC == iL || iC == iR) ++iC;
    float *q = st + 3 * iC * D, *p = q + D, *g = p + D;
    const float* e = st + 3 * iE * D;
    for (int d = tid; d < D; d += NT) {
      q[d] = e[d]; p[d] = e[D + d]; g[d] = e[2 * D + d];
    }
    const int n_sub = 1 << dstep, leaf_base = n_sub - 1, iS = 1 - iP;
    Subtree s = subtree_start();
    for (int i = 0; i < n_sub && !s.done(); ++i) {
      for (int d = tid; d < D; d += NT) {          // half kick, drift
        const float ph = p[d] - (0.5f * eps_w) * g[d];
        p[d] = ph;
        q[d] = q[d] + eps_w * (invm[d] * ph);
      }
      if (tid == 0) *helper_state = iC;
      __syncthreads();
      const float part = pot.eval(q, g);
      const LeafSlots ls = leaf_slots(i);
      float ke = 0.f;
      for (int d = tid; d < D; d += NT) {          // half kick, bookkeeping
        const float pn = p[d] - (0.5f * eps_w) * g[d];
        p[d] = pn;
        ke = fmaf(pn * pn, invm[d], ke);
        if (ls.even) {
          ckq[(size_t)ls.pc * D + d] = q[d];
          ckv[(size_t)ls.pc * D + d] = invm[d] * pn;
        }
      }
      // the leaf's sums over the owner warps: pe, |p|^2 and the U-turn dots
      // against its checkpoints
      float* rw = red + warp * MAXV;
      const float pw = warp_sum(part), kw = warp_sum(ke);
      if (lane == 0) {
        rw[0] = pw;
        rw[1] = kw;
      }
      for (int c = 0; c < ls.n_chk; ++c) {
        float x = 0.f, y = 0.f;
        for (int d = tid; d < D; d += NT) {
          const size_t o = (size_t)(ls.idx_min + c) * D + d;
          const float dq = (q[d] - ckq[o]) * sign_w;
          x = fmaf(dq, ckv[o], x);
          y = fmaf(dq, invm[d] * p[d], y);
        }
        x = warp_sum(x);
        y = warp_sum(y);
        if (lane == 0) {
          rw[2 + 2 * c] = x;
          rw[3 + 2 * c] = y;
        }
      }
      owner_sync(nw);
      float pe_leaf = 0.f, ke_leaf = 0.f;
      for (int w = 0; w < nw; ++w) {
        pe_leaf += red[w * MAXV];
        ke_leaf += red[w * MAXV + 1];
      }
      bool turn = false;
      for (int c = 0; c < ls.n_chk; ++c) {
        float x = 0.f, y = 0.f;
        for (int w = 0; w < nw; ++w) {
          x += red[w * MAXV + 2 + 2 * c];
          y += red[w * MAXV + 3 + 2 * c];
        }
        turn = turn || jmin(x, y) < 0.f;
      }
      const float lu = leaf_u[leaf_base + i];
      if (subtree_fold(s, pe_leaf + pot.cst, ke_leaf, T.h0, turn,
                       [lu] { return lu; }, A.div_threshold)) {
        float* t = pr + 2 * iS * D;                // progressive take
        for (int d = tid; d < D; d += NT) {
          t[d] = q[d];
          t[D + d] = g[d];
        }
      }
    }
    bool full_turn = false;
    if (!s.done()) {
      if (trajectory_merge(T, s, merge_u[dstep]))
        iP = iS;                                   // biased merge
      if (go_right) iR = iC; else iL = iC;
      const float *ql = st + 3 * iL * D, *qr = st + 3 * iR * D;
      float u2[2] = {0.f, 0.f};
      for (int d = tid; d < D; d += NT) {          // full-span U-turn
        const float dq = qr[d] - ql[d];
        u2[0] = fmaf(dq, invm[d] * ql[D + d], u2[0]);
        u2[1] = fmaf(dq, invm[d] * qr[D + d], u2[1]);
      }
      owner_sum(u2, nw, red2);
      full_turn = jmin(u2[0], u2[1]) < 0.f;
    }
    trajectory_close(T, s, full_turn);
  }
  if (tid == 0) *helper_state = -1;
  __syncthreads();                              // releases the helpers
  const float* t = pr + 2 * iP * D;
  for (int d = tid; d < D; d += NT) {
    A.q_out[row + d] = t[d];
    A.g_out[row + d] = t[D + d];
  }
  if (tid == 0) trajectory_write(A, chain, T);
}

// pe and grad of each chain with the kernel's own device function.
template <int NT, class Potential>
__global__ void __launch_bounds__(NT, 1)
potential_kernel(Potential pot, const float* q, float* pe_out,
                 float* g_out) {
  extern __shared__ __align__(16) float smem[];
  const int D = pot.dim();
  float* qs = pot.bind(smem);
  float* gs = qs + D;
  pot.load();
  const size_t row = (size_t)blockIdx.x * D;
  for (int d = threadIdx.x; d < D; d += NT) qs[d] = q[row + d];
  __syncthreads();
  pot.wait();
  const float pe = pot.eval(qs, gs);
  for (int d = threadIdx.x; d < D; d += NT) g_out[row + d] = gs[d];
  if (threadIdx.x == 0) pe_out[blockIdx.x] = pe + pot.cst;
}

// Floats of shared memory one potential block needs.
template <int NT>
__host__ __device__ size_t potential_smem_floats(int dim, size_t pot_floats) {
  return pot_floats + 2 * (size_t)dim;
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
