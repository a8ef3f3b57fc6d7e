// Whole-run fused hierarchical-logistic SVI trainer for Hopper (sm_90a),
// fp32 SIMT.
//
// Replaces bayesic_tpu/ops/fused_hier.py:_train_kernel (reached through
// fused_train).  One launch runs every step of the call: mean-field STL
// ELBO with the hand-derived gradient (ops/fused_hier.py:_step_math), then
// Adam at the cosine-decayed rate, for `steps` steps.  Streams come from
// Philox keyed by (seed, step) (ops/_kernel_common.hier_streams rebuilds
// them) or are injected (offsets and noise) for the parity checks.
//
// Design: one persistent block of NT = 1024 threads, as the TPU kernel runs
// one program (grid=(1,)).  Thread p < P = 2 + J + F owns flat parameter p:
// its loc, log-scale and both Adam moment pairs stay in registers for the
// whole run.  A step is
//   1. owners draw eps[p] and write z[p] to shared memory; thread 0 draws
//      the block offset;
//   2. every thread takes rows r = tid, tid + NT, ... of the circular block
//      (read from device memory; the data set is ~280 KB and stays in L2):
//      the logit, the log-likelihood and d elbo / d logit, summed per thread
//      into the feature gradients; the per-group sums go through per-warp
//      partial sums in shared memory: lanes with the same group
//      (__match_any_sync) hand their values to the lowest such lane, which
//      adds them in lane order;
//   3. owners of theta_j add the warps' partial sums for group j in warp
//      order; one block reduction (warp butterfly, then warps in order)
//      gives the likelihood, the mu and beta gradients, sum theta_j S_j and
//      the prior and log q terms;
//   4. owners form their gradients and run Adam; thread 0 writes the loss.
// No atomics: a run repeats bit for bit.  Every product is fp32 FFMA.
//
// What bounds it: not operations or bytes.  A step is ~35 k operations
// (4F + 14 for each of B = 1024 rows, F = 5) and reads ~28 KB of rows from
// L2, well under a microsecond of either; the step is a chain of four
// block barriers, two in-order reductions and an L2 read, so its time is
// the latency of that chain on one SM.  Measured: 4.9 us per step at the
// bench shape (chip_smoke.py phase 13, NVIDIA H100 80GB HBM3, 700 W).
// Several independent runs per launch (one block each) would use the other
// 131 SMs; one run cannot.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "kernel_common.cuh"

namespace {

constexpr int NT = 1024;             // threads, one block
constexpr int NWARPS = NT / 32;
constexpr int MAXF = 8;              // most features (ops/fused_hier.py)
constexpr int NV = 4 + MAXF;         // values of the step's block reduction
constexpr float kC = 0.91893853320467274f;        // 0.5 ln 2pi
constexpr float kLn5 = 1.6094379124341003f;
// HalfNormal(2) on tau: ln 2 - ln 2 - c, i.e. 0.5 ln(2/pi) - ln 2
constexpr float kTauConst = -0.91893853320467274f;
constexpr float kPi = 3.14159265358979323846f;

struct Args {
  const float *x, *y;
  const int* group;
  float *loc, *ls, *m1, *m2, *v1, *v2, *losses;
  const int* off_in;      // null: Philox offsets
  const float* eps_in;    // null: Philox noise
  int n, f, j, b, steps, thin, lr_total;
  long long t0;
  float lr0, scale;
  uint32_t k0, k1;
};

__host__ __device__ size_t smem_floats(int j, int p) {
  // z[P], per-warp group sums, per-warp staging, reduction scratch, totals
  return (size_t)p + (size_t)NWARPS * j + NWARPS * 32 + NWARPS * NV + NV;
}

__device__ __forceinline__ bt::U4 draw(unsigned long long t, int lane,
                                       uint32_t k0, uint32_t k1) {
  return bt::philox4x32_10(
      bt::U4{(uint32_t)t, 0u, (uint32_t)lane, (uint32_t)(t >> 32)}, k0, k1);
}

__global__ void __launch_bounds__(NT) hier_train_kernel(Args A) {
  extern __shared__ float sm[];
  const int J = A.j, F = A.f, P = 2 + J + F;
  float* zs = sm;                          // P
  float* part = zs + P;                    // NWARPS x J
  float* stage = part + NWARPS * J;        // NWARPS x 32
  float* red = stage + NWARPS * 32;        // NWARPS x NV
  float* tot = red + NWARPS * NV;          // NV
  __shared__ int s_off;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool own = tid < P;
  float loc = 0.f, ls = 0.f, m1 = 0.f, m2 = 0.f, v1 = 0.f, v2 = 0.f;
  if (own) {
    loc = A.loc[tid]; ls = A.ls[tid];
    m1 = A.m1[tid]; m2 = A.m2[tid]; v1 = A.v1[tid]; v2 = A.v2[tid];
  }

  for (int i = 0; i < A.steps; ++i) {
    const unsigned long long t = (unsigned long long)A.t0 + i;
    // -- 1. noise, z, block offset; clear this warp's group sums
    float eps = 0.f, z = 0.f;
    if (own) {
      if (A.eps_in) {
        eps = A.eps_in[(size_t)i * P + tid];
      } else {
        const bt::U4 w = draw(t, 1 + tid, A.k0, A.k1);
        eps = bt::box_muller(w.x, w.y);
      }
      z = fmaf(expf(ls), eps, loc);
      zs[tid] = z;
    }
    if (tid == 0) {
      s_off = A.off_in ? A.off_in[i]
                       : min((int)(bt::uniform24(draw(t, 0, A.k0, A.k1).x) *
                                   (float)A.n),
                             A.n - 1);
    }
    for (int g = lane; g < J; g += 32) part[warp * J + g] = 0.f;
    __syncthreads();

    // -- 2. the block's rows
    const float mu = zs[0], tau = expf(zs[1]);
    float bk[MAXF];
#pragma unroll
    for (int k = 0; k < MAXF; ++k) bk[k] = k < F ? zs[2 + J + k] : 0.f;
    float v[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = 0.f;
    const int off = s_off;
    for (int base = 0; base < A.b; base += NT) {   // uniform over the block
      const int r = base + tid;
      int g = -1;
      float gl = 0.f;
      if (r < A.b) {
        int row = off + r;
        if (row >= A.n) row -= A.n;
        const float* xr = A.x + (size_t)row * F;
        g = A.group[row];
        float xv[MAXF];
        float l = fmaf(tau, zs[2 + g], mu);
#pragma unroll
        for (int k = 0; k < MAXF; ++k) {
          xv[k] = k < F ? xr[k] : 0.f;
          l = fmaf(xv[k], bk[k], l);
        }
        const float yv = A.y[row];
        const float e = expf(-fabsf(l));
        v[0] += yv * l - (fmaxf(l, 0.f) + log1pf(e));
        const float sig = l >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
        gl = A.scale * (yv - sig);
        v[1] += gl;
#pragma unroll
        for (int k = 0; k < MAXF; ++k) v[4 + k] = fmaf(gl, xv[k], v[4 + k]);
      }
      // group sums: the lowest lane of each group adds its peers in order
      const unsigned peers = __match_any_sync(0xffffffffu, g);
      stage[warp * 32 + lane] = gl;
      __syncwarp();
      if (g >= 0 && lane == __ffs(peers) - 1) {
        float s = 0.f;
        for (unsigned m = peers; m; m &= m - 1)
          s += stage[warp * 32 + __ffs(m) - 1];
        part[warp * J + g] += s;
      }
      __syncwarp();
    }
    __syncthreads();

    // -- 3. per-group sums, prior and log q terms, one block reduction
    float seg = 0.f;
    if (own) {
      float term;                          // this parameter's lp - logq
      if (tid == 0) {
        term = -z * z / 50.f - kLn5 - kC;
      } else if (tid == 1) {
        term = kTauConst - tau * tau / 8.f + z;
      } else {
        term = -0.5f * z * z - kC;
      }
      if (tid >= 2 && tid < 2 + J) {
        for (int w = 0; w < NWARPS; ++w) seg += part[w * J + tid - 2];
        v[2] = z * seg;
      }
      v[3] = term - (-ls - 0.5f * eps * eps - kC);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float s = v[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) red[warp * NV + k] = s;
    }
    __syncthreads();
    if (tid < NV) {
      float s = 0.f;
      for (int w = 0; w < NWARPS; ++w) s += red[w * NV + tid];
      tot[tid] = s;
    }
    __syncthreads();

    // -- 4. gradients, Adam, loss
    if (own) {
      float g;
      if (tid == 0) {
        g = tot[1] - z / 25.f;
      } else if (tid == 1) {
        g = tau * tot[2] - tau * tau / 4.f + 1.f;
      } else if (tid < 2 + J) {
        g = tau * seg - z;
      } else {
        g = tot[4 + tid - 2 - J] - z;
      }
      g = fmaf(eps, expf(-ls), g);         // STL: -d logq / dz
      const float g_ls = g * eps * expf(ls);
      const float frac = fminf((float)t / (float)A.lr_total, 1.f);
      const float lr = A.lr0 * 0.5f * (1.f + cosf(kPi * frac));
      const float tt = (float)(t + 1);
      const float bc1 = 1.f - expf(tt * bt::kLnB1);
      const float bc2 = 1.f - expf(tt * bt::kLnB2);
      bt::adam_elem(loc, m1, v1, g, bc1, bc2, lr);
      bt::adam_elem(ls, m2, v2, g_ls, bc1, bc2, lr);
    }
    if (tid == 0) A.losses[i / A.thin] = -(A.scale * tot[0] + tot[3]);
  }
  if (own) {
    A.loc[tid] = loc; A.ls[tid] = ls;
    A.m1[tid] = m1; A.m2[tid] = m2; A.v1[tid] = v1; A.v2[tid] = v2;
  }
}

constexpr size_t kMaxSmem = 232448;   // 227 KB, the per-block maximum

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the trainer needs (0 = too many).
size_t fused_hier_smem_bytes(int f, int j) {
  const size_t b = 4 * smem_floats(j, 2 + j + f);
  return b > kMaxSmem ? 0 : b;
}

// Runs `steps` steps on `stream`.  loc/ls/m1/m2/v1/v2: (P,) flat vectors,
// P = 2 + J + F, updated in place.  off/eps: null for Philox streams keyed
// by `seed` with counter (t0+i, 0, lane, (t0+i) >> 32), else injected
// offsets (steps) and noise (steps*P).  losses[i / thin] = -elbo of step i
// (later steps overwrite).  Returns a cudaError_t (0 on success); launches
// only, never synchronises.
int fused_hier_train(const float* x, const float* y, const int* group,
                     float* loc, float* ls, float* m1, float* m2, float* v1,
                     float* v2, float* losses, const int* off,
                     const float* eps, int n, int f, int j, int b, int steps,
                     long long t0, int thin, float lr0, int lr_total,
                     float scale, unsigned long long seed, void* stream_ptr) {
  if (n <= 0 || f < 1 || f > MAXF || j < 1 || 2 + j + f > NT || b < 1 ||
      b > n || steps < 0 || thin < 1 || t0 < 0 || lr_total < 1)
    return cudaErrorInvalidValue;
  if (steps == 0) return cudaSuccess;
  const size_t bytes = fused_hier_smem_bytes(f, j);
  if (bytes == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hier_train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  Args A{x, y, group, loc, ls, m1, m2, v1, v2, losses, off, eps,
         n, f, j, b, steps, thin, lr_total, t0, lr0, scale,
         (uint32_t)seed, (uint32_t)(seed >> 32)};
  hier_train_kernel<<<1, NT, bytes, static_cast<cudaStream_t>(stream_ptr)>>>(
      A);
  return cudaGetLastError();
}

}  // extern "C"
