// Whole-run fused linear-regression SVI trainer for Hopper (sm_90a), fp32
// SIMT, bound by the latency of one step's dependent chain.
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
// What bounds it: latency.  A step is ~(D+2)^2 FMAs and ~200 operations a
// parameter, well under a microsecond of any of the card's rates, but it is
// a chain: z -> u exchange -> G u -> gradient -> Adam -> exp(ls) -> next z,
// on one SM, since one run is one block.  The first design ran the chain
// on 128 threads with G in shared memory: Philox, Box-Muller, the schedule
// and accurate exp/div/sqrt on the path, a 66-link FFMA chain per row and
// two block barriers a step (1.58 us a step at D = 64, about 2,800 cycles).
// This one keeps only the chain on the path:
//   1. Producer warps (NPW, two per SM sub-partition) fill a ring of R
//      steps ahead of the consumers: a step's eps[p] (Philox + Box-Muller,
//      or the injected rows) and its schedule, lr(t)/bc1(t) and 1/bc2(t).
//      They work in batches of BATCH steps over (step, parameter) items, so
//      every lane draws; one full and one empty mbarrier a batch hand the
//      batches over, so a consumer waits on a barrier once a batch and
//      otherwise only loads the slot of its next step.
//   2. Consumer warps hold G in registers: row r of G u belongs to KL
//      lanes of one warp, lane j of the row holding the NC float4 column
//      chunks j, j + KL, ... (NC a template argument, so the matvec is
//      straight-line code at every D).  A lane sums its
//      chunks in four FFMA accumulators (one per float4 component) and a
//      fixed-order xor butterfly over the KL lanes gives every lane of the
//      row the same (G u)[r]; the row's lanes then all run parameter r's
//      gradient and Adam, so no lane waits on another.
//   3. One consumer barrier a step (bar.sync 1, or __syncwarp for one
//      warp): u is double-buffered by the parity of the step, and the loss
//      of a write step (a fixed-order warp butterfly, then the warps summed
//      in order) is read by one thread after the next step's barrier.
//   4. Adam on the schedule made ahead and the .approx sqrt and rcp;
//      exp(ls) and exp(-ls) by ex2.approx right after the update, so the
//      next z waits on one FFMA.
// No atomics: a run repeats bit for bit.  u^T G u is a difference of large
// terms (y^T y ~ 1e6 against a residual ~ 4e3 at N = 16,384), so every
// product is an fp32 FFMA, never TF32; the tests hold it against a float64
// plain step and emulate this arithmetic (tests/test_torch_fused_linreg.py).
//
// Measured on an H100 SXM at 1,980 MHz (chip_smoke.py phase 22, N 16,384,
// D 64): 0.338 us a step, ~670 cycles, against 1.576 us before.  A probe
// instance (PROBE = true, fused_linreg_probe) stamps clock64() at the phase
// boundaries of sampled steps on consumer thread 0; its stamps slow those
// steps to ~800 cycles, of which the slot load ~170, z and the barrier ~30,
// the matvec and butterfly ~270, the gradient, Adam and exps ~345.  What
// each design step is worth, undone alone (tools/linreg_ablation.py, which
// rebuilds this file with textual edits; 0.335 us as shipped there): 4
// lanes a row (more warps to one barrier and sub-partition) 0.415 us; one
// consumer warp with whole rows in registers (spills) 0.935; accurate exp,
// sqrt and division on the chain 0.588; 4 producer warps 0.338.  One lane a
// row is 0.308 but holds G only while D + 2 <= 68.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "kernel_common.cuh"

namespace {

constexpr int KL = 2;          // lanes a row of G
constexpr int NPW = 8;         // producer warps
constexpr int R = 32;          // ring slots: steps made ahead
constexpr int BATCH = 16;      // steps a producer batch
constexpr int MAXD2 = 128;     // D + 2 <= 128, the JAX cap
constexpr int MAXU = 128;      // u and ring rows, padded
constexpr int RPW = 32 / KL;                        // rows a warp
constexpr int NCMAX = (MAXD2 + 4 * KL - 1) / (4 * KL);  // chunks a lane
constexpr int NBUF = R / BATCH;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(32 % KL == 0 && 4 * KL * NCMAX <= MAXU, "layout");
static_assert(R % BATCH == 0 && NBUF >= 2, "ring");

// consumer warps of the instance with NC chunks a lane
__host__ __device__ constexpr int cw_max(int nc) {
  return ((4 * KL * nc < MAXD2 ? 4 * KL * nc : MAXD2) + RPW - 1) / RPW;
}
static_assert(cw_max(NCMAX) + NPW <= 32, "block");

struct Args {
  const float* g;
  float *loc, *ls, *m1, *m2, *v1, *v2, *losses;
  const float* eps_in;    // null: Philox noise
  long long* probe;       // the probe instance's cycle sums
  int d, steps, thin, lr_total;
  long long t0;
  float lr0, inv_s2, ll_const;   // ll_const = n (ln s + 0.5 ln 2pi)
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}

// Returns once the phase of `b` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
  } while (!done);
}

template <int CW>
__device__ __forceinline__ void consumer_sync() {
  if constexpr (CW == 1)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;" ::"n"(32 * CW) : "memory");
}

__device__ __forceinline__ float exp_path(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fmul_rn(x, kLog2e)));
  return r;
}

// 1 / (sqrt(x) + 1e-8): Adam's denominator.
__device__ __forceinline__ float adam_rden(float x) {
  float s, r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(s) : "f"(x));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fadd_rn(s, 1e-8f)));
  return r;
}

// optax.adam(b1=.9, b2=.999, eps=1e-8) on loss = -elbo (g is d elbo), with
// c1 = lr / bc1 and c2 = 1 / bc2 made ahead by the producers.
__device__ __forceinline__ void adam(float& p, float& m, float& v, float g,
                                     float c1, float c2) {
  g = -g;
  m = fmaf(0.9f, m, __fmul_rn(0.1f, g));
  v = fmaf(0.999f, v, __fmul_rn(__fmul_rn(0.001f, g), g));
  p = fmaf(-__fmul_rn(c1, m), adam_rden(__fmul_rn(v, c2)), p);
}

// A lane's own value through a shuffle: ptxas keeps the result in a
// register, where it would re-derive a kernel parameter (LDC) or the
// thread index (S2R), both slow, on the step's path.
template <typename T>
__device__ __forceinline__ T pin(T v) {
  return __shfl_sync(0xffffffffu, v, threadIdx.x & 31);
}

// clock64 once `dep` is ready: the store waits for its operand.
__device__ __forceinline__ long long stamp_after(float dep, float* sink) {
  long long c;
  asm volatile("st.shared.f32 [%1], %2;\n\tmov.u64 %0, %%clock64;"
               : "=l"(c) : "r"(smem_u32(sink)), "f"(dep) : "memory");
  return c;
}

struct Smem {
  float u[2][MAXU];           // u = (z, -1, 0...), by the step's parity
  float eps[R][MAXU];         // the ring: a step's noise ...
  float2 sched[R];            // ... and (lr / bc1, 1 / bc2)
  float2 red[2][32];          // a write step's (q, lp - logq) warp sums
  uint64_t full[NBUF], empty[NBUF];
  float sink;
};

// Loss entry pend - 1 from a write step's warp sums, read after the next
// consumer barrier: -elbo = 0.5 q / s^2 + n (ln s + c) - sum(lp - logq).
template <int CW>
__device__ __forceinline__ void write_loss(const Args& A, const float2* red,
                                           int pend) {
  float q = 0.f, pq = 0.f;
  for (int k = 0; k < CW; ++k) {
    q += red[k].x;
    pq += red[k].y;
  }
  A.losses[pend - 1] = 0.5f * A.inv_s2 * q + A.ll_const - pq;
}

// Parameter q's noise at step t: Philox4x32-10 keyed by the seed at the
// counter (t, 0, 1 + q, t >> 32), then Box-Muller (kernel_common.cuh).
__device__ __forceinline__ float draw(const Args& A, unsigned long long t,
                                      int q) {
  const bt::U4 w = bt::philox4x32_10(
      bt::U4{(uint32_t)t, 0u, (uint32_t)(1 + q), (uint32_t)(t >> 32)}, A.k0,
      A.k1);
  return bt::box_muller(w.x, w.y);
}

// Item (b, q) of the batch in ring buffer buf: step b's eps[q] (q < P) or
// its schedule (q = P), (lr / bc1, 1 / bc2) at the cosine-decayed rate.
__device__ __forceinline__ void put(const Args& A, Smem& S, int buf, int b,
                                    int q, unsigned long long t, float e) {
  const int s = buf * BATCH + b;
  if (q < A.d + 1) {
    S.eps[s][q] = e;
  } else {
    const float frac = fminf((float)t / (float)A.lr_total, 1.f);
    const float lr = A.lr0 * 0.5f * (1.f + cosf(kPi * frac));
    const float tt = (float)(t + 1);
    const float bc1 = 1.f - expf(tt * bt::kLnB1);
    const float bc2 = 1.f - expf(tt * bt::kLnB2);
    S.sched[s] = make_float2(lr / bc1, 1.f / bc2);
  }
}

// Producer thread pt of 32 NPW: fills batch k (steps k BATCH ...) into
// ring buffer k % NBUF.  A batch is W = P + 1 items a step; the thread
// takes items pt, pt + 32 NPW, ... two at a time, so two Philox chains are
// in flight.
__device__ void produce(const Args& A, Smem& S, int pt) {
  constexpr int NPT = 32 * NPW;
  const int P = A.d + 1, W = P + 1;
  const int db = NPT / W, dq = NPT % W;      // the item stride in (b, q)
  const int nbatch = (A.steps + BATCH - 1) / BATCH;
  for (int k = 0; k < nbatch; ++k) {
    const int buf = k % NBUF, i0 = k * BATCH;
    const int nb = min(BATCH, A.steps - i0);
    const unsigned long long t0 = (unsigned long long)A.t0 + i0;
    mbar_wait(&S.empty[buf], ((k / NBUF) & 1) ^ 1);
    for (int b = pt / W, q = pt % W; b < nb;) {
      int b2 = b + db, q2 = q + dq;
      if (q2 >= W) { q2 -= W; ++b2; }
      float e, e2;
      if (A.eps_in) {
        e = q < P ? A.eps_in[(size_t)(i0 + b) * P + q] : 0.f;
        e2 = b2 < nb && q2 < P ? A.eps_in[(size_t)(i0 + b2) * P + q2] : 0.f;
      } else {
        e = draw(A, t0 + b, q);
        e2 = draw(A, t0 + b2, q2);
      }
      put(A, S, buf, b, q, t0 + b, e);
      if (b2 < nb) put(A, S, buf, b2, q2, t0 + b2, e2);
      b = b2 + db;
      q = q2 + dq;
      if (q >= W) { q -= W; ++b; }
    }
    mbar_arrive(&S.full[buf]);
  }
}

template <int NC, bool PROBE>
__device__ void consume(const Args& A, Smem& S, int tid) {
  constexpr int CW = cw_max(NC);
  const int D2 = A.d + 2, P = A.d + 1;
  const int lane = tid & 31, w = tid >> 5, j = lane % KL;
  // Lane state: row r of G and parameter r.  A row past the parameters
  // keeps z = loc fixed (-1 at row P, the y column; 0 past it: eps is 0
  // there and cm = 0 stops Adam), so every lane runs the step without a
  // predicate.
  const int r = w * RPW + lane / KL;
  float4 g[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    float e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * (j + KL * n) + k;
      e[k] = (r < D2 && c < D2) ? A.g[r * D2 + c] : 0.f;
    }
    g[n] = make_float4(e[0], e[1], e[2], e[3]);
  }
  const bool own = r < P;
  float loc = own ? A.loc[r] : (r == P ? -1.f : 0.f);
  float ls = own ? A.ls[r] : 0.f;
  float m1 = own ? A.m1[r] : 0.f, m2 = own ? A.m2[r] : 0.f;
  float v1 = own ? A.v1[r] : 0.f, v2 = own ? A.v2[r] : 0.f;
  const float cm = pin(own ? 1.f : 0.f);
  float* ust = &S.u[0][r];      // toggled between the u buffers
  const float* eld = &S.eps[0][r];
  const float* uld = &S.u[0][4 * j];
  int du = MAXU;                // to the other u buffer

  // step 0's slot
  mbar_wait(&S.full[0], 0);
  float eps = *eld, els = exp_path(ls), emls = exp_path(-ls);
  float2 sc = S.sched[0];
  const float nis = pin(-A.inv_s2);
  const int steps = pin(A.steps), lead = pin(tid == 0 ? 1 : 0);

  int par = 0, left = A.thin, pend = 0, slot = 0, inb = 0, batch = 0;
  long long ph[4] = {0, 0, 0, 0}, nsamp = 0, c0 = 0, c1 = 0, c2 = 0,
            c3 = 0, c4 = 0;
  const long long loop0 = PROBE ? clock64() : 0;
  for (int i = 0; i < steps; ++i) {
    const bool probing = PROBE && lead && i >= R && (i & 15) == 0;
    if (probing) c0 = clock64();
    // -- z, the u exchange: every lane of a row stores the same z
    const float z = fmaf(els, eps, loc);
    *ust = z;

    // -- the next step's slot, loaded while the barrier gathers the
    //    warps; at a batch's end, release it and wait for the next
    if (probing) c2 = clock64();
    float eps_n = 0.f;
    float2 sc_n = sc;
    if (i + 1 < steps) {
      if (++inb == BATCH) {
        mbar_arrive(&S.empty[batch % NBUF]);
        ++batch;
        inb = 0;
        mbar_wait(&S.full[batch % NBUF], (batch / NBUF) & 1);
      }
      int adv = MAXU;
      if (++slot == R) { slot = 0; adv -= R * MAXU; }
      eld += adv;
      eps_n = *eld;
      sc_n = S.sched[slot];
    }
    if (probing) c3 = clock64();
    consumer_sync<CW>();
    if (probing) c1 = clock64();
    float4 uv[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n)
      uv[n] = *reinterpret_cast<const float4*>(uld + 4 * KL * n);

    // -- (G u)[r]: four accumulators a lane, then the row's KL lanes
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      a0 = fmaf(g[n].x, uv[n].x, a0);
      a1 = fmaf(g[n].y, uv[n].y, a1);
      a2 = fmaf(g[n].z, uv[n].z, a2);
      a3 = fmaf(g[n].w, uv[n].w, a3);
    }
    float gu = __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
#pragma unroll
    for (int o = 1; o < KL; o <<= 1)
      gu = __fadd_rn(gu, __shfl_xor_sync(0xffffffffu, gu, o));
    if (probing) c4 = stamp_after(gu, &S.sink);

    // -- the loss, on the steps whose loss is kept: u^T G u over lane 0 of
    //    each row (u = z there, -1 at row P, 0 past it)
    const bool write = --left == 0 || i + 1 == steps;
    if (write) {                          // uniform over the consumers
      left = A.thin;
      float q = j == 0 ? z * gu : 0.f, pq = 0.f;
      if (j == 0 && own)
        pq = (-0.5f * z * z) - (-ls - 0.5f * eps * eps);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        q += __shfl_xor_sync(0xffffffffu, q, o);
        pq += __shfl_xor_sync(0xffffffffu, pq, o);
      }
      if (lane == 0) S.red[par][w] = make_float2(q, pq);
    }

    // -- STL gradient, Adam, the next step's exps
    const float g_z = fmaf(nis, gu, fmaf(eps, emls, -z));
    const float g_ls = g_z * __fmul_rn(eps, els);
    const float c1m = __fmul_rn(sc.x, cm);
    adam(loc, m1, v1, g_z, c1m, sc.y);
    adam(ls, m2, v2, g_ls, c1m, sc.y);
    els = exp_path(ls);
    emls = exp_path(-ls);
    eps = eps_n;
    ust += du;
    uld += du;
    du = -du;
    sc = sc_n;
    if (pend && lead) write_loss<CW>(A, S.red[par ^ 1], pend);
    pend = write ? i / A.thin + 1 : 0;
    par ^= 1;
    if (probing) {
      const long long c5 = stamp_after(els, &S.sink);
      ph[0] += c3 - c2;                   // the wait on the ring
      ph[1] += (c1 - c0) - (c3 - c2);     // z and the u exchange
      ph[2] += c4 - c1;                   // the matvec and the butterfly
      ph[3] += c5 - c4;                   // the loss, gradient and Adam
      ++nsamp;
    }
  }
  consumer_sync<CW>();
  if (pend && lead) write_loss<CW>(A, S.red[par ^ 1], pend);
  if (PROBE && lead) {
    const long long loop = clock64() - loop0;
    for (int k = 0; k < 4; ++k) A.probe[k] = ph[k];
    A.probe[4] = nsamp;
    A.probe[5] = loop;
  }
  if (j == 0 && own) {
    A.loc[r] = loc; A.ls[r] = ls;
    A.m1[r] = m1; A.m2[r] = m2; A.v1[r] = v1; A.v2[r] = v2;
  }
}

template <int NC, bool PROBE>
__global__ void __launch_bounds__(32 * (cw_max(NC) + NPW), 1)
    linreg_train_kernel(Args A) {
  __shared__ __align__(16) Smem S;
  const int tid = threadIdx.x, P = A.d + 1, ct = 32 * cw_max(NC);
  if (tid == 0) {
    for (int b = 0; b < NBUF; ++b) {
      mbar_init(&S.full[b], 32 * NPW);
      mbar_init(&S.empty[b], ct);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int k = tid; k < 2 * MAXU; k += blockDim.x)
    (&S.u[0][0])[k] = k % MAXU == P ? -1.f : 0.f;
  for (int k = tid; k < R * MAXU; k += blockDim.x)   // the rows past P
    if (k % MAXU >= P) (&S.eps[0][0])[k] = 0.f;
  __syncthreads();
  if (tid >= ct)
    produce(A, S, tid - ct);
  else
    consume<NC, PROBE>(A, S, tid);
}

// The instance with nc chunks a lane.
template <bool PROBE, int NC = 1>
cudaError_t launch_nc(int nc, const Args& A, cudaStream_t stream) {
  if constexpr (NC > NCMAX) {
    return cudaErrorInvalidValue;
  } else {
    if (nc != NC) return launch_nc<PROBE, NC + 1>(nc, A, stream);
    linreg_train_kernel<NC, PROBE>
        <<<1, 32 * (cw_max(NC) + NPW), 0, stream>>>(A);
    return cudaGetLastError();
  }
}

template <bool PROBE>
int launch(const float* g, float* loc, float* ls, float* m1, float* m2,
           float* v1, float* v2, float* losses, const float* eps, int d,
           int steps, long long t0, int thin, float lr0, int lr_total,
           float inv_s2, float ll_const, unsigned long long seed,
           long long* probe, void* stream_ptr) {
  const int d2 = d + 2, nc = ((d2 + 3) / 4 + KL - 1) / KL;
  if (d < 1 || d2 > MAXD2 || nc > NCMAX || steps < 0 ||
      thin < 1 || t0 < 0 || lr_total < 1 || (PROBE && !probe))
    return cudaErrorInvalidValue;
  if (steps == 0) return cudaSuccess;
  Args A{g, loc, ls, m1, m2, v1, v2, losses, eps, probe, d, steps, thin,
         lr_total, t0, lr0, inv_s2, ll_const, (uint32_t)seed,
         (uint32_t)(seed >> 32)};
  return launch_nc<PROBE>(nc, A, static_cast<cudaStream_t>(stream_ptr));
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
  return launch<false>(g, loc, ls, m1, m2, v1, v2, losses, eps, d, steps, t0,
                       thin, lr0, lr_total, inv_s2, ll_const, seed, nullptr,
                       stream_ptr);
}

// The same run through the probe instance: probe (6 int64) receives the
// cycles of consumer thread 0 summed over the sampled steps (every 16th
// from step R on) in four phases (the wait on the ring, z and the u
// exchange, the matvec and the butterfly, the loss, gradient and Adam), the
// number of sampled steps and the cycles of the whole step loop.
int fused_linreg_probe(const float* g, float* loc, float* ls, float* m1,
                       float* m2, float* v1, float* v2, float* losses,
                       const float* eps, int d, int steps, long long t0,
                       int thin, float lr0, int lr_total, float inv_s2,
                       float ll_const, unsigned long long seed,
                       long long* probe, void* stream_ptr) {
  return launch<true>(g, loc, ls, m1, m2, v1, v2, losses, eps, d, steps, t0,
                      thin, lr0, lr_total, inv_s2, ll_const, seed, probe,
                      stream_ptr);
}

}  // extern "C"
