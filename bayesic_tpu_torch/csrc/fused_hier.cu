// Whole-run fused hierarchical-logistic SVI trainer for Hopper (sm_90a),
// fp32 SIMT, bound by the latency of one step's dependent chain.
//
// Replaces bayesic_tpu/ops/fused_hier.py:_train_kernel (reached through
// fused_train).  One launch runs every step of the call: the mean-field STL
// ELBO on a circular block of B rows with the hand-derived gradient
// (ops/fused_hier.py:_step_math), then Adam at the cosine-decayed rate, for
// `steps` steps.  Streams come from Philox keyed by (seed, step) with the
// counter (t_lo, 0, lane, t_hi): lane 0 the block offset, lane 1 + p the
// noise of parameter p (ops/_kernel_common.hier_streams rebuilds them), or
// are injected (offsets and noise) for the parity checks.
//
// What bounds it: latency.  A step is ~35 k operations (4F + 14 for each of
// B = 1024 rows at F = 5) and ~28 KB of rows, well under a microsecond of
// any of the card's rates, but one run is one block on one SM, and each
// step is a chain: z -> every row's logit -> sums over the rows and over
// each group's rows -> gradient -> Adam -> next z.  The first design ran
// that chain on 1,024 threads with everything that depends only on t on it
// (Philox, Box-Muller, the schedule, the offset, the rows read from L2
// through it), per-group sums by __match_any_sync and four block barriers
// a step: 4.9 us a step at the bench shape.  This one keeps only the chain
// on the path:
//   1. Producer warps (NPW, one per ring slot) make each step ahead of the
//      consumers: its block offset, its noise eps[p] (Philox + Box-Muller,
//      or the injected rows) and its schedule (lr / bc1, 1 / bc2); one lane
//      copies the step's rows into the slot by cp.async.bulk.  A full
//      mbarrier a slot (the producer warp's 32 arrivals and the copy's
//      bytes) and an empty one (the consumer warps, at the step's end) hand
//      the slots over; a waiting producer backs off with __nanosleep.
//   2. The rows, packed once a call by the wrapper (ops/fused_hier.
//      pack_rows), lie in tiles of 32 rows of F + 2 planes: x, y + 2 group
//      in one word, and the tile's group order (below).  A window is one
//      contiguous run of tiles, staged whole.  Consumer warp w takes tiles
//      w, w + CW, ..., a lane one row of each (rows outside the window add
//      zeros): a warp reads 32 consecutive words of a plane, no bank
//      conflict at any F.  Where the slots do not fit in shared memory the
//      instance that reads the same tiles from L2 (RES false, chosen by
//      shape only) runs the same arithmetic in the same order.
//   3. Per-group sums by a segmented scan: pack_rows sorts each tile's rows
//      by group (stable) once a call and stores, for position l of that
//      order, the lane of its row, the first position of its group's
//      segment, whether l ends the segment and the rounds the tile's
//      longest segment needs.  A warp gathers the rows' d in that order
//      (one shuffle), scans each segment (Hillis-Steele, at most five
//      shuffles, two to four at the bench) and the segment's last lane adds
//      the total to the warp's partial of the group in shared memory, tile
//      after tile; theta_j's owner adds the CW warps' partials in warp
//      order.  A fixed order throughout: no atomics, no __match_any_sync
//      (~1 us a call, stalling the pipe the loads share), and a run repeats
//      bit for bit.  (Segment sums through shared memory instead of the
//      scan ran slower.)
//   4. The row loop runs on the SFU in the log2 domain with gmm_lik.cuh's
//      helpers, as the hier NUTS kernel's does: e = exp(-|l|) one
//      ex2.approx, sigmoid one rcp.approx of 1 + e, log1p(e) one lg2.approx
//      of the product of kChunk rows' 1 + e, y folded into the sign of the
//      logit; the value's sums only on the steps whose loss is kept.  A
//      thread sums d = sigmoid(l) - y, theta_g d and d x beside it, so tau's
//      gradient (sum_j theta_j S_j = sum_r theta_g d_r) does not wait for the
//      group sums.
//   5. Two consumer barriers a step: z published, and the warps' sums and
//      group partials published.  A warp's sums go through its staging
//      rows in shared memory (publish), then every owner reads its CW warp
//      values itself (mu, tau, beta from the sums, theta_j from the
//      partials), so no barrier publishes totals.  Adam on the schedule
//      made ahead with the .approx sqrt and rcp; exp(+-ls) by ex2.approx
//      right after the update, so the next z waits on one FFMA.  A thread
//      of the last consumer warp writes the loss.
//   6. The step's code is kept short (one row-pass body, one parameter a
//      consumer thread in registers, the parameters past CT in shared
//      memory by a plain loop): a step loop unrolled four ways ran slower.
// Every product is fp32 FFMA; the tests hold the arithmetic, emulated at
// the PTX ISA bounds of the .approx functions in this order, against a
// float64 step (tests/test_torch_fused_hier.py).
//
// A probe instance (PROBE true, fused_hier_probe) stamps clock64() at the
// phase boundaries of sampled steps on consumer thread 2 (theta_0's owner);
// the shipped instances carry no stamps.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "gmm_lik.cuh"
#include "kernel_common.cuh"

namespace {

constexpr int CW = 8;              // consumer warps
constexpr int NPW = 4;             // producer warps, one ring slot each
constexpr int R = NPW;             // ring slots: steps made ahead
constexpr int CT = 32 * CW;        // consumer threads
constexpr int NT = 32 * (CW + NPW);
constexpr int MAXF = 8;            // most features (ops/fused_hier.py)
constexpr int MAXP = 1024;         // most parameters, 2 + J + F
constexpr unsigned kIdleNs = 200;  // a waiting producer's back-off
constexpr uint32_t kCopyPiece = 32768;       // bytes of one bulk copy
constexpr size_t kMaxSmem = 232448;          // 227 KB, the per-block maximum
constexpr float kC = 0.91893853320467274f;   // 0.5 ln 2pi
constexpr float kLn5 = 1.6094379124341003f;
// HalfNormal(2) on tau: ln 2 - ln 2 - c, i.e. 0.5 ln(2/pi) - ln 2
constexpr float kTauConst = -0.91893853320467274f;
constexpr double kPi = 3.14159265358979323846;
constexpr double kLnB1 = -0.10536051565782628;    // ln 0.9
constexpr double kLnB2 = -0.0010005003335835335;  // ln 0.999
constexpr int kPhases = 7;         // the probe's phases
// a warp's staging floats: its sums' rows of 33 (at most 4 + MAXF of them)
constexpr int kStage = 33 * (4 + MAXF);

struct Args {
  const float* tiles;     // pack_rows: (ntile, F + 2, 32)
  float *loc, *ls, *m1, *m2, *v1, *v2, *losses;
  const int* off_in;      // null: Philox offsets
  const float* eps_in;    // null: Philox noise
  long long* probe;       // the probe instance's cycle sums
  int n, j, b, steps, thin, lr_total;
  long long t0;
  float lr0, scale;
  uint32_t k0, k1;
};

__host__ __device__ constexpr size_t up128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Byte offsets of the dynamic shared memory at (J, B).  A ring slot holds
// a step's tiles (RES), noise, schedule and offset.
template <int F, bool RES>
struct Layout {
  static constexpr int NV = 4 + F;   // a warp's sums
  int p, j, b;
  size_t eps, misc, slot;             // in a slot: the tiles from 0
  size_t bars, zs, red, part, ext, stage, sink, total;

  __host__ __device__ Layout(int j_, int b_) : p(2 + j_ + F), j(j_), b(b_) {
    eps = RES ? (size_t)((b + 62) / 32) * (F + 2) * 128 : 0;
    misc = (eps + 4 * (size_t)p + 7) / 8 * 8;   // float2 schedule, offset
    slot = up128(misc + 16);
    bars = R * slot;                  // full[R], empty[R]
    zs = bars + 16 * R;               // z[P], then tau
    red = (zs + 4 * (size_t)(p + 1) + 15) / 16 * 16;
    part = red + 4 * (size_t)CW * NV;
    ext = part + 4 * (size_t)CW * j;
    stage = ext + 4 * (size_t)6 * (p > CT ? p - CT : 0);
    sink = stage + 4 * (size_t)CW * kStage;
    total = sink + 16;
  }
};

template <int F, bool RES>
struct Slot {
  const float* rows;   // RES: the window's tiles; else null
  float* eps;
  float2* sched;
  int* off;

  __device__ Slot(unsigned char* sm, const Layout<F, RES>& L, int s) {
    unsigned char* b = sm + (size_t)s * L.slot;
    rows = RES ? reinterpret_cast<const float*>(b) : nullptr;
    eps = reinterpret_cast<float*>(b + L.eps);
    sched = reinterpret_cast<float2*>(b + L.misc);
    off = reinterpret_cast<int*>(b + L.misc + 8);
  }
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

__device__ __forceinline__ bool mbar_try(uint64_t* b, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
  return done;
}

// Returns once the phase of `b` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  while (!mbar_try(b, parity)) {
  }
}

// The producers' wait: they run steps ahead, so a failed try backs off
// rather than issue try after try into the pipe the consumers' loads and
// shuffles use.
__device__ __forceinline__ void mbar_wait_idle(uint64_t* b, uint32_t parity) {
  while (!mbar_try(b, parity)) __nanosleep(kIdleNs);
}

// One lane: the copy of [src, src + bytes) into dst, completing on `bar`,
// which expects its bytes besides its arrivals.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;"
               ::"r"(b), "r"(bytes) : "memory");
  for (uint32_t o = 0; o < bytes; o += kCopyPiece) {
    const uint32_t n = bytes - o < kCopyPiece ? bytes - o : kCopyPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(static_cast<char*>(dst) + o)),
        "l"(static_cast<const char*>(src) + o), "r"(n), "r"(b)
        : "memory");
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CT) : "memory");
}

// The warp's totals of v[K0 .. K0 + N) into red[K0 ..]: each lane stores
// its values in the warp's staging rows (a row of 33 a value, so neither
// the stores nor the loads conflict), and lane k < N adds the 32 of value
// k in four accumulators, lane l into accumulator l % 4, then
// (a0 + a1) + (a2 + a3): a store and eight loads a lane, where a
// butterfly waits on five dependent rounds of shuffles, each slow on the
// pipe the loads share (tools/hier_train_ablation.py times one).  Returns
// lane k's total.
template <int K0, int N, int NV>
__device__ __forceinline__ float publish(const float (&v)[NV], float* stage,
                                         float* red, int lane) {
#pragma unroll
  for (int k = 0; k < N; ++k) stage[k * 33 + lane] = v[K0 + k];
  __syncwarp();
  float t = 0.f;
  if (lane < N) {
    const float* row = stage + lane * 33;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int l = 0; l < 32; l += 4) {
      a0 += row[l];
      a1 += row[l + 1];
      a2 += row[l + 2];
      a3 += row[l + 3];
    }
    t = (a0 + a1) + (a2 + a3);
    red[K0 + lane] = t;
  }
  return t;
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

__device__ __forceinline__ float exp_path(float x) {
  return ex2_approx(__fmul_rn(x, kLog2e));
}

// clock64 once `dep` is ready: the store waits for its operand.
__device__ __forceinline__ long long stamp_after(float dep, float* sink) {
  long long c;
  asm volatile("st.shared.f32 [%1], %2;\n\tmov.u64 %0, %%clock64;"
               : "=l"(c) : "r"(smem_u32(sink)), "f"(dep) : "memory");
  return c;
}

__device__ __forceinline__ bt::U4 draw(unsigned long long t, int lane,
                                       uint32_t k0, uint32_t k1) {
  return bt::philox4x32_10(
      bt::U4{(uint32_t)t, 0u, (uint32_t)lane, (uint32_t)(t >> 32)}, k0, k1);
}

// One warp makes step i into slot w = i % R.
template <int F, bool RES>
__device__ void produce_step(const Args& A, unsigned char* sm,
                             const Layout<F, RES> L, int w, int lane,
                             int i) {
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + R;
  const Slot<F, RES> s(sm, L, w);
  const int P = L.p;
  mbar_wait_idle(&empty[w], ((i / R) & 1) ^ 1);
  const unsigned long long t = (unsigned long long)A.t0 + i;
  if (lane == 0) {
    const int off =
        A.off_in ? A.off_in[i]
                 : min((int)(bt::uniform24(draw(t, 0, A.k0, A.k1).x) *
                             (float)A.n),
                       A.n - 1);
    *s.off = off;
    // in float64, as the plain version's Python floats: 1 - 0.999^(t+1)
    // in float32 cancels (a relative error of 1.3e-5 at t = 0)
    const double frac = fmin((double)t / (double)A.lr_total, 1.0);
    const double lr = A.lr0 * 0.5 * (1.0 + cos(kPi * frac));
    const double bc1 = -expm1((double)(t + 1) * kLnB1);
    const double bc2 = -expm1((double)(t + 1) * kLnB2);
    *s.sched = make_float2((float)(lr / bc1), (float)(1.0 / bc2));
    if constexpr (RES) {
      const int c0 = off >> 5, nt = ((off + A.b - 1) >> 5) - c0 + 1;
      bulk_copy(sm + (size_t)w * L.slot,
                A.tiles + (size_t)c0 * (F + 2) * 32,
                (uint32_t)nt * (F + 2) * 128, &full[w]);
    }
  }
  for (int p = lane; p < P; p += 32) {
    float e;
    if (A.eps_in) {
      e = A.eps_in[(size_t)i * P + p];
    } else {
      const bt::U4 u = draw(t, 1 + p, A.k0, A.k1);
      e = bt::box_muller(u.x, u.y);
    }
    s.eps[p] = e;
  }
  __syncwarp();
  mbar_arrive(&full[w]);
}

// Producer warp w: steps w, w + R, ... into slot w.
template <int F, bool RES>
__device__ void produce(const Args& A, unsigned char* sm,
                        const Layout<F, RES> L, int w, int lane) {
  for (int i = w; i < A.steps; i += R)
    produce_step<F, RES>(A, sm, L, w, lane, i);
}

// Warp w's tiles tt = w, w + CW, ... < nt of the window (its first row at
// lane s0 of tile 0 of xs), lane l holding row 32 tt + l - s0 (a zero
// outside [0, B)).  Adds to v (NV sums: 0 the softplus sum, on a write
// step (ll), 2 sum d, 3 sum theta_g d, 4 + k sum d x_k) and, tile after
// tile, each group segment's total of d to part[g].  Each kChunk tiles of
// a thread share one lg2 of their rows' 1 + e product.
template <int F, bool RES>
__device__ __forceinline__ void row_pass(const float* xs, const float* th_z,
                                         float* part, float mu, float tau,
                                         const float (&bk)[F], int s0,
                                         int nt, int w, int lane, int B,
                                         bool ll, float (&v)[4 + F]) {
  const int* ws = reinterpret_cast<const int*>(xs);
  float lik2 = 0.f, prod = 1.f;
  int m = 0;                          // the thread's tiles so far
  for (int tt = w; tt < nt; tt += CW) {
    const int base = tt * (F + 2) * 32 + lane;
    float xv[F];
#pragma unroll
    for (int k = 0; k < F; ++k)
      xv[k] = RES ? xs[base + 32 * k] : __ldg(xs + base + 32 * k);
    const int yg = RES ? ws[base + 32 * F] : __ldg(ws + base + 32 * F);
    const int sw = RES ? ws[base + 32 * (F + 1)]
                       : __ldg(ws + base + 32 * (F + 1));
    const int r = 32 * tt + lane - s0;
    const bool in = (unsigned)r < (unsigned)B;
    const float th = th_z[yg >> 1];
    float l = fmaf(tau, th, mu);
#pragma unroll
    for (int k = 0; k < F; ++k) l = fmaf(xv[k], bk[k], l);
    const bool yv = yg & 1;
    const float lv = yv ? -l : l;
    const float e = ex2_approx(-fabsf(l) * kLog2e);
    const float opl = 1.f + e;
    if (ll && in) {
      prod *= opl;
      v[0] += fmaxf(lv, 0.f);
    }
    if (ll && ++m % kChunk == 0) {
      lik2 += lg2_approx(prod);
      prod = 1.f;
    }
    const float rc = rcp_approx(opl);
    const float sg = lv >= 0.f ? rc : e * rc;      // sigmoid(l')
    const float d = in ? (yv ? -sg : sg) : 0.f;    // sigmoid(l) - y
    v[2] += d;
    v[3] = fmaf(th, d, v[3]);
#pragma unroll
    for (int k = 0; k < F; ++k) v[4 + k] = fmaf(d, xv[k], v[4 + k]);
    // the tile's rows by group: position `lane` of its group order holds
    // the row of lane sw & 31, its segment starts at (sw >> 5) & 31, no
    // segment of the tile is longer than 2^(sw >> 21); round o adds the
    // value o places back while it is in the segment, and the segment's
    // last position (bit 10) adds the total to the group's partial
    float x = __shfl_sync(0xffffffffu, d, sw & 31);
    const int lo = lane - ((sw >> 5) & 31), span = 1 << (sw >> 21);
    for (int o = 1; o < span; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, x, o);
      if (o <= lo) x += up;
    }
    if (sw & 1024) part[(sw >> 11) & 1023] += x;
    __syncwarp();
  }
  if (ll) {
    if (m % kChunk) lik2 += lg2_approx(prod);
    v[0] = fmaf(kLn2, lik2, v[0]);
  }
}

// Parameter p's lp - log q term of the loss (z = loc + e^ls eps).
__device__ __forceinline__ float loss_term(int p, float z, float ls,
                                           float eps, float tau) {
  float term;
  if (p == 0)
    term = -z * z / 50.f - kLn5 - kC;
  else if (p == 1)
    term = kTauConst - tau * tau / 8.f + z;
  else
    term = -0.5f * z * z - kC;
  return term - (-ls - 0.5f * eps * eps - kC);
}

// Parameter p's elbo gradient at z from s, its CW warp values summed: mu,
// tau and beta_k from the warps' sums, theta_j from their group partials.
__device__ __forceinline__ float grad(int p, int J, float s, float z,
                                      float tau, float nscale) {
  if (p == 0) return fmaf(nscale, s, -z * 0.04f);
  if (p == 1) return fmaf(tau, nscale * s, fmaf(-0.25f * tau, tau, 1.f));
  if (p < 2 + J) return fmaf(tau, nscale * s, -z);
  return fmaf(nscale, s, -z);
}

// Where parameter p reads its CW warp values: {first, stride}.
template <int NV>
__device__ __forceinline__ int2 source(int p, int J, int red, int part) {
  if (p >= 2 && p < 2 + J) return make_int2(part + p - 2, J);
  return make_int2(red + (p < 2 ? 2 + p : 4 + p - 2 - J), NV);
}

// The STL gradient of (loc, ls) from the elbo gradient g at z, then Adam.
__device__ __forceinline__ void update(float& loc, float& ls, float& m1,
                                       float& m2, float& v1, float& v2,
                                       float g, float eps, float els,
                                       float emls, float2 sc) {
  g = fmaf(eps, emls, g);                       // STL: -d logq / dz
  const float g_ls = g * __fmul_rn(eps, els);
  adam(loc, m1, v1, g, sc.x, sc.y);
  adam(ls, m2, v2, g_ls, sc.x, sc.y);
}

// Consumer thread tid owns parameter tid in registers and, where P > CT,
// the parameters tid + CT, tid + 2 CT, ... with their state in shared
// memory (ext: loc, ls, m1, m2, v1, v2 of each).
template <int F, bool RES, bool PROBE>
__device__ void consume(const Args& A, unsigned char* sm,
                        const Layout<F, RES> L, int tid) {
  constexpr int NV = Layout<F, RES>::NV;
  const int lane = tid & 31, w = tid >> 5;
  const int P = L.p, J = L.j, B = A.b, steps = A.steps;
  const float scale = A.scale, nscale = -A.scale;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + R;
  float* f32 = reinterpret_cast<float*>(sm);
  float* zs = reinterpret_cast<float*>(sm + L.zs);
  float* red = reinterpret_cast<float*>(sm + L.red);
  float* part = reinterpret_cast<float*>(sm + L.part);
  float* ext = reinterpret_cast<float*>(sm + L.ext);
  float* stage = reinterpret_cast<float*>(sm + L.stage);
  float* sink = reinterpret_cast<float*>(sm + L.sink);

  const bool own = tid < P;
  float loc = own ? A.loc[tid] : 0.f, ls = own ? A.ls[tid] : 0.f;
  float m1 = own ? A.m1[tid] : 0.f, m2 = own ? A.m2[tid] : 0.f;
  float v1 = own ? A.v1[tid] : 0.f, v2 = own ? A.v2[tid] : 0.f;
  for (int p = tid + CT; p < P; p += CT) {
    float* e = ext + 6 * (p - CT);
    e[0] = A.loc[p]; e[1] = A.ls[p];
    e[2] = A.m1[p]; e[3] = A.m2[p]; e[4] = A.v1[p]; e[5] = A.v2[p];
  }
  const int2 src = source<NV>(tid, J, (int)(L.red / 4), (int)(L.part / 4));
  mbar_wait(&full[0], 0);
  Slot<F, RES> cur(sm, L, 0);
  float eps = own ? cur.eps[tid] : 0.f;
  float els = exp_path(ls), emls = exp_path(-ls);

  int left = A.thin;
  long long ph[kPhases] = {}, nsamp = 0, c[kPhases + 1] = {};
  const long long loop0 = PROBE ? clock64() : 0;
  for (int i = 0; i < steps; ++i) {
    const int si = i % R;
    const bool probing = PROBE && tid == 2 && i >= R && (i & 15) == 0;
    const bool write = --left == 0 || i + 1 == steps;   // uniform
    if (write) left = A.thin;
    if (probing) c[0] = clock64();

    // -- z published; this thread's lp - log q terms on a write step
    float tq = 0.f, z = 0.f, tau_own = 0.f;
    if (own) {
      z = fmaf(els, eps, loc);
      zs[tid] = z;
      if (tid == 1) {
        tau_own = exp_path(z);
        zs[P] = tau_own;
      }
      if (write) tq = loss_term(tid, z, ls, eps, tau_own);
    }
    for (int p = tid + CT; p < P; p += CT) {
      const float* e = ext + 6 * (p - CT);
      const float ep = cur.eps[p];
      zs[p] = fmaf(exp_path(e[1]), ep, e[0]);
      if (write) tq += loss_term(p, zs[p], e[1], ep, 0.f);
    }
    const float2 sc = *cur.sched;
    const int off = *cur.off;
    consumer_sync();
    if (probing) c[1] = clock64();
    // the warp's group partials, read by the last step's owners before the
    // barrier
    for (int g = lane; g < J; g += 32) part[w * J + g] = 0.f;
    __syncwarp();

    // -- the window's rows
    const float mu = zs[0], tau = zs[P];
    float bk[F];
#pragma unroll
    for (int k = 0; k < F; ++k) bk[k] = zs[2 + J + k];
    const int s0 = off & 31, nt = ((s0 + B - 1) >> 5) + 1;
    const float* xs = RES ? cur.rows
                          : A.tiles + (size_t)(off >> 5) * (F + 2) * 32;
    float v[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = 0.f;
    v[1] = tq;
    row_pass<F, RES>(xs, zs + 2, part + w * J, mu, tau, bk, s0, nt, w, lane,
                     B, write, v);
    if (probing) c[2] = stamp_after(v[2], sink);

    // -- the warp's sums, published through its staging rows (the value's
    //    two only on a write step)
    const float pub =
        write ? publish<0, NV>(v, stage + w * kStage, red + w * NV, lane)
              : publish<2, NV - 2>(v, stage + w * kStage, red + w * NV, lane);
    if (probing) c[3] = stamp_after(pub, sink);

    // -- the next step's slot, loaded while the barrier gathers the warps
    float eps_n = 0.f;
    Slot<F, RES> nxt = cur;
    if (i + 1 < steps) {
      mbar_wait(&full[(i + 1) % R], ((i + 1) / R) & 1);
      nxt = Slot<F, RES>(sm, L, (i + 1) % R);
      if (own) eps_n = nxt.eps[tid];
    }
    if (probing) c[4] = clock64();
    consumer_sync();
    if (probing) c[5] = clock64();

    // -- the owners: the CW warp values in warp order, the gradient, Adam
    //    and the next step's exps
    if (own) {
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < CW; ++ww) s += f32[src.x + ww * src.y];
      const float g = grad(tid, J, s, z, tau, nscale);
      if (probing) c[6] = stamp_after(g, sink);
      update(loc, ls, m1, m2, v1, v2, g, eps, els, emls, sc);
      els = exp_path(ls);
      emls = exp_path(-ls);
    }
    for (int p = tid + CT; p < P; p += CT) {
      float* e = ext + 6 * (p - CT);
      const int2 sp = source<NV>(p, J, (int)(L.red / 4), (int)(L.part / 4));
      float s = 0.f;
      for (int ww = 0; ww < CW; ++ww) s += f32[sp.x + ww * sp.y];
      const float g = grad(p, J, s, zs[p], tau, nscale);
      update(e[0], e[1], e[2], e[3], e[4], e[5], g, cur.eps[p],
             exp_path(e[1]), exp_path(-e[1]), sc);
    }
    if (probing) c[7] = stamp_after(els, sink);
    if (write && tid == CT - 1) {       // the loss, off the owners' chain
      float ll = 0.f, pq = 0.f;
      for (int ww = 0; ww < CW; ++ww) {
        ll += red[ww * NV];
        pq += red[ww * NV + 1];
      }
      A.losses[i / A.thin] = fmaf(scale, ll, -pq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[si]);
    cur = nxt;
    eps = eps_n;
    if (probing) {
      // z and barrier 1, row pass, warp sums, slot wait, barrier 2, the
      // group and total sums, Adam and exps
#pragma unroll
      for (int k = 0; k < kPhases; ++k) ph[k] += c[k + 1] - c[k];
      ++nsamp;
    }
  }
  if (PROBE && tid == 2) {
    const long long loop = clock64() - loop0;
    for (int k = 0; k < kPhases; ++k) A.probe[k] = ph[k];
    A.probe[kPhases] = nsamp;
    A.probe[kPhases + 1] = loop;
  }
  if (own) {
    A.loc[tid] = loc; A.ls[tid] = ls;
    A.m1[tid] = m1; A.m2[tid] = m2; A.v1[tid] = v1; A.v2[tid] = v2;
  }
  for (int p = tid + CT; p < P; p += CT) {
    const float* e = ext + 6 * (p - CT);
    A.loc[p] = e[0]; A.ls[p] = e[1];
    A.m1[p] = e[2]; A.m2[p] = e[3]; A.v1[p] = e[4]; A.v2[p] = e[5];
  }
}

template <int F, bool RES, bool PROBE>
__global__ void __launch_bounds__(NT, 1) hier_train_kernel(Args A) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout<F, RES> L(A.j, A.b);
  const int tid = threadIdx.x;
  if (tid == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
    for (int s = 0; s < R; ++s) {
      mbar_init(&bars[s], 32);          // full: the producer warp's lanes
      mbar_init(&bars[R + s], CW);      // empty: the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= CT)
    produce<F, RES>(A, sm, L, (tid - CT) >> 5, tid & 31);
  else
    consume<F, RES, PROBE>(A, sm, L, tid);
}

template <int F, bool RES>
size_t smem_bytes(int j, int b) {
  return Layout<F, RES>(j, b).total;
}

// Calls fn(std::integral_constant<int, F>) for F = f.
template <class Fn>
int with_features(int f, Fn fn) {
  switch (f) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 5: return fn(std::integral_constant<int, 5>{});
    case 6: return fn(std::integral_constant<int, 6>{});
    case 7: return fn(std::integral_constant<int, 7>{});
    case 8: return fn(std::integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

bool bad_shape(int n, int f, int j, int b) {
  return n <= 0 || f < 1 || f > MAXF || j < 1 || 2 + j + f > MAXP || b < 1 ||
         b > n || (long long)n + b > (1LL << 30);
}

// {threads, bytes of dynamic shared memory, 1 if the rows are staged in it
// (0: read from L2)}: the rows are staged whenever the slots fit.
int geometry(int f, int j, int b, long long* out) {
  return with_features(f, [&](auto fc) {
    constexpr int F = decltype(fc)::value;
    const size_t res = smem_bytes<F, true>(j, b);
    const bool staged = res <= kMaxSmem;
    const size_t bytes = staged ? res : smem_bytes<F, false>(j, b);
    if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    out[0] = NT;
    out[1] = (long long)bytes;
    out[2] = staged;
    return (int)cudaSuccess;
  });
}

template <bool PROBE>
int launch(const float* tiles, float* loc, float* ls, float* m1, float* m2,
           float* v1, float* v2, float* losses, const int* off,
           const float* eps, long long* probe, int n, int f, int j, int b,
           int steps, long long t0, int thin, float lr0, int lr_total,
           float scale, unsigned long long seed, void* stream_ptr) {
  if (bad_shape(n, f, j, b) || steps < 0 || thin < 1 || t0 < 0 ||
      lr_total < 1 || (PROBE && !probe) ||
      (reinterpret_cast<uintptr_t>(tiles) & 15) != 0)
    return cudaErrorInvalidValue;
  if (steps == 0) return cudaSuccess;
  const Args A{tiles, loc, ls, m1, m2, v1, v2, losses, off, eps, probe,
               n, j, b, steps, thin, lr_total, t0, lr0, scale,
               (uint32_t)seed, (uint32_t)(seed >> 32)};
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  return with_features(f, [&](auto fc) {
    constexpr int F = decltype(fc)::value;
    const auto run = [&](auto rc) {
      constexpr bool RES = decltype(rc)::value;
      if constexpr (PROBE && !RES) {
        return (int)cudaErrorInvalidValue;   // the probe stages its rows
      } else {
        const size_t bytes = smem_bytes<F, RES>(j, b);
        if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
        const auto kernel = hier_train_kernel<F, RES, PROBE>;
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
        kernel<<<1, NT, bytes, stream>>>(A);
        return (int)cudaGetLastError();
      }
    };
    return smem_bytes<F, true>(j, b) <= kMaxSmem
               ? run(std::true_type{})
               : run(std::false_type{});
  });
}

}  // namespace

extern "C" {

// The launch geometry at (F, J, B): out = {threads, bytes of dynamic shared
// memory, 1 if the rows are staged in it or 0 if read from L2}.  Returns a
// cudaError_t (cudaErrorInvalidValue: the shape is out of range or nothing
// fits).
int fused_hier_geometry(int f, int j, int b, long long* out) {
  if (bad_shape(b, f, j, b)) return cudaErrorInvalidValue;
  return geometry(f, j, b, out);
}

// Runs `steps` steps on `stream`.  tiles: the rows as pack_rows lays them
// out (16-byte aligned).  loc/ls/m1/m2/v1/v2: (P,) flat vectors, P = 2 + J
// + F, updated in place.  off/eps: null for Philox streams keyed by `seed`
// with counter (t0+i, 0, lane, (t0+i) >> 32), else injected offsets (steps)
// and noise (steps*P).  losses[i / thin] = -elbo of the last step of each
// group of `thin`.  Returns a cudaError_t (0 on success); launches only,
// never synchronises.
int fused_hier_train(const float* tiles, float* loc, float* ls, float* m1,
                     float* m2, float* v1, float* v2, float* losses,
                     const int* off, const float* eps, int n, int f, int j,
                     int b, int steps, long long t0, int thin, float lr0,
                     int lr_total, float scale, unsigned long long seed,
                     void* stream_ptr) {
  return launch<false>(tiles, loc, ls, m1, m2, v1, v2, losses, off, eps,
                       nullptr, n, f, j, b, steps, t0, thin, lr0, lr_total,
                       scale, seed, stream_ptr);
}

// The same run through the probe instance (rows staged only): probe (9
// int64) receives consumer thread 2's cycles summed over the sampled steps
// (every 16th from step R on) in seven phases (z and barrier 1, the row
// pass, the warp sums, the wait on the next slot, barrier 2, the group and
// total sums, Adam and the exps), the number of sampled steps and the
// cycles of the whole step loop.
int fused_hier_probe(const float* tiles, float* loc, float* ls, float* m1,
                     float* m2, float* v1, float* v2, float* losses,
                     const int* off, const float* eps, int n, int f, int j,
                     int b, int steps, long long t0, int thin, float lr0,
                     int lr_total, float scale, unsigned long long seed,
                     long long* probe, void* stream_ptr) {
  return launch<true>(tiles, loc, ls, m1, m2, v1, v2, losses, off, eps,
                      probe, n, f, j, b, steps, t0, thin, lr0, lr_total,
                      scale, seed, stream_ptr);
}

}  // extern "C"
