// Fused multinomial-NUTS transition for the DLGM local posterior, Hopper
// (sm_90a): the potential on the tensor cores (mma.sync, TF32 with each
// operand split), the chain's state owned by the lanes that compute it, and
// the transition's random draws made in the kernel.
//
// Replaces bayesic_tpu/ops/fused_nuts.py:_kernel (reached through
// fused_nuts_transition and make_batched_transition).  Its oracle is
// ops/fused_nuts.reference_transition.  One launch runs one whole NUTS
// transition of every chain: momentum energy, up to K doublings with
// checkpoint U-turn slots, the in-subtree progressive multinomial take
// (first leaf always taken), the biased merge and the full-span U-turn.
// The tree's scalar decisions are nuts_tree.cuh's (leaf_slots,
// subtree_leaf, trajectory_merge, trajectory_close), shared with the hier
// kernel; this file lays the chain's vectors out for its lanes.
//
// The posterior of one chain, q = z.view(nb, latent):
//   pe(q) = 0.5|q|^2 + |x - (tanh(z W1 + b1) W2 + b2)|^2 / (2 s^2) + const
//   grad  = q + (((res / s^2) W2^T) * (1 - a^2)) W1^T
// Every data row is independent, so a warp evaluates a row block (16 rows)
// of one chain with no help.  A chain is W <= 16 warps; past 256 rows each
// warp takes RG row blocks in turn.
//
// Products.  The four products per leaf (z W1, a W2, r W2^T, da W1^T) are
// mma.sync m16n8k8 tiles in TF32 with both operands split, hi = tf32(x),
// lo = tf32(x - hi), summed lo hi + hi lo + hi hi: about fp32's accuracy
// (a pe that enters the multinomial weights stays within 1e-5, the
// gradient within 1e-4 of max|g|; one TF32 pass does not hold the
// gradient's limit).  Each width is zero-padded to whole 8-wide tiles (a
// padded weight is 0 and adds nothing) and the tile counts come from the
// shape, so a narrow decoder runs only its own tiles.  The accumulator of
// one product is the A fragment of the next: an accumulator holds columns
// 2t, 2t+1 of its rows g, g+8 (g = lane / 4, t = lane % 4) and an A
// fragment columns t, t+4, so the next product reads its k in the order
// 2t, 2t+1 (dlgm_pack_kernel lays the weights out once per launch in that
// order, hi and lo, one 16-byte load per lane and tile).  z W1 takes z's A
// fragment as it lies; da W1^T writes each latent tile's columns in the
// order (0, 4, 1, 5, 2, 6, 3, 7), so the lane that holds z[r][l] also
// receives grad[r][l].  An eval holds 64 hidden and 32 data columns in
// registers (the bench's widths: 80 tiles per warp and leaf, 240 mma);
// wider layers go through in whole chunks (the last padded with zero
// tiles), their activations a and r parked in the warp's own scratch
// between the three passes.  Three instances (Mode): FAST, the bench's
// tile counts with everything in shared memory, straight-line code;
// GUARDED, narrower layers, each tile behind a test so that only the
// shape's own tiles run; STAGED, the chunked passes.
//
// Lane-owned chain state.  A lane owns, for each of its G element groups
// (a row block and a latent tile; G = RG ceil(latent / 8) <= 16), the 4
// elements of its z fragment there: rows g, g+8, latent t, t+4 of the
// tile.  The current q, p and grad and the inverse mass live in its
// registers (E >= G groups, E = 1, 2, 4 or 16 by template; at 16 the
// group loops are not unrolled and the arrays sit in local memory: that
// instance serves only the widest shapes, and unrolled it would take
// ptxas minutes to build); the edges, the
// two proposals, the K-1 checkpoint pairs and the parked activations at
// the lane's own float4s, so the kicks, the drift, the takes and the
// checkpoints need no barrier.  What crosses warps per leaf is one
// fixed-order sum (the potential's share, |p|^2_M^-1 and the 2 n_chk
// U-turn dots: warp butterfly, then the chain's warps in order, one named
// barrier on the chain's warps), and per doubling the full-span U-turn's
// two dots: two calls repeat bit for bit.
//
// Memory.  A launch first packs the weights' fragments, the biases and x
// in fragment order into a workspace in device memory and zeroes the chain
// counter there (dlgm_pack_kernel).  A block copies the packed region into
// shared memory when it fits beside a chain slot, and the slots' lane
// memory goes to shared memory when it fits; what does not fit is read
// from the workspace (through L1), so every shape with G <= 16 runs.  A
// block holds up to 15 chain slots of W warps (512 threads at most); each
// slot takes the next chain from the counter until none is left, so a
// slot that drew short trees takes more chains, and the grid is what fits
// on the card at once.  Which slot runs a chain changes nothing in its
// result.  At the bench (nb 64, latent 8, hidden 64, data 32, K 6) all of
// it is in shared memory: 49.5 KB packed, 41.8 KB a slot, four slots a
// block, one block per SM.
//
// Draws.  The injected entry reads the momentum normals, doubling signs
// and log-uniforms from arrays; the keyed entry makes them from Philox as
// infer/mcmc/streams.nuts_streams does (nuts_draws.cuh), a leaf's uniform
// when it reaches that leaf, so a fused transition is the pack launch and
// this one.
//
// Bound (chip_smoke.py phase 11): the plain version's work is 3 decoder
// forwards a chain-leaf, 2 nb (latent hidden + hidden data) FLOP each,
// 0.98 MFLOP at the bench widths, 0.2254 ms a transition at the 67
// TFLOP/s FP32 rate; the kernel's four products are two forwards' FLOP,
// three TF32 passes of them on the tensor cores (494.7 TFLOP/s dense) take
// 0.0610 ms, the bound the kernels line reports.  Measured (PERF.md row
// 3 keeps the latest; NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase
// 11): 0.35-0.38 ms a transition at the bench state (1024 chains, 15
// leapfrogs each) against 1.83 ms for the FFMA kernel it replaced; the
// fast instance has 128 registers and ~200 bytes of spills.  What holds it
// is not measured (ncu does not run there); by count each warp issues 240
// mma and about 2,000 other instructions a leaf, and at 4 warps a
// scheduler the leaf's dependent chain (the a W2 accumulators 24 mma deep,
// the tanh, the chain sum and its barrier) is not hidden; 1024 chains on
// 528 slots (132 SMs x 4) also take two rounds.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "nuts_draws.cuh"
#include "nuts_tree.cuh"

namespace {

constexpr int HC = 8, DC = 4;      // hidden, data tiles an eval holds
constexpr int MAXW = 16;           // warps of a chain slot
constexpr int MAXG = 16;           // element groups of a lane
constexpr int BT = 512;            // threads of a block at most
constexpr int MAXSLOTS = 15;       // named barriers 1..15

// A chain's shape and its layout on the lanes.
struct Shape {
  int nb, latent, hidden, data, k;
  int w, rg, lt, g;   // warps, row blocks a warp, latent tiles, groups
  int ht, dt;         // hidden and data tiles
  bool staged;        // wider than an eval's registers: in whole chunks
  bool full;          // whole chunks only: no per-tile tests
};

__host__ __device__ inline Shape make_shape(int nb, int latent, int hidden,
                                            int data, int k) {
  Shape s{};
  s.nb = nb; s.latent = latent; s.hidden = hidden; s.data = data; s.k = k;
  const int blocks = (nb + 15) / 16;
  s.rg = (blocks + MAXW - 1) / MAXW;
  s.w = (blocks + s.rg - 1) / s.rg;
  s.lt = (latent + 7) / 8;
  s.g = s.rg * s.lt;
  s.ht = (hidden + 7) / 8;
  s.dt = (data + 7) / 8;
  s.staged = s.ht > HC || s.dt > DC;
  if (s.staged) {       // whole chunks: the padded tiles are zero
    s.ht = (s.ht + HC - 1) / HC * HC;
    s.dt = (s.dt + DC - 1) / DC * DC;
  }
  s.full = s.ht % HC == 0 && s.dt % DC == 0;
  return s;
}

__host__ __device__ inline int slots_ck(int k) {
  return k > 1 ? k - 1 : 1;   // even leaves of a subtree fill slots 0..K-2
}

// Fragment tiles of the weights, in this order: z W1 [lt][ht], a W2
// [ht][dt], r W2^T [dt][ht], da W1^T [ht][lt].
__host__ __device__ inline int n_frag(const Shape& s) {
  return 2 * s.lt * s.ht + 2 * s.ht * s.dt;
}

// Their tile index from the tile counts lt, ht, dt.
__device__ __forceinline__ int f1(int ht, int kt, int h) {
  return kt * ht + h;
}
__device__ __forceinline__ int f2(int lt, int ht, int dt, int h, int d) {
  return lt * ht + h * dt + d;
}
__device__ __forceinline__ int f3(int lt, int ht, int dt, int d, int h) {
  return lt * ht + ht * dt + d * ht + h;
}
__device__ __forceinline__ int f4(int lt, int ht, int dt, int h, int l) {
  return lt * ht + 2 * ht * dt + h * lt + l;
}

// Floats of the packed region: weight fragments, biases, x in fragment
// order per row block.
__host__ __device__ inline size_t fixed_floats(const Shape& s) {
  return (size_t)n_frag(s) * 128 + 8 * s.ht + 8 * s.dt +
         (size_t)s.w * s.rg * s.dt * 128;
}

// Floats of one slot's lane memory: the tree's vectors (edges q p g twice,
// two proposals q g, the checkpoint pairs; V = G W 128 floats each) and
// the warps' parked activations.
__host__ __device__ inline size_t lane_floats(const Shape& s, bool tree) {
  const size_t v =
      tree ? (size_t)(10 + 2 * slots_ck(s.k)) * s.g * s.w * 128 : 0;
  return v + (s.staged ? (size_t)s.w * (s.ht + s.dt) * 128 : 0);
}

// Floats of one slot always in shared memory: the chain sums' two buffers
// and the slot's chain index.
__host__ __device__ inline size_t red_floats(const Shape& s) {
  return 2 * (size_t)s.w * MAXV + 4;
}

struct DlgmArgs {
  Shape s;
  const float *q, *pe, *grad, *eps, *inv_mass;
  const float *w1, *b1, *w2, *b2, *x;    // (in, out) weights, (nb, data) x
  NutsDraws draws;
  float *q_out, *pe_out, *g_out, *acc_out, *div_out, *depth_out, *steps_out,
      *h0_out;
  float* ws;            // workspace: counter (4 floats), packed, lane memory
  int n, slots;
  bool fixed_smem, lane_smem;
  float inv_s2, cst, div_threshold;
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b: 16 x 8 x 8 in TF32
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with both split: lo hi + hi lo + hi hi.  b = (hi0, hi1, lo0, lo1)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint4 b) {
  mma8(d, al, b.x, b.y);
  mma8(d, ah, b.z, b.w);
  mma8(d, ah, b.x, b.y);
}

// d_lo += a_lo b_hi + a_hi b_lo, d_hi += a_hi b_hi
__device__ __forceinline__ void mma3s(float (&dh)[4], float (&dl)[4],
                                      const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint4 b) {
  mma8(dl, al, b.x, b.y);
  mma8(dl, ah, b.z, b.w);
  mma8(dh, ah, b.x, b.y);
}

// tanh(x) = sign(x) (1 - 2 / (exp(2|x|) + 1)) on the SFU's ex2 and rcp,
// each within about two ulp: a few 1e-7 off tanh absolute, the error class
// of the operand split (a enters the products linearly), in a handful of
// instructions where tanhf takes both of its branches.
__device__ __forceinline__ float tanh_sfu(float x) {
  float e, r;
  const float y = 2.8853900817779268f * fabsf(x);   // 2 |x| log2(e)
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e + 1.f));
  return copysignf(fmaf(-2.f, r, 1.f), x);
}

// The A fragment (rows g, g+8 at k = t, t+4) of a 16 x 8 accumulator tile
// whose columns 2t, 2t+1 are taken as k = t, t+4.
__device__ __forceinline__ void a_from_acc(const float (&c)[4],
                                           uint32_t (&ah)[4],
                                           uint32_t (&al)[4]) {
  split(c[0], ah[0], al[0]);
  split(c[2], ah[1], al[1]);
  split(c[1], ah[2], al[2]);
  split(c[3], ah[3], al[3]);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Items of the packed region: a lane's uint4 of each weight tile, a bias
// float, a lane's float4 of each x tile.
__host__ __device__ inline int pack_items(const Shape& s) {
  return n_frag(s) * 32 + 8 * s.ht + 8 * s.dt + s.w * s.rg * s.dt * 32;
}

// Writes the packed region into the workspace (weights split into
// fragment order, biases and x zero-padded) and zeroes the chain counter.
__global__ void dlgm_pack_kernel(DlgmArgs A) {
  const Shape s = A.s;
  const int L = s.latent, H = s.hidden, Dd = s.data;
  const int nf = n_frag(s) * 32, nbias = 8 * s.ht + 8 * s.dt;
  const int n1 = s.lt * s.ht, n2 = n1 + s.ht * s.dt, n3 = n2 + s.ht * s.dt;
  float* fix = A.ws + 4;
  auto w1 = [&](int l, int h) {
    return l < L && h < H ? A.w1[l * H + h] : 0.f;
  };
  auto w2 = [&](int h, int d) {
    return h < H && d < Dd ? A.w2[h * Dd + d] : 0.f;
  };
  auto xv = [&](int r, int d) {
    return r < s.nb && d < Dd ? A.x[r * Dd + d] : 0.f;
  };
  const int total = pack_items(s);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    if (e == 0) *reinterpret_cast<int*>(A.ws) = 0;
    if (e < nf) {
      const int tile = e >> 5, ln = e & 31, g = ln >> 2, t = ln & 3;
      float v0, v1;
      if (tile < n1) {                          // z W1: k latent, n hidden
        const int kt = tile / s.ht, nt = tile % s.ht;
        v0 = w1(8 * kt + t, 8 * nt + g);
        v1 = w1(8 * kt + t + 4, 8 * nt + g);
      } else if (tile < n2) {                   // a W2: k hidden (2t order)
        const int r = tile - n1, ks = r / s.dt, nt = r % s.dt;
        v0 = w2(8 * ks + 2 * t, 8 * nt + g);
        v1 = w2(8 * ks + 2 * t + 1, 8 * nt + g);
      } else if (tile < n3) {                   // r W2^T: k data (2t order)
        const int r = tile - n2, ks = r / s.ht, nt = r % s.ht;
        v0 = w2(8 * nt + g, 8 * ks + 2 * t);
        v1 = w2(8 * nt + g, 8 * ks + 2 * t + 1);
      } else {                                  // da W1^T: n latent permuted
        const int r = tile - n3, ks = r / s.lt, lt = r % s.lt;
        const int l = 8 * lt + (g >> 1) + 4 * (g & 1);
        v0 = w1(l, 8 * ks + 2 * t);
        v1 = w1(l, 8 * ks + 2 * t + 1);
      }
      uint32_t h0, l0, h1, l1;
      split(v0, h0, l0);
      split(v1, h1, l1);
      reinterpret_cast<uint4*>(fix)[e] = make_uint4(h0, h1, l0, l1);
    } else if (e < nf + nbias) {
      const int b = e - nf, bd = b - 8 * s.ht;
      fix[(size_t)nf * 4 + b] =
          bd < 0 ? (b < H ? A.b1[b] : 0.f) : (bd < Dd ? A.b2[bd] : 0.f);
    } else {
      const int i = e - nf - nbias;
      const int blk = i / (s.dt * 32), nt = (i / 32) % s.dt, ln = i & 31;
      const int r = 16 * blk + (ln >> 2), d = 8 * nt + 2 * (ln & 3);
      reinterpret_cast<float4*>(fix + (size_t)nf * 4 + nbias)[i] =
          make_float4(xv(r, d), xv(r, d + 1), xv(r + 8, d),
                      xv(r + 8, d + 1));
    }
  }
}

// The packed region, in shared memory or in the workspace.
struct Fixed {
  const uint4* f;       // [n_frag][32]
  const float *b1, *b2;
  const float4* xf;     // [row block][dt][32]
};

__device__ __forceinline__ Fixed bind(const float* p, const Shape& s) {
  Fixed m;
  m.f = reinterpret_cast<const uint4*>(p);
  m.b1 = p + (size_t)n_frag(s) * 128;
  m.b2 = m.b1 + 8 * s.ht;
  m.xf = reinterpret_cast<const float4*>(m.b2 + 8 * s.dt);
  return m;
}

// pe share and grad of row block blk = rg W + wc (rows 16 blk .. +15) of
// one chain.  The lane's groups e0 .. e0 + LT - 1 (e0 = rg LT) hold its z
// fragments of the block's latent tiles; with FULL every hidden and data
// chunk is whole, with STAGED the layers go through in chunks (else one
// of each, hidden <= 64, data <= 32): compile-time, so the bench's widths
// run straight-line code.  scr is the warp's parked activations: [ht +
// dt][32].
// Returns this lane's share of pe - const; writes grad at the positions of
// q in those groups.
template <int E, bool FULL, bool STAGED>
__device__ __forceinline__ float dlgm_eval(const Fixed& S, const Shape& sh,
                                          float4* scr, int rg, int wc,
                                          int lane, const float (&q)[E][4],
                                          float (&gr)[E][4], float inv_s2) {
  const int t = lane & 3, g = lane >> 2;
  // one whole chunk (FAST, one latent tile): tile counts known here, so
  // every weight tile's offset is a constant
  constexpr bool FIXED = FULL && !STAGED;
  static_assert(!FIXED || E == 1, "the fixed widths take one group");
  const int LT = FIXED ? 1 : sh.lt, HT = FIXED ? HC : sh.ht;
  const int DT = FIXED ? DC : sh.dt;
  const int e0 = rg * LT, blk = rg * sh.w + wc;
  const bool ok0 = 16 * blk + g < sh.nb, ok1 = 16 * blk + g + 8 < sh.nb;
  const float4* xw = S.xf + (size_t)blk * DT * 32;
  constexpr bool staged = STAGED;
  const int nhc = STAGED ? (HT + HC - 1) / HC : 1;
  const int ndc = STAGED ? (DT + DC - 1) / DC : 1;
  auto mine = [&](int e) { return E == 1 || (e >= e0 && e < e0 + LT); };
  auto lat = [&](int e) { return E == 1 ? 0 : e - e0; };
  auto hon = [&](int h) { return FULL || h < HT; };
  auto don = [&](int d) { return FULL || d < DT; };
  auto park = [&](int i, const float (&c)[4]) {
    scr[i * 32 + lane] = make_float4(c[0], c[1], c[2], c[3]);
  };
  auto unpark = [&](int i, float (&c)[4]) {
    const float4 v = scr[i * 32 + lane];
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  };
  uint32_t zh[E][4], zl[E][4], ah[4], al[4];
#pragma unroll (E > 4 ? 1 : E)
  for (int e = 0; e < E; ++e)
    if (mine(e))
#pragma unroll
      for (int j = 0; j < 4; ++j) split(q[e][j], zh[e][j], zl[e][j]);

  float a[HC][4];                                   // tanh(z W1 + b1)
  for (int hc = 0; hc < nhc; ++hc) {
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      const int h = hc * HC + i;
      if (!hon(h)) continue;
      const float2 b = *reinterpret_cast<const float2*>(S.b1 + 8 * h + 2 * t);
      a[i][0] = b.x; a[i][1] = b.y; a[i][2] = b.x; a[i][3] = b.y;
#pragma unroll (E > 4 ? 1 : E)
      for (int e = 0; e < E; ++e)
        if (mine(e))
          mma3(a[i], zh[e], zl[e], S.f[f1(HT, lat(e), h) * 32 + lane]);
    }
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      const int h = hc * HC + i;
      if (!hon(h)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = tanh_sfu(a[i][j]);
      if (staged) park(h, a[i]);
    }
  }

  float m[DC][4], sq = 0.f;                         // (a W2 + b2 - x) / s^2
  for (int dc = 0; dc < ndc; ++dc) {
    float ml[DC][4];                                // the lo terms
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      const int d = dc * DC + i;
      if (!don(d)) continue;
      const float2 b = *reinterpret_cast<const float2*>(S.b2 + 8 * d + 2 * t);
      m[i][0] = b.x; m[i][1] = b.y; m[i][2] = b.x; m[i][3] = b.y;
#pragma unroll
      for (int j = 0; j < 4; ++j) ml[i][j] = 0.f;
    }
    for (int hc = 0; hc < nhc; ++hc) {
      if (staged)
#pragma unroll
        for (int i = 0; i < HC; ++i)
          if (hon(hc * HC + i)) unpark(hc * HC + i, a[i]);
#pragma unroll
      for (int ks = 0; ks < HC; ++ks) {
        const int h = hc * HC + ks;
        if (!hon(h)) continue;
        a_from_acc(a[ks], ah, al);
#pragma unroll
        for (int i = 0; i < DC; ++i)
          if (don(dc * DC + i))
            mma3s(m[i], ml[i], ah, al,
                  S.f[f2(LT, HT, DT, h, dc * DC + i) * 32 + lane]);
      }
    }
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      const int d = dc * DC + i;
      if (!don(d)) continue;
      const float4 xv = xw[d * 32 + lane];
      const float r0 = ok0 ? (m[i][0] + ml[i][0]) - xv.x : 0.f;
      const float r1 = ok0 ? (m[i][1] + ml[i][1]) - xv.y : 0.f;
      const float r2 = ok1 ? (m[i][2] + ml[i][2]) - xv.z : 0.f;
      const float r3 = ok1 ? (m[i][3] + ml[i][3]) - xv.w : 0.f;
      sq = fmaf(r0, r0, sq);
      sq = fmaf(r1, r1, sq);
      sq = fmaf(r2, r2, sq);
      sq = fmaf(r3, r3, sq);
      m[i][0] = r0 * inv_s2; m[i][1] = r1 * inv_s2;
      m[i][2] = r2 * inv_s2; m[i][3] = r3 * inv_s2;
      if (staged) park(HT + d, m[i]);
    }
  }

  float o[E][2][4];                                 // da W1^T: hi, lo terms
#pragma unroll (E > 4 ? 1 : E)
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[e][0][j] = o[e][1][j] = 0.f;
  for (int hc = 0; hc < nhc; ++hc) {
    if (staged)
#pragma unroll
      for (int i = 0; i < HC; ++i)
        if (hon(hc * HC + i)) unpark(hc * HC + i, a[i]);
    float da[HC][4];                                // (r W2^T) (1 - a^2)
#pragma unroll
    for (int i = 0; i < HC; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) da[i][j] = 0.f;
    for (int dc = 0; dc < ndc; ++dc) {
      if (staged)
#pragma unroll
        for (int i = 0; i < DC; ++i)
          if (don(dc * DC + i)) unpark(HT + dc * DC + i, m[i]);
#pragma unroll
      for (int ks = 0; ks < DC; ++ks) {
        const int d = dc * DC + ks;
        if (!don(d)) continue;
        a_from_acc(m[ks], ah, al);
#pragma unroll
        for (int i = 0; i < HC; ++i)
          if (hon(hc * HC + i))
            mma3(da[i], ah, al, S.f[f3(LT, HT, DT, d, hc * HC + i) * 32 + lane]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < HC; ++ks) {
      const int h = hc * HC + ks;
      if (!hon(h)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) da[ks][j] *= 1.f - a[ks][j] * a[ks][j];
      a_from_acc(da[ks], ah, al);
#pragma unroll (E > 4 ? 1 : E)
      for (int e = 0; e < E; ++e)
        if (mine(e))
          mma3s(o[e][0], o[e][1], ah, al,
                S.f[f4(LT, HT, DT, h, lat(e)) * 32 + lane]);
    }
  }
  // columns 2t, 2t+1 of a permuted latent tile are latent t, t+4
  float qq = 0.f;
#pragma unroll (E > 4 ? 1 : E)
  for (int e = 0; e < E; ++e) {
    if (!mine(e)) continue;
    gr[e][0] = q[e][0] + (o[e][0][0] + o[e][1][0]);
    gr[e][1] = q[e][1] + (o[e][0][2] + o[e][1][2]);
    gr[e][2] = q[e][2] + (o[e][0][1] + o[e][1][1]);
    gr[e][3] = q[e][3] + (o[e][0][3] + o[e][1][3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) qq = fmaf(q[e][j], q[e][j], qq);
  }
  return 0.5f * qq + (0.5f * inv_s2) * sq;
}

// Sum the first n of v[] over the chain's warps; every thread of the chain
// gets the sums.  Butterfly shuffles give all lanes the same bits; the
// warps are added in order 0..W-1.  Two buffers alternate, so one barrier
// per call suffices.
__device__ __forceinline__ void chain_sum(float (&v)[MAXV], int n,
                                          float* red, int& buf, int wc,
                                          int lane, int W, int bar) {
  float* r = red + buf * W * MAXV;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    if (k < n) {
      float x = v[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) r[wc * MAXV + k] = x;
    }
  }
  bar_sync(bar, 32 * W);
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    if (k < n) {
      float s = 0.f;
      for (int w = 0; w < W; ++w) s += r[w * MAXV + k];
      v[k] = s;
    }
  }
  buf ^= 1;
}

__device__ __forceinline__ void st4(float* v, int o, const float (&x)[4]) {
  *reinterpret_cast<float4*>(v + o) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void ld4(const float* v, int o, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(v + o);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

// A lane's share of one of the tree's vectors: its float4 of each group.
template <int E>
__device__ __forceinline__ void st_lane(float* v, const int (&own)[E],
                                        int G, const float (&x)[E][4]) {
#pragma unroll (E > 4 ? 1 : E)
  for (int e = 0; e < E; ++e)
    if (E == 1 || e < G) st4(v, own[e], x[e]);
}

template <int E>
__device__ __forceinline__ void ld_lane(const float* v,
                                        const int (&own)[E], int G,
                                        float (&x)[E][4]) {
#pragma unroll (E > 4 ? 1 : E)
  for (int e = 0; e < E; ++e) {
    if (E == 1 || e < G) {
      ld4(v, own[e], x[e]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[e][j] = 0.f;
    }
  }
}

// One NUTS transition per chain (TREE), or the potential alone: each chain
// slot of W warps takes chains from the counter until none is left.  E >=
// G element groups a lane.  MODE: FAST, one whole chunk (the bench's
// widths: hidden 64, data 32) with everything in shared memory, addressed
// as such; GUARDED, one chunk of any smaller width, tiles tested; STAGED,
// whole chunks through the parked activations.  The last two reach their
// memory through generic pointers (shared memory or the workspace).
enum Mode { FAST = 0, GUARDED = 1, STAGED = 2 };

template <bool TREE, int E, int MODE>
__global__ void __launch_bounds__(BT, 1) dlgm_nuts_kernel(DlgmArgs A) {
  constexpr bool SM = MODE == FAST;
  extern __shared__ __align__(16) float dsm[];
  const Shape& sh = A.s;
  const int W = sh.w, K = sh.k, G = sh.g, LT = sh.lt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / W, wc = warp - slot * W, bar = 1 + slot;
  const int g = lane >> 2, t = lane & 3;
  const size_t nfix = fixed_floats(sh);
  const float* fix = A.ws + 4;
  float* sm = dsm;
  if (SM || A.fixed_smem) {
    const float4* src = reinterpret_cast<const float4*>(fix);
    float4* dst = reinterpret_cast<float4*>(dsm);
    for (size_t e = threadIdx.x; e < nfix / 4; e += blockDim.x)
      dst[e] = src[e];
    fix = dsm;
    sm += nfix;
  }
  __syncthreads();
  const Fixed S = bind(fix, sh);
  float* red = sm + (size_t)slot * red_floats(sh);
  int* cid = reinterpret_cast<int*>(red + 2 * W * MAXV);
  const size_t per = lane_floats(sh, TREE);
  float* lm = SM || A.lane_smem
                  ? sm + (size_t)A.slots * red_floats(sh) + slot * per
                  : A.ws + 4 + nfix +
                        ((size_t)blockIdx.x * A.slots + slot) * per;
  const size_t V = (size_t)G * W * 128;
  float *Lq = lm, *Lp = lm + V, *Lg = lm + 2 * V;
  float *Rq = lm + 3 * V, *Rp = lm + 4 * V, *Rg = lm + 5 * V;
  float* PQ = lm + 6 * V;       // proposal b: q at PQ + 2 b V, grad + V
  float* ckq = lm + 10 * V;
  float* ckv = ckq + (size_t)slots_ck(K) * V;
  float4* scr = reinterpret_cast<float4*>(
                    lm + (TREE ? (size_t)(10 + 2 * slots_ck(K)) * V : 0)) +
                (size_t)wc * (sh.ht + sh.dt) * 32;
  const int D = sh.nb * sh.latent;
  // the lane's elements: group e is row block (e / LT) W + wc, latent tile
  // e % LT; in it rows g, g + 8, latent t, t + 4
  int own[E];
  int dj[E][4];
#pragma unroll (E > 4 ? 1 : E)
  for (int e = 0; e < E; ++e) {
    own[e] = ((e * W + wc) * 32 + lane) * 4;
    const int rgi = e / LT, lt = e - rgi * LT;
    const int r0 = 16 * (rgi * W + wc) + g, l0 = 8 * lt + t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 8 * (j & 1), l = l0 + 4 * (j >> 1);
      dj[e][j] = e < G && r < sh.nb && l < sh.latent ? r * sh.latent + l
                                                     : -1;
    }
  }
  // this warp's share of pe - const over its row blocks; grad into gg
  auto potential = [&](const float (&qq)[E][4], float (&gg)[E][4]) {
    if constexpr (E == 1)   // one row block a warp, never empty
      return dlgm_eval<E, MODE != GUARDED, MODE == STAGED>(
          S, sh, scr, 0, wc, lane, qq, gg, A.inv_s2);
    float part = 0.f;
    for (int rg = 0; rg < sh.rg; ++rg) {
      if (16 * (rg * W + wc) >= sh.nb) continue;   // an empty row block
      part += dlgm_eval<E, MODE != GUARDED, MODE == STAGED>(
          S, sh, scr, rg, wc, lane, qq, gg, A.inv_s2);
    }
    return part;
  };
  int buf = 0;
  for (;;) {
    if (wc == 0 && lane == 0) *cid = atomicAdd(reinterpret_cast<int*>(A.ws), 1);
    bar_sync(bar, 32 * W);
    const int chain = *cid;
    if (chain >= A.n) break;
    const size_t row = (size_t)chain * D;
    float q[E][4], gr[E][4], v[MAXV];
    if (!TREE) {
#pragma unroll (E > 4 ? 1 : E)
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          q[e][j] = dj[e][j] >= 0 ? A.q[row + dj[e][j]] : 0.f;
          gr[e][j] = 0.f;
        }
      v[0] = potential(q, gr);
#pragma unroll (E > 4 ? 1 : E)
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (dj[e][j] >= 0) A.g_out[row + dj[e][j]] = gr[e][j];
      chain_sum(v, 1, red, buf, wc, lane, W, bar);
      if (wc == 0 && lane == 0) A.pe_out[chain] = v[0] + A.cst;
      bar_sync(bar, 32 * W);
      continue;
    }
    const float eps = A.eps[0];
    float p[E][4], im[E][4];
    v[0] = 0.f;
#pragma unroll (E > 4 ? 1 : E)
    for (int e = 0; e < E; ++e) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = dj[e][j];
        im[e][j] = d >= 0 ? A.inv_mass[d] : 0.f;
        q[e][j] = d >= 0 ? A.q[row + d] : 0.f;
        gr[e][j] = d >= 0 ? A.grad[row + d] : 0.f;
        p[e][j] = d >= 0 ? A.draws.momentum(chain, d, D) * rsqrtf(im[e][j])
                         : 0.f;
        v[0] = fmaf(p[e][j] * p[e][j], im[e][j], v[0]);
      }
    }
    st_lane(Lq, own, G, q); st_lane(Lp, own, G, p); st_lane(Lg, own, G, gr);
    st_lane(Rq, own, G, q); st_lane(Rp, own, G, p); st_lane(Rg, own, G, gr);
    st_lane(PQ, own, G, q); st_lane(PQ + V, own, G, gr);
    chain_sum(v, 1, red, buf, wc, lane, W, bar);
    const float pe0 = A.pe[chain];
    Trajectory T = trajectory_start(pe0, pe0 + 0.5f * v[0]);

    int iP = 0;                             // the proposal's buffer
    for (int dstep = 0; T.more(dstep, K); ++dstep) {
      const bool go_right = A.draws.go_right(chain, dstep);
      const float sign_w = go_right ? 1.f : -1.f, eps_w = sign_w * eps;
      float *Eq = go_right ? Rq : Lq, *Ep = go_right ? Rp : Lp,
            *Eg = go_right ? Rg : Lg;
      ld_lane(Eq, own, G, q); ld_lane(Ep, own, G, p); ld_lane(Eg, own, G, gr);
      const int n_sub = 1 << dstep, leaf_base = n_sub - 1, iS = 1 - iP;
      Subtree s = subtree_start();
      for (int i = 0; i < n_sub && !s.done(); ++i) {
#pragma unroll (E > 4 ? 1 : E)
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int j = 0; j < 4; ++j) {     // half kick, drift
            const float ph = p[e][j] - (0.5f * eps_w) * gr[e][j];
            p[e][j] = ph;
            q[e][j] = q[e][j] + eps_w * (im[e][j] * ph);
          }
        const float part = potential(q, gr);
        const LeafSlots ls = leaf_slots(i);
        float ke = 0.f, vn[E][4];
#pragma unroll
        for (int c = 0; c < 2 * MAXK; ++c) v[2 + c] = 0.f;
#pragma unroll (E > 4 ? 1 : E)
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int j = 0; j < 4; ++j) {     // half kick
            const float pn = p[e][j] - (0.5f * eps_w) * gr[e][j];
            vn[e][j] = im[e][j] * pn;
            p[e][j] = pn;
            ke = fmaf(pn * pn, im[e][j], ke);
          }
        if (ls.even) {
          st_lane(ckq + (size_t)ls.pc * V, own, G, q);
          st_lane(ckv + (size_t)ls.pc * V, own, G, vn);
        } else {
#pragma unroll
          for (int c = 0; c < MAXK; ++c) {
            if (c >= ls.n_chk) continue;
#pragma unroll (E > 4 ? 1 : E)
            for (int e = 0; e < E; ++e) {
              if (E > 1 && e >= G) continue;
              float cq[4], cv[4];
              ld4(ckq + (size_t)(ls.idx_min + c) * V, own[e], cq);
              ld4(ckv + (size_t)(ls.idx_min + c) * V, own[e], cv);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float dq = (q[e][j] - cq[j]) * sign_w;
                v[2 + 2 * c] = fmaf(dq, cv[j], v[2 + 2 * c]);
                v[3 + 2 * c] = fmaf(dq, vn[e][j], v[3 + 2 * c]);
              }
            }
          }
        }
        v[0] = part;
        v[1] = ke;
        chain_sum(v, 2 + 2 * ls.n_chk, red, buf, wc, lane, W, bar);
        if (subtree_leaf(s, v[0] + A.cst, v[1], T.h0, v, ls.n_chk, A.draws,
                         chain, leaf_base + i, A.div_threshold)) {
          st_lane(PQ + 2 * iS * V, own, G, q);      // progressive take
          st_lane(PQ + (2 * iS + 1) * V, own, G, gr);
        }
      }
      bool full_turn = false;
      if (!s.done()) {
        if (trajectory_merge(T, s, A.draws.merge_log_u(chain, dstep)))
          iP = iS;                          // biased merge
        st_lane(Eq, own, G, q); st_lane(Ep, own, G, p);
        st_lane(Eg, own, G, gr);
        float oq[E][4], op[E][4];           // the other edge
        ld_lane(go_right ? Lq : Rq, own, G, oq);
        ld_lane(go_right ? Lp : Rp, own, G, op);
        v[0] = v[1] = 0.f;
#pragma unroll (E > 4 ? 1 : E)
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int j = 0; j < 4; ++j) {     // full-span U-turn
            const float ql = go_right ? oq[e][j] : q[e][j];
            const float qr = go_right ? q[e][j] : oq[e][j];
            const float pl = go_right ? op[e][j] : p[e][j];
            const float pr = go_right ? p[e][j] : op[e][j];
            const float dq = qr - ql;
            v[0] = fmaf(dq, im[e][j] * pl, v[0]);
            v[1] = fmaf(dq, im[e][j] * pr, v[1]);
          }
        chain_sum(v, 2, red, buf, wc, lane, W, bar);
        full_turn = jmin(v[0], v[1]) < 0.f;
      }
      trajectory_close(T, s, full_turn);
    }
    ld_lane(PQ + 2 * iP * V, own, G, q);
    ld_lane(PQ + (2 * iP + 1) * V, own, G, gr);
#pragma unroll (E > 4 ? 1 : E)
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (dj[e][j] >= 0) {
          A.q_out[row + dj[e][j]] = q[e][j];
          A.g_out[row + dj[e][j]] = gr[e][j];
        }
      }
    if (wc == 0 && lane == 0) trajectory_write(A, chain, T);
    bar_sync(bar, 32 * W);                  // every warp has read *cid
  }
}

// How a launch is laid out: chain slots per block, block threads, grid,
// dynamic shared bytes, where the packed region and the lane memory live,
// the kernel instance and the workspace floats it needs.
using Kernel = void (*)(DlgmArgs);

struct Plan {
  int slots, threads, grid;
  bool fixed_smem, lane_smem;
  size_t bytes, ws_floats;
  Kernel kernel;
};

bool shape_ok(int n, int nb, int latent, int hidden, int data, int k) {
  return n > 0 && nb > 0 && latent > 0 && hidden > 0 && data > 0 &&
         k >= 1 && k <= MAXK &&
         make_shape(nb, latent, hidden, data, k).g <= MAXG;
}

// Chain slots as many as fit (512 threads, 15 barriers, n chains), in the
// first of: all in shared memory; the packed region in the workspace; the
// lane memory there; both there.  Then the grid: what the card holds at
// once, no more than the chains need.
template <bool TREE, int E>
cudaError_t make_plan(int n, const Shape& s, Plan& p) {
  p = Plan{};
  const size_t room = kMaxSmem / 4, fx = fixed_floats(s);
  const size_t lf = lane_floats(s, TREE), rd = red_floats(s);
  int cap = BT / (32 * s.w);
  cap = cap < MAXSLOTS ? cap : MAXSLOTS;
  cap = cap < n ? cap : n;
  for (int m = 0; m < 4 && p.slots == 0; ++m) {
    const bool fs = m == 0 || m == 2, ls = m < 2;
    const size_t fixed = fs ? fx : 0, per = rd + (ls ? lf : 0);
    if (fixed + per > room) continue;
    const size_t fit = (room - fixed) / per;
    p.slots = (int)(fit < (size_t)cap ? fit : (size_t)cap);
    p.fixed_smem = fs;
    p.lane_smem = ls;
    p.threads = 32 * s.w * p.slots;
    p.bytes = 4 * (fixed + (size_t)p.slots * per);
  }
  if (p.slots < 1) return cudaErrorInvalidValue;
  p.kernel = s.staged ? dlgm_nuts_kernel<TREE, E, STAGED>
                       : dlgm_nuts_kernel<TREE, E, GUARDED>;
  if constexpr (E == 1)
    if (!s.staged && s.full && p.fixed_smem && p.lane_smem)
      p.kernel = dlgm_nuts_kernel<TREE, 1, FAST>;
  cudaError_t err = prepare(p.kernel, p.bytes);
  if (err != cudaSuccess) return err;
  // blocks an SM holds, kept for the last device and plan
  static int last_dev = -1, last_threads = 0, sms = 0, per_sm = 0;
  static size_t last_bytes = 0;
  static Kernel last_kernel = nullptr;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev != last_dev || p.threads != last_threads ||
      p.bytes != last_bytes || p.kernel != last_kernel) {
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, p.kernel, p.threads, p.bytes)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    last_dev = dev; last_threads = p.threads; last_bytes = p.bytes;
    last_kernel = p.kernel;
  }
  const int need = (n + p.slots - 1) / p.slots, resident = sms * per_sm;
  p.grid = resident < need ? resident : need;
  p.ws_floats = 4 + fx + (p.lane_smem ? 0 : (size_t)p.grid * p.slots * lf);
  return cudaSuccess;
}

// The plan of the instance for G element groups: E = 1, 2, 4 or 16.
template <bool TREE>
cudaError_t plan_for(int n, const Shape& s, Plan& p) {
  if (s.g <= 1) return make_plan<TREE, 1>(n, s, p);
  if (s.g <= 2) return make_plan<TREE, 2>(n, s, p);
  if (s.g <= 4) return make_plan<TREE, 4>(n, s, p);
  return make_plan<TREE, 16>(n, s, p);
}

// The pack launch, then the kernel's.
template <bool TREE>
int run(DlgmArgs& a, void* ws, size_t ws_bytes, void* stream_ptr) {
  Plan p;
  cudaError_t err = plan_for<TREE>(a.n, a.s, p);
  if (err != cudaSuccess) return err;
  if (ws_bytes < 4 * p.ws_floats) return cudaErrorInvalidValue;
  a.ws = static_cast<float*>(ws);
  a.slots = p.slots;
  a.fixed_smem = p.fixed_smem;
  a.lane_smem = p.lane_smem;
  const cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (pack_items(a.s) + 255) / 256;
  dlgm_pack_kernel<<<blocks < 1024 ? blocks : 1024, 256, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  void* args[] = {&a};
  return cudaLaunchKernel(reinterpret_cast<const void*>(p.kernel),
                          dim3(p.grid), dim3(p.threads), args, p.bytes, st);
}

template <bool TREE>
size_t workspace_bytes(int n, const Shape& s) {
  Plan p{};
  return plan_for<TREE>(n, s, p) == cudaSuccess ? 4 * p.ws_floats : 0;
}

DlgmArgs make_args(const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* x, int n, int nb,
                   int latent, int hidden, int data, int k, float sigma) {
  DlgmArgs a{};
  a.s = make_shape(nb, latent, hidden, data, k);
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.x = x;
  a.n = n;
  const double s = sigma;
  a.inv_s2 = (float)(1.0 / (s * s));
  a.cst = (float)(0.5 * std::log(2.0 * 3.14159265358979323846) *
                      (nb * latent + nb * data) +
                  nb * data * std::log(s));
  return a;
}

int transition(const float* q, const float* pe, const float* grad,
               NutsDraws draws, const float* eps, const float* inv_mass,
               const float* w1, const float* b1, const float* w2,
               const float* b2, const float* x, float* q_out, float* pe_out,
               float* g_out, float* acc_out, float* div_out, float* depth_out,
               float* steps_out, float* h0_out, void* ws, size_t ws_bytes,
               int n, int nb, int latent, int hidden, int data, int k,
               float sigma, float div_threshold, void* stream_ptr) {
  if (!shape_ok(n, nb, latent, hidden, data, k)) return cudaErrorInvalidValue;
  DlgmArgs a = make_args(w1, b1, w2, b2, x, n, nb, latent, hidden, data, k,
                         sigma);
  a.q = q; a.pe = pe; a.grad = grad; a.eps = eps; a.inv_mass = inv_mass;
  a.draws = draws;
  a.q_out = q_out; a.pe_out = pe_out; a.g_out = g_out; a.acc_out = acc_out;
  a.div_out = div_out; a.depth_out = depth_out; a.steps_out = steps_out;
  a.h0_out = h0_out;
  a.div_threshold = div_threshold;
  return run<true>(a, ws, ws_bytes, stream_ptr);
}

}  // namespace

extern "C" {

// Bytes of device workspace a call at this shape needs (tree != 0: a
// transition, else the potential), 0 if the kernel does not take the
// shape: K outside 1..MAXK, or more than 16 element groups a lane
// (ceil(nb / 256) ceil(latent / 8) > 16).  Lets the wrapper refuse a shape
// before it launches.
size_t fused_nuts_workspace_bytes(int n, int nb, int latent, int hidden,
                                  int data, int k, int tree) {
  if (!shape_ok(n, nb, latent, hidden, data, k)) return 0;
  const Shape s = make_shape(nb, latent, hidden, data, k);
  return tree ? workspace_bytes<true>(n, s) : workspace_bytes<false>(n, s);
}

// One NUTS transition for each of n chains on `stream`, the draws read from
// the (n, D) / (n, K) / (n, K) / (n, 2^K) arrays.  eps is one float in
// device memory; outputs pe/acc/div/depth/steps/h0 are (n,) floats; ws is
// ws_bytes of device scratch (fused_nuts_workspace_bytes).  Returns a
// cudaError_t (0 on success); enqueues two launches, never synchronises.
int fused_nuts_transition(const float* q, const float* pe, const float* grad,
                          const float* mom, const float* sign_dir,
                          const float* log_u_acc, const float* log_u_leaf,
                          const float* eps, const float* inv_mass,
                          const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* x, float* q_out,
                          float* pe_out, float* g_out, float* acc_out,
                          float* div_out, float* depth_out, float* steps_out,
                          float* h0_out, void* ws, size_t ws_bytes, int n,
                          int nb, int latent, int hidden, int data, int k,
                          float sigma, float div_threshold,
                          void* stream_ptr) {
  return transition(q, pe, grad,
                    injected_draws(mom, sign_dir, log_u_acc, log_u_leaf, k),
                    eps, inv_mass, w1, b1, w2, b2, x, q_out, pe_out, g_out,
                    acc_out, div_out, depth_out, steps_out, h0_out, ws,
                    ws_bytes, n, nb, latent, hidden, data, k, sigma,
                    div_threshold, stream_ptr);
}

// The same transition with its draws made in the kernel from Philox keyed
// by (seed, phase, t) and the chain index chain0 + i of the launch's chain
// i (nuts_draws.cuh): what make_batched_transition runs, chain0 the first
// of a chain-sharded rank's chains.
int fused_nuts_transition_keyed(
    const float* q, const float* pe, const float* grad, const float* eps,
    const float* inv_mass, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* x, float* q_out, float* pe_out,
    float* g_out, float* acc_out, float* div_out, float* depth_out,
    float* steps_out, float* h0_out, void* ws, size_t ws_bytes, int n,
    int nb, int latent, int hidden, int data, int k, float sigma,
    float div_threshold, unsigned long long seed, unsigned phase, unsigned t,
    unsigned chain0, void* stream_ptr) {
  return transition(q, pe, grad, keyed_draws(seed, phase, t, chain0, k), eps,
                    inv_mass, w1, b1, w2, b2, x, q_out, pe_out, g_out,
                    acc_out, div_out, depth_out, steps_out, h0_out, ws,
                    ws_bytes, n, nb, latent, hidden, data, k, sigma,
                    div_threshold, stream_ptr);
}

// pe (n,) and grad (n, D) at q (n, D) with the transition's potential.
int fused_nuts_potential(const float* q, const float* w1, const float* b1,
                         const float* w2, const float* b2, const float* x,
                         float* pe_out, float* g_out, void* ws,
                         size_t ws_bytes, int n, int nb, int latent,
                         int hidden, int data, float sigma,
                         void* stream_ptr) {
  if (!shape_ok(n, nb, latent, hidden, data, 1)) return cudaErrorInvalidValue;
  DlgmArgs a = make_args(w1, b1, w2, b2, x, n, nb, latent, hidden, data, 1,
                         sigma);
  a.q = q; a.pe_out = pe_out; a.g_out = g_out;
  return run<false>(a, ws, ws_bytes, stream_ptr);
}

// The keyed draws of chains chain0 .. chain0 + n - 1: mom (n, dim), sign
// (n, K) of +-1, log_u_acc (n, K), log_u_leaf (n, 2^K), as the keyed
// transitions make them (the check entry against nuts_streams).
int fused_nuts_draws(float* mom, float* sign, float* log_u_acc,
                     float* log_u_leaf, int n, int dim, int k,
                     unsigned long long seed, unsigned phase, unsigned t,
                     unsigned chain0, void* stream_ptr) {
  if (n <= 0 || dim <= 0 || k < 1 || k > MAXK) return cudaErrorInvalidValue;
  const size_t total = (size_t)n * (dim + 2 * k + (1 << k));
  const size_t blocks = (total + 255) / 256;
  nuts_draws_kernel<<<blocks < 8192 ? (int)blocks : 8192, 256, 0,
                      static_cast<cudaStream_t>(stream_ptr)>>>(
      keyed_draws(seed, phase, t, chain0, k), n, dim, mom, sign, log_u_acc,
      log_u_leaf);
  return cudaGetLastError();
}

}  // extern "C"
