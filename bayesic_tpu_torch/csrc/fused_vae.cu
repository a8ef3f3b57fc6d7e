// Whole-run fused DLGM/VAE trainer for Hopper (sm_90a): every product on the
// tensor cores (mma.sync m16n8k8, TF32 with each operand split in two; or,
// in the bf16 instance, one pass on operands rounded to bf16).
//
// Replaces bayesic_tpu/ops/fused_vae.py:_train_kernel (Philox streams, with
// mm_dtype float32 or bfloat16) and :_injected_kernel (injected idx/eps
// streams).  One call of
// fused_vae_train enqueues every SVI step on the caller's stream; the data,
// parameters and Adam state stay in device memory and no step waits on the
// host.  A call first packs the weights (a memset and pack_kernel); then
// each step is three launches:
//
//   1. row_kernel: one block of 16 warps per 16 batch rows (an m16 tile).
//      Philox indices, exact row gather, the encoder, the reparameterised
//      z, the decoder and the per-row backward, as seven products of the
//      block's 16 rows with a weight: xb W1e, h1 [Wmu|Wsig], z W1d, hd W2d,
//      g_mx W2d^T, g_a1d W1d^T, [g_z|g_pre] [Wmu|Wsig]^T, each followed by
//      an elementwise epilogue.  It writes the activations and row
//      gradients the weight gradients need, and per block its elbo and
//      g_usig sums (fixed order: warp trees, then warps in order).
//   2. wgrad_kernel: the four weight-gradient products A^T G over the
//      batch (xb^T g_a1e, h1^T [g_z|g_pre], zl^T g_a1d, hd^T g_mx) as 64 x
//      64 output tiles, the batch split into S fixed chunks (split-K), each
//      (tile, chunk) one block that stages its A and G rows in shared
//      memory with cp.async, double-buffered, and writes its partial tile;
//      the first row of tiles also sums G's columns (the five bias
//      gradients), and one more block a chunk sums that chunk's row
//      blocks' g_usig and elbo.
//   3. adam_kernel: each gradient is the fixed-order sum of its S partials;
//      Adam with bias correction over the flat buffer of all 11 leaves, the
//      step's loss, and the updated weights packed for the next step.
// No float atomics anywhere: two calls with the same inputs repeat bit for
// bit.
//
// What bounds it.  At N=65,536, D=128, Z=32, H=256, B=1024 a step is 553.6
// MFLOP of plain work (chip_smoke.py svi_ops): 0.0083 ms at the 67 TFLOP/s
// FP32 rate, 0.0034 ms as three TF32 passes at 494.7 TFLOP/s; it moves ~1.6
// MB.  Neither rate bounds it: a step is a chain of small dependent pieces.
// The row pass is 64 blocks (one per 16 rows) that each run seven
// dependent products and epilogues with a barrier after each.  Probes on
// an H100 (not kept) found one block alone about as slow as all 64, and
// little change when the weight loads or the mma were taken out: a
// block's own chain of instructions and round trips is the limit, not
// L2's bandwidth nor the tensor cores, and splitting a block's columns
// over a 2-CTA cluster or staggering its warps' reads did not shorten it;
// more warps a block did.  The weight-gradient pass restages each operand
// for every output tile that reads it, so there the bytes through L2
// count, and its operands are plain floats.  The design keeps the chains
// short:
//
// Operands split once.  Each product sums lo hi + hi lo + hi hi with hi =
// tf32(x) (rounded to nearest) and lo = x - hi: about fp32's accuracy,
// where one TF32 pass misses the gradient limit of 1e-4 |g| + 1e-5 max|g|
// (tests/test_torch_fused_vae.py emulates both).  The weights are split
// when they change, by adam_kernel (and pack_kernel at the start of a
// call), into fragment order: for each product, 16-byte (hi b0, hi b1, lo
// b0, lo b1) groups, one per lane, 16 x 8 tile and 8-step of k, zero
// padded to whole tiles, so a B fragment is one 16-byte copy with no
// bounds test, and a weight used transposed in the backward has its own
// packing (no strided reads).  The row pass keeps its activations in
// shared memory as (hi, lo) pairs, split when an epilogue writes them, lo
// kept exact (hi + lo == x for the epilogues; the tensor core reads lo's
// top 10 mantissa bits).  The weight-gradient pass splits its operands as
// it reads them from its staged rows, rounding both parts.
//
// The bf16 instance (template flag BF, fused_vae_train's `bf16`): the
// function of the TPU kernel's mm_dtype=bfloat16, each product's operands
// rounded to bf16 (to nearest even, as the plain version's .to(bfloat16)
// does) and multiplied with float32 accumulation, every elementwise step in
// float32.  A bf16 value is exact in TF32, so each product is ONE m16n8k8
// TF32 pass on the hi parts, with hi = bf16_rn(x) and the lo passes dropped;
// the layouts, rings and packing are the float32 instance's (the lo words
// are packed as zeros and never read by an mma).
//
// Fragments.  In the row pass the k order inside each 8-step is permuted
// (logical t, t+4 -> stored 2t, 2t+1), so an A fragment row is one float4
// of two (hi, lo) pairs; rows are padded to 16 mod 32 floats so the loads
// hit distinct banks.  A warp owns up to two 16 x 8 output tiles at a
// time; where a layer has fewer tiles than warps the warps split its k
// range and the parts are summed in a fixed order through shared memory.
// Each lane streams its B groups into its warp's ring in shared memory
// with cp.async, two iterations ahead, and each k step of an iteration
// has its own accumulators.
//
// Shapes.  Every width is padded to whole tiles (zeroed packing, zeroed
// padding in shared memory), so any d, h, z >= 1 runs, and a batch that is
// a multiple of 8 but not of 16 masks its last tile's lower 8 rows.  A
// shape whose 16 rows of activations do not fit in shared memory beside
// the rings keeps them in a per-block region of the device scratch (the
// global instance of row_kernel): slower, the same arithmetic.  A
// persistent kernel or a CUDA graph over the step loop, and wgmma, are
// later steps.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "kernel_common.cuh"

namespace {

constexpr int NT = 256;        // threads of a wgrad, Adam or pack block
constexpr int RW = 16;         // warps of a row_kernel block
constexpr int RT = RW * 32;    // its threads
constexpr int RB = 16;         // batch rows of a row_kernel block
constexpr int TPW = 2;         // output tiles a warp holds at once (row pass)
constexpr int RING = 3;        // stages of a warp's B-fragment ring
constexpr int RING_ITEMS = 4;  // 16-byte groups a lane copies a stage
constexpr int WT = 64;         // wgrad_kernel output tile edge
constexpr int WLD = WT + 8;    // a staged row of WT floats (8 mod 32)
constexpr int KC = 64;         // batch rows of a wgrad_kernel stage
constexpr int MAX_SPLIT = 8;   // split-K chunks of the batch
constexpr int SPLIT_ROWS = 128;    // batch rows a chunk has at least
constexpr int NJOBS = 4;       // weight-gradient products
constexpr int NPROD = 7;       // row-pass products
constexpr int NLEAVES = 11;
constexpr float kC = 0.91893853320467274f;   // 0.5 ln 2pi

struct Leaves {
  const float *w1e, *b1e, *wmu, *bmu, *wsig, *bsig, *w1d, *b1d, *w2d, *b2d,
      *usig;
};

struct Dims {
  int n, d, h, z, b;
};

// leaf offsets in the flat parameter buffer, LEAVES order
struct Offsets {
  size_t w1e, b1e, wmu, bmu, wsig, bsig, w1d, b1d, w2d, b2d, usig, total;
};

__host__ Offsets offsets(int d, int h, int z) {
  Offsets o;
  size_t p = 0;
  o.w1e = p; p += (size_t)d * h;
  o.b1e = p; p += h;
  o.wmu = p; p += (size_t)h * z;
  o.bmu = p; p += z;
  o.wsig = p; p += (size_t)h * z;
  o.bsig = p; p += z;
  o.w1d = p; p += (size_t)z * h;
  o.b1d = p; p += h;
  o.w2d = p; p += (size_t)h * d;
  o.b2d = p; p += d;
  o.usig = p; p += 1;
  o.total = p;
  return o;
}

// A row block's partials: its g_usig and elbo sums.
constexpr int NQ = 2;

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline size_t pad4(size_t f) {
  return (f + 3) & ~(size_t)3;
}

// A 16-row buffer of plain floats: whole 8-wide tiles, 8 mod 32 floats a
// row (the accumulators' float2 stores hit distinct banks).
__host__ __device__ inline int ldp(int k) { return ceil_div(k, 32) * 32 + 8; }

// A 16-row buffer of (hi, lo) pairs: whole 8-steps, 16 mod 32 floats a row
// (an A fragment row is one float4; eight lanes a phase hit distinct banks).
__host__ __device__ inline int ld2(int k) {
  return ceil_div(2 * k, 32) * 32 + 16;
}

// k-slices of a row-pass product with N output columns: the warps split
// the k range when the layer has fewer 8-wide tiles than warps.
__host__ __device__ inline int row_slices(int n) {
  const int nt = ceil_div(n, 8);
  return nt >= RW ? 1 : RW / nt;
}

// The row-pass products' (K, N), in the order of the kernel, and where
// each one's packed weights start (floats, from the first).
struct Prods {
  int k[NPROD], n[NPROD];
  size_t off[NPROD + 1];
};

__host__ __device__ inline Prods prods(int d, int h, int z) {
  Prods p;
  const int kn[NPROD][2] = {{d, h}, {h, 2 * z}, {z, h}, {h, d},
                            {d, h}, {h, z},     {2 * z, h}};
  p.off[0] = 0;
  for (int i = 0; i < NPROD; ++i) {
    p.k[i] = kn[i][0];
    p.n[i] = kn[i][1];
    p.off[i + 1] =
        p.off[i] + (size_t)ceil_div(kn[i][0], 8) * ceil_div(kn[i][1], 8) * 128;
  }
  return p;
}

// Floats of a row block's buffers: (hi, lo) pairs xs (d; g_mx takes its
// place), h1, hd (h; g_a1d takes its place), gzp (2z), zl (z); plain ep
// (z) and the products' output with its k-slices.
struct RowLayout {
  int l_d, l_h, l_z, l_2z, lp_z;
  size_t xs, h1, hd, gzp, zl, ep, out, total;
};

__host__ __device__ inline RowLayout row_layout(int d, int h, int z) {
  RowLayout L;
  L.l_d = ld2(d);
  L.l_h = ld2(h);
  L.l_z = ld2(z);
  L.l_2z = ld2(2 * z);
  L.lp_z = ldp(z);
  size_t p = 0;
  L.xs = p; p += (size_t)RB * L.l_d;
  L.h1 = p; p += (size_t)RB * L.l_h;
  L.hd = p; p += (size_t)RB * L.l_h;
  L.gzp = p; p += (size_t)RB * L.l_2z;
  L.zl = p; p += (size_t)RB * L.l_z;
  L.ep = p; p += (size_t)RB * L.lp_z;
  L.out = p;
  size_t out = 0;
  const int ns[4] = {h, 2 * z, d, z};
  for (int i = 0; i < 4; ++i) {
    const size_t f = (size_t)row_slices(ns[i]) * RB * ldp(ns[i]);
    out = f > out ? f : out;
  }
  p += out;
  L.total = pad4(p);
  return L;
}

constexpr size_t kSmemLimit = 232448;
constexpr size_t kRowStatic = sizeof(int) * RB + sizeof(float) * RW * NQ;

// Shared memory of the warps' B-fragment rings, bytes.
constexpr size_t kRingBytes = (size_t)RW * RING * RING_ITEMS * 32 * 16;

__host__ inline bool row_in_smem(const RowLayout& L) {
  return L.total * sizeof(float) + kRingBytes + kRowStatic <= kSmemLimit;
}

// split-K chunks of the batch, and each chunk's rows (a multiple of 8)
__host__ __device__ inline int wsplit(int b) {
  const int s = b / SPLIT_ROWS;
  return s < 1 ? 1 : (s > MAX_SPLIT ? MAX_SPLIT : s);
}

__host__ inline int wchunk(int b) {
  return ceil_div(ceil_div(b, wsplit(b)), 8) * 8;
}

// Device scratch, floats, each array 16-byte aligned: the batch's
// activations and row gradients, the row blocks' partials, the split-K
// partials (P + 1 a chunk: every gradient and the elbo), the packed
// weights and (global instance only) the row blocks' buffers.
struct ScratchLayout {
  size_t xb, h1, zl, hd, gmx, ga1d, gzp, ga1e, bpart, wpart, packed, rowbuf,
      total;
};

__host__ ScratchLayout scratch_layout(int d, int h, int z, int b) {
  ScratchLayout s;
  const size_t B = b;
  size_t p = 0;
  s.xb = p; p += pad4(B * d);
  s.h1 = p; p += pad4(B * h);
  s.zl = p; p += pad4(B * z);
  s.hd = p; p += pad4(B * h);
  s.gmx = p; p += pad4(B * d);
  s.ga1d = p; p += pad4(B * h);
  s.gzp = p; p += pad4(B * 2 * z);
  s.ga1e = p; p += pad4(B * h);
  s.bpart = p; p += pad4((size_t)ceil_div(b, RB) * NQ);
  s.wpart = p; p += pad4((size_t)wsplit(b) * (offsets(d, h, z).total + 1));
  s.packed = p; p += prods(d, h, z).off[NPROD];
  s.rowbuf = p;
  const RowLayout L = row_layout(d, h, z);
  if (!row_in_smem(L)) p += (size_t)ceil_div(b, RB) * L.total;
  s.total = p;
  return s;
}

struct Scratch {
  float *xb, *h1, *zl, *hd, *gmx, *ga1d, *gzp, *ga1e, *bpart, *wpart,
      *packed, *rowbuf;
};

// x rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero as cvt.rna.tf32.f32 rounds, in two integer operations: half of
// the dropped bits' unit added to the magnitude's bits, then masked off.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x rounded to bf16 (7 stored mantissa bits), to nearest with ties to even
// as __float2bfloat16_rn and torch's .to(bfloat16) round finite values.
__device__ __forceinline__ uint32_t bf16_rn(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

// an operand's high part: bf16 in the bf16 instance, else TF32
template <bool BF>
__device__ __forceinline__ uint32_t round_hi(float x) {
  return BF ? bf16_rn(x) : tf32(x);
}

// d += a b: 16 x 8 x 8 in TF32
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, both split: lo hi + hi lo + hi hi; b = (hi0, hi1, lo0, lo1).
// The bf16 instance: hi hi alone.
template <bool BF>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint4 b) {
  if (!BF) {
    mma8(d, al, b.x, b.y);
    mma8(d, ah, b.z, b.w);
  }
  mma8(d, ah, b.x, b.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// buf[r][j] = v as a (hi, lo) pair: hi = round_hi(v), lo = v - hi exactly
template <bool BF>
__device__ __forceinline__ void put(float* buf, int ld, int r, int j,
                                    float v) {
  const float hi = __uint_as_float(round_hi<BF>(v));
  *reinterpret_cast<float2*>(buf + r * ld + 2 * j) = make_float2(hi, v - hi);
}

__device__ __forceinline__ float get(const float* buf, int ld, int r, int j) {
  const float2 p = *reinterpret_cast<const float2*>(buf + r * ld + 2 * j);
  return p.x + p.y;
}

// Packed weights.  B[k][n] of a product with ks 8-steps goes to the group
// of tile n / 8, step k / 8, lane 4 (n % 8) + (k % 8) / 2, word (k % 2)
// (hi) and 2 + (k % 2) (lo; zero in the bf16 instance).
template <bool BF>
__device__ __forceinline__ void pack_put(float* pk, int ks, int k, int n,
                                         float v) {
  const size_t group = (size_t)((n >> 3) * ks + (k >> 3)) * 32 +
                       (n & 7) * 4 + ((k & 7) >> 1);
  const size_t at = group * 4 + (k & 1);
  const uint32_t hi = round_hi<BF>(v);
  pk[at] = __uint_as_float(hi);
  pk[at + 2] = BF ? 0.f : __uint_as_float(tf32(v - __uint_as_float(hi)));
}

// Leaf boundaries and each weight leaf's row length.
struct LeafTable {
  int off[NLEAVES + 1];
  int cols[NLEAVES];
};

__device__ __forceinline__ int leaf_of(const LeafTable& T, int i) {
  int leaf = 0;
#pragma unroll
  for (int l = 1; l < NLEAVES; ++l) leaf += i >= T.off[l];
  return leaf;
}

// Writes weight element i (value v) into every product that reads it.
template <bool BF>
__device__ __forceinline__ void pack_elem(float* packed, const Prods& Pr,
                                          const LeafTable& T, int z, int i,
                                          float v) {
  const int leaf = leaf_of(T, i);
  if (leaf % 2 || leaf == NLEAVES - 1) return;   // biases, usig: not packed
  int off = 0, cols = 1;
#pragma unroll
  for (int l = 0; l < NLEAVES - 1; l += 2)
    if (leaf == l) {
      off = T.off[l];
      cols = T.cols[l];
    }
  const int e = i - off, r = e / cols, c = e - r * cols;
  auto put_in = [&](int p, int k, int n) {
    pack_put<BF>(packed + Pr.off[p], ceil_div(Pr.k[p], 8), k, n, v);
  };
  switch (leaf) {
    case 0: put_in(0, r, c); break;                       // w1e
    case 2: put_in(1, r, c); put_in(6, c, r); break;      // wmu
    case 4: put_in(1, r, z + c); put_in(6, z + c, r); break;   // wsig
    case 6: put_in(2, r, c); put_in(5, c, r); break;      // w1d
    default: put_in(3, r, c); put_in(4, c, r); break;     // w2d
  }
}

template <bool BF>
__global__ void __launch_bounds__(NT)
pack_kernel(const float* __restrict__ p, float* __restrict__ packed,
            Prods Pr, LeafTable T, int z) {
  const int P = T.off[NLEAVES];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < P;
       i += gridDim.x * blockDim.x)
    pack_elem<BF>(packed, Pr, T, z, i, p[i]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// NT_ tiles of a warp over k steps [k_lo, k_hi), KU steps an iteration.
// A: (hi, lo) pairs, row stride lda; the A fragment holds rows g, g+8 at
// logical k t, t+4 (stored k0+2t, k0+2t+1: one float4 a row).  Bp: the
// product's packed weights, ks 8-steps a tile.  Each lane streams its own
// B groups through the warp's ring (RING stages of KU x NT_ groups) with
// cp.async, RING - 1 iterations ahead, and reads back only what it copied.
// The k steps of an iteration run without branches: a step past k_hi
// reads zero-filled B groups and a zeroed A fragment.  Each step of an
// iteration has its own accumulators (fewer dependent mma in a row),
// summed in order at the end.  Writes the tiles to dst.
template <int NT_, bool BF>
__device__ __forceinline__ void row_tiles(const float* A, int lda,
                                          const uint4* __restrict__ Bp,
                                          int ks, int tile0, int tstride,
                                          int k_lo, int k_hi, float* dst,
                                          int ldo, uint4* ring, int lane) {
  constexpr int KU = RING_ITEMS / NT_;
  const int g = lane >> 2, t = lane & 3;
  const uint4* bp[NT_];
#pragma unroll
  for (int i = 0; i < NT_; ++i)
    bp[i] = Bp + (size_t)(tile0 + i * tstride) * ks * 32 + lane;
  const int iters = ceil_div(k_hi - k_lo, KU);
  auto fetch = [&](int it) {
    if (it < iters) {
      uint4* st = ring + (it % RING) * RING_ITEMS * 32 + lane;
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int kk = k_lo + it * KU + u;
        const bool live = kk < k_hi;
#pragma unroll
        for (int i = 0; i < NT_; ++i)
          cp_async16(st + (u * NT_ + i) * 32,
                     bp[i] + (size_t)(live ? kk : k_lo) * 32, live);
      }
    }
    asm volatile("cp.async.commit_group;");
  };
  float acc[KU][NT_][4] = {};
#pragma unroll
  for (int p = 0; p < RING - 1; ++p) fetch(p);
  for (int it = 0; it < iters; ++it) {
    __syncwarp();
    fetch(it + RING - 1);
    asm volatile("cp.async.wait_group %0;" ::"n"(RING - 1));
    const uint4* st = ring + (it % RING) * RING_ITEMS * 32 + lane;
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int kk = k_lo + it * KU + u;
      const bool live = kk < k_hi;
      const float* a = A + 16 * (live ? kk : k_lo) + 4 * t;   // pairs 8 kk + 2t
      float4 r0 = *reinterpret_cast<const float4*>(a + g * lda);
      float4 r1 = *reinterpret_cast<const float4*>(a + (g + 8) * lda);
      if (!live) r0 = r1 = make_float4(0.f, 0.f, 0.f, 0.f);
      const uint32_t ah[4] = {__float_as_uint(r0.x), __float_as_uint(r1.x),
                              __float_as_uint(r0.z), __float_as_uint(r1.z)};
      const uint32_t al[4] = {__float_as_uint(r0.y), __float_as_uint(r1.y),
                              __float_as_uint(r0.w), __float_as_uint(r1.w)};
#pragma unroll
      for (int i = 0; i < NT_; ++i)
        mma3<BF>(acc[u][i], ah, al, st[(u * NT_ + i) * 32]);
    }
  }
#pragma unroll
  for (int i = 0; i < NT_; ++i) {
    float c[4] = {acc[0][i][0], acc[0][i][1], acc[0][i][2], acc[0][i][3]};
#pragma unroll
    for (int u = 1; u < KU; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[q] += acc[u][i][q];
    float* o = dst + 8 * (tile0 + i * tstride) + 2 * t;
    *reinterpret_cast<float2*>(o + g * ldo) = make_float2(c[0], c[1]);
    *reinterpret_cast<float2*>(o + (g + 8) * ldo) = make_float2(c[2], c[3]);
  }
}

// out[s][r][n] = sum over the k of slice s of A[r][k] B[k][n] for the
// block's 16 rows; out has stride ldo and RB * ldo floats a slice.  A warp
// takes its tiles TPW at a time, or one tile when the warps split k.  Ends
// without a barrier.
template <bool BF>
__device__ void row_mm(const float* A, int lda, int K,
                       const float* packed, int N, float* out, int ldo,
                       uint4* rings) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* ring = rings + warp * RING * RING_ITEMS * 32;
  const uint4* Bp = reinterpret_cast<const uint4*>(packed);
  const int nt = ceil_div(N, 8), ks = ceil_div(K, 8);
  const int S = row_slices(N);
  if (S > 1) {
    if (warp >= nt * S) return;
    const int s = warp / nt;
    row_tiles<1, BF>(A, lda, Bp, ks, warp - s * nt, 0, s * ks / S,
                 (s + 1) * ks / S, out + (size_t)s * RB * ldo, ldo, ring,
                 lane);
    return;
  }
  for (int c0 = warp; c0 < nt; c0 += TPW * RW) {
    if (c0 + RW < nt)
      row_tiles<2, BF>(A, lda, Bp, ks, c0, RW, 0, ks, out, ldo, ring, lane);
    else
      row_tiles<1, BF>(A, lda, Bp, ks, c0, RW, 0, ks, out, ldo, ring, lane);
  }
}

// The product's value at (r, j): its k-slices summed in order.
__device__ __forceinline__ float row_out(const float* out, int ldo, int S,
                                         int r, int j) {
  float v = out[r * ldo + j];
  for (int s = 1; s < S; ++s) v += out[(size_t)s * RB * ldo + r * ldo + j];
  return v;
}

// Zero what a block reads before writing: each pair buffer's padded
// columns (whole 8-steps past its width) in every row, and the masked rows
// of the gathered x and the noise.
__device__ __forceinline__ void zero_pads(float* buf, int ld, int k,
                                          int rows) {
  const int kp = 8 * ceil_div(k, 8);
  const int w = kp - k;
  for (int e = threadIdx.x; e < RB * w; e += RT) {
    const int r = e / w;
    buf[r * ld + 2 * (k + e - r * w)] = 0.f;
    buf[r * ld + 2 * (k + e - r * w) + 1] = 0.f;
  }
  for (int e = threadIdx.x; e < (RB - rows) * 2 * kp; e += RT)
    buf[rows * ld + (e / (2 * kp)) * ld + e % (2 * kp)] = 0.f;
}

// One block = RB consecutive batch rows (the last block of a batch that is
// not a multiple of 16 holds 8).  idx_in/eps_in are null for the Philox
// path, else this step's slice of the injected streams.  IN_SMEM: the
// block's buffers in shared memory, else in S.rowbuf (the warps' B rings
// are in shared memory either way).  A wide epilogue takes four rows of
// one column a thread, a latent-wide one one element a thread in turn; a
// masked row is computed on zeros and written nowhere.  BF: the bf16
// instance.
template <bool IN_SMEM, bool BF>
__global__ void __launch_bounds__(RT, 1)
row_kernel(const float* __restrict__ x, Leaves P, Scratch S, Dims D,
           const int* __restrict__ idx_in, const float* __restrict__ eps_in,
           unsigned long long step, uint32_t k0, uint32_t k1, float scale) {
  extern __shared__ float4 smem4[];
  __shared__ int sidx[RB];
  __shared__ float wred[RW][NQ];
  const int d = D.d, h = D.h, z = D.z;
  const RowLayout L = row_layout(d, h, z);
  const Prods Pr = prods(d, h, z);
  float* base = IN_SMEM ? reinterpret_cast<float*>(smem4)
                        : S.rowbuf + (size_t)blockIdx.x * L.total;
  float* xs = base + L.xs;     // x, then g_mx
  float* h1 = base + L.h1;
  float* hd = base + L.hd;     // hd, then g_a1d
  float* gzp = base + L.gzp;   // pre in its second half, then g_z | g_pre
  float* zl = base + L.zl;
  float* ep = base + L.ep;
  float* out = base + L.out;
  uint4* rings = reinterpret_cast<uint4*>(smem4) +
                 (IN_SMEM ? L.total / 4 : 0);   // each warp's B ring
  const float* pk = S.packed;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * RB;
  const int rows = min(RB, D.b - row0);
  const int Sh = row_slices(h);
  const uint32_t t_lo = (uint32_t)step, t_hi = (uint32_t)(step >> 32);
  float pe = 0.f, pu = 0.f;   // this thread's elbo and g_usig terms

  zero_pads(xs, L.l_d, d, rows);
  zero_pads(h1, L.l_h, h, RB);
  zero_pads(hd, L.l_h, h, RB);
  zero_pads(gzp, L.l_2z, 2 * z, RB);
  zero_pads(zl, L.l_z, z, RB);
  for (int e = tid; e < (RB - rows) * L.lp_z; e += RT)
    ep[rows * L.lp_z + e] = 0.f;
  // -- streams: lane 0 the row index, lane 1+l the noise eps[row, l]
  if (tid < rows) {
    const int row = row0 + tid;
    int i;
    if (idx_in) {
      i = idx_in[row];
    } else {
      const bt::U4 w =
          bt::philox4x32_10(bt::U4{t_lo, (uint32_t)row, 0u, t_hi}, k0, k1);
      i = min((int)(bt::uniform24(w.x) * (float)D.n), D.n - 1);
    }
    sidx[tid] = i;
  }
  for (int e = tid; e < rows * z; e += RT) {
    const int r = e / z, l = e - r * z, row = row0 + r;
    float v;
    if (eps_in) {
      v = eps_in[(size_t)row * z + l];
    } else {
      const bt::U4 w = bt::philox4x32_10(
          bt::U4{t_lo, (uint32_t)row, (uint32_t)(1 + l), t_hi}, k0, k1);
      v = bt::box_muller(w.x, w.y);
    }
    ep[r * L.lp_z + l] = v;
  }
  __syncthreads();
  // -- exact with-replacement gather, eight loads a thread in flight
  for (int e0 = tid; e0 < rows * d; e0 += 8 * RT) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * RT, r = e / d;
      v[u] = e < rows * d ? __ldg(x + (size_t)sidx[r] * d + (e - r * d)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * RT, r = e / d;
      if (e < rows * d) {
        put<BF>(xs, L.l_d, r, e - r * d, v[u]);
        S.xb[(size_t)row0 * d + e] = v[u];
      }
    }
  }
  __syncthreads();

  // -- encoder hidden layer: h1 = tanh(xb W1e + b1e)
  row_mm<BF>(xs, L.l_d, d, pk + Pr.off[0], h, out, ldp(h), rings);
  __syncthreads();
  for (int jj = tid; jj < h * (RB / 4); jj += RT) {
    const int j = jj % h, r0 = 4 * (jj / h);
    const float bj = __ldg(P.b1e + j);
    for (int r = r0; r < r0 + 4; ++r) {
      const float v = tanhf(row_out(out, ldp(h), Sh, r, j) + bj);
      put<BF>(h1, L.l_h, r, j, v);
      if (r < rows) S.h1[(size_t)(row0 + r) * h + j] = v;
    }
  }
  __syncthreads();

  // -- mu | pre = h1 [Wmu | Wsig] + [bmu | bsig]; reparameterised z, prior
  //    and -log q terms; pre kept in gzp's second half
  row_mm<BF>(h1, L.l_h, h, pk + Pr.off[1], 2 * z, out, ldp(2 * z), rings);
  __syncthreads();
  for (int e = tid; e < RB * z; e += RT) {
    const int r = e / z, j = e - r * z;
    const int Sn = row_slices(2 * z), lo = ldp(2 * z);
    const float mu = row_out(out, lo, Sn, r, j) + __ldg(P.bmu + j);
    const float pre = row_out(out, lo, Sn, r, z + j) + __ldg(P.bsig + j);
    const float lsv = fminf(fmaxf(pre, -6.f), 3.f);
    const float eps = ep[r * L.lp_z + j];
    const float zv = mu + expf(lsv) * eps;
    put<BF>(zl, L.l_z, r, j, zv);
    put<BF>(gzp, L.l_2z, r, z + j, pre);
    if (r < rows) {
      S.zl[(size_t)row0 * z + e] = zv;
      pe += (-0.5f * zv * zv - kC) - (-lsv - 0.5f * eps * eps - kC);
    }
  }
  __syncthreads();

  // -- decoder hidden layer: hd = tanh(z W1d + b1d)
  row_mm<BF>(zl, L.l_z, z, pk + Pr.off[2], h, out, ldp(h), rings);
  __syncthreads();
  for (int jj = tid; jj < h * (RB / 4); jj += RT) {
    const int j = jj % h, r0 = 4 * (jj / h);
    const float bj = __ldg(P.b1d + j);
    for (int r = r0; r < r0 + 4; ++r) {
      const float v = tanhf(row_out(out, ldp(h), Sh, r, j) + bj);
      put<BF>(hd, L.l_h, r, j, v);
      if (r < rows) S.hd[(size_t)(row0 + r) * h + j] = v;
    }
  }
  __syncthreads();

  // -- decoder output, likelihood terms and g_mx = d elbo / d mx (in x's
  //    place)
  const float us = __ldg(P.usig);
  const float inv_s2 = expf(-2.f * us);
  row_mm<BF>(hd, L.l_h, h, pk + Pr.off[3], d, out, ldp(d), rings);
  __syncthreads();
  for (int jj = tid; jj < d * (RB / 4); jj += RT) {
    const int j = jj % d, r0 = 4 * (jj / d);
    const float bj = __ldg(P.b2d + j);
    const int Sd = row_slices(d);
    for (int r = r0; r < r0 + 4; ++r) {
      const float res =
          (row_out(out, ldp(d), Sd, r, j) + bj) - get(xs, L.l_d, r, j);
      const float g = -scale * res * inv_s2;
      put<BF>(xs, L.l_d, r, j, g);
      if (r < rows) {
        S.gmx[(size_t)(row0 + r) * d + j] = g;
        pe += -0.5f * res * res * inv_s2 - us - kC;
        pu += res * res * inv_s2 - 1.f;
      }
    }
  }
  __syncthreads();

  // -- g_a1d = (g_mx W2d^T) * (1 - hd^2), in hd's place
  row_mm<BF>(xs, L.l_d, d, pk + Pr.off[4], h, out, ldp(h), rings);
  __syncthreads();
  for (int jj = tid; jj < h * (RB / 4); jj += RT) {
    const int j = jj % h, r0 = 4 * (jj / h);
    for (int r = r0; r < r0 + 4; ++r) {
      const float hv = get(hd, L.l_h, r, j);
      const float g = row_out(out, ldp(h), Sh, r, j) * (1.f - hv * hv);
      put<BF>(hd, L.l_h, r, j, g);
      if (r < rows) S.ga1d[(size_t)(row0 + r) * h + j] = g;
    }
  }
  __syncthreads();

  // -- g_z = g_a1d W1d^T - s z + s eps e^{-ls};  g_pre = g_z eps e^ls mask
  row_mm<BF>(hd, L.l_h, h, pk + Pr.off[5], z, out, ldp(z), rings);
  __syncthreads();
  for (int e = tid; e < RB * z; e += RT) {
    const int r = e / z, j = e - r * z;
    const float pre = get(gzp, L.l_2z, r, z + j);
    const float lsv = fminf(fmaxf(pre, -6.f), 3.f);
    const float eps = ep[r * L.lp_z + j];
    const float g = row_out(out, ldp(z), row_slices(z), r, j) -
                    scale * get(zl, L.l_z, r, j) + scale * eps * expf(-lsv);
    const float mask = (pre > -6.f && pre < 3.f) ? 1.f : 0.f;
    const float gp = g * eps * expf(lsv) * mask;
    put<BF>(gzp, L.l_2z, r, j, g);
    put<BF>(gzp, L.l_2z, r, z + j, gp);
    if (r < rows) {
      S.gzp[(size_t)(row0 + r) * 2 * z + j] = g;
      S.gzp[(size_t)(row0 + r) * 2 * z + z + j] = gp;
    }
  }
  __syncthreads();

  // -- g_a1e = ([g_z | g_pre] [Wmu | Wsig]^T) * (1 - h1^2)
  row_mm<BF>(gzp, L.l_2z, 2 * z, pk + Pr.off[6], h, out, ldp(h), rings);
  __syncthreads();
  for (int jj = tid; jj < h * (RB / 4); jj += RT) {
    const int j = jj % h, r0 = 4 * (jj / h);
    for (int r = r0; r < min(r0 + 4, rows); ++r) {
      const float hv = get(h1, L.l_h, r, j);
      S.ga1e[(size_t)(row0 + r) * h + j] =
          row_out(out, ldp(h), Sh, r, j) * (1.f - hv * hv);
    }
  }

  // -- the block's g_usig and elbo sums, fixed order: warp tree, then warps
  const int warp = tid >> 5, lane = tid & 31;
  const float su = warp_sum(pu), se = warp_sum(pe);
  if (lane == 0) {
    wred[warp][0] = su;
    wred[warp][1] = se;
  }
  __syncthreads();
  if (tid < NQ) {
    float s = 0.f;
    for (int w = 0; w < RW; ++w) s += wred[w][tid];
    S.bpart[(size_t)blockIdx.x * NQ + tid] = scale * s;
  }
}

// C (M x N) = A^T G over one chunk of the batch, A (B x M) and G (B x N)
// row-major; C's column n < csplit goes to flat offset c0 + m ldc + n, the
// others to c1 + m ldc + (n - csplit) (the [Wmu | Wsig] pair).  The
// blocks of the first row of tiles also sum G's columns, the bias
// gradient, into flat offset g0 + n or g1 + (n - csplit).
struct WJob {
  const float* A;
  const float* G;
  int M, N;
  int c0, c1, csplit, ldc, g0, g1;
};

struct WJobs {
  WJob job[NJOBS];
  int start[NJOBS + 1];   // first tile of each job; start[NJOBS] = total
  int b, chunk;           // batch rows, rows of a split-K chunk
  int P1;                 // floats of a partial: every gradient, the elbo
  const float* bpart;     // the row blocks' g_usig and elbo partials
  int nblk, usig;         // row blocks; usig's offset (the elbo's is P)
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// Stage rows [k0, k1) of a (B x M) array, columns [m0, m0+WT), into
// s[KC][WLD]; rows and columns outside are zero-filled.
__device__ __forceinline__ void stage(float* s, const float* a, int M, int m0,
                                      int k0, int k1) {
  if (M % 4 == 0) {   // four floats a copy
    for (int e = threadIdx.x; e < KC * (WT / 4); e += NT) {
      const int r = e / (WT / 4), c = 4 * (e - r * (WT / 4));
      const bool ok = k0 + r < k1 && m0 + c < M;
      cp_async16(s + r * WLD + c, ok ? a + (size_t)(k0 + r) * M + m0 + c : a,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < KC * WT; e += NT) {
      const int r = e / WT, c = e - r * WT;
      const bool ok = k0 + r < k1 && m0 + c < M;
      cp_async4(s + r * WLD + c, ok ? a + (size_t)(k0 + r) * M + m0 + c : a,
                ok);
    }
  }
}

template <bool BF>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_hi<BF>(x);
  lo = BF ? 0u : tf32(x - __uint_as_float(hi));
}

// One k step of a warp's four 16 x 8 tiles from the staged rows: A^T's
// fragment (rows mr + g, +8 at k t, t+4) and G's per tile, each split into
// (hi, lo) as it is read.
template <bool BF>
__device__ __forceinline__ void wg_kstep(float (&acc)[4][4], const float* As,
                                         const float* Gs, int k, int mr,
                                         int nc, int g, int t) {
  const float* ar = As + (k + t) * WLD + mr + g;
  uint32_t ah[4], al[4];
  split<BF>(ar[0], ah[0], al[0]);
  split<BF>(ar[8], ah[1], al[1]);
  split<BF>(ar[4 * WLD], ah[2], al[2]);
  split<BF>(ar[4 * WLD + 8], ah[3], al[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* gr = Gs + (k + t) * WLD + nc + 8 * i + g;
    uint4 b;
    split<BF>(gr[0], b.x, b.z);
    split<BF>(gr[4 * WLD], b.y, b.w);
    mma3<BF>(acc[i], ah, al, b);
  }
}

// One block = one 64 x 64 output tile of one job over one split-K chunk
// (blockIdx.y), its rows staged KC at a time in two buffers (the next
// stage is copied while this one's products run); or, the last block of
// each chunk, the sum in row block order of that chunk's share of the row
// blocks' g_usig and elbo partials.  Warp (wm, wn) owns rows 16 wm and
// columns 32 wn: four 16 x 8 tiles.
template <bool BF>
__global__ void __launch_bounds__(NT)
wgrad_kernel(WJobs J, float* __restrict__ wpart) {
  extern __shared__ float4 smem4[];
  __shared__ float cred[4][WT];
  float* part = wpart + (size_t)blockIdx.y * J.P1;
  if ((int)blockIdx.x == J.start[NJOBS]) {
    if (threadIdx.x < NQ) {
      const int b_lo = blockIdx.y * J.nblk / gridDim.y;
      const int b_hi = (blockIdx.y + 1) * J.nblk / gridDim.y;
      float v = 0.f;
      for (int b = b_lo; b < b_hi; ++b)
        v += J.bpart[(size_t)b * NQ + threadIdx.x];
      part[threadIdx.x == 0 ? J.usig : J.P1 - 1] = v;
    }
    return;
  }
  int q = 0;
  while (q + 1 < NJOBS && (int)blockIdx.x >= J.start[q + 1]) ++q;
  const WJob jb = J.job[q];
  const int tile = blockIdx.x - J.start[q];
  const int tiles_n = ceil_div(jb.N, WT);
  const int m0 = (tile / tiles_n) * WT, n0 = (tile % tiles_n) * WT;
  const int kb = blockIdx.y * J.chunk, ke = min(J.b, kb + J.chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mr = 16 * (warp & 3), nc = 32 * (warp >> 2);
  const bool active = m0 + mr < jb.M && n0 + nc < jb.N;
  const bool bias = m0 == 0;   // this block also sums G's columns
  const int cc = threadIdx.x & (WT - 1), cq = threadIdx.x / WT;
  float* buf[2] = {reinterpret_cast<float*>(smem4),
                   reinterpret_cast<float*>(smem4) + 2 * KC * WLD};
  float acc0[4][4] = {}, acc1[4][4] = {};
  float cs = 0.f;   // column cc's sum over rows cq, cq + 4, ...
  const int stages = ceil_div(ke - kb, KC);
  stage(buf[0], jb.A, jb.M, m0, kb, ke);
  stage(buf[0] + KC * WLD, jb.G, jb.N, n0, kb, ke);
  asm volatile("cp.async.commit_group;");
  for (int st = 0; st < stages; ++st) {
    const int k0 = kb + st * KC;
    if (st + 1 < stages) {
      float* nb = buf[(st + 1) & 1];
      stage(nb, jb.A, jb.M, m0, k0 + KC, ke);
      stage(nb + KC * WLD, jb.G, jb.N, n0, k0 + KC, ke);
      asm volatile("cp.async.commit_group;");
      asm volatile("cp.async.wait_group 1;");
    } else {
      asm volatile("cp.async.wait_group 0;");
    }
    __syncthreads();
    const float* As = buf[st & 1];
    const float* Gs = As + KC * WLD;
    if (active) {
      const int steps = ceil_div(min(KC, ke - k0), 8);
      int ks = 0;
      for (; ks + 1 < steps; ks += 2) {
        wg_kstep<BF>(acc0, As, Gs, 8 * ks, mr, nc, g, t);
        wg_kstep<BF>(acc1, As, Gs, 8 * ks + 8, mr, nc, g, t);
      }
      if (ks < steps) wg_kstep<BF>(acc0, As, Gs, 8 * ks, mr, nc, g, t);
    }
    if (bias) {
#pragma unroll
      for (int r = cq; r < KC; r += 4) cs += Gs[r * WLD + cc];
    }
    __syncthreads();
  }
  if (bias) {
    cred[cq][cc] = cs;
    __syncthreads();
    const int n = n0 + threadIdx.x;
    if (threadIdx.x < WT && n < jb.N)
      part[n < jb.csplit ? jb.g0 + n : jb.g1 + (n - jb.csplit)] =
          ((cred[0][threadIdx.x] + cred[1][threadIdx.x]) +
           cred[2][threadIdx.x]) + cred[3][threadIdx.x];
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m0 + mr + g + 8 * (c >> 1);
      const int n = n0 + nc + 8 * i + 2 * t + (c & 1);
      if (m < jb.M && n < jb.N) {
        const int off = n < jb.csplit ? jb.c0 + m * jb.ldc + n
                                      : jb.c1 + m * jb.ldc + (n - jb.csplit);
        part[off] = acc0[i][c] + acc1[i][c];
      }
    }
  }
}

// Sums each gradient's split-K partials in order, then Adam, then packs
// the updated weights for the next step's row pass; the step's loss from
// the elbo partials.
template <bool BF>
__global__ void __launch_bounds__(NT)
adam_kernel(float* __restrict__ p, float* __restrict__ m,
            float* __restrict__ v, const float* __restrict__ wpart,
            float* __restrict__ packed, Prods Pr, LeafTable T, int z,
            int nsplit, float t, float lr, float* __restrict__ losses,
            int slot) {
  const float bc1 = 1.f - expf(t * bt::kLnB1);
  const float bc2 = 1.f - expf(t * bt::kLnB2);
  const int P = T.off[NLEAVES], P1 = P + 1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < P;
       i += gridDim.x * blockDim.x) {
    float g = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) g += wpart[(size_t)s * P1 + i];
    float pv = p[i], mv = m[i], vv = v[i];
    bt::adam_elem(pv, mv, vv, g, bc1, bc2, lr);
    p[i] = pv;
    m[i] = mv;
    v[i] = vv;
    pack_elem<BF>(packed, Pr, T, z, i, pv);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float e = 0.f;
    for (int s = 0; s < nsplit; ++s) e += wpart[(size_t)s * P1 + P];
    losses[slot] = -e;
  }
}

}  // namespace

extern "C" {

size_t fused_vae_scratch_floats(int d, int h, int z, int b) {
  return scratch_layout(d, h, z, b).total;
}

const char* bt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs `steps` steps.  params/m/v: flat buffers in LEAVES order, updated in
// place.  idx/eps: null for in-kernel Philox streams keyed by `seed` with
// counter (t0+i, row, lane); else injected streams (steps*b) and
// (steps*b*z).  losses[i / thin] = -elbo of step i (later steps overwrite).
// scale: the likelihood's plate scale (N / B, or n_total / B for a shard).
// bf16: nonzero runs the bf16 instance (products on operands rounded to
// bf16), zero the float32 one.
// Returns a cudaError_t (0 on success); launches only, never synchronises.
int fused_vae_train(const float* x, float* params, float* m, float* v,
                    float* losses, float* scratch, const int* idx,
                    const float* eps, int n, int d, int h, int z, int b,
                    int steps, long long t0, int thin, float lr, float scale,
                    unsigned long long seed, int bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || d <= 0 || h <= 0 || z <= 0 || b <= 0 || b % 8 ||
      steps < 0 || thin < 1 || t0 < 0)
    return cudaErrorInvalidValue;
  const Dims D{n, d, h, z, b};
  const Offsets o = offsets(d, h, z);
  const RowLayout RL = row_layout(d, h, z);
  const ScratchLayout SL = scratch_layout(d, h, z, b);
  const Prods Pr = prods(d, h, z);
  const bool in_smem = row_in_smem(RL);
  const size_t row_smem =
      (in_smem ? RL.total * sizeof(float) : 0) + kRingBytes;
  const size_t wg_smem = 4 * (size_t)KC * WLD * sizeof(float);

  const Leaves P{params + o.w1e, params + o.b1e,  params + o.wmu,
                 params + o.bmu, params + o.wsig, params + o.bsig,
                 params + o.w1d, params + o.b1d,  params + o.w2d,
                 params + o.b2d, params + o.usig};
  Scratch S;
  S.xb = scratch + SL.xb;
  S.h1 = scratch + SL.h1;
  S.zl = scratch + SL.zl;
  S.hd = scratch + SL.hd;
  S.gmx = scratch + SL.gmx;
  S.ga1d = scratch + SL.ga1d;
  S.gzp = scratch + SL.gzp;
  S.ga1e = scratch + SL.ga1e;
  S.bpart = scratch + SL.bpart;
  S.wpart = scratch + SL.wpart;
  S.packed = scratch + SL.packed;
  S.rowbuf = scratch + SL.rowbuf;

  const int nblk = ceil_div(b, RB);
  const int nsplit = wsplit(b);
  WJobs J;
  J.b = b;
  J.chunk = wchunk(b);
  J.P1 = (int)o.total + 1;
  J.bpart = S.bpart;
  J.nblk = nblk;
  J.usig = (int)o.usig;
  const int big = 1 << 30;   // a column split past every column
  const WJob jobs[NJOBS] = {
      {S.xb, S.ga1e, d, h, (int)o.w1e, (int)o.w1e, big, h, (int)o.b1e,
       (int)o.b1e},
      {S.h1, S.gzp, h, 2 * z, (int)o.wmu, (int)o.wsig, z, z, (int)o.bmu,
       (int)o.bsig},
      {S.zl, S.ga1d, z, h, (int)o.w1d, (int)o.w1d, big, h, (int)o.b1d,
       (int)o.b1d},
      {S.hd, S.gmx, h, d, (int)o.w2d, (int)o.w2d, big, d, (int)o.b2d,
       (int)o.b2d},
  };
  int tiles = 0;
  for (int q = 0; q < NJOBS; ++q) {
    J.job[q] = jobs[q];
    J.start[q] = tiles;
    tiles += ceil_div(jobs[q].M, WT) * ceil_div(jobs[q].N, WT);
  }
  J.start[NJOBS] = tiles;

  LeafTable T;
  const size_t offs[NLEAVES + 1] = {o.w1e, o.b1e, o.wmu, o.bmu,
                                    o.wsig, o.bsig, o.w1d, o.b1d,
                                    o.w2d, o.b2d, o.usig, o.total};
  const int cols[NLEAVES] = {h, 1, z, 1, z, 1, h, 1, d, 1, 1};
  for (int i = 0; i <= NLEAVES; ++i) T.off[i] = (int)offs[i];
  for (int i = 0; i < NLEAVES; ++i) T.cols[i] = cols[i];

  const int p_blocks = ceil_div((int)o.total, NT);
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  // every launch of one instance: BF_ is std::true_type for bf16
  auto enqueue = [&](auto BF_) -> cudaError_t {
    constexpr bool BF = decltype(BF_)::value;
    auto row = in_smem ? row_kernel<true, BF> : row_kernel<false, BF>;
    cudaError_t err = cudaFuncSetAttribute(
        row, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)row_smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(wgrad_kernel<BF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)wg_smem);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(S.packed, 0, Pr.off[NPROD] * sizeof(float), stream);
    if (err != cudaSuccess) return err;
    pack_kernel<BF><<<p_blocks, NT, 0, stream>>>(params, S.packed, Pr, T, z);
    for (int i = 0; i < steps; ++i) {
      const unsigned long long t = (unsigned long long)t0 + i;
      const int* ii = idx ? idx + (size_t)i * b : nullptr;
      const float* ee = eps ? eps + (size_t)i * b * z : nullptr;
      row<<<nblk, RT, row_smem, stream>>>(x, P, S, D, ii, ee, t, k0, k1,
                                          scale);
      wgrad_kernel<BF><<<dim3(tiles + 1, nsplit), NT, wg_smem, stream>>>(
          J, S.wpart);
      adam_kernel<BF><<<p_blocks, NT, 0, stream>>>(
          params, m, v, S.wpart, S.packed, Pr, T, z, nsplit, (float)(t + 1),
          lr, losses, i / thin);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return cudaGetLastError();
  };
  return bf16 ? enqueue(std::true_type{}) : enqueue(std::false_type{});
}

}  // extern "C"
