// Dense matrix-factorization ELBO cell pass for Hopper (sm_90a): warp-level
// tensor-core products (mma.sync), two block roles in one launch, and a
// fixed-order reduction of few partials.
//
// Replaces bayesic_tpu/ops/mf_dense.py:_cell_kernel (reached through
// cell_grads).  Over the per-cell statistics cnt (bf16, exact integer
// counts) and rsum (fp32) of a (NU, NI) rating grid, with the augmented
// factors Fu = [Ua | Wu] (NU, 3A) and Fv = [Va | Wv] (NI, 3A), A = K + 2
// (ops/mf_dense.py:pack_aug), it computes
//   mean = Ua Va^T,  var = Wu Wv^T,  G = 2 (cnt mean - rsum),
//   cells = sum cnt (var + mean^2) - 2 rsum mean,
//   dFu = [G Va | cnt Wv],  dFv = [G^T Ua | cnt^T Wu].
// var enters only the loss, and sum cnt var = sum_u <Wu_u, (cnt Wv)_u>, so
// var is never formed: each user row adds the dot of its Wu row with its
// dWu row to the loss.
//
// Products.  Each warp owns 16 rows and runs mma.sync tiles of 16 x 8:
//   bf16 mode: m16n8k16, operands rounded to bf16 (the factors and G; cnt
//     is exact) with fp32 sums, as the plain version rounds them;
//   float32 mode: m16n8k8 in TF32 with each operand split, hi = tf32(x) and
//     lo = tf32(x - hi), summing lo hi + hi lo + hi hi (about fp32's
//     accuracy; one TF32 pass keeps ~1e-3 of max|g|, over phase 23's 1e-5);
//     cnt is exact in TF32, so its products are cnt lo + cnt hi.
// A is padded to AP, the next multiple of 8 (a template argument, so every
// product loop has a fixed count and its independent mma chains
// interleave), with zero fragments; rows and columns past the grid load as
// zeros, so their cells add nothing.
//
// Three launches.  mf_pack_kernel writes both factor matrices once in the
// layout the products read (split or rounded, A padded to AP, rows padded
// to a whole tile; bf16 also transposed per tile), so that a tile reaches
// shared memory by 16-byte cp.async copies and nothing else.  In
// mf_cell_kernel a U block owns 64 users and sweeps a chunk of CH items in
// tiles of TC: per cell it forms mean, G and the loss terms, and it keeps
// its users' [G Va | cnt Wv] in mma accumulators across the chunk, written
// once at the end with its partial loss.  A V block owns 64 items and
// sweeps CH users the same way, forming mean and G again (A more FMAs a
// cell), for [G^T Ua | cnt^T Wu].  The next tile's copy is in flight while
// the current one computes (two buffers), each 16-column step's cnt and
// rsum are loaded while the step before computes, and the owned rows' Ua
// or Va fragments stay in registers.  mf_reduce_kernel sums the chunk
// partials in chunk order and the U blocks' losses in block order.  No
// atomics: a run repeats bit for bit.
//
// Bound at the bench shape (3000 x 1500 cells, A = 18): the inputs are 27 MB
// (8.1 us at 3.35 TB/s) and the plain version's work 9A FMAs a cell (1.46
// GFLOP: 21.8 us at the 67 TFLOP/s FP32 rate, the figure chip_smoke.py
// reports for float32 mode; on the tensor cores the three TF32 passes take
// 4.4 GFLOP, 8.8 us at 495 TFLOP/s); in bf16 mode 1.5 us at 989 TFLOP/s, so
// bytes bound it at 8.1 us.  This design reads cnt and rsum twice (once per
// role) and does 8A FMAs a cell (var folded into the loss, mean twice).
// Scratch: ceil(NI/CH) NU 3A + ceil(NU/CH) NI 3A partial floats, one loss
// per U block and 6 AP floats per padded factor row: 7.78 MB at the bench
// shape, against 30.8 MB for the one 64 x 64 tile per CTA before.
//
// Sizing.  Each block is bound by the latency of its own chain (the next
// tile's copy, the stats loads, the mma chains; three blocks share an SM at
// 130-170 registers a thread), not by the SM's instruction rate, so the
// kernel takes about one block's time when every block runs in the first
// wave: CH = 384 gives 188 U and 192 V blocks at the bench shape, 380 of
// the 396 places that 132 SMs hold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int NW = 4;                 // warps per block, 16 rows each
constexpr int NT = 32 * NW;           // threads per block
constexpr int BR = 16 * NW;           // rows a block owns
constexpr int TC = 32;                // swept rows per staged tile
constexpr int CH = 384;               // columns a block sweeps (TC multiple)
constexpr int MAXA = 32;              // A = K + 2 <= 32
constexpr int RT = 256;               // threads per reduction block
constexpr int PT = 256;               // threads per packing block

// The packed and staged columns of a factor row, [Ua | 0 | Wu | 0]: A
// padded to AP (a multiple of 8), 2A to 2 AP.  Shared row strides are in
// 32-bit words, each an odd multiple of 4, so that the eight rows of a
// fragment load fall on distinct banks: float32 mode keeps the hi and lo
// parts as floats, [TC][LDS] each; bf16 mode keeps the rounded values row
// major ([TC][LDB words]) for the forward B fragments, whose pairs run
// along the factor, and column major ([SW][LDT words]) for the backward
// ones, whose pairs run along the swept rows.
template <int AP>
struct Layout {
  static constexpr int SW = 3 * AP;
  static constexpr int LDS = SW + 4;
  static constexpr int LDB = SW / 2 + (AP / 8 % 2 ? 8 : 4);
  static constexpr int LDT = TC / 2 + 4;
  static constexpr int BUF = 2 * TC * LDS;   // floats of a buffer, either mode
};

__host__ __device__ __forceinline__ int tiles(int n, int t) {
  return (n + t - 1) / t;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// two floats as bf16 (round to nearest even), the first in the low half
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return reinterpret_cast<uint32_t&>(v);
}

// d += a b: 16 x 8 x 16 in bf16
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: 16 x 8 x 8 in TF32
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Packed factor rows: 2 SW = 6 AP floats per row, rows padded to a whole
// tile.  float32 mode: row r is SW hi parts then SW lo parts.  bf16 mode:
// the first half of the area is the rows as SW bf16 each, the second half
// each tile of TC rows transposed, [SW][TC] bf16.
__host__ __device__ __forceinline__ size_t packed_floats(int n, int ap) {
  return (size_t)tiles(n, TC) * TC * 6 * ap;
}

// One thread per packed entry (bf16: per entry of each of the two
// layouts), so that the stores are contiguous.
template <bool BF16>
__global__ void __launch_bounds__(PT)
    mf_pack_kernel(const float* __restrict__ fu, const float* __restrict__ fv,
                   int nu, int ni, int a, int ap, float* __restrict__ pu,
                   float* __restrict__ pv) {
  constexpr int LAYOUTS = BF16 ? 2 : 1;
  const int sw = 3 * ap;
  const size_t eu = LAYOUTS * (size_t)tiles(nu, TC) * TC * sw;
  size_t e = (size_t)blockIdx.x * PT + threadIdx.x;
  const bool user = e < eu;
  if (!user) e -= eu;
  const int n = user ? nu : ni;
  const size_t entries = (size_t)tiles(n, TC) * TC * sw;
  if (e >= LAYOUTS * entries) return;
  const float* f = user ? fu : fv;
  float* p = user ? pu : pv;
  const bool transposed = e >= entries;   // bf16: [tile][SW][TC]
  const size_t q = transposed ? e - entries : e;
  const int r = transposed ? (int)(q / (sw * TC)) * TC + (int)(q % TC)
                           : (int)(q / sw);
  const int d = transposed ? (int)(q / TC % sw) : (int)(q % sw);
  const int src = d < ap ? (d < a ? d : -1)
                         : (d - ap < 2 * a ? a + d - ap : -1);
  const float x = r < n && src >= 0 ? f[(size_t)r * 3 * a + src] : 0.f;
  if constexpr (BF16) {
    reinterpret_cast<__nv_bfloat16*>(p)[e] = __float2bfloat16_rn(x);
  } else {
    uint32_t hi, lo;
    split(x, hi, lo);
    p[(size_t)r * 2 * sw + d] = __uint_as_float(hi);
    p[(size_t)r * 2 * sw + sw + d] = __uint_as_float(lo);
  }
}

// One block of either role.  Rows are the owned side (users for U, items
// for V) with factors fr (nrows, 3a); columns the swept side, packed in pc.
// Cell (row r, column c) is cnt/rsum[r ni + c] for U and [c ni + r] for V.
// Writes the block's partial rows of [G Fc_a | cnt Fc_w] to part
// (chunk-major, (nrows, 3a) each) and, for U, its loss to *loss_out.
//
// Fragment layouts (PTX mma.sync, g = lane / 4, t = lane % 4): an
// accumulator holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).  In bf16 an
// A fragment holds rows g, g+8 at k = 2t, 2t+1 and k = 2t+8, 2t+9, a B
// fragment k = 2t, 2t+1 and 2t+8, 2t+9 at column g; so two accumulator
// tiles of 8 columns are the A fragment of a 16-deep backward product as
// they lie.  In TF32 an A fragment holds rows g, g+8 at k = t and t+4, a B
// fragment k = t and t+4 at column g; the backward product takes the
// accumulator's columns 2t, 2t+1 as its k = t, t+4, and reads the B rows in
// that order.
template <bool BF16, bool U, int AP>
__device__ __forceinline__ void cell_role(
    const __nv_bfloat16* __restrict__ cnt, const float* __restrict__ rsum,
    const float* __restrict__ fr, const float* __restrict__ pc, int nrows,
    int ncols, int ni, int a, int band, int chunk, float* __restrict__ part,
    float* __restrict__ loss_out, float* sm, float* red) {
  using L = Layout<AP>;
  constexpr int SW = L::SW, LDS = L::LDS, LDB = L::LDB, LDT = L::LDT;
  constexpr int KS = BF16 ? (AP + 15) / 16 : AP / 8;   // forward k steps
  constexpr int NA = AP / 8, NWT = AP / 4;             // backward n tiles
  const int w = 3 * a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = band * BR + warp * 16;
  const int row[2] = {r0 + g, r0 + g + 8};
  const bool rok[2] = {row[0] < nrows, row[1] < nrows};
  const int c_begin = chunk * CH, c_end = min(ncols, c_begin + CH);

  // tile c0.. of the packed swept rows into buffer b, by 16-byte copies
  auto fetch = [&](int c0, int b) {
    float* s = sm + b * L::BUF;
    if constexpr (BF16) {
      const __nv_bfloat16* rows = reinterpret_cast<const __nv_bfloat16*>(pc);
      const __nv_bfloat16* cols = rows + (size_t)tiles(ncols, TC) * TC * SW;
      const __nv_bfloat16* rsrc = rows + (size_t)c0 * SW;
      const __nv_bfloat16* csrc = cols + (size_t)c0 * SW;
      uint32_t* sb = reinterpret_cast<uint32_t*>(s);
      uint32_t* st = sb + TC * LDB;
      constexpr int RCH = SW / 8, CCH = TC / 8;   // 16-byte pieces a line
      for (int k = tid; k < TC * RCH + SW * CCH; k += NT) {
        if (k < TC * RCH) {
          const int r = k / RCH, p = k % RCH;
          cp16(sb + r * LDB + 4 * p, rsrc + r * SW + 8 * p);
        } else {
          const int d = (k - TC * RCH) / CCH, p = (k - TC * RCH) % CCH;
          cp16(st + d * LDT + 4 * p, csrc + d * TC + 8 * p);
        }
      }
    } else {
      const float* src = pc + (size_t)c0 * 2 * SW;
      constexpr int RCH = 2 * SW / 4;              // 16-byte pieces a row
      for (int k = tid; k < TC * RCH; k += NT) {
        const int r = k / RCH, p = k % RCH, half = p / (RCH / 2);
        cp16(s + half * TC * LDS + r * LDS + 4 * (p % (RCH / 2)),
             src + r * 2 * SW + 4 * p);
      }
    }
    asm volatile("cp.async.commit_group;");
  };
  // cnt and rsum of the 16 columns from cs at the accumulator's positions
  auto load_stats = [&](int cs, float (&cn)[2][4], float (&rs)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = cs + 8 * j + 2 * t + (e & 1);
        cn[j][e] = rs[j][e] = 0.f;
        if (rok[h] && c < c_end) {
          const size_t cell = U ? (size_t)row[h] * ni + c
                                : (size_t)c * ni + row[h];
          cn[j][e] = __bfloat162float(cnt[cell]);
          rs[j][e] = rsum[cell];
        }
      }
  };
  auto rowf = [&](int h, int c) {      // own Ua / Va entry, 0 past the edge
    return rok[h] && c < a ? fr[(size_t)row[h] * w + c] : 0.f;
  };

  const int ntile = tiles(c_end - c_begin, TC);
  fetch(c_begin, 0);
  float ncn[2][4], nrs[2][4];
  load_stats(c_begin, ncn, nrs);

  // the owned rows' Ua (or Va) as forward A fragments, for the whole sweep
  uint32_t ah[KS][4], al[KS][4];
  if constexpr (BF16) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int k = 16 * ks + 2 * t;
      ah[ks][0] = bf2(rowf(0, k), rowf(0, k + 1));
      ah[ks][1] = bf2(rowf(1, k), rowf(1, k + 1));
      ah[ks][2] = bf2(rowf(0, k + 8), rowf(0, k + 9));
      ah[ks][3] = bf2(rowf(1, k + 8), rowf(1, k + 9));
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int k = 8 * ks + t;
      split(rowf(0, k), ah[ks][0], al[ks][0]);
      split(rowf(1, k), ah[ks][1], al[ks][1]);
      split(rowf(0, k + 4), ah[ks][2], al[ks][2]);
      split(rowf(1, k + 4), ah[ks][3], al[ks][3]);
    }
  }

  float da[NA][4], dw[NWT][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) da[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < NWT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dw[n][e] = 0.f;
  float loss = 0.f;

  for (int i = 0; i < ntile; ++i) {
    const int c0 = c_begin + i * TC;
    if (i + 1 < ntile) {
      fetch(c0 + TC, (i + 1) & 1);
      asm volatile("cp.async.wait_group 1;");
    } else {
      asm volatile("cp.async.wait_group 0;");
    }
    __syncthreads();                   // tile i has landed for every thread
    const float* sh = sm + (i & 1) * L::BUF;
    const float* sl = sh + TC * LDS;
    const uint32_t* sbw = reinterpret_cast<const uint32_t*>(sh);
    const uint32_t* stw = sbw + TC * LDB;

    for (int s = 0; s < TC && c0 + s < c_end; s += 16) {
      float cn[2][4], rs[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cn[j][e] = ncn[j][e];
          rs[j][e] = nrs[j][e];
        }
      if (c0 + s + 16 < c_end) load_stats(c0 + s + 16, ncn, nrs);

      // -- forward: mean over 16 rows x 16 columns (two n tiles); the
      // passes and k steps go to separate accumulators, summed after.  In
      // bf16 an AP of 8 or 24 leaves the last k step 8 columns into Wu,
      // where the A fragment is zero
      float mean[2][4];
      if constexpr (BF16) {
        float mk[KS][2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t* b = sbw + (s + 8 * j + g) * LDB + 8 * ks + t;
            mma16(mk[ks][j], ah[ks], b[0], b[4]);
          }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mean[j][e] = mk[0][j][e];
#pragma unroll
            for (int ks = 1; ks < KS; ++ks) mean[j][e] += mk[ks][j][e];
          }
      } else {
        float small[2][4] = {}, big[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = (s + 8 * j + g) * LDS + 8 * ks + t;
            const uint32_t h0 = __float_as_uint(sh[k]),
                           h1 = __float_as_uint(sh[k + 4]);
            mma8(small[j], al[ks], h0, h1);
            mma8(small[j], ah[ks], __float_as_uint(sl[k]),
                 __float_as_uint(sl[k + 4]));
            mma8(big[j], ah[ks], h0, h1);
          }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mean[j][e] = small[j][e] + big[j][e];
      }
      // -- per cell: G and the loss terms, in accumulator order (j, e)
      float gv[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float m = mean[j][e];
          if (U) loss += (cn[j][e] * m - 2.f * rs[j][e]) * m;
          gv[j][e] = 2.f * (cn[j][e] * m - rs[j][e]);
        }
      // -- backward: [G | cnt] (16 x 16) times the tile's 16 factor rows
      if constexpr (BF16) {
        const uint32_t ga[4] = {
            bf2(gv[0][0], gv[0][1]), bf2(gv[0][2], gv[0][3]),
            bf2(gv[1][0], gv[1][1]), bf2(gv[1][2], gv[1][3])};
        const uint32_t ca[4] = {
            bf2(cn[0][0], cn[0][1]), bf2(cn[0][2], cn[0][3]),
            bf2(cn[1][0], cn[1][1]), bf2(cn[1][2], cn[1][3])};
#pragma unroll
        for (int n = 0; n < NA; ++n) {
          const uint32_t* b = stw + (8 * n + g) * LDT + s / 2 + t;
          mma16(da[n], ga, b[0], b[4]);
        }
#pragma unroll
        for (int n = 0; n < NWT; ++n) {
          const uint32_t* b = stw + (AP + 8 * n + g) * LDT + s / 2 + t;
          mma16(dw[n], ca, b[0], b[4]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t gh[4], gl[4];
          split(gv[j][0], gh[0], gl[0]);
          split(gv[j][2], gh[1], gl[1]);
          split(gv[j][1], gh[2], gl[2]);
          split(gv[j][3], gh[3], gl[3]);
          const uint32_t ca[4] = {
              __float_as_uint(cn[j][0]), __float_as_uint(cn[j][2]),
              __float_as_uint(cn[j][1]), __float_as_uint(cn[j][3])};
          const int r = (s + 8 * j + 2 * t) * LDS;   // k = t; k = t + 4 next
          uint32_t h[NA][2], l[NA][2];
#pragma unroll
          for (int n = 0; n < NA; ++n) {
            const int c = r + 8 * n + g;
            h[n][0] = __float_as_uint(sh[c]);
            h[n][1] = __float_as_uint(sh[c + LDS]);
            l[n][0] = __float_as_uint(sl[c]);
            l[n][1] = __float_as_uint(sl[c + LDS]);
          }
#pragma unroll
          for (int n = 0; n < NA; ++n) mma8(da[n], gl, h[n][0], h[n][1]);
#pragma unroll
          for (int n = 0; n < NA; ++n) mma8(da[n], gh, l[n][0], l[n][1]);
#pragma unroll
          for (int n = 0; n < NA; ++n) mma8(da[n], gh, h[n][0], h[n][1]);
#pragma unroll
          for (int n = 0; n < NWT; ++n) {
            const int c = r + AP + 8 * n + g;
            mma8(dw[n], ca, __float_as_uint(sl[c]),
                 __float_as_uint(sl[c + LDS]));
          }
#pragma unroll
          for (int n = 0; n < NWT; ++n) {
            const int c = r + AP + 8 * n + g;
            mma8(dw[n], ca, __float_as_uint(sh[c]),
                 __float_as_uint(sh[c + LDS]));
          }
        }
      }
    }
    __syncthreads();                   // buffer i & 1 is free for tile i + 2
  }

  // -- the block's partial rows; U adds <Wu_u, dWu_u> to its loss
  float* out = part + (size_t)chunk * nrows * w;
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, c = 8 * n + 2 * t + (e & 1);
      if (rok[h] && c < a) out[(size_t)row[h] * w + c] = da[n][e];
    }
#pragma unroll
  for (int n = 0; n < NWT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, c = a + 8 * n + 2 * t + (e & 1);
      if (rok[h] && c < w) {
        const size_t at = (size_t)row[h] * w + c;
        out[at] = dw[n][e];
        if (U) {
          const float wu = fr[at];
          loss += (BF16 ? __bfloat162float(__float2bfloat16_rn(wu)) : wu)
                  * dw[n][e];
        }
      }
    }
  if (U) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      loss += __shfl_xor_sync(0xffffffffu, loss, o);
    if (lane == 0) red[warp] = loss;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int k = 0; k < NW; ++k) s += red[k];
      *loss_out = s;
    }
  }
}

// Blocks [0, nub) are U blocks (band-major, chunks of items inner); the
// rest V blocks (bands of items, chunks of users inner).
template <bool BF16, int AP>
__global__ void __launch_bounds__(NT, 3)
    mf_cell_kernel(const __nv_bfloat16* __restrict__ cnt,
                   const float* __restrict__ rsum,
                   const float* __restrict__ fu, const float* __restrict__ fv,
                   const float* __restrict__ pu, const float* __restrict__ pv,
                   int nu, int ni, int a, float* __restrict__ part_u,
                   float* __restrict__ part_v, float* __restrict__ part_loss) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[NW];
  const int ncu = tiles(ni, CH), nub = tiles(nu, BR) * ncu;
  const int b = blockIdx.x;
  if (b < nub) {
    cell_role<BF16, true, AP>(cnt, rsum, fu, pv, nu, ni, ni, a, b / ncu,
                              b % ncu, part_u, part_loss + b, sm, red);
  } else {
    const int ncv = tiles(nu, CH), v = b - nub;
    cell_role<BF16, false, AP>(cnt, rsum, fv, pu, ni, nu, ni, a, v / ncv,
                               v % ncv, part_v, nullptr, sm, red);
  }
}

__global__ void __launch_bounds__(RT)
    mf_reduce_kernel(const float* __restrict__ part_u,
                     const float* __restrict__ part_v,
                     const float* __restrict__ part_loss, int nu, int ni,
                     int w, int ncu, int ncv, int nub,
                     float* __restrict__ loss, float* __restrict__ dfu,
                     float* __restrict__ dfv) {
  const size_t eu = (size_t)nu * w, ev = (size_t)ni * w;
  if (blockIdx.x == gridDim.x - 1) {       // the loss
    __shared__ float red[RT / 32];
    float s = 0.f;
    for (int k = threadIdx.x; k < nub; k += RT) s += part_loss[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int k = 0; k < RT / 32; ++k) t += red[k];
      *loss = t;
    }
    return;
  }
  const size_t e = (size_t)blockIdx.x * RT + threadIdx.x;
  if (e < eu) {
    float s = 0.f;
    for (int k = 0; k < ncu; ++k) s += part_u[k * eu + e];
    dfu[e] = s;
  } else if (e < eu + ev) {
    const size_t f = e - eu;
    float s = 0.f;
    for (int k = 0; k < ncv; ++k) s += part_v[k * ev + f];
    dfv[f] = s;
  }
}

// Scratch offsets in floats: the chunk partials of both roles, the U
// blocks' losses, then (16-byte aligned) the packed factors of both sides.
struct Scratch {
  size_t part_v, part_loss, pu, pv, total;
};

Scratch scratch_layout(int nu, int ni, int a) {
  const size_t w = 3 * (size_t)a, ncu = tiles(ni, CH), ncv = tiles(nu, CH);
  Scratch s;
  s.part_v = ncu * nu * w;
  s.part_loss = s.part_v + ncv * ni * w;
  s.pu = (s.part_loss + ncu * tiles(nu, BR) + 3) / 4 * 4;
  s.pv = s.pu + packed_floats(nu, 8 * tiles(a, 8));
  s.total = s.pv + packed_floats(ni, 8 * tiles(a, 8));
  return s;
}

template <bool BF16, int AP>
cudaError_t launch_cells(const __nv_bfloat16* cnt, const float* rsum,
                         const float* fu, const float* fv, const float* pu,
                         const float* pv, int nu, int ni, int a,
                         float* scratch, const Scratch& s,
                         cudaStream_t stream) {
  const int ncu = tiles(ni, CH), ncv = tiles(nu, CH);
  const int blocks = tiles(nu, BR) * ncu + tiles(ni, BR) * ncv;
  const int bytes = (int)(sizeof(float) * 2 * Layout<AP>::BUF);
  const cudaError_t err = cudaFuncSetAttribute(
      mf_cell_kernel<BF16, AP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  mf_cell_kernel<BF16, AP><<<blocks, NT, bytes, stream>>>(
      cnt, rsum, fu, fv, pu, pv, nu, ni, a, scratch, scratch + s.part_v,
      scratch + s.part_loss);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch(const __nv_bfloat16* cnt, const float* rsum,
                   const float* fu, const float* fv, float* scratch,
                   float* loss, float* dfu, float* dfv, int nu, int ni, int a,
                   cudaStream_t stream) {
  const Scratch s = scratch_layout(nu, ni, a);
  const int w = 3 * a, ncu = tiles(ni, CH), ncv = tiles(nu, CH);
  const int nub = tiles(nu, BR) * ncu;
  float *pu = scratch + s.pu, *pv = scratch + s.pv;
  const int ap = 8 * tiles(a, 8);
  const size_t packed =
      (BF16 ? 2 : 1) * (size_t)(tiles(nu, TC) + tiles(ni, TC)) * TC * 3 * ap;
  mf_pack_kernel<BF16><<<(int)((packed + PT - 1) / PT), PT, 0, stream>>>(
      fu, fv, nu, ni, a, ap, pu, pv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (tiles(a, 8)) {
    case 1:
      err = launch_cells<BF16, 8>(cnt, rsum, fu, fv, pu, pv, nu, ni, a,
                                  scratch, s, stream);
      break;
    case 2:
      err = launch_cells<BF16, 16>(cnt, rsum, fu, fv, pu, pv, nu, ni, a,
                                   scratch, s, stream);
      break;
    case 3:
      err = launch_cells<BF16, 24>(cnt, rsum, fu, fv, pu, pv, nu, ni, a,
                                   scratch, s, stream);
      break;
    default:
      err = launch_cells<BF16, 32>(cnt, rsum, fu, fv, pu, pv, nu, ni, a,
                                   scratch, s, stream);
  }
  if (err != cudaSuccess) return err;
  const size_t elems = (size_t)(nu + ni) * w;
  const int blocks = (int)((elems + RT - 1) / RT) + 1;
  mf_reduce_kernel<<<blocks, RT, 0, stream>>>(
      scratch, scratch + s.part_v, scratch + s.part_loss, nu, ni, w, ncu, ncv,
      nub, loss, dfu, dfv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch the pass needs (scratch_layout).
size_t mf_dense_scratch_floats(int nu, int ni, int a) {
  return scratch_layout(nu, ni, a).total;
}

// One value+grad pass on `stream`.  cnt: (nu, ni) bf16, rsum: (nu, ni)
// fp32, fu: (nu, 3a), fv: (ni, 3a), all row major; scratch:
// mf_dense_scratch_floats(nu, ni, a) floats, 16-byte aligned; outputs loss
// (1), dfu (nu, 3a), dfv (ni, 3a).  bf16 != 0 rounds the product operands
// to bf16.  Returns a cudaError_t (0 on success); launches only, never
// synchronises.
int mf_dense_cell_grads(const void* cnt, const float* rsum, const float* fu,
                        const float* fv, float* scratch, float* loss,
                        float* dfu, float* dfv, int nu, int ni, int a,
                        int bf16, void* stream_ptr) {
  if (nu < 1 || ni < 1 || a < 1 || a > MAXA ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(cnt);
  return bf16 ? launch<true>(c, rsum, fu, fv, scratch, loss, dfu, dfv, nu, ni,
                             a, stream)
              : launch<false>(c, rsum, fu, fv, scratch, loss, dfu, dfv, nu,
                              ni, a, stream);
}

}  // extern "C"
