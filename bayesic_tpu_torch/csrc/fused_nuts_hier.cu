// Fused multinomial-NUTS transition for the hierarchical-logistic posterior,
// Hopper (sm_90a), fp32 SIMT.
//
// Replaces bayesic_tpu/ops/fused_nuts_hier.py:_kernel (reached through
// fused_hier_nuts_transition and make_batched_transition_hier).  The
// transition tree is nuts_tree.cuh's nuts_kernel (one thread block per
// chain, one launch per transition of every chain); this file gives it the
// HierPotential and the C entries: the injected one, which reads the
// transition's streams from arrays, and the keyed one, which makes the
// same draws in the kernel (nuts_draws.cuh).  Its oracle is
// ops/fused_nuts_hier.reference_transition.
//
// The posterior: the centered model of models/hier_logistic.py over
// q = (mu, u = log tau, theta[J], beta[F]), D = 2 + J + F, with
//   pe(q) = mu^2/50 + tau^2/8 + (J-1) u + |theta - mu|^2 / (2 tau^2)
//           + |beta|^2/2 + sum_n softplus(l_n) - y_n l_n + const,
//   l_n = theta[g_n] + x_n . beta,
// the density of the JAX package's make_hier_potential on its real lanes.
// The TPU kernel's 128-lane padding (redrawn auxiliary dims), design matrix
// and bf16 splits are not ported: the chain state is the real D dims, so
// the U-turn statistic covers every dim, and every product is fp32.
//
// What bounds it.  One chain is one block on one SM, and every leaf of its
// trajectory evaluates all N rows: per row the logit's and the beta
// gradient's 2F FFMAs, an exp and a reciprocal on the SFU and ~12 more
// operations.  At N = 10,000, F = 5 that is 2,578 cycles of one SM's
// issue a leaf (33 SASS instructions a row) and 1,250 of its SFU; the 128
// chains of the bench run side by side on 128 SMs, so a launch lasts as
// long as its deepest chain's leaves, each also paying the tree's serial
// steps (barriers, the owner warps' sums and decision).  Measured on an
// H100 (PERF.md, row 4): ~4 us a leaf, the rows at ~58% of that issue
// rate; from the start to the rows resident (the copy, the draws and the
// momentum) 4.9-8.8 us a launch in two readings, the spread not explained.
//
// Design of the potential.
// - The rows are resident in shared memory.  ops/fused_nuts_hier.hier_data
//   lays them out once: the rows, sorted by group, are cut into chunks of
//   at most `depth` rows that never cross a group (a group's chunks differ
//   by at most one row; the depth gives a thread the fewest rows, with at
//   most B + J chunks in all, padded to a multiple of B = kChunkBlock,
//   1,024); chunk c = m B + t holds its row i at position
//   (m depth + i) B + t, x as F planes of B floats a row step and y one
//   bit a position.  Thread t of the block's 512 walks chunks t, t + 512,
//   t + 1,024 and on, so at each step the 32 lanes of a warp
//   read 32 consecutive floats of a plane, at offsets fixed at compile
//   time: no bank conflict at any F, where rows of F floats conflict at
//   even F, and no address arithmetic but one increment a row; y is one
//   32-bit word a warp-step.  At the start of the transition thread 0
//   copies x and y into shared memory with cp.async.bulk on an mbarrier
//   (at N 10,000, F 5: 205 KB beside ~11 KB of tree and sums), issued
//   before the momentum and the draws, which overlap it; every leaf then
//   reads only shared memory, but for each chunk's rows and group (read
//   from device memory, so that the chunks' count costs shared memory
//   only their sums).
//   Where the rows and the tree do not fit in 227 KB the launch picks the
//   instance that reads the same layout from device memory (RESIDENT
//   false, chosen by shape only; same arithmetic and order, same bits).
// - The row split is balanced: every thread takes at most nch / 512 x
//   `depth` rows (20 at the bench, against 19.5 on average), where a warp
//   per group left 7 groups to two warps and 6 to the others; at any J
//   and skew at most 2 (1 + ceil(J / B)) ceil(N / B), against N / 512 on
//   average.  A chunk's
//   d pe / d theta partial goes to its own slot in shared memory and the
//   theta gradient of group g sums its chunks in chunk order; the beta
//   partials are warp butterflies summed in warp order, the likelihood's
//   and the prior's sums butterflies of warp 0.  No atomics, so a run
//   repeats bit for bit.
// - The likelihood loop runs on the SFU in the log2 domain, as
//   gmm_lik.cuh's points_log2 does: e = exp(-|l|) is one ex2.approx,
//   sigmoid(l) one rcp.approx of 1 + e, and log1p(e) is taken once per
//   kChunk rows as one lg2.approx of the product of their 1 + e (each in
//   [1, 2], the product below 2^16).  With y folded into the sign of the
//   logit (softplus(l) - y l = max(l', 0) + log1p(e), sigmoid(l) - y =
//   +-sigmoid(l'), l' = (1 - 2y) l) a row takes 2 MUFU ops;
//   tests/test_torch_fused_nuts_hier.py holds the loop, emulated at the
//   PTX ISA bounds of the .approx functions, against float64.
// - Only the warps that own the chain's D elements run the tree
//   (nuts_tree.cuh); the other 14 at the bench evaluate rows and wait.
//   512 threads, not 1,024: at 1,024 the 64-register bound spills and the
//   transition took 0.046 ms against 0.036 (PERF.md, row 4).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "gmm_lik.cuh"
#include "nuts_tree.cuh"

namespace {

constexpr int MAXF = 8;              // most features (ops/fused_nuts_hier.py)
// positions a block of the rows' layout holds (CHUNK_THREADS there): at
// the bench the chunks number kChunkBlock, two a thread
constexpr int kChunkBlock = 1024;
constexpr int kHierThreads = 512;           // threads a block
constexpr uint32_t kCopyPiece = 32768;   // bytes of one bulk copy

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0: an mbarrier expecting one arrival and the bytes of both copies,
// then the copies of [src, src + bytes) into shared memory, in pieces.
__device__ __forceinline__ void bulk_load(uint64_t* bar, void* dst0,
                                          const void* src0, uint32_t bytes0,
                                          void* dst1, const void* src1,
                                          uint32_t bytes1) {
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(b), "r"(bytes0 + bytes1) : "memory");
  void* dst[2] = {dst0, dst1};
  const void* src[2] = {src0, src1};
  const uint32_t bytes[2] = {bytes0, bytes1};
  for (int a = 0; a < 2; ++a) {
    for (uint32_t o = 0; o < bytes[a]; o += kCopyPiece) {
      const uint32_t n = bytes[a] - o < kCopyPiece ? bytes[a] - o : kCopyPiece;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(smem_u32(static_cast<char*>(dst[a]) + o)),
          "l"(static_cast<const char*>(src[a]) + o), "r"(n), "r"(b)
          : "memory");
    }
  }
}

// Returns once the mbarrier's first phase has completed.
__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
  } while (!done);
}

// The rows as hier_data lays them out, in device memory: chunk c = m B + t
// (B = kChunkBlock) holds its row i at position (m depth + i) B + t.
struct HierRows {
  const float* x;        // (nch / B, depth, F, B): x of position (., ., t)
  const uint32_t* y;     // depth nch / 32 words: bit p % 32 of word p / 32
                         // is y at position p
  const int* chunks;     // (3, nch): first sorted row, rows, group
  const int* coff;       // (J + 1): the first chunk of each group
  int j, depth, nch;
};

template <int NT, int F, bool RESIDENT>
struct HierPotential {
  static constexpr int NW = NT / 32;
  HierRows r;
  float cst;
  const float* xs;       // the planes: shared memory (RESIDENT) or r.x
  const uint32_t* ys;    // the bits: likewise
  float *tp, *bpart, *lpart;   // shared: chunk, warp x beta, warp sums
  uint64_t* bar;

  __host__ __device__ int dim() const { return 2 + r.j + F; }
  __host__ __device__ size_t x_floats() const {
    return (size_t)F * r.depth * r.nch;
  }
  __host__ __device__ size_t y_words() const {
    return (size_t)r.depth * r.nch / 32;
  }

  __host__ __device__ size_t smem_floats() const {
    // [x, y bits, mbarrier,] chunk sums, warp beta and likelihood sums
    return (RESIDENT ? x_floats() + y_words() + 2 : 0) + r.nch + NW * (F + 1);
  }

  __device__ float* bind(float* s) {
    if constexpr (RESIDENT) {
      xs = s; s += x_floats();
      ys = reinterpret_cast<const uint32_t*>(s); s += y_words();
      bar = reinterpret_cast<uint64_t*>(s);   // 8-byte aligned: both even
      s += 2;
    } else {
      xs = r.x;
      ys = r.y;
    }
    tp = s; s += r.nch;
    bpart = s; s += NW * F;
    lpart = s; s += NW;
    return s;
  }

  // Starts the bulk copy of x and y (RESIDENT).
  __device__ void load() {
    if constexpr (RESIDENT) {
      if (threadIdx.x == 0)
        bulk_load(bar, const_cast<float*>(xs), r.x,
                  (uint32_t)(4 * x_floats()), const_cast<uint32_t*>(ys), r.y,
                  (uint32_t)(4 * y_words()));
    }
  }

  __device__ void wait() const {
    if constexpr (RESIDENT) bulk_wait(bar);
  }

  // An x float and a bits word at index i of the layout.
  __device__ __forceinline__ float x_at(const float* x, int i) const {
    if constexpr (RESIDENT)
      return x[i];
    else
      return __ldg(x + i);
  }
  __device__ __forceinline__ uint32_t y_at(const uint32_t* y, int i) const {
    if constexpr (RESIDENT)
      return y[i];
    else
      return __ldg(y + i);
  }

  // q visible to the whole block.  Returns pe - cst on thread 0 (0 on the
  // others); writes grad[d] for d = tid + k*NT < D.
  __device__ float eval(const float* q, float* grad) const {
    constexpr int B = kChunkBlock;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int J = r.j, nch = r.nch, depth = r.depth;
    float bk[F], gb[F];
#pragma unroll
    for (int k = 0; k < F; ++k) {
      bk[k] = q[2 + J + k];
      gb[k] = 0.f;
    }
    float lin = 0.f, lik2 = 0.f;    // max(l', 0) and log2(1 + e) sums
    for (int c = tid; c < nch; c += NT) {
      const int rows = __ldg(r.chunks + nch + c);
      const float th = q[2 + __ldg(r.chunks + 2 * nch + c)];
      const int m = c / B, t = c % B, bit = t & 31;
      const float* xc = xs + (size_t)m * depth * F * B + t;
      const uint32_t* yc = ys + (size_t)m * depth * (B / 32) + t / 32;
      float s = 0.f;
      for (int i0 = 0; i0 < rows; i0 += kChunk) {
        const int i1 = min(rows, i0 + kChunk);
        float prod = 1.f;
#pragma unroll 2
        for (int i = i0; i < i1; ++i) {
          float xv[F];
          float l = th;
#pragma unroll
          for (int k = 0; k < F; ++k) {
            xv[k] = x_at(xc, (i * F + k) * B);
            l = fmaf(xv[k], bk[k], l);
          }
          const bool yv = (y_at(yc, i * (B / 32)) >> bit) & 1u;
          const float lv = yv ? -l : l;
          const float e = ex2_approx(-fabsf(l) * kLog2e);
          const float opl = 1.f + e;
          prod *= opl;
          lin += fmaxf(lv, 0.f);
          const float rc = rcp_approx(opl);
          const float sg = lv >= 0.f ? rc : e * rc;   // sigmoid(l')
          const float d = yv ? -sg : sg;              // sigmoid(l) - y
          s += d;
#pragma unroll
          for (int k = 0; k < F; ++k) gb[k] = fmaf(d, xv[k], gb[k]);
        }
        lik2 += lg2_approx(prod);
      }
      tp[c] = s;
    }
    const float lw = warp_sum(fmaf(kLn2, lik2, lin));
#pragma unroll
    for (int k = 0; k < F; ++k) gb[k] = warp_sum(gb[k]);
    if (lane == 0) {
      lpart[warp] = lw;
#pragma unroll
      for (int k = 0; k < F; ++k) bpart[warp * F + k] = gb[k];
    }
    __syncthreads();
    const int D = 2 + J + F;
    const float mu = q[0];
    float s1 = 0.f, s2 = 0.f, share = 0.f;
    if (warp == 0) {      // the prior's theta sums and the likelihood's total
      for (int g = lane; g < J; g += 32) {
        const float dt = q[2 + g] - mu;
        s1 += dt;
        s2 = fmaf(dt, dt, s2);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      share = warp_sum(lane < NW ? lpart[lane] : 0.f);
    }
    if (tid < D) {
      const float u = q[1];
      const float tau2 = expf(2.f * u), inv_t2 = expf(-2.f * u);
      for (int d = tid; d < D; d += NT) {
        float gd;
        if (d == 0) {
          gd = mu / 25.f - s1 * inv_t2;
        } else if (d == 1) {
          gd = 0.25f * tau2 + (float)(J - 1) - s2 * inv_t2;
        } else if (d < 2 + J) {
          float sg = 0.f;
          const int c1 = __ldg(r.coff + d - 1);
#pragma unroll 4
          for (int c = __ldg(r.coff + d - 2); c < c1; ++c) sg += tp[c];
          gd = sg + (q[d] - mu) * inv_t2;
        } else {
          const int k = d - 2 - J;
          float sb = 0.f;
#pragma unroll
          for (int w = 0; w < NW; ++w) sb += bpart[w * F + k];
          gd = sb + q[d];
        }
        grad[d] = gd;
      }
      if (tid == 0) {
        float bb = 0.f;
#pragma unroll
        for (int k = 0; k < F; ++k) bb = fmaf(bk[k], bk[k], bb);
        share += 0.5f * mu * mu / 25.f + 0.125f * tau2 + (float)(J - 1) * u +
                 0.5f * s2 * inv_t2 + 0.5f * bb;
      }
    }
    return tid == 0 ? share : 0.f;
  }
};

template <int F, bool RESIDENT>
HierPotential<kHierThreads, F, RESIDENT> make_hier(const HierRows& rows) {
  HierPotential<kHierThreads, F, RESIDENT> pot{};
  pot.r = rows;
  // mu ~ N(0, 5): ln 5 + c; tau ~ HalfNormal(2) under Exp: c; theta, beta:
  // c each (c = 0.5 ln 2pi)
  const double c = 0.5 * std::log(2.0 * 3.14159265358979323846);
  pot.cst = (float)(std::log(5.0) + c * (2 + rows.j + F));
  return pot;
}

// Bytes of dynamic shared memory of one block: a transition at K doublings
// (k >= 1) or the potential (k = 0).
template <int F, bool RESIDENT>
size_t smem_bytes(const HierRows& rows, int k) {
  const auto pot = make_hier<F, RESIDENT>(rows);
  return 4 * (k ? transition_smem_floats<kHierThreads>(pot.dim(), k,
                                                       pot.smem_floats())
                : potential_smem_floats<kHierThreads>(pot.dim(),
                                                      pot.smem_floats()));
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

bool bad_shape(int n, const HierRows& rows, int f) {
  return n <= 0 || rows.j < 1 || f < 1 || f > MAXF || rows.depth < 1 ||
         (size_t)rows.depth * MAXF * kChunkBlock >= (size_t)1 << 31 ||
         rows.nch < kChunkBlock || rows.nch % kChunkBlock != 0 ||
         ((reinterpret_cast<uintptr_t>(rows.x) |
           reinterpret_cast<uintptr_t>(rows.y)) & 15) != 0;
}

// The launch geometry at this shape: {threads, bytes, resident}; the rows
// are resident in shared memory whenever they fit beside the tree.
int geometry(const HierRows& rows, int f, int k, int* out) {
  return with_features(f, [&](auto fc) {
    constexpr int F = decltype(fc)::value;
    const size_t res = smem_bytes<F, true>(rows, k);
    const size_t bytes = res <= kMaxSmem ? res : smem_bytes<F, false>(rows, k);
    if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    out[0] = kHierThreads;
    out[1] = (int)bytes;
    out[2] = res <= kMaxSmem;
    return (int)cudaSuccess;
  });
}

int launch_hier_transition(const float* q, const float* pe, const float* grad,
                           NutsDraws draws, const float* eps,
                           const float* inv_mass, const HierRows& rows,
                           float* q_out, float* pe_out, float* g_out,
                           float* acc_out, float* div_out, float* depth_out,
                           float* steps_out, float* h0_out, int n, int f,
                           int k, float div_threshold, void* stream_ptr) {
  if (bad_shape(n, rows, f) || k < 1 || k > MAXK) return cudaErrorInvalidValue;
  const TransitionArgs A{q, pe, grad, eps, inv_mass, draws, q_out, pe_out,
                         g_out, acc_out, div_out, depth_out, steps_out,
                         h0_out, k, div_threshold};
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  return with_features(f, [&](auto fc) {
    constexpr int F = decltype(fc)::value;
    const auto run = [&](auto pot) {
      const size_t bytes = 4 * transition_smem_floats<kHierThreads>(
                                   pot.dim(), k, pot.smem_floats());
      const auto kernel = nuts_kernel<kHierThreads, decltype(pot)>;
      cudaError_t err = prepare(kernel, bytes);
      if (err != cudaSuccess) return (int)err;
      kernel<<<n, kHierThreads, bytes, stream>>>(pot, A);
      return (int)cudaGetLastError();
    };
    return smem_bytes<F, true>(rows, k) <= kMaxSmem
               ? run(make_hier<F, true>(rows))
               : run(make_hier<F, false>(rows));
  });
}

}  // namespace

extern "C" {

// The launch geometry of a transition at K = k doublings (k = 0: of the
// potential entry): out = {threads a block, bytes of dynamic shared memory,
// 1 if the rows are resident in it or 0 if read from device memory}.
// Returns a cudaError_t (cudaErrorInvalidValue: no instance fits).
int fused_hier_nuts_geometry(int j, int f, int k, int depth, int nch,
                             int* out) {
  const HierRows rows{nullptr, nullptr, nullptr, nullptr, j, depth, nch};
  if (bad_shape(1, rows, f) || k < 0 || k > MAXK) return cudaErrorInvalidValue;
  return geometry(rows, f, k, out);
}

// One NUTS transition for each of n chains (one block each) on `stream`.
// Per-chain inputs are rows of the (n, D) / (n, K) / (n, 2^K) arrays; eps
// is one float in device memory; x, y, chunks and coff are hier_data's
// layout of the rows (HierRows; x and y 16-byte aligned); outputs
// pe/acc/div/depth/steps/h0 are (n,) floats.  Returns a cudaError_t (0 on
// success); launches only, never synchronises.
int fused_hier_nuts_transition(
    const float* q, const float* pe, const float* grad, const float* mom,
    const float* sign_dir, const float* log_u_acc, const float* log_u_leaf,
    const float* eps, const float* inv_mass, const float* x,
    const uint32_t* y, const int* chunks, const int* coff, float* q_out,
    float* pe_out, float* g_out, float* acc_out, float* div_out,
    float* depth_out, float* steps_out, float* h0_out, int n, int j, int f,
    int k, int depth, int nch, float div_threshold, void* stream_ptr) {
  return launch_hier_transition(
      q, pe, grad, injected_draws(mom, sign_dir, log_u_acc, log_u_leaf, k),
      eps, inv_mass, HierRows{x, y, chunks, coff, j, depth, nch}, q_out,
      pe_out, g_out, acc_out, div_out, depth_out, steps_out, h0_out, n, f, k,
      div_threshold, stream_ptr);
}

// The same transition with its draws made in the kernel from Philox keyed
// by (seed, phase, t) and the chain index chain0 + i of the launch's chain
// i (nuts_draws.cuh): what make_batched_transition_hier runs.
int fused_hier_nuts_transition_keyed(
    const float* q, const float* pe, const float* grad, const float* eps,
    const float* inv_mass, const float* x, const uint32_t* y,
    const int* chunks, const int* coff, float* q_out, float* pe_out,
    float* g_out, float* acc_out, float* div_out, float* depth_out,
    float* steps_out, float* h0_out, int n, int j, int f, int k, int depth,
    int nch, float div_threshold, unsigned long long seed, unsigned phase,
    unsigned t, unsigned chain0, void* stream_ptr) {
  return launch_hier_transition(
      q, pe, grad, keyed_draws(seed, phase, t, chain0, k), eps, inv_mass,
      HierRows{x, y, chunks, coff, j, depth, nch}, q_out, pe_out, g_out,
      acc_out, div_out, depth_out, steps_out, h0_out, n, f, k, div_threshold,
      stream_ptr);
}

// pe (n,) and grad (n, D) at q (n, D) with the transition's potential.
int fused_hier_nuts_potential(const float* q, const float* x,
                              const uint32_t* y, const int* chunks,
                              const int* coff, float* pe_out, float* g_out,
                              int n, int j, int f, int depth, int nch,
                              void* stream_ptr) {
  const HierRows rows{x, y, chunks, coff, j, depth, nch};
  if (bad_shape(n, rows, f)) return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  return with_features(f, [&](auto fc) {
    constexpr int F = decltype(fc)::value;
    const auto run = [&](auto pot) {
      const size_t bytes = 4 * potential_smem_floats<kHierThreads>(
                                   pot.dim(), pot.smem_floats());
      const auto kernel = potential_kernel<kHierThreads, decltype(pot)>;
      cudaError_t err = prepare(kernel, bytes);
      if (err != cudaSuccess) return (int)err;
      kernel<<<n, kHierThreads, bytes, stream>>>(pot, q, pe_out, g_out);
      return (int)cudaGetLastError();
    };
    return smem_bytes<F, true>(rows, 0) <= kMaxSmem
               ? run(make_hier<F, true>(rows))
               : run(make_hier<F, false>(rows));
  });
}

}  // extern "C"
