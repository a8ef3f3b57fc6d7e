// Batched Gaussian-mixture log-likelihood kernels, Hopper (sm_90a), fp32
// SIMT: the forward (ll per particle), the backward (cotangent times the
// parameter gradient) and the one-launch value+grad.
//
// Replaces bayesic_tpu/ops/gmm_logprob.py:_fwd_kernel (reached through
// gmm_loglik), :_bwd_kernel (gmm_loglik's VJP) and :_vg_kernel
// (gmm_loglik_grad).  Their oracles are ops/gmm_logprob.py's
// gmm_loglik_reference and gmm_loglik_grad_reference.
//
// Inputs: x (N, D) row-major; per particle log w (K,), mu (K, D), s (K,).
// One kernel template, gmm_lik_kernel<K, D, exact, mode>, runs the three
// modes on gmm_lik.cuh's log2-domain point loop, points_log2: the forward
// keeps the value's sums only (LL), the backward the gradient's only
// (GRAD), value+grad both.  Each warp evaluates its particles (W, one or
// two) over all the points, its lanes striding over them; x comes through
// dynamic shared memory at its own size, in tiles of TILE_FLOATS floats
// past 48 KB (N 6,144 at D 2), loaded by every thread of the block, so a
// block reads x from L2 once for all its particles.  The loop and the
// epilogue are one code in one order in every mode, so where two modes walk
// the same tiles the forward's ll equals the value+grad kernel's bit for
// bit and the backward's gradients are the value+grad's times the
// cotangent, the product taken last.  The TPU kernels' (D, N) transposed
// data, 512-lane blocks with masks, particle padding with s = 1 and
// lifted-feature matmul are not ported: a warp runs to the end of its own
// points and a warp with no particle only helps load the tiles.
//
// What bounds it: the SFU and the issue rate.  Per (particle, point) the
// forward takes K ex2 and 1 / kChunk of a lg2, the backward K ex2 and an
// rcp, value+grad all of them, at 16 per SM per clock, inside 34 / 48 / 50
// SASS instructions at K 3, D 2; the data are 16 KB.
//
// K = 3, D = 2 (the GMM bench) runs instances with both fixed at compile
// time, each mode at its own launch shape; at P 8,192 on an H100:
//  * value+grad: blocks of 32 warps, one an SM (56 registers a thread), one
//    particle a warp, so an SM loads x once for 32 particles; 256 blocks
//    fill 1.94 waves of 132.  32 warps beat 16 (2 an SM) by ~3% and 8 (4
//    an SM) by ~5%; 4 warps, 5 blocks of 8 an SM and two warps a particle
//    lost more.
//  * backward: the value+grad shape (55 registers); 16 and 8 warps a
//    block were 3% and 7% slower.
//  * forward: blocks of 32 warps, two an SM (32 registers, 8 bytes of
//    spill outside the loop), one particle a warp: 256 blocks in one wave
//    of 264.  One block an SM (48 registers) was 2.5% slower, two
//    particles a warp (one block an SM, 31.5 instructions a pair) 1% and
//    four blocks of 16 warps 4%.
// tools/gmm_lik_ablation.py times the alternatives.  Other K <= 8, D <= 4
// run one generic instance a mode, 8 warps a block, one particle a warp.

#include <cuda_runtime.h>

#include <cstddef>

#include "gmm_lik.cuh"

namespace {

constexpr int GL_NT = 256;                // the generic instances' threads
// the most x floats a block holds at once (48 KB: no launch needs the
// opt-in above 48 KB, and two blocks fit an SM)
constexpr int TILE_FLOATS = 12288;
// the K 3, D 2 instances: threads a block, the resident blocks an SM each
// is built for, and the forward's particles a warp
constexpr int FWD_NT = 1024;
constexpr int FWD_MIN_BLOCKS = 2;
constexpr int FWD_W = 1;
constexpr int BWD_NT = 1024;
constexpr int BWD_MIN_BLOCKS = 1;
constexpr int VG_NT = 1024;
constexpr int VG_MIN_BLOCKS = 1;

enum Mode { FWD = 0, BWD = 1, VG = 2 };

// An instance's launch: threads a block, the resident blocks an SM it is
// built for (__launch_bounds__), particles a warp.
struct Shape {
  int nt, min_blocks, w;
};

template <int MODE, bool EXACT>
__host__ __device__ constexpr Shape shape() {
  return !EXACT        ? Shape{GL_NT, 1, 1}
         : MODE == FWD ? Shape{FWD_NT, FWD_MIN_BLOCKS, FWD_W}
         : MODE == BWD ? Shape{BWD_NT, BWD_MIN_BLOCKS, 1}
                       : Shape{VG_NT, VG_MIN_BLOCKS, 1};
}

static_assert(FWD_MIN_BLOCKS * (TILE_FLOATS * 4 + 1024) <= kGmmMaxSmem &&
                  BWD_MIN_BLOCKS * (TILE_FLOATS * 4 + 1024) <= kGmmMaxSmem &&
                  VG_MIN_BLOCKS * (TILE_FLOATS * 4 + 1024) <= kGmmMaxSmem,
              "the x tiles of an instance's resident blocks fit an SM");

// Each warp's W particles (lane 0 writes): with LL ll, with GRAD the three
// gradients, times ct[pi] in the backward.
template <int MK, int MD, bool EXACT, int MODE>
__global__ void __launch_bounds__(shape<MODE, EXACT>().nt,
                                  shape<MODE, EXACT>().min_blocks)
    gmm_lik_kernel(const float* __restrict__ x, const float* __restrict__ logw,
                   const float* __restrict__ mus,
                   const float* __restrict__ sig,
                   const float* __restrict__ ct, float* __restrict__ ll_out,
                   float* __restrict__ dlogw, float* __restrict__ dmus,
                   float* __restrict__ dsig, int p, int n, int k_rt,
                   int d_rt) {
  constexpr bool LL = MODE != BWD, GRAD = MODE != FWD;
  constexpr int NT = shape<MODE, EXACT>().nt, W = shape<MODE, EXACT>().w;
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);
  const int k = EXACT ? MK : k_rt, d = EXACT ? MD : d_rt;
  const int lane = threadIdx.x & 31;
  const int p0 = (blockIdx.x * (NT / 32) + (threadIdx.x >> 5)) * W;
  const bool live = p0 < p;
  Mix2<MK, MD, W> m;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int pi = p0 + w;
#pragma unroll
    for (int kk = 0; kk < MK; ++kk) {
      const bool on = pi < p && kk < k;
      const float s = on ? sig[(size_t)pi * k + kk] : 1.f;
      const float lw = on ? logw[(size_t)pi * k + kk] : 0.f;
      m.c[w][kk] =
          kLog2e * (lw - (float)d * logf(s) - (float)d * kHalfLog2Pi);
      m.h[w][kk] = kLog2e * 0.5f / (s * s);
#pragma unroll
      for (int j = 0; j < MD; ++j)
        m.mu[w][kk][j] =
            on && j < d ? mus[((size_t)pi * k + kk) * d + j] : 0.f;
    }
  }
  Acc2<MK, MD, W, LL, GRAD> s;
  s.zero();
  const int tile = TILE_FLOATS / d;        // points per tile
  for (int t0 = 0; t0 < n; t0 += tile) {
    const int cnt = min(tile, n - t0);
    if (t0 > 0) __syncthreads();           // every warp is past the last tile
    for (int i = threadIdx.x; i < cnt * d; i += NT)
      xs[i] = x[(size_t)t0 * d + i];
    __syncthreads();
    if (live) points_log2<MK, MD, EXACT, W>(m, xs, lane, cnt, k, d, s);
  }
  if (!live) return;                       // whole warps only
  s.butterfly(k, d);
  if (lane != 0) return;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int pi = p0 + w;
    if (pi >= p) return;
    if constexpr (LL) ll_out[pi] = kLn2 * s.ll[w];
    if constexpr (GRAD) {
      const float c = MODE == BWD ? ct[pi] : 1.f;
#pragma unroll
      for (int kk = 0; kk < MK; ++kk) {
        if (kk < k) {
          const size_t o = (size_t)pi * k + kk;
          const float sg = sig[o];
          const float inv_s2 = 1.f / (sg * sg);
          dlogw[o] = c * s.r[w][kk];
#pragma unroll
          for (int j = 0; j < MD; ++j)
            if (j < d) dmus[o * d + j] = c * (s.rdx[w][kk][j] * inv_s2);
          dsig[o] =
              c * ((s.rq[w][kk] * inv_s2 - (float)d * s.r[w][kk]) / sg);
        }
      }
    }
  }
}

bool valid(int p, int n, int k, int d) {
  return p > 0 && n > 0 && k >= 1 && k <= GMM_MAXK && d >= 1 &&
         d <= GMM_MAXD;
}

template <int MODE>
Shape launch_shape(int k, int d) {
  return k == 3 && d == 2 ? shape<MODE, true>() : shape<MODE, false>();
}

// Dynamic shared bytes of a launch: x, or one tile of it.
size_t smem_bytes(int n, int d) {
  const int tile = TILE_FLOATS / d;
  return 4 * (size_t)(n < tile ? n : tile) * d;
}

int blocks(int p, const Shape& sh) {
  const int per = sh.nt / 32 * sh.w;
  return (p + per - 1) / per;
}

// The launch; with `resident` set, only the blocks of its instance that
// an SM can hold at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <int MODE>
int launch(const float* x, const float* logw, const float* mus,
           const float* sig, const float* ct, float* ll, float* dlogw,
           float* dmus, float* dsig, int p, int n, int k, int d,
           void* stream_ptr, int* resident = nullptr) {
  if (!valid(p, n, k, d)) return cudaErrorInvalidValue;
  const Shape sh = launch_shape<MODE>(k, d);
  const size_t bytes = smem_bytes(n, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  auto kernel = k == 3 && d == 2
                    ? gmm_lik_kernel<3, 2, true, MODE>
                    : gmm_lik_kernel<GMM_MAXK, GMM_MAXD, false, MODE>;
  if (resident)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                         sh.nt, bytes);
  kernel<<<blocks(p, sh), sh.nt, bytes, st>>>(x, logw, mus, sig, ct, ll,
                                              dlogw, dmus, dsig, p, n, k, d);
  return cudaGetLastError();
}

template <int MODE>
int geometry(int p, int n, int k, int d, int* out) {
  const Shape sh = launch_shape<MODE>(k, d);
  const int tile = TILE_FLOATS / d;
  out[0] = sh.nt;
  out[1] = sh.w;
  out[2] = sh.nt / 32 * sh.w;
  out[3] = blocks(p, sh);
  out[4] = (int)smem_bytes(n, d);
  out[5] = (n + tile - 1) / tile;
  return launch<MODE>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, nullptr, p, n, k, d, nullptr,
                      &out[6]);
}

}  // namespace

extern "C" {

// ll (p,) at x (n, d), logw (p, k), mus (p, k, d), sig (p, k).  Each entry
// returns a cudaError_t (0 on success); launches only, never synchronises.
int gmm_loglik_fwd(const float* x, const float* logw, const float* mus,
                   const float* sig, float* ll, int p, int n, int k, int d,
                   void* stream) {
  return launch<FWD>(x, logw, mus, sig, nullptr, ll, nullptr, nullptr,
                     nullptr, p, n, k, d, stream);
}

// ct (p,) times d ll / d (logw, mus, sig).
int gmm_loglik_bwd(const float* x, const float* logw, const float* mus,
                   const float* sig, const float* ct, float* dlogw,
                   float* dmus, float* dsig, int p, int n, int k, int d,
                   void* stream) {
  return launch<BWD>(x, logw, mus, sig, ct, nullptr, dlogw, dmus, dsig, p,
                     n, k, d, stream);
}

// ll and d ll / d (logw, mus, sig) in one launch.
int gmm_loglik_vg(const float* x, const float* logw, const float* mus,
                  const float* sig, float* ll, float* dlogw, float* dmus,
                  float* dsig, int p, int n, int k, int d, void* stream) {
  return launch<VG>(x, logw, mus, sig, nullptr, ll, dlogw, dmus, dsig, p, n,
                    k, d, stream);
}

// The launch of `mode` (0 forward, 1 backward, 2 value+grad) at (p, n, k,
// d): out[0] threads a block, out[1] particles a warp, out[2] particles a
// block, out[3] blocks, out[4] dynamic shared bytes, out[5] x tiles, out[6]
// the blocks an SM can hold at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns a cudaError_t.
int gmm_loglik_geometry(int mode, int p, int n, int k, int d, int* out) {
  if (!valid(p, n, k, d)) return cudaErrorInvalidValue;
  switch (mode) {
    case FWD:
      return geometry<FWD>(p, n, k, d, out);
    case BWD:
      return geometry<BWD>(p, n, k, d, out);
    case VG:
      return geometry<VG>(p, n, k, d, out);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
