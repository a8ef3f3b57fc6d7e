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
// A block evaluates one particle a warp (gmm_lik.cuh): the lanes stride
// over the points, which come through shared memory, so one block reads x
// from L2 once for all its particles.  The TPU kernels' (D, N)
// transposed data, 512-lane blocks with masks, particle padding with s = 1
// and lifted-feature matmul are not ported: a warp runs to the end of its
// own points and a missing particle's warp only helps load the tiles.
//
// What bounds it: the SFU and the issue rate.  Per (particle, point) the
// forward takes K exps and a log, the backward K exps and a reciprocal,
// value+grad K exps, a reciprocal and 1 / kChunk of a log, at 16 per SM per
// clock; the data are 16 KB.
//
// The forward and backward run gmm_lik.cuh's accumulate (accurate expf,
// logf and reciprocal) over x in tiles of 8192 floats of static shared
// memory.  The value+grad kernel runs points_log2, the SMC mutation's
// log2-domain loop (~50 SASS instructions a particle-point at K 3, D 2,
// against ~118 for accumulate), over x in dynamic shared memory at its own
// size, in tiles only past VG_TILE_FLOATS (N 6,144 at D 2).  Its K 3, D 2
// instance runs blocks of 32 warps, one an SM (64 registers a thread), so
// an SM loads x once for 32 particles: at P 8,192 its 256 blocks fill 1.94
// waves of 132, the last 94% full.  Blocks of 32 warps beat 16 (2 an SM)
// by ~3% and 8 (4 an SM) by ~5%; 4 warps, 5 blocks of 8 an SM and two
// warps a particle lost more (tools/gmm_vg_ablation.py times them).  The
// generic instance (~200 registers) and the forward and backward kernels
// run 8 warps a block.
//
// K = 3, D = 2 (the GMM bench) runs an instantiation with both fixed at
// compile time; other K <= 8, D <= 4 run a general one.

#include <cuda_runtime.h>

#include <cstddef>

#include "gmm_lik.cuh"

namespace {

constexpr int GL_NT = 256;                // threads per block
constexpr int TILE_FLOATS = 8192;         // forward/backward: x tile floats
// value+grad: the K 3, D 2 instance's threads a block and the resident
// blocks an SM it is built for, and the most x floats a block holds at
// once (48 KB: VG_MIN_BLOCKS of them fit an SM's shared memory, and no
// launch needs the opt-in above 48 KB)
constexpr int VG_NT = 1024;
constexpr int VG_MIN_BLOCKS = 1;
constexpr int VG_TILE_FLOATS = 12288;
static_assert(VG_MIN_BLOCKS * (VG_TILE_FLOATS * 4 + 1024) <= kGmmMaxSmem,
              "the value+grad tiles of VG_MIN_BLOCKS blocks fit an SM");

enum Mode { FWD = 0, BWD = 1, VG = 2 };

// Threads a block of an instance, one warp per particle.
template <int MODE, bool EXACT>
__host__ __device__ constexpr int block_threads() {
  return MODE == VG && EXACT ? VG_NT : GL_NT;
}

// One particle's value and gradient by the log2-domain loop (lane 0
// writes): x in tiles of dynamic shared memory, loaded by the NT threads of
// the block, one warp per particle.
template <int MK, int MD, bool EXACT, int NT>
__device__ __forceinline__ void value_grad(
    const float* __restrict__ x, const float* __restrict__ logw,
    const float* __restrict__ mus, const float* __restrict__ sig,
    float* __restrict__ ll_out, float* __restrict__ dlogw,
    float* __restrict__ dmus, float* __restrict__ dsig, int pi, bool live,
    int n, int k, int d, int lane) {
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);
  Mix2<MK, MD, 1> m;
#pragma unroll
  for (int kk = 0; kk < MK; ++kk) {
    const bool on = live && kk < k;
    const float s = on ? sig[(size_t)pi * k + kk] : 1.f;
    const float lw = on ? logw[(size_t)pi * k + kk] : 0.f;
    m.c[0][kk] =
        kLog2e * (lw - (float)d * logf(s) - (float)d * kHalfLog2Pi);
    m.h[0][kk] = kLog2e * 0.5f / (s * s);
#pragma unroll
    for (int j = 0; j < MD; ++j)
      m.mu[0][kk][j] = on && j < d ? mus[((size_t)pi * k + kk) * d + j] : 0.f;
  }
  Acc2<MK, MD, 1> s;
  s.zero();
  const int tile = VG_TILE_FLOATS / d;     // points per tile
  for (int t0 = 0; t0 < n; t0 += tile) {
    const int cnt = min(tile, n - t0);
    if (t0 > 0) __syncthreads();           // every warp is past the last tile
    for (int i = threadIdx.x; i < cnt * d; i += NT)
      xs[i] = x[(size_t)t0 * d + i];
    __syncthreads();
    if (live) points_log2<MK, MD, EXACT, 1>(m, xs, lane, cnt, k, d, s);
  }
  if (!live) return;                       // whole warps only
  s.butterfly(k, d);
  if (lane != 0) return;
  ll_out[pi] = kLn2 * s.ll[0];
#pragma unroll
  for (int kk = 0; kk < MK; ++kk) {
    if (kk < k) {
      const size_t o = (size_t)pi * k + kk;
      const float sg = sig[o];
      const float inv_s2 = 1.f / (sg * sg);
      dlogw[o] = s.r[0][kk];
#pragma unroll
      for (int j = 0; j < MD; ++j)
        if (j < d) dmus[o * d + j] = s.rdx[0][kk][j] * inv_s2;
      dsig[o] = (s.rq[0][kk] * inv_s2 - (float)d * s.r[0][kk]) / sg;
    }
  }
}

template <int MK, int MD, bool EXACT, int MODE>
__global__ void __launch_bounds__(MODE == VG && EXACT ? VG_NT : GL_NT,
                                  MODE == VG && EXACT ? VG_MIN_BLOCKS : 1)
    gmm_lik_kernel(const float* __restrict__ x, const float* __restrict__ logw,
                   const float* __restrict__ mus,
                   const float* __restrict__ sig,
                   const float* __restrict__ ct, float* __restrict__ ll_out,
                   float* __restrict__ dlogw, float* __restrict__ dmus,
                   float* __restrict__ dsig, int p, int n, int k_rt,
                   int d_rt) {
  constexpr bool LL = MODE != BWD, GRAD = MODE != FWD;
  constexpr int NT = block_threads<MODE, EXACT>();
  const int k = EXACT ? MK : k_rt, d = EXACT ? MD : d_rt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pi = blockIdx.x * (NT / 32) + warp;
  const bool live = pi < p;
  if constexpr (MODE == VG) {
    value_grad<MK, MD, EXACT, NT>(x, logw, mus, sig, ll_out, dlogw, dmus,
                                  dsig, pi, live, n, k, d, lane);
  } else {
    __shared__ float xs[TILE_FLOATS];
    Mix<MK, MD> m;
    float sk[MK];
#pragma unroll
    for (int kk = 0; kk < MK; ++kk) {
      const bool on = live && kk < k;
      const float s = on ? sig[(size_t)pi * k + kk] : 1.f;
      const float lw = on ? logw[(size_t)pi * k + kk] : 0.f;
      sk[kk] = s;
      m.c[kk] = lw - (float)d * logf(s) - (float)d * kHalfLog2Pi;
      m.h[kk] = 0.5f / (s * s);
#pragma unroll
      for (int j = 0; j < MD; ++j)
        m.mu[kk][j] = on && j < d ? mus[((size_t)pi * k + kk) * d + j] : 0.f;
    }
    Sums<MK, MD> s;
    s.zero();
    const int tile = TILE_FLOATS / d;       // points per tile
    for (int t0 = 0; t0 < n; t0 += tile) {
      const int cnt = min(tile, n - t0);
      __syncthreads();
      for (int i = threadIdx.x; i < cnt * d; i += GL_NT)
        xs[i] = x[(size_t)t0 * d + i];
      __syncthreads();
      if (live) accumulate<MK, MD, LL, GRAD>(m, xs, lane, cnt, k, d, s);
    }
    if (!live) return;                       // whole warps only
    reduce<MK, MD, LL, GRAD>(s, k, d);
    if (lane != 0) return;
    if (LL) ll_out[pi] = s.ll;
    if (GRAD) {
      const float w = MODE == BWD ? ct[pi] : 1.f;
#pragma unroll
      for (int kk = 0; kk < MK; ++kk) {
        if (kk < k) {
          const float inv_s2 = 2.f * m.h[kk];
          const size_t o = (size_t)pi * k + kk;
          dlogw[o] = w * s.r[kk];
#pragma unroll
          for (int j = 0; j < MD; ++j)
            if (j < d) dmus[o * d + j] = w * (s.rdx[kk][j] * inv_s2);
          dsig[o] = w * ((s.rq[kk] * inv_s2 - (float)d * s.r[kk]) / sk[kk]);
        }
      }
    }
  }
}

bool valid(int p, int n, int k, int d) {
  return p > 0 && n > 0 && k >= 1 && k <= GMM_MAXK && d >= 1 &&
         d <= GMM_MAXD;
}

// Dynamic shared bytes of a launch: the value+grad kernel's x tile.
template <int MODE>
size_t smem_bytes(int n, int d) {
  const int tile = VG_TILE_FLOATS / d;
  return MODE == VG ? 4 * (size_t)(n < tile ? n : tile) * d : 0;
}

template <int MODE>
int threads(int k, int d) {
  return k == 3 && d == 2 ? block_threads<MODE, true>()
                          : block_threads<MODE, false>();
}

int blocks(int p, int nt) { return (p + nt / 32 - 1) / (nt / 32); }

// The launch; with `resident` set, only the blocks of its instance that
// an SM can hold at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <int MODE>
int launch(const float* x, const float* logw, const float* mus,
           const float* sig, const float* ct, float* ll, float* dlogw,
           float* dmus, float* dsig, int p, int n, int k, int d,
           void* stream_ptr, int* resident = nullptr) {
  if (!valid(p, n, k, d)) return cudaErrorInvalidValue;
  const int nt = threads<MODE>(k, d);
  const size_t bytes = smem_bytes<MODE>(n, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  auto kernel = k == 3 && d == 2
                    ? gmm_lik_kernel<3, 2, true, MODE>
                    : gmm_lik_kernel<GMM_MAXK, GMM_MAXD, false, MODE>;
  if (resident)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                         nt, bytes);
  kernel<<<blocks(p, nt), nt, bytes, st>>>(x, logw, mus, sig, ct, ll, dlogw,
                                           dmus, dsig, p, n, k, d);
  return cudaGetLastError();
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

// The value+grad launch at (p, n, k, d): out[0] threads per block, out[1]
// particles per block, out[2] blocks, out[3] dynamic shared bytes, out[4]
// x tiles, out[5] the blocks an SM can hold at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns a cudaError_t.
int gmm_loglik_vg_geometry(int p, int n, int k, int d, int* out) {
  if (!valid(p, n, k, d)) return cudaErrorInvalidValue;
  const int tile = VG_TILE_FLOATS / d;
  out[0] = threads<VG>(k, d);
  out[1] = out[0] / 32;
  out[2] = blocks(p, out[0]);
  out[3] = (int)smem_bytes<VG>(n, d);
  out[4] = (n + tile - 1) / tile;
  return launch<VG>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, p, n, k, d, nullptr, &out[5]);
}

}  // extern "C"
