// Whole-run fused DLGM/VAE trainer for Hopper (sm_90a), fp32 SIMT.
//
// Replaces bayesic_tpu/ops/fused_vae.py:_train_kernel (Philox streams) and
// :_injected_kernel (injected idx/eps streams).  One call of
// fused_vae_train enqueues every SVI step on the caller's stream; the data,
// parameters and Adam state stay in device memory and no step waits on the
// host.  Each step is three launches:
//
//   1. row_kernel: ROWS rows per block.  Philox indices, exact row gather,
//      encoder MLP, reparameterised z, decoder, and the per-row backward
//      (g_mx, g_a1d, g_z, g_pre, g_a1e) plus per-row loss and g_usig terms.
//   2. atg_kernel: every weight gradient A^T G over the batch, every bias
//      gradient (A = ones), and the scalar sums, as one table of 32x32
//      output tiles.  Each tile walks the batch in a fixed order: no float
//      atomics, so a run repeats bit for bit.
//   3. adam_kernel: Adam with bias correction at the global step over one
//      flat buffer that holds all 11 leaves; writes the step's loss.
//
// What bounds it: about 553 MFLOP per step at N=65,536, D=128, Z=32, H=256,
// B=1024 (benchmarks/roofline.py dlgm_svi), spread over three small
// launches; the 90k weights live in L2.  At this size the step is bound by
// launch overhead and by the latency of small tiles, not by FLOPs or bytes.
// A persistent kernel or a CUDA graph over the step loop is the later fix;
// every product is fp32 FMA here (no tensor cores), which the parity tests
// rest on.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "kernel_common.cuh"

namespace {

constexpr int ROWS = 8;      // rows per row_kernel block (ops/fused_vae.py)
constexpr int NT = 256;      // threads per block
constexpr int TILE = 32;     // atg_kernel output tile edge
constexpr int NJOBS = 11;    // 10 leaf products + the scalar sums
constexpr float kC = 0.91893853320467274f;   // 0.5 ln 2pi

struct Leaves {
  const float *w1e, *b1e, *wmu, *bmu, *wsig, *bsig, *w1d, *b1d, *w2d, *b2d,
      *usig;
};

struct Scratch {
  float *xb, *h1, *zl, *hd, *gmx, *ga1d, *gz, *gpre, *ga1e, *rowstat, *grad;
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

__host__ size_t scratch_floats(int d, int h, int z, int b) {
  // xb, gmx: b*d; h1, hd, ga1d, ga1e: b*h; zl, gz, gpre: b*z; rowstat: b*2;
  // grad: all leaves + 1 (the elbo sum sits right after g_usig)
  return (size_t)b * (2 * d + 4 * h + 3 * z + 2) + offsets(d, h, z).total + 1;
}

__host__ size_t row_smem_bytes(const Dims& D) {
  return sizeof(float) * ROWS * (2 * D.d + 3 * D.h + 6 * D.z);
}

// acc[r] += sum_k in[r][k] * W[k][j]     (W row-major (K, out))
__device__ __forceinline__ void dense_nn(const float* in, int K,
                                         const float* __restrict__ W, int out,
                                         int j, float (&acc)[ROWS]) {
  for (int k = 0; k < K; ++k) {
    const float w = W[(size_t)k * out + j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(in[r * K + k], w, acc[r]);
  }
}

// acc[r] += sum_k in[r][k] * W[j][k]     (W row-major (rows, K): in W^T)
__device__ __forceinline__ void dense_nt(const float* in, int K,
                                         const float* __restrict__ W, int j,
                                         float (&acc)[ROWS]) {
  const float* wr = W + (size_t)j * K;
  for (int k = 0; k < K; ++k) {
    const float w = wr[k];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(in[r * K + k], w, acc[r]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block = ROWS consecutive batch rows.  idx_in/eps_in are null for the
// Philox path, else this step's slice of the injected streams.
__global__ void __launch_bounds__(NT)
row_kernel(const float* __restrict__ x, Leaves P, Scratch S, Dims D,
           const int* __restrict__ idx_in, const float* __restrict__ eps_in,
           unsigned long long step, uint32_t k0, uint32_t k1, float scale) {
  extern __shared__ float sm[];
  const int d = D.d, h = D.h, z = D.z;
  float* xs = sm;                  // ROWS*d  gathered rows
  float* gmx = xs + ROWS * d;      // ROWS*d  d elbo / d mx
  float* h1 = gmx + ROWS * d;      // ROWS*h
  float* hd = h1 + ROWS * h;       // ROWS*h
  float* ga = hd + ROWS * h;       // ROWS*h  d elbo / d a1d
  float* zl = ga + ROWS * h;       // ROWS*z
  float* ep = zl + ROWS * z;       // ROWS*z  noise
  float* ls = ep + ROWS * z;       // ROWS*z  clipped log sigma
  float* pre = ls + ROWS * z;      // ROWS*z  unclipped log sigma
  float* gz = pre + ROWS * z;      // ROWS*z  mu, then d elbo / d z
  float* gp = gz + ROWS * z;       // ROWS*z  d elbo / d pre
  __shared__ int sidx[ROWS];
  __shared__ float wred[NT / 32][ROWS][2];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const uint32_t t_lo = (uint32_t)step, t_hi = (uint32_t)(step >> 32);
  float pe[ROWS], pu[ROWS];   // per-row elbo and g_usig partial sums
#pragma unroll
  for (int r = 0; r < ROWS; ++r) pe[r] = pu[r] = 0.f;

  // -- streams: lane 0 the row index, lane 1+l the noise eps[row, l]
  if (tid < ROWS) {
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
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
    for (int l = tid; l < z; l += NT) {
      float e;
      if (eps_in) {
        e = eps_in[(size_t)row * z + l];
      } else {
        const bt::U4 w = bt::philox4x32_10(
            bt::U4{t_lo, (uint32_t)row, (uint32_t)(1 + l), t_hi}, k0, k1);
        e = bt::box_muller(w.x, w.y);
      }
      ep[r * z + l] = e;
    }
  }
  __syncthreads();

  // -- exact with-replacement gather
  for (int e = tid; e < ROWS * d; e += NT) {
    const int r = e / d, c = e - r * d;
    const float val = x[(size_t)sidx[r] * d + c];
    xs[e] = val;
    S.xb[(size_t)row0 * d + e] = val;
  }
  __syncthreads();

  // -- encoder hidden layer
  for (int j = tid; j < h; j += NT) {
    float acc[ROWS] = {};
    dense_nn(xs, d, P.w1e, h, j, acc);
    const float bj = P.b1e[j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = tanhf(acc[r] + bj);
      h1[r * h + j] = v;
      S.h1[(size_t)(row0 + r) * h + j] = v;
    }
  }
  __syncthreads();

  // -- mu (into gz for now) and pre
  for (int j = tid; j < 2 * z; j += NT) {
    const bool is_mu = j < z;
    const int c = is_mu ? j : j - z;
    float acc[ROWS] = {};
    dense_nn(h1, h, is_mu ? P.wmu : P.wsig, z, c, acc);
    const float bj = is_mu ? P.bmu[c] : P.bsig[c];
    float* dst = is_mu ? gz : pre;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) dst[r * z + c] = acc[r] + bj;
  }
  __syncthreads();

  // -- reparameterised z; prior and -log q terms
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    for (int l = tid; l < z; l += NT) {
      const int e = r * z + l;
      const float lsv = fminf(fmaxf(pre[e], -6.f), 3.f);
      const float eps = ep[e];
      const float zv = gz[e] + expf(lsv) * eps;
      ls[e] = lsv;
      zl[e] = zv;
      S.zl[(size_t)(row0 + r) * z + l] = zv;
      pe[r] += (-0.5f * zv * zv - kC) - (-lsv - 0.5f * eps * eps - kC);
    }
  }
  __syncthreads();

  // -- decoder hidden layer
  for (int j = tid; j < h; j += NT) {
    float acc[ROWS] = {};
    dense_nn(zl, z, P.w1d, h, j, acc);
    const float bj = P.b1d[j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = tanhf(acc[r] + bj);
      hd[r * h + j] = v;
      S.hd[(size_t)(row0 + r) * h + j] = v;
    }
  }
  __syncthreads();

  // -- decoder output, likelihood terms and d elbo / d mx
  const float us = P.usig[0];
  const float inv_s2 = expf(-2.f * us);
  for (int j = tid; j < d; j += NT) {
    float acc[ROWS] = {};
    dense_nn(hd, h, P.w2d, d, j, acc);
    const float bj = P.b2d[j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float res = (acc[r] + bj) - xs[r * d + j];
      const float g = -scale * res * inv_s2;
      gmx[r * d + j] = g;
      S.gmx[(size_t)(row0 + r) * d + j] = g;
      pe[r] += -0.5f * res * res * inv_s2 - us - kC;
      pu[r] += res * res * inv_s2 - 1.f;
    }
  }
  __syncthreads();

  // -- g_a1d = (g_mx W2d^T) * (1 - hd^2)
  for (int j = tid; j < h; j += NT) {
    float acc[ROWS] = {};
    dense_nt(gmx, d, P.w2d, j, acc);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float hv = hd[r * h + j];
      const float g = acc[r] * (1.f - hv * hv);
      ga[r * h + j] = g;
      S.ga1d[(size_t)(row0 + r) * h + j] = g;
    }
  }
  __syncthreads();

  // -- g_z = g_a1d W1d^T - s z + s eps e^{-ls};  g_pre = g_z eps e^ls mask
  for (int j = tid; j < z; j += NT) {
    float acc[ROWS] = {};
    dense_nt(ga, h, P.w1d, j, acc);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int e = r * z + j;
      const float lsv = ls[e], eps = ep[e], p = pre[e];
      const float g = acc[r] - scale * zl[e] + scale * eps * expf(-lsv);
      const float mask = (p > -6.f && p < 3.f) ? 1.f : 0.f;
      const float gpv = g * eps * expf(lsv) * mask;
      gz[e] = g;
      gp[e] = gpv;
      S.gz[(size_t)(row0 + r) * z + j] = g;
      S.gpre[(size_t)(row0 + r) * z + j] = gpv;
    }
  }
  __syncthreads();

  // -- g_a1e = (g_z Wmu^T + g_pre Wsig^T) * (1 - h1^2)
  for (int j = tid; j < h; j += NT) {
    float a1[ROWS] = {}, a2[ROWS] = {};
    dense_nt(gz, z, P.wmu, j, a1);
    dense_nt(gp, z, P.wsig, j, a2);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float hv = h1[r * h + j];
      S.ga1e[(size_t)(row0 + r) * h + j] = (a1[r] + a2[r]) * (1.f - hv * hv);
    }
  }

  // -- per-row sums, fixed order: warp tree, then warps in order.
  //    rowstat[row] = (s * g_usig term, s * elbo term)
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float su = warp_sum(pu[r]);
    const float se = warp_sum(pe[r]);
    if (lane == 0) {
      wred[warp][r][0] = su;
      wred[warp][r][1] = se;
    }
  }
  __syncthreads();
  if (tid < 2 * ROWS) {
    const int r = tid >> 1, c = tid & 1;
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += wred[w][r][c];
    S.rowstat[(size_t)(row0 + r) * 2 + c] = scale * s;
  }
}

// C (M x N) = A^T G with A (K x M), G (K x N), all row-major; A == nullptr
// stands for a column of ones (M == 1): column sums of G.
struct Job {
  const float* A;
  const float* G;
  float* C;
  int M, N;
};

struct Jobs {
  Job job[NJOBS];
  int start[NJOBS + 1];   // first tile of each job; start[NJOBS] = total
  int K;
};

__global__ void __launch_bounds__(NT) atg_kernel(Jobs J) {
  int q = 0;
  while (q + 1 < NJOBS && (int)blockIdx.x >= J.start[q + 1]) ++q;
  const Job jb = J.job[q];
  const int t = blockIdx.x - J.start[q];
  const int tiles_n = (jb.N + TILE - 1) / TILE;
  const int m0 = (t / tiles_n) * TILE, n0 = (t % tiles_n) * TILE;
  __shared__ float As[TILE][TILE + 1];
  __shared__ float Gs[TILE][TILE + 1];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;   // ty in [0, 8)
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < J.K; k0 += TILE) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = ty + 8 * i, k = k0 + kk;
      const int m = m0 + tx, n = n0 + tx;
      As[kk][tx] = (k < J.K && m < jb.M)
                       ? (jb.A ? jb.A[(size_t)k * jb.M + m] : 1.f) : 0.f;
      Gs[kk][tx] = (k < J.K && n < jb.N) ? jb.G[(size_t)k * jb.N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TILE; ++kk) {
      const float g = Gs[kk][tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(As[kk][ty + 8 * i], g, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 8 * i, n = n0 + tx;
    if (m < jb.M && n < jb.N) jb.C[(size_t)m * jb.N + n] = acc[i];
  }
}

// grad[0..P) ascent directions in leaf order, grad[P] the step's elbo.
__global__ void __launch_bounds__(NT)
adam_kernel(float* __restrict__ p, float* __restrict__ m,
            float* __restrict__ v, const float* __restrict__ grad, int P,
            float t, float lr, float* __restrict__ losses, int slot) {
  const float bc1 = 1.f - expf(t * bt::kLnB1);
  const float bc2 = 1.f - expf(t * bt::kLnB2);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < P;
       i += gridDim.x * blockDim.x) {
    float pv = p[i], mv = m[i], vv = v[i];
    bt::adam_elem(pv, mv, vv, grad[i], bc1, bc2, lr);
    p[i] = pv;
    m[i] = mv;
    v[i] = vv;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) losses[slot] = -grad[P];
}

}  // namespace

extern "C" {

size_t fused_vae_scratch_floats(int d, int h, int z, int b) {
  return scratch_floats(d, h, z, b);
}

const char* bt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs `steps` steps.  params/m/v: flat buffers in LEAVES order, updated in
// place.  idx/eps: null for in-kernel Philox streams keyed by `seed` with
// counter (t0+i, row, lane); else injected streams (steps*b) and
// (steps*b*z).  losses[i / thin] = -elbo of step i (later steps overwrite).
// Returns a cudaError_t (0 on success); launches only, never synchronises.
int fused_vae_train(const float* x, float* params, float* m, float* v,
                    float* losses, float* scratch, const int* idx,
                    const float* eps, int n, int d, int h, int z, int b,
                    int steps, long long t0, int thin, float lr, float scale,
                    unsigned long long seed, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || d <= 0 || h <= 0 || z <= 0 || b <= 0 || b % ROWS ||
      steps < 0 || thin < 1 || t0 < 0)
    return cudaErrorInvalidValue;
  const Dims D{n, d, h, z, b};
  const Offsets o = offsets(d, h, z);
  const size_t smem = row_smem_bytes(D);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  const Leaves P{params + o.w1e, params + o.b1e,  params + o.wmu,
                 params + o.bmu, params + o.wsig, params + o.bsig,
                 params + o.w1d, params + o.b1d,  params + o.w2d,
                 params + o.b2d, params + o.usig};
  Scratch S;
  float* s = scratch;
  S.xb = s; s += (size_t)b * d;
  S.gmx = s; s += (size_t)b * d;
  S.h1 = s; s += (size_t)b * h;
  S.hd = s; s += (size_t)b * h;
  S.ga1d = s; s += (size_t)b * h;
  S.ga1e = s; s += (size_t)b * h;
  S.zl = s; s += (size_t)b * z;
  S.gz = s; s += (size_t)b * z;
  S.gpre = s; s += (size_t)b * z;
  S.rowstat = s; s += (size_t)b * 2;
  S.grad = s;
  float* g = S.grad;

  Jobs J;
  J.K = b;
  const Job jobs[NJOBS] = {
      {S.xb, S.ga1e, g + o.w1e, d, h},   {nullptr, S.ga1e, g + o.b1e, 1, h},
      {S.h1, S.gz, g + o.wmu, h, z},     {nullptr, S.gz, g + o.bmu, 1, z},
      {S.h1, S.gpre, g + o.wsig, h, z},  {nullptr, S.gpre, g + o.bsig, 1, z},
      {S.zl, S.ga1d, g + o.w1d, z, h},   {nullptr, S.ga1d, g + o.b1d, 1, h},
      {S.hd, S.gmx, g + o.w2d, h, d},    {nullptr, S.gmx, g + o.b2d, 1, d},
      // (g_usig, elbo) into grad[usig] and grad[P]: usig is the last leaf
      {nullptr, S.rowstat, g + o.usig, 1, 2},
  };
  int tiles = 0;
  for (int q = 0; q < NJOBS; ++q) {
    J.job[q] = jobs[q];
    J.start[q] = tiles;
    tiles += ((jobs[q].M + TILE - 1) / TILE) * ((jobs[q].N + TILE - 1) / TILE);
  }
  J.start[NJOBS] = tiles;

  const int P_total = (int)o.total;
  const int adam_blocks = (P_total + NT - 1) / NT;
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  for (int i = 0; i < steps; ++i) {
    const unsigned long long t = (unsigned long long)t0 + i;
    row_kernel<<<b / ROWS, NT, smem, stream>>>(
        x, P, S, D, idx ? idx + (size_t)i * b : nullptr,
        eps ? eps + (size_t)i * b * z : nullptr, t, k0, k1, scale);
    atg_kernel<<<tiles, NT, 0, stream>>>(J);
    adam_kernel<<<adam_blocks, NT, 0, stream>>>(
        params, m, v, g, P_total, (float)(t + 1), lr, losses, i / thin);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
