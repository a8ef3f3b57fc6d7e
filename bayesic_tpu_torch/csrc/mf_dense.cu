// Dense matrix-factorization ELBO cell pass for Hopper (sm_90a), fp32 SIMT.
//
// Replaces bayesic_tpu/ops/mf_dense.py:_cell_kernel (reached through
// cell_grads).  Over the per-cell statistics cnt (bf16, exact integer
// counts) and rsum (fp32) of a (NU, NI) rating grid, with the augmented
// factors Fu = [Ua | Wu] (NU, 3A) and Fv = [Va | Wv] (NI, 3A), A = K + 2
// (ops/mf_dense.py:pack_aug), it computes
//   mean = Ua Va^T,  var = Wu Wv^T,  G = 2 (cnt mean - rsum),
//   cells = sum cnt (var + mean^2) - 2 rsum mean,
//   dFu = [G Va | cnt Wv],  dFv = [G^T Ua | cnt^T Wu].
// In bf16 mode each product operand (the factors and G; cnt is exact) is
// rounded to bf16 and the sums stay fp32, as the plain version does.
//
// Design.  The TPU kernel walks item blocks in order and carries dUa/dWu in
// VMEM across them; here blocks run at once, so nothing carries over:
//   1. mf_cell_kernel: one CTA per 64 x 64 tile of users x items stages its
//      Fu rows and Fv rows (transposed) in shared memory, forms mean, var
//      and G per cell with FFMA (each thread one item and 16 users, the
//      item's factor loaded once per column), keeps G and cnt in shared
//      memory, then forms the tile's partial dFu rows (summed over its 64
//      items) and partial dFv rows (over its 64 users) and writes them,
//      through shared memory so the stores are coalesced, to scratch indexed
//      by its item tile and its user tile, with the tile's partial loss.
//   2. mf_reduce_kernel sums the partials over tiles in a fixed order: one
//      thread per output element, tiles in index order; one block sums the
//      loss partials (strided, then the warps in order).
// No atomics: a run repeats bit for bit.  Ragged edges are bounds checks
// (missing rows stage as zeros, so their cells add nothing).
//
// What bounds it: at the bench shape (3000 x 1500 cells, A = 18) the
// inputs are 27 MB (8.2 us at 3.35 TB/s) and the work 9A FMAs per cell
// (1.46 GFLOP, 21.8 us at 67 TFLOP/s FP32), so FP32 issue.  This first
// design does not reach it: the FMAs read one operand from shared memory
// (about one shared load per FMA), and the partials add ~31 MB written and
// read again.  Register tiles and tensor-core products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TU = 64, TI = 64;      // users x items per tile
constexpr int NT = 256;              // threads per tile CTA
constexpr int NWARPS = NT / 32;
constexpr int GROUPS = NT / TI;      // 4 column groups
constexpr int MAXA = 32;             // A = K + 2 <= 32
constexpr int MAXW = 3 * MAXA;
constexpr int CPG = MAXW / GROUPS;   // columns per group, at most 24
constexpr int UPT = TU / GROUPS;     // users per thread in the cell pass
constexpr int LD = TI + 1;           // padded row of the G and cnt tiles
constexpr int RT = 256;              // threads per reduction block

template <bool BF16>
__device__ __forceinline__ float op(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

size_t smem_floats(int w) {
  // Fu rows [TU][w], Fv transposed [w][TI], G and cnt [TU][LD]
  return (size_t)TU * w + (size_t)w * TI + 2 * (size_t)TU * LD;
}

template <bool BF16>
__global__ void __launch_bounds__(NT)
    mf_cell_kernel(const __nv_bfloat16* __restrict__ cnt,
                   const float* __restrict__ rsum,
                   const float* __restrict__ fu, const float* __restrict__ fv,
                   int nu, int ni, int a, float* __restrict__ part_u,
                   float* __restrict__ part_v, float* __restrict__ part_loss) {
  extern __shared__ float sm[];
  const int w = 3 * a;
  float* su = sm;                    // [TU][w]
  float* sv = su + TU * w;           // [w][TI]
  float* sg = sv + w * TI;           // [TU][LD]
  float* sc = sg + TU * LD;          // [TU][LD]
  __shared__ float red[NWARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx = blockIdx.x, by = blockIdx.y;
  const int i0 = bx * TI, u0 = by * TU;

  for (int k = tid; k < TU * w; k += NT) {
    const int r = k / w;
    su[k] = u0 + r < nu ? op<BF16>(fu[(size_t)u0 * w + k]) : 0.f;
  }
  for (int k = tid; k < TI * w; k += NT) {
    const int r = k / w, c = k - r * w;
    sv[c * TI + r] = i0 + r < ni ? op<BF16>(fv[(size_t)i0 * w + k]) : 0.f;
  }
  __syncthreads();

  // -- cell pass: item i, users ug, ug + 4, ...
  const int i = tid % TI, grp = tid / TI;
  float mean[UPT], var[UPT];
#pragma unroll
  for (int k = 0; k < UPT; ++k) mean[k] = var[k] = 0.f;
  for (int c = 0; c < a; ++c) {
    const float f = sv[c * TI + i];
#pragma unroll
    for (int k = 0; k < UPT; ++k)
      mean[k] = fmaf(su[(grp + GROUPS * k) * w + c], f, mean[k]);
  }
  for (int c = a; c < w; ++c) {
    const float f = sv[c * TI + i];
#pragma unroll
    for (int k = 0; k < UPT; ++k)
      var[k] = fmaf(su[(grp + GROUPS * k) * w + c], f, var[k]);
  }
  float loss = 0.f;
#pragma unroll
  for (int k = 0; k < UPT; ++k) {
    const int u = grp + GROUPS * k;
    float cn = 0.f, rs = 0.f;
    if (u0 + u < nu && i0 + i < ni) {
      const size_t cell = (size_t)(u0 + u) * ni + i0 + i;
      cn = __bfloat162float(cnt[cell]);
      rs = rsum[cell];
    }
    loss += cn * (var[k] + mean[k] * mean[k]) - 2.f * rs * mean[k];
    sg[u * LD + i] = op<BF16>(2.f * (cn * mean[k] - rs));
    sc[u * LD + i] = cn;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) loss += __shfl_xor_sync(0xffffffffu, loss, o);
  if (lane == 0) red[warp] = loss;
  __syncthreads();

  // -- partial gradients: user row r = tid % 64 sums its 64 items, item
  // row r sums its 64 users; columns grp, grp + 4, ... (G for c < A, cnt
  // after)
  const int r = tid % TU;
  float du[CPG], dv[CPG];
#pragma unroll
  for (int j = 0; j < CPG; ++j) du[j] = dv[j] = 0.f;
  for (int s = 0; s < TI; ++s) {     // items, for the user row r
    const float g = sg[r * LD + s], cn = sc[r * LD + s];
#pragma unroll
    for (int j = 0; j < CPG; ++j) {
      const int c = grp + GROUPS * j;
      if (c < w) du[j] = fmaf(c < a ? g : cn, sv[c * TI + s], du[j]);
    }
  }
  for (int s = 0; s < TU; ++s) {     // users, for the item row r
    const float g = sg[s * LD + r], cn = sc[s * LD + r];
#pragma unroll
    for (int j = 0; j < CPG; ++j) {
      const int c = grp + GROUPS * j;
      if (c < w) dv[j] = fmaf(c < a ? g : cn, su[s * w + c], dv[j]);
    }
  }
  __syncthreads();                   // su/sv now hold the results
#pragma unroll
  for (int j = 0; j < CPG; ++j) {
    const int c = grp + GROUPS * j;
    if (c < w) {
      su[r * w + c] = du[j];
      sv[r * w + c] = dv[j];
    }
  }
  __syncthreads();
  const int nrow_u = min(TU, nu - u0), nrow_i = min(TI, ni - i0);
  float* pu = part_u + ((size_t)bx * nu + u0) * w;
  float* pv = part_v + ((size_t)by * ni + i0) * w;
  for (int k = tid; k < nrow_u * w; k += NT) pu[k] = su[k];
  for (int k = tid; k < nrow_i * w; k += NT) pv[k] = sv[k];
  if (tid == 0) {
    float s = 0.f;
    for (int k = 0; k < NWARPS; ++k) s += red[k];
    part_loss[by * gridDim.x + bx] = s;
  }
}

__global__ void __launch_bounds__(RT)
    mf_reduce_kernel(const float* __restrict__ part_u,
                     const float* __restrict__ part_v,
                     const float* __restrict__ part_loss, int nu, int ni,
                     int w, int n_it, int n_ut, float* __restrict__ loss,
                     float* __restrict__ dfu, float* __restrict__ dfv) {
  const size_t eu = (size_t)nu * w, ev = (size_t)ni * w;
  if (blockIdx.x == gridDim.x - 1) {       // the loss
    __shared__ float red[RT / 32];
    const int n = n_it * n_ut;
    float s = 0.f;
    for (int k = threadIdx.x; k < n; k += RT) s += part_loss[k];
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
    for (int t = 0; t < n_it; ++t) s += part_u[t * eu + e];
    dfu[e] = s;
  } else if (e < eu + ev) {
    const size_t f = e - eu;
    float s = 0.f;
    for (int t = 0; t < n_ut; ++t) s += part_v[t * ev + f];
    dfv[f] = s;
  }
}

int tiles(int n, int t) { return (n + t - 1) / t; }

}  // namespace

extern "C" {

// Floats of scratch the pass needs: the partials of both sides and the
// per-tile losses.
size_t mf_dense_scratch_floats(int nu, int ni, int a) {
  const size_t w = 3 * (size_t)a, n_it = tiles(ni, TI), n_ut = tiles(nu, TU);
  return n_it * nu * w + n_ut * ni * w + n_it * n_ut;
}

// One value+grad pass on `stream`.  cnt: (nu, ni) bf16, rsum: (nu, ni)
// fp32, fu: (nu, 3a), fv: (ni, 3a), all row major; scratch:
// mf_dense_scratch_floats(nu, ni, a) floats; outputs loss (1), dfu (nu, 3a),
// dfv (ni, 3a).  bf16 != 0 rounds the product operands to bf16.  Returns a
// cudaError_t (0 on success); launches only, never synchronises.
int mf_dense_cell_grads(const void* cnt, const float* rsum, const float* fu,
                        const float* fv, float* scratch, float* loss,
                        float* dfu, float* dfv, int nu, int ni, int a,
                        int bf16, void* stream_ptr) {
  if (nu < 1 || ni < 1 || a < 1 || a > MAXA) return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int w = 3 * a, n_it = tiles(ni, TI), n_ut = tiles(nu, TU);
  const size_t bytes = sizeof(float) * smem_floats(w);
  float* part_u = scratch;
  float* part_v = part_u + (size_t)n_it * nu * w;
  float* part_loss = part_v + (size_t)n_ut * ni * w;
  const dim3 grid(n_it, n_ut);
  const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(cnt);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(mf_cell_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    mf_cell_kernel<true><<<grid, NT, bytes, stream>>>(
        c, rsum, fu, fv, nu, ni, a, part_u, part_v, part_loss);
  } else {
    err = cudaFuncSetAttribute(mf_cell_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    mf_cell_kernel<false><<<grid, NT, bytes, stream>>>(
        c, rsum, fu, fv, nu, ni, a, part_u, part_v, part_loss);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t elems = (size_t)(nu + ni) * w;
  const int blocks = (int)((elems + RT - 1) / RT) + 1;
  mf_reduce_kernel<<<blocks, RT, 0, stream>>>(part_u, part_v, part_loss, nu,
                                              ni, w, n_it, n_ut, loss, dfu,
                                              dfv);
  return cudaGetLastError();
}

}  // extern "C"
