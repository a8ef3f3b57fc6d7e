// Fused multinomial-NUTS transition for the DLGM local posterior, Hopper
// (sm_90a), fp32 SIMT.
//
// Replaces bayesic_tpu/ops/fused_nuts.py:_kernel (reached through
// fused_nuts_transition and make_batched_transition).  The transition tree
// is nuts_tree.cuh's nuts_kernel (one thread block per chain, one launch
// per transition of every chain); this file gives it the DlgmPotential and
// the C entries.  The decoder weights, the data rows and the hidden
// activations live in shared memory beside the tree's state (about 98 KB
// at D=512, K=6), so device memory is read once and written once per
// transition.  Its oracle is ops/fused_nuts.reference_transition.
//
// The bound it works against (benchmarks/roofline.py:94-102): the decoder
// forward and backward is ~3x the forward, 983,040 FLOP per chain per
// leaf at nb=64, latent=8, hidden=64, data=32, so 1.007 GFLOP per leaf
// step over 1024 chains: 15 us at the 67 TFLOP/s non-tensor FP32 peak of
// the H100 SXM.  Measured: 1.84 ms per transition at the adapted bench
// state, 15 leapfrogs per chain, so 122 us per leaf step, 12% of that
// bound (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 11).  What
// holds it there is not measured; the likely limit is shared-memory loads
// (about two per FMA: one broadcast, one row element).  Register tiling of
// the four products, tensor cores and several chains per block are later
// work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "nuts_tree.cuh"

namespace {

// The DLGM local posterior of one chain, q = z.view(nb, latent):
//   pe(q) = 0.5|q|^2 + |x - (tanh(z W1 + b1) W2 + b2)|^2 / (2 s^2) + const
//   grad  = q + (((res / s^2) W2^T) * (1 - a^2)) W1^T
// Weights in the JAX (in, out) layout; W1 and W2 rows and the activation
// rows are padded by one float so column walks hit distinct banks.
struct DlgmPotential {
  const float *gw1, *gb1, *gw2, *gb2, *gx;   // device memory
  int nb, latent, hidden, data;
  float inv_s2, cst;
  float *w1, *b1, *w2, *b2, *x, *a, *r;      // shared memory

  __host__ __device__ int dim() const { return nb * latent; }

  __host__ __device__ size_t smem_floats() const {
    return (size_t)latent * (hidden + 1) + hidden
           + (size_t)hidden * (data + 1) + data + (size_t)nb * data
           + (size_t)nb * (hidden + 1) + (size_t)nb * data;
  }

  __device__ float* bind(float* s) {
    w1 = s; s += latent * (hidden + 1);
    b1 = s; s += hidden;
    w2 = s; s += hidden * (data + 1);
    b2 = s; s += data;
    x = s; s += nb * data;
    a = s; s += nb * (hidden + 1);
    r = s; s += nb * data;
    return s;
  }

  // Cooperative copy into shared memory; the caller syncs.
  __device__ void load() {
    for (int o = threadIdx.x; o < latent * hidden; o += NT)
      w1[(o / hidden) * (hidden + 1) + o % hidden] = gw1[o];
    for (int o = threadIdx.x; o < hidden * data; o += NT)
      w2[(o / data) * (data + 1) + o % data] = gw2[o];
    for (int o = threadIdx.x; o < hidden; o += NT) b1[o] = gb1[o];
    for (int o = threadIdx.x; o < data; o += NT) b2[o] = gb2[o];
    for (int o = threadIdx.x; o < nb * data; o += NT) x[o] = gx[o];
  }

  // q must be visible to the whole block.  Returns this thread's share of
  // pe - cst; writes grad[d] for d = tid + k*NT.
  __device__ float eval(const float* q, float* grad) const {
    const int tid = threadIdx.x, hp = hidden + 1, dp = data + 1;
    for (int o = tid; o < nb * hidden; o += NT) {        // a = tanh(z W1 + b1)
      const int row = o / hidden, j = o - row * hidden;
      const float* z = q + row * latent;
      float h = b1[j];
      for (int l = 0; l < latent; ++l) h = fmaf(z[l], w1[l * hp + j], h);
      a[row * hp + j] = tanhf(h);
    }
    __syncthreads();
    float sq = 0.f;
    for (int o = tid; o < nb * data; o += NT) {          // res = a W2 + b2 - x
      const int row = o / data, k = o - row * data;
      const float* ar = a + row * hp;
      float mu = b2[k];
      for (int j = 0; j < hidden; ++j) mu = fmaf(ar[j], w2[j * dp + k], mu);
      const float res = mu - x[o];
      sq = fmaf(res, res, sq);
      r[o] = res * inv_s2;                               // dmu
    }
    __syncthreads();
    for (int o = tid; o < nb * hidden; o += NT) {        // da, in place of a
      const int row = o / hidden, j = o - row * hidden;
      const float* dr = r + row * data;
      const float* w2j = w2 + j * dp;
      float s = 0.f;
      for (int k = 0; k < data; ++k) s = fmaf(dr[k], w2j[k], s);
      const float av = a[row * hp + j];
      a[row * hp + j] = s * (1.f - av * av);
    }
    __syncthreads();
    float qq = 0.f;
    for (int d = tid; d < nb * latent; d += NT) {        // grad = q + da W1^T
      const int row = d / latent, l = d - row * latent;
      const float* dar = a + row * hp;
      const float* w1l = w1 + l * hp;
      float s = 0.f;
      for (int j = 0; j < hidden; ++j) s = fmaf(dar[j], w1l[j], s);
      const float qv = q[d];
      grad[d] = qv + s;
      qq = fmaf(qv, qv, qq);
    }
    return 0.5f * qq + (0.5f * inv_s2) * sq;
  }
};

DlgmPotential make_dlgm(const float* w1, const float* b1, const float* w2,
                        const float* b2, const float* x, int nb, int latent,
                        int hidden, int data, float sigma) {
  DlgmPotential pot{};
  pot.gw1 = w1; pot.gb1 = b1; pot.gw2 = w2; pot.gb2 = b2; pot.gx = x;
  pot.nb = nb; pot.latent = latent; pot.hidden = hidden; pot.data = data;
  const double s = sigma;
  pot.inv_s2 = (float)(1.0 / (s * s));
  pot.cst = (float)(0.5 * std::log(2.0 * 3.14159265358979323846) * (nb * latent + nb * data)
                    + nb * data * std::log(s));
  return pot;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one transition block needs (0 = too many
// for a block): lets the wrapper refuse a shape before it launches.
size_t fused_nuts_smem_bytes(int nb, int latent, int hidden, int data,
                             int k) {
  DlgmPotential pot{};
  pot.nb = nb; pot.latent = latent; pot.hidden = hidden; pot.data = data;
  const size_t b = 4 * transition_smem_floats(pot.dim(), k,
                                              pot.smem_floats());
  return b > kMaxSmem ? 0 : b;
}

// One NUTS transition for each of n chains (one block each) on `stream`.
// Per-chain inputs are rows of the (n, .) arrays; eps is one float in
// device memory; outputs pe/acc/div/depth/steps/h0 are (n,) floats.
// Returns a cudaError_t (0 on success); launches only, never synchronises.
int fused_nuts_transition(const float* q, const float* pe, const float* grad,
                          const float* mom, const float* sign_dir,
                          const float* log_u_acc, const float* log_u_leaf,
                          const float* eps, const float* inv_mass,
                          const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* x, float* q_out,
                          float* pe_out, float* g_out, float* acc_out,
                          float* div_out, float* depth_out, float* steps_out,
                          float* h0_out, int n, int nb, int latent,
                          int hidden, int data, int k, float sigma,
                          float div_threshold, void* stream_ptr) {
  if (n <= 0 || nb <= 0 || latent <= 0 || hidden <= 0 || data <= 0 ||
      k < 1 || k > MAXK)
    return cudaErrorInvalidValue;
  const DlgmPotential pot =
      make_dlgm(w1, b1, w2, b2, x, nb, latent, hidden, data, sigma);
  const size_t bytes =
      4 * transition_smem_floats(pot.dim(), k, pot.smem_floats());
  cudaError_t err = prepare(nuts_kernel<DlgmPotential>, bytes);
  if (err != cudaSuccess) return err;
  TransitionArgs A{q, pe, grad, mom, sign_dir, log_u_acc, log_u_leaf, eps,
                   inv_mass, q_out, pe_out, g_out, acc_out, div_out,
                   depth_out, steps_out, h0_out, k, div_threshold};
  nuts_kernel<DlgmPotential><<<n, NT, bytes,
                               static_cast<cudaStream_t>(stream_ptr)>>>(pot,
                                                                        A);
  return cudaGetLastError();
}

// pe (n,) and grad (n, D) at q (n, D) with the transition's potential.
int fused_nuts_potential(const float* q, const float* w1, const float* b1,
                         const float* w2, const float* b2, const float* x,
                         float* pe_out, float* g_out, int n, int nb,
                         int latent, int hidden, int data, float sigma,
                         void* stream_ptr) {
  if (n <= 0 || nb <= 0 || latent <= 0 || hidden <= 0 || data <= 0)
    return cudaErrorInvalidValue;
  const DlgmPotential pot =
      make_dlgm(w1, b1, w2, b2, x, nb, latent, hidden, data, sigma);
  const size_t bytes =
      4 * (pot.smem_floats() + 2 * (size_t)pot.dim() + NWARPS * MAXV);
  cudaError_t err = prepare(potential_kernel<DlgmPotential>, bytes);
  if (err != cudaSuccess) return err;
  potential_kernel<DlgmPotential><<<n, NT, bytes,
                                    static_cast<cudaStream_t>(stream_ptr)>>>(
      pot, q, pe_out, g_out);
  return cudaGetLastError();
}

}  // extern "C"
