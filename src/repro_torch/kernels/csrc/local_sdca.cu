// LocalSDCA over dense rows (paper Algorithm 2) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/local_sdca.py::_sdca_kernel
// (entry local_sdca_pallas, pallas_call at :127), which ran one worker's
// walk as a sequential (pass, row block) grid with u and dalpha in VMEM,
// vmapped over the K workers.
//
// What it computes, per worker k (one thread block each), for n_passes
// passes over its nk rows in the order perm[k, :]:
//     i = perm[k, j];  x = X[k, i, :]
//     z = x . u;  q = scale * ||x||^2;  abar = alpha[k, i] + dalpha[k, i]
//     delta = cd_update(abar, z, q, y[k, i]) * mask[k, i]
//     dalpha[k, i] += delta;  u += scale * delta * x
// from u = w, and emits du[k, :] = u - w.
//
// What bounds it on this card: the walk is a chain of nk * n_passes
// dependent steps per worker -- every step reads the u the previous step
// wrote -- so its time is steps x step latency, not bytes: X is read once
// per pass (K*nk*d*4 bytes, 0.96 ms at 3.35 TB/s for epsilon's 400k x 2000)
// but each step pays a global row load, two block barriers and a serial
// scalar update. Only K of the 132 SMs have work.
//
// What the design does about it, kept simple on purpose: one launch per
// round with a grid of K blocks (the vmap over workers), u held in dynamic
// shared memory for the whole walk, each thread owning the same columns of
// u for the dot and the axpy (so u needs no barrier between them), rows
// read in place through perm (X is never copied into visit order), and the
// thread-0 scalars (y, alpha, mask, dalpha) loaded before the dot so their
// latency overlaps it. Splitting a worker's walk across SMs is later work.

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
local_sdca_kernel(const float* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ alpha,
                  const float* __restrict__ mask,
                  const float* __restrict__ w, const int* __restrict__ perm,
                  float* __restrict__ dalpha, float* __restrict__ du, int nk,
                  int d, int n_passes, float scale, int loss_id, float g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* scratch = reinterpret_cast<float2*>(smem);
  float* bcast = reinterpret_cast<float*>(smem + sdca::MAX_WARPS * 8);
  float* u = reinterpret_cast<float*>(smem + sdca::SCRATCH_BYTES);

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(k) * nk;   // first row of worker k
  const float* Xk = X + row0 * d;
  const int* perm_k = perm + row0;

  for (int c = tid; c < d; c += THREADS) u[c] = w[c];
  __syncthreads();

  for (int p = 0; p < n_passes; ++p) {
    for (int j = 0; j < nk; ++j) {
      const int i = perm_k[j];
      const size_t r = row0 + i;
      float yi = 0.0f, ai = 0.0f, mi = 0.0f, dai = 0.0f;
      if (tid == 0) {
        yi = y[r];
        ai = alpha[r];
        mi = mask[r];
        dai = dalpha[r];
      }
      const float* x = Xk + static_cast<size_t>(i) * d;
      float z = 0.0f, sq = 0.0f;
      for (int c = tid; c < d; c += THREADS) {
        const float xc = x[c];
        z += xc * u[c];
        sq += xc * xc;
      }
      const float2 tot = sdca::block_sum2(z, sq, scratch);
      if (tid == 0) {
        const float q = scale * tot.y;
        const float delta =
            sdca::cd_update(loss_id, g, ai + dai, tot.x, q, yi) * mi;
        dalpha[r] = dai + delta;
        bcast[0] = scale * delta;
      }
      __syncthreads();
      const float coef = bcast[0];
      if (coef != 0.0f) {
        for (int c = tid; c < d; c += THREADS) u[c] += coef * x[c];
      }
    }
  }
  __syncthreads();
  float* du_k = du + static_cast<size_t>(k) * d;
  for (int c = tid; c < d; c += THREADS) du_k[c] = u[c] - w[c];
}

}  // namespace

extern "C" {

// Launch one round: K blocks, one per worker, on `stream`. dalpha must be
// zeroed by the caller. Returns the cudaError_t of the launch (0 = ok).
int local_sdca_launch(const float* X, const float* y, const float* alpha,
                      const float* mask, const float* w, const int* perm,
                      float* dalpha, float* du, int K, int nk, int d,
                      int n_passes, float scale, int loss_id, float g,
                      void* stream) {
  const size_t smem = sdca::SCRATCH_BYTES + static_cast<size_t>(d) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      local_sdca_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  local_sdca_kernel<<<K, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      X, y, alpha, mask, w, perm, dalpha, du, nk, d, n_passes, scale,
      loss_id, g);
  return static_cast<int>(cudaGetLastError());
}

const char* local_sdca_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
