// LocalSDCA over padded-ELL rows, with the fused soft-threshold prox, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_sdca.py::
// _sparse_sdca_kernel (with _block_walk and _prox; entry sparse_local_sdca
// at buffer_depth=1, pallas_call at :360), vmapped over the K workers.
//
// What it computes, per worker k (one thread block each), for n_passes
// passes over its nk rows in the order perm[k, :]:
//     i = perm[k, j];  (c_r, v_r) = (cols, vals)[k, i, r],  r < r_max
//     z = sum_r prox(u[c_r]) * v_r     (prox = soft-threshold at kappa,
//                                        only when has_prox)
//     q = scale * sum_r v_r^2;  abar = alpha[k, i] + dalpha[k, i]
//     delta = cd_update(abar, z, q, y[k, i]) * mask[k, i]
//     dalpha[k, i] += delta;  u[c_r] += scale * delta * v_r   (raw u)
// from u = w (w = v when the prox is fused, so u stays in v-space), and
// emits du[k, :] = u - w. Padding slots are (col 0, val 0.0): no-ops.
//
// What bounds it on this card: like the dense kernel, a chain of
// nk * n_passes dependent steps per worker, each a gather, a block
// reduction, a serial scalar update and a scatter, separated by barriers.
// The bytes are tiny by comparison (nnz * 8 for rcv1's 677k x 47k at
// density 0.0016 is 0.12 ms at 3.35 TB/s), so step latency decides.
//
// What the design does about it: one launch per round with a grid of K
// blocks; u (d floats) in dynamic shared memory for the whole walk, so
// gather and scatter never touch device memory (d <= 58,044 floats fit the
// 232,448-byte limit; the wrapper rejects wider d); one thread per ELL slot
// (blockDim = r_max rounded up to a warp, at most 256); rows read in place
// through perm. The scatter is an atomicAdd into shared u, not a store:
// duplicate column ids in one row are legal and must all land, and zero
// padding slots share column 0 with a real entry -- a plain parallel store
// would drop an update in both cases (slots with v == 0 are skipped, which
// is exact). A barrier after the scatter keeps the next row's gather from
// reading u before this row's updates have landed.

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

constexpr int MAX_THREADS = 256;

__global__ void __launch_bounds__(MAX_THREADS)
sparse_sdca_kernel(const int* __restrict__ cols,
                   const float* __restrict__ vals,
                   const float* __restrict__ y,
                   const float* __restrict__ alpha,
                   const float* __restrict__ mask,
                   const float* __restrict__ w, const int* __restrict__ perm,
                   float* __restrict__ dalpha, float* __restrict__ du, int nk,
                   int r_max, int d, int n_passes, float scale, int loss_id,
                   float g, int has_prox, float kappa) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* scratch = reinterpret_cast<float2*>(smem);
  float* bcast = reinterpret_cast<float*>(smem + sdca::MAX_WARPS * 8);
  float* u = reinterpret_cast<float*>(smem + sdca::SCRATCH_BYTES);

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t row0 = static_cast<size_t>(k) * nk;   // first row of worker k
  const int* perm_k = perm + row0;

  for (int c = tid; c < d; c += nthr) u[c] = w[c];
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
      const int* ci = cols + r * r_max;
      const float* vi = vals + r * r_max;
      float z = 0.0f, sq = 0.0f;
      for (int s = tid; s < r_max; s += nthr) {
        const float v = vi[s];
        float uc = u[ci[s]];
        if (has_prox) uc = sdca::soft_threshold(uc, kappa);
        z += uc * v;
        sq += v * v;
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
        for (int s = tid; s < r_max; s += nthr) {
          const float v = vi[s];
          if (v != 0.0f) atomicAdd(&u[ci[s]], coef * v);
        }
      }
      __syncthreads();
    }
  }
  float* du_k = du + static_cast<size_t>(k) * d;
  for (int c = tid; c < d; c += nthr) du_k[c] = u[c] - w[c];
}

}  // namespace

extern "C" {

// Launch one round: K blocks, one per worker, on `stream`. dalpha must be
// zeroed by the caller. Returns the cudaError_t of the launch (0 = ok).
int sparse_sdca_launch(const int* cols, const float* vals, const float* y,
                       const float* alpha, const float* mask, const float* w,
                       const int* perm, float* dalpha, float* du, int K,
                       int nk, int r_max, int d, int n_passes, float scale,
                       int loss_id, float g, int has_prox, float kappa,
                       void* stream) {
  int threads = ((r_max + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS
                                                       : threads);
  const size_t smem = sdca::SCRATCH_BYTES + static_cast<size_t>(d) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      sparse_sdca_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_sdca_kernel<<<K, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      cols, vals, y, alpha, mask, w, perm, dalpha, du, nk, r_max, d,
      n_passes, scale, loss_id, g, has_prox, kappa);
  return static_cast<int>(cudaGetLastError());
}

const char* sparse_sdca_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
