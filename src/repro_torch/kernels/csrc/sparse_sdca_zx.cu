// The z-exchange schedule of feature-sharded sparse LocalSDCA, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_sdca.py::
// _sparse_sdca_zx_kernel (entry sparse_local_sdca_zx at :476, pallas_call
// at :542), vmapped over the K workers and shard_mapped over the M model
// shards of a (data=K, model=M) mesh, with the model axis's psum between
// invocations.
//
// What it computes. Worker k's rows are split by feature block: model
// shard m holds the row's entries in its own column block, with
// shard-local ids into its slice u[k, m, :] of d_loc floats. The visit
// order perm[k, :] is cut into nb = ceil(nk / B) blocks of B rows (the
// last one ragged). Invocation g < n_passes * nb, on block b = g % nb:
//     z_t   = sum_{m' = 0..M-1} zin[k, m', t]       (the psum; fixed order)
//     i     = perm[k, b B + t]
//     delta = cd_update(alpha + dalpha, z_t, scale sq[k, i], y) * mask
//     dalpha[k, m, i] += delta;  u[k, m, c] += scale delta v   (its slots)
// then, at the updated u, the partial dots of block (g + 1) % nb:
//     zout[k, m, t] = sum_s prox(u[k, m, c_s]) v_s
// zin of invocation 0 holds block 0's partial dots at u = w (the wrapper's
// prologue). Every shard of worker k sums the same M vectors in the same
// order, so each takes the same decisions and dalpha is replicated by
// construction; the wrapper returns shard 0's copy.
//
// Within one invocation the B row updates are independent: each row uses
// the block's stale exchanged z, and a row appears once per pass, so no
// row reads another's dalpha. The walk is therefore B parallel row
// updates, not a chain of B steps; only the float additions of rows that
// share a column land in another order (atomics, in no fixed order). At
// B = 1 the schedule is sequential SDCA.
//
// What bounds it on this card: launches. One launch per invocation, on a
// grid of K M blocks, each with B rows of r_loc slots to gather and
// scatter -- at rcv1's 4 x 2 shape, B = 16, that is ~10,600 launches a
// round of ~16 x 60 slots per block, so the launch-to-launch interval, not
// the bytes (both tiles and the z vectors, ~16 KB a launch), sets the
// time. The bytes' bound is computed in chip_smoke.py.
//
// What the design does about it: the loop over invocations runs in the C
// launcher below, one Python call per round, so the host adds only its
// per-launch enqueue. The u slices (K, M, d_loc) stay in device memory
// (756 KB at rcv1's 4 x 2, resident in L2) and are read with __ldcg, past
// L1, after the block's own atomics; so d is not bounded by shared memory.
// The partial dots are double-buffered (2, K, M, B) between launches: the
// launch boundary is the exchange. A persistent kernel with one
// thread-block cluster of M CTAs per worker exchanging z through
// distributed shared memory would remove the launches (ROADMAP Queue 2).

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
sparse_sdca_zx_kernel(const int* __restrict__ cols,
                      const float* __restrict__ vals,
                      const float* __restrict__ y,
                      const float* __restrict__ alpha,
                      const float* __restrict__ mask,
                      const float* __restrict__ sq,
                      const int* __restrict__ perm, float* u, float* dalpha,
                      const float* zin, float* zout, int M, int nk,
                      int r_loc, int d_loc, int B, int blk, int nxt,
                      float scale, int loss_id, float g, int has_prox,
                      float kappa) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* coef = reinterpret_cast<float*>(smem);           // B
  int* rows = reinterpret_cast<int*>(smem) + B;           // B

  const int k = blockIdx.x / M;
  const int m = blockIdx.x % M;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t km = static_cast<size_t>(k) * M + m;
  const int* perm_k = perm + static_cast<size_t>(k) * nk;
  const int* cols_km = cols + km * nk * r_loc;
  const float* vals_km = vals + km * nk * r_loc;
  float* u_km = u + km * d_loc;
  float* da_km = dalpha + km * nk;

  // the rows of this block: one thread each
  const int lo = blk * B;
  const int n_rows = min(B, nk - lo);
  for (int t = tid; t < n_rows; t += blockDim.x) {
    float z = 0.0f;
    for (int mm = 0; mm < M; ++mm)
      z += __ldcg(zin + (static_cast<size_t>(k) * M + mm) * B + t);
    const int i = perm_k[lo + t];
    const size_t r = static_cast<size_t>(k) * nk + i;
    const float dai = da_km[i];
    const float delta = sdca::cd_update(loss_id, g, alpha[r] + dai, z,
                                        scale * sq[r], y[r]) *
                        mask[r];
    da_km[i] = dai + delta;
    coef[t] = scale * delta;
    rows[t] = i;
  }
  __syncthreads();

  // the scatter into this shard's u slice: one warp per row
  for (int t = warp; t < n_rows; t += nwarps) {
    const float c = coef[t];
    if (c == 0.0f) continue;
    const size_t off = static_cast<size_t>(rows[t]) * r_loc;
    for (int s = lane; s < r_loc; s += 32) {
      const float v = vals_km[off + s];
      if (v != 0.0f) atomicAdd(u_km + cols_km[off + s], c * v);
    }
  }
  __syncthreads();

  // the next block's partial dots at the updated u: one warp per row
  const int lo2 = nxt * B;
  const int n2 = min(B, nk - lo2);
  for (int t = warp; t < n2; t += nwarps) {
    const size_t off = static_cast<size_t>(perm_k[lo2 + t]) * r_loc;
    float z = 0.0f;
    for (int s = lane; s < r_loc; s += 32) {
      float uc = __ldcg(u_km + cols_km[off + s]);
      if (has_prox) uc = sdca::soft_threshold(uc, kappa);
      z += uc * vals_km[off + s];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
    if (lane == 0) zout[km * B + t] = z;
  }
}

}  // namespace

extern "C" {

// Run one round: n_passes * ceil(nk / B) launches of a K M-block grid on
// `stream`. u (K, M, d_loc) holds w on entry and the final u on return;
// dalpha (K, M, nk) must be zeroed; zbuf (2, K, M, B) holds block 0's
// partial dots at u = w in its first half. Returns the cudaError_t of the
// first failing launch (0 = ok).
int sparse_sdca_zx_launch(const int* cols, const float* vals, const float* y,
                          const float* alpha, const float* mask,
                          const float* sq, const int* perm, float* u,
                          float* dalpha, float* zbuf, int K, int M, int nk,
                          int r_loc, int d_loc, int B, int n_passes,
                          float scale, int loss_id, float g, int has_prox,
                          float kappa, void* stream) {
  if (K < 1 || M < 1 || nk < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(B) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      sparse_sdca_zx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (nk + B - 1) / B;
  const long long total = static_cast<long long>(n_passes) * nb;
  const size_t half = static_cast<size_t>(K) * M * B;
  for (long long gi = 0; gi < total; ++gi) {
    const float* zin = zbuf + (gi % 2) * half;
    float* zout = zbuf + ((gi + 1) % 2) * half;
    sparse_sdca_zx_kernel<<<K * M, THREADS, smem, s>>>(
        cols, vals, y, alpha, mask, sq, perm, u, dalpha, zin, zout, M, nk,
        r_loc, d_loc, B, static_cast<int>(gi % nb),
        static_cast<int>((gi + 1) % nb), scale, loss_id, g, has_prox, kappa);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* sparse_sdca_zx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
