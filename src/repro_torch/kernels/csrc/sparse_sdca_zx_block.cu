// The z-exchange schedule of feature-sharded sparse LocalSDCA, one launch
// per invocation, for Hopper (sm_90a): the form for meshes whose model
// shards do not fit one thread-block cluster (M > 16, or a cluster the
// card cannot hold) and for process meshes, where the exchange is a
// collective between launches.
//
// Replaces the TPU kernel src/repro/kernels/sparse_sdca.py::
// _sparse_sdca_zx_kernel (entry sparse_local_sdca_zx at :476, pallas_call
// at :542) at the reference's own granularity: one launch is one
// invocation of that kernel for every (k, m) block of the tensors it is
// given, and the model axis's exchange lies between launches, as the
// reference's psum lies between its calls (:565-589).
//
// What one launch computes, for invocation `step` of the round (block
// b = step % nb of the visit order, nb = ceil(nk / B), the last ragged),
// in thread block (k, m):
//     z_t   = sum_{j = 0..Min-1} zin[k, j, t]        (in rank order)
//     i     = perm[k, b B + t]
//     delta = cd_update(alpha + dalpha, z_t, scale sq[k, i], y) * mask
//     dalpha[k, m, i] += delta;  u[k, m, c] += scale delta v   (its slots)
// then, at the updated u, the partial dots of block (step + 1) % nb:
//     zout[k, m, t] = sum_s prox(u[k, m, c_s]) v_s
// (skipped at the round's last invocation). On one card zin is the
// previous launch's zout, Min = M: the launch boundary is the exchange,
// and each block sums its worker's M partials itself, in the order the
// cluster kernel and the plain version sum them. On a process mesh each
// rank holds one block (K = M = 1) and zin is its model column's
// all_reduce of the previous zout (Min = 1). Every shard of a worker sums
// the same vectors in the same order, so all take the same decisions and
// dalpha is replicated; each shard keeps its own copy (a shard that read
// another's write within the launch would add delta twice), and the
// wrapper returns shard 0's.
//
// What bounds it on this card: the chain of n_passes * nb launches, each a
// few dependent device-memory round trips (the row ids, the rows' scalars,
// the scatter, the next rows' ids and columns, the gather of u) on B rows
// and a launch's own latency; the bytes are those of the cluster kernel
// (obs.cost.zx_round). The one-card round is launch-bound.
//
// What the design does about it: nothing that hides latency yet (a simple
// kernel, right first). u persists across launches, so it lives in device
// memory, (K, M, d_loc), gathered with __ldcg past L1 after the block's own
// atomics (they land in L2) and scattered with global atomicAdd. The
// one-card round's launches are issued by one C call
// (sparse_sdca_zx_block_round), so no Python runs between them; on a
// process mesh the wrapper issues each launch (sparse_sdca_zx_block_launch)
// between its collectives.
//
// Hazards:
//  * Within one launch the B row updates are independent (each uses the
//    block's exchanged z; a row appears once per pass), so a thread per
//    row updates them in parallel; only float additions of rows that share
//    a column land in another order.
//  * The scatter's atomics and the next block's gather are in the same
//    thread block, ordered by __syncthreads; the gather's ld.global.cg
//    reads L2, where the atomics landed. No other block touches u[k, m].
//  * zin and zout are different buffers (the one-card round alternates
//    two); zout entries past a ragged block's rows are left as they were.

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr size_t MAX_SMEM = 232448;  // a block's dynamic shared memory

__global__ void __launch_bounds__(THREADS)
sparse_sdca_zx_block_kernel(const int* __restrict__ cols,
                            const float* __restrict__ vals,
                            const float* __restrict__ y,
                            const float* __restrict__ alpha,
                            const float* __restrict__ mask,
                            const float* __restrict__ sq,
                            const int* __restrict__ perm,
                            float* __restrict__ u,
                            float* __restrict__ dalpha,
                            const float* __restrict__ zin,
                            float* __restrict__ zout, int M, int Min, int nk,
                            int r_loc, int d_loc, int B, int step,
                            int want_next, float scale, int loss_id, float g,
                            int has_prox, float kappa) {
  extern __shared__ __align__(16) float smem[];
  float* coef = smem;                                   // B
  int* ids = reinterpret_cast<int*>(smem + B);          // B
  const int k = static_cast<int>(blockIdx.x) / M;
  const int m = static_cast<int>(blockIdx.x) % M;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t km = static_cast<size_t>(k) * M + m;
  const size_t r0 = static_cast<size_t>(k) * nk;
  const int nb = (nk + B - 1) / B;
  const int lo = (step % nb) * B;
  const int n = min(B, nk - lo);
  const int* cols_km = cols + km * nk * r_loc;
  const float* vals_km = vals + km * nk * r_loc;
  float* u_km = u + km * d_loc;
  float* da_km = dalpha + km * nk;

  // the exchanged z and the row updates: one thread per row
  for (int t = tid; t < n; t += THREADS) {
    float z = 0.0f;
    for (int j = 0; j < Min; ++j)
      z += zin[(static_cast<size_t>(k) * Min + j) * B + t];
    const int i = perm[r0 + lo + t];
    const float dai = da_km[i];
    const float delta =
        sdca::cd_update(loss_id, g, alpha[r0 + i] + dai, z,
                        scale * sq[r0 + i], y[r0 + i]) * mask[r0 + i];
    da_km[i] = dai + delta;
    coef[t] = scale * delta;
    ids[t] = i;
  }
  __syncthreads();

  // the scatter into this shard's u slice: one warp per row
  for (int t = warp; t < n; t += NWARPS) {
    const float c = coef[t];
    if (c == 0.0f) continue;
    const size_t off = static_cast<size_t>(ids[t]) * r_loc;
    for (int s = lane; s < r_loc; s += 32) {
      const float v = vals_km[off + s];
      if (v != 0.0f) atomicAdd(u_km + cols_km[off + s], c * v);
    }
  }
  if (!want_next) return;
  __syncthreads();                   // the scatter before the gather

  // the next block's partial dots at the updated u: one warp per row
  const int lo2 = ((step + 1) % nb) * B;
  const int n2 = min(B, nk - lo2);
  for (int t = warp; t < n2; t += NWARPS) {
    const size_t off = static_cast<size_t>(perm[r0 + lo2 + t]) * r_loc;
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

size_t smem_bytes(int B) { return 8 * static_cast<size_t>(B); }

cudaError_t launch(const int* cols, const float* vals, const float* y,
                   const float* alpha, const float* mask, const float* sq,
                   const int* perm, float* u, float* dalpha,
                   const float* zin, float* zout, int K, int M, int Min,
                   int nk, int r_loc, int d_loc, int B, int step,
                   int want_next, float scale, int loss_id, float g,
                   int has_prox, float kappa, cudaStream_t stream) {
  const size_t smem = smem_bytes(B);
  if (smem > 48 * 1024) {            // past the default: B above 6,144
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_sdca_zx_block_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sparse_sdca_zx_block_kernel<<<K * M, THREADS, smem, stream>>>(
      cols, vals, y, alpha, mask, sq, perm, u, dalpha, zin, zout, M, Min, nk,
      r_loc, d_loc, B, step, want_next, scale, loss_id, g, has_prox, kappa);
  return cudaGetLastError();
}

bool bad_shape(int K, int M, int Min, int nk, int B) {
  return K < 1 || M < 1 || Min < 1 || nk < 1 || B < 1 ||
         smem_bytes(B) > MAX_SMEM;
}

}  // namespace

extern "C" {

// One invocation `step` of the round: K M blocks on `stream`. u
// (K, M, d_loc) and dalpha (K, M, nk) are updated in place; zin
// (K, Min, B) holds the exchanged z of block step % nb (Min partials to
// sum, or 1 already summed); zout (K, M, B) receives the partial dots of
// the next block when want_next. Returns the cudaError_t (0 = ok).
int sparse_sdca_zx_block_launch(const int* cols, const float* vals,
                                const float* y, const float* alpha,
                                const float* mask, const float* sq,
                                const int* perm, float* u, float* dalpha,
                                const float* zin, float* zout, int K, int M,
                                int Min, int nk, int r_loc, int d_loc, int B,
                                int step, int want_next, float scale,
                                int loss_id, float g, int has_prox,
                                float kappa, void* stream) {
  if (bad_shape(K, M, Min, nk, B))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(
      cols, vals, y, alpha, mask, sq, perm, u, dalpha, zin, zout, K, M, Min,
      nk, r_loc, d_loc, B, step, want_next, scale, loss_id, g, has_prox,
      kappa, static_cast<cudaStream_t>(stream)));
}

// The one-card round: invocations 0 .. n_steps - 1 on `stream`, one
// launch each, the exchange being the launch boundary (Min = M). z (2, K,
// M, B): z[0] holds block 0's partial dots at u = w, z[1] is scratch; the
// invocations alternate them. Returns the first cudaError_t (0 = ok).
int sparse_sdca_zx_block_round(const int* cols, const float* vals,
                               const float* y, const float* alpha,
                               const float* mask, const float* sq,
                               const int* perm, float* u, float* dalpha,
                               float* z, int K, int M, int nk, int r_loc,
                               int d_loc, int B, int n_steps, float scale,
                               int loss_id, float g, int has_prox,
                               float kappa, void* stream) {
  if (bad_shape(K, M, M, nk, B) || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t half = static_cast<size_t>(K) * M * B;
  for (int step = 0; step < n_steps; ++step) {
    float* zin = z + (step & 1) * half;
    float* zout = z + ((step + 1) & 1) * half;
    const cudaError_t err = launch(
        cols, vals, y, alpha, mask, sq, perm, u, dalpha, zin, zout, K, M, M,
        nk, r_loc, d_loc, B, step, step + 1 < n_steps, scale, loss_id, g,
        has_prox, kappa, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* sparse_sdca_zx_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
