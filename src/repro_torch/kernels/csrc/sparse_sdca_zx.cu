// The z-exchange schedule of feature-sharded sparse LocalSDCA, for Hopper
// (sm_90a): one round in one launch, one thread-block cluster per worker.
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
// What bounds it on this card: the chain of n_passes * nb dependent steps
// (10,585 a round at rcv1's 4 x 2 shape, B = 16), each an exchange of B
// floats among the M shards followed by B row updates, a scatter and the
// next block's gather of ~16 x 60 slots. The bytes (8 per nonzero per
// pass, the z vectors, the row scalars; bound computed in chip_smoke.py)
// are far below the chain's latency, so what a step costs decides.
//
// What the design does about it:
//  * One launch per round. A grid of K M blocks in clusters of M
//    (cudaLaunchKernelEx, cluster dimension (M, 1, 1)): cluster k is
//    worker k, block rank m its model shard. The loop over the n_passes nb
//    invocations runs inside the kernel.
//  * The exchange is distributed shared memory. Each block writes its B
//    partial dots into its own buffer zb[(g + 1) % 2]; one cluster barrier
//    opens step g + 1; then every block reads the M peers' zb[(g + 1) % 2]
//    through cluster.map_shared_rank and sums them in rank order 0..M-1,
//    the order the per-launch kernel summed zin in. One barrier a step is
//    enough because the buffers alternate: a block reads zb[g % 2] only in
//    step g, after the barrier that opens step g and before it arrives at
//    the barrier that opens step g + 1; the next write of zb[g % 2] is the
//    dots of step g + 1, made after its writer passed that same barrier.
//    One more barrier after the last step keeps every block's shared
//    memory alive until its peers have read it.
//  * Workers never wait for each other: clusters are independent, so K is
//    not bounded by co-residency (clusters that do not fit run in a later
//    wave, with the same result). M is bounded by the cluster size the
//    card schedules: 8 portable, 16 with the non-portable attribute; the
//    wrapper asks cudaOccupancyMaxActiveClusters (zx_max_clusters below)
//    and refuses what does not fit.
//  * u in shared memory where it fits (U_SMEM): the block's u slice, 4
//    d_loc bytes (94 KB at rcv1's 4 x 2), beside the buffers below under
//    the 232,448-byte limit; the gather and the scatter's atomics are then
//    shared-memory operations, and u goes back to device memory once, at
//    the end of the round. Where it does not fit (d_loc above 53,360 at
//    B = 16, r_loc = 70) the same kernel runs with u in device memory
//    (U_SMEM false),
//    gathered with __ldcg past L1 after the block's own atomics.
//  * The next blocks' rows are prefetched with 4-byte cp.async (rows of
//    r_loc slots are neither 16-byte sized nor aligned): during step g the
//    row ids of block g + 3 and the cols, vals, y, alpha, mask, sqnorm and
//    dalpha of block g + 2 are copied into shared memory, so the device
//    memory round trips (ids, then rows, then scalars) leave the step's
//    critical path. A ring of two row stages (block g updated and
//    scattered, block g + 1's dots) and four id slots.
//
// Hazards:
//  * dalpha is prefetched two blocks ahead. Block g + 2's rows were last
//    written in step g + 2 - nb: before step g when nb >= 3, in step g's
//    update (before the barrier ahead of the prefetch) when nb = 2. At
//    nb = 1 they are written in step g + 1, after the prefetch, so there
//    the update reads dalpha from device memory (thread t owns row t in
//    every step, so it reads its own write).
//  * The prefetch into stage g % 2 starts after the barrier that ends
//    block g's scatter; its wait is the cp.async.wait_all ahead of the
//    barrier of the next step's prefetch point, before block g + 2's dots.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int PORTABLE_CLUSTER = 8;
constexpr int MAX_CLUSTER = 16;
constexpr int ID_SLOTS = 4;          // row ids of blocks g .. g + 3
constexpr int SCALARS = 5;           // y, alpha, mask, sqnorm, dalpha

// 4-byte words of one row stage: cols (B r_loc) | vals (B r_loc) | scalars
__host__ __device__ __forceinline__ int stage_words(int B, int r_loc) {
  return 2 * B * r_loc + SCALARS * B;
}

// dynamic shared memory of one block, in bytes: [u (d_loc)] | zb (2 B) |
// coef (B) | ids (ID_SLOTS B) | two stages
__host__ __device__ __forceinline__ size_t smem_bytes(int B, int r_loc,
                                                      int d_loc,
                                                      bool u_smem) {
  return 4 * ((u_smem ? static_cast<size_t>(d_loc) : 0) +
              static_cast<size_t>(3 + ID_SLOTS) * B +
              2 * static_cast<size_t>(stage_words(B, r_loc)));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The block (k, m)'s view of its inputs and its shared memory.
struct Walk {
  const int* perm_k;                 // (nk,) worker k's visit order
  const int* cols_km;                // (nk, r_loc) shard-local ids
  const float* vals_km;
  const float *y_k, *alpha_k, *mask_k, *sq_k;  // (nk,) row scalars
  float* da_km;                      // (nk,) this shard's dalpha copy
  int* ids;                          // ID_SLOTS x B
  float* stages;                     // 2 x stage_words
  int nk, r_loc, B, nb, sw;

  __device__ int rows_of(int seq) const {
    return min(B, nk - (seq % nb) * B);
  }
  __device__ int* ids_of(int seq) const { return ids + (seq % ID_SLOTS) * B; }
  __device__ float* stage_of(int seq) const { return stages + (seq & 1) * sw; }

  // row ids of the seq-th block of the round into their slot
  __device__ void fetch_ids(int seq) const {
    const int lo = (seq % nb) * B;
    const int n = rows_of(seq);
    int* dst = ids_of(seq);
    for (int t = threadIdx.x; t < n; t += THREADS)
      cp_async4(dst + t, perm_k + lo + t);
  }

  // the seq-th block's rows (their ids must have landed) into its stage
  __device__ void fetch_rows(int seq) const {
    const int n = rows_of(seq);
    const int* id = ids_of(seq);
    int* ci = reinterpret_cast<int*>(stage_of(seq));
    float* vi = stage_of(seq) + B * r_loc;
    float* sc = vi + B * r_loc;
    const int lane = threadIdx.x & 31;
    for (int t = threadIdx.x >> 5; t < n; t += NWARPS) {
      const size_t off = static_cast<size_t>(id[t]) * r_loc;
      for (int s = lane; s < r_loc; s += 32) {
        cp_async4(ci + t * r_loc + s, cols_km + off + s);
        cp_async4(vi + t * r_loc + s, vals_km + off + s);
      }
    }
    for (int t = threadIdx.x; t < n; t += THREADS) {
      const int i = id[t];
      cp_async4(sc + t, y_k + i);
      cp_async4(sc + B + t, alpha_k + i);
      cp_async4(sc + 2 * B + t, mask_k + i);
      cp_async4(sc + 3 * B + t, sq_k + i);
      cp_async4(sc + 4 * B + t, da_km + i);
    }
  }
};

template <bool U_SMEM>
__device__ __forceinline__ float load_u(const float* p) {
  if constexpr (U_SMEM) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

template <bool U_SMEM>
__global__ void __launch_bounds__(THREADS)
sparse_sdca_zx_kernel(const int* __restrict__ cols,
                      const float* __restrict__ vals,
                      const float* __restrict__ y,
                      const float* __restrict__ alpha,
                      const float* __restrict__ mask,
                      const float* __restrict__ sq,
                      const int* __restrict__ perm, float* __restrict__ u,
                      float* __restrict__ dalpha,
                      const float* __restrict__ z0, int M, int nk, int r_loc,
                      int d_loc, int B, int n_passes, float scale,
                      int loss_id, float g, int has_prox, float kappa) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int m = static_cast<int>(cluster.block_rank());
  const int k = static_cast<int>(blockIdx.x) / M;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t km = static_cast<size_t>(k) * M + m;
  const size_t r0 = static_cast<size_t>(k) * nk;

  float* us = smem;                                // d_loc, when U_SMEM
  float* zb = smem + (U_SMEM ? d_loc : 0);         // 2 x B partial dots
  float* coef = zb + 2 * B;                        // B
  Walk w{perm + r0,
         cols + km * nk * r_loc,
         vals + km * nk * r_loc,
         y + r0, alpha + r0, mask + r0, sq + r0,
         dalpha + km * nk,
         reinterpret_cast<int*>(coef + B),
         coef + B + ID_SLOTS * B,
         nk, r_loc, B, (nk + B - 1) / B, stage_words(B, r_loc)};
  float* u_km = u + km * d_loc;
  float* uu = U_SMEM ? us : u_km;                  // u as gathered/scattered
  const int total = n_passes * w.nb;

  // prologue: u, block 0's partial dots at u = w, ids of blocks 0-2 and the
  // rows of blocks 0-1
  if constexpr (U_SMEM) {
    for (int j = tid; j < d_loc; j += THREADS) us[j] = u_km[j];
  }
  for (int t = tid; t < B; t += THREADS) zb[t] = z0[km * B + t];
  w.fetch_ids(0);
  w.fetch_ids(1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  w.fetch_rows(0);
  w.fetch_rows(1);
  w.fetch_ids(2);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int step = 0; step < total; ++step) {
    const int n = w.rows_of(step);
    const int* id = w.ids_of(step);
    const int* ci = reinterpret_cast<const int*>(w.stage_of(step));
    const float* vi = w.stage_of(step) + B * r_loc;
    const float* sc = vi + B * r_loc;
    const int zin = (step & 1) * B;
    cluster.sync();                  // every peer's zb[step % 2] is written

    // the exchanged z and the row updates: one thread per row
    for (int t = tid; t < n; t += THREADS) {
      float z = 0.0f;
      for (int mm = 0; mm < M; ++mm)
        z += cluster.map_shared_rank(zb, mm)[zin + t];
      const int i = id[t];
      const float dai = w.nb == 1 ? w.da_km[i] : sc[4 * B + t];
      const float delta = sdca::cd_update(loss_id, g, sc[B + t] + dai, z,
                                          scale * sc[3 * B + t], sc[t]) *
                          sc[2 * B + t];
      w.da_km[i] = dai + delta;
      coef[t] = scale * delta;
    }
    __syncthreads();

    // the scatter into this shard's u slice: one warp per row
    for (int t = warp; t < n; t += NWARPS) {
      const float c = coef[t];
      if (c == 0.0f) continue;
      for (int s = lane; s < r_loc; s += 32) {
        const float v = vi[t * r_loc + s];
        if (v != 0.0f) atomicAdd(uu + ci[t * r_loc + s], c * v);
      }
    }
    // block step + 1's rows and block step + 2's ids have landed; block
    // step's stage and step - 1's id slot are free
    cp_async_wait_all();
    __syncthreads();
    w.fetch_rows(step + 2);
    w.fetch_ids(step + 3);
    cp_async_commit();

    // the next block's partial dots at the updated u: one warp per row
    if (step + 1 < total) {
      const int n2 = w.rows_of(step + 1);
      const int* c2 = reinterpret_cast<const int*>(w.stage_of(step + 1));
      const float* v2 = w.stage_of(step + 1) + B * r_loc;
      float* zout = zb + ((step + 1) & 1) * B;
      for (int t = warp; t < n2; t += NWARPS) {
        float z = 0.0f;
        for (int s = lane; s < r_loc; s += 32) {
          float uc = load_u<U_SMEM>(uu + c2[t * r_loc + s]);
          if (has_prox) uc = sdca::soft_threshold(uc, kappa);
          z += uc * v2[t * r_loc + s];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          z += __shfl_xor_sync(0xffffffffu, z, o);
        if (lane == 0) zout[t] = z;
      }
    }
  }
  cp_async_wait_all();
  cluster.sync();                    // peers are done reading this zb
  if constexpr (U_SMEM) {
    for (int j = tid; j < d_loc; j += THREADS) u_km[j] = us[j];
  }
}

template <bool U_SMEM>
cudaError_t configure(int M, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      sparse_sdca_zx_kernel<U_SMEM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && M > PORTABLE_CLUSTER)
    err = cudaFuncSetAttribute(sparse_sdca_zx_kernel<U_SMEM>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

// a launch of n_clusters clusters of M blocks
cudaLaunchConfig_t config(int n_clusters, int M, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = M;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * M);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Run one round in one launch: K clusters of M blocks on `stream`. u
// (K, M, d_loc) holds w on entry and the final u on return; dalpha
// (K, M, nk) must be zeroed; z0 (K, M, B) holds block 0's partial dots at
// u = w. u_in_smem picks the instance (u in shared memory or in device
// memory; the wrapper's smem_budget decides). Returns the cudaError_t of
// the launch (0 = ok).
int sparse_sdca_zx_launch(const int* cols, const float* vals, const float* y,
                          const float* alpha, const float* mask,
                          const float* sq, const int* perm, float* u,
                          float* dalpha, const float* z0, int K, int M,
                          int nk, int r_loc, int d_loc, int B, int n_passes,
                          float scale, int loss_id, float g, int has_prox,
                          float kappa, int u_in_smem, void* stream) {
  if (K < 1 || M < 1 || M > MAX_CLUSTER || nk < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(B, r_loc, d_loc, u_in_smem != 0);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(
      K, M, smem, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err;
  if (u_in_smem) {
    err = configure<true>(M, smem);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, sparse_sdca_zx_kernel<true>, cols, vals,
                               y, alpha, mask, sq, perm, u, dalpha, z0, M,
                               nk, r_loc, d_loc, B, n_passes, scale, loss_id,
                               g, has_prox, kappa);
  } else {
    err = configure<false>(M, smem);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, sparse_sdca_zx_kernel<false>, cols,
                               vals, y, alpha, mask, sq, perm, u, dalpha, z0,
                               M, nk, r_loc, d_loc, B, n_passes, scale,
                               loss_id, g, has_prox, kappa);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block, in bytes (the wrapper's smem_budget
// must agree).
long long sparse_sdca_zx_smem_bytes(int B, int r_loc, int d_loc,
                                    int u_in_smem) {
  return static_cast<long long>(smem_bytes(B, r_loc, d_loc, u_in_smem != 0));
}

// How many clusters of M blocks of this instance the card can hold at
// once (cudaOccupancyMaxActiveClusters) into *out; 0 means a cluster of M
// cannot be scheduled. Returns the cudaError_t (0 = ok).
int sparse_sdca_zx_max_clusters(int M, int B, int r_loc, int d_loc,
                                int u_in_smem, int* out) {
  *out = 0;
  if (M < 1 || M > MAX_CLUSTER) return 0;
  const size_t smem = smem_bytes(B, r_loc, d_loc, u_in_smem != 0);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, M, smem, nullptr, &attr);
  cudaError_t err;
  if (u_in_smem) {
    err = configure<true>(M, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          out, reinterpret_cast<const void*>(sparse_sdca_zx_kernel<true>),
          &cfg);
  } else {
    err = configure<false>(M, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          out, reinterpret_cast<const void*>(sparse_sdca_zx_kernel<false>),
          &cfg);
  }
  return static_cast<int>(err);
}

const char* sparse_sdca_zx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
