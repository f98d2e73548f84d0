// LocalSDCA over padded-ELL rows, with the fused soft-threshold prox and a
// prefetch ring, for Hopper (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/sparse_sdca.py, both
// vmapped over the K workers (entry sparse_local_sdca, pallas_call at :360):
//  * _sparse_sdca_kernel (with _block_walk and _prox; buffer_depth = 1),
//    by the DEPTH = 1 instance below;
//  * _sparse_sdca_pipelined_kernel (buffer_depth >= 2), by DEPTH = 2..8.
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
// Every depth walks the same rows with the same thread-to-slot map and the
// same block_sum2, so on rows without duplicate column ids every depth
// gives the same bits (with duplicates the shared-memory atomics may land
// in another order, at any depth).
//
// What bounds it on this card: a chain of nk * n_passes dependent steps
// per worker, each a gather, a block reduction, a serial scalar update and
// a scatter, separated by barriers. The bytes are tiny by comparison
// (nnz * 8 for rcv1's 677k x 47k at density 0.0016 is 0.13 ms at
// 3.35 TB/s), so step latency decides. Part of each step is loads from
// device memory whose addresses hang on perm: the row's cols/vals (rcv1's
// 640 MB of ELL data is far past the 50 MB L2) and its y, alpha, mask and
// dalpha.
//
// What the design does about it: one launch per round with a grid of K
// blocks; u (d floats) in dynamic shared memory for the whole walk, so
// gather and scatter never touch device memory (u plus the ring must fit
// the 232,448-byte limit; the wrapper's smem_budget rejects wider d); one
// thread per ELL slot (blockDim = r_max rounded up to a warp, at most
// 256); rows read in place through perm; the scatter an atomicAdd into
// shared u, and a barrier after it so the next row's gather reads the
// updated u. The row loads go through a ring of DEPTH stages in shared
// memory, after u. A stage holds one row: its cols and vals, its y /
// alpha / mask / dalpha and its row id. While row j is walked, the stage
// of row j + DEPTH - 1 is filled with cp.async (4-byte copies: a row of
// r_max = 118 slots is neither 16-byte sized nor aligned, so neither
// 16-byte cp.async nor TMA bulk copies apply), one commit group per step,
// and cp.async.wait_group<DEPTH - 1> before the walk leaves only the newer
// fills in flight. At DEPTH = 1 each row is fetched and waited for in its
// own step. perm itself is read one step ahead into a register, so that
// load hides behind the walk too. One row per stage, not a block of rows:
// the walk drains one row per step, so a row-sized stage refills at the
// rate it empties, and a ring of 128-row blocks (120 KB a stage at
// r_max = 118) would not fit beside u.
//
// Hazards:
//  * dalpha is prefetched. That is right only because a row appears once
//    per pass, so no step between the prefetch and the walk writes it.
//    Across the pass boundary the window reaches the next pass: the stage
//    of position j + DEPTH - 1 >= nk holds row perm[j + DEPTH - 1 - nk],
//    whose walk in this pass must be done, i.e. DEPTH <= nk. The launcher
//    refuses DEPTH > nk; the wrapper clamps DEPTH to nk.
//  * A stage is refilled one step after it was walked; the barrier that
//    ends each step keeps the fill from overwriting it under the scatter.
//  * u plus the ring must fit the 232,448-byte limit (the wrapper's
//    smem_budget): at d = 47,236 and r_max = 118, u is 188,944 B and a
//    depth-4 ring 3,856 B.

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_DEPTH = 8;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// words of one stage: cols (r_max) | vals (r_max) | y alpha mask dalpha row
__host__ __device__ __forceinline__ int stage_words(int r_max) {
  return 2 * r_max + 5;
}

// (z, sq) partials of one row over slots s = tid, tid + nthr, ...;
// block_sum2 totals them. With has_prox each gathered u entry goes through
// the soft-threshold.
__device__ __forceinline__ float2 row_partials(const int* ci, const float* vi,
                                               const float* u, int r_max,
                                               int has_prox, float kappa) {
  float z = 0.0f, sq = 0.0f;
  for (int s = threadIdx.x; s < r_max; s += blockDim.x) {
    const float v = vi[s];
    float uc = u[ci[s]];
    if (has_prox) uc = sdca::soft_threshold(uc, kappa);
    z += uc * v;
    sq += v * v;
  }
  return make_float2(z, sq);
}

// u[c_s] += coef * v_s over this thread's slots. An atomicAdd, not a store:
// duplicate column ids in a row, and zero padding slots sharing column 0
// with a real entry, must all land (slots with v == 0 are skipped, which
// is exact).
__device__ __forceinline__ void row_scatter(const int* ci, const float* vi,
                                            float* u, int r_max, float coef) {
  if (coef == 0.0f) return;
  for (int s = threadIdx.x; s < r_max; s += blockDim.x) {
    const float v = vi[s];
    if (v != 0.0f) atomicAdd(&u[ci[s]], coef * v);
  }
}

template <int DEPTH>
__global__ void __launch_bounds__(MAX_THREADS)
sparse_sdca_pipelined_kernel(const int* __restrict__ cols,
                             const float* __restrict__ vals,
                             const float* __restrict__ y,
                             const float* __restrict__ alpha,
                             const float* __restrict__ mask,
                             const float* __restrict__ w,
                             const int* __restrict__ perm,
                             float* __restrict__ dalpha,
                             float* __restrict__ du, int nk, int r_max, int d,
                             int n_passes, float scale, int loss_id, float g,
                             int has_prox, float kappa) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* scratch = reinterpret_cast<float2*>(smem);
  float* bcast = reinterpret_cast<float*>(smem + sdca::MAX_WARPS * 8);
  float* u = reinterpret_cast<float*>(smem + sdca::SCRATCH_BYTES);
  float* ring = u + d;
  const int sw = stage_words(r_max);

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t row0 = static_cast<size_t>(k) * nk;   // first row of worker k
  const int* perm_k = perm + row0;
  const long long total = static_cast<long long>(n_passes) * nk;

  // fill the stage of visit position `pos` (row i) into ring slot pos % DEPTH
  auto fill = [&](long long pos, int i) {
    float* st = ring + static_cast<int>(pos % DEPTH) * sw;
    const size_t r = row0 + i;
    const int* ci = cols + r * r_max;
    const float* vi = vals + r * r_max;
    for (int s = tid; s < r_max; s += nthr) {
      cp_async4(st + s, ci + s);
      cp_async4(st + r_max + s, vi + s);
    }
    float* sc = st + 2 * r_max;
    if (tid == 0) cp_async4(sc + 0, y + r);
    if (tid == 1) cp_async4(sc + 1, alpha + r);
    if (tid == 2) cp_async4(sc + 2, mask + r);
    if (tid == 3) cp_async4(sc + 3, dalpha + r);
    if (tid == 4) reinterpret_cast<int*>(sc)[4] = i;
  };

  for (int c = tid; c < d; c += nthr) u[c] = w[c];
  for (int p = 0; p < DEPTH - 1; ++p) {          // warm the ring
    if (p < total) fill(p, perm_k[p % nk]);
    cp_async_commit();
  }
  long long pf = DEPTH - 1;                      // next position to fill
  int pf_row = pf < total ? perm_k[pf % nk] : 0;

  for (long long j = 0; j < total; ++j, ++pf) {
    if (pf < total) fill(pf, pf_row);
    cp_async_commit();
    if (pf + 1 < total) pf_row = perm_k[(pf + 1) % nk];   // one step ahead
    cp_async_wait<DEPTH - 1>();
    __syncthreads();                  // stage j (and u at j = 0) published

    const float* st = ring + static_cast<int>(j % DEPTH) * sw;
    const int* ci = reinterpret_cast<const int*>(st);
    const float* vi = st + r_max;
    const float* sc = st + 2 * r_max;
    const float2 part =
        row_partials(ci, vi, u, r_max, has_prox, kappa);
    const float2 tot = sdca::block_sum2(part.x, part.y, scratch);
    if (tid == 0) {
      const float q = scale * tot.y;
      const float dai = sc[3];
      const float delta =
          sdca::cd_update(loss_id, g, sc[1] + dai, tot.x, q, sc[0]) * sc[2];
      dalpha[row0 + reinterpret_cast<const int*>(sc)[4]] = dai + delta;
      bcast[0] = scale * delta;
    }
    __syncthreads();
    row_scatter(ci, vi, u, r_max, bcast[0]);
    __syncthreads();
  }
  cp_async_wait<0>();
  float* du_k = du + static_cast<size_t>(k) * d;
  for (int c = tid; c < d; c += nthr) du_k[c] = u[c] - w[c];
}

template <int DEPTH>
int launch(int K, int threads, size_t smem, cudaStream_t stream,
           const int* cols, const float* vals, const float* y,
           const float* alpha, const float* mask, const float* w,
           const int* perm, float* dalpha, float* du, int nk, int r_max,
           int d, int n_passes, float scale, int loss_id, float g,
           int has_prox, float kappa) {
  cudaError_t err = cudaFuncSetAttribute(
      sparse_sdca_pipelined_kernel<DEPTH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_sdca_pipelined_kernel<DEPTH><<<K, threads, smem, stream>>>(
      cols, vals, y, alpha, mask, w, perm, dalpha, du, nk, r_max, d,
      n_passes, scale, loss_id, g, has_prox, kappa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch one round with a ring of `depth` rows (1 <= depth <= min(nk, 8)):
// K blocks, one per worker, on `stream`. dalpha must be zeroed by the
// caller. Returns the cudaError_t of the launch (0 = ok).
int sparse_sdca_pipelined_launch(const int* cols, const float* vals,
                                 const float* y, const float* alpha,
                                 const float* mask, const float* w,
                                 const int* perm, float* dalpha, float* du,
                                 int K, int nk, int r_max, int d,
                                 int n_passes, float scale, int loss_id,
                                 float g, int has_prox, float kappa,
                                 int depth, void* stream) {
  if (depth < 1 || depth > MAX_DEPTH || depth > nk)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((r_max + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS
                                                       : threads);
  const size_t smem = sdca::SCRATCH_BYTES + static_cast<size_t>(d) * 4 +
                      static_cast<size_t>(depth) * stage_words(r_max) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDCA_PIPELINED_CASE(D)                                             \
  case D:                                                                  \
    return launch<D>(K, threads, smem, s, cols, vals, y, alpha, mask, w,   \
                     perm, dalpha, du, nk, r_max, d, n_passes, scale,      \
                     loss_id, g, has_prox, kappa);
  switch (depth) {
    SDCA_PIPELINED_CASE(1)
    SDCA_PIPELINED_CASE(2)
    SDCA_PIPELINED_CASE(3)
    SDCA_PIPELINED_CASE(4)
    SDCA_PIPELINED_CASE(5)
    SDCA_PIPELINED_CASE(6)
    SDCA_PIPELINED_CASE(7)
    SDCA_PIPELINED_CASE(8)
  }
#undef SDCA_PIPELINED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* sparse_sdca_pipelined_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
