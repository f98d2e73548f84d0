// The z-exchange schedule of feature-sharded sparse LocalSDCA, for Hopper
// (sm_90a): one round in one launch, one thread-block cluster per worker
// (the cluster form), or one cooperative grid of persistent blocks that
// exchange through device memory (the grid form, GRID below), each block
// holding one worker's shard or, past what the card holds, W workers'
// shards walked in lockstep.
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
// The grid form (GRID), for a mesh whose M shards a cluster cannot hold
// (M > 16, or a cluster the card refuses) on one card. The per-block kernel
// (sparse_sdca_zx_block.cu) ran that mesh one launch an invocation, 8.47 us
// each at rcv1's 4 x 32, a launch's latency and a reload of the block's
// rows and u from device memory every time. Here one cooperative launch
// (cudaLaunchCooperativeKernel, so all K M blocks are resident at once or
// the launch is refused) runs the round; block (k, m) owns worker k's shard
// m for every invocation, so everything above carries over: u on chip where
// it fits (5.9 KB at 4 x 32), the prefetch ring, the rows' scalars. Only
// the exchange differs, since blocks outside a cluster cannot read each
// other's shared memory. It goes through device memory, and each partial
// dot carries its own flag:
//  * Shard m writes row t's partial dot of step g + 1 as one 64-bit word,
//    the float's bits beside the tag g + 1, to z[(g + 1) % 2][k][t][m]
//    (st.relaxed.gpu: one single-copy-atomic store, so a reader sees the
//    value and its tag together or neither). z[0] holds block 0's partial
//    dots at u = w with tag 0 (the wrapper's prologue).
//  * Step g's rows go to the warps (row t to warp t % 8). Lane j of the
//    row's warp loads shard j's word (ld.relaxed.gpu, past L1; a row's M
//    words lie side by side, so a warp's load is coalesced), the loads of
//    up to ZROWS rows and of every 32 shards in flight together, and
//    reloads until every lane holds tag g (__all_sync); then each lane adds
//    the M values in rank order j = 0..M-1 by __shfl_sync, the order of
//    the cluster form, the per-block kernel and the plain version, so z
//    keeps its bits. Lane 0 updates the row.
//  * No fence, no counter, no block barrier serves the exchange: a design
//    with a __threadfence and an atomicAdd a step on a worker's counter,
//    polled by one thread, then the M partials loaded by one thread a row,
//    took 4.14 us a step at rcv1's 4 x 32 (43.8 ms a round); taking out its
//    wait, its fence and its partials' loads saved 0.27, 0.37 and 1.15 us
//    of it (tools/sdca_step_ablation.py, H100 at 700 W). This design
//    takes 3.4-3.5 us a step there (36.3-37.1 ms a round), its exchange
//    1.0 us of it.
//  * Only the M blocks of one worker wait on each other, never the whole
//    grid.
//
// Workers in lockstep (the grid form's W > 1 instances), for a mesh whose
// K M blocks the card cannot hold at once (K = 32 x M = 32 at rcv1's
// widths: 1,024 blocks, 528 resident). Within a round the workers are
// independent; only the M shards of one worker exchange. So the launch has
// K' = ceil(K / W) groups of M blocks, and block (k', m) holds shard m of
// workers k' + j K' for j < W (the last groups fewer where W does not
// divide K). All M shards of a worker sit in one group and every block
// walks its workers in the same order, so no wait can form a cycle. Each
// worker keeps what it keeps at W = 1 in its own slab of shared memory
// (u where W slabs with u fit, else u stays in device memory; its ids,
// its prefetch ring, its coefficients) and its own (2, B, M) slice of the
// tagged words. The step's chain is latency-bound (barriers, L2 round
// trips, the exchange's 1.0 us), so every phase of a step runs over the
// W B rows of all its workers together, and W workers take about one
// chain, not W:
//  * warp t % 8 takes row t of every worker at once, the loops over the
//    worker slots unrolled so their loads are in flight together;
//  * the poll: zrows(W) rows of each worker a warp, W zrows(W) <= 4 words
//    a lane in flight; lane i of the warp then adds its i-th row's M words
//    in rank order from the warp's staging rows in shared memory (the same
//    additions as the shuffles at W = 1, so z keeps its bits) and updates
//    that row, the warp's updates side by side;
//  * rows of at most 16 slots (rcv1's r_loc 15) go two workers' rows a
//    copy, scatter and gather instruction, one a half warp: the prefetch
//    cost the instructions that send its copies, not the wait for them.
// Every grid instance is held to MIN_BLOCKS blocks an SM (64 registers a
// thread: 528 blocks resident at rcv1's widths), so each W keeps the
// residency of one worker a block. Measured at rcv1's 4 x 32 with the
// residency read lower (tools/sdca_step_ablation.py --workers, H100 at
// 700 W): walking a warp's W rows one after another, lane 0 updating them
// in turn, took 3.42, 7.14 and 13.21 us a step at W = 1, 2, 4, every part
// of the step growing with W; this design takes 3.16 us at W = 2 and 5.76
// at W = 4, and rcv1 at 32 x 32 runs a round in 0.42-0.49 of the
// per-block kernel's time.
//
// Hazards:
//  * Grid form, two z buffers: step g reads z[g % 2] (tag g) and writes
//    z[(g + 1) % 2] (tag g + 1). A shard writes z[g % 2] again only at the
//    end of step g + 1, after it read every peer's tag g + 1; each peer
//    wrote that after its own reads of z[g % 2] in step g, and the value it
//    wrote depends on them. A tag is never reused within a buffer (g and
//    g + 2). A word that never arrives traps after ~2^34 cycles instead of
//    hanging the card.
//  * Lockstep: row t of worker slot j is updated by warp t % 8, lane
//    j zrows(W) + (t / 8) % zrows(W), in every step (nb = 1 below).
//    A warp's staging rows are written after its poll and read by lanes
//    below ZR between two __syncwarp()s.
//  * dalpha is prefetched two blocks ahead. Block g + 2's rows were last
//    written in step g + 2 - nb: before step g when nb >= 3, in step g's
//    update (before the barrier ahead of the prefetch) when nb = 2. At
//    nb = 1 they are written in step g + 1, after the prefetch, so there
//    the update reads dalpha from device memory (thread t owns row t in
//    every step, in the grid form lane 0 of warp t % 8, so it reads its
//    own write).
//  * The prefetch into stage g % 2 starts after the barrier that ends
//    block g's scatter; its wait is the cp.async.wait_all ahead of the
//    barrier of the next step's prefetch point, before block g + 2's dots.


#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "sdca_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int PORTABLE_CLUSTER = 8;
constexpr int MAX_CLUSTER = 16;
constexpr int ID_SLOTS = 4;          // row ids of blocks g .. g + 3
constexpr int SCALARS = 5;           // y, alpha, mask, sqnorm, dalpha
constexpr int ZROWS = 2;             // grid form: a worker's rows a warp polls
constexpr int XS_STRIDE = 33;        // a staged row's 32 words, padded a bank

// grid form: the rows of each worker a warp polls at once, and so how many
// words a lane holds in flight (W zrows(W), at most 4)
__host__ __device__ constexpr int zrows(int W) { return W <= 2 ? ZROWS : 1; }
constexpr int MIN_BLOCKS = 4;        // blocks an SM a grid instance keeps

// 4-byte words of one row stage: cols (B r_loc) | vals (B r_loc) | scalars
__host__ __device__ __forceinline__ int stage_words(int B, int r_loc) {
  return 2 * B * r_loc + SCALARS * B;
}

// dynamic shared memory of one block, in bytes: W slabs of one worker's
// [u (d_loc)] | zb (2 B) | coef (B) | ids (ID_SLOTS B) | two stages, then
// at W > 1 each warp's staging rows of the exchange (W zrows(W) of
// XS_STRIDE floats)
__host__ __device__ __forceinline__ size_t smem_bytes(int B, int r_loc,
                                                      int d_loc, bool u_smem,
                                                      int W = 1) {
  return 4 * (static_cast<size_t>(W) *
                  ((u_smem ? static_cast<size_t>(d_loc) : 0) +
                   static_cast<size_t>(3 + ID_SLOTS) * B +
                   2 * static_cast<size_t>(stage_words(B, r_loc))) +
              (W > 1 ? static_cast<size_t>(NWARPS) * W * zrows(W) * XS_STRIDE
                     : 0));
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

// One worker's view of its inputs and of its slab of shared memory, in
// block (k, m).
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
};

// row ids of the seq-th block of the round into each worker's slot;
// walk(j) is worker slot j's Walk, nw the block's workers
template <int W, class WalkOf>
__device__ void fetch_ids(const WalkOf& walk, int nw, int seq) {
  const Walk w0 = walk(0);
  const int n = w0.rows_of(seq);
  const int lo = (seq % w0.nb) * w0.B;
  for (int t = threadIdx.x; t < n; t += THREADS) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < nw) {
        const Walk w = walk(j);
        cp_async4(w.ids_of(seq) + t, w.perm_k + lo + t);
      }
    }
  }
}

// each worker's seq-th block's rows (their ids must have landed) into its
// stage: one warp a row of every worker at once for cols and vals, one
// thread a row of every worker for the scalars
template <int W, class WalkOf>
__device__ void fetch_rows(const WalkOf& walk, int nw, int seq) {
  const Walk w0 = walk(0);
  const int n = w0.rows_of(seq), r_loc = w0.r_loc, B = w0.B;
  const int lane = threadIdx.x & 31;
  if (W > 1 && r_loc <= 16) {
    // two workers' row t a copy instruction: lane 16 h + s copies slot s
    // of worker slot 2 p + h's row
    const int h = lane >> 4, s = lane & 15;
    for (int t = threadIdx.x >> 5; t < n; t += NWARPS) {
#pragma unroll
      for (int p = 0; p < (W + 1) / 2; ++p) {
        const int j = 2 * p + h;
        if (j < nw && s < r_loc) {
          const Walk w = walk(j);
          const size_t off = static_cast<size_t>(w.ids_of(seq)[t]) * r_loc;
          cp_async4(reinterpret_cast<int*>(w.stage_of(seq)) + t * r_loc + s,
                    w.cols_km + off + s);
          cp_async4(w.stage_of(seq) + B * r_loc + t * r_loc + s,
                    w.vals_km + off + s);
        }
      }
    }
  } else {
    for (int t = threadIdx.x >> 5; t < n; t += NWARPS) {
      size_t off[W];
#pragma unroll
      for (int j = 0; j < W; ++j)
        off[j] = j < nw ? static_cast<size_t>(walk(j).ids_of(seq)[t]) * r_loc
                        : 0;
      for (int s = lane; s < r_loc; s += 32) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          if (j < nw) {
            const Walk w = walk(j);
            int* ci = reinterpret_cast<int*>(w.stage_of(seq));
            float* vi = w.stage_of(seq) + B * r_loc;
            cp_async4(ci + t * r_loc + s, w.cols_km + off[j] + s);
            cp_async4(vi + t * r_loc + s, w.vals_km + off[j] + s);
          }
        }
      }
    }
  }
  for (int t = threadIdx.x; t < n; t += THREADS) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < nw) {
        const Walk w = walk(j);
        const int i = w.ids_of(seq)[t];
        float* sc = w.stage_of(seq) + 2 * B * r_loc;
        cp_async4(sc + t, w.y_k + i);
        cp_async4(sc + B + t, w.alpha_k + i);
        cp_async4(sc + 2 * B + t, w.mask_k + i);
        cp_async4(sc + 3 * B + t, w.sq_k + i);
        cp_async4(sc + 4 * B + t, w.da_km + i);
      }
    }
  }
}

template <bool U_SMEM>
__device__ __forceinline__ float load_u(const float* p) {
  if constexpr (U_SMEM) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

// Grid form: a tagged partial dot, the float's bits low, the step high
__device__ __forceinline__ unsigned long long tagged(float z, int step) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(step))
          << 32) |
         __float_as_uint(z);
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// Grid form: shard j's words of ZR rows into wv[], reloaded until every
// lane of the calling warp holds tag `step`: row(i) points at row i's M
// words, side by side, so a warp's load of 32 shards is two 128-byte
// lines; live(i) says whether row i exists.
template <int ZR, class RowWords, class Live>
__device__ __forceinline__ void poll_words(const RowWords& row,
                                           const Live& live, int M, int j,
                                           int step,
                                           unsigned long long (&wv)[ZR]) {
  bool ready = true;
#pragma unroll
  for (int r = 0; r < ZR; ++r)
    wv[r] = live(r) && j < M ? load_word(row(r) + j) : tagged(0.0f, step);
  const long long c0 = clock64();
  for (int spin = 0;; ++spin) {
#pragma unroll
    for (int r = 0; r < ZR; ++r)
      ready &= static_cast<int>(wv[r] >> 32) == step;
    if (__all_sync(0xffffffffu, ready)) break;
    if (clock64() - c0 > (1LL << 34)) __trap();
    if (spin >= 16) __nanosleep(32);
    ready = true;
#pragma unroll
    for (int r = 0; r < ZR; ++r) {
      if (static_cast<int>(wv[r] >> 32) != step)
        wv[r] = load_word(row(r) + j);
    }
  }
}

// Grid form at W = 1: the exchanged z of ZR rows into zr[], the same in
// every lane of the calling warp, each row's M values added in rank order
// by __shfl_sync.
template <int ZR, class RowWords, class Live>
__device__ __forceinline__ void exchange_rows(const RowWords& row,
                                              const Live& live, int M,
                                              int step, float (&zr)[ZR]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < ZR; ++r) zr[r] = 0.0f;
  for (int j0 = 0; j0 < M; j0 += 32) {
    unsigned long long wv[ZR];
    poll_words<ZR>(row, live, M, j0 + lane, step, wv);
    // the M values in rank order, every lane the same sums
    const int nj = min(32, M - j0);
    for (int jj = 0; jj < nj; ++jj) {
#pragma unroll
      for (int r = 0; r < ZR; ++r)
        zr[r] += __uint_as_float(__shfl_sync(
            0xffffffffu, static_cast<unsigned>(wv[r]), jj));
    }
  }
}

// Grid form at W > 1: the exchanged z of the warp's row `lane` (lanes
// below ZR), its M values added in rank order from the warp's staging
// rows xs (ZR x XS_STRIDE floats): the same additions in the same order
// as exchange_rows, by one lane a row instead of every lane every row.
template <int ZR, class RowWords, class Live>
__device__ __forceinline__ float exchange_staged(const RowWords& row,
                                                 const Live& live, int M,
                                                 int step, float* xs) {
  const int lane = threadIdx.x & 31;
  float z = 0.0f;
  for (int j0 = 0; j0 < M; j0 += 32) {
    unsigned long long wv[ZR];
    poll_words<ZR>(row, live, M, j0 + lane, step, wv);
#pragma unroll
    for (int r = 0; r < ZR; ++r)
      xs[r * XS_STRIDE + lane] = __uint_as_float(static_cast<unsigned>(wv[r]));
    __syncwarp();
    if (lane < ZR) {
      const int nj = min(32, M - j0);
      for (int jj = 0; jj < nj; ++jj) z += xs[lane * XS_STRIDE + jj];
    }
    __syncwarp();                    // read before the next 32 shards land
  }
  return z;
}

template <bool U_SMEM, bool GRID, int W>
__global__ void __launch_bounds__(THREADS, GRID ? MIN_BLOCKS : 1)
sparse_sdca_zx_kernel(const int* __restrict__ cols,
                      const float* __restrict__ vals,
                      const float* __restrict__ y,
                      const float* __restrict__ alpha,
                      const float* __restrict__ mask,
                      const float* __restrict__ sq,
                      const int* __restrict__ perm, float* __restrict__ u,
                      float* __restrict__ dalpha,
                      const float* __restrict__ z0, unsigned long long* zx,
                      int K, int M, int nk, int r_loc,
                      int d_loc, int B, int n_passes, float scale,
                      int loss_id, float g, int has_prox, float kappa) {
  // z0: the cluster form's (K, M, B) prologue dots; zx: the grid form's
  // (2, K, B, M) tagged words, zx[0] the prologue dots (written by other
  // blocks during the launch: no __restrict__)
  extern __shared__ __align__(16) float smem[];
  const int m = static_cast<int>(blockIdx.x) % M;   // the cluster's rank
  const int k0 = static_cast<int>(blockIdx.x) / M;  // slot 0's worker
  const int groups = static_cast<int>(gridDim.x) / M;   // K'
  // the block's workers k0 + j K', j < nw: W but in the last groups
  const int nw = W == 1 ? 1 : min(W, (K - k0 + groups - 1) / groups);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = (nk + B - 1) / B;
  const size_t slab = smem_bytes(B, r_loc, d_loc, U_SMEM) / 4;

  // worker slot j: worker k0 + j K', its slab of shared memory
  // [u] | zb (2 B) | coef (B) | ids | stages, its u slice in device memory
  auto worker = [&](int j) { return k0 + j * groups; };
  auto zb_of = [&](int j) { return smem + j * slab + (U_SMEM ? d_loc : 0); };
  auto coef_of = [&](int j) { return zb_of(j) + 2 * B; };
  auto u_of = [&](int j) {
    return u + (static_cast<size_t>(worker(j)) * M + m) * d_loc;
  };
  auto uu_of = [&](int j) {                    // u as gathered/scattered
    return U_SMEM ? smem + j * slab : u_of(j);
  };
  auto make_walk = [&](int j) {
    const int k = worker(j);
    const size_t km = static_cast<size_t>(k) * M + m;
    const size_t r0 = static_cast<size_t>(k) * nk;
    float* coef = coef_of(j);
    return Walk{perm + r0,
                cols + km * nk * r_loc,
                vals + km * nk * r_loc,
                y + r0, alpha + r0, mask + r0, sq + r0,
                dalpha + km * nk,
                reinterpret_cast<int*>(coef + B),
                coef + B + ID_SLOTS * B,
                nk, r_loc, B, nb, stage_words(B, r_loc)};
  };
  const Walk w0 = make_walk(0);
  auto walk = [&](int j) { return W == 1 ? w0 : make_walk(j); };
  const int total = n_passes * nb;
  // grid form: row t of worker slot j's words, z[s % 2][k][t][:]
  const size_t zhalf = static_cast<size_t>(K) * B * M;
  auto zrow = [&](int s, int j, int t) {
    return zx + (s & 1) * zhalf +
           (static_cast<size_t>(worker(j)) * B + t) * M;
  };

  // prologue: u, block 0's partial dots at u = w, ids of blocks 0-2 and the
  // rows of blocks 0-1
  if constexpr (U_SMEM) {
    for (int j = 0; j < nw; ++j) {
      float* us = smem + j * slab;
      const float* uk = u_of(j);
      for (int i = tid; i < d_loc; i += THREADS) us[i] = uk[i];
    }
  }
  if constexpr (!GRID) {
    const size_t km = static_cast<size_t>(k0) * M + m;
    for (int t = tid; t < B; t += THREADS) zb_of(0)[t] = z0[km * B + t];
  }
  fetch_ids<W>(walk, nw, 0);
  fetch_ids<W>(walk, nw, 1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  fetch_rows<W>(walk, nw, 0);
  fetch_rows<W>(walk, nw, 1);
  fetch_ids<W>(walk, nw, 2);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int step = 0; step < total; ++step) {
    const int n = w0.rows_of(step);         // every worker's block: n rows
    // worker slot j's row update of its row t at its exchanged z
    auto update = [&](int j, int t, float z) {
      const Walk w = walk(j);
      const float* sc = w.stage_of(step) + 2 * B * r_loc;
      const int i = w.ids_of(step)[t];
      const float dai = nb == 1 ? w.da_km[i] : sc[4 * B + t];
      const float delta = sdca::cd_update(loss_id, g, sc[B + t] + dai, z,
                                          scale * sc[3 * B + t], sc[t]) *
                          sc[2 * B + t];
      w.da_km[i] = dai + delta;
      coef_of(j)[t] = scale * delta;
    };
    if constexpr (GRID) {
      // each warp waits for and sums its own rows' partials, rows t0,
      // t0 + NWARPS, ... (ZW of them) of every worker at once (ZR): no
      // barrier
      constexpr int ZW = zrows(W), ZR = W * ZW;
      for (int t0 = warp; t0 < n; t0 += NWARPS * ZW) {
        // the warp's row i: worker slot i / ZW, row t0 + (i % ZW) NWARPS
        auto row_t = [&](int i) { return t0 + (i % ZW) * NWARPS; };
        auto live = [&](int i) { return i / ZW < nw && row_t(i) < n; };
        auto words = [&](int i) { return zrow(step, i / ZW, row_t(i)); };
        if constexpr (W == 1) {
          float zr[ZR];
          exchange_rows<ZR>(words, live, M, step, zr);
#pragma unroll
          for (int r = 0; r < ZR; ++r)
            if (lane == 0 && live(r)) update(0, row_t(r), zr[r]);
        } else {
          // lane i sums and updates the warp's row i, side by side
          const float z = exchange_staged<ZR>(
              words, live, M, step,
              smem + W * slab + warp * (ZR * XS_STRIDE));
          if (lane < ZR && live(lane)) update(lane / ZW, row_t(lane), z);
        }
      }
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();                // every peer's zb[step % 2] is written
      // the exchanged z and the row updates: one thread per row
      float* zb = zb_of(0);
      const int zin = (step & 1) * B;
      for (int t = tid; t < n; t += THREADS) {
        float z = 0.0f;
        for (int mm = 0; mm < M; ++mm)
          z += cluster.map_shared_rank(zb, mm)[zin + t];
        update(0, t, z);
      }
    }
    __syncthreads();

    // the scatter into each worker's u slice: one warp per row t, of
    // every worker at once (two workers' rows an instruction where they
    // fit half a warp)
    if (W > 1 && r_loc <= 16) {
      const int h = lane >> 4, s = lane & 15;
      for (int t = warp; t < n; t += NWARPS) {
#pragma unroll
        for (int p = 0; p < (W + 1) / 2; ++p) {
          const int j = 2 * p + h;
          const float c = j < nw && s < r_loc ? coef_of(j)[t] : 0.0f;
          if (c != 0.0f) {
            const Walk w = walk(j);
            const int* ci = reinterpret_cast<const int*>(w.stage_of(step));
            const float v = w.stage_of(step)[B * r_loc + t * r_loc + s];
            if (v != 0.0f) atomicAdd(uu_of(j) + ci[t * r_loc + s], c * v);
          }
        }
      }
    } else {
      for (int t = warp; t < n; t += NWARPS) {
        float c[W];
        bool any = false;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          c[j] = j < nw ? coef_of(j)[t] : 0.0f;
          any |= c[j] != 0.0f;
        }
        if (!any) continue;
        for (int s = lane; s < r_loc; s += 32) {
#pragma unroll
          for (int j = 0; j < W; ++j) {
            if (c[j] != 0.0f) {
              const Walk w = walk(j);
              const int* ci =
                  reinterpret_cast<const int*>(w.stage_of(step));
              const float v = w.stage_of(step)[B * r_loc + t * r_loc + s];
              if (v != 0.0f)
                atomicAdd(uu_of(j) + ci[t * r_loc + s], c[j] * v);
            }
          }
        }
      }
    }
    // block step + 1's rows and block step + 2's ids have landed; block
    // step's stage and step - 1's id slot are free
    cp_async_wait_all();
    __syncthreads();
    fetch_rows<W>(walk, nw, step + 2);
    fetch_ids<W>(walk, nw, step + 3);
    cp_async_commit();

    // the next block's partial dots at the updated u: one warp per row t,
    // of every worker at once
    if (step + 1 < total && W > 1 && r_loc <= 16) {
      // two workers' rows an instruction: half h of the warp sums worker
      // slot 2 p + h's row with the butterfly's last four levels (the
      // first would add the 0 of lanes past r_loc: the same bits)
      const int n2 = w0.rows_of(step + 1);
      const int h = lane >> 4, s = lane & 15;
      for (int t = warp; t < n2; t += NWARPS) {
        float z[(W + 1) / 2];
#pragma unroll
        for (int p = 0; p < (W + 1) / 2; ++p) {
          const int j = 2 * p + h;
          z[p] = 0.0f;
          if (j < nw && s < r_loc) {
            const Walk w = walk(j);
            const int* c2 =
                reinterpret_cast<const int*>(w.stage_of(step + 1));
            const float* v2 = w.stage_of(step + 1) + B * r_loc;
            float uc = load_u<U_SMEM>(uu_of(j) + c2[t * r_loc + s]);
            if (has_prox) uc = sdca::soft_threshold(uc, kappa);
            z[p] += uc * v2[t * r_loc + s];
          }
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
          for (int p = 0; p < (W + 1) / 2; ++p)
            z[p] += __shfl_xor_sync(0xffffffffu, z[p], o);
        }
        if (s == 0) {
#pragma unroll
          for (int p = 0; p < (W + 1) / 2; ++p) {
            if (2 * p + h < nw)
              store_word(zrow(step + 1, 2 * p + h, t) + m,
                         tagged(z[p], step + 1));
          }
        }
      }
    } else if (step + 1 < total) {
      const int n2 = w0.rows_of(step + 1);
      for (int t = warp; t < n2; t += NWARPS) {
        float z[W];
#pragma unroll
        for (int j = 0; j < W; ++j) z[j] = 0.0f;
        for (int s = lane; s < r_loc; s += 32) {
#pragma unroll
          for (int j = 0; j < W; ++j) {
            if (j < nw) {
              const Walk w = walk(j);
              const int* c2 =
                  reinterpret_cast<const int*>(w.stage_of(step + 1));
              const float* v2 = w.stage_of(step + 1) + B * r_loc;
              float uc = load_u<U_SMEM>(uu_of(j) + c2[t * r_loc + s]);
              if (has_prox) uc = sdca::soft_threshold(uc, kappa);
              z[j] += uc * v2[t * r_loc + s];
            }
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int j = 0; j < W; ++j)
            z[j] += __shfl_xor_sync(0xffffffffu, z[j], o);
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < W; ++j) {
            if (j < nw) {
              if constexpr (GRID) {
                store_word(zrow(step + 1, j, t) + m, tagged(z[j], step + 1));
              } else {
                zb_of(0)[((step + 1) & 1) * B + t] = z[j];
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();
  if constexpr (!GRID) {
    cg::this_cluster().sync();       // peers are done reading this zb
  }
  if constexpr (U_SMEM) {
    for (int j = 0; j < nw; ++j) {
      const float* us = smem + j * slab;
      float* uk = u_of(j);
      for (int i = tid; i < d_loc; i += THREADS) uk[i] = us[i];
    }
  }
}

template <bool U_SMEM, bool GRID, int W>
cudaError_t configure(int M, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      sparse_sdca_zx_kernel<U_SMEM, GRID, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && !GRID && M > PORTABLE_CLUSTER)
    err = cudaFuncSetAttribute(sparse_sdca_zx_kernel<U_SMEM, GRID, W>,
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

// f(std::integral_constant<int, W>) for the grid form's instance of W
// workers a block (1-4; sparse_sdca.ZX_GRID_WORKERS); an error for a W it
// is not built for
template <class F>
cudaError_t with_workers(int W, F f) {
  switch (W) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
  }
  return cudaErrorInvalidValue;
}

// The grid form's launch: ceil(K / W) groups of M blocks, all resident or
// refused
template <bool U_SMEM, int W>
cudaError_t launch_grid(const int* cols, const float* vals, const float* y,
                        const float* alpha, const float* mask,
                        const float* sq, const int* perm, float* u,
                        float* dalpha, unsigned long long* z, int K, int M,
                        int nk, int r_loc, int d_loc, int B, int n_passes,
                        float scale, int loss_id, float g, int has_prox,
                        float kappa, cudaStream_t stream) {
  const size_t smem = smem_bytes(B, r_loc, d_loc, U_SMEM, W);
  cudaError_t err = configure<U_SMEM, true, W>(M, smem);
  if (err != cudaSuccess) return err;
  const float* z0 = nullptr;          // the cluster form's prologue dots
  void* args[] = {&cols,  &vals,  &y,     &alpha,    &mask,  &sq,
                  &perm,  &u,     &dalpha, &z0,      &z,     &K,
                  &M,     &nk,    &r_loc, &d_loc,    &B,     &n_passes,
                  &scale, &loss_id, &g,   &has_prox, &kappa};
  const int groups = (K + W - 1) / W;
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sparse_sdca_zx_kernel<U_SMEM, true, W>),
      dim3(groups * M), dim3(THREADS), args, smem, stream);
}

// How many blocks of the grid instance of W workers a block the card holds
// at once: blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// times the SMs; 0 where the card takes no cooperative launch
template <bool U_SMEM, int W>
cudaError_t grid_resident(size_t smem, int* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = configure<U_SMEM, true, W>(1, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sparse_sdca_zx_kernel<U_SMEM, true, W>, THREADS, smem);
  if (err == cudaSuccess) *out = coop ? per_sm * sms : 0;
  return err;
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
                          float* dalpha, float* z0, int K, int M,
                          int nk, int r_loc, int d_loc, int B, int n_passes,
                          float scale, int loss_id, float g, int has_prox,
                          float kappa, int u_in_smem, void* stream) {
  if (K < 1 || M < 1 || M > MAX_CLUSTER || nk < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(B, r_loc, d_loc, u_in_smem != 0);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(
      K, M, smem, static_cast<cudaStream_t>(stream), &attr);
  unsigned long long* none = nullptr;   // the grid form's words
  cudaError_t err;
  if (u_in_smem) {
    err = configure<true, false, 1>(M, smem);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, sparse_sdca_zx_kernel<true, false, 1>,
                               cols, vals, y, alpha, mask, sq, perm, u,
                               dalpha, z0, none, K, M, nk, r_loc, d_loc, B,
                               n_passes, scale, loss_id, g, has_prox, kappa);
  } else {
    err = configure<false, false, 1>(M, smem);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, sparse_sdca_zx_kernel<false, false, 1>,
                               cols, vals, y, alpha, mask, sq, perm, u,
                               dalpha, z0, none, K, M, nk, r_loc, d_loc, B,
                               n_passes, scale, loss_id, g, has_prox, kappa);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Run one round in one cooperative launch on `stream` (the grid form):
// ceil(K / workers) groups of M blocks, block (k', m) walking shard m of
// workers k' + j ceil(K / workers), j < workers, in lockstep. u and dalpha
// as above; z (2, K, B, M) 64-bit words, z[0] block 0's partial dots at
// u = w with tag 0 (the float's bits in the low half, the high half 0),
// z[1] zeroed. The launch is refused (an error, never another form) where
// the card cannot hold all its blocks at once. Returns the cudaError_t
// (0 = ok).
int sparse_sdca_zx_grid_launch(const int* cols, const float* vals,
                               const float* y, const float* alpha,
                               const float* mask, const float* sq,
                               const int* perm, float* u, float* dalpha,
                               unsigned long long* z, int K, int M, int nk,
                               int r_loc, int d_loc, int B, int n_passes,
                               float scale, int loss_id, float g,
                               int has_prox, float kappa, int u_in_smem,
                               int workers, void* stream) {
  // the tags count the round's steps
  if (K < 1 || M < 1 || nk < 1 || B < 1 || n_passes < 0 ||
      static_cast<long long>(n_passes) * ((nk + B - 1) / B) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_workers(workers, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return u_in_smem
               ? launch_grid<true, W>(cols, vals, y, alpha, mask, sq, perm,
                                      u, dalpha, z, K, M, nk, r_loc, d_loc,
                                      B, n_passes, scale, loss_id, g,
                                      has_prox, kappa, s)
               : launch_grid<false, W>(cols, vals, y, alpha, mask, sq, perm,
                                       u, dalpha, z, K, M, nk, r_loc, d_loc,
                                       B, n_passes, scale, loss_id, g,
                                       has_prox, kappa, s);
  });
  if (err != cudaSuccess) {
    cudaGetLastError();   // a refused launch is not left for the next one
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block, in bytes (the wrapper's smem_budget
// must agree; the grid form's layout at W = 1 is the same).
long long sparse_sdca_zx_smem_bytes(int B, int r_loc, int d_loc,
                                    int u_in_smem) {
  return static_cast<long long>(smem_bytes(B, r_loc, d_loc, u_in_smem != 0));
}

// The same for the grid form's block of `workers` workers (W slabs).
long long sparse_sdca_zx_grid_smem_bytes(int B, int r_loc, int d_loc,
                                         int u_in_smem, int workers) {
  return static_cast<long long>(
      smem_bytes(B, r_loc, d_loc, u_in_smem != 0, workers));
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
    err = configure<true, false, 1>(M, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          out,
          reinterpret_cast<const void*>(sparse_sdca_zx_kernel<true, false, 1>),
          &cfg);
  } else {
    err = configure<false, false, 1>(M, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          out,
          reinterpret_cast<const void*>(
              sparse_sdca_zx_kernel<false, false, 1>),
          &cfg);
  }
  return static_cast<int>(err);
}

// How many blocks of the grid form's instance of `workers` workers a block
// the card holds at once (its blocks an SM times the SMs; 0 without
// cooperative launches) into *out: the grid form runs where its
// ceil(K / workers) M blocks fit. Returns the cudaError_t (0 = ok).
int sparse_sdca_zx_grid_resident(int B, int r_loc, int d_loc, int u_in_smem,
                                 int workers, int* out) {
  *out = 0;
  return static_cast<int>(with_workers(workers, [&](auto w) {
    constexpr int W = decltype(w)::value;
    const size_t smem = smem_bytes(B, r_loc, d_loc, u_in_smem != 0, W);
    return u_in_smem ? grid_resident<true, W>(smem, out)
                     : grid_resident<false, W>(smem, out);
  }));
}

const char* sparse_sdca_zx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
