// The z-exchange schedule of feature-sharded sparse LocalSDCA, for Hopper
// (sm_90a): one round in one launch, one thread-block cluster per worker
// (the cluster form), or one cooperative grid of persistent blocks that
// exchange through device memory (the grid form), each block holding one
// worker's shard or, past what the card holds, W workers' shards walked in
// lockstep.
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
// What the design does about it, in both forms:
//  * One launch per round; the loop over the n_passes nb invocations runs
//    inside the kernel.
//  * u in shared memory where it fits (U_SMEM): the block's u slice, 4
//    d_loc bytes (94 KB at rcv1's 4 x 2), beside the buffers below under
//    the 232,448-byte limit; the gather and the scatter are then
//    shared-memory operations, and u goes back to device memory once, at
//    the end of the round. Where it does not fit the same kernel runs with
//    u in device memory (U_SMEM false), gathered with __ldcg past L1 after
//    the block's own atomics.
//
// The cluster form (sparse_sdca_zx_cluster_kernel), for M <= 16: a grid of
// K M blocks in clusters of M (cudaLaunchKernelEx, cluster dimension
// (M, 1, 1)); cluster k is worker k, block rank m its model shard. Workers
// never wait for each other: clusters are independent, so K is not bounded
// by co-residency (clusters that do not fit run in a later wave, with the
// same result). M is bounded by the cluster size the card schedules: 8
// portable, 16 with the non-portable attribute; the wrapper asks
// cudaOccupancyMaxActiveClusters (zx_max_clusters below) and refuses what
// does not fit. A block is eight walk warps and one fetch warp.
//  * The exchange waits for data, not for the cluster. Each block pushes
//    its B partial dots of step g + 1 into slot m of every peer's buffer
//    xb[(g + 1) % 2] (row t's M partials side by side) with
//    st.async.shared::cluster, each store completing 4 bytes of the
//    transaction on that peer's mbarrier xbar[(g + 1) % 2]; a block waits
//    only on its own mbarrier, for the M partials of the step's rows, and
//    sums row t's M partials in rank order 0..M-1, the order of the grid
//    form, the per-block kernel and the plain version, so z keeps its bits.
//    Step 0's partials are the wrapper's prologue dots, read from z0.
//  * A row's warp owns it: warp w holds rows w, w + 8, ... through the
//    exchange, the update and the scatter; lane i sums and updates the
//    warp's row i, the rows side by side, and the warp scatters them at
//    once, each row's coefficient from its lane by __shfl_sync. The one
//    barrier of the walk warps left on the chain separates the scatter
//    from the next block's dots.
//  * The scatter expects what the dots saw: at B <= 16 a warp's rows of
//    block g + 1 are the ones it scatters in step g + 1, so each lane keeps
//    its slots' ids, values and u as the dots gathered them, and the
//    scatter is one compare-and-swap a slot, issued together, expecting
//    that u (only the step's own rows change u in between), the ones that
//    lost to a row sharing the id going round again; it rounds as
//    atomicAdd rounds (the product, then the add). Slots past a lane's
//    SLOTS, larger blocks and u in device memory take atomicAdd.
//  * The rows come from a fetch warp over a ring of stages of B rows (4
//    where they fit beside u, down to 2): block seq into stage seq % ring
//    once the walk has released block seq - ring (`empty`), each row's cols
//    and vals by two bulk copies of its 16-byte chunks (cp.async.bulk;
//    4-byte cp.async where the arrays allow no 16-byte chunks) and its
//    five scalars by 4-byte cp.async, all completing on the stage's `full`
//    mbarrier. The walk's chain is then the exchange, the update, the
//    scatter, one barrier and the dots; the fetch warp issues in its
//    shadow.
//  * Why (tools/sdca_step_ablation.py --only zxc, the stamped split, rcv1
//    4 x 2, B = 16, H100 at 700 W): the former design, one cluster barrier
//    a step, the 16 updating threads' DSMEM loads, the scatter by
//    atomicAdd and the prefetch issued by the walk's own warps between the
//    scatter and the dots, took 3.42 us a step: cluster barrier 0.53,
//    exchange loads 0.21, update 0.15, scatter 0.80, prefetch issue 1.11,
//    dots 0.60. This design takes 2.30 us: exchange wait 0.22, sum 0.11,
//    update 0.20, scatter 0.59, barrier 0.24, wait for the stage 0.16,
//    dots 0.50, sends 0.25; the fetch warp is busy 1.65 us a block.
//
// The grid form (sparse_sdca_zx_grid_kernel), for a mesh whose M shards a
// cluster cannot hold (M > 16, or a cluster the card refuses) on one card.
// The per-block kernel (sparse_sdca_zx_block.cu) ran that mesh one launch
// an invocation, 8.47 us each at rcv1's 4 x 32, a launch's latency and a
// reload of the block's rows and u from device memory every time. Here
// one cooperative launch (cudaLaunchCooperativeKernel, so all K M blocks
// are resident at once or the launch is refused) runs the round; block
// (k, m) owns worker k's shard m for every invocation: u on chip where it
// fits (5.9 KB at 4 x 32). The
// next blocks' rows are prefetched by the block's own threads with 4-byte
// cp.async: during step g the row ids of block g + 3 and the cols, vals,
// y, alpha, mask, sqnorm and dalpha of block g + 2, into a ring of two row
// stages and four id slots. Blocks outside a cluster cannot read each
// other's shared memory, so the exchange goes through device memory, and
// each partial dot carries its own flag:
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
//  * Cluster form, two exchange buffers: step g reads xb[g % 2] once its
//    mbarrier's phase completes, and pushes step g + 1's partials into the
//    peers' xb[(g + 1) % 2]. A block pushes into a peer's buffer b again
//    (step g + 2's partials, in step g + 1) only after it received that
//    peer's step g + 1 partials, which the peer pushed after its update of
//    step g had read its own buffer b: so no store reaches a buffer still
//    being read, nor a barrier phase still being waited for. A barrier's
//    phase for step g + 2 is armed (arrive.expect_tx, thread 0) after
//    thread 0's wait of step g, and no store of step g + 2 can come before
//    that wait (a store arriving before the arming only leaves the
//    transaction count below zero until it). The barriers are initialised
//    and fenced (fence.mbarrier_init) before a cluster barrier that comes
//    before the first remote store, and a cluster barrier after the last
//    step keeps every block alive until no peer sends to it.
//  * Cluster form, the ring: block seq's stage is refilled only after the
//    walk's barrier that ends block seq - ring's scatter (thread 0 arrives
//    on `empty` after it); the walk waits on `full` before block seq's dots
//    (step seq - 1), which also covers its update's scalars in step seq.
//    dalpha rides in the stage when nb >= ring: block seq's rows were last
//    updated in step seq - nb <= seq - ring, before that release. Past
//    that (a pass shorter than the ring) the update reads dalpha from
//    device memory: the row's lane is the same in every pass, so it reads
//    its own write.
//  * Cluster form, the held slots: a lane's registers hold block g + 1's
//    ids, values and u as its dots gathered them after step g's scatter;
//    step g + 1's scatter swaps against them. Only step g + 1's rows write
//    u in between; a swap that finds another value (a row sharing the id,
//    or a repeated id within the row) retries with the value it found.
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
//  * Grid form, dalpha is prefetched two blocks ahead. Block g + 2's rows
//    were last written in step g + 2 - nb: before step g when nb >= 3, in
//    step g's update (before the barrier ahead of the prefetch) when
//    nb = 2. At nb = 1 they are written in step g + 1, after the prefetch,
//    so there the update reads dalpha from device memory (lane 0 of warp
//    t % 8 owns row t in every step, so it reads its own write).
//  * Grid form, the prefetch into stage g % 2 starts after the barrier that
//    ends block g's scatter; its wait is the cp.async.wait_all ahead of the
//    barrier of the next step's prefetch point, before block g + 2's dots.


#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "sdca_common.cuh"

// the cluster form's stamped build (tools/sdca_step_ablation.py --only zxc):
// each role's phases as the cluster kernel stamps them, the walk's warp 0
// and the fetch warp
#define ZX_STAMP_NAMES                                          \
  "walk:wait,sum,update,scatter,barrier,ready,dots,send;"     \
  "fetch:wait_empty,ids,issue,arrive"
#include "sdca_zx_stamps.cuh"

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
constexpr int CLUSTER_THREADS = THREADS + 32;   // cluster form: walk, fetch
constexpr int RING_MAX = 4;          // cluster form: stages of B rows
constexpr int SLOTS = 4;             // cluster form: a lane's slots of a
                                     // row held from its dots to its scatter
constexpr size_t SMEM_LIMIT = 232448;   // a block's shared memory (opt-in)

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

// the cluster form's ring: words a stage gives one row's cols (and its
// vals), the row and up to 3 words before it from its 16-byte chunk on,
// rounded up to 16 bytes; words of a stage of B rows: cols (B rows) | vals
// (B rows) | y, alpha, mask, sqnorm, dalpha and the row ids (B each),
// rounded up to 16 bytes
__host__ __device__ __forceinline__ int ring_row_words(int r_loc) {
  return (r_loc + 3 + 3) & ~3;
}
__host__ __device__ __forceinline__ int ring_stage_words(int B, int r_loc) {
  return (2 * B * ring_row_words(r_loc) + (SCALARS + 1) * B + 3) & ~3;
}

// dynamic shared memory of one block of the cluster form with a ring of
// `ring` stages, in bytes: the stages | full and empty mbarriers a stage
// and the exchange's two | xb (2 B M: a buffer's rows, each row's M
// partials in rank order) | [u (d_loc)]
__host__ __device__ __forceinline__ size_t cluster_smem_bytes(
    int B, int r_loc, int d_loc, bool u_smem, int M, int ring) {
  return 4 * static_cast<size_t>(ring) * ring_stage_words(B, r_loc) +
         8 * static_cast<size_t>(2 * ring + 2) +
         8 * static_cast<size_t>(B) * M +
         (u_smem ? 4 * static_cast<size_t>(d_loc) : 0);
}

// the cluster form's ring: the deepest of RING_MAX .. 2 stages that fits
// beside the rest (2 where none does: the wrapper refuses that layout)
__host__ __device__ __forceinline__ int cluster_ring(int B, int r_loc,
                                                     int d_loc, bool u_smem,
                                                     int M) {
  int ring = RING_MAX;
  while (ring > 2 &&
         cluster_smem_bytes(B, r_loc, d_loc, u_smem, M, ring) > SMEM_LIMIT)
    --ring;
  return ring;
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

// The grid form: ceil(K / W) groups of M persistent blocks, block (k', m)
// walking shard m of W workers in lockstep
template <bool U_SMEM, int W>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sparse_sdca_zx_grid_kernel(const int* __restrict__ cols,
                           const float* __restrict__ vals,
                           const float* __restrict__ y,
                           const float* __restrict__ alpha,
                           const float* __restrict__ mask,
                           const float* __restrict__ sq,
                           const int* __restrict__ perm,
                           float* __restrict__ u,
                           float* __restrict__ dalpha,
                           unsigned long long* zx, int K, int M, int nk,
                           int r_loc, int d_loc, int B, int n_passes,
                           float scale, int loss_id, float g, int has_prox,
                           float kappa) {
  // zx: the (2, K, B, M) tagged words, zx[0] the prologue dots (written by
  // other blocks during the launch: no __restrict__)
  extern __shared__ __align__(16) float smem[];
  const int m = static_cast<int>(blockIdx.x) % M;   // the block's shard
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
              store_word(zrow(step + 1, j, t) + m, tagged(z[j], step + 1));
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();
  if constexpr (U_SMEM) {
    for (int j = 0; j < nw; ++j) {
      const float* us = smem + j * slab;
      float* uk = u_of(j);
      for (int i = tid; i < d_loc; i += THREADS) uk[i] = us[i];
    }
  }
}

// ---------------------------------------------------------------------------
// The cluster form: one cluster of M blocks a worker, partial dots pushed
// into every peer's shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address `a` of this block's shared memory in the block of cluster
// rank `rank` (the same layout in every block of the launch)
__device__ __forceinline__ unsigned peer_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// arrive on `bar`, and expect `bytes` of remote stores or bulk copies in
// its phase
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state)
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// whether `bar`'s phase of parity `parity` has completed; acquire at
// cluster scope, so the peers' stores (and the copies) that completed it
// are visible
__device__ __forceinline__ bool mbar_try(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for that completion; a wait past ~2^34 cycles (a lost store or
// copy) traps, so a fault of the protocol shows as a launch error and not
// as a hung card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  for (unsigned n = 1; !mbar_try(bar, parity); ++n)
    if ((n & 255) == 0 && clock64() - t0 > (1LL << 34)) __trap();
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_addr(bar))
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// to shared memory by the bulk-copy unit, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// this thread's cp.asyncs so far arrive on `bar` when they have landed
__device__ __forceinline__ void mbar_arrive_cp_async(
    unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the walk warps' barrier (the fetch warp runs on)
__device__ __forceinline__ void walk_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// one partial dot into a peer's buffer (`dst`, a shared::cluster address),
// completing 4 bytes of the transaction on that peer's barrier `bar`
__device__ __forceinline__ void send_partial(unsigned dst, float z,
                                             unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "r"(__float_as_uint(z)), "r"(bar)
      : "memory");
}

// the stamped phases of the walk and the fetch warp (ZX_STAMP_NAMES)
[[maybe_unused]] constexpr int WALK_PHASES = 8;
[[maybe_unused]] constexpr int FETCH_PHASES = 4;

template <bool U_SMEM>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
sparse_sdca_zx_cluster_kernel(const int* __restrict__ cols,
                              const float* __restrict__ vals,
                              const float* __restrict__ y,
                              const float* __restrict__ alpha,
                              const float* __restrict__ mask,
                              const float* __restrict__ sq,
                              const int* __restrict__ perm,
                              float* __restrict__ u,
                              float* __restrict__ dalpha,
                              const float* __restrict__ z0, int M, int nk,
                              int r_loc, int d_loc, int B, int n_passes,
                              float scale, int loss_id, float g,
                              int has_prox, float kappa, int ring,
                              int vec16) {
  // z0: the (K, M, B) prologue dots
  extern __shared__ __align__(16) float smem[];
  // ring stages | full[ring], empty[ring], xbar[2] | xb (2 B M) | [u]
  const int rw = ring_row_words(r_loc);
  const int sw = ring_stage_words(B, r_loc);
  float* stages = smem;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + ring * sw);
  unsigned long long* empty = full + ring;
  unsigned long long* xbar = empty + ring;
  float* xb = reinterpret_cast<float*>(xbar + 2);
  float* us = xb + 2 * B * M;
  const int m = static_cast<int>(blockIdx.x) % M;   // the cluster's rank
  const int k = static_cast<int>(blockIdx.x) / M;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = (nk + B - 1) / B;
  const int total = n_passes * nb;
  const size_t km = static_cast<size_t>(k) * M + m;
  const size_t r0 = static_cast<size_t>(k) * nk;
  float* uk = u + km * d_loc;
  float* uu = U_SMEM ? us : uk;                 // u as gathered/scattered
  float* da = dalpha + km * nk;
  // the stage of the seq-th block: cols (B rw) | vals (B rw) | y, alpha,
  // mask, sqnorm, dalpha (B each) | ids (B)
  auto stage = [&](int seq) { return stages + (seq % ring) * sw; };
  auto ids_of = [&](const float* st) {
    return reinterpret_cast<const int*>(st + 2 * B * rw + SCALARS * B);
  };
  auto rows_of = [&](int seq) { return min(B, nk - (seq % nb) * B); };
  // where row i's slots start in its stage region (bulk copies start at
  // the row's 16-byte chunk)
  auto shift = [&](int i) {
    return vec16 ? static_cast<int>(((km * nk + i) * r_loc) & 3) : 0;
  };
  // dalpha rides in the stage where the ring is shorter than a pass: the
  // copy of block seq is issued after block seq - ring's scatter, and its
  // rows were last updated in step seq - nb. Otherwise the row's owning
  // lane (the same every pass) reads its own write from device memory.
  const bool da_in_stage = nb >= ring;
  cg::cluster_group cluster = cg::this_cluster();

  // prologue: the barriers, u, step 0's M partials of every row (the
  // wrapper's dots at u = w); buffer 1 expects step 1's partials, buffer 0
  // step 2's
  if (tid == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(full + s, 32 + 1);     // 32 cp.async lanes, lane 0's bytes
      mbar_init(empty + s, 1);         // the walk's thread 0
    }
    mbar_init(xbar, 1);
    mbar_init(xbar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (U_SMEM) {
    for (int i = tid; i < d_loc; i += CLUSTER_THREADS) us[i] = uk[i];
  }
  for (int i = tid; i < B * M; i += CLUSTER_THREADS)
    xb[i] = z0[(static_cast<size_t>(k) * M + i % M) * B + i / M];
  __syncthreads();
  if (tid == 0) {
    if (total > 1) mbar_expect(xbar + 1, 4u * M * rows_of(1));
    if (total > 2) mbar_expect(xbar, 4u * M * rows_of(2));
  }
  cluster.sync();                   // every peer's barriers are armed

  if (warp == NWARPS) {
    // ---- the fetch warp: block seq into stage seq % ring, once the walk
    // has released block seq - ring; row t's scalars and bulk copies from
    // lane t % 32
    ZX_STAMP_BEGIN(FETCH_PHASES);
    for (int seq = 0; seq < total; ++seq) {
      ZX_STAMP(3);
      const int s = seq % ring;
      float* st = stages + s * sw;
      float* sc = st + 2 * B * rw;
      int* sid = reinterpret_cast<int*>(sc + SCALARS * B);
      if (seq >= ring) mbar_wait(empty + s, ((seq / ring) - 1) & 1);
      ZX_STAMP(0);
      const int n = rows_of(seq);
      const int lo = (seq % nb) * B;
      unsigned bytes = 0;
      for (int t = lane; t < n; t += 32) {
        const int i = perm[r0 + lo + t];
        sid[t] = i;
        ZX_STAMP(1);
        cp_async4(sc + t, y + r0 + i);
        cp_async4(sc + B + t, alpha + r0 + i);
        cp_async4(sc + 2 * B + t, mask + r0 + i);
        cp_async4(sc + 3 * B + t, sq + r0 + i);
        if (da_in_stage) cp_async4(sc + 4 * B + t, da + i);
        if (vec16) {
          const size_t e0 = (km * nk + i) * r_loc;
          const size_t a0 = e0 & ~static_cast<size_t>(3);
          const unsigned b =
              16u * static_cast<unsigned>((e0 + r_loc - a0 + 3) >> 2);
          bulk_copy(st + t * rw, cols + a0, b, full + s);
          bulk_copy(st + B * rw + t * rw, vals + a0, b, full + s);
          bytes += 2 * b;
        }
      }
      if (!vec16) {
        // 4-byte copies where the arrays allow no 16-byte chunks
        __syncwarp();
        for (int t = 0; t < n; ++t) {
          const size_t e0 = (km * nk + sid[t]) * r_loc;
          for (int q = lane; q < r_loc; q += 32) {
            cp_async4(st + t * rw + q, cols + e0 + q);
            cp_async4(st + B * rw + t * rw + q, vals + e0 + q);
          }
        }
      }
      ZX_STAMP(2);
      mbar_arrive_cp_async(full + s);
      bytes = __reduce_add_sync(0xffffffffu, bytes);
      __syncwarp();                   // the lanes' ids before the arrival
      if (lane == 0) mbar_expect(full + s, bytes);
    }
    ZX_STAMP_FLUSH(WALK_PHASES, FETCH_PHASES, 1, total);
  } else {
    // ---- the walk: NWARPS warps, warp w owning rows w + i NWARPS
    // lane j < M sends to shard j: its buffers and barriers
    const unsigned xb_to = peer_addr(smem_addr(xb), lane < M ? lane : 0);
    const unsigned bar_to = peer_addr(smem_addr(xbar), lane < M ? lane : 0);
    // the warp's rows warp and warp + NWARPS of the block whose dots it
    // took last: lane l's slots l + 32 j, j < SLOTS (ids, values, u as
    // gathered), kept for their scatter in the next step
    int ca[SLOTS], cb[SLOTS];
    float va[SLOTS], vb[SLOTS], ua[SLOTS], ub[SLOTS];
    // they hold a whole block where a warp takes at most one pair of rows
    const bool held = U_SMEM && B <= 2 * NWARPS;
    mbar_wait(full, 0);               // block 0
    ZX_STAMP_BEGIN(WALK_PHASES);
    ZX_STAMP_CLOCK(0);
    for (int step = 0; step < total; ++step) {
      ZX_STAMP(7);
      const int n = rows_of(step);
      // lane i of the warp sums and updates its row i, then the warp
      // scatters its rows one after another
      const int rows = warp < n ? (n - warp + NWARPS - 1) / NWARPS : 0;
      const float* xs = xb + (step & 1) * B * M;
      const float* st = stage(step);
      if (step > 0 && lane < rows)
        mbar_wait(xbar + (step & 1), ((step - 1) >> 1) & 1);
      ZX_STAMP(0);
      float coef = 0.0f;
      if (lane < rows) {
        const int t = warp + lane * NWARPS;
        float z = 0.0f;
        for (int mm = 0; mm < M; ++mm) z += xs[t * M + mm];   // rank order
        ZX_STAMP(1);
        const float* sc = st + 2 * B * rw;
        const int i = ids_of(st)[t];
        const float dai = da_in_stage ? sc[4 * B + t] : da[i];
        const float delta = sdca::cd_update(loss_id, g, sc[B + t] + dai, z,
                                            scale * sc[3 * B + t], sc[t]) *
                            sc[2 * B + t];
        da[i] = dai + delta;
        coef = scale * delta;
        ZX_STAMP(2);
      }
      // u[c_s] += coef v_s over the slots with v_s != 0, rounded as
      // atomicAdd rounds it (the product, then the add): the held slots by
      // compare-and-swaps issued together, each expecting the value the
      // dots gathered (only this step's rows change u before it), the ones
      // that lost to a repeated id going round again; the rest by atomicAdd
      int first = 0;                  // the lane's first slot left over
      if (held && step > 0) {
        first = 32 * SLOTS;
        const float c0 = __shfl_sync(0xffffffffu, coef, 0);
        const float c1 = __shfl_sync(0xffffffffu, coef, 1);
        float adda[SLOTS], addb[SLOTS];
        bool pa[SLOTS], pb[SLOTS];
#pragma unroll
        for (int j = 0; j < SLOTS; ++j) {
          const bool in = lane + 32 * j < r_loc;
          adda[j] = __fmul_rn(c0, va[j]);
          addb[j] = __fmul_rn(c1, vb[j]);
          pa[j] = in && c0 != 0.0f && va[j] != 0.0f;
          pb[j] = in && c1 != 0.0f && vb[j] != 0.0f;
        }
        bool any = true;
        while (any) {
          any = false;
#pragma unroll
          for (int j = 0; j < SLOTS; ++j) {
            if (pa[j]) {
              const unsigned seen = __float_as_uint(ua[j]);
              const unsigned got = atomicCAS(
                  reinterpret_cast<unsigned*>(uu + ca[j]), seen,
                  __float_as_uint(__fadd_rn(ua[j], adda[j])));
              pa[j] = got != seen;
              ua[j] = __uint_as_float(got);
              any |= pa[j];
            }
            if (pb[j]) {
              const unsigned seen = __float_as_uint(ub[j]);
              const unsigned got = atomicCAS(
                  reinterpret_cast<unsigned*>(uu + cb[j]), seen,
                  __float_as_uint(__fadd_rn(ub[j], addb[j])));
              pb[j] = got != seen;
              ub[j] = __uint_as_float(got);
              any |= pb[j];
            }
          }
        }
      }
      for (int r = 0; r < rows && first < r_loc; ++r) {
        const float c = __shfl_sync(0xffffffffu, coef, r);
        if (c == 0.0f) continue;
        const int t = warp + r * NWARPS;
        const int sh = shift(ids_of(st)[t]);
        const int* ci = reinterpret_cast<const int*>(st) + t * rw + sh;
        const float* vi = st + B * rw + t * rw + sh;
        for (int s = lane + first; s < r_loc; s += 32) {
          const float v = vi[s];
          if (v != 0.0f) atomicAdd(uu + ci[s], c * v);
        }
      }
      ZX_STAMP(3);
      walk_sync();                    // u has every row's scatter
      if (tid == 0) mbar_arrive(empty + step % ring);   // block step's stage
      ZX_STAMP(4);

      // block step + 1's partial dots at the updated u, two rows a warp at
      // once; lane j sends them to slot m of shard j's buffer
      if (step + 1 < total) {
        mbar_wait(full + (step + 1) % ring, ((step + 1) / ring) & 1);
        ZX_STAMP(5);
        const int n2 = rows_of(step + 1);
        const float* s2 = stage(step + 1);
        const unsigned to = xb_to + 4u * (((step + 1) & 1) * B * M + m);
        const unsigned bar = bar_to + 8u * ((step + 1) & 1);
        for (int t0 = warp; t0 < n2; t0 += 2 * NWARPS) {
          const int t1 = t0 + NWARPS;
          const bool two = t1 < n2;
          const int sa = t0 * rw + shift(ids_of(s2)[t0]);
          const int sb = two ? t1 * rw + shift(ids_of(s2)[t1]) : 0;
          const int* c2 = reinterpret_cast<const int*>(s2);
          const float* v2 = s2 + B * rw;
          // the held slots' ids and values, then their u, all in flight
#pragma unroll
          for (int j = 0; j < SLOTS; ++j) {
            const int s = lane + 32 * j;
            const bool in = s < r_loc;
            ca[j] = in ? c2[sa + s] : 0;
            va[j] = in ? v2[sa + s] : 0.0f;
            cb[j] = in && two ? c2[sb + s] : 0;
            vb[j] = in && two ? v2[sb + s] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < SLOTS; ++j) {
            ua[j] = load_u<U_SMEM>(uu + ca[j]);
            ub[j] = load_u<U_SMEM>(uu + cb[j]);
          }
          // the partial dots in the lane's slot order, as one loop over
          // s = lane, lane + 32, ... would add them
          float za = 0.0f, zb = 0.0f;
#pragma unroll
          for (int j = 0; j < SLOTS; ++j) {
            if (lane + 32 * j < r_loc) {
              za += (has_prox ? sdca::soft_threshold(ua[j], kappa) : ua[j]) *
                    va[j];
              if (two)
                zb += (has_prox ? sdca::soft_threshold(ub[j], kappa)
                                : ub[j]) *
                      vb[j];
            }
          }
          for (int s = lane + 32 * SLOTS; s < r_loc; s += 32) {
            float xa = load_u<U_SMEM>(uu + c2[sa + s]);
            if (has_prox) xa = sdca::soft_threshold(xa, kappa);
            za += xa * v2[sa + s];
            if (two) {
              float xb = load_u<U_SMEM>(uu + c2[sb + s]);
              if (has_prox) xb = sdca::soft_threshold(xb, kappa);
              zb += xb * v2[sb + s];
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            za += __shfl_xor_sync(0xffffffffu, za, o);
            zb += __shfl_xor_sync(0xffffffffu, zb, o);
          }
          ZX_STAMP(6);
          if (lane < M) {
            send_partial(to + 4u * t0 * M, za, bar);
            if (two) send_partial(to + 4u * t1 * M, zb, bar);
          }
        }
      }
      // this step's buffer expects step + 2's partials, armed in the
      // exchange's shadow (thread 0 waited for its phase above)
      if (tid == 0 && step > 0 && step + 2 < total)
        mbar_expect(xbar + (step & 1), 4u * M * rows_of(step + 2));
    }
    ZX_STAMP_CLOCK(1);
    if (warp == 0) ZX_STAMP_FLUSH(0, WALK_PHASES, 0, total);
  }
  cp_async_wait_all();
  cluster.sync();                   // no peer sends to this block any more
  if constexpr (U_SMEM) {
    for (int i = tid; i < d_loc; i += CLUSTER_THREADS) uk[i] = us[i];
  }
}

template <bool U_SMEM>
cudaError_t configure_cluster(int M, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      sparse_sdca_zx_cluster_kernel<U_SMEM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && M > PORTABLE_CLUSTER)
    err = cudaFuncSetAttribute(sparse_sdca_zx_cluster_kernel<U_SMEM>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

template <bool U_SMEM, int W>
cudaError_t configure_grid(size_t smem) {
  return cudaFuncSetAttribute(sparse_sdca_zx_grid_kernel<U_SMEM, W>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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
  cfg.blockDim = dim3(CLUSTER_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster form's launch: K clusters of M blocks
template <bool U_SMEM>
cudaError_t launch_cluster(const int* cols, const float* vals,
                           const float* y, const float* alpha,
                           const float* mask, const float* sq,
                           const int* perm, float* u, float* dalpha,
                           const float* z0, int K, int M, int nk, int r_loc,
                           int d_loc, int B, int n_passes, float scale,
                           int loss_id, float g, int has_prox, float kappa,
                           cudaStream_t stream) {
  const int ring = cluster_ring(B, r_loc, d_loc, U_SMEM, M);
  const size_t smem = cluster_smem_bytes(B, r_loc, d_loc, U_SMEM, M, ring);
  cudaError_t err = configure_cluster<U_SMEM>(M, smem);
  if (err != cudaSuccess) return err;
  // bulk copies of a row's 16-byte chunks need 16-byte aligned bases and
  // arrays that end on a chunk (no copy reads past them)
  const int vec16 = reinterpret_cast<size_t>(cols) % 16 == 0 &&
                    reinterpret_cast<size_t>(vals) % 16 == 0 &&
                    static_cast<long long>(K) * M * nk * r_loc % 4 == 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(K, M, smem, stream, &attr);
  return cudaLaunchKernelEx(&cfg, sparse_sdca_zx_cluster_kernel<U_SMEM>,
                            cols, vals, y, alpha, mask, sq, perm, u, dalpha,
                            z0, M, nk, r_loc, d_loc, B, n_passes, scale,
                            loss_id, g, has_prox, kappa, ring, vec16);
}

// How many clusters of M blocks of the cluster instance the card holds at
// once (cudaOccupancyMaxActiveClusters)
template <bool U_SMEM>
cudaError_t cluster_resident(int M, size_t smem, int* out) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, M, smem, nullptr, &attr);
  cudaError_t err = configure_cluster<U_SMEM>(M, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        out,
        reinterpret_cast<const void*>(sparse_sdca_zx_cluster_kernel<U_SMEM>),
        &cfg);
  return err;
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
  cudaError_t err = configure_grid<U_SMEM, W>(smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&cols,   &vals,  &y,     &alpha,    &mask,     &sq,
                  &perm,   &u,     &dalpha, &z,       &K,        &M,
                  &nk,     &r_loc, &d_loc, &B,        &n_passes, &scale,
                  &loss_id, &g,    &has_prox, &kappa};
  const int groups = (K + W - 1) / W;
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sparse_sdca_zx_grid_kernel<U_SMEM, W>),
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
  if (err == cudaSuccess) err = configure_grid<U_SMEM, W>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sparse_sdca_zx_grid_kernel<U_SMEM, W>, THREADS, smem);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      u_in_smem
          ? launch_cluster<true>(cols, vals, y, alpha, mask, sq, perm, u,
                                 dalpha, z0, K, M, nk, r_loc, d_loc, B,
                                 n_passes, scale, loss_id, g, has_prox,
                                 kappa, s)
          : launch_cluster<false>(cols, vals, y, alpha, mask, sq, perm, u,
                                  dalpha, z0, K, M, nk, r_loc, d_loc, B,
                                  n_passes, scale, loss_id, g, has_prox,
                                  kappa, s);
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

// Dynamic shared memory of one block of the cluster form at M shards, in
// bytes, at the ring it runs (the wrapper's smem_budget(cluster=M) must
// agree).
long long sparse_sdca_zx_smem_bytes(int B, int r_loc, int d_loc,
                                    int u_in_smem, int M) {
  const bool u_smem = u_in_smem != 0;
  return static_cast<long long>(cluster_smem_bytes(
      B, r_loc, d_loc, u_smem, M, cluster_ring(B, r_loc, d_loc, u_smem, M)));
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
  const bool u_smem = u_in_smem != 0;
  const size_t smem = cluster_smem_bytes(
      B, r_loc, d_loc, u_smem, M, cluster_ring(B, r_loc, d_loc, u_smem, M));
  return static_cast<int>(u_in_smem ? cluster_resident<true>(M, smem, out)
                                    : cluster_resident<false>(M, smem, out));
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

