// LocalSDCA over padded-ELL rows, with the fused soft-threshold prox and a
// prefetch ring, for Hopper (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/sparse_sdca.py, both
// vmapped over the K workers (entry sparse_local_sdca, pallas_call at :360):
//  * _sparse_sdca_kernel (with _block_walk and _prox; buffer_depth = 1);
//  * _sparse_sdca_pipelined_kernel (buffer_depth >= 2).
// buffer_depth is the TPU's VMEM double-buffering knob. Here every depth
// walks the same rows with the same lane map and gives the same bits, so
// on the card the wrapper runs the ring at least D_card deep (its
// `ring_plan`); the launch takes DEPTH = 1..8.
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
// What bounds it on this card: a chain of nk * n_passes dependent steps
// per worker, each a gather, a reduction, a scalar update and a scatter.
// The bytes are tiny by comparison (nnz * 8 for rcv1's 677k x 47k at
// density 0.0016 is 0.13 ms at 3.35 TB/s), so step latency decides. Part
// of each step is loads from device memory whose addresses hang on perm:
// the row's cols/vals (rcv1's 640 MB of ELL data is far past the 50 MB L2)
// and its y, alpha, mask and dalpha. The rest is the step's own chain.
//
// Two kernels. u (d floats) sits in dynamic shared memory beside the ring
// where it fits (sparse_sdca_smem_kernel, below); past that (d above
// 57,852 at depth 1, r_max 118) u stays in device memory
// (sparse_sdca_device_u_kernel, further below).
//
// ---- u in shared memory: three warps a worker, the walk's chain alone
//
// Why (tools/sdca_step_ablation.py --only sparse, its stamped build, rcv1's
// shape, K = 8, depth 4, H100 at 700 W): the earlier design (a walk warp
// and a fetch warp) took 0.650 us a step. Its walk waited on `full`
// 0.09 us and spent the rest on its own chain: the row id, the stage at an
// offset hung on it, the gather, a butterfly of z and sum v^2, the update
// and a device-memory store of dalpha, a compare-and-swap scatter (0.23
// us, the largest part), the arrival. Its fetch warp waited on `empty`
// 0.22 us a row and was busy 0.49 (a copy stalls the warp that issues
// it). So the walk's chain set the pace, with the fetch close behind. The
// walk now keeps only what depends on u, and the rest of a row's work is
// spread over two more warps, each a row ahead:
//  * the walk warp (warp 0): lane l gathers slots s = l, l + 32, l + 64,
//    l + 96 of the row from registers (u[c_s], through the soft-threshold
//    when has_prox; wider rows walk slots from 128 on from the stage),
//    reduces z alone by a butterfly (the same tree as before, so the same
//    bits), runs cd_update on every lane, writes the new dalpha into the
//    stage (lane 0), scatters, __syncwarp, and lane 0 arrives on `empty`.
//    The next row's ids, values and scalars are loaded into registers
//    after this row's gather is issued, in the shadow of its sums: they do
//    not depend on u (at DEPTH 1 there is no other stage; the row is loaded
//    after the release). The walk holds two stages, so a ring of DEPTH
//    has DEPTH - 2 rows in flight.
//  * the scatter of a row marked `plain` (below) stores u[c_s] = u_s +
//    coef v_s (the product, then the add: how atomicAdd rounds) from the
//    gathered value; there is nothing to race with, since no other slot
//    of the row has the column and only the walk warp writes u. Other rows
//    keep the lane's compare-and-swaps issued together (a shared-memory
//    float atomicAdd is a compare-and-swap loop on this card), so repeated
//    ids in a row all land. On rcv1's rows (all plain) the stores save
//    8.8 ms at depth 4 and 11.6 at depth 8 (the `cas_scatter` variant).
//  * the prep warp (warp 2) waits for each row to land, in visit order,
//    and computes what hangs on the row alone: q = scale * sum v^2 with the
//    walk's lane-to-slot map and the same butterfly (the same bits as the
//    walk's former sum), abar = alpha + dalpha, the row's 16-byte shift,
//    and the mark: `plain` when its nonzero slots come first in strictly
//    increasing column order (padding skipped: every row a CSR builds),
//    which makes them distinct. Then lane 0 arrives on the stage's
//    `ready`, which the walk waits on. The mark is computed branch-free
//    from loads issued together: written with short-circuit tests it cost
//    the prep 0.65 us a row and the kernel 31.6 ms (73.6 against 42.0).
//  * the fetch warp (warp 1) fills the ring in visit order: the row's cols
//    and vals by one bulk copy each (cp.async.bulk, the 16-byte chunks that
//    hold the row, completing on the stage's `full` with their bytes
//    expected) where the arrays allow 16-byte chunks, else by 4-byte
//    cp.asyncs; y, alpha, mask and dalpha by four lanes of one cp.async.
//    Before it refills a stage it stores the stage's dalpha, which the
//    walk left there, to device memory: the walk's release then publishes
//    shared memory only.
// At depth 4 the step took 0.518 us: the walk waited 0.085 us on `ready`,
// the fetch warp was busy 0.36 us a row and the prep warp 0.41; no part
// of the walk taken out saved more than 3.1 ms of 43.9, the prep's slot
// loop 6.8. The ring's depth then decides: rings 3-8 took 62.8, 43.8,
// 43.9, 40.7, 43.9 and 40.2 ms (tools/walk_times.py's ring sweep), so the
// wrapper runs the ring at least D_CARD = 8 deep (its `ring_plan`). Bulk
// copies against 16-byte cp.asyncs of the rows, the arrival relaxed
// against a release, and the mbarrier polls slowed (__nanosleep, or a
// suspend-time hint) each moved nothing or cost time.
//
// A stage: cols | vals, each in a region that starts at the row's 16-byte
// chunk (a row of r_max = 118 is neither 16-byte sized nor aligned, so the
// copy takes up to 3 words more on each side and the row starts `shift`
// words in) | y, abar (alpha as copied), mask, q, dalpha, flags, and the
// stage's `ready` mbarrier (STAGE_SCALARS words, 16-byte aligned). Each
// stage also has `full` (the fetch warp's 32 cp.async arrivals and lane
// 0's arrival with the bulk bytes expected) and `empty` (the walk's lane
// 0). Every depth walks the same rows with the same lane-to-slot map and
// the same shuffle trees, so on rows without repeated column ids every
// depth gives the same bits, and the bits of the parent design; with
// repeats the compare-and-swaps may land in another order.
//
// Hazards:
//  * dalpha is prefetched. Its row appears once per pass, so no step
//    between the prefetch and the walk writes it. Across the pass boundary
//    the fetch of position p needs the write-back of position p - nk (the
//    same row), which the fetch warp makes when it refills that position's
//    stage, at position p - nk + DEPTH: DEPTH <= nk keeps it at or before
//    p. The same lane (3) stores the write-back and issues the dalpha copy,
//    with a fence between, so at DEPTH = nk the copy reads the store. The
//    launcher refuses DEPTH > nk; the wrapper clamps DEPTH to nk. The last
//    DEPTH rows go back after the fetch warp's loop, each after its
//    `empty`.
//  * A stage is refilled only after the walk released it (`empty`): the
//    walk's lane 0 arrives after the __syncwarp that ends the step, every
//    lane's reads of the stage and the dalpha store into it done. The prep
//    warp is done with a stage before its `ready`, which precedes the
//    walk's use.
//  * The prep warp reads a stage only after `full` completed: the fetch
//    lanes' cp.asyncs landed and the bulk copies' bytes arrived. Its lane
//    0's release on `ready`, after its own acquire of `full`, carries both
//    to the walk's acquire. `full`'s init is fenced
//    (fence.mbarrier_init) before the bulk copies may complete on it.
//  * No copy writes what another role writes: bulk copies write the cols
//    and vals regions, cp.asyncs the y / abar / mask / dalpha words, the
//    prep warp abar, q and flags after they landed, the walk dalpha after
//    `ready`, and the fetch warp reads it back after `empty`.
//  * Only the walk warp touches u between the setup and the final
//    __syncthreads, and its __syncwarp orders a step's scatter before the
//    next step's gather.
//  * The ring plus u must fit the 232,448-byte limit (the wrapper's
//    smem_budget and ring_plan): at d = 47,236 and r_max = 118, u is
//    188,944 B and a depth-8 ring 8,320 B with its barriers.
//
// ---- u in device memory
//
// The same ring on two warps, a walk warp and a fetch warp (three where
// rows pass 128 slots: two walk warps, below). du[k, :] holds worker k's u
// (initialised from w here) and becomes u - w in place at the end. The
// gather reads u with __ldcg, past L1, so it sees the block's own earlier
// atomics (they land in L2), and the scatter is a plain global atomicAdd
// (a native reduction in L2, no compare-and-swap loop). u then takes K 4 d
// bytes of device memory: 21.7 MB at news20's width (1,355,191) and K = 4,
// inside the card's 50 MB L2. There a gather is a round trip to L2 or
// beyond, and a step's gathers decide it: with SLOTS = 4 registers a lane
// and the rest walked from the stage one load after another, news20's
// rows (r_max 549, 18 slots a lane) took 5.65 us a step, 14 round trips in
// series. So a lane issues the __ldcg of all its slots before it uses any
// (one round trip a row), and the device-memory instance is built at SLOTS
// 4 on one walk warp (rows up to 128 slots) and at SLOTS 8 and 16 on two
// walk warps (the wrapper's device_u_walk takes the first that holds the
// row). Predicated-off registers are not free: at r_max 374 and 496 two
// warps of 8 took 10.3 and 10.7 ms a call against two of 16's 11.8 and
// 12.2, and at r_max 170 and 250 two warps of 8 took 9.9 and 10.1 against
// one warp of 8's 12.0 and 12.0 (news20's width, K = 4, depth 4;
// tools/walk_times.py --parts slots, H100 at 700 W), so one warp of 8 is
// not built. Rows past a lane's SLOTS walk the rest in batches of SLOTS,
// each batch's loads in flight together. Why two warps: on one warp with
// 24 slots a lane news20 took 3.3 us a step (16.2 ms a call), of which
// taking the gathers out saved 0.8, fetching every step's row from L2
// 0.6, the scatter 0.2, and the warp's __syncwarp and release nothing
// (tools/sdca_step_ablation.py, H100 at 700 W): the lane's chain of 18
// slots' loads, products and atomics was most of the step. Two warps, each
// a lane's 9 slots, took 2.43 us (12.2 ms). Their totals meet in shared
// memory behind a named barrier of the two warps (bar.sync 1), added in
// warp order by both, and a second one ends the step. A step: lane l
// gathers slots s = l, l + 32, ... (walk warp q: l + 32 q + 64 i) into its
// (z, sq) partials, sdca::warp_sum2 leaves both totals in every lane,
// every lane runs the same cd_update, thread 0 stores dalpha, each lane
// atomicAdds coef * v_s into u[c_s] over its slots with v_s != 0, and the
// step's barrier orders the scatter before the next gather. The fetch
// warp fills the stages in visit order with cp.async (cols and vals by
// 16-byte copies of the chunks that hold the row, the scalars and the row
// id by five lanes of one more instruction; 4-byte pieces where the arrays
// do not allow 16-byte chunks) and each lane arrives on `full` when its
// copies landed (cp.async.mbarrier.arrive.noinc); the walk's thread 0
// arrives on `empty` (a release: dalpha too) once the step is done. Every
// SLOTS adds a lane's slots into its partials in slot order, so the
// one-warp instances give the bits of a walk that loaded a lane's slots
// past the first 4 one at a time; two walk warps add their warp totals,
// another order of the same sum. Hazards: dalpha is prefetched (DEPTH <=
// nk, as above, the walk's store released on `empty` before the refill's
// copy); with u in device memory a gather after a scatter of the same
// column must see it: the atomics land in L2, every read of u is an
// ld.global.cg, and the step's __syncwarp or barrier orders the atomics
// before the next loads; two walk warps write their totals to part[]
// before the first barrier of a step and read both after it, the next
// step's writes after the second.

#include <cuda_runtime.h>

#include "sdca_common.cuh"

// The stamped build (tools/sdca_step_ablation.py --only sparse: its
// `stamped` variant sets this to 1). Every thread of the shared-memory
// walk's three warps reads clock64 at each phase boundary of every step
// and adds the cycles since the boundary before to that phase's 32-bit
// total, in registers, without a branch; lane 0 of each warp writes its
// totals and its step count to a device buffer at the end. A phase is so
// the time from one boundary's issue to the next one's: a load's latency
// shows where its value is first waited for. Nothing of it is compiled
// otherwise.
#ifndef SDCA_STEP_STAMPS
#define SDCA_STEP_STAMPS 0
#endif

namespace {

constexpr int WARP = 32;
constexpr int MAX_DEPTH = 8;
// words of a stage after its cols and vals, 16-byte aligned
constexpr int STAGE_SCALARS = 8;
// the scalar words: copied (y, alpha -> abar, mask, dalpha), computed by
// the prep warp (abar, q, flags), the walk's dalpha, and `ready` (2 words)
constexpr int SC_Y = 0, SC_ABAR = 1, SC_MASK = 2, SC_Q = 3, SC_DALPHA = 4,
              SC_FLAGS = 5, SC_READY = 6;
constexpr int FLAG_PLAIN = 4;         // flags: shift (0-3) | FLAG_PLAIN
constexpr unsigned FULL = 0xffffffffu;
// slots a lane keeps in registers through a step with u in shared memory
// (rows of r_max <= 128 whole; wider rows walk their further slots from
// the stage)
constexpr int SMEM_SLOTS = 4;

#if SDCA_STEP_STAMPS
constexpr int STAMP_BLOCKS = 16;      // blocks stamped
constexpr int STAMP_WORDS = 20;       // the roles' phases, then their steps
// each role's phases in word order, each named by the boundary that ends
// it; the last of a role ends at the top of its loop
constexpr const char* STAMP_NAMES =
    "walk:gather,wait_ready,next_row,reduce,update,dalpha,scatter,release;"
    "fetch:wait_empty,write_back,rows,scalars_arrive;"
    "prep:wait_full,slots,sums,publish";
constexpr int STAMP_WALK0 = 0, STAMP_FETCH0 = 8, STAMP_PREP0 = 12;
__device__ long long g_stamps[STAMP_BLOCKS][STAMP_WORDS];
// per block: clock64 and %globaltimer at the walk's start and end
__device__ long long g_stamp_clock[STAMP_BLOCKS][4];
__device__ __forceinline__ long long stamp_clock() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
__device__ __forceinline__ long long stamp_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}
#define STAMP_BEGIN(NPH)     \
  unsigned acc_[NPH] = {};   \
  unsigned last_ = static_cast<unsigned>(stamp_clock())
// the phase that ends here, phase I of this role's
#define STAMP(I)                                              \
  do {                                                        \
    const unsigned t_ = static_cast<unsigned>(stamp_clock()); \
    acc_[I] += t_ - last_;                                    \
    last_ = t_;                                               \
  } while (0)
// this role's NPH totals from word W0, its steps to word STAMP_WORDS - 3
// + R (role R)
#define STAMP_FLUSH(W0, NPH, R, STEPS)                          \
  do {                                                          \
    if ((threadIdx.x & 31) == 0 && blockIdx.x < STAMP_BLOCKS) { \
      for (int i_ = 0; i_ < (NPH); ++i_)                        \
        g_stamps[blockIdx.x][(W0) + i_] = acc_[i_];             \
      g_stamps[blockIdx.x][STAMP_WORDS - 3 + (R)] = (STEPS);    \
    }                                                           \
  } while (0)
#define STAMP_CLOCK(W)                                   \
  do {                                                   \
    if (threadIdx.x == 0 && blockIdx.x < STAMP_BLOCKS) { \
      g_stamp_clock[blockIdx.x][W] = stamp_clock();      \
      g_stamp_clock[blockIdx.x][(W) + 2] = stamp_ns();   \
    }                                                    \
  } while (0)
#else
#define STAMP_BEGIN(NPH) \
  do {                   \
  } while (0)
#define STAMP(I) \
  do {           \
  } while (0)
#define STAMP_FLUSH(W0, NPH, R, STEPS) \
  do {                                 \
  } while (0)
#define STAMP_CLOCK(W) \
  do {                 \
  } while (0)
#endif

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_addr(bar))
               : "memory");
}

// arrive on `bar`, and expect `bytes` more of bulk copies in its phase
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state)
               : "r"(smem_addr(bar)), "r"(bytes)
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

__device__ __forceinline__ bool mbar_try(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the completion of `bar`'s phase of parity `parity`; a wait
// past ~2^34 cycles (seconds: a lost arrival) traps, so a fault of the
// ring protocol shows as a launch error and not as a hung card. The clock
// is read once a wait starts to poll, and then every 256 polls, not on
// every poll of the hot path.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  for (unsigned n = 1; !mbar_try(bar, parity); ++n)
    if ((n & 255) == 0 && clock64() - t0 > (1LL << 34)) __trap();
}

// this thread's cp.asyncs so far arrive on `bar` when they have landed
__device__ __forceinline__ void mbar_arrive_cp_async(
    unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// words a stage gives one row's cols (and as many its vals): the row and
// up to 3 words before it, from its 16-byte chunk on, rounded to 16 bytes
__host__ __device__ __forceinline__ int row_words(int r_max) {
  return (r_max + 3 + 3) & ~3;
}

// words of one stage: cols | vals | STAGE_SCALARS
__host__ __device__ __forceinline__ int stage_words(int r_max) {
  return 2 * row_words(r_max) + STAGE_SCALARS;
}

// one value summed over a warp: warp_sum2's tree on one value, so the same
// bits as its second total
__device__ __forceinline__ float warp_sum1(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(FULL, a, off);
  return a;
}

// the walk warps' barrier (named barrier 1; the fetch warp is not in it)
template <int NWALK>
__device__ __forceinline__ void walk_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWALK * WARP) : "memory");
}

// ---------------------------------------------------------------------------
// u in shared memory: the walk warp, the fetch warp and the prep warp
// ---------------------------------------------------------------------------

// a row of the ring in the walk's registers: lane l's slots l + 32 i
struct WalkRow {
  int cs[SMEM_SLOTS];
  float vs[SMEM_SLOTS];
  float4 sc;                 // y, abar, mask, q
  float dai;                 // dalpha as prefetched
  int flags;                 // shift | FLAG_PLAIN
};

__device__ __forceinline__ void load_row(WalkRow& r, const float* st, int rw,
                                         int r_max, int lane) {
  const float* sc = st + 2 * rw;
  r.flags = __float_as_int(sc[SC_FLAGS]);
  r.sc = *reinterpret_cast<const float4*>(sc);
  r.dai = sc[SC_DALPHA];
  const int sh = r.flags & 3;
  const int* ci = reinterpret_cast<const int*>(st) + sh;
  const float* vi = st + rw + sh;
#pragma unroll
  for (int i = 0; i < SMEM_SLOTS; ++i) {
    const int s = lane + WARP * i;
    r.cs[i] = s < r_max ? ci[s] : 0;
    r.vs[i] = s < r_max ? vi[s] : 0.0f;
  }
}

template <int DEPTH>
__global__ void __launch_bounds__(3 * WARP)
sparse_sdca_smem_kernel(const int* __restrict__ cols,
                        const float* __restrict__ vals,
                        const float* __restrict__ y,
                        const float* __restrict__ alpha,
                        const float* __restrict__ mask,
                        const float* __restrict__ w,
                        const int* __restrict__ perm,
                        float* __restrict__ dalpha, float* __restrict__ du,
                        int nk, int r_max, int d, int n_passes, float scale,
                        int loss_id, float g, int has_prox, float kappa,
                        int vec16) {
  constexpr int NTHR = 3 * WARP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int sw = stage_words(r_max);
  const int rw = row_words(r_max);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + DEPTH * sw);
  unsigned long long* empty = full + DEPTH;
  float* u = reinterpret_cast<float*>(empty + DEPTH);
  auto ready = [&](int s) {
    return reinterpret_cast<unsigned long long*>(ring + s * sw + 2 * rw +
                                                 SC_READY);
  };
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / WARP;
  const size_t row0 = static_cast<size_t>(k) * nk;   // first row of worker k
  const int* perm_k = perm + row0;
  const long long total = static_cast<long long>(n_passes) * nk;
  auto perm_at = [&](long long pos) -> int {
    return pos < total ? perm_k[pos % nk] : 0;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(full + s, WARP + 1);   // 32 cp.async lanes, lane 0's bytes
      mbar_init(empty + s, 1);         // the walk's lane 0
      mbar_init(ready(s), 1);          // the prep warp's lane 0
    }
    // the inits visible to the bulk-copy unit before a copy completes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = threadIdx.x; c < d; c += NTHR) u[c] = w[c];
  __syncthreads();                     // u and the barriers published

  if (warp == 1) {
    // ---- the fetch warp: row after row into the ring, up to DEPTH ahead
    int prv = 0;                       // perm of the chunk before
    int cur = perm_at(lane);           // of the chunk being fetched
    int nxt = perm_at(WARP + lane);    // and of the chunk after it
    int slot = 0;
    unsigned phase = 0;                // parity of the stage's next reuse
    STAMP_BEGIN(4);
    for (long long p = 0; p < total; ++p) {
      float* st = ring + slot * sw;
      float* sc = st + 2 * rw;
      if (p >= DEPTH) {
        mbar_wait(empty + slot, phase ^ 1);
        STAMP(0);
        // the walk left its row's dalpha in the stage: back to device
        // memory before anything refills the stage (and before this lane
        // copies the same row's dalpha, at DEPTH = nk)
        const long long q = p - DEPTH;
        const int iq = __shfl_sync(FULL, (q >> 5) == (p >> 5) ? cur : prv,
                                   static_cast<int>(q & 31));
        if (lane == 3) {
          dalpha[row0 + iq] = sc[SC_DALPHA];
          __threadfence_block();
        }
      } else {
        STAMP(0);
      }
      STAMP(1);
      const int i = __shfl_sync(FULL, cur, static_cast<int>(p & 31));
      const size_t r = row0 + i;
      const size_t e0 = r * r_max;
      if (vec16) {
        const size_t a0 = e0 & ~static_cast<size_t>(3);
        const unsigned bytes =
            16u * static_cast<unsigned>((e0 + r_max - a0 + 3) >> 2);
        if (lane == 0) {
          mbar_arrive_expect_tx(full + slot, 2 * bytes);
          bulk_copy(st, cols + a0, bytes, full + slot);
          bulk_copy(st + rw, vals + a0, bytes, full + slot);
        }
      } else {
        if (lane == 0) mbar_arrive_expect_tx(full + slot, 0);
        for (int s = lane; s < r_max; s += WARP) {
          cp_async4(st + s, cols + e0 + s);
          cp_async4(st + rw + s, vals + e0 + s);
        }
      }
      STAMP(2);
      if (lane < 4) {                  // y, alpha, mask, dalpha
        const float* src = lane == 0 ? y + r : lane == 1 ? alpha + r
                         : lane == 2 ? mask + r : dalpha + r;
        cp_async4(sc + (lane == 0 ? SC_Y : lane == 1 ? SC_ABAR
                        : lane == 2 ? SC_MASK : SC_DALPHA), src);
      }
      mbar_arrive_cp_async(full + slot);
      if (((p + 1) & 31) == 0) {       // next chunk of perm
        prv = cur;
        cur = nxt;
        nxt = perm_at(p + 1 + WARP + lane);
      }
      if (++slot == DEPTH) {
        slot = 0;
        phase ^= 1;
      }
      STAMP(3);
    }
    // the last DEPTH rows' dalpha, each once the walk released it
    for (long long q = total > DEPTH ? total - DEPTH : 0; q < total; ++q) {
      const int s = static_cast<int>(q % DEPTH);
      mbar_wait(empty + s, static_cast<unsigned>((q / DEPTH) & 1));
      if (lane == 3)
        dalpha[row0 + perm_k[q % nk]] = ring[s * sw + 2 * rw + SC_DALPHA];
    }
    STAMP_FLUSH(STAMP_FETCH0, 4, 1, total);
  } else if (warp == 2) {
    // ---- the prep warp: each landed row's q, abar, shift and mark
    int cur = perm_at(lane), nxt = perm_at(WARP + lane);
    int slot = 0;
    unsigned phase = 0;
    STAMP_BEGIN(4);
    for (long long j = 0; j < total; ++j) {
      const int i = __shfl_sync(FULL, cur, static_cast<int>(j & 31));
      mbar_wait(full + slot, phase);
      STAMP(0);
      float* st = ring + slot * sw;
      float* sc = st + 2 * rw;
      const int sh = vec16 ? static_cast<int>((row0 + i) * r_max & 3) : 0;
      const int* ci = reinterpret_cast<const int*>(st) + sh;
      const float* vi = st + rw + sh;
      // the lane's slots in the walk's order (l, l + 32, ...); `plain`
      // while the slot after each is padding or a larger id after a
      // nonzero one. Branch-free: slot r_max, read past the row, is still
      // in the stage and stands for padding.
      float sq = 0.0f;
      bool plain = true;
#pragma unroll 4
      for (int s = lane; s < r_max; s += WARP) {
        const float v = vi[s];
        const int c = ci[s];
        const bool last = s + 1 == r_max;
        const float v1 = last ? 0.0f : vi[s + 1];
        const int c1 = ci[s + 1];
        sq = __fmaf_rn(v, v, sq);
        plain &= (v1 == 0.0f) | ((v != 0.0f) & (c < c1));
      }
      STAMP(1);
      sq = warp_sum1(sq);
      plain = __all_sync(FULL, plain);
      STAMP(2);
      if (lane == 0) {
        sc[SC_ABAR] = sc[SC_ABAR] + sc[SC_DALPHA];
        sc[SC_Q] = scale * sq;
        sc[SC_FLAGS] = __int_as_float(sh | (plain ? FLAG_PLAIN : 0));
        mbar_arrive(ready(slot));      // release: the landed row too
      }
      if (((j + 1) & 31) == 0) {
        cur = nxt;
        nxt = perm_at(j + 1 + WARP + lane);
      }
      if (++slot == DEPTH) {
        slot = 0;
        phase ^= 1;
      }
      STAMP(3);
    }
    STAMP_FLUSH(STAMP_PREP0, 4, 2, total);
  } else {
    // ---- the walk: one row a step, its next row loaded in its shadow
    int slot = 0;
    unsigned phase = 0;
    WalkRow row, nrow;
    STAMP_CLOCK(0);
    mbar_wait(ready(0), 0);
    load_row(row, ring, rw, r_max, lane);
    STAMP_BEGIN(8);
    for (long long j = 0; j < total; ++j) {
      STAMP(7);
      float* st = ring + slot * sw;
      const int sh = row.flags & 3;
      const int* ci = reinterpret_cast<const int*>(st) + sh;
      const float* vi = st + rw + sh;
      float z = 0.0f, us[SMEM_SLOTS];
#pragma unroll
      for (int i = 0; i < SMEM_SLOTS; ++i)
        us[i] = lane + WARP * i < r_max ? u[row.cs[i]] : 0.0f;
      // the next row, in the shadow of this one's sums
      const int nslot = slot + 1 == DEPTH ? 0 : slot + 1;
      const unsigned nphase = slot + 1 == DEPTH ? phase ^ 1 : phase;
      const bool ahead = DEPTH > 1 && j + 1 < total;
      if (ahead) mbar_wait(ready(nslot), nphase);
      STAMP(1);
      if (ahead) load_row(nrow, ring + nslot * sw, rw, r_max, lane);
      STAMP(2);
#pragma unroll
      for (int i = 0; i < SMEM_SLOTS; ++i) {
        if (lane + WARP * i < r_max) {
          const float uc =
              has_prox ? sdca::soft_threshold(us[i], kappa) : us[i];
          z = __fmaf_rn(uc, row.vs[i], z);
        }
      }
      for (int s = lane + WARP * SMEM_SLOTS; s < r_max; s += WARP) {
        float uc = u[ci[s]];
        if (has_prox) uc = sdca::soft_threshold(uc, kappa);
        z = __fmaf_rn(uc, vi[s], z);
      }
      STAMP(0);
      z = warp_sum1(z);
      STAMP(3);
      const float delta = sdca::cd_update(loss_id, g, row.sc.y, z,
                                          row.sc.w, row.sc.x) * row.sc.z;
      STAMP(4);
      if (lane == 0) st[2 * rw + SC_DALPHA] = row.dai + delta;
      STAMP(5);
      const float coef = scale * delta;
      // u[c_s] += coef * v_s over slots with v_s != 0 (padding skipped,
      // exactly), rounded as atomicAdd rounds it (the product, then the
      // add): by plain stores where the prep warp marked the row's ids
      // distinct, else by the lane's compare-and-swaps issued together,
      // each expecting the value the gather read, the ones that lost to a
      // repeated id going round again
      if (coef != 0.0f) {
        if (row.flags & FLAG_PLAIN) {
#pragma unroll
          for (int i = 0; i < SMEM_SLOTS; ++i)
            if (row.vs[i] != 0.0f)
              u[row.cs[i]] = __fadd_rn(us[i], __fmul_rn(coef, row.vs[i]));
          for (int s = lane + WARP * SMEM_SLOTS; s < r_max; s += WARP) {
            const float v = vi[s];
            if (v != 0.0f)
              u[ci[s]] = __fadd_rn(u[ci[s]], __fmul_rn(coef, v));
          }
        } else {
          float add[SMEM_SLOTS];
          bool pend[SMEM_SLOTS];
#pragma unroll
          for (int i = 0; i < SMEM_SLOTS; ++i) {
            add[i] = __fmul_rn(coef, row.vs[i]);
            pend[i] = row.vs[i] != 0.0f;
          }
          bool any = true;
          while (any) {
            any = false;
#pragma unroll
            for (int i = 0; i < SMEM_SLOTS; ++i) {
              if (pend[i]) {
                const unsigned seen = __float_as_uint(us[i]);
                const unsigned got = atomicCAS(
                    reinterpret_cast<unsigned*>(u + row.cs[i]), seen,
                    __float_as_uint(__fadd_rn(us[i], add[i])));
                pend[i] = got != seen;
                us[i] = __uint_as_float(got);
                any |= pend[i];
              }
            }
          }
          for (int s = lane + WARP * SMEM_SLOTS; s < r_max; s += WARP) {
            const float v = vi[s];
            if (v != 0.0f) atomicAdd(&u[ci[s]], __fmul_rn(coef, v));
          }
        }
      }
      STAMP(6);
      __syncwarp();                    // scatter before the next gather
      if (lane == 0) mbar_arrive(empty + slot);   // release: its dalpha
      slot = nslot;
      phase = nphase;
      if (ahead) {
        row = nrow;
      } else if (j + 1 < total) {      // DEPTH 1: the one stage, refilled
        mbar_wait(ready(slot), phase);
        load_row(row, ring + slot * sw, rw, r_max, lane);
      }
    }
    STAMP_CLOCK(1);
    STAMP_FLUSH(STAMP_WALK0, 8, 0, total);
  }
  __syncthreads();
  float* du_k = du + static_cast<size_t>(k) * d;
  for (int c = threadIdx.x; c < d; c += NTHR) du_k[c] = u[c] - w[c];
}

// ---------------------------------------------------------------------------
// u in device memory: the walk warps and the fetch warp
// ---------------------------------------------------------------------------

template <int DEPTH, int SLOTS, int NWALK>
__global__ void __launch_bounds__((NWALK + 1) * WARP)
sparse_sdca_device_u_kernel(const int* __restrict__ cols,
                            const float* __restrict__ vals,
                            const float* __restrict__ y,
                            const float* __restrict__ alpha,
                            const float* __restrict__ mask,
                            const float* __restrict__ w,
                            const int* __restrict__ perm,
                            float* __restrict__ dalpha,
                            float* __restrict__ du, int nk, int r_max, int d,
                            int n_passes, float scale, int loss_id, float g,
                            int has_prox, float kappa, int vec16) {
  constexpr int NTHR = (NWALK + 1) * WARP;
  constexpr int STRIDE = NWALK * WARP;  // slots between a lane's two slots
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int sw = stage_words(r_max);
  const int rw = row_words(r_max);
  // per stage: `full` completes when its row has landed, `empty` when the
  // walk is done with it
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + DEPTH * sw);
  unsigned long long* empty = full + DEPTH;

  const int k = blockIdx.x;
  // worker k's u: its row of du
  float* u = du + static_cast<size_t>(k) * d;
  const int lane = threadIdx.x & 31;
  const bool walker = threadIdx.x < STRIDE;
  // a walk lane's first slot: walk warp q's lane l takes l + 32 q
  const int base = NWALK == 1 ? lane : static_cast<int>(threadIdx.x);
  const size_t row0 = static_cast<size_t>(k) * nk;   // first row of worker k
  const int* perm_k = perm + row0;
  const long long total = static_cast<long long>(n_passes) * nk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(full + s, WARP);       // one arrival per fetch lane
      mbar_init(empty + s, 1);         // the walk's lane 0
    }
  }
  for (int c = threadIdx.x; c < d; c += NTHR) __stcg(u + c, w[c]);
  __syncthreads();                     // u and the barriers published

  if (!walker) {
    // ---- the fetch warp: row after row into the ring, up to DEPTH ahead
    auto perm_at = [&](long long pos) -> int {
      return pos < total ? perm_k[pos % nk] : 0;
    };
    int cur = perm_at(lane);           // perm of the chunk being fetched
    int nxt = perm_at(WARP + lane);    // and of the chunk after it
    int slot = 0, pm = 0;              // pm = p % nk
    unsigned phase = 0;                // parity of the stage's next reuse
    for (long long p = 0; p < total; ++p) {
      if (p >= DEPTH) mbar_wait(empty + slot, phase ^ 1);
      const int i = __shfl_sync(FULL, cur, static_cast<int>(p & 31));
      float* st = ring + slot * sw;
      const size_t r = row0 + i;
      const size_t e0 = r * r_max;
      if (vec16) {
        const size_t a0 = e0 & ~static_cast<size_t>(3);
        const int n16 = static_cast<int>((e0 + r_max - a0 + 3) >> 2);
        for (int q = lane; q < n16; q += WARP) {
          cp_async16(st + 4 * q, cols + a0 + 4 * q);
          cp_async16(st + rw + 4 * q, vals + a0 + 4 * q);
        }
      } else {
        for (int s = lane; s < r_max; s += WARP) {
          cp_async4(st + s, cols + e0 + s);
          cp_async4(st + rw + s, vals + e0 + s);
        }
      }
      float* sc = st + 2 * rw;
      if (lane < 5) {                  // y, alpha, mask, dalpha, row id
        const float* src = lane == 0 ? y + r : lane == 1 ? alpha + r
                         : lane == 2 ? mask + r : lane == 3 ? dalpha + r
                         : reinterpret_cast<const float*>(perm_k + pm);
        cp_async4(sc + lane, src);
      }
      mbar_arrive_cp_async(full + slot);
      if (((p + 1) & 31) == 0) {       // next chunk of perm
        cur = nxt;
        nxt = perm_at(p + 1 + WARP + lane);
      }
      pm = pm + 1 == nk ? 0 : pm + 1;
      if (++slot == DEPTH) {
        slot = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---- the walk: one row a step, on NWALK warps (no block barrier)
    int slot = 0;
    unsigned phase = 0;
    for (long long j = 0; j < total; ++j) {
      mbar_wait(full + slot, phase);   // stage j has landed
      const float* st = ring + slot * sw;
      const float* sc = st + 2 * rw;
      const int row = reinterpret_cast<const int*>(sc)[4];
      const int sh = vec16 ? static_cast<int>((row0 + row) * r_max & 3) : 0;
      const int* ci = reinterpret_cast<const int*>(st) + sh;
      const float* vi = st + rw + sh;
      // the lane's first SLOTS slots in registers, loaded together so their
      // latencies overlap, and kept for the scatter; wider rows loop on
      int cs[SLOTS];
      float vs[SLOTS];
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        const int s = base + STRIDE * i;
        cs[i] = s < r_max ? ci[s] : 0;
        vs[i] = s < r_max ? vi[s] : 0.0f;
      }
      float z = 0.0f, sq = 0.0f, us[SLOTS];
      // every gather of the lane's slots in flight before any is used,
      // then the partials in slot order
#pragma unroll
      for (int i = 0; i < SLOTS; ++i)
        us[i] = base + STRIDE * i < r_max ? __ldcg(u + cs[i]) : 0.0f;
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        if (base + STRIDE * i < r_max) {
          const float uc =
              has_prox ? sdca::soft_threshold(us[i], kappa) : us[i];
          z += uc * vs[i];
          sq += vs[i] * vs[i];
        }
      }
      // rows past STRIDE * SLOTS: batches of SLOTS from the stage, each
      // batch's gathers in flight together
      for (int s0 = base + STRIDE * SLOTS; s0 < r_max;
           s0 += STRIDE * SLOTS) {
        int cb[SLOTS];
        float vb[SLOTS], ub[SLOTS];
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) {
          const int s = s0 + STRIDE * i;
          cb[i] = s < r_max ? ci[s] : 0;
          vb[i] = s < r_max ? vi[s] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < SLOTS; ++i)
          ub[i] = s0 + STRIDE * i < r_max ? __ldcg(u + cb[i]) : 0.0f;
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) {
          if (s0 + STRIDE * i < r_max) {
            const float uc =
                has_prox ? sdca::soft_threshold(ub[i], kappa) : ub[i];
            z += uc * vb[i];
            sq += vb[i] * vb[i];
          }
        }
      }
      float2 tot = sdca::warp_sum2(z, sq);
      if constexpr (NWALK > 1) {
        // the walk warps' totals, added in warp order by every walk warp
        // (the same bits in each); read before the step's closing barrier,
        // rewritten only after it
        __shared__ float2 part[NWALK];
        if (lane == 0) part[threadIdx.x / WARP] = tot;
        walk_sync<NWALK>();
        tot = part[0];
#pragma unroll
        for (int q = 1; q < NWALK; ++q) {
          tot.x += part[q].x;
          tot.y += part[q].y;
        }
      }
      const float dai = sc[3];
      const float delta = sdca::cd_update(loss_id, g, sc[1] + dai, tot.x,
                                          scale * tot.y, sc[0]) * sc[2];
      if (threadIdx.x == 0) dalpha[row0 + row] = dai + delta;
      const float coef = scale * delta;
      // u[c_s] += coef * v_s by a native atomicAdd in L2 (slots with v == 0
      // skipped, exactly), so repeated ids and column-0 padding all land
      if (coef != 0.0f) {
#pragma unroll
        for (int i = 0; i < SLOTS; ++i)
          if (vs[i] != 0.0f) atomicAdd(u + cs[i], __fmul_rn(coef, vs[i]));
        for (int s = base + STRIDE * SLOTS; s < r_max; s += STRIDE) {
          const float v = vi[s];
          if (v != 0.0f) atomicAdd(&u[ci[s]], coef * v);
        }
      }
      // scatter before the next gather, stage reads done
      if constexpr (NWALK > 1) {
        walk_sync<NWALK>();
      } else {
        __syncwarp();
      }
      if (threadIdx.x == 0) mbar_arrive(empty + slot);   // release: dalpha too
      if (++slot == DEPTH) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
  __syncthreads();
  float* du_k = du + static_cast<size_t>(k) * d;
  for (int c = threadIdx.x; c < d; c += NTHR) du_k[c] = __ldcg(u + c) - w[c];
}

template <typename Kernel>
int launch_kernel(Kernel kernel, int K, int threads, size_t smem,
                  cudaStream_t stream, const int* cols, const float* vals,
                  const float* y, const float* alpha, const float* mask,
                  const float* w, const int* perm, float* dalpha, float* du,
                  int nk, int r_max, int d, int n_passes, float scale,
                  int loss_id, float g, int has_prox, float kappa,
                  int vec16) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<K, threads, smem, stream>>>(cols, vals, y, alpha, mask, w, perm,
                                       dalpha, du, nk, r_max, d, n_passes,
                                       scale, loss_id, g, has_prox, kappa,
                                       vec16);
  return static_cast<int>(cudaGetLastError());
}

// the kernel of (DEPTH, u_in_smem, slots, walkers): u in shared memory at
// SMEM_SLOTS and one walk warp only; u in device memory at 4 slots a lane
// of one walk warp, or 8 or 16 of two
template <int DEPTH>
int launch(int u_in_smem, int slots, int walkers, int K, size_t smem,
           cudaStream_t stream,
           const int* cols, const float* vals, const float* y,
           const float* alpha, const float* mask, const float* w,
           const int* perm, float* dalpha, float* du, int nk, int r_max,
           int d, int n_passes, float scale, int loss_id, float g,
           int has_prox, float kappa, int vec16) {
#define SDCA_LAUNCH(KERNEL, THREADS)                                       \
  return launch_kernel(KERNEL, K, THREADS, smem, stream, cols, vals, y,    \
                       alpha, mask, w, perm, dalpha, du, nk, r_max, d,     \
                       n_passes, scale, loss_id, g, has_prox, kappa, vec16);
  if (u_in_smem) {
    if (slots == SMEM_SLOTS && walkers == 1)
      SDCA_LAUNCH(sparse_sdca_smem_kernel<DEPTH>, 3 * WARP)
  } else if (walkers == 1) {
    if (slots == 4)
      SDCA_LAUNCH((sparse_sdca_device_u_kernel<DEPTH, 4, 1>), 2 * WARP)
  } else if (walkers == 2) {
    if (slots == 8)
      SDCA_LAUNCH((sparse_sdca_device_u_kernel<DEPTH, 8, 2>), 3 * WARP)
    if (slots == 16)
      SDCA_LAUNCH((sparse_sdca_device_u_kernel<DEPTH, 16, 2>), 3 * WARP)
  }
#undef SDCA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launch one round with a ring of `depth` rows (1 <= depth <= min(nk, 8)):
// K blocks, one per worker, on `stream`. dalpha must be zeroed by the
// caller. u_in_smem picks the kernel: u in shared memory beside the ring,
// or in device memory (du's rows; the wrapper's smem_budget decides);
// `slots` the registers a lane gathers into at once and `walkers` the walk
// warps: 4 and 1 with u in shared memory; in device memory 4 and 1, or 8
// or 16 and 2 (the wrapper's device_u_walk).
// Returns the cudaError_t of the launch (0 = ok).
int sparse_sdca_pipelined_launch(const int* cols, const float* vals,
                                 const float* y, const float* alpha,
                                 const float* mask, const float* w,
                                 const int* perm, float* dalpha, float* du,
                                 int K, int nk, int r_max, int d,
                                 int n_passes, float scale, int loss_id,
                                 float g, int has_prox, float kappa,
                                 int depth, int u_in_smem, int slots,
                                 int walkers, void* stream) {
  if (depth < 1 || depth > MAX_DEPTH || depth > nk)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      4 * ((u_in_smem ? static_cast<size_t>(d) : 0) +
           static_cast<size_t>(depth) * stage_words(r_max)) +
      16 * static_cast<size_t>(depth);                   // two barriers each
  // 16-byte copies of a row's 16-byte chunks need 16-byte aligned bases
  // and arrays that end on a chunk (no copy reads past them)
  const int vec16 = reinterpret_cast<size_t>(cols) % 16 == 0 &&
                    reinterpret_cast<size_t>(vals) % 16 == 0 &&
                    static_cast<long long>(K) * nk * r_max % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDCA_PIPELINED_CASE(D)                                             \
  case D:                                                                  \
    return launch<D>(u_in_smem, slots, walkers, K, smem, s, cols, vals, y, \
                     alpha, mask, w, perm, dalpha, du, nk, r_max, d,       \
                     n_passes, scale, loss_id, g, has_prox, kappa, vec16);
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

#if SDCA_STEP_STAMPS
// the stamped build's buffer: its shape (blocks, words), its phases'
// names, a reset and a read (cudaError_t)
void sparse_sdca_stamp_shape(int* out) {
  out[0] = STAMP_BLOCKS;
  out[1] = STAMP_WORDS;
}

const char* sparse_sdca_stamp_names() { return STAMP_NAMES; }

int sparse_sdca_stamps_reset() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_stamps);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_stamps));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, g_stamp_clock);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_stamp_clock));
  return static_cast<int>(err);
}

int sparse_sdca_stamps_read(long long* stamps, long long* clocks) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(stamps, g_stamps, sizeof(g_stamps));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(clocks, g_stamp_clock, sizeof(g_stamp_clock));
  return static_cast<int>(err);
}
#endif

}  // extern "C"
