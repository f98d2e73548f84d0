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
//
// What bounds it on this card: a chain of nk * n_passes dependent steps
// per worker, each a gather, a reduction, a scalar update and a scatter.
// The bytes are tiny by comparison (nnz * 8 for rcv1's 677k x 47k at
// density 0.0016 is 0.13 ms at 3.35 TB/s), so step latency decides. Part
// of each step is loads from device memory whose addresses hang on perm:
// the row's cols/vals (rcv1's 640 MB of ELL data is far past the 50 MB L2)
// and its y, alpha, mask and dalpha. The rest is the step's own chain: the
// gather, the reduction, the update and the scatter, and whatever
// synchronisation orders the scatter before the next gather.
//
// What the design does about it: one launch per round with a grid of K
// blocks, one per worker, of two warps: the walk warp and a fetch warp
// (three where u is in device memory and rows pass 128 slots: two walk
// warps, below). u
// (d floats) sits in dynamic shared memory for the whole walk where it
// fits beside the ring (U_SMEM), so gather and scatter never touch device
// memory. Where it does not (d above 57,852 at depth 1, r_max 118), the
// same walk runs with u in device memory (U_SMEM false): du[k, :] holds
// worker k's u (initialised from w here) and becomes u - w in place at
// the end. There the gather reads u with __ldcg, past L1, so it sees the
// block's own earlier atomics (they land in L2), and the scatter is a
// plain global atomicAdd (a native reduction in L2, no compare-and-swap
// loop); the ring, its mbarriers and the fetch warp stay in shared memory.
// u then takes K 4 d bytes of device memory: 21.7 MB at news20's width
// (1,355,191) and K = 4, inside the card's 50 MB L2. There a gather is a
// round trip to L2 or beyond, and a step's gathers decide it: with SLOTS =
// 4 registers a lane and the rest walked from the stage one load after
// another, news20's rows (r_max 549, 18 slots a lane) took 5.65 us a step,
// 14 round trips in series. So a lane issues the __ldcg of all its slots
// before it uses any (one round trip a row), and the device-memory
// instance is built at SLOTS 4 on one walk warp (rows up to 128 slots)
// and at SLOTS 8 and 16 on two walk warps (the wrapper's device_u_walk
// takes the first that holds the row). Predicated-off registers are not
// free: at r_max 374 and 496 two warps of 8 took 10.3 and 10.7 ms a call
// against two of 16's 11.8 and 12.2, and at r_max 170 and 250 two warps
// of 8 took 9.9 and 10.1 against one warp of 8's 12.0 and 12.0 (news20's
// width, K = 4, depth 4; tools/walk_times.py --parts slots, H100 at 700
// W), so one warp of 8 is not built. Rows past a
// lane's SLOTS walk the rest in batches of SLOTS, each batch's loads in
// flight together. The scatter over the same registers stays
// fire-and-forget global atomicAdd. Why two warps: on one warp with 24
// slots a lane news20 took 3.3 us a step (16.2 ms a call), of which
// taking the gathers out saved 0.8, fetching every step's row from L2
// 0.6, the scatter 0.2, and the warp's __syncwarp and release nothing
// (tools/sdca_step_ablation.py, H100 at 700 W): the lane's chain of 18
// slots' loads, products and atomics was most of the step. Two warps, each
// a lane's 9 slots, took 2.43 us (12.2 ms). Their totals meet in shared
// memory behind a named barrier of the two warps (bar.sync 1), added in
// warp order by both, and a second one ends the step.
// A step of the walk warp (on one walk warp):
//  * lane l gathers slots s = l, l + 32, ... of the staged row (u[c_s],
//    through the soft-threshold when has_prox) into its (z, sq) partials,
//    its first SLOTS slots' ids and values loaded into registers at once
//    (their latencies overlap) and kept there for the scatter;
//  * sdca::warp_sum2, a shuffle butterfly, leaves both totals in every
//    lane: no shared scratch, no serial cross-warp sum;
//  * every lane runs the same cd_update on the same bits, so nothing is
//    broadcast; lane 0 stores dalpha;
//  * each lane scatters coef * v_s into u[c_s] atomically over its slots
//    with v_s != 0 (duplicate column ids and column-0 padding still land),
//    by its own compare-and-swaps issued together: a shared-memory float
//    atomicAdd is a compare-and-swap loop on this card (ATOMS.CAST.SPIN in
//    the SASS), and with one atomicAdd after another the scatter cost
//    0.35 us of a 0.92 us step (tools/sdca_step_ablation.py, run on that
//    scatter);
//  * __syncwarp() orders the scatter before the next step's gather.
// No block barrier is left in the loop. The rows reach the walk through a
// ring of DEPTH one-row stages in shared memory. A stage holds the row's
// cols and vals, each in a region that starts at the row's 16-byte chunk,
// then y / alpha / mask / dalpha and the row id (STAGE_SCALARS words,
// 16-byte aligned). The fetch warp fills the stages in visit order with
// cp.async: cols and vals by 16-byte copies of the chunks that hold the row
// (a row of r_max = 118 is neither 16-byte sized nor aligned, so the copy
// takes up to 3 words more on each side and the walk starts `shift` words
// in), the scalars and the row id by five lanes of one more instruction
// (arrays whose bases are not 16-byte aligned, or that do not end on a
// 16-byte chunk, are copied in 4-byte pieces). Why a second warp: on one
// warp, issuing the row's copies was part of the step's chain, and cost
// 0.59-0.66 us of a 1.07-1.12 us step at rcv1's shape however few copy
// instructions it took (tools/sdca_step_ablation.py on that design): a copy
// from a random row of 640 MB stalls the warp that issues it, not only the
// warp that reads it. Each stage has two mbarriers: `full`, on which each
// fetch lane arrives when its copies have landed (cp.async.mbarrier.arrive
// .noinc), and `empty`, on which the walk's lane 0 arrives once the warp
// is done with the row. The fetch warp refills a stage after waiting on its
// `empty`; the walk waits on `full` before it reads. So at most DEPTH rows
// are fetched ahead: at DEPTH = 1 each row is fetched and waited for in
// its own step, at DEPTH >= 2 the next DEPTH - 1 rows are in flight while
// one is walked. The fetch warp reads perm 32 entries at a time, one
// coalesced load a lane, a whole chunk ahead, keeping two chunks in
// registers and taking each row id by __shfl_sync. One row per stage, not
// a block of rows: the walk drains one row per step, so a row-sized stage
// refills at the rate it empties.
//
// Every depth walks the same rows with the same lane-to-slot map and the
// same shuffle tree, so on rows without duplicate column ids every depth
// gives the same bits (with duplicates the shared-memory atomics may land
// in another order, at any depth). Every SLOTS adds a lane's slots into its
// partials in the same order (slot l, l + 32, l + 64, ... on one warp), so
// the one-warp device-memory instances give the bits of the walk that
// loaded a lane's slots past the first 4 one at a time; two walk
// warps take slots l + 32 q + 64 i (warp q) and add their warp totals,
// another order of the same sum.
//
// Hazards:
//  * dalpha is prefetched. That is right only because a row appears once
//    per pass, so no step between the prefetch and the walk writes it.
//    Across the pass boundary the ring reaches the next pass: the fetch of
//    position p waits for the walk of position p - DEPTH, and row perm[p -
//    nk] was last written at position p - nk, so DEPTH <= nk keeps that
//    write before the wait. The launcher refuses DEPTH > nk; the wrapper
//    clamps DEPTH to nk. The walk's lane 0 stores dalpha and then arrives
//    on `empty` (a release); the fetch lanes wait on it (an acquire)
//    before the copy that prefetches the row again.
//  * A stage is refilled only after its walk: the fetch warp waits on the
//    stage's `empty`, which the walk's lane 0 arrives on after the
//    __syncwarp that ends the step (every lane's reads of the row done).
//  * The walk reads a stage only after its `full` phase completed: every
//    fetch lane's copies of that row have landed, and the wait's acquire
//    makes them visible to the whole walk warp.
//  * The ring plus u must fit the 232,448-byte limit to hold u in shared
//    memory (the wrapper's smem_budget): at d = 47,236 and r_max = 118, u
//    is 188,944 B and a depth-8 ring 8,320 B with its barriers. Past it u
//    goes to device memory, and only the ring must fit.
//  * With u in device memory, a gather after a scatter of the same column
//    (the same lane or another, in the next row) must see the scatter: the
//    atomics land in L2, every read of u is an ld.global.cg (__ldcg), which
//    does not look in L1, and the __syncwarp (one walk warp) or the walk
//    warps' barrier (two) that ends the step orders the atomics before the
//    next loads. u is never read through L1, so L1 holds no stale line of
//    it.
//  * Two walk warps: each writes its totals to part[] before the first
//    walk barrier of the step and reads both after it; the next step's
//    writes come after the second barrier, which both pass only after
//    their reads. The walk's thread 0 stores dalpha and arrives on `empty`
//    after that second barrier, when both warps are done with the stage.

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

constexpr int WARP = 32;
constexpr int MAX_DEPTH = 8;
// words of a stage after its cols and vals: y, alpha, mask, dalpha, row id
// and three spare, so every stage and region stays 16-byte aligned
constexpr int STAGE_SCALARS = 8;
constexpr unsigned FULL = 0xffffffffu;
// slots a lane keeps in registers through a step with u in shared memory
// (rows of r_max <= 128 whole; wider rows walk their further slots from
// the stage); with u in device memory SLOTS is the instance's: 4 on one
// walk warp, 8 or 16 on two
constexpr int SMEM_SLOTS = 4;

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

// wait for the completion of `bar`'s phase of parity `parity`; a wait
// past ~2^34 cycles (seconds: a lost arrival) traps, so a fault of the
// ring protocol shows as a launch error and not as a hung card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const long long t0 = clock64();
  unsigned done;
  do {
    if (clock64() - t0 > (1LL << 34)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
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

// a read of u: shared memory, or device memory past L1 (see Hazards)
template <bool U_SMEM>
__device__ __forceinline__ float load_u(const float* p) {
  if constexpr (U_SMEM) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

// the walk warps' barrier (named barrier 1; the fetch warp is not in it)
template <int NWALK>
__device__ __forceinline__ void walk_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWALK * WARP) : "memory");
}

template <int DEPTH, bool U_SMEM, int SLOTS, int NWALK>
__global__ void __launch_bounds__((NWALK + 1) * WARP)
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
  // worker k's u: after the barriers in shared memory, or its row of du
  float* u = U_SMEM ? reinterpret_cast<float*>(empty + DEPTH)
                    : du + static_cast<size_t>(k) * d;
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
  for (int c = threadIdx.x; c < d; c += NTHR) {
    if constexpr (U_SMEM) {
      u[c] = w[c];
    } else {
      __stcg(u + c, w[c]);
    }
  }
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
      if constexpr (U_SMEM) {
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) {
          us[i] = 0.0f;
          if (base + STRIDE * i < r_max) {
            us[i] = load_u<U_SMEM>(u + cs[i]);
            const float uc =
                has_prox ? sdca::soft_threshold(us[i], kappa) : us[i];
            z += uc * vs[i];
            sq += vs[i] * vs[i];
          }
        }
        for (int s = base + STRIDE * SLOTS; s < r_max; s += STRIDE) {
          const float v = vi[s];
          float uc = load_u<U_SMEM>(u + ci[s]);
          if (has_prox) uc = sdca::soft_threshold(uc, kappa);
          z += uc * v;
          sq += v * v;
        }
      } else {
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
      // u[c_s] += coef * v_s, atomically, so duplicate column ids in a
      // row, and zero padding slots sharing column 0 with a real entry, all
      // land (slots with v == 0 are skipped, exactly). A shared-memory
      // float atomicAdd is a compare-and-swap loop on this card, one loop
      // per slot in turn; here the lane's SLOTS compare-and-swaps go out
      // together, each expecting the value the gather read, and only the
      // ones that lost to a duplicate go round again. The sum is rounded
      // as atomicAdd rounds it (the product, then the add). In device
      // memory atomicAdd is a native reduction in L2, so the lane's slots
      // are plain atomicAdds there.
      if (coef != 0.0f) {
        float add[SLOTS];
        bool pend[SLOTS];
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) {
          add[i] = __fmul_rn(coef, vs[i]);
          pend[i] = vs[i] != 0.0f;
          if (!U_SMEM && pend[i]) atomicAdd(u + cs[i], add[i]);
        }
        bool any = U_SMEM;
        while (any) {
          any = false;
#pragma unroll
          for (int i = 0; i < SLOTS; ++i) {
            if (pend[i]) {
              const unsigned seen = __float_as_uint(us[i]);
              const unsigned got = atomicCAS(
                  reinterpret_cast<unsigned*>(u + cs[i]), seen,
                  __float_as_uint(__fadd_rn(us[i], add[i])));
              pend[i] = got != seen;
              us[i] = __uint_as_float(got);
              any |= pend[i];
            }
          }
        }
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
  for (int c = threadIdx.x; c < d; c += NTHR)
    du_k[c] = load_u<U_SMEM>(u + c) - w[c];   // in place when u is du_k
}

template <int DEPTH, bool U_SMEM, int SLOTS, int NWALK>
int launch_instance(int K, size_t smem, cudaStream_t stream, const int* cols,
                    const float* vals, const float* y, const float* alpha,
                    const float* mask, const float* w, const int* perm,
                    float* dalpha, float* du, int nk, int r_max, int d,
                    int n_passes, float scale, int loss_id, float g,
                    int has_prox, float kappa, int vec16) {
  cudaError_t err = cudaFuncSetAttribute(
      sparse_sdca_pipelined_kernel<DEPTH, U_SMEM, SLOTS, NWALK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_sdca_pipelined_kernel<DEPTH, U_SMEM, SLOTS, NWALK>
      <<<K, (NWALK + 1) * WARP, smem, stream>>>(
      cols, vals, y, alpha, mask, w, perm, dalpha, du, nk, r_max, d,
      n_passes, scale, loss_id, g, has_prox, kappa, vec16);
  return static_cast<int>(cudaGetLastError());
}

// the instance of (DEPTH, u_in_smem, slots, walkers): u in shared memory
// at SMEM_SLOTS and one walk warp only; u in device memory at 4 slots a
// lane of one walk warp, or 8 or 16 of two
template <int DEPTH>
int launch(int u_in_smem, int slots, int walkers, int K, size_t smem,
           cudaStream_t stream,
           const int* cols, const float* vals, const float* y,
           const float* alpha, const float* mask, const float* w,
           const int* perm, float* dalpha, float* du, int nk, int r_max,
           int d, int n_passes, float scale, int loss_id, float g,
           int has_prox, float kappa, int vec16) {
#define SDCA_INSTANCE(U, S, W)                                             \
  return launch_instance<DEPTH, U, S, W>(K, smem, stream, cols, vals, y,   \
                                         alpha, mask, w, perm, dalpha, du, \
                                         nk, r_max, d, n_passes, scale,    \
                                         loss_id, g, has_prox, kappa,      \
                                         vec16);
  if (u_in_smem) {
    if (slots == SMEM_SLOTS && walkers == 1) SDCA_INSTANCE(true, SMEM_SLOTS, 1)
  } else if (walkers == 1) {
    if (slots == 4) SDCA_INSTANCE(false, 4, 1)
  } else if (walkers == 2) {
    if (slots == 8) SDCA_INSTANCE(false, 8, 2)
    if (slots == 16) SDCA_INSTANCE(false, 16, 2)
  }
#undef SDCA_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launch one round with a ring of `depth` rows (1 <= depth <= min(nk, 8)):
// K blocks, one per worker, on `stream`. dalpha must be zeroed by the
// caller. u_in_smem picks the instance: u in shared memory beside the
// ring, or in device memory (du's rows; the wrapper's smem_budget
// decides); `slots` the registers a lane gathers into at once and
// `walkers` the walk warps: 4 and 1 with u in shared memory; in device
// memory 4 and 1, or 8 or 16 and 2 (the wrapper's device_u_walk).
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

}  // extern "C"
