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
// blocks, one per worker, of two warps: the walk warp and a fetch warp. u
// (d floats) sits in dynamic shared memory for the whole walk, so gather
// and scatter never touch device memory (the ring plus u must fit the
// 232,448-byte limit; the wrapper's smem_budget rejects wider d).
// A step of the walk warp:
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
// in another order, at any depth).
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
//  * The ring plus u must fit the 232,448-byte limit (the wrapper's
//    smem_budget): at d = 47,236 and r_max = 118, u is 188,944 B and a
//    depth-8 ring 8,320 B with its barriers.

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

constexpr int WARP = 32;
constexpr int MAX_DEPTH = 8;
// words of a stage after its cols and vals: y, alpha, mask, dalpha, row id
// and three spare, so every stage and region stays 16-byte aligned
constexpr int STAGE_SCALARS = 8;
constexpr unsigned FULL = 0xffffffffu;
// slots a lane keeps in registers through a step (rows of r_max <= 128
// whole; wider rows walk their further slots from the stage)
constexpr int SLOTS = 4;

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

template <int DEPTH>
__global__ void __launch_bounds__(2 * WARP)
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
  constexpr int NTHR = 2 * WARP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int sw = stage_words(r_max);
  const int rw = row_words(r_max);
  // per stage: `full` completes when its row has landed, `empty` when the
  // walk is done with it
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + DEPTH * sw);
  unsigned long long* empty = full + DEPTH;
  float* u = reinterpret_cast<float*>(empty + DEPTH);

  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const bool walker = threadIdx.x < WARP;
  const size_t row0 = static_cast<size_t>(k) * nk;   // first row of worker k
  const int* perm_k = perm + row0;
  const long long total = static_cast<long long>(n_passes) * nk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(full + s, WARP);       // one arrival per fetch lane
      mbar_init(empty + s, 1);         // the walk's lane 0
    }
  }
  for (int c = threadIdx.x; c < d; c += NTHR) u[c] = w[c];
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
    // ---- the walk: one row a step, one warp, no block barrier
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
        const int s = lane + WARP * i;
        cs[i] = s < r_max ? ci[s] : 0;
        vs[i] = s < r_max ? vi[s] : 0.0f;
      }
      float z = 0.0f, sq = 0.0f, us[SLOTS];
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        us[i] = 0.0f;
        if (lane + WARP * i < r_max) {
          us[i] = u[cs[i]];
          const float uc =
              has_prox ? sdca::soft_threshold(us[i], kappa) : us[i];
          z += uc * vs[i];
          sq += vs[i] * vs[i];
        }
      }
      for (int s = lane + WARP * SLOTS; s < r_max; s += WARP) {
        const float v = vi[s];
        float uc = u[ci[s]];
        if (has_prox) uc = sdca::soft_threshold(uc, kappa);
        z += uc * v;
        sq += v * v;
      }
      const float2 tot = sdca::warp_sum2(z, sq);
      const float dai = sc[3];
      const float delta = sdca::cd_update(loss_id, g, sc[1] + dai, tot.x,
                                          scale * tot.y, sc[0]) * sc[2];
      if (lane == 0) dalpha[row0 + row] = dai + delta;
      const float coef = scale * delta;
      // u[c_s] += coef * v_s, atomically, so duplicate column ids in a
      // row, and zero padding slots sharing column 0 with a real entry, all
      // land (slots with v == 0 are skipped, exactly). A shared-memory
      // float atomicAdd is a compare-and-swap loop on this card, one loop
      // per slot in turn; here the lane's SLOTS compare-and-swaps go out
      // together, each expecting the value the gather read, and only the
      // ones that lost to a duplicate go round again. The sum is rounded
      // as atomicAdd rounds it (the product, then the add).
      if (coef != 0.0f) {
        float add[SLOTS];
        bool pend[SLOTS];
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) {
          add[i] = __fmul_rn(coef, vs[i]);
          pend[i] = vs[i] != 0.0f;
        }
        bool any = true;
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
        for (int s = lane + WARP * SLOTS; s < r_max; s += WARP) {
          const float v = vi[s];
          if (v != 0.0f) atomicAdd(&u[ci[s]], coef * v);
        }
      }
      __syncwarp();     // scatter before the next gather, stage reads done
      if (lane == 0) mbar_arrive(empty + slot);   // release: dalpha too
      if (++slot == DEPTH) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
  __syncthreads();
  float* du_k = du + static_cast<size_t>(k) * d;
  for (int c = threadIdx.x; c < d; c += NTHR) du_k[c] = u[c] - w[c];
}

template <int DEPTH>
int launch(int K, size_t smem, cudaStream_t stream, const int* cols,
           const float* vals, const float* y, const float* alpha,
           const float* mask, const float* w, const int* perm, float* dalpha,
           float* du, int nk, int r_max, int d, int n_passes, float scale,
           int loss_id, float g, int has_prox, float kappa, int vec16) {
  cudaError_t err = cudaFuncSetAttribute(
      sparse_sdca_pipelined_kernel<DEPTH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_sdca_pipelined_kernel<DEPTH><<<K, 2 * WARP, smem, stream>>>(
      cols, vals, y, alpha, mask, w, perm, dalpha, du, nk, r_max, d,
      n_passes, scale, loss_id, g, has_prox, kappa, vec16);
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
  const size_t smem = 4 * (static_cast<size_t>(d) +
                           static_cast<size_t>(depth) * stage_words(r_max)) +
                      16 * static_cast<size_t>(depth);   // two barriers each
  // 16-byte copies of a row's 16-byte chunks need 16-byte aligned bases
  // and arrays that end on a chunk (no copy reads past them)
  const int vec16 = reinterpret_cast<size_t>(cols) % 16 == 0 &&
                    reinterpret_cast<size_t>(vals) % 16 == 0 &&
                    static_cast<long long>(K) * nk * r_max % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDCA_PIPELINED_CASE(D)                                             \
  case D:                                                                  \
    return launch<D>(K, smem, s, cols, vals, y, alpha, mask, w, perm,      \
                     dalpha, du, nk, r_max, d, n_passes, scale, loss_id,   \
                     g, has_prox, kappa, vec16);
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
