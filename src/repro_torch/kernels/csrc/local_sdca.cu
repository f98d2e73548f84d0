// LocalSDCA over dense rows (paper Algorithm 2) for Hopper (sm_90a), as a
// windowed lookahead over a thread-block cluster.
//
// Replaces the TPU kernel src/repro/kernels/local_sdca.py::_sdca_kernel
// (entry local_sdca_pallas, pallas_call at :127), which ran one worker's
// walk as a sequential (pass, row block) grid with u and dalpha in VMEM,
// vmapped over the K workers.
//
// What it computes, per worker k, for n_passes passes over its nk rows in
// the order perm[k, :]:
//     i = perm[k, j];  x = X[k, i, :]
//     z = x . u;  q = scale * ||x||^2;  abar = alpha[k, i] + dalpha[k, i]
//     delta = cd_update(abar, z, q, y[k, i]) * mask[k, i]
//     dalpha[k, i] += delta;  u += scale * delta * x
// from u = w, and emits du[k, :] = u - w.
//
// What bounds it on this card: the walk is a chain of nk * n_passes
// dependent steps per worker -- every step reads the u the previous step
// wrote. X is read once per pass (K*nk*d*4 bytes, 0.96 ms at 3.35 TB/s for
// epsilon's 400k x 2000), but a step pays a reduction over d and a serial
// scalar update, and one block a worker leaves all but K of the 132 SMs
// idle (a step of the paper cell's rank block, d = 16,384 on one SM, took
// 6.1 us: its rows streamed through one SM twice).
//
// What the design does about it:
//  * Windows. B rows of the visit order at a time; the step reads u only
//    through z_j = x_j . u, and every update is rank one along its own row,
//    so from u0 = the u at the window's start
//        z_j = x_j . u0 + sum_{l<j} c_l G_lj,  G = X_B X_B^T,  c_l = scale d_l
//        q_j = scale G_jj;   afterwards u = u0 + X_B^T c
//    -- in exact arithmetic the same walk, row for row; only the order of
//    the float additions changes. The wrapper hoists the conjugate map, so
//    the walk is linear in u and this holds under every dense
//    configuration.
//  * A cluster of C blocks a worker (cudaLaunchKernelEx, cluster dimension
//    (C, 1, 1); C <= 16, past 8 with the non-portable attribute). Block
//    rank r owns columns [r dc, min(d, (r + 1) dc)), dc = ceil(d / C)
//    rounded up to 4: its slice of u and of each window row live in its
//    own shared memory. The dots and G are sums over columns and the update
//    is column by column, so the d-long work splits over the C SMs, and a
//    window needs one exchange of its P partials.
//  * The exchange waits for data, not for the cluster: each block pushes
//    its P partials into slot r of every peer's buffer xb[n % 4] by
//    st.async, each store completing 4 bytes of the transaction on that
//    peer's mbarrier xbar[n % 4]; a block waits only on its own mbarrier.
//    Every block then sums the C partials in rank order 0..C-1, never in
//    order of arrival, so every block holds them bit for bit alike, runs
//    the same scalar loop and gets the same c with no second exchange.
//  * A window ahead (where whole slices fit: `ahead`). Window s + 1's Gram
//    needs only its rows, and its dots need u only through
//        z_{s+1} = X_{s+1} u0_s + H c_s,   H = X_{s+1} X_s^T,
//    so the column warps (1-7) take window s + 1's partials -- G's upper
//    triangle with its diagonal, z' = X_{s+1} u0_s and H, P = B (B + 3) / 2
//    + B^2 -- and push them while warp 0 runs window s's scalar loop; the
//    exchange's latency and the partials leave the chain, which is warp 0's
//    sums, z = z' + H c_s and the loop. Where slices do not fit whole, the
//    rows are cut into column tiles (d_tile) streamed as (window, tile)
//    chunks, and a window's partials are G, z0 = X_s u0_s (P = B (B + 3) /
//    2), taken in window s itself after its tiles; the update then reads
//    the rows from device memory (just streamed, so in L2).
//    Measured (tools/sdca_step_ablation.py --only dense, stamped, H100 at
//    700 W): at epsilon's shape (K = 8, C = 8, B = 8) a window takes
//    2.48 us, warp 0's sums, fix and loop 1.33 of it; the column warps
//    pace it (partials 1.45, update and its barrier 0.54), so warp 0
//    waits 1.13 for the exchange.
//  * Partials: register tiles of RB x RB rows (RB = min(B, 8)) over the
//    block's columns, in float32 FMA (no tensor cores: TF32 would round
//    G); a tile's partials are reduced across a warp by recursive halving
//    and across its team's warps through shared memory in a fixed order,
//    and the threads that sum them push them. With the lookahead the 7
//    column warps split into teams, one a tile (B <= 8: G's with the dots
//    and H's, two teams of 3 warps; B = 16: seven single warps), so the
//    tiles and their reductions run side by side: with every warp on every
//    tile, a window's partials took 2.09 us at epsilon's shape, in teams
//    1.45 (tools/sdca_step_ablation.py, H100 at 700 W). Without it all 7
//    warps take each tile.
//  * Scalar loop, warp 0: it sums every partial in rank order (lane i the
//    i-th of each 32, its C loads in flight together) into shared memory;
//    lane j takes its z'_j, its column of G and its row of H from there,
//    z_j = z'_j + sum_l H_jl c_l, then runs the window's updates in order:
//    every lane runs cd_update on its own row, and after
//    step l lane l's c_l goes to all lanes by __shfl_sync. The loss is a
//    template constant of the loop, so cd_update's switch folds away. Warp
//    0 reads the next window's row ids from perm and their y, alpha, mask
//    and dalpha a window ahead, and hands c (and the row ids) to the column
//    warps through shared memory and an mbarrier (cbar), without a block
//    barrier.
//  * Update, the column warps: u = fma(c_j, x_j, u) for j = 0 .. nb-1 in
//    visit order, over the block's columns, from the staged slices.
//  * Rows off the chain: a fetch warp fills a ring of 2-4 stages of B rows
//    x d_tile columns, guarded by a full and an empty mbarrier each, a
//    stage or more ahead, each row's slice by one bulk copy (cp.async.bulk;
//    4-byte cp.async where a slice does not start on 16 bytes, d % 4 != 0).
//    It reads the row ids from perm one window ahead of its own fill.
//
// Hazards:
//  * Windows never cross a pass boundary: a row visited at the end of pass
//    p and again near the start of pass p + 1 must see its own delta in
//    dalpha and in u. Windows are cut per pass; the last window of a pass
//    has nb = nk - its start rows when B does not divide nk. Within one
//    pass a row appears once, so within a window no row is visited twice.
//  * dalpha: every block computes the same deltas, and each keeps its own
//    copy (dalpha[r, k, :]; the wrapper returns rank 0's), written and read
//    by its warp 0 only, so no ordering across blocks or warps is needed. A
//    row comes back at the same position of the next pass, nw windows
//    later; warp 0 reads window s + 1's dalpha at window s's start, after
//    its write of window s - 1 (nw >= 2), or, where a pass is one window
//    (nk <= B), lane j keeps row j's dalpha in a register (da_next).
//  * Stage rows past nb hold stale words (or, before the first fill, any
//    bits); they feed only partials of rows past nb, and the fix, the loop
//    and the update read only rows below nb.
//  * Exchange, four buffers: window n's partials go into buffer n % 4. A
//    block is in window s only when its warp 0 has all peers' window s - 1
//    partials, pushed by their column warps while their warp 0 ran window
//    s - 2 (or earlier): so a peer's warp 0 is at least in window s - 2,
//    done with buffer (s - 3) % 4, when this block pushes window s + 1's
//    partials into it. Each buffer's mbarrier phase is armed
//    (arrive.expect_tx, lane 0 of warp 0) after warp 0's wait of the
//    window four before, which comes before any store of the new one (a
//    store arriving before the arming would only leave the transaction
//    count below zero until it; the phase cannot complete before its one
//    arrival). The barriers are initialised and fenced (fence.mbarrier_init)
//    and the first four phases armed before a cluster barrier that comes
//    before the first remote store, and a cluster barrier after the walk
//    keeps every block alive until no peer sends to it.
//  * c, two slots: warp 0 writes window s's c and row ids into slot s % 2
//    and arrives on cbar[s % 2]; the column warps wait on it. Warp 0
//    writes that slot again (window s + 2) only after its own block's
//    column warps pushed window s + 2's partials, which they do after
//    reading window s's slot.
//  * The ring: chunk n's stage (n % ring) is refilled with chunk n + ring
//    once every column warp arrived on its `empty`: after the window's
//    update with the lookahead (the stage also feeds H of the next
//    window's partials, taken before that update), after the chunk's
//    partials without it. The column warps wait on `full` before reading a
//    chunk.
//  * u, with the lookahead: two slices, u0 of window s in buffer s % 2.
//    The teams read window s + 1's z' from buffer s % 2 while the update of
//    window s writes u0 of window s + 1 into the other buffer, and the
//    column warps' barrier after the update publishes it; the buffer is
//    written again (window s + 1's update) only after that barrier, when
//    its readers are done. Without the lookahead all 7 warps take every
//    tile and the update, a column thread the same columns (column i of
//    the tile, i % 224 its index), so u needs no barrier.
//  * A slice past d (d < 4 C, as at covtype's 54) owns no columns: its
//    partials are zeros, which the rank-order sums add exactly; it still
//    pushes every window, so no peer waits for it.
//  * Masked padding rows (delta = 0 by the mask) and all-zero rows (q = 0,
//    the guarded no-op) give c = 0, and u = fma(0, x, u) leaves u exactly.
//  * Shared memory (the wrapper's dense_smem_budget): the mbarriers, the
//    ring, u's slice (two with the lookahead), the exchange's four buffers
//    of C P partials, the block's own partials (P, for column tiles) and
//    warp 0's sums (P), c and the row ids (two slots of B each) and two
//    reduction buffers (2 x 7 x 64), within 232,448 bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "sdca_common.cuh"

// the stamped build (tools/sdca_step_ablation.py --only dense): each
// role's phases as the kernel stamps them, warp 0 and column warp 1
#define ZX_STAMP_NAMES                       \
  "scalar:wait,sums,fix,loop,hand;"          \
  "columns:wait_full,partials,wait_c,update"
#include "sdca_zx_stamps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;         // the walk: warp 0 and 7 column warps
constexpr int COL_WARPS = THREADS / 32 - 1;
constexpr int COL_THREADS = 32 * COL_WARPS;
constexpr int BLOCK_THREADS = THREADS + 32;   // and the fetch warp
constexpr int RED_WORDS = 64;        // per warp and buffer: a tile's values
constexpr int RING_MAX = 4;          // stages of the ring, where they fit
constexpr int XBUFS = 4;             // the exchange's buffers
constexpr int PORTABLE_CLUSTER = 8;
constexpr int MAX_CLUSTER = 16;
constexpr long long SMEM_LIMIT = 232448;   // a block's shared memory (opt-in)
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) & ~3;
}

// the partials a window exchanges: G's upper triangle with its diagonal
// (entry (i, k), i <= k, at k (k + 1) / 2 + i), then the dots, then with
// the lookahead H (entry (j, l) at B (B + 3) / 2 + j B + l)
__host__ __device__ __forceinline__ int partials(int B, bool ahead) {
  return B * (B + 3) / 2 + (ahead ? B * B : 0);
}

// the columns each block of a cluster of C owns (the last one fewer)
__host__ __device__ __forceinline__ int slice_cols(int d, int C) {
  return round4((d + C - 1) / C);
}

// words of dynamic shared memory, in layout order
__host__ __device__ __forceinline__ long long smem_words(int dc, int B, int C,
                                                         int dt, int ring,
                                                         bool ahead) {
  const long long P = partials(B, ahead);
  return 2LL * (2 * ring + XBUFS + 2)            // full, empty; xbar; cbar
         + static_cast<long long>(ring) * B * dt // the ring
         + (ahead ? 2LL : 1LL) * dc              // u's slice (two)
         + XBUFS * C * P                         // the exchange's buffers
         + 2LL * P                               // own partials; the sums
         + 4LL * B                               // c, row ids: two slots
         + 2LL * COL_WARPS * RED_WORDS;          // reduction buffers
}

// One block's layout: its columns (dc), a stage's columns (dt), the ring,
// the column tiles a window takes, the lookahead and the bytes. Whole
// slices with the lookahead in the deepest ring of RING_MAX .. 2 stages
// that fits; else, without it, two stages of the widest multiple of 4
// columns that fits, evened out over the tiles.
struct Layout {
  int dc, dt, ring, chunks;
  bool ahead;
  long long bytes;
};

__host__ __device__ Layout dense_layout(int d, int B, int C) {
  Layout L;
  L.dc = slice_cols(d, C);
  L.ahead = true;
  for (L.ring = RING_MAX; L.ring >= 2; --L.ring) {
    L.bytes = 4 * smem_words(L.dc, B, C, L.dc, L.ring, true);
    if (L.bytes <= SMEM_LIMIT) {
      L.dt = L.dc;
      L.chunks = 1;
      return L;
    }
  }
  L.ring = 2;
  L.ahead = false;
  const long long widest =
      (SMEM_LIMIT / 4 - smem_words(L.dc, B, C, 0, 2, false)) / (2LL * B) /
      4 * 4;
  if (widest >= 4) {
    L.chunks = static_cast<int>((L.dc + widest - 1) / widest);
    L.dt = round4((L.dc + L.chunks - 1) / L.chunks);
  } else {
    L.dt = 4;
    L.chunks = L.dc / 4;
  }
  L.bytes = 4 * smem_words(L.dc, B, C, L.dt, 2, false);
  return L;
}

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

// arrive on `bar`, and expect `bytes` of remote stores or copies in its
// phase
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state)
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// whether `bar`'s phase of parity `parity` has completed; acquire at
// cluster scope where peers' stores completed it (so they are visible),
// else at the block's (its own copies and arrivals)
template <bool CLUSTER>
__device__ __forceinline__ bool mbar_try(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done;
  if constexpr (CLUSTER) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } else {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
  return done != 0;
}

// wait for that completion; a wait past ~2^34 cycles (a lost store or
// copy) traps, so a fault of the protocol shows as a launch error and not
// as a hung card
template <bool CLUSTER = false>
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  if (mbar_try<CLUSTER>(bar, parity)) return;
  const long long t0 = clock64();
  for (unsigned n = 1; !mbar_try<CLUSTER>(bar, parity); ++n)
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// this thread's cp.asyncs so far arrive on `bar` when they have landed
__device__ __forceinline__ void mbar_arrive_cp_async(
    unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the column warps' barrier (warp 0 and the fetch warp run on)
__device__ __forceinline__ void col_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(COL_THREADS) : "memory");
}

// one partial into a peer's buffer (`dst`, a shared::cluster address),
// completing 4 bytes of the transaction on that peer's barrier `bar`
__device__ __forceinline__ void send_partial(unsigned dst, float v,
                                             unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// a tile of partials: the diagonal block of G with the rows' dots, a block
// of G off the diagonal, or a block of H (rows of the window against the
// window before)
enum Tile { DIAG, OFF, CROSS };

// values one tile reduces, padded to a multiple of 32 for the recursive
// halving
template <int RB, Tile T>
struct TileShape {
  static constexpr int N = T == DIAG ? RB * (RB + 1) / 2 + RB : RB * RB;
  static constexpr int NP = N <= 32 ? 32 : 64;
  static constexpr int M = NP / 32;  // values a lane holds at the end
};

// Sum NP values over the warp by recursive halving: at each level a lane
// sends half its values to its partner and adds the half it receives, so
// after five levels lane l holds the sums of values M l .. M l + M - 1 in
// acc[0 .. M-1] (with 64 values: 62 shuffles, not 320).
template <int NP, int H = NP / 2, int O = 16>
__device__ __forceinline__ void warp_halve(float (&acc)[NP]) {
  const bool up = (threadIdx.x & O) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? acc[i] : acc[i + H];
    const float keep = up ? acc[i + H] : acc[i];
    acc[i] = keep + __shfl_xor_sync(FULL, send, O);
  }
  if constexpr (O > 1) warp_halve<NP, H / 2, O / 2>(acc);
}

// Where a window's partials go: this block's rank, the cluster's size, the
// partials a window exchanges, the window's exchange buffer and mbarrier
// (shared::cta addresses, mapped to each peer's), and the block's own
// partials of the window's earlier column tiles
struct Exchange {
  int rank, C, P;
  unsigned xb, bar;
  float* part;
};

// The window's tiles of partials: G's diagonal blocks (with the rows' dots
// against u), its blocks off the diagonal, and with the lookahead H's
// blocks, in that order
template <int NBLK>
__host__ __device__ constexpr int tiles_of(bool ahead) {
  return NBLK + NBLK * (NBLK - 1) / 2 + (ahead ? NBLK * NBLK : 0);
}

// The column warps split into teams, one a tile (each team loops over
// every `teams`-th tile): min(tiles, 7) teams of 7 / teams warps
__host__ __device__ constexpr int team_warps(int tiles) {
  return COL_WARPS / (tiles < COL_WARPS ? tiles : COL_WARPS);
}

// a team's barrier (named barrier 2 + team, its NW warps)
__device__ __forceinline__ void team_sync(int team, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + team), "r"(threads)
               : "memory");
}

// One tile of partials over this chunk's `w` columns by a team of NW warps
// (`tt` the thread's index in it), rows I*RB.. of the stage `sa` against
// rows J*RB.. of `sb` (and u on a diagonal tile): every thread's partials,
// the warp's sums by recursive halving, then (NW > 1) the warps' sums into
// red[warp][M lane + k] and after the team's barrier threads tt < N sum its
// warps in order; each value, partial p, is added to the block's partials
// of the window's earlier column tiles unless `first`, and pushed into
// slot `rank` of every peer's buffer on the window's `last` tile.
template <int B, int RB, Tile T, int NW>
__device__ __forceinline__ void gram_tile(const float* sa, const float* sb,
                                          int dts, int w, const float* uc0,
                                          int I, int J, int tt, int team,
                                          float* red, const Exchange& x,
                                          bool first, bool last) {
  using S = TileShape<RB, T>;
  constexpr int TRIB = B * (B + 1) / 2;
  float acc[S::NP];
#pragma unroll
  for (int p = 0; p < S::NP; ++p) acc[p] = 0.0f;
  for (int cl = tt; cl < w; cl += 32 * NW) {
    float a[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) a[i] = sa[(I * RB + i) * dts + cl];
    if constexpr (T == DIAG) {
      const float uc = uc0[cl];
      int p = 0;
#pragma unroll
      for (int i = 0; i < RB; ++i) {
#pragma unroll
        for (int k = i; k < RB; ++k, ++p) acc[p] = fmaf(a[i], a[k], acc[p]);
      }
#pragma unroll
      for (int i = 0; i < RB; ++i, ++p) acc[p] = fmaf(a[i], uc, acc[p]);
    } else {
      float b[RB];
#pragma unroll
      for (int k = 0; k < RB; ++k) b[k] = sb[(J * RB + k) * dts + cl];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
#pragma unroll
        for (int k = 0; k < RB; ++k)
          acc[i * RB + k] = fmaf(a[i], b[k], acc[i * RB + k]);
      }
    }
  }
  warp_halve<S::NP>(acc);
  const int lane = tt & 31;
  // value v of the tile, summed: partial p of the window
  auto finish = [&](int v, float s) {
    int p;
    if constexpr (T == DIAG) {
      constexpr int TRI = RB * (RB + 1) / 2;
      if (v < TRI) {
        int i = 0, rest = v;
        while (rest >= RB - i) rest -= RB - i++;
        const int row = I * RB + i, col = row + rest;
        p = col * (col + 1) / 2 + row;
      } else {
        p = TRIB + I * RB + (v - TRI);
      }
    } else if constexpr (T == OFF) {
      const int row = I * RB + v / RB, col = J * RB + v % RB;
      p = col * (col + 1) / 2 + row;
    } else {
      p = TRIB + B + (I * RB + v / RB) * B + J * RB + v % RB;
    }
    if (!first) s += x.part[p];
    if (last) {
      const unsigned dst = x.xb + 4u * (x.rank * x.P + p);
      for (int j = 0; j < x.C; ++j)
        send_partial(peer_addr(dst, j), s, peer_addr(x.bar, j));
    } else {
      x.part[p] = s;
    }
  };
  if constexpr (NW == 1) {
    // lane l holds values M l .. M l + M - 1, summed over the warp
#pragma unroll
    for (int k = 0; k < S::M; ++k)
      if (S::M * lane + k < S::N) finish(S::M * lane + k, acc[k]);
  } else {
    const int tw = tt >> 5;            // the warp's index in its team
#pragma unroll
    for (int k = 0; k < S::M; ++k)
      red[tw * RED_WORDS + S::M * lane + k] = acc[k];
    team_sync(team, 32 * NW);
    if (tt < S::N) {
      float s = 0.0f;
#pragma unroll
      for (int v = 0; v < NW; ++v) s += red[v * RED_WORDS + tt];
      finish(tt, s);
    }
  }
}

// Window n's tiles of one team over one chunk: tile tau (G's diagonal
// blocks, its blocks off the diagonal, then H's) for tau = team, team +
// teams, ...
template <int B, int NW>
__device__ __forceinline__ void team_tiles(const float* sa, const float* sp,
                                           int dts, int w, const float* uc0,
                                           int tt, int team, int teams,
                                           int n_tiles, float* red,
                                           int& tile, const Exchange& x,
                                           bool first, bool last) {
  constexpr int RB = B < 8 ? B : 8;
  constexpr int NBLK = B / RB;
  constexpr int OFFS = NBLK * (NBLK - 1) / 2;
  for (int tau = team; tau < n_tiles; tau += teams) {
    float* r = red + ((tile++ & 1) * COL_WARPS + team * NW) * RED_WORDS;
    if (tau < NBLK) {
      gram_tile<B, RB, DIAG, NW>(sa, sa, dts, w, uc0, tau, tau, tt, team, r,
                                 x, first, last);
    } else if (tau < NBLK + OFFS) {
      int I = 0, rest = tau - NBLK;    // the (I, J > I) block, row-major
      while (rest >= NBLK - 1 - I) rest -= NBLK - 1 - I++;
      gram_tile<B, RB, OFF, NW>(sa, sa, dts, w, uc0, I, I + 1 + rest, tt,
                                team, r, x, first, last);
    } else {
      const int c = tau - NBLK - OFFS;
      gram_tile<B, RB, CROSS, NW>(sa, sp, dts, w, uc0, c / NBLK, c % NBLK,
                                  tt, team, r, x, first, last);
    }
  }
}

// The window's updates in order, on one warp: lane j < nb holds row j's
// z_j, q_j, its column of G (G_lj, l < j) and its scalars; after step l
// lane l's c_l goes to all lanes by __shfl_sync and each lane j > l adds
// c_l G_lj. The loss is a constant, so cd_update's switch folds away.
// Returns the lane's delta (0 past nb).
template <int B, int LOSS>
__device__ __forceinline__ float window_updates(float z, float q,
                                                const float (&gcol)[B],
                                                float abar, float yj,
                                                float mj, float g,
                                                float scale, int nb) {
  const int lane = threadIdx.x & 31;
  float mine = 0.0f;
#pragma unroll
  for (int l = 0; l < B; ++l) {
    if (l < nb) {
      const float dl = sdca::cd_update(LOSS, g, abar, z, q, yj) * mj;
      const float cl = __shfl_sync(FULL, scale * dl, l);
      if (lane == l) mine = dl;
      if (lane > l) z = fmaf(cl, gcol[l], z);
    }
  }
  return mine;
}

template <int B>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
local_sdca_kernel(const float* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ alpha,
                  const float* __restrict__ mask,
                  const float* __restrict__ w, const int* __restrict__ perm,
                  float* __restrict__ dalpha, float* __restrict__ du, int K,
                  int nk, int d, int n_passes, float scale, int loss_id,
                  float g, int C, int dc, int dt, int ring, int ahead,
                  int vec16) {
  // dalpha: (C, K, nk), rank r's copy at [r]
  constexpr int RB = B < 8 ? B : 8;
  constexpr int NBLK = B / RB;
  constexpr int TRIB = B * (B + 1) / 2;
  // partials a lane of warp 0 sums, at most
  constexpr int PL = (B * (B + 3) / 2 + B * B + 31) / 32;
  const int P = partials(B, ahead);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + ring;
  unsigned long long* xbar = empty + ring;
  unsigned long long* cbar = xbar + XBUFS;
  float* stages = reinterpret_cast<float*>(cbar + 2);
  float* u = stages + ring * B * dt;
  float* xb = u + (ahead ? 2 : 1) * dc;
  float* part = xb + XBUFS * C * P;
  float* sums = part + P;
  float* cvec = sums + P;
  int* wid = reinterpret_cast<int*>(cvec + 2 * B);
  float* red = reinterpret_cast<float*>(wid + 2 * B);

  const int r = static_cast<int>(blockIdx.x) % C;   // the cluster's rank
  const int k = static_cast<int>(blockIdx.x) / C;   // the worker
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c_lo = r * dc;                          // the block's columns
  const int wr = max(0, min(dc, d - c_lo));
  const size_t row0 = static_cast<size_t>(k) * nk;  // first row of worker k
  const float* Xk = X + row0 * d;
  const int* perm_k = perm + row0;
  float* da = dalpha + (static_cast<size_t>(r) * K + k) * nk;
  const int nw = (nk + B - 1) / B;                  // windows a pass
  const int nwin = n_passes * nw;
  const int nch = (dc + dt - 1) / dt;               // column tiles a window
  const int nchunks = nwin * nch;
  const unsigned xbytes = 4u * P * C;               // a window's exchange
  auto rows_of = [&](int s) { return min(B, nk - (s % nw) * B); };
  cg::cluster_group cluster = cg::this_cluster();

  if (tid == 0) {
    for (int i = 0; i < ring; ++i) {
      mbar_init(full + i, 32 + 1);     // 32 cp.async lanes, lane 0's bytes
      mbar_init(empty + i, COL_WARPS); // lane 0 of each column warp
    }
    for (int i = 0; i < XBUFS; ++i) mbar_init(xbar + i, 1);
    mbar_init(cbar, 1);                // lane 0 of warp 0
    mbar_init(cbar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < wr; c += BLOCK_THREADS) u[c] = w[c_lo + c];
  __syncthreads();
  if (tid == 0) {                      // the first windows' exchanges
    for (int i = 0; i < XBUFS && i < nwin; ++i) mbar_expect(xbar + i, xbytes);
  }
  cluster.sync();                      // every peer's barriers are armed
  ZX_STAMP_CLOCK(0);

  if (warp == THREADS / 32) {
    // ---- the fetch warp: chunk n (window n / nch, tile n % nch) into
    // stage n % ring once the column warps released chunk n - ring; row
    // t's slice by lane t
    int id = 0;
    int id_next = nwin > 0 && lane < rows_of(0) ? perm_k[lane] : 0;
    for (int n = 0; n < nchunks; ++n) {
      const int s = n / nch, t = n % nch, sl = n % ring;
      if (t == 0) {                    // the window's ids; the next one's
        id = id_next;
        if (s + 1 < nwin && lane < rows_of(s + 1))
          id_next = perm_k[((s + 1) % nw) * B + lane];
      }
      if (n >= ring) mbar_wait(empty + sl, ((n / ring) - 1) & 1);
      const int nb = rows_of(s);
      const int c0 = t * dt, wd = max(0, min(dt, wr - c0));
      float* st = stages + sl * B * dt;
      unsigned bytes = 0;
      if (vec16) {
        const float* src = Xk + static_cast<size_t>(id) * d + c_lo + c0;
        if (lane < nb && wd > 0) {
          bulk_copy(st + lane * dt, src, 4u * wd, full + sl);
          bytes = 4u * wd;
        }
      } else {
        // 4-byte copies where a slice does not start on 16 bytes
        for (int j = 0; j < nb; ++j) {
          const int rj = __shfl_sync(FULL, id, j);
          const float* src = Xk + static_cast<size_t>(rj) * d + c_lo + c0;
          for (int q = lane; q < wd; q += 32)
            cp_async4(st + j * dt + q, src + q);
        }
      }
      mbar_arrive_cp_async(full + sl);
      bytes = __reduce_add_sync(FULL, bytes);
      if (lane == 0) mbar_expect(full + sl, bytes);
    }
  } else if (warp == 0) {
    // ---- warp 0: per window the C partials summed in rank order, the
    // dots, the scalar loop; lane j holds row j of the window
    int rj = 0;                        // this window's row and scalars
    float yj = 0.0f, aj = 0.0f, mj = 0.0f, daj = 0.0f;
    if (nwin > 0 && lane < rows_of(0)) {
      rj = perm_k[lane];
      yj = y[row0 + rj];
      aj = alpha[row0 + rj];
      mj = mask[row0 + rj];
      daj = da[rj];
    }
    float cprev = 0.0f;                // the lane's c of the window before
    ZX_STAMP_BEGIN(5);
    for (int s = 0; s < nwin; ++s) {
      const int nb = rows_of(s);
      // the next window's row and scalars, a window ahead; its dalpha too
      // where its rows were last written a window or more before (nw >= 2)
      int rn = 0;
      float yn = 0.0f, an = 0.0f, mn = 0.0f, dan = 0.0f;
      if (s + 1 < nwin && lane < rows_of(s + 1)) {
        rn = perm_k[((s + 1) % nw) * B + lane];
        yn = y[row0 + rn];
        an = alpha[row0 + rn];
        mn = mask[row0 + rn];
        if (nw > 1) dan = da[rn];
      }
      mbar_wait<true>(xbar + s % XBUFS, (s / XBUFS) & 1);
      ZX_STAMP(0);
      // this buffer expects window s + 4's partials
      if (lane == 0 && s + XBUFS < nwin)
        mbar_expect(xbar + s % XBUFS, xbytes);
      // every partial summed in rank order, lane i the i-th of each 32,
      // the ranks' loads of a lane in flight together
      {
        const float* xs = xb + (s % XBUFS) * C * P;
        float acc[PL];
#pragma unroll
        for (int i = 0; i < PL; ++i)
          acc[i] = lane + 32 * i < P ? xs[lane + 32 * i] : 0.0f;
        for (int j = 1; j < C; ++j) {
#pragma unroll
          for (int i = 0; i < PL; ++i)
            if (lane + 32 * i < P) acc[i] += xs[j * P + lane + 32 * i];
        }
#pragma unroll
        for (int i = 0; i < PL; ++i)
          if (lane + 32 * i < P) sums[lane + 32 * i] = acc[i];
      }
      __syncwarp();
      float z = 0.0f, q = 0.0f, gcol[B];
      if (lane < B) {
        z = sums[TRIB + lane];
        q = scale * sums[lane * (lane + 1) / 2 + lane];
      }
#pragma unroll
      for (int l = 0; l < B; ++l)
        gcol[l] = l < lane && lane < B ? sums[lane * (lane + 1) / 2 + l]
                                       : 0.0f;
      ZX_STAMP(1);
      if (ahead && s > 0) {
        // z = z' + H c of the window before (its rows below nb)
        const int nbp = rows_of(s - 1);
#pragma unroll
        for (int l = 0; l < B; ++l) {
          const float cl = __shfl_sync(FULL, cprev, l);
          if (l < nbp && lane < B)
            z = fmaf(cl, sums[TRIB + B + lane * B + l], z);
        }
      }
      ZX_STAMP(2);
      const float abar = aj + daj;
      float mine;
      switch (loss_id) {
        case sdca::HINGE:
          mine = window_updates<B, sdca::HINGE>(z, q, gcol, abar, yj, mj, g,
                                                scale, nb);
          break;
        case sdca::SMOOTH_HINGE:
          mine = window_updates<B, sdca::SMOOTH_HINGE>(z, q, gcol, abar, yj,
                                                       mj, g, scale, nb);
          break;
        case sdca::SQUARED:
          mine = window_updates<B, sdca::SQUARED>(z, q, gcol, abar, yj, mj,
                                                  g, scale, nb);
          break;
        default:
          mine = window_updates<B, sdca::ABSOLUTE>(z, q, gcol, abar, yj, mj,
                                                   g, scale, nb);
      }
      ZX_STAMP(3);
      cprev = scale * mine;
      // c and the row ids to the column warps
      if (lane < B) {
        cvec[(s & 1) * B + lane] = cprev;
        wid[(s & 1) * B + lane] = rj;
      }
      const float da_next = daj + mine;   // the row's, where nk <= B
      if (lane < nb) da[rj] = da_next;
      __syncwarp();
      if (lane == 0) mbar_arrive(cbar + (s & 1));
      ZX_STAMP(4);
      rj = rn;
      yj = yn;
      aj = an;
      mj = mn;
      daj = nw > 1 ? dan : da_next;
    }
    ZX_STAMP_CLOCK(1);
    ZX_STAMP_FLUSH(0, 5, 0, nwin);
  } else {
    // ---- the column warps: the partials a window ahead, in teams (or, in
    // column tiles, the window's own, all 7 warps a tile), then the update
    // with warp 0's c
    constexpr int NW_AHEAD = team_warps(tiles_of<NBLK>(true));
    const int n_tiles = tiles_of<NBLK>(ahead);
    const int nwarps = ahead ? NW_AHEAD : COL_WARPS;
    const int teams = COL_WARPS / nwarps;
    const int ct = tid - 32;           // the column thread
    const int team = ct / (32 * nwarps);
    const int tt = ct - 32 * nwarps * team;   // its index in its team
    int tile = 0;                      // the team's tiles so far
    ZX_STAMP_BEGIN(4);
    auto partials_of = [&](int n) {    // window n's, over its chunks
      for (int t = 0; t < nch; ++t) {
        const int ch = n * nch + t, sl = ch % ring;
        mbar_wait(full + sl, (ch / ring) & 1);
        ZX_STAMP(0);
        const float* sa = stages + sl * B * dt;
        // H's rows: the window before (window 0: itself, times c = 0)
        const float* sp = n > 0 ? stages + ((ch - 1) % ring) * B * dt : sa;
        const int c0 = t * dt, wd = max(0, min(dt, wr - c0));
        // the dots' u: with the lookahead the window before's start u
        const float* uc0 = u + (ahead && n > 0 ? ((n - 1) & 1) * dc : 0) + c0;
        const Exchange x{r, C, P, smem_addr(xb + (n % XBUFS) * C * P),
                         smem_addr(xbar + n % XBUFS), part};
        const bool first = t == 0, last = t == nch - 1;
        if (ahead) {
          if (team < teams)            // 7 % nwarps warps sit out
            team_tiles<B, NW_AHEAD>(sa, sp, dt, wd, uc0, tt, team, teams,
                                    n_tiles, red, tile, x, first, last);
        } else {
          team_tiles<B, COL_WARPS>(sa, sp, dt, wd, uc0, ct, 0, 1, n_tiles,
                                   red, tile, x, first, last);
          if (lane == 0) mbar_arrive(empty + sl);   // the update reads X
        }
        ZX_STAMP(1);
      }
    };
    for (int s = 0; s < nwin; ++s) {
      const int nb = rows_of(s);
      if (!ahead || s == 0) partials_of(s);
      if (ahead && s + 1 < nwin) partials_of(s + 1);
      // (d) u = u0 + X_B^T c, row after row in visit order; the window's
      // loop unrolled, so a column's B loads issue together
      mbar_wait(cbar + (s & 1), (s >> 1) & 1);
      ZX_STAMP(2);
      float cj[B];
#pragma unroll
      for (int j = 0; j < B; ++j) cj[j] = cvec[(s & 1) * B + j];
      if (ahead) {
        // from u0 (buffer s % 2) into the next window's u0 (the other one),
        // which the teams read after the barrier below
        const float* st = stages + (s % ring) * B * dt;
        const float* u0 = u + (s & 1) * dc;
        float* u1 = u + ((s + 1) & 1) * dc;
#pragma unroll 2
        for (int c = ct; c < wr; c += COL_THREADS) {
          float v = u0[c];
#pragma unroll
          for (int j = 0; j < B; ++j)
            if (j < nb) v = fmaf(cj[j], st[j * dt + c], v);
          u1[c] = v;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s % ring);   // the stage is free
        col_sync();
      } else {
        int ij[B];
#pragma unroll
        for (int j = 0; j < B; ++j) ij[j] = wid[(s & 1) * B + j];
        for (int t = 0; t < nch; ++t) {
          const int c0 = t * dt, wd = max(0, min(dt, wr - c0));
#pragma unroll 2
          for (int cl = ct; cl < wd; cl += COL_THREADS) {
            const int c = c0 + cl;
            float v = u[c];
#pragma unroll
            for (int j = 0; j < B; ++j)
              if (j < nb)
                v = fmaf(cj[j],
                         Xk[static_cast<size_t>(ij[j]) * d + c_lo + c], v);
            u[c] = v;
          }
        }
      }
      ZX_STAMP(3);
    }
    if (warp == 1) ZX_STAMP_FLUSH(5, 4, 1, nwin);
  }
  cluster.sync();                      // no peer sends to this block any more
  float* du_k = du + static_cast<size_t>(k) * d + c_lo;
  const float* uf = u + (ahead ? (nwin & 1) * dc : 0);   // the final u
  for (int c = tid; c < wr; c += BLOCK_THREADS) du_k[c] = uf[c] - w[c_lo + c];
}

template <int B>
cudaError_t configure(int C, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      local_sdca_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && C > PORTABLE_CLUSTER)
    err = cudaFuncSetAttribute(local_sdca_kernel<B>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

// a launch of n_clusters clusters of C blocks
cudaLaunchConfig_t config(int n_clusters, int C, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * C);
  cfg.blockDim = dim3(BLOCK_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// f(std::integral_constant<int, B>) for the kernel's windows (1, 2, 4, 8,
// 16, 32); an error for another B
template <class F>
cudaError_t with_rows(int B, F f) {
  switch (B) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes at a window of
// `block_rows` rows in a cluster of `cluster` blocks (the wrapper's
// dense_smem_budget restates this layout).
long long local_sdca_smem_bytes(int d, int block_rows, int cluster) {
  return dense_layout(d, block_rows, cluster).bytes;
}

// How many clusters of `cluster` blocks of this layout the card holds at
// once (cudaOccupancyMaxActiveClusters) into *out; 0 means such a cluster
// cannot be scheduled. Returns the cudaError_t (0 = ok).
int local_sdca_max_clusters(int d, int block_rows, int cluster, int* out) {
  *out = 0;
  if (cluster < 1 || cluster > MAX_CLUSTER || d < 1) return 0;
  const Layout L = dense_layout(d, block_rows, cluster);
  if (L.bytes > SMEM_LIMIT) return 0;
  const cudaError_t err = with_rows(block_rows, [&](auto b) {
    constexpr int B = decltype(b)::value;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(1, cluster, L.bytes, nullptr, &attr);
    cudaError_t e = configure<B>(cluster, L.bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(
          out, reinterpret_cast<const void*>(local_sdca_kernel<B>), &cfg);
    return e;
  });
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// Launch one round: K clusters of `cluster` blocks (1-16), one per worker,
// on `stream`, walking windows of `block_rows` (1, 2, 4, 8, 16 or 32)
// rows. dalpha is (cluster, K, nk), zeroed by the caller; rank 0's copy is
// the result. Returns the cudaError_t of the launch (0 = ok); a cluster the
// card cannot schedule is refused, never run another way.
int local_sdca_launch(const float* X, const float* y, const float* alpha,
                      const float* mask, const float* w, const int* perm,
                      float* dalpha, float* du, int K, int nk, int d,
                      int n_passes, float scale, int loss_id, float g,
                      int block_rows, int cluster, void* stream) {
  if (K < 1 || nk < 1 || d < 1 || n_passes < 0 || cluster < 1 ||
      cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = dense_layout(d, block_rows, cluster);
  if (L.bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  // bulk copies need 16-byte aligned rows and slices
  const int vec16 = d % 4 == 0 && reinterpret_cast<size_t>(X) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_rows(block_rows, [&](auto b) {
    constexpr int B = decltype(b)::value;
    cudaError_t e = configure<B>(cluster, L.bytes);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(K, cluster, L.bytes, s, &attr);
    return cudaLaunchKernelEx(&cfg, local_sdca_kernel<B>, X, y, alpha, mask,
                              w, perm, dalpha, du, K, nk, d, n_passes, scale,
                              loss_id, g, cluster, L.dc, L.dt, L.ring,
                              static_cast<int>(L.ahead), vec16);
  });
  if (err != cudaSuccess) {
    cudaGetLastError();   // a refused launch is not left for the next one
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* local_sdca_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
