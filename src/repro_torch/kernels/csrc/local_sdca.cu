// LocalSDCA over dense rows (paper Algorithm 2) for Hopper (sm_90a), as a
// windowed lookahead.
//
// Replaces the TPU kernel src/repro/kernels/local_sdca.py::_sdca_kernel
// (entry local_sdca_pallas, pallas_call at :127), which ran one worker's
// walk as a sequential (pass, row block) grid with u and dalpha in VMEM,
// vmapped over the K workers.
//
// What it computes, per worker k (one thread block each), for n_passes
// passes over its nk rows in the order perm[k, :]:
//     i = perm[k, j];  x = X[k, i, :]
//     z = x . u;  q = scale * ||x||^2;  abar = alpha[k, i] + dalpha[k, i]
//     delta = cd_update(abar, z, q, y[k, i]) * mask[k, i]
//     dalpha[k, i] += delta;  u += scale * delta * x
// from u = w, and emits du[k, :] = u - w.
//
// What bounds it on this card: the walk is a chain of nk * n_passes
// dependent steps per worker -- every step reads the u the previous step
// wrote. X is read once per pass (K*nk*d*4 bytes, 0.96 ms at 3.35 TB/s for
// epsilon's 400k x 2000), but a step done one row at a time pays a row
// load from device memory, a block reduction and a serial scalar update
// (the first port: 3.04 us a step, 160x the bytes). Only K of the 132 SMs
// have work.
//
// What the design does about it: it takes B rows of the visit order at a
// time (a window) and moves the d-long work off the chain. The step reads
// u only through z_j = x_j . u, and every update is rank one along its own
// row, so from u0 = the u at the window's start
//     z_j = x_j . u0 + sum_{l<j} c_l G_lj,   G = X_B X_B^T,  c_l = scale d_l
//     q_j = scale G_jj;   afterwards u = u0 + X_B^T c
// -- in exact arithmetic the same walk, row for row; only the order of the
// float additions changes. The wrapper hoists the conjugate map, so the
// walk is linear in u and this holds under every dense configuration. A
// window runs in four parts:
//  (a) load: the window's rows stream into a two-stage shared-memory ring
//      by cp.async, one stage ahead (16-byte copies where d % 4 == 0 and X
//      is 16-byte aligned, 4-byte copies otherwise); where B rows do not
//      fit a stage the rows are cut into column tiles (d_tile) and the
//      stream runs over (window, tile) chunks. The next window's rows are
//      copied by warps 1-7 while warp 0 runs (c): issuing a copy from a
//      random row of X stalls the issuing warp, and there the other warps
//      have nothing else to do (issued by all threads at the window's
//      start, the copies cost 8.6 ms of a 30.3 ms round at epsilon's
//      shape, tools/sdca_step_ablation.py; a window's later tiles are
//      copied at the start of the tile before). Row ids come from perm
//      three windows ahead, by cp.async into a ring of four id slots. The
//      rows' y, alpha, mask and dalpha are loaded at the window's start by
//      one lane of warp 0 each, and their latency hides behind (b);
//  (b) dots: all 256 threads compute z0 = X_B u0 and the lower triangle of
//      G with its diagonal, in float32 FMA (no tensor cores: TF32 would
//      round G), in register tiles of RB x RB rows (RB = min(B, 8)), each
//      thread over its own columns; a tile's partials are reduced across
//      the warp by recursive halving (each shuffle level halves the values
//      a lane holds) and across the 8 warps through shared memory in a
//      fixed order, so the result does not depend on timing;
//  (c) scalar loop: warp 0 alone runs the window's updates in order; lane
//      j keeps z_j and its column of G in registers, every lane runs
//      cd_update on its own row, and after step l the lane l's c_l goes to
//      all lanes by __shfl_sync and each lane j > l adds c_l G_lj. No block
//      barrier inside the loop; lane j stores dalpha of row j;
//  (d) update: all threads apply u = fma(c_j, x_j, u) for j = 0 .. nb-1 in
//      visit order, from the staged rows, or from device memory (the rows
//      are then in L2, just streamed) when they were cut into column tiles.
// A window costs a fixed number of block barriers (2 + chunks x (1 +
// tiles)), whatever its d.
//
// Hazards:
//  * Windows never cross a pass boundary: a row visited at the end of pass
//    p and again near the start of pass p + 1 must see its own delta in
//    dalpha and in u. Windows are cut per pass; the last window of a pass
//    has nb = nk - its start rows when B does not divide nk. Within one
//    pass a row appears once, so within a window no row is visited twice.
//  * dalpha is read at the window's start, after the barrier that ends the
//    previous window (whose warp 0 wrote it), never earlier.
//  * Stage rows past nb hold stale words; they feed only G and z0 entries
//    of rows past nb, which the scalar loop and the update never read.
//  * Masked padding rows (delta = 0 by the mask) and all-zero rows (q = 0,
//    the guarded no-op) give c = 0, and u = fma(0, x, u) leaves u exactly.
//  * A stage is refilled one chunk after it was read: chunk n + 1 is
//    copied into the stage of chunk n - 1 after the barrier that opens
//    chunk n (inside a window) or ends chunk n's dots (the next window's
//    first chunk), so the dots and the update of chunk n - 1 are done and
//    the update of chunk n reads the other stage. Every thread waits for
//    all its copies (wait_group 0) before the barrier that opens a chunk.
//    The id slot of window s + 3 is written at window s's
//    first chunk, after window s - 1, its last user, ended at a barrier.
//  * Small d (covtype's 54 < 256 threads): threads past d own no column
//    and add zeros.
//  * Shared memory (the wrapper's dense_smem_budget): u, the two stages of
//    B x d_tile floats, G (B x B), z0 and c (B each), two reduction buffers
//    (2 x 8 x 64) and four id slots of B, within 232,448 bytes.

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RED_WORDS = 64;        // per warp and buffer: a tile's values
constexpr int ID_SLOTS = 4;          // windows of row ids in flight
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) & ~3;
}

// words of dynamic shared memory, in layout order
__host__ __device__ __forceinline__ long long smem_words(int d, int B,
                                                         int d_tile) {
  return static_cast<long long>(round4(d))          // u
         + 2LL * B * d_tile                          // the row ring
         + static_cast<long long>(B) * B             // G
         + 2LL * B                                   // z0, c
         + 2LL * WARPS * RED_WORDS                   // reduction buffers
         + static_cast<long long>(ID_SLOTS) * B;     // row ids
}

// values one tile reduces: the lower triangle and z0 on a diagonal tile,
// RB x RB off it; padded to a multiple of 32 for the recursive halving
template <int RB, bool DIAG>
struct TileShape {
  static constexpr int N = DIAG ? RB * (RB + 1) / 2 + RB : RB * RB;
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

// One tile of the window's Gram (rows I*RB.., J*RB..) over this chunk's
// columns: every thread's partials, then the warp's sums into
// red[warp][M lane + k], then after a barrier threads t < N sum the 8
// warps in order into G (or z0) -- assigned on the window's first chunk,
// added on later ones.
template <int B, int RB, bool DIAG>
__device__ __forceinline__ void gram_tile(const float* st, int dts, int w,
                                          const float* uc0, int I, int J,
                                          float* red, float* G, float* z0,
                                          bool first) {
  using S = TileShape<RB, DIAG>;
  float acc[S::NP];
#pragma unroll
  for (int p = 0; p < S::NP; ++p) acc[p] = 0.0f;
  for (int cl = threadIdx.x; cl < w; cl += THREADS) {
    float a[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) a[i] = st[(I * RB + i) * dts + cl];
    if (DIAG) {
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
      for (int k = 0; k < RB; ++k) b[k] = st[(J * RB + k) * dts + cl];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
#pragma unroll
        for (int k = 0; k < RB; ++k)
          acc[i * RB + k] = fmaf(a[i], b[k], acc[i * RB + k]);
      }
    }
  }
  warp_halve<S::NP>(acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < S::M; ++k)
    red[warp * RED_WORDS + S::M * lane + k] = acc[k];
  __syncthreads();
  const int t = threadIdx.x;
  if (t < S::N) {
    float s = 0.0f;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) s += red[v * RED_WORDS + t];
    float* dst;
    if (DIAG) {
      constexpr int TRI = RB * (RB + 1) / 2;
      if (t < TRI) {
        int i = 0, rest = t;
        while (rest >= RB - i) rest -= RB - i++;
        dst = G + (I * RB + i) * B + I * RB + i + rest;
      } else {
        dst = z0 + I * RB + (t - TRI);
      }
    } else {
      dst = G + (I * RB + t / RB) * B + J * RB + t % RB;
    }
    *dst = first ? s : *dst + s;
  }
}

template <int B>
__global__ void __launch_bounds__(THREADS, 1)
local_sdca_kernel(const float* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ alpha,
                  const float* __restrict__ mask,
                  const float* __restrict__ w, const int* __restrict__ perm,
                  float* __restrict__ dalpha, float* __restrict__ du, int nk,
                  int d, int n_passes, float scale, int loss_id, float g,
                  int d_tile, int vec4) {
  constexpr int RB = B < 8 ? B : 8;
  constexpr int NBLK = B / RB;
  extern __shared__ __align__(16) unsigned char smem[];
  float* u = reinterpret_cast<float*>(smem);
  float* ring = u + round4(d);
  float* G = ring + 2 * B * d_tile;
  float* z0 = G + B * B;
  float* cvec = z0 + B;
  float* red = cvec + B;
  int* rid = reinterpret_cast<int*>(red + 2 * WARPS * RED_WORDS);

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row0 = static_cast<size_t>(k) * nk;   // first row of worker k
  const float* Xk = X + row0 * d;
  const int* perm_k = perm + row0;
  const int nw = (nk + B - 1) / B;                   // windows a pass
  const int nwin = n_passes * nw;
  const int nch = (d + d_tile - 1) / d_tile;         // column chunks a window
  const int nchunks = nwin * nch;

  auto rows_of = [&](int s) { return min(B, nk - (s % nw) * B); };
  auto load_ids = [&](int s, bool async) {            // window s's row ids
    if (s < nwin && tid < rows_of(s)) {
      const int* src = perm_k + (s % nw) * B + tid;
      int* dst = rid + (s % ID_SLOTS) * B + tid;
      if (async) cp_async4(dst, src); else *dst = *src;
    }
  };
  // stage n % 2 <- chunk n: rows of window n / nch, columns of tile n % nch,
  // by the threads t0 .. THREADS - 1
  auto fill = [&](int n, int t0) {
    if (n >= nchunks) return;
    const int s = n / nch, c0 = (n % nch) * d_tile;
    const int nb = rows_of(s), wd = min(d_tile, d - c0);
    const int* ids = rid + (s % ID_SLOTS) * B;
    float* st = ring + (n & 1) * B * d_tile;
    for (int j = 0; j < nb; ++j) {
      const float* src = Xk + static_cast<size_t>(ids[j]) * d + c0;
      float* dst = st + j * d_tile;
      if (vec4) {
        for (int c = 4 * (tid - t0); c < wd; c += 4 * (THREADS - t0))
          cp_async16(dst + c, src + c);
      } else {
        for (int c = tid - t0; c < wd; c += THREADS - t0)
          cp_async4(dst + c, src + c);
      }
    }
  };

  for (int c = tid; c < d; c += THREADS) u[c] = w[c];
  for (int s = 0; s < ID_SLOTS - 1; ++s) load_ids(s, false);
  __syncthreads();
  fill(0, 0);
  cp_async_commit();

  for (int s = 0; s < nwin; ++s) {
    const int nb = rows_of(s);
    const int* ids = rid + (s % ID_SLOTS) * B;
    // (a) this window's scalars, one lane of warp 0 each; used in (c)
    int r = 0;
    float yj = 0.0f, aj = 0.0f, mj = 0.0f, daj = 0.0f;
    if (warp == 0 && lane < nb) {
      r = ids[lane];
      yj = y[row0 + r];
      aj = alpha[row0 + r];
      mj = mask[row0 + r];
      daj = dalpha[row0 + r];
    }
    // (b) z0 and G over the window's column chunks
    for (int t = 0; t < nch; ++t) {
      const int n = s * nch + t;
      cp_async_wait<0>();
      __syncthreads();                // chunk n (and u, ids) published
      if (t + 1 < nch) fill(n + 1, 0);           // the window's next tile
      if (t == 0) load_ids(s + ID_SLOTS - 1, true);
      cp_async_commit();
      const float* st = ring + (n & 1) * B * d_tile;
      const int c0 = t * d_tile, wd = min(d_tile, d - c0);
      int tile = 0;
#pragma unroll
      for (int I = 0; I < NBLK; ++I) {
        gram_tile<B, RB, true>(st, d_tile, wd, u + c0, I, I,
                               red + (tile++ & 1) * WARPS * RED_WORDS, G, z0,
                               t == 0);
#pragma unroll
        for (int J = I + 1; J < NBLK; ++J)
          gram_tile<B, RB, false>(st, d_tile, wd, u + c0, I, J,
                                  red + (tile++ & 1) * WARPS * RED_WORDS, G,
                                  z0, t == 0);
      }
    }
    __syncthreads();                  // G and z0 complete
    // the next window's first chunk, by warps 1-7 while warp 0 runs (c):
    // a copy from a random row stalls the warp that issues it
    if (warp != 0) {
      fill((s + 1) * nch, 32);
      cp_async_commit();
    }
    // (c) the window's updates in order, on warp 0
    if (warp == 0) {
      float z = 0.0f, q = 0.0f, gcol[B];
      if (lane < B) {
        z = z0[lane];
        q = scale * G[lane * B + lane];
      }
#pragma unroll
      for (int l = 0; l < B; ++l)
        gcol[l] = l < lane && lane < B ? G[l * B + lane] : 0.0f;
      const float abar = aj + daj;
      float mine = 0.0f;
#pragma unroll
      for (int l = 0; l < B; ++l) {
        if (l < nb) {
          const float dl = sdca::cd_update(loss_id, g, abar, z, q, yj) * mj;
          const float cl = __shfl_sync(FULL, scale * dl, l);
          if (lane == l) mine = dl;
          if (lane > l) z = fmaf(cl, gcol[l], z);
        }
      }
      if (lane < nb) dalpha[row0 + r] = daj + mine;
      if (lane < B) cvec[lane] = lane < nb ? scale * mine : 0.0f;
    }
    __syncthreads();                  // c published
    // (d) u = u0 + X_B^T c, row after row in visit order; the window's
    // loop unrolled, so a column's B loads issue together
    float cj[B];
#pragma unroll
    for (int j = 0; j < B; ++j) cj[j] = cvec[j];
    if (nch == 1) {
      const float* st = ring + ((s * nch) & 1) * B * d_tile;
#pragma unroll 2
      for (int c = tid; c < d; c += THREADS) {
        float v = u[c];
#pragma unroll
        for (int j = 0; j < B; ++j)
          if (j < nb) v = fmaf(cj[j], st[j * d_tile + c], v);
        u[c] = v;
      }
    } else {
#pragma unroll 2
      for (int c = tid; c < d; c += THREADS) {
        float v = u[c];
#pragma unroll
        for (int j = 0; j < B; ++j)
          if (j < nb)
            v = fmaf(cj[j], Xk[static_cast<size_t>(ids[j]) * d + c], v);
        u[c] = v;
      }
    }
    __syncthreads();                  // u and the stage free for reuse
  }
  cp_async_wait<0>();
  float* du_k = du + static_cast<size_t>(k) * d;
  for (int c = tid; c < d; c += THREADS) du_k[c] = u[c] - w[c];
}

template <int B>
int launch(int K, size_t smem, cudaStream_t stream, const float* X,
           const float* y, const float* alpha, const float* mask,
           const float* w, const int* perm, float* dalpha, float* du, int nk,
           int d, int n_passes, float scale, int loss_id, float g,
           int d_tile, int vec4) {
  cudaError_t err = cudaFuncSetAttribute(
      local_sdca_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  local_sdca_kernel<B><<<K, THREADS, smem, stream>>>(
      X, y, alpha, mask, w, perm, dalpha, du, nk, d, n_passes, scale,
      loss_id, g, d_tile, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes (the wrapper's
// dense_smem_budget restates this layout).
long long local_sdca_smem_bytes(int d, int block_rows, int d_tile) {
  return 4 * smem_words(d, block_rows, d_tile);
}

// Launch one round: K blocks, one per worker, on `stream`, walking windows
// of `block_rows` (1, 2, 4, 8, 16 or 32) rows with the rows cut into
// column tiles of `d_tile` floats (a multiple of 4; d_tile >= d: whole
// rows). dalpha must be zeroed by the caller. Returns the cudaError_t of
// the launch (0 = ok).
int local_sdca_launch(const float* X, const float* y, const float* alpha,
                      const float* mask, const float* w, const int* perm,
                      float* dalpha, float* du, int K, int nk, int d,
                      int n_passes, float scale, int loss_id, float g,
                      int block_rows, int d_tile, void* stream) {
  if (d_tile < 4 || d_tile % 4 != 0 || nk < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d_tile > round4(d)) d_tile = round4(d);
  const size_t smem = static_cast<size_t>(local_sdca_smem_bytes(
      d, block_rows, d_tile));
  // 16-byte copies need rows and tiles on 16-byte boundaries
  const int vec4 = d % 4 == 0 && reinterpret_cast<size_t>(X) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LOCAL_SDCA_CASE(B)                                                 \
  case B:                                                                  \
    return launch<B>(K, smem, s, X, y, alpha, mask, w, perm, dalpha, du,   \
                     nk, d, n_passes, scale, loss_id, g, d_tile, vec4);
  switch (block_rows) {
    LOCAL_SDCA_CASE(1)
    LOCAL_SDCA_CASE(2)
    LOCAL_SDCA_CASE(4)
    LOCAL_SDCA_CASE(8)
    LOCAL_SDCA_CASE(16)
    LOCAL_SDCA_CASE(32)
  }
#undef LOCAL_SDCA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* local_sdca_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
