// Fused mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::_scan_kernel
// (entry ssm_scan_pallas, pallas_call at :78), which ran the sequential
// time loop per (batch, block_d channel block) with h in VMEM scratch.
//
// What it computes, in float32, for every batch b and channel c < di, from
// h = 0, for t = 0 .. S-1:
//     h[n] = exp(dt[b,t,c] A[c,n]) h[n] + (dt[b,t,c] x[b,t,c]) B[b,t,n]
//     y[b,t,c] = sum_n h[n] C[b,t,n] + D[c] x[b,t,c]
//
// What bounds it on this card. Bytes: the streams, (3 di + 2 N) S B 4
// (x, dt, y per channel; B and C once per batch), 202 MB at falcon-mamba's
// scoring shape (B 1, S 2,048, di 8,192, N 16): 0.060 ms at 3.35 TB/s.
// The exps: S B di N = 268 M, one MUFU.EX2 each at 16 a clock per SM,
// 0.064 ms at 1.98 GHz. What holds it in practice is instruction issue,
// most of it FP32: an element (b, t, c, n) takes ~14 instructions, ~10
// of them FP32 (dt a; expf's range reduction and scaling, 6; dx B, the h
// FMA, the y FMA), and each FP32 instruction an element costs ~1.5
// clocks a scheduler (tools/scan_ablation.py splits a launch; PERF.md
// section 6). The t loop of a (b, c, n) chain is one FMA a step: h does
// not feed the exp.
//
// What the design does about it:
//  * A thread owns one channel and G states (G = 4, 8 or 16 by template,
//    4 the default); a block is 32 channels (one a lane) times
//    ceil(N / G) warps, warp q holding states q G .. q G + G - 1. h[G] and
//    A's G values stay in registers. x_t and dt_t are read once per thread
//    and step (each lane its own channel, no broadcast re-reads), B_t and
//    C_t as vectors that every lane of a warp reads at one address.
//  * A thread takes STEPS steps at a time: their shared-memory reads
//    first, then their STEPS G exps and recurrences, then their partials.
//  * y's sum over n is summed in registers over a thread's G states (the
//    first warp's starting from D x); the ceil(N / G) partials of a
//    channel go to shared memory, not through shuffles, and are summed
//    when the chunk's y is stored as 16-byte vectors, a warp writing four
//    whole 128-byte rows.
//  * The streams are staged in chunks of T = 64 steps (x, dt: T x 32
//    channels; B, C: T x 16) by cp.async into two stages, and the
//    partials into two plane sets: at the one barrier a chunk, chunk
//    k + 1's copies go out and chunk k - 1's y is stored while the warps
//    run chunk k, so the block waits on device memory only for the first
//    chunk. Slots past S
//    or di are zero-filled by the copy, so the recurrence never reads
//    stale shared memory. 16-byte copies where rows allow (di % 4 == 0 for
//    x and dt, N % 4 == 0 for B and C, 16-byte aligned bases), 4-byte ones
//    elsewhere.
//  * At B 1 and di 8,192 the grid is 256 blocks of 128 threads (G = 4),
//    two blocks (2 x 112 KB of shared memory) and 8 warps an SM; a
//    thread's STEPS G exps, which do not depend on h, supply the
//    independent work in place of occupancy. G = 8 and 16 (fewer warps)
//    ran slower, and so did G = 2 (more warps, more instructions an
//    element; not kept); so did chunks of 32 and 128 steps
//    (tools/scan_ablation.py sweeps them as source variants).
//  * expf stays: exp2f of a pre-scaled A, which drops the range
//    reduction, is measured in the ablation and not taken.
//
// Lanes past di and states past N hold A = 0 and read zeros, so they add
// nothing; their y is not stored.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_STATE = 16;        // N <= 16; B and C rows padded to 16
constexpr int CH = 32;               // channels per block: one per lane
constexpr int STEPS = 4;             // time steps a thread takes per batch
constexpr int T = 64;                // time steps a chunk

// The G instances (states a thread) the library holds.
#define SSM_SCAN_GROUPS(X) X(4) X(8) X(16)

__host__ __device__ constexpr int n_groups(int N, int G) {
  return (N + G - 1) / G;
}

// Shared memory of one block, in floats: two stages of x, dt (T x CH) and
// B, C (T x MAX_STATE), then two sets of ceil(N / G) planes of y partials
// (T x CH): one being written, one being stored.
constexpr int STAGE_FLOATS = 2 * T * CH + 2 * T * MAX_STATE;
__host__ __device__ constexpr long long smem_floats(int N, int G) {
  return 2LL * STAGE_FLOATS + 2LL * n_groups(N, G) * T * CH;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copies of steps t0 .. t0 + T - 1 (tn of them real) into a
// stage. Out-of-range slots get zeros; the source address of a zero-fill
// is the array's base, never read.
__device__ __forceinline__ void load_chunk(
    float* stage, const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm, size_t xrow,
    size_t nrow, int tn, int c0, int di, int N, bool vec_x, bool vec_bc,
    int tid, int nthreads) {
  float* xs = stage;
  float* dts = xs + T * CH;
  float* Bs = dts + T * CH;
  float* Cs = Bs + T * MAX_STATE;
  if (vec_x) {
    for (int i = tid; i < T * (CH / 4); i += nthreads) {
      const int tt = i / (CH / 4), cc = (i % (CH / 4)) * 4;
      const bool in = tt < tn && c0 + cc < di;   // di % 4 == 0: all 4 in
      const size_t off = in ? xrow + static_cast<size_t>(tt) * di + c0 + cc
                            : 0;
      cp_async16(xs + tt * CH + cc, x + off, in);
      cp_async16(dts + tt * CH + cc, dt + off, in);
    }
  } else {
    for (int i = tid; i < T * CH; i += nthreads) {
      const int tt = i / CH, cc = i % CH;
      const bool in = tt < tn && c0 + cc < di;
      const size_t off = in ? xrow + static_cast<size_t>(tt) * di + c0 + cc
                            : 0;
      cp_async4(xs + i, x + off, in);
      cp_async4(dts + i, dt + off, in);
    }
  }
  if (vec_bc) {
    const int n4 = N / 4;
    for (int i = tid; i < T * n4; i += nthreads) {
      const int tt = i / n4, nn = (i % n4) * 4;
      const bool in = tt < tn;
      const size_t off = in ? nrow + static_cast<size_t>(tt) * N + nn : 0;
      cp_async16(Bs + tt * MAX_STATE + nn, Bm + off, in);
      cp_async16(Cs + tt * MAX_STATE + nn, Cm + off, in);
    }
  } else {
    for (int i = tid; i < T * N; i += nthreads) {
      const int tt = i / N, nn = i % N;
      const bool in = tt < tn;
      const size_t off = in ? nrow + static_cast<size_t>(tt) * N + nn : 0;
      cp_async4(Bs + tt * MAX_STATE + nn, Bm + off, in);
      cp_async4(Cs + tt * MAX_STATE + nn, Cm + off, in);
    }
  }
}

// G consecutive floats of a B or C row, as 16-byte vectors (p is G-aligned,
// rows are 16-aligned).
template <int G>
__device__ __forceinline__ void load_states(const float* p, float (&v)[G]) {
  static_assert(G % 4 == 0, "states a thread: a multiple of 4");
#pragma unroll
  for (int k = 0; k < G / 4; ++k) {
    const float4 f = *reinterpret_cast<const float4*>(p + 4 * k);
    v[4 * k] = f.x;
    v[4 * k + 1] = f.y;
    v[4 * k + 2] = f.z;
    v[4 * k + 3] = f.w;
  }
}

// U steps t .. t + U - 1 of a thread's G states: every shared-memory read
// of the U steps first, then the U steps' exps and recurrences (U G
// independent exp chains), then the U partials of y (dq = D[c] in the
// first warp, 0 in the others). Loads of the next batch cannot pass this
// batch's stores (both are shared memory), so a batch pays one load
// latency, not one a step.
template <int G, int U>
__device__ __forceinline__ void scan_steps(
    const float* xs, const float* dts, const float* Bs, const float* Cs,
    float* yq, int t, int lane, int q, float dq, const float (&a)[G],
    float (&h)[G]) {
  float xv[U], dv[U], bv[U][G], cv[U][G];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    xv[u] = xs[(t + u) * CH + lane];
    dv[u] = dts[(t + u) * CH + lane];
    const int o = (t + u) * MAX_STATE + q * G;
    load_states<G>(Bs + o, bv[u]);
    load_states<G>(Cs + o, cv[u]);
  }
  float yp[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float dx = dv[u] * xv[u];
    float acc = dq * xv[u];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      h[g] = fmaf(expf(dv[u] * a[g]), h[g], dx * bv[u][g]);
      acc = fmaf(h[g], cv[u][g], acc);
    }
    yp[u] = acc;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) yq[(t + u) * CH + lane] = yp[u];
}

// y for steps t0 .. t0 + tn - 1 of the block's 32 channels: the nq
// partials of each (t, c) summed (the first holds D x already), stored as
// 16-byte vectors where rows allow.
__device__ __forceinline__ void store_y(const float* ys, float* __restrict__ y,
                                        size_t yrow, int tn, int nq, int c0,
                                        int di, int vec_y, int tid,
                                        int nthreads) {
  if (vec_y) {
    const int oc = 4 * (tid % (CH / 4));   // the same every turn
    if (c0 + oc >= di) return;             // di % 4 == 0: all 4 or none
    for (int i = tid; i < tn * (CH / 4); i += nthreads) {
      const int tt = i / (CH / 4);
      float4 v = *reinterpret_cast<const float4*>(ys + tt * CH + oc);
      for (int p = 1; p < nq; ++p) {
        const float4 w =
            *reinterpret_cast<const float4*>(ys + (p * T + tt) * CH + oc);
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      *reinterpret_cast<float4*>(y + yrow + static_cast<size_t>(tt) * di +
                                 oc) = v;
    }
  } else {
    for (int i = tid; i < tn * CH; i += nthreads) {
      const int tt = i / CH, cc = i % CH;
      if (c0 + cc >= di) continue;
      float v = ys[tt * CH + cc];
      for (int p = 1; p < nq; ++p) v += ys[(p * T + tt) * CH + cc];
      y[yrow + static_cast<size_t>(tt) * di + cc] = v;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(CH * (MAX_STATE / G))
ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ D,
                float* __restrict__ y, int S, int di, int N, int vec_x,
                int vec_bc, int vec_y) {
  extern __shared__ __align__(16) float smem[];
  const int nq = n_groups(N, G);
  const int nthreads = nq * CH;
  const int tid = threadIdx.x, lane = tid % 32, q = tid / 32;
  const int b = blockIdx.y, c0 = blockIdx.x * CH, c = c0 + lane;
  float* ys = smem + 2 * STAGE_FLOATS;       // two sets of nq planes
  const int plane_set = nq * T * CH;
  const size_t xrow = static_cast<size_t>(b) * S * di;
  const size_t nrow = static_cast<size_t>(b) * S * N;
  const int nchunks = (S + T - 1) / T;

  // B and C rows hold N of 16 slots; the rest stay 0 for every chunk
  if (N < MAX_STATE) {
    for (int s = 0; s < 2; ++s) {
      float* bc = smem + s * STAGE_FLOATS + 2 * T * CH;
      for (int i = tid; i < 2 * T * MAX_STATE; i += nthreads) bc[i] = 0.0f;
    }
    __syncthreads();
  }
  load_chunk(smem, x, dt, Bm, Cm, xrow, nrow, min(T, S), c0, di, N, vec_x,
             vec_bc, tid, nthreads);
  cp_async_commit();

  float a[G], h[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int n = q * G + g;
    a[g] = n < N && c < di ? A[static_cast<size_t>(c) * N + n] : 0.0f;
    h[g] = 0.0f;
  }
  // D x enters y through the first warp's partial
  const float dq = q == 0 && c < di ? D[c] : 0.0f;

  // Chunk k: its copies landed and chunk k-1's partials are complete at
  // the barrier; chunk k+1's copies go into chunk k-1's stage; chunk k-1's
  // y is stored while other warps already run chunk k, whose partials go
  // to the other plane set. One barrier a chunk.
  for (int k = 0; k < nchunks; ++k) {
    const int t0 = k * T, tn = min(T, S - t0);
    cp_async_wait_all();
    __syncthreads();
    if (k + 1 < nchunks) {
      load_chunk(smem + ((k + 1) & 1) * STAGE_FLOATS, x, dt, Bm, Cm,
                 xrow + static_cast<size_t>(t0 + T) * di,
                 nrow + static_cast<size_t>(t0 + T) * N, min(T, S - t0 - T),
                 c0, di, N, vec_x, vec_bc, tid, nthreads);
      cp_async_commit();
    }
    if (k > 0) {
      store_y(ys + ((k - 1) & 1) * plane_set, y,
              xrow + static_cast<size_t>(t0 - T) * di + c0, T, nq, c0,
              di, vec_y, tid, nthreads);
    }
    const float* xs = smem + (k & 1) * STAGE_FLOATS;
    const float* dts = xs + T * CH;
    const float* Bs = dts + T * CH;
    const float* Cs = Bs + T * MAX_STATE;
    float* yq = ys + (k & 1) * plane_set + q * T * CH;
    int tt = 0;
    for (; tt + STEPS <= tn; tt += STEPS) {
      scan_steps<G, STEPS>(xs, dts, Bs, Cs, yq, tt, lane, q, dq, a, h);
    }
    for (; tt < tn; ++tt) {
      scan_steps<G, 1>(xs, dts, Bs, Cs, yq, tt, lane, q, dq, a, h);
    }
  }
  __syncthreads();
  const int last = nchunks - 1;
  store_y(ys + (last & 1) * plane_set, y,
          xrow + static_cast<size_t>(last) * T * di + c0, S - last * T, nq,
          c0, di, vec_y, tid, nthreads);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int G>
int launch(const float* x, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* D, float* y, int B, int S, int di,
           int N, cudaStream_t stream) {
  auto kernel = ssm_scan_kernel<G>;
  const long long bytes = 4 * smem_floats(N, G);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) {          // two 112 KB blocks an SM at G = 4
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_x = di % 4 == 0 && aligned16(x) && aligned16(dt);
  const int vec_bc = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  const int vec_y = di % 4 == 0 && aligned16(y);
  const dim3 grid((di + CH - 1) / CH, B);
  kernel<<<grid, n_groups(N, G) * CH, bytes, stream>>>(
      x, dt, Bm, Cm, A, D, y, S, di, N, vec_x, vec_bc, vec_y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block takes at (N, G); -1 for a G the
// library does not hold or an N outside [1, 16].
long long ssm_scan_smem_bytes(int N, int G) {
  if (N < 1 || N > MAX_STATE) return -1;
#define SSM_SCAN_CASE(g) \
  if (G == g) return 4 * smem_floats(N, g);
  SSM_SCAN_GROUPS(SSM_SCAN_CASE)
#undef SSM_SCAN_CASE
  return -1;
}

// x, dt, y (B, S, di); Bm, Cm (B, S, N); A (di, N); D (di,): contiguous
// float32, 1 <= N <= 16; G states a thread, an instance the library
// holds. Launches on `stream`; returns the cudaError_t of the launch
// (0 = ok).
int ssm_scan_launch(const float* x, const float* dt, const float* Bm,
                    const float* Cm, const float* A, const float* D,
                    float* y, int B, int S, int di, int N, int G,
                    void* stream) {
  if (N < 1 || N > MAX_STATE) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSM_SCAN_CASE(g) \
  if (G == g) return launch<g>(x, dt, Bm, Cm, A, D, y, B, S, di, N, st);
  SSM_SCAN_GROUPS(SSM_SCAN_CASE)
#undef SSM_SCAN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
