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
// What bounds it on this card: the bytes are the streams only,
// (3 di + 2 N) S B 4 (x, dt, y per channel; B and C once per batch), and
// the work is an exp and a few FMAs per (b, t, c, n) -- at falcon-mamba's
// shapes (di 8192, N 16, S 2048) both are tens of microseconds, but every
// step of a channel depends on the one before it, so the time is S steps
// of one (b, c) chain each, with only B * di * N lanes of parallelism.
//
// What the design does about it: one lane per (b, c, n), so the state h
// never leaves a register and the N = 16 lanes of a channel sit in one
// half warp, where y's sum over n is four shuffles; a block holds 16
// channels (256 threads) and the grid is (di / 16, B), so falcon-mamba's
// 8192 channels give 512 blocks, all resident at once. x and dt for 64
// steps x 16 channels, and B and C for the same 64 steps, are staged in
// shared memory with coalesced loads; y goes back the same way. Lanes
// n >= N hold h = 0 and add nothing.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 16;            // state lanes per channel: N <= 16
constexpr int CH = 16;               // channels per block
constexpr int THREADS = CH * LANES;  // 256
constexpr int TT = 64;               // time steps staged per chunk

__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ D,
                float* __restrict__ y, int S, int di, int N) {
  __shared__ float xs[TT][CH];
  __shared__ float dts[TT][CH];
  __shared__ float ys[TT][CH];
  __shared__ float Bs[TT][LANES];
  __shared__ float Cs[TT][LANES];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int cl = tid / LANES;        // channel within the block
  const int n = tid % LANES;         // state index
  const int c = c0 + cl;
  const bool live = n < N && c < di;
  const float a = live ? A[static_cast<size_t>(c) * N + n] : 0.0f;
  const float dpar = c < di ? D[c] : 0.0f;
  const size_t xoff = static_cast<size_t>(b) * S * di;
  const size_t noff = static_cast<size_t>(b) * S * N;

  float h = 0.0f;
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int tn = min(TT, S - t0);
    __syncthreads();                 // last chunk's ys written out
    for (int i = tid; i < TT * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH;
      const bool in = tt < tn && c0 + cc < di;
      const size_t off = xoff + static_cast<size_t>(t0 + tt) * di + c0 + cc;
      xs[tt][cc] = in ? x[off] : 0.0f;
      dts[tt][cc] = in ? dt[off] : 0.0f;
    }
    for (int i = tid; i < TT * LANES; i += THREADS) {
      const int tt = i / LANES, nn = i % LANES;
      const bool in = tt < tn && nn < N;
      const size_t off = noff + static_cast<size_t>(t0 + tt) * N + nn;
      Bs[tt][nn] = in ? Bm[off] : 0.0f;
      Cs[tt][nn] = in ? Cm[off] : 0.0f;
    }
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      const float xv = xs[tt][cl];
      const float dv = dts[tt][cl];
      h = expf(dv * a) * h + (dv * xv) * Bs[tt][n];
      float yp = h * Cs[tt][n];
      yp += __shfl_xor_sync(0xffffffffu, yp, 8);
      yp += __shfl_xor_sync(0xffffffffu, yp, 4);
      yp += __shfl_xor_sync(0xffffffffu, yp, 2);
      yp += __shfl_xor_sync(0xffffffffu, yp, 1);
      if (n == 0) ys[tt][cl] = yp + dpar * xv;
    }
    __syncthreads();
    for (int i = tid; i < TT * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH;
      if (tt < tn && c0 + cc < di)
        y[xoff + static_cast<size_t>(t0 + tt) * di + c0 + cc] = ys[tt][cc];
    }
  }
}

}  // namespace

extern "C" {

// x, dt, y (B, S, di); Bm, Cm (B, S, N); A (di, N); D (di,): contiguous
// float32, N <= 16. Launches on `stream`; returns the cudaError_t of the
// launch (0 = ok).
int ssm_scan_launch(const float* x, const float* dt, const float* Bm,
                    const float* Cm, const float* A, const float* D,
                    float* y, int B, int S, int di, int N, void* stream) {
  if (N < 1 || N > LANES) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((di + CH - 1) / CH, B);
  ssm_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dt, Bm, Cm, A, D, y, S, di, N);
  return static_cast<int>(cudaGetLastError());
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
