// Causal GQA flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (entry flash_attention, pallas_call at :114), which walked a sequential
// (B*H, q block, kv block) grid with the running (m, l, acc) in VMEM.
//
// What it computes, for every batch b, head h and query row i < S (the KV
// head is h / (H / KV), read in place, never replicated):
//     s_ij = (q_i . k_j) / sqrt(hd)         float32 sums of exact products
//     s_ij = cap * tanh(s_ij / cap)         when a softcap is given
//     s_ij = -1e30 unless j <= i and j < S  (causal mask, ragged tail)
//     online over key tiles: m' = max(m, max_j s_ij); p_ij = exp(s_ij - m')
//     l = l exp(m - m') + sum_j p_ij;  acc = acc exp(m - m') + sum_j p~_ij v_j
// with p~ = p rounded to v's type before the product (the reference's
// p.astype(v.dtype)), and emits acc / max(l, 1e-30) in q's type.
//
// What bounds it on this card: the causal work, 4 B H hd S(S+1)/2 flops,
// against 2 B S (H + KV) hd bytes of q/k/v/o -- at stablelm's prefill
// shapes (hd 64, S in the thousands) hundreds of flops per byte, far above
// the H100's ~295 (bf16 tensor cores) ridge: operations, not bytes.
//
// What the design does about it, kept simple on purpose (a first port):
// one block of 256 threads per (64-row q tile, b*h); q, K and V tiles are
// staged in shared memory as float32 (rows padded by one float so the four
// lanes of a row read four banks); four lanes share a q row, each scoring
// 16 of the tile's 64 keys and accumulating a quarter of the head's
// columns; the row max and sum are reduced with two warp shuffles and p~
// goes through shared memory. Key tiles past the diagonal are skipped, and
// the heaviest q tiles are scheduled first. SIMT FMAs only: tensor cores
// (mma.sync / wgmma) and TMA-fed pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;               // q rows per block
constexpr int BK = 64;               // keys per staged tile
constexpr int TPR = 4;               // lanes per q row
constexpr int THREADS = BQ * TPR;    // 256
constexpr int KPT = BK / TPR;        // keys scored per lane per tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_floats() {
  return static_cast<size_t>(BQ) * (HD + 1) + static_cast<size_t>(BK) *
         (HD + 1) + static_cast<size_t>(BK) * HD +
         static_cast<size_t>(BQ) * (BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H,
             int KV, float softcap) {
  constexpr int LD = HD + 1;         // padded row stride of the q and K tiles
  constexpr int DPT = HD / TPR;      // accumulator columns per lane
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x LD
  float* Ks = Qs + BQ * LD;          // BK x LD
  float* Vs = Ks + BK * LD;          // BK x HD
  float* Ps = Vs + BK * HD;          // BQ x (BK + 1)

  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int r = tid / TPR;           // q row within the tile
  const int t = tid % TPR;           // lane within the row's group
  const int q0 = qt * BQ;
  const int qpos = q0 + r;
  const size_t qstride = static_cast<size_t>(H) * HD;
  const size_t kvstride = static_cast<size_t>(KV) * HD;
  const T* qb = q + static_cast<size_t>(b) * S * qstride +
                static_cast<size_t>(h) * HD;
  const T* kb = k + static_cast<size_t>(b) * S * kvstride +
                static_cast<size_t>(kvh) * HD;
  const T* vb = v + static_cast<size_t>(b) * S * kvstride +
                static_cast<size_t>(kvh) * HD;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int rr = i / HD, c = i % HD;
    const int p = q0 + rr;
    Qs[rr * LD + c] = p < S ? to_f(qb[static_cast<size_t>(p) * qstride + c])
                            : 0.0f;
  }

  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.0f;
  float m = NEG, l = 0.0f;
  float* pr = Ps + r * (BK + 1);
  const float* qr = Qs + r * LD;

  // BQ == BK, so key tile qt holds the diagonal and later tiles are skipped
  for (int j = 0; j <= qt; ++j) {
    const int k0 = j * BK;
    __syncthreads();                 // q staged / last tile no longer read
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int rr = i / HD, c = i % HD;
      const int p = k0 + rr;
      const bool in = p < S;
      const size_t off = static_cast<size_t>(p) * kvstride + c;
      Ks[rr * LD + c] = in ? to_f(kb[off]) : 0.0f;
      Vs[rr * HD + c] = in ? to_f(vb[off]) : 0.0f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < HD; ++c) {
      const float qc = qr[c];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
        s[i] = fmaf(qc, Ks[(t + TPR * i) * LD + c], s[i]);
    }
    float mt = NEG;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kp = k0 + t + TPR * i;
      float x = s[i] * scale;
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      x = (qpos >= kp && kp < S) ? x : NEG;
      s[i] = x;
      mt = fmaxf(mt, x);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    float ps = 0.0f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = expf(s[i] - m_new);
      ps += p;
      pr[t + TPR * i] = to_f(from_f<T>(p));
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    const float corr = expf(m - m_new);
    l = l * corr + ps;
    m = m_new;
    __syncwarp();                    // a row's four lanes share one warp
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= corr;
    for (int jj = 0; jj < BK; ++jj) {
      const float p = pr[jj];
      const float* vr = Vs + jj * HD + t;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, vr[TPR * d], acc[d]);
    }
  }

  if (qpos < S) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = o + (static_cast<size_t>(b) * S + qpos) * qstride +
              static_cast<size_t>(h) * HD;
#pragma unroll
    for (int d = 0; d < DPT; ++d) orow[t + TPR * d] = from_f<T>(acc[d] / lc);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, int hd, float softcap,
              cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, KV, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, KV, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, KV, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, H, KV, softcap, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B, S, H, hd), k/v (B, S, KV, hd), o (B, S, H, hd), all contiguous and
// of one type: dtype 0 = float32, 1 = bfloat16. Scores are scaled by
// 1/sqrt(hd); softcap <= 0 means none.
// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int KV, int hd,
                           int dtype, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, B, S, H, KV, hd, softcap, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, softcap,
                                    st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
