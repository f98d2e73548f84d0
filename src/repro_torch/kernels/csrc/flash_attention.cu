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
// Two instances, picked by dtype (a dispatch, not a fallback):
//
// bfloat16 (the serving path's type), on tensor cores. One block of 4 warps
// per (64-row q tile, b*h), the heaviest q tiles scheduled first; each warp
// owns 16 q rows. Q.K^T and P.V are mma.sync.m16n8k16 bf16 -> f32, their
// operands read from shared memory with ldmatrix (.trans for V). S and the
// online softmax stay in registers: the row max and sum over a quad of
// lanes with two shuffles (l is kept per lane and summed once at the end),
// and p, rounded to bf16 in registers -- exactly the reference's
// p.astype(v.dtype) -- is the A operand of P.V as it stands, because the
// m16n8k16 accumulator layout of two adjacent 8-key tiles is the A layout
// of one 16-key step; P never touches shared memory. q, K and V stay bf16
// in shared memory, rows padded by 16 bytes so the eight 16-byte rows an
// ldmatrix phase reads fall in eight distinct bank quads. K/V tiles come
// through a double-buffered ring filled by 16-byte cp.async (the ragged
// tail zero-filled), so tile j+1 arrives while tile j is multiplied. Key
// tiles past the diagonal are skipped; only a warp's diagonal tile and the
// ragged tile past S are masked. 64-key tiles up to hd 128; at hd 256 the
// key tile is cut to 32 so the 128-float output accumulator and the
// operands fit the registers (tc::smem_bytes: 25.6-101.4 KB a block).
//
// float32, on the SIMT instance kept from the first port: tensor cores
// would take float32 only as TF32 (10-bit mantissa), which is not the
// reference's float32 arithmetic. One block of 256 threads per (64-row q
// tile, b*h); q, K and V tiles staged in shared memory as float32 (rows
// padded by one float so the four lanes of a row read four banks); four
// lanes share a q row, each scoring 16 of the tile's 64 keys and
// accumulating a quarter of the head's columns; the row max and sum are
// reduced with two warp shuffles and p~ goes through shared memory. Key
// tiles past the diagonal are skipped, the heaviest q tiles scheduled
// first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// float32: the SIMT kernel
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BQ = 64;               // q rows per block
constexpr int BK = 64;               // keys per staged tile
constexpr int TPR = 4;               // lanes per q row
constexpr int THREADS = BQ * TPR;    // 256
constexpr int KPT = BK / TPR;        // keys scored per lane per tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async ring)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;               // q rows per block
constexpr int WARPS = BQ / 16;       // one warp per 16 q rows
constexpr int THREADS = WARPS * 32;  // 128
constexpr int PAD = 8;               // bf16 elements appended to a smem row
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
__host__ __device__ constexpr int kv_tile() {   // keys per K/V tile
  return HD >= 256 ? 32 : 64;
}

template <int HD>
constexpr size_t smem_bytes() {      // q tile + two K and two V tiles
  return sizeof(bf16) * static_cast<size_t>(HD + PAD) *
         (BQ + 4 * kv_tile<HD>());
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 writes zeros (rows past S)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, float32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// rows [row0, row0 + ROWS) of a (S, stride) bf16 matrix into a padded
// smem tile, 16 bytes per copy; rows at or past S become zeros
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int S) {
  constexpr int CPR = HD / 8;        // 16-byte chunks per row
  constexpr int LD = HD + PAD;
  static_assert(ROWS * CPR % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
    const int c = static_cast<int>(threadIdx.x) + it * THREADS;
    const int r = c / CPR, col = (c % CPR) * 8;
    const int p = row0 + r;
    const bool in = p < S;
    cp_async16(dst + r * LD + col,
               src + static_cast<size_t>(in ? p : 0) * stride + col, in);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                int H, int KV, float softcap) {
  constexpr int BK = kv_tile<HD>();
  constexpr int LD = HD + PAD;
  constexpr int NT_S = BK / 8;       // 8-key accumulator tiles of S
  constexpr int NT_O = HD / 8;       // 8-column accumulator tiles of O
  constexpr int KS_QK = HD / 16;     // 16-deep steps of Q.K^T
  constexpr int KS_PV = BK / 16;     // 16-deep steps of P.V
  constexpr bool Q_IN_REGS = HD <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);   // BQ x LD
  bf16* Ks = Qs + BQ * LD;                    // 2 x BK x LD
  bf16* Vs = Ks + 2 * BK * LD;                // 2 x BK x LD

  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.y);  // heaviest first
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;          // accumulator row within 8
  const int gc = lane & 3;           // accumulator column pair
  const int mi = lane >> 3;          // ldmatrix: which 8x8 matrix it addresses
  const int q0 = qt * BQ;
  const int wrow = q0 + warp * 16;   // the warp's first q row
  const size_t qstride = static_cast<size_t>(H) * HD;
  const size_t kvstride = static_cast<size_t>(KV) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * S * qstride +
                   static_cast<size_t>(h) * HD;
  const bf16* kb = k + static_cast<size_t>(b) * S * kvstride +
                   static_cast<size_t>(kvh) * HD;
  const bf16* vb = v + static_cast<size_t>(b) * S * kvstride +
                   static_cast<size_t>(kvh) * HD;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const int nkt = (min(q0 + BQ, S) + BK - 1) / BK;   // tiles up to the diagonal

  load_tile<HD, BQ>(Qs, qb, qstride, q0, S);
  load_tile<HD, BK>(Ks, kb, kvstride, 0, S);
  load_tile<HD, BK>(Vs, vb, kvstride, 0, S);
  cp_async_commit();

  // A operand of Q.K^T: rows wrow + (lane & 7) + 8 (mi & 1), columns 8 (mi >> 1)
  const bf16* qfrag = Qs + (warp * 16 + (lane & 7) + (mi & 1) * 8) * LD +
                      (mi >> 1) * 8;
  uint32_t qf[Q_IN_REGS ? KS_QK : 1][4];
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m_run[2] = {NEG, NEG};       // rows gr and gr + 8 of the warp
  float l_run[2] = {0.0f, 0.0f};     // this lane's share of the row sums

  for (int j = 0; j < nkt; ++j) {
    const int st = j & 1;
    if (j + 1 < nkt) {               // the next tile lands during this one
      load_tile<HD, BK>(Ks + (st ^ 1) * BK * LD, kb, kvstride, (j + 1) * BK,
                        S);
      load_tile<HD, BK>(Vs + (st ^ 1) * BK * LD, vb, kvstride, (j + 1) * BK,
                        S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Q_IN_REGS) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KS_QK; ++kk)
          ldmatrix_x4(qf[kk], smem_addr(qfrag + kk * 16));
      }
    }
    const bf16* Kt = Ks + st * BK * LD;
    const bf16* Vt = Vs + st * BK * LD;

    // S = Q K^T: K rows are keys (the mma's n), their columns its k
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS_QK; ++kk) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, smem_addr(qfrag + kk * 16));
      }
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t bk[4];              // keys 16 np + [0, 16), 16 depth
        ldmatrix_x4(bk, smem_addr(Kt + (np * 16 + (lane & 7) + (mi >> 1) * 8) *
                                           LD + kk * 16 + (mi & 1) * 8));
        mma(s[2 * np], a, bk[0], bk[1]);
        mma(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap, mask; the tile's row max. Lane holds rows gr (e < 2)
    // and gr + 8 (e >= 2), keys k0 + 8 n + 2 gc + (e & 1)
    const int k0 = j * BK;
    const bool edge = k0 + BK - 1 > wrow || k0 + BK > S;
    float mt[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        if (edge) {
          const int key = k0 + n * 8 + 2 * gc + (e & 1);
          const int row = wrow + gr + (e >> 1) * 8;
          if (key > row || key >= S) x = NEG;
        }
        s[n][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m_run[r], mt[r]);
      corr[r] = exp2f((m_run[r] - m_new) * LOG2E);
      m_run[r] = m_new;
    }

    // p in float for l, rounded to bf16 as the A operand of P.V: 8-key
    // tile n is half n & 1 of 16-key step n >> 1 (a0/a1, then a2/a3)
    uint32_t pa[KS_PV][4];
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      const float p0 = exp2f((s[n][0] - m_run[0]) * LOG2E);
      const float p1 = exp2f((s[n][1] - m_run[0]) * LOG2E);
      const float p2 = exp2f((s[n][2] - m_run[1]) * LOG2E);
      const float p3 = exp2f((s[n][3] - m_run[1]) * LOG2E);
      ps[0] += p0 + p1;
      ps[1] += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + ps[r];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: V rows are keys (the mma's k), read transposed
#pragma unroll
    for (int kk = 0; kk < KS_PV; ++kk) {
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t bv[4];              // keys 16 kk + [0, 16), columns 16 np + [0, 16)
        ldmatrix_x4_trans(bv, smem_addr(Vt + (kk * 16 + (lane & 7) +
                                              (mi & 1) * 8) * LD +
                                             np * 16 + (mi >> 1) * 8));
        mma(acc[2 * np], pa[kk], bv[0], bv[1]);
        mma(acc[2 * np + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();                 // the stage is refilled next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = wrow + gr + r * 8;
    if (row < S) {
      const float lc = fmaxf(l, 1e-30f);
      bf16* orow = o + (static_cast<size_t>(b) * S + row) * qstride +
                   static_cast<size_t>(h) * HD + 2 * gc;
#pragma unroll
      for (int n = 0; n < NT_O; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r] / lc, acc[n][2 * r + 1] / lc);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_tc_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, KV, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// the instance for head dim hd: F<hd>() for hd in 32, 64, 128, 256
template <typename F>
int by_head_dim(int hd, F&& f) {
  switch (hd) {
    case 32:
      return f(std::integral_constant<int, 32>());
    case 64:
      return f(std::integral_constant<int, 64>());
    case 128:
      return f(std::integral_constant<int, 128>());
    case 256:
      return f(std::integral_constant<int, 256>());
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// q (B, S, H, hd), k/v (B, S, KV, hd), o (B, S, H, hd), all contiguous and
// of one type: dtype 0 = float32 (the SIMT kernel), 1 = bfloat16 (tensor
// cores; every pointer 16-byte aligned). Scores are scaled by 1/sqrt(hd);
// softcap <= 0 means none. Launches on `stream`; returns the cudaError_t
// of the launch (0 = ok).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int KV, int hd,
                           int dtype, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int code = -1;
  if (dtype == 0)
    code = by_head_dim(hd, [&](auto d) {
      return simt::launch<float, decltype(d)::value>(q, k, v, o, B, S, H, KV,
                                                     softcap, st);
    });
  else if (dtype == 1)
    code = by_head_dim(hd, [&](auto d) {
      return tc::launch<decltype(d)::value>(q, k, v, o, B, S, H, KV, softcap,
                                            st);
    });
  return code < 0 ? static_cast<int>(cudaErrorInvalidValue) : code;
}

// Dynamic shared memory of one block of the instance (hd, dtype), in bytes;
// -1 for a head dim or dtype there is no instance of.
int flash_attention_smem_bytes(int hd, int dtype) {
  if (dtype == 0)
    return by_head_dim(hd, [](auto d) {
      return static_cast<int>(simt::smem_floats<decltype(d)::value>() *
                              sizeof(float));
    });
  if (dtype == 1)
    return by_head_dim(hd, [](auto d) {
      return static_cast<int>(tc::smem_bytes<decltype(d)::value>());
    });
  return -1;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
