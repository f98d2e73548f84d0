// The stamped build of the zx cluster form's step and of the dense walk's
// window (tools/sdca_step_ablation.py --only zxc,dense: their `stamped`
// variants set SDCA_ZX_STAMPS to 1; the tool gives a checkout that lacks the
// stamps this header and its own boundaries). Every thread reads clock64 at
// each phase boundary of every step and adds the cycles since the boundary
// before to that phase's 32-bit total, in registers, without a branch; lane
// 0 of the
// warp that flushes a role writes its totals and its step count to a
// device buffer at the end. A phase is the time from one boundary's issue
// to the next one's: a load's latency shows where its value is first
// waited for. The including source defines ZX_STAMP_NAMES: each role's
// phases in word order ("role:a,b;role:c,..."). Nothing of it is compiled
// otherwise.
#pragma once

#ifndef SDCA_ZX_STAMPS
#define SDCA_ZX_STAMPS 0
#endif

#if SDCA_ZX_STAMPS
constexpr int ZX_STAMP_BLOCKS = 16;     // blocks stamped
constexpr int ZX_STAMP_WORDS = 24;      // the roles' phases, then their steps
constexpr int ZX_STAMP_ROLES = 2;       // the roles ZX_STAMP_NAMES names
__device__ long long g_zx_stamps[ZX_STAMP_BLOCKS][ZX_STAMP_WORDS];
// per block: clock64 and %globaltimer at the loop's start and end
__device__ long long g_zx_stamp_clock[ZX_STAMP_BLOCKS][4];
__device__ __forceinline__ long long zx_stamp_clock() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
__device__ __forceinline__ long long zx_stamp_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}
#define ZX_STAMP_BEGIN(NPH)       \
  unsigned zacc_[NPH] = {};       \
  unsigned zlast_ = static_cast<unsigned>(zx_stamp_clock())
// the phase that ends here, phase I of the thread's role
#define ZX_STAMP(I)                                              \
  do {                                                           \
    const unsigned t_ = static_cast<unsigned>(zx_stamp_clock()); \
    zacc_[I] += t_ - zlast_;                                     \
    zlast_ = t_;                                                 \
  } while (0)
// lane 0 of the calling warp writes its NPH totals from word W0 and its
// steps to word ZX_STAMP_WORDS - ZX_STAMP_ROLES + R (role R)
#define ZX_STAMP_FLUSH(W0, NPH, R, STEPS)                               \
  do {                                                                  \
    if ((threadIdx.x & 31) == 0 && blockIdx.x < ZX_STAMP_BLOCKS) {      \
      for (int i_ = 0; i_ < (NPH); ++i_)                                \
        g_zx_stamps[blockIdx.x][(W0) + i_] = zacc_[i_];                 \
      g_zx_stamps[blockIdx.x][ZX_STAMP_WORDS - ZX_STAMP_ROLES + (R)] =  \
          (STEPS);                                                      \
    }                                                                   \
  } while (0)
#define ZX_STAMP_CLOCK(W)                                \
  do {                                                   \
    if (threadIdx.x == 0 && blockIdx.x < ZX_STAMP_BLOCKS) { \
      g_zx_stamp_clock[blockIdx.x][W] = zx_stamp_clock();   \
      g_zx_stamp_clock[blockIdx.x][(W) + 2] = zx_stamp_ns(); \
    }                                                    \
  } while (0)

extern "C" {

// the stamped build's buffer: its shape (blocks, words), its phases'
// names, a reset and a read (cudaError_t)
void sparse_sdca_zx_stamp_shape(int* out) {
  out[0] = ZX_STAMP_BLOCKS;
  out[1] = ZX_STAMP_WORDS;
}

const char* sparse_sdca_zx_stamp_names() { return ZX_STAMP_NAMES; }

int sparse_sdca_zx_stamps_reset() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_zx_stamps);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_zx_stamps));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, g_zx_stamp_clock);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_zx_stamp_clock));
  return static_cast<int>(err);
}

int sparse_sdca_zx_stamps_read(long long* stamps, long long* clocks) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(stamps, g_zx_stamps, sizeof(g_zx_stamps));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(clocks, g_zx_stamp_clock,
                               sizeof(g_zx_stamp_clock));
  return static_cast<int>(err);
}

}  // extern "C"
#else
#define ZX_STAMP_BEGIN(NPH) \
  do {                      \
  } while (0)
#define ZX_STAMP(I) \
  do {              \
  } while (0)
#define ZX_STAMP_FLUSH(W0, NPH, R, STEPS) \
  do {                                    \
  } while (0)
#define ZX_STAMP_CLOCK(W) \
  do {                    \
  } while (0)
#endif
