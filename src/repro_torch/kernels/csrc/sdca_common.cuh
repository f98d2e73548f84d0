// Shared pieces of the LocalSDCA kernels (local_sdca.cu,
// sparse_sdca_pipelined.cu, sparse_sdca_zx.cu):
// the closed-form coordinate update of every kernel-supported loss, the
// soft-threshold of the fused prox, and the per-step block reduction.
//
// The closed forms follow src/repro_torch/core/losses.py (and the reference
// src/repro/core/losses.py) line for line, including the q == 0 guards and
// _safe_div, so a row with zero norm is an exact no-op.
#pragma once

#include <cuda_runtime.h>

namespace sdca {

// loss ids: the wrapper maps Loss.name onto these (logistic is rejected)
enum LossId : int { HINGE = 0, SMOOTH_HINGE = 1, SQUARED = 2, ABSOLUTE = 3 };

// threads of one block; 32 warps at most, so the reduction scratch below
// always has room for one float2 per warp
constexpr int MAX_WARPS = 32;

// dynamic shared memory ahead of u: MAX_WARPS float2 partial sums plus a
// 16-byte broadcast slot (keeps u 16-byte aligned)
constexpr int SCRATCH_BYTES = MAX_WARPS * 8 + 16;

__device__ __forceinline__ float safe_div(float a, float b) {
  return a / (b == 0.0f ? 1.0f : b);
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// argmax over delta of  -l*(-(abar+delta)) - delta z - (q/2) delta^2
__device__ __forceinline__ float cd_update(int loss_id, float g, float abar,
                                          float z, float q, float y) {
  switch (loss_id) {
    case HINGE: {
      float beta = clip(y * abar + safe_div(1.0f - y * z, q), 0.0f, 1.0f);
      float delta = y * beta - abar;
      return q == 0.0f ? 0.0f : delta;
    }
    case SMOOTH_HINGE: {
      float d_unc = safe_div(y - g * abar - z, g + q);
      float beta = clip(y * (abar + d_unc), 0.0f, 1.0f);
      return y * beta - abar;
    }
    case SQUARED:
      return (y - abar - z) / (1.0f + q);
    case ABSOLUTE: {
      float b = clip(abar + safe_div(y - z, q), -1.0f, 1.0f);
      return q == 0.0f ? 0.0f : b - abar;
    }
  }
  return 0.0f;
}

// sign(u) * max(|u| - kappa, 0): the fused v -> w map on one gathered entry
__device__ __forceinline__ float soft_threshold(float u, float kappa) {
  float m = fmaxf(fabsf(u) - kappa, 0.0f);
  return u > 0.0f ? m : (u < 0.0f ? -m : 0.0f);
}

// Sum (a, b) over the block. Every thread passes its partials; the totals
// are valid in thread 0 only. Ends with the scratch published: the caller
// must __syncthreads() before the scratch is written again.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float2* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  float2 tot = make_float2(0.0f, 0.0f);
  if (threadIdx.x == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    for (int w = 0; w < nwarps; ++w) {
      tot.x += scratch[w].x;
      tot.y += scratch[w].y;
    }
  }
  return tot;
}

}  // namespace sdca
