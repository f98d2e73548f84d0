// Shared pieces of the LocalSDCA kernels (local_sdca.cu,
// sparse_sdca_pipelined.cu, sparse_sdca_zx.cu):
// the closed-form coordinate update of every kernel-supported loss, the
// soft-threshold of the fused prox, and the per-step warp reduction.
//
// The closed forms follow src/repro_torch/core/losses.py (and the reference
// src/repro/core/losses.py) line for line, including the q == 0 guards and
// _safe_div, so a row with zero norm is an exact no-op.
#pragma once

#include <cuda_runtime.h>

namespace sdca {

// loss ids: the wrapper maps Loss.name onto these (logistic is rejected)
enum LossId : int { HINGE = 0, SMOOTH_HINGE = 1, SQUARED = 2, ABSOLUTE = 3 };

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

// Sum (a, b) over one warp: a butterfly of __shfl_xor_sync, so every lane
// ends with the totals, the same bits in every lane (each level adds the
// same two values in each pair of lanes, and float addition commutes). The
// whole warp must call it; no shared memory, no barrier.
__device__ __forceinline__ float2 warp_sum2(float a, float b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  return make_float2(a, b);
}

}  // namespace sdca
