// The masked depth loss of K8 and K9 (heal_swin_tpu/ops/final_head.py _depth_loss_vals,
// _depth_loss_grads) on one element's f32 logits (mean, logvar), not rounded: shared by
// the bf16 kernels' epilogues (tail_core.cuh) and the f32 kernels' (tail_f32.cuh).
// Kinds in the order of the wrapper's DEPTH_KINDS.
#pragma once

#include <cuda_runtime.h>

namespace hs {

enum DepthKind : int { kL2 = 0, kL1 = 1, kHuber = 2, kNll = 3 };

// jnp.sign: +-1, and d itself at 0 and NaN
__device__ __forceinline__ float sign_of(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : d);
}

// d = logit 0 - target: an invalid target is selected to 0 before the subtraction,
// and d is 0 where the target is invalid
__device__ __forceinline__ float depth_diff(float lf0, float t, bool valid) {
  const float ts = valid ? t : 0.f;
  return valid ? lf0 - ts : 0.f;
}

// the loss of one valid element
__device__ __forceinline__ float depth_loss(const float (&lf)[2], float d, int kind,
                                            float delta) {
  switch (kind) {
    case kL2:
      return 0.5f * d * d;
    case kL1:
      return fabsf(d);
    case kHuber: {
      const float ad = fabsf(d);
      return ad < delta ? 0.5f * ad * ad / delta : ad - 0.5f * delta;
    }
    default:  // kNll over (mean, logvar)
      return 0.5f * lf[1] + (0.5f * d * d) * expf(-lf[1]);
  }
}

// d loss / d logits of one element: (g0, g1), both 0 where invalid; g1 is 0 for every
// kind but nll (a logvar channel before the loss switches to the NLL)
__device__ __forceinline__ void depth_grads(const float (&lf)[2], float d, bool valid,
                                            int kind, float delta, float (&g)[2]) {
  g[0] = 0.f;
  g[1] = 0.f;
  if (!valid) return;
  switch (kind) {
    case kL2:
      g[0] = d;
      break;
    case kL1:
      g[0] = sign_of(d);
      break;
    case kHuber:
      g[0] = fabsf(d) < delta ? d / delta : sign_of(d);
      break;
    default: {
      const float e = expf(-lf[1]);
      g[0] = d * e;
      g[1] = 0.5f - (0.5f * d * d) * e;
    }
  }
}

}  // namespace hs
