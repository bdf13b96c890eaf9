// Shared by K1 (blend_fwd.cu) and K2 (blend_bwd.cu): the constants of the
// blend and the alpha of one (instance, pixel) pair. Both kernels include
// this one definition, so the forward's keep test and the backward's
// recompute of it cannot drift apart by an ulp.
#pragma once

#include <cuda_runtime.h>

namespace hugs_blend {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kFeat = 10;  // r g b op mx my ca cb cc rad
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kLogTEps = -9.21034049987793f;  // float32(log(1e-4))

// alpha of a Gaussian (opacity op, mean mx my, conic ca cb cc, radius rad)
// at the pixel centre (px, py), in the operation order of
// hugs_tpu_torch/render/oracle.py::gaussian_alpha, product by product:
//   alpha = min(0.99, op * exp(min(power, 0))),
// zero where power > 0, alpha < 1/255 or dist^2 > rad^2. Also returns
// dx = mx - px and dy = my - py.
__device__ __forceinline__ float pair_alpha(float op, float mx, float my,
                                            float ca, float cb, float cc,
                                            float rad, float px, float py,
                                            float& dx, float& dy) {
  dx = mx - px;
  dy = my - py;
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  const float alpha = fminf(kMaxAlpha, op * expf(fminf(power, 0.0f)));
  const bool keep =
      power <= 0.0f && alpha >= kMinAlpha && dx * dx + dy * dy <= rad * rad;
  return keep ? alpha : 0.0f;
}

}  // namespace hugs_blend
