// Shared by K1 (blend_fwd.cu) and K2 (blend_bwd.cu): the constants of the
// blend, the alpha of one (instance, pixel) pair, the warp cull and the
// occupancy query. Both kernels include this one definition, so the
// forward's keep test and the backward's recompute of it cannot drift
// apart by an ulp.
#pragma once

#include <cuda_runtime.h>

namespace hugs_blend {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 32 / kTile;  // warp w covers pixel rows 2w, 2w + 1
constexpr int kFeat = 10;  // r g b op mx my ca cb cc rad
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kLogTEps = -9.21034049987793f;  // float32(log(1e-4))
// float32(1/255 * 0.999), rounded once from double as the plain version's
// comparison with a Python float rounds it
constexpr float kCullAlpha = static_cast<float>(1.0 / 255.0 * 0.999);

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

// False only where the Gaussian's alpha is zero at every pixel centre of
// the rectangle [x0, x1] x [y0, y1]: hugs_tpu_torch/render/tiles.py::
// _tight_cull_keep in its operation order (the disk test against the
// radius, and the ellipse test, op * exp(-min q) over the rectangle below
// 1/255 with the 0.999 margin, where the conic is positive-definite).
__device__ __forceinline__ bool cull_keep(float op, float mx, float my,
                                          float ca, float cb, float cc,
                                          float rad, float x0, float y0,
                                          float x1, float y1) {
  const float ddx = fminf(fmaxf(mx, x0), x1) - mx;
  const float ddy = fminf(fmaxf(my, y0), y1) - my;
  const bool disk_ok = ddx * ddx + ddy * ddy <= rad * rad;
  const float lx = x0 - mx, hx = x1 - mx;
  const float ly = y0 - my, hy = y1 - my;
  const bool inside = lx <= 0.0f && hx >= 0.0f && ly <= 0.0f && hy >= 0.0f;
  const float safe_ca = ca > 0.0f ? ca : 1.0f;
  const float safe_cc = cc > 0.0f ? cc : 1.0f;
  auto q = [&](float dx, float dy) {
    return 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
  };
  auto edge_v = [&](float dx) {  // vertical edge, fixed dx
    return q(dx, fminf(fmaxf(-cb * dx / safe_cc, ly), hy));
  };
  auto edge_h = [&](float dy) {  // horizontal edge, fixed dy
    return q(fminf(fmaxf(-cb * dy / safe_ca, lx), hx), dy);
  };
  float min_q = fminf(fminf(edge_v(lx), edge_v(hx)),
                      fminf(edge_h(ly), edge_h(hy)));
  min_q = inside ? 0.0f : fmaxf(min_q, 0.0f);
  const bool pd = ca > 0.0f && cc > 0.0f && ca * cc - cb * cb >= 0.0f;
  const bool ellipse_dead = pd && op * expf(-min_q) < kCullAlpha;
  return disk_ok && !ellipse_dead;
}

// cull_keep of the feature row f (kFeat floats) against the pixel-centre
// rectangle of warp `warp` of the tile whose top-left pixel is (tx0, ty0).
__device__ __forceinline__ bool warp_keep(const float* f, int tx0, int ty0,
                                          int warp) {
  const float x0 = static_cast<float>(tx0);
  const float y0 = static_cast<float>(ty0 + kWarpRows * warp);
  return cull_keep(f[3], f[4], f[5], f[6], f[7], f[8], f[9], x0, y0,
                   x0 + (kTile - 1), y0 + (kWarpRows - 1));
}

// Resident blocks per SM of `kernel` at kThreads threads, no dynamic
// shared memory; -1 if the query fails.
template <typename Kernel>
int blocks_per_sm(Kernel kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) !=
      cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace hugs_blend
