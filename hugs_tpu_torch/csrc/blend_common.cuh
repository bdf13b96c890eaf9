// Shared by K1 (blend_fwd.cu) and K2 (blend_bwd.cu): the constants of the
// blend, the alpha of one (instance, pixel) pair, the warp cull, the
// POWER_MXU mode's exponent on the tensor cores and the occupancy query.
// Both kernels include this one definition, so the forward's keep test
// and the backward's recompute of it cannot drift apart by an ulp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// ---- The POWER_MXU mode (hugs_tpu/render/pallas_blend.py:116-188 and
// :279-313, off by default): the Gaussian's exponent at a pixel is a
// quadratic in the pixel's coordinates, so for the 32 pixels of a warp
// and 8 instances it is one matrix product, D (32 x 8) = A (32 x K) B
// (K x 8), run here on the tensor cores with mma.sync m16n8k16 (bf16
// operands, float32 accumulation). A holds each pixel's basis [1, u', v',
// u'^2, v'^2, u'v'] at the tile's 2 x 2 grid points (tile-local (8 gx +
// 4, 8 gy + 4)), u' and v' relative to the grid point: integers of at
// most 144, exact in bf16, so the TPU's second (lo) basis term is zero
// at a 16-pixel tile and its two passes are left out (they add exact
// zeros). B holds each instance's coefficients [a0, bu, bv, -ca/2,
// -cc/2, -cb] at its own grid point (floor of its tile-local mean over 8,
// clipped to the tile: a mean outside the tile keeps a residual beyond 4
// pixels, pallas_blend.py:94-104), zero at the other three, each split
// into three bf16 terms c1 + c2 + c3, and the power is bh c1 + bh c2 +
// bh c3, chained through the accumulator in that order. K = 32: each
// grid point g takes rows 8 g .. 8 g + 7 (six terms and two zero rows),
// the TPU's rows 6 g .. 6 g + 5 padded from 24 to 32 in another order:
// the same products, summed inside one mma in the hardware's order. k
// step ks covers the grid points 2 ks and 2 ks + 1.
//
// A group is the next kGroupN instances that a warp's cull keeps, in the
// order its kernel walks them (K1 front to back, K2 back to front): the
// columns of one product. Each column of an mma is its own dot product
// over the same A rows, and the k step that does not hold an instance's
// grid point adds exact zeros to its column, so a pair's power does not
// depend on its column or on the other instances of its group: K1 and K2
// group their kept instances differently and still agree on every alpha,
// bit for bit. Per (warp, group): 12 mma (2 pixel rows x 3 passes x 2 k
// steps), 4,096 tensor-core flops each.
constexpr int kGridSp = 8;                 // grid spacing (pixels)
constexpr int kGridN = kTile / kGridSp;    // grid points a side
constexpr float kPowEps = 1e-4f;           // the mode's `power <= 0` guard
constexpr int kGroupN = 8;                 // instances per mma (n8)
constexpr int kCofStride = 16;  // words per instance record: for each
                                // lane t of a column, its bf16 pair of
                                // the three passes and the grid point
                                // (one 16-byte load; t = 3 loads zeros)
constexpr int kPowStride = 36;  // floats per instance row of powers: the
                                // warp's 32 pixels and 4 pad (no bank
                                // conflicts on the fragment's stores)

// The mode's shared memory for a batch of B instances: each instance's
// coefficient record and, past them, a record of zeros (a group's
// columns past its end); per warp its list of kept slots, and its
// group's powers and rows (mxu_group_row).
template <int B>
struct MxuShared {
  uint32_t cof[B + 1][kCofStride];
  float power[kWarps][kGroupN][kPowStride];
  float4 rows[kWarps][kGroupN][2];
  uint8_t list[kWarps][B];
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(
             __bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(
              __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// The coefficient record of the instance with feature row f in the tile
// whose top-left pixel is (tx0, ty0), in the operation order of
// pallas_blend.py:162-177 (and of render/blend.py::mxu_coefficients,
// under -fmad=false): rec[4 t + p] packs pass p's terms 2 t and 2 t + 1
// (p = 0, 1, 2 for c1, c2, c3; t = 0, 1, 2) and rec[4 t + 3] the grid
// point; rec[12 .. 14] are zero (terms 6 and 7), rec[15] the grid point.
__device__ __forceinline__ void mxu_record(const float* f, float tx0,
                                           float ty0, uint32_t* rec) {
  const float ca = f[6], cb = f[7], cc = f[8];
  const float mxl = f[4] - tx0;
  const float myl = f[5] - ty0;
  const float gx = fminf(fmaxf(floorf(mxl * (1.0f / kGridSp)), 0.0f),
                         static_cast<float>(kGridN - 1));
  const float gy = fminf(fmaxf(floorf(myl * (1.0f / kGridSp)), 0.0f),
                         static_cast<float>(kGridN - 1));
  const float rx = mxl - (gx * kGridSp + kGridSp / 2);
  const float ry = myl - (gy * kGridSp + kGridSp / 2);
  float c[6] = {-0.5f * (ca * rx * rx + cc * ry * ry) - cb * rx * ry,
                ca * rx + cb * ry,
                cc * ry + cb * rx,
                -0.5f * ca,
                -0.5f * cc,
                -cb};
  const uint32_t grid =
      static_cast<uint32_t>(static_cast<int>(gy * kGridN + gx));
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float term[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      term[k] = __bfloat162float(__float2bfloat16_rn(c[k]));
      c[k] = c[k] - term[k];  // the remainder the next pass splits
    }
#pragma unroll
    for (int t = 0; t < 3; ++t) rec[4 * t + p] = pack_bf16(term[2 * t],
                                                           term[2 * t + 1]);
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) rec[4 * t + 3] = grid;
  rec[12] = rec[13] = rec[14] = 0u;
}

// Term s of the basis [1, u, v, u^2, v^2, uv] (0 for s = 6, 7).
__device__ __forceinline__ float basis_term(int s, float u, float v) {
  return s == 0   ? 1.0f
         : s == 1 ? u
         : s == 2 ? v
         : s == 3 ? u * u
         : s == 4 ? v * v
         : s == 5 ? u * v
                  : 0.0f;
}

// This lane's A fragments (basis) for the warp's 32 pixels: warp w holds
// tile-local pixel rows y = 2 w + mt (mt = 0, 1), its lanes 16 mt .. 16
// mt + 15 the columns x = 0 .. 15, which are the rows of m-tile mt.
// a[mt][ks] is the m16n8k16 A fragment of k step ks, its register r rows
// x = lane / 4 + 8 (r & 1), columns 16 ks + 8 (r >> 1) + 2 (lane % 4) +
// {0, 1}, i.e. grid point 2 ks + (r >> 1) and terms 2 (lane % 4) + {0,
// 1}.
__device__ __forceinline__ void mxu_basis(int warp, int lane,
                                          uint4 a[2][2]) {
  const int tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t r4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int g = 2 * ks + (r >> 1);
        const float u = static_cast<float>((lane >> 2) + 8 * (r & 1) -
                                           (kGridSp * (g % kGridN) +
                                            kGridSp / 2));
        const float v = static_cast<float>(kWarpRows * warp + mt -
                                           (kGridSp * (g / kGridN) +
                                            kGridSp / 2));
        r4[r] = pack_bf16(basis_term(2 * tig, u, v),
                          basis_term(2 * tig + 1, u, v));
      }
      a[mt][ks] = make_uint4(r4[0], r4[1], r4[2], r4[3]);
    }
  }
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// One group's powers at the warp's 32 pixels, into the accumulator
// fragments d of both pixel rows (mxu_store writes them out). Every lane
// of the warp calls it together (mma.sync). Lane (n = lane / 4, t = lane
// % 4) builds B's column n from the record of slot `slot` (the zero
// record past the group's end): pass p's bf16 pair t where the
// instance's grid point is 2 ks + rb, zero elsewhere; each pixel row's
// accumulator runs the passes in turn, both k steps each.
__device__ __forceinline__ void mxu_product(const uint4 a[2][2],
                                            const uint32_t (*cof)[kCofStride],
                                            int slot, int lane,
                                            float d[2][4]) {
  const uint4 rec =
      *reinterpret_cast<const uint4*>(&cof[slot][4 * (lane & 3)]);
  const uint32_t w[3] = {rec.x, rec.y, rec.z};
  const int g = static_cast<int>(rec.w);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[mt][i] = 0.0f;
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t b0 = g == 2 * ks ? w[p] : 0u;
      const uint32_t b1 = g == 2 * ks + 1 ? w[p] : 0u;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(d[mt], a[mt][ks], b0, b1);
    }
  }
}

// Writes mxu_product's accumulators to out[column][pixel lane]; the
// caller syncs the warp before another lane reads them.
__device__ __forceinline__ void mxu_store(const float d[2][4], int lane,
                                          float (*out)[kPowStride]) {
  const int n = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    // d: rows x = n, n + 8 of pixel row mt, columns (instances) 2 t, 2 t + 1
    out[2 * t][16 * mt + n] = d[mt][0];
    out[2 * t + 1][16 * mt + n] = d[mt][1];
    out[2 * t][16 * mt + n + 8] = d[mt][2];
    out[2 * t + 1][16 * mt + n + 8] = d[mt][3];
  }
}

// The row of the group's column lane / 4 that the walk reads in place of
// the instance's feature row f (slot `slot` of the batch): rows[0] = (op,
// mx, my, rad^2), rows[1] = (r, g, b, slot); the column's four lanes
// write it together, lane t floats 2 t and 2 t + 1. A column past the
// group's end (valid false) gets opacity 0, so its alpha is 0 at every
// pixel, and slot -1.
__device__ __forceinline__ void mxu_group_row(const float* f, int slot,
                                              bool valid, int lane,
                                              float4 (*rows)[2]) {
  const int t = lane & 3;
  float lo, hi;
  if (t == 0) {
    lo = f[3];
    hi = f[4];
  } else if (t == 1) {
    lo = f[5];
    hi = f[9] * f[9];
  } else if (t == 2) {
    lo = f[0];
    hi = f[1];
  } else {
    lo = f[2];
    hi = __int_as_float(slot);
  }
  if (!valid) {
    lo = 0.0f;
    hi = t == 3 ? __int_as_float(-1) : 0.0f;
  }
  reinterpret_cast<float2*>(rows[lane >> 2])[t] = make_float2(lo, hi);
}

// pair_alpha in the mode, from the pair's power off the tensor cores and
// the instance's group row r = (op, mx, my, rad^2): alpha = min(0.99, op
// * exp(min(power, 0))), zero unless power <= kPowEps, alpha >= 1/255
// and dist^2 <= rad^2 (pallas_blend.py:279-313). Also returns dx = mx -
// px and dy = my - py.
__device__ __forceinline__ float pair_alpha_mxu(float power, float4 r,
                                                float px, float py,
                                                float& dx, float& dy) {
  dx = r.y - px;
  dy = r.z - py;
  const float alpha = fminf(kMaxAlpha, r.x * expf(fminf(power, 0.0f)));
  const bool keep = power <= kPowEps && alpha >= kMinAlpha &&
                    dx * dx + dy * dy <= r.w;
  return keep ? alpha : 0.0f;
}

// Resident blocks per SM of `kernel` at kThreads threads and `dynamic`
// bytes of dynamic shared memory; -1 if the query fails.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t dynamic = 0) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    dynamic) != cudaSuccess) {
    return -1;
  }
  return n;
}


}  // namespace hugs_blend
