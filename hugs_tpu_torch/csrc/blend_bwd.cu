// K2: backward tile blend of the splat renderer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of hugs_tpu/render/pallas_blend.py
// (launched by `_blend_core_bwd`), with the XLA code around it: the
// background's gradient (pallas_blend.py:872-876) and the scatter of the
// per-instance rows onto the Gaussians (the AD transpose of
// `_pack_aligned`'s gather). Given g = dL/d(raw colour) per pixel, it adds
// the gradient of the forward blend (K1, blend_fwd.cu; semantics of
// hugs_tpu_torch/render/oracle.py) with respect to each Gaussian's r g b,
// opacity, mean x y and conic a b c into grad_feat (N, 10), and the
// background's into grad_bg (3,). Each pixel walks its tile's instances
// back to front, from the last one it walked in the forward (K1's
// per-pixel n_walked) to the first, and rebuilds the exclusive
// transmittance of instance i from K1's final log T as
// T_i = exp(log T_fin - sum_{j >= i} log1p(-alpha_j)), with
//   S      = sum_c g_c bg_c T_fin [log T_fin >= log 1e-4]   (seed)
//   w_i    = alpha_i T_i [log T_i >= log 1e-4]
//   d_rgb  = g w_i
//   d_alpha= (g . rgb_i) T_i - S / (1 - alpha_i);  S += w_i (g . rgb_i)
//   dp     = d_alpha alpha_i where alpha_i < 0.99 (d power), else 0.
// These are pallas_blend.py:591-668 written per pixel. Per pair it keeps
// nine sums: g w (three), dp, dp dx, dp dy, dp dx^2, dp dx dy, dp dy^2,
// with dx, dy relative to the mean as pair_alpha returns them; once per
// instance, after the sum over the tile's pixels,
//   d_op = sum dp / op,  d_mx = -(ca sum dp dx + cb sum dp dy),
//   d_my = -(cc sum dp dy + cb sum dp dx),  d_ca = -sum dp dx^2 / 2,
//   d_cb = -sum dp dx dy,  d_cc = -sum dp dy^2 / 2,
// which saves a division and the conic products per blended pair. The
// alpha of a pair is recomputed with K1's own code (blend_common.cuh), so
// the two agree on which pairs are kept.
//
// The suffix sum of log1p(-alpha) and S are Kahan-compensated. Where the
// splats behind instance i share its colour, d_alpha is a cancellation:
// g.rgb T_i and S / (1 - alpha) agree up to about g.rgb T_fin, so a
// rounding error in either is amplified by up to T_i / T_fin (1e4), and
// an uncompensated sum's error grows with the length of the walk. K1's own
// rounding of log T_fin scales every rebuilt T_i and S alike, so it scales
// d_alpha and is not amplified.
//
// Design: one block of 256 threads per 16x16 tile, one thread per pixel,
// warp w on pixel rows 2w and 2w + 1. The block stages its tile's
// instances in shared memory in batches of 128, last batch first, 128
// threads loading one instance's row each. Per batch each warp culls as
// K1 does (lane l tests instances l, l + 32, ... against the warp's 16x2
// rectangle, and past every lane's n_walked; a ballot gives the mask),
// then walks the kept instances back to front in groups of kGroup = 8. A lane holds its nine
// partials of a group's instances in registers, and the warp sums them
// with a butterfly that also scatters the results (a reduce-scatter): at
// each of the first three stages a lane keeps half of its instances and
// sends the other half, then two stages finish the sum, 81 shuffles per
// group where a tree per instance takes 360. The stages run as the
// group's instances are computed, so at most four instances' partials are
// live. Lanes 0, 4, ... write the warp's sums to shared memory; after the
// batch, one thread per instance adds the eight warps' sums in warp order
// (a fixed order within the tile), forms the instance's gradient and adds
// it to its Gaussian's row with one atomicAdd (red.global.add.f32) per
// nonzero column. Gaussians appear in many tiles, so the atomics add in
// an order that is not fixed and the result is not bit-reproducible; slots
// no pixel walked, and the budget's padding, are never read or written.
// Copies of the next batch that overlap the walk of this one (cp.async
// into a second buffer) bought 2-4 % on an NVIDIA H100 80GB HBM3 at
// 700 W, not worth their code while a training step is bound by the
// host (PERF.md).
//
// The TPU kernel's mechanics (8 tiles per grid cell, a 4-deep DMA ring,
// bf16 split matmuls for the suffix sums, the pixel-moment basis on the
// matrix unit) exist for the TPU and have no counterpart here.
//
// Bound on the H100: operations. Each (pixel, instance) pair the cull
// keeps within the forward's walk costs the alpha recompute (about 22
// float operations and an exp) and, where alpha > 0, about 38 more (a
// log1p, an exp, a division, the nine products, the compensated sums)
// and 9 adds to sum them; each (warp, instance) it culls costs about 90;
// the bytes (the (N, 10) table, the instance list, three per-pixel planes
// in, grad_feat (N, 10) out) are tens of MB. Times against the bound:
// PERF.md.
//
// Built with -fmad=false, as K1 is, so the alpha of a pair and the cull
// are bit-identical to K1's and to the plain PyTorch version's.
//
// The POWER_MXU mode (blend_bwd_mxu_kernel, hugs_blend_bwd_mxu; the TPU
// kernel's `basis` at pallas_blend.py:499 and its alpha at :589) is
// bwd_tile<kMxu>: each warp compacts the slots its mask keeps into its
// list, back to front, and each 8 of them form a group, as the exact
// mode's cursor pops them: one product on the tensor cores (K1's
// mxu_product), the group's rows (mxu_group_row), and one group of the
// reduce-scatter (group_sums), whose leaves read their column's power
// and row at fixed offsets. A pair's power does not depend on its group
// (blend_common.cuh), so K2's alphas are K1's though the two group the
// kept instances differently. The gradient math is the exact mode's
// (pallas_blend.py:603-613: d power = d_alpha alpha wherever the pair is
// live and unclamped, the moments from the exact dx, dy). Measured
// against the alternatives as K1's mode was (blend_fwd.cu; PERF.md,
// section 6): groups of kept instances -1.5 % on the training frame, -14 %
// serving; the group's rows -9 % and -10 %; left out, each slower or
// within the noise: the k-step vote, the next group's product over this
// group's sums (64 B of spills at 3 blocks per SM, +5 %), two buffers,
// split accumulators and a shared table of A fragments (its 16 KB leave
// 2 blocks per SM, +5 %). The mode adds 20,544 B of dynamic shared
// memory (8,256 B of records with the zero record, 9,216 B of powers,
// 2,048 B of rows, 1,024 B of lists), past 48 KB with the static 42,752
// B, which the launch opts into; held to K2's 3 blocks per SM by its
// launch bounds (80 registers).
//
// S3, K2's skeleton: the tile's work is one template, `bwd_tile`, on a
// variant. K2 is the `kFull` instantiation (blend_bwd_kernel); the others
// (blend_bwd_skeleton_kernel) replace the TPU kernel `_skel_kernel` of
// scripts/micro_bwd.py, which split the TPU kernel's fixed cost from its
// gradient arithmetic, and split K2's the same way on this design:
//   kSkeleton     all of K2 but the gradient math: pair_grad (the alpha
//                 recompute, T_i, the compensated sums and the nine
//                 products) becomes one multiply per sum, d_k = g_r f_k,
//                 and the per-instance conic algebra goes; the per-pixel
//                 setup, staging, cull, grouped walk, reduce-scatter, the
//                 warp-order sum and the atomics stay. Output grad_feat:
//                 f_k times the sum of g_r over the pixels that walk the
//                 instance and whose warp keeps it.
//   kNoCull       kSkeleton with every walked instance kept (no warp
//                 cull): the Hopper-specific part of the fixed cost.
//   kNoShuffle    kSkeleton without the sum across pixels (the TPU's
//                 no_k8): no reduce-scatter, no warp sum, so no
//                 per-instance sums and no atomics; each pixel adds its
//                 own nine sums and writes their total to a (H, W) plane.
//   kStagingOnly  the per-pixel setup, the batch loop, its loads and
//                 syncs (the TPU's dma_only); each thread adds up the row
//                 another thread staged, and the block adds its tile's
//                 total to a (T,) checksum.
// Every variant writes grad_bg as K2 does. Each output depends on all the
// work its variant keeps, so nvcc cannot drop that work, and each has a
// plain PyTorch version (hugs_tpu_torch/micro/micro_bwd.py).
// Without the gradient math a variant needs fewer registers (and the
// cull-free ones less shared memory) than K2, and would run more blocks
// per SM; so each is launched with unused dynamic shared memory, the
// least that brings it down to K2's resident blocks per SM
// (residency_pad), and the variants' times differ from K2's by their
// work, not by their residency.

#include "blend_common.cuh"

namespace {

using namespace hugs_blend;

constexpr int kBatch = 128;
constexpr int kWords = kBatch / 32;
constexpr int kGrad = 9;  // the nine sums per instance; the radius has none
constexpr int kGroupLog = 3;
constexpr int kGroup = 1 << kGroupLog;
constexpr unsigned kAll = 0xffffffffu;

enum Variant : int {
  kFull = 0,
  kSkeleton = 1,
  kNoCull = 2,
  kNoShuffle = 3,
  kStagingOnly = 4,
  kMxu = 5  // K2 in the POWER_MXU mode
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

// One pixel's walk state: its centre, g, K1's final log T and walked
// count, and the Kahan sums S = s_acc - s_c and suffix = suf_log - suf_c.
struct Pixel {
  float px, py, g0, g1, g2, log_t, s_acc, s_c, suf_log, suf_c;
  int n_walk;
};

// The warp's cursor over its mask of kept instances in one batch, back to
// front. Every lane holds the same cursor.
struct Cursor {
  const unsigned* mask;  // kWords words in shared memory
  int word;
  unsigned bits;
  __device__ __forceinline__ bool more() {
    while (bits == 0u && word > 0) bits = mask[--word];
    return bits != 0u;
  }
  // the next kept instance, or -1 when none is left
  __device__ __forceinline__ int pop() {
    if (!more()) return -1;
    const int hb = 31 - __clz(bits);
    bits &= ~(1u << hb);
    return word * 32 + hb;
  }
};

// One group of the POWER_MXU mode: the rows (mxu_group_row) and powers
// of its kGroupN columns; column c's slot is rows[c][1].w, -1 past the
// group's end.
struct MxuGroup {
  const float4 (*rows)[2];
  const float (*power)[kPowStride];
};

// The nine sums of one pair: instance row f at the pixel p, whose walk
// reaches it if `live`. Advances the pixel's compensated sums. kMxuAlpha:
// the instance's group row `row` in place of f and the alpha from the
// POWER_MXU mode's `power` (the gradient math is the exact mode's,
// pallas_blend.py:589-613).
template <bool kMxuAlpha>
__device__ __forceinline__ void pair_grad(Pixel& p, const float* f, bool live,
                                          float power, float d[kGrad],
                                          const float4* row = nullptr) {
#pragma unroll
  for (int k = 0; k < kGrad; ++k) d[k] = 0.0f;
  if (!live) return;
  float dx, dy;
  float alpha;
  if constexpr (kMxuAlpha) {
    alpha = pair_alpha_mxu(power, row[0], p.px, p.py, dx, dy);
  } else {
    alpha = pair_alpha(f[3], f[4], f[5], f[6], f[7], f[8], f[9], p.px, p.py,
                       dx, dy);
  }
  if (alpha <= 0.0f) return;
  // log T_i (exclusive) = log T_fin - (suffix behind i + la)
  const float la_c = log1pf(-alpha) - p.suf_c;
  const float pre = (p.log_t - p.suf_log) - la_c;
  const float ti = pre >= kLogTEps ? expf(pre) : 0.0f;
  const float w = alpha * ti;
  float gc;
  if constexpr (kMxuAlpha) {
    gc = p.g0 * row[1].x + p.g1 * row[1].y + p.g2 * row[1].z;
  } else {
    gc = p.g0 * f[0] + p.g1 * f[1] + p.g2 * f[2];
  }
  const float d_alpha =
      gc * ti - (p.s_acc - p.s_c) / fmaxf(1.0f - alpha, 1e-6f);
  const float suf_new = p.suf_log + la_c;
  p.suf_c = (suf_new - p.suf_log) - la_c;
  p.suf_log = suf_new;
  const float wg_c = w * gc - p.s_c;
  const float s_new = p.s_acc + wg_c;
  p.s_c = (s_new - p.s_acc) - wg_c;
  p.s_acc = s_new;
  const float dp = alpha < kMaxAlpha ? d_alpha * alpha : 0.0f;
  d[0] = p.g0 * w;
  d[1] = p.g1 * w;
  d[2] = p.g2 * w;
  d[3] = dp;
  d[4] = dp * dx;
  d[5] = dp * dy;
  d[6] = d[4] * dx;
  d[7] = d[4] * dy;
  d[8] = d[5] * dy;
}

// The skeleton's stand-in for pair_grad: one multiply per sum.
__device__ __forceinline__ void pair_skel(const Pixel& p, const float* f,
                                          bool live, float d[kGrad]) {
  const float s = live ? p.g0 : 0.0f;
#pragma unroll
  for (int k = 0; k < kGrad; ++k) d[k] = s * f[k];
}

// The warp's sums of 2^L consecutive kept instances, reduce-scattered:
// `out` holds, for the instance `j` this lane was assigned (-1 if the
// group ran out), the sum of the partials of the 2^L lanes whose index
// differs from this lane's only in bits 4 down to 5 - L; lane bits 4 ..
// 5 - L pick the instance. Instances are computed back to front, and each
// stage runs as soon as both of its halves are computed. kMxu: `cur` is
// the group (MxuGroup), its instances its columns C, C + 1, ... in turn.
template <int L, int V, int C = 0, typename Cur = Cursor>
__device__ __forceinline__ void group_sums(Pixel& p, Cur& cur,
                                           float (*rows)[kFeat], int b0,
                                           int lane, float out[kGrad],
                                           int& j) {
  if constexpr (L == 0 && V == kMxu) {
    j = __float_as_int(cur.rows[C][1].w);
    pair_grad<true>(p, nullptr, j >= 0 && b0 + j < p.n_walk,
                    cur.power[C][lane], out, cur.rows[C]);
  } else if constexpr (L == 0) {
    j = cur.pop();
    const float* f = rows[j < 0 ? 0 : j];
    const bool live = j >= 0 && b0 + j < p.n_walk;
    if constexpr (V == kFull) {
      pair_grad<false>(p, f, live, 0.0f, out);
    } else {
      pair_skel(p, f, live, out);
    }
  } else {
    float a[kGrad], b[kGrad];
    int ja, jb;
    group_sums<L - 1, V, C, Cur>(p, cur, rows, b0, lane, a, ja);
    group_sums<L - 1, V, C + (1 << (L - 1)), Cur>(p, cur, rows, b0, lane, b,
                                                  jb);
    constexpr int off = 32 >> L;
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int k = 0; k < kGrad; ++k) {
      const float send = upper ? a[k] : b[k];
      const float keep = upper ? b[k] : a[k];
      out[k] = keep + __shfl_xor_sync(kAll, send, off);
    }
    j = upper ? jb : ja;
  }
}

// One 16x16 tile's work, variant V (the header says what each keeps).
// `out` is the variant's own output: grad_feat (N, 10) for kFull, kMxu,
// kSkeleton and kNoCull, the (H, W) per-pixel plane for kNoShuffle, the
// (T,) per-tile checksum for kStagingOnly. `mx`: kMxu's shared memory.
template <int V>
__device__ __forceinline__ void bwd_tile(const float* __restrict__ feat,
                                         const int* __restrict__ gauss_id,
                                         const int* __restrict__ starts,
                                         const float* __restrict__ bg,
                                         const float* __restrict__ log_t_fin,
                                         const int* __restrict__ n_walked,
                                         const float* __restrict__ grad,
                                         int width, int height, int nx,
                                         float* __restrict__ out,
                                         float* __restrict__ grad_bg,
                                         MxuShared<kBatch>* mx) {
  __shared__ float s_feat[kBatch][kFeat];
  __shared__ int s_gid[kBatch];
  __shared__ float s_part[kWarps][kBatch][kGrad];
  __shared__ unsigned s_mask[kWarps][kWords];
  __shared__ float s_bg[kWarps][3];
  __shared__ int s_walk[kWarps];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx0 = (t % nx) * kTile;
  const int ty0 = (t / nx) * kTile;
  const int px_i = tx0 + tid % kTile;
  const int py_i = ty0 + tid / kTile;
  const bool inside = px_i < width && py_i < height;
  const int start = starts[t];
  uint4 basis[2][2];  // kMxu's A fragments
  if constexpr (V == kMxu) {
    mxu_basis(warp, lane, basis);
    if (tid < kCofStride) mx->cof[kBatch][tid] = 0u;  // the zero record
  }

  // per-pixel setup: g, K1's final log T and walked count; the sums start
  // from the background's term
  Pixel p{static_cast<float>(px_i), static_cast<float>(py_i), 0.0f, 0.0f,
          0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0};
  if (inside) {
    const size_t q = static_cast<size_t>(py_i) * width + px_i;
    const size_t plane = static_cast<size_t>(width) * height;
    p.g0 = grad[q];
    p.g1 = grad[plane + q];
    p.g2 = grad[2 * plane + q];
    p.log_t = log_t_fin[q];
    p.n_walk = n_walked[q];
  }
  const float t_fin = p.log_t >= kLogTEps ? expf(p.log_t) : 0.0f;
  p.s_acc = (p.g0 * bg[0] + p.g1 * bg[1] + p.g2 * bg[2]) * t_fin;

  // the background's gradient, sum_p g T_fin, and the walk lengths
  const float gb0 = warp_sum(p.g0 * t_fin);
  const float gb1 = warp_sum(p.g1 * t_fin);
  const float gb2 = warp_sum(p.g2 * t_fin);
  const int wwalk = __reduce_max_sync(kAll, p.n_walk);  // the warp's
  if (lane == 0) {
    s_bg[warp][0] = gb0;
    s_bg[warp][1] = gb1;
    s_bg[warp][2] = gb2;
    s_walk[warp] = wwalk;
  }
  __syncthreads();
  int walk = 0;  // the most any pixel of the tile walked
#pragma unroll
  for (int w = 0; w < kWarps; ++w) walk = max(walk, s_walk[w]);
  if (tid < 3) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_bg[w][tid];
    if (v != 0.0f) atomicAdd(grad_bg + tid, v);
  }

  float acc[kGrad];  // kNoShuffle: this pixel's own nine sums
#pragma unroll
  for (int k = 0; k < kGrad; ++k) acc[k] = 0.0f;
  float chk = 0.0f;  // kStagingOnly: the rows this thread read

  for (int b = (walk + kBatch - 1) / kBatch - 1; b >= 0; --b) {
    const int b0 = b * kBatch;
    const int n = min(kBatch, walk - b0);
    // keeps every reader of s_feat, s_gid, s_part and s_mask (the previous
    // batch) ahead of this batch's writers
    __syncthreads();
    if (tid < n) {
      const int gid = gauss_id[start + b0 + tid];
      const float* f = feat + static_cast<size_t>(gid) * kFeat;
#pragma unroll
      for (int k = 0; k < kFeat; ++k) s_feat[tid][k] = f[k];
      s_gid[tid] = gid;
      if constexpr (V == kMxu) {
        mxu_record(s_feat[tid], static_cast<float>(tx0),
                   static_cast<float>(ty0), mx->cof[tid]);
      }
    }
    __syncthreads();

    if constexpr (V == kStagingOnly) {
      if (tid < n) {
        const float* f = s_feat[n - 1 - tid];
#pragma unroll
        for (int k = 0; k < kFeat; ++k) chk += f[k];
      }
      continue;
    }

    // the warp's mask: instances that can have alpha > 0 at one of its
    // pixels, and that some lane of it walked
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int i = w * 32 + lane;
      bool kept = i < n && b0 + i < wwalk;
      if constexpr (V != kNoCull) {
        kept = kept && warp_keep(s_feat[i], tx0, ty0, warp);
      }
      const unsigned m = __ballot_sync(kAll, kept);
      if (lane == 0) s_mask[warp][w] = m;
    }
    __syncwarp();

    if constexpr (V == kMxu) {
      // the warp's kept instances, back to front
      uint8_t* list = mx->list[warp];
      int cnt = 0;
#pragma unroll
      for (int w = kWords - 1; w >= 0; --w) {
        const unsigned m = s_mask[warp][w];
        if ((m >> lane) & 1u) {
          list[cnt + __popc(m & (0xfffffffeu << lane))] = 32 * w + lane;
        }
        cnt += __popc(m);
      }
      __syncwarp();
      // groups of kGroupN kept instances, each one group of the
      // reduce-scatter: a group's product and rows, then its sums
      MxuGroup cur{mx->rows[warp], mx->power[warp]};
#pragma unroll 1
      for (int c0 = 0; c0 < cnt; c0 += kGroupN) {
        const int c = c0 + (lane >> 2);
        const bool valid = c < cnt;
        const int slot = valid ? list[c] : 0;
        float d[2][4];
        mxu_product(basis, mx->cof, valid ? slot : kBatch, lane, d);
        // the rows' loads run while the product's chain completes
        mxu_group_row(s_feat[slot], slot, valid, lane, mx->rows[warp]);
        mxu_store(d, lane, mx->power[warp]);
        __syncwarp();
        float r[kGrad];
        int j;
        group_sums<kGroupLog, V>(p, cur, s_feat, b0, lane, r, j);
#pragma unroll
        for (int off = 16 >> kGroupLog; off > 0; off >>= 1) {
#pragma unroll
          for (int k = 0; k < kGrad; ++k) r[k] += __shfl_xor_sync(kAll, r[k], off);
        }
        if ((lane & (32 / kGroup - 1)) == 0 && j >= 0) {
#pragma unroll
          for (int k = 0; k < kGrad; ++k) s_part[warp][j][k] = r[k];
        }
        __syncwarp();  // the group's readers before the next one's writers
      }
    }
    Cursor cur{s_mask[warp], kWords, 0u};
    if constexpr (V == kNoShuffle) {
      for (int j = cur.pop(); j >= 0; j = cur.pop()) {
        float d[kGrad];
        pair_skel(p, s_feat[j], b0 + j < p.n_walk, d);
#pragma unroll
        for (int k = 0; k < kGrad; ++k) acc[k] += d[k];
      }
      continue;
    }
    if constexpr (V != kMxu) {
    while (cur.more()) {
      float r[kGrad];
      int j;
      group_sums<kGroupLog, V>(p, cur, s_feat, b0, lane, r, j);
#pragma unroll
      for (int off = 16 >> kGroupLog; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < kGrad; ++k) r[k] += __shfl_xor_sync(kAll, r[k], off);
      }
      if ((lane & (32 / kGroup - 1)) == 0 && j >= 0) {
#pragma unroll
        for (int k = 0; k < kGrad; ++k) s_part[warp][j][k] = r[k];
      }
    }
    }
    __syncthreads();

    // one thread per instance: the warps' sums in warp order, then the
    // instance's gradient onto its Gaussian
    if (tid < n) {
      const unsigned bit = 1u << (tid & 31);
      bool any = false;
      float s[kGrad];
#pragma unroll
      for (int k = 0; k < kGrad; ++k) s[k] = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (s_mask[w][tid >> 5] & bit) {
          any = true;
#pragma unroll
          for (int k = 0; k < kGrad; ++k) s[k] += s_part[w][tid][k];
        }
      }
      if (any) {
        float* dst = out + static_cast<size_t>(s_gid[tid]) * kFeat;
        if constexpr (V == kFull || V == kMxu) {
          const float* f = s_feat[tid];
          const float op = f[3], ca = f[6], cb = f[7], cc = f[8];
          const float g[kGrad] = {
              s[0], s[1], s[2], op > 0.0f ? s[3] / op : 0.0f,
              -(ca * s[4] + cb * s[5]), -(cc * s[5] + cb * s[4]),
              -0.5f * s[6], -s[7], -0.5f * s[8]};
#pragma unroll
          for (int k = 0; k < kGrad; ++k) {
            if (g[k] != 0.0f) atomicAdd(dst + k, g[k]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < kGrad; ++k) {
            if (s[k] != 0.0f) atomicAdd(dst + k, s[k]);
          }
        }
      }
    }
  }

  if constexpr (V == kNoShuffle) {
    if (inside) {
      float total = 0.0f;
#pragma unroll
      for (int k = 0; k < kGrad; ++k) total += acc[k];
      out[static_cast<size_t>(py_i) * width + px_i] = total;
    }
  }
  if constexpr (V == kStagingOnly) {
    chk = warp_sum(chk);
    if (lane == 0 && chk != 0.0f) atomicAdd(out + t, chk);
  }
}

__global__ void __launch_bounds__(kThreads)
blend_bwd_kernel(const float* __restrict__ feat,
                 const int* __restrict__ gauss_id,
                 const int* __restrict__ starts,
                 const float* __restrict__ bg,
                 const float* __restrict__ log_t_fin,
                 const int* __restrict__ n_walked,
                 const float* __restrict__ grad,
                 int width, int height, int nx,
                 float* __restrict__ grad_feat,
                 float* __restrict__ grad_bg) {
  bwd_tile<kFull>(feat, gauss_id, starts, bg, log_t_fin, n_walked, grad,
                  width, height, nx, grad_feat, grad_bg, nullptr);
}

// K2 in the POWER_MXU mode: the mode's shared memory is dynamic. Held to
// K2's 3 blocks per SM by its launch bounds (80 registers; unbounded,
// ptxas takes more and leaves 2 blocks, PERF.md).
__global__ void __launch_bounds__(kThreads, 3)
blend_bwd_mxu_kernel(const float* __restrict__ feat,
                     const int* __restrict__ gauss_id,
                     const int* __restrict__ starts,
                     const float* __restrict__ bg,
                     const float* __restrict__ log_t_fin,
                     const int* __restrict__ n_walked,
                     const float* __restrict__ grad,
                     int width, int height, int nx,
                     float* __restrict__ grad_feat,
                     float* __restrict__ grad_bg) {
  extern __shared__ __align__(16) unsigned char s_mxu[];
  bwd_tile<kMxu>(feat, gauss_id, starts, bg, log_t_fin, n_walked, grad, width,
                 height, nx, grad_feat, grad_bg,
                 reinterpret_cast<MxuShared<kBatch>*>(s_mxu));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
blend_bwd_skeleton_kernel(const float* __restrict__ feat,
                          const int* __restrict__ gauss_id,
                          const int* __restrict__ starts,
                          const float* __restrict__ bg,
                          const float* __restrict__ log_t_fin,
                          const int* __restrict__ n_walked,
                          const float* __restrict__ grad,
                          int width, int height, int nx,
                          float* __restrict__ out,
                          float* __restrict__ grad_bg) {
  bwd_tile<V>(feat, gauss_id, starts, bg, log_t_fin, n_walked, grad, width,
              height, nx, out, grad_bg, nullptr);
}

// The dynamic shared memory (bytes, a multiple of 128) that the launch of
// variant V requests so that it has K2's resident blocks per SM: the
// least that does, 0 if it has no more blocks than K2 already; -1 if no
// amount gives exactly K2's count or a query fails. Found once.
template <int V>
int residency_pad() {
  static int pad = -2;
  if (pad != -2) return pad;
  pad = -1;
  const auto kernel = blend_bwd_skeleton_kernel<V>;
  const int target = blocks_per_sm(blend_bwd_kernel);
  int dev = 0, optin = 0;
  cudaFuncAttributes attr{};
  if (target <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) {
    return pad;
  }
  const int room = optin - static_cast<int>(attr.sharedSizeBytes);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           room) != cudaSuccess) {
    return pad;
  }
  for (int p = 0; p <= room; p += 128) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                      p) != cudaSuccess) {
      return pad;
    }
    if (n <= target) {
      if (n == target) pad = p;
      return pad;
    }
  }
  return pad;
}

template <int V>
cudaError_t launch_skeleton(const float* feat, const int* gauss_id,
                            const int* starts, const float* bg,
                            const float* log_t_fin, const int* n_walked,
                            const float* grad, int width, int height, int nx,
                            int n_tiles, float* out, float* grad_bg,
                            cudaStream_t stream) {
  const int pad = residency_pad<V>();
  if (pad < 0) return cudaErrorInvalidConfiguration;
  blend_bwd_skeleton_kernel<V><<<n_tiles, kThreads, pad, stream>>>(
      feat, gauss_id, starts, bg, log_t_fin, n_walked, grad, width, height,
      nx, out, grad_bg);
  return cudaGetLastError();
}

// Variant V's resident blocks per SM at its pad; -1 as residency_pad.
template <int V>
int skeleton_blocks_per_sm(int* pad) {
  *pad = residency_pad<V>();
  int n = 0;
  if (*pad < 0 || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &n, blend_bwd_skeleton_kernel<V>, kThreads, *pad) !=
                      cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace

// Launches K2 on `stream` over n_tiles = nx * ny tiles of 16x16 pixels.
// feat: (N, 10) float32 (the forward's); gauss_id, starts:
// the forward's instance list and per-tile segment starts; bg: (3,);
// log_t_fin and n_walked: K1's (H, W) outputs; grad: (3, H, W)
// dL/d(raw colour). Adds each Gaussian's gradient into columns 0-8 of
// grad_feat (N, 10) and the background's into grad_bg (3,); the caller
// zeroes both. Returns cudaGetLastError().
extern "C" int hugs_blend_bwd(const float* feat, const int* gauss_id,
                              const int* starts, const float* bg,
                              const float* log_t_fin, const int* n_walked,
                              const float* grad, int width, int height,
                              int nx, int n_tiles, float* grad_feat,
                              float* grad_bg, void* stream) {
  if (n_tiles > 0) {
    blend_bwd_kernel<<<n_tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        feat, gauss_id, starts, bg, log_t_fin, n_walked, grad, width, height,
        nx, grad_feat, grad_bg);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K2 in the POWER_MXU mode (blend_bwd_mxu_kernel), with
// hugs_blend_bwd's arguments and outputs. Its static and dynamic shared
// memory together pass 48 KB, which the launch opts into once. Returns
// cudaGetLastError(), or the opt-in's error.
extern "C" int hugs_blend_bwd_mxu(const float* feat, const int* gauss_id,
                                  const int* starts, const float* bg,
                                  const float* log_t_fin, const int* n_walked,
                                  const float* grad, int width, int height,
                                  int nx, int n_tiles, float* grad_feat,
                                  float* grad_bg, void* stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      blend_bwd_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(MxuShared<kBatch>)));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  if (n_tiles > 0) {
    blend_bwd_mxu_kernel<<<n_tiles, kThreads, sizeof(MxuShared<kBatch>),
                           static_cast<cudaStream_t>(stream)>>>(
        feat, gauss_id, starts, bg, log_t_fin, n_walked, grad, width, height,
        nx, grad_feat, grad_bg);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches S3, K2's skeleton variant `variant` (1 kSkeleton, 2 kNoCull,
// 3 kNoShuffle, 4 kStagingOnly), with hugs_blend_bwd's arguments; `out`
// is the variant's output (bwd_tile), which the caller zeroes with
// grad_bg; each variant at K2's resident blocks per SM (residency_pad).
// Returns cudaGetLastError(), cudaErrorInvalidValue for another variant,
// or cudaErrorInvalidConfiguration if its residency cannot be pinned.
extern "C" int hugs_blend_bwd_skeleton(int variant, const float* feat,
                                       const int* gauss_id, const int* starts,
                                       const float* bg,
                                       const float* log_t_fin,
                                       const int* n_walked, const float* grad,
                                       int width, int height, int nx,
                                       int n_tiles, float* out,
                                       float* grad_bg, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant < kSkeleton || variant > kStagingOnly) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
#define HUGS_SKELETON(V)                                                     \
  launch_skeleton<V>(feat, gauss_id, starts, bg, log_t_fin, n_walked, grad, \
                     width, height, nx, n_tiles, out, grad_bg, s)
  cudaError_t err;
  switch (variant) {
    case kSkeleton: err = HUGS_SKELETON(kSkeleton); break;
    case kNoCull: err = HUGS_SKELETON(kNoCull); break;
    case kNoShuffle: err = HUGS_SKELETON(kNoShuffle); break;
    default: err = HUGS_SKELETON(kStagingOnly); break;
  }
#undef HUGS_SKELETON
  return static_cast<int>(err);
}

// K2's resident blocks per SM, from the occupancy calculator.
extern "C" int hugs_blend_bwd_blocks_per_sm() {
  return blocks_per_sm(blend_bwd_kernel);
}

// The mode's K2's resident blocks per SM, and in *dynamic the dynamic
// shared memory (bytes) it is launched with; -1 where the opt-in fails.
extern "C" int hugs_blend_bwd_mxu_blocks_per_sm(int* dynamic) {
  *dynamic = static_cast<int>(sizeof(MxuShared<kBatch>));
  if (cudaFuncSetAttribute(blend_bwd_mxu_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *dynamic) != cudaSuccess) {
    return -1;
  }
  return blocks_per_sm(blend_bwd_mxu_kernel, sizeof(MxuShared<kBatch>));
}

// Skeleton variant `variant`'s resident blocks per SM as it is launched,
// and in *pad the dynamic shared memory that pins it; -1 for another
// variant or where residency_pad fails.
extern "C" int hugs_blend_bwd_skeleton_blocks_per_sm(int variant, int* pad) {
  *pad = -1;
  switch (variant) {
    case kSkeleton: return skeleton_blocks_per_sm<kSkeleton>(pad);
    case kNoCull: return skeleton_blocks_per_sm<kNoCull>(pad);
    case kNoShuffle: return skeleton_blocks_per_sm<kNoShuffle>(pad);
    case kStagingOnly: return skeleton_blocks_per_sm<kStagingOnly>(pad);
    default: return -1;
  }
}
