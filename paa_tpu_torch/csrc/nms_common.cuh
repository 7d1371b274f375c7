// What the two NMS kernels (nms_batched.cu, nms_global.cu) share: the
// (score, index) argmax and the bit-exact +1-convention IoU; and what
// nms_batched.cu's sort-and-sweep adds on top of them: the sort key of a
// score and the suppression test of one box by another.
//
// Bit-exactness: box_area and iou_gt follow the JAX kernels' op order
// (paa_tpu/ops/nms_pallas.py), every operation rounded on its own
// (__fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn; the build also passes
// -fmad=false), and compare iou > thresh in float32, so the kernels'
// picks equal the plain PyTorch version's.

#pragma once

#include <cuda_runtime.h>

namespace paa_nms {

constexpr float kNegInf = -1e30f;

// (s, i) beats (bs, bi): higher score, ties to the lower index
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// Warp-wide argmax; lane 0 ends with the warp's (bs, bi).
__device__ __forceinline__ void warp_argmax(float& bs, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, bs, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(os, oi, bs, bi)) {
      bs = os;
      bi = oi;
    }
  }
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

// IoU of box a (the pick) and box b, +1 convention, > thresh
__device__ __forceinline__ bool iou_gt(float ax1, float ay1, float ax2,
                                       float ay2, float aarea, float bx1,
                                       float by1, float bx2, float by2,
                                       float barea, float thresh) {
  const float w = fmaxf(
      __fadd_rn(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 1.0f), 0.0f);
  const float h = fmaxf(
      __fadd_rn(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 1.0f), 0.0f);
  const float inter = __fmul_rn(w, h);
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(aarea, barea), inter)) >
         thresh;
}

// Sort key of a score: ascending keys are descending scores, and -0 and
// +0 share a key, since the greedy argmax ties them. NaN is never keyed:
// a valid NaN ends its row before any pick.
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? u : ~(u | 0x80000000u);
}

// Whether box a, once picked, suppresses candidate b: the greedy step's
// iou_gt(a, b) > thresh, given both areas (box_area). Boxes that do not
// overlap skip the division: their intersection is 0 (or NaN), and so is
// their IoU, which is above no threshold >= 0. The caller compares labels.
__device__ __forceinline__ bool suppresses(float4 a, float aarea, float4 b,
                                           float barea, float thresh) {
  const float iw = __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)),
                             1.0f);
  const float ih = __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)),
                             1.0f);
  if (thresh >= 0.0f && !(iw > 0.0f && ih > 0.0f)) return false;
  return iou_gt(a.x, a.y, a.z, a.w, aarea, b.x, b.y, b.z, b.w, barea,
                thresh);
}

}  // namespace paa_nms
