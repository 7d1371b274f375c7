// What the deformable convolution's two kernels share: K4
// (deform_im2col.cu, the forward's sampling) and K5 (deform_col2im.cu,
// its gradient) compute every sample's corners, fractions and gate with
// the functions below, so that K5 differentiates exactly the samples K4
// took, and both those of ops/deform_sampling.py::_geometry bit for bit
// (built with -fmad=false).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace deform {

// Element types by their bits.
struct F32 {
  using Raw = unsigned;
  __device__ static float load(Raw r) { return __uint_as_float(r); }
  __device__ static Raw store(float v) { return __float_as_uint(v); }
};
struct BF16 {
  using Raw = unsigned short;
  __device__ static float load(Raw r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  __device__ static Raw store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// One load or store of Bytes.
template <int Bytes> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = unsigned; };
template <> struct Word<2> { using T = unsigned short; };

// V elements as one word.
template <typename Tr, int V>
union Pack {
  typename Word<sizeof(typename Tr::Raw) * V>::T word;
  typename Tr::Raw raw[V];
};

// One sample of output position (oh, ow), kernel tap (ti, tj): its
// top-left corner (yc, xc), clamped into [-1, H - 1] x [-1, W - 1] as
// the plain version's 1-padded frame clamps it (a no-op where the gate
// is open; NaN goes to -1), its fractions (wy, wx) and the centre gate
// (the whole sample is zero unless -1 < ys < H and -1 < xs < W).
struct Coords {
  int yc, xc;
  float wy, wx, gate;
};

__device__ inline Coords sample_coords(float dy, float dx, int oh, int ow,
                                       int ti, int tj, int stride, int pad,
                                       int dil, int h, int w) {
  // (oh * stride - pad + ti * dil) + dy, summed in _geometry's order
  const float ys = static_cast<float>(oh * stride - pad + ti * dil) + dy;
  const float xs = static_cast<float>(ow * stride - pad + tj * dil) + dx;
  const float y0 = floorf(ys);
  const float x0 = floorf(xs);
  Coords s;
  s.wy = ys - y0;
  s.wx = xs - x0;
  s.gate = (ys > -1.0f && ys < static_cast<float>(h) && xs > -1.0f &&
            xs < static_cast<float>(w))
               ? 1.0f : 0.0f;
  s.yc = static_cast<int>(fminf(fmaxf(y0, -1.0f), static_cast<float>(h - 1)));
  s.xc = static_cast<int>(fminf(fmaxf(x0, -1.0f), static_cast<float>(w - 1)));
  return s;
}

// The bilinear weights of the corners (tl, tr, bl, br), before the gate
// and the mask.
__device__ inline void bilinear(float wy, float wx, float (&cw)[4]) {
  cw[0] = (1.0f - wy) * (1.0f - wx);
  cw[1] = (1.0f - wy) * wx;
  cw[2] = wy * (1.0f - wx);
  cw[3] = wy * wx;
}

}  // namespace deform
