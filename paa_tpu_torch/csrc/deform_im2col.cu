// Deformable im2col (K4) for Hopper, sm_90a: the sampling step of the
// deformable convolution v2 (mask) and v1 (no mask), the DCNs of the
// dcnv2 bodies' stages 3-5 and of the dense heads' towers.
//
// Replaces no TPU kernel: the JAX package's deformable convolution
// (paa_tpu/ops/dcn.py, "gather" and "auto") is XLA, not Pallas. It was
// added because its plain PyTorch port (ops/dcn.py::deform_conv2d)
// built a patch table of four corners per pixel, gathered 4C values per
// (position, tap), weighted and summed them in separate passes and
// permuted the columns once more for the product: about 79% of the
// X-152 serving call's device time, for work that is a small fraction
// of it.
//
// What it computes, per output position p = (oh, ow) of an image, tap
// k = (i, j) of the kh x kw kernel and deformable group g, as
// ops/deform_sampling.py::_geometry does: the sample (ys, xs) =
// (oh * stride - pad + i * dil) + dy, (ow * stride - pad + j * dil) + dx
// in float32, summed in that order; its top-left corner floor(ys),
// floor(xs) and fractions; the centre gate -1 < ys < H && -1 < xs < W
// (the whole sample is zero outside it); the four bilinear corner
// weights, times the gate, times the v2 mask; corners off the image read
// 0 (deform_geometry.cuh, shared with K5, deform_col2im.cu). With
// -fmad=false every sample's corners and weights are those of _geometry
// bit for bit. Then for every channel c of the group, the
// weighted sum of the four corners in float32, rounded once to x's
// dtype, is written to the columns.
//
// Layout. x is read channels-last (B, H, W, C): a corner of a sample is
// C / dg contiguous values (the wrapper copies an NCHW x to channels-last
// first, 2 x x's bytes). The columns are (B, groups, Ho * Wo, K,
// C / groups) (K = kh * kw): for each image and conv group the matrix
// that the product (ops/dcn.py::_contract_columns) multiplies by that
// group's weight, so the product writes the NCHW output directly.
//
// What bounds it on the card: bytes. Each column value costs four
// corner reads (mostly L1 and L2 hits: neighbouring taps and positions
// share pixels) and one write, about 10 operations, so the column
// write, B * Ho * Wo * K * C * itemsize bytes, is the bound (1.24 GB at
// X-152's stage 3 at B = 8 in bf16, 0.37 ms at 3.35 TB/s).
//
// The design: a block takes ``tile`` consecutive output positions of
// one image. Its threads first compute each (position, tap, deformable
// group)'s four corner offsets and weights into shared memory, reading
// the offsets and mask coalesced along the positions. Then a 2-D block
// of ``lanes`` x ``rows`` threads writes the columns: a thread takes
// vectors of V channels (16 bytes or less: V divides C / groups and
// C / dg) and walks the block's (position, tap) rows, two at a time so
// that eight corner loads are in flight. A warp's lanes take
// neighbouring vectors of a row, so its corner reads are contiguous runs
// of the channels; where a conv group's share of a row is under 128
// bytes (C / groups of 8-32 in bf16), the warp spans as many rows as
// fill a 128-byte line of each group's columns, since a store
// instruction that touches more lines costs more (X-152's stage 3, with
// 32-byte shares, ran at 16% of its bound with a warp on one row, 54%
// with four). The columns are stored evict-first: the product reads them
// only after they have left L2, where x's pixels stay for their other
// taps. The host side (ops/deform_sampling.py::im2col_plan) chooses V,
// lanes, rows and the tile from C, C / groups, C / dg and K alone.

#include "deform_geometry.cuh"

namespace {

using deform::BF16;
using deform::F32;
using deform::Pack;
using deform::Word;

constexpr int kUnroll = 2;  // (position, tap) rows a thread loads at once

// A sample's corners (tl, tr, bl, br): the element offset of the pixel in
// its image (-1 off the image) and the weight.
struct __align__(16) Sample {
  int off[4];
  float w[4];
};

struct Params {
  const void* x;      // (nb, H, W, C) channels-last
  const float* off;   // (nb, dg * K * 2, Ho, Wo), batch stride off_b
  const float* mask;  // (nb, dg * K, Ho, Wo), batch stride mask_b; or null
  void* col;          // (nb, C / cg, Ho * Wo, K, cg)
  int h, w, c, ho, wo, kh, kw, stride, pad, dil, cg, dg;
  long long off_b, mask_b;
  int tile, tiles;
};

template <typename Tr, int V>
__global__ void __launch_bounds__(256) im2col_kernel(const Params p) {
  using Raw = typename Tr::Raw;
  using W = typename Word<sizeof(Raw) * V>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  Sample* samples = reinterpret_cast<Sample*>(smem);

  const int b = blockIdx.x / p.tiles;
  const int npos = p.ho * p.wo;
  const int p0 = (blockIdx.x - b * p.tiles) * p.tile;
  const int np = min(p.tile, npos - p0);
  const int k_taps = p.kh * p.kw;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // geometry: sample j is position j % np of (group, tap) j / np
  const float* off = p.off + b * p.off_b;
  const float* mask = p.mask ? p.mask + b * p.mask_b : nullptr;
  for (int j = tid; j < np * k_taps * p.dg; j += nthreads) {
    const int gk = j / np;
    const int pos = p0 + (j - gk * np);
    const int g = gk / k_taps;
    const int k = gk - g * k_taps;
    const int oh = pos / p.wo;
    const int ow = pos - oh * p.wo;
    const int ti = k / p.kw;
    const float dy = off[static_cast<long long>(2 * gk) * npos + pos];
    const float dx = off[static_cast<long long>(2 * gk + 1) * npos + pos];
    const deform::Coords g0 = deform::sample_coords(
        dy, dx, oh, ow, ti, k - ti * p.kw, p.stride, p.pad, p.dil, p.h, p.w);
    float cw[4];
    deform::bilinear(g0.wy, g0.wx, cw);
    const float gate = g0.gate;
    const float m = mask ? mask[static_cast<long long>(gk) * npos + pos]
                         : 1.0f;
    Sample s;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int y = g0.yc + (q >> 1);
      const int x = g0.xc + (q & 1);
      s.off[q] = (y >= 0 && y < p.h && x >= 0 && x < p.w)
                     ? (y * p.w + x) * p.c : -1;
      s.w[q] = mask ? (cw[q] * gate) * m : cw[q] * gate;
    }
    samples[((pos - p0) * k_taps + k) * p.dg + g] = s;
  }
  __syncthreads();

  // columns: row r = (position - p0) * K + tap, one V-channel vector each
  const Raw* x = static_cast<const Raw*>(p.x) +
                 static_cast<long long>(b) * p.h * p.w * p.c;
  const long long plane = static_cast<long long>(npos) * k_taps * p.cg;
  Raw* col = static_cast<Raw*>(p.col) +
             static_cast<long long>(b) * (p.c / p.cg) * plane +
             static_cast<long long>(p0) * k_taps * p.cg;
  const int cdg = p.c / p.dg;
  const int nr = np * k_taps;
  const int step = blockDim.y * kUnroll;
  for (int v = threadIdx.x; v < p.c / V; v += blockDim.x) {
    const int c = v * V;
    const int gd = c / cdg;
    const int gc = c / p.cg;
    const Raw* xv = x + c;
    Raw* colv = col + gc * plane + (c - gc * p.cg);
    for (int r0 = threadIdx.y; r0 < nr; r0 += step) {
      Pack<Tr, V> a[kUnroll][4];
      float w[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * blockDim.y;
        if (r < nr) {
          const Sample s = samples[r * p.dg + gd];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            w[u][q] = s.w[q];
            if (s.off[q] >= 0) {
              a[u][q].word = __ldg(reinterpret_cast<const W*>(xv + s.off[q]));
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) a[u][q].raw[e] = 0;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * blockDim.y;
        if (r < nr) {
          Pack<Tr, V> out;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            float acc = w[u][0] * Tr::load(a[u][0].raw[e]);
#pragma unroll
            for (int q = 1; q < 4; ++q) {
              acc = acc + w[u][q] * Tr::load(a[u][q].raw[e]);
            }
            out.raw[e] = Tr::store(acc);
          }
          // streaming (evict-first): the columns are not read again before
          // they leave L2, where x's pixels are (each read by many taps)
          __stcs(reinterpret_cast<W*>(colv +
                                      static_cast<long long>(r) * p.cg),
                 out.word);
        }
      }
    }
  }
}

template <typename Tr, int V>
cudaError_t launch_vec(int vec, const Params& p, int blocks, dim3 block,
                       int smem, cudaStream_t stream) {
  if constexpr (V == 0) {
    return cudaErrorInvalidValue;
  } else {
    if (vec == V) {
      if constexpr (sizeof(typename Tr::Raw) * V <= 16) {
        im2col_kernel<Tr, V><<<blocks, block, smem, stream>>>(p);
        return cudaGetLastError();
      } else {
        return cudaErrorInvalidValue;
      }
    }
    return launch_vec<Tr, V / 2>(vec, p, blocks, block, smem, stream);
  }
}

}  // namespace

extern "C" {

// x (nb, H, W, C) channels-last of the dtype code (0 float32, 1 bfloat16),
// its address a multiple of vec elements; off, mask float32
// (nb, ., Ho, Wo) with each image's planes contiguous, batch strides
// off_b and mask_b in elements; mask null for a v1 conv; col (nb,
// C / cg, Ho * Wo, kh * kw, cg) of x's dtype. vec, tile, lanes and rows
// as ops/deform_sampling.py::im2col_plan chose them. Returns the launch's
// CUDA error code.
int paa_deform_im2col(const void* x, const float* off, const float* mask,
                      void* col, int dtype, int vec, int nb, int h, int w,
                      int c, int ho, int wo, int kh, int kw, int stride,
                      int pad, int dil, int cg, int dg, long long off_b,
                      long long mask_b, int tile, int lanes, int rows,
                      void* stream) {
  const int tiles = (ho * wo + tile - 1) / tile;
  const Params p{x, off, mask, col, h, w, c, ho, wo, kh, kw, stride, pad,
                 dil, cg, dg, off_b, mask_b, tile, tiles};
  const long long blocks = static_cast<long long>(nb) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = tile * kh * kw * dg * static_cast<int>(sizeof(Sample));
  const dim3 block(lanes, rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_vec<F32, 8>(vec, p, static_cast<int>(blocks), block, smem,
                               s);
      break;
    case 1:
      err = launch_vec<BF16, 8>(vec, p, static_cast<int>(blocks), block,
                                smem, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
