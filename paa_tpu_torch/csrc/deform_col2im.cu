// Deformable col2im (K5) for Hopper, sm_90a: the gradient of the
// deformable convolution's sampling (K4, deform_im2col.cu) with respect
// to x, the offsets and the v2 mask, given the columns' gradient dcol.
//
// Replaces no TPU kernel: the JAX package's deformable convolution
// (paa_tpu/ops/dcn.py, "gather" and "auto") is XLA, not Pallas, and its
// gradient is XLA's transpose of the gather. It was added because the
// port's backward (ops/dcn.py::DeformConv2dFunction) recomputed the plain
// sampling under autograd and took its VJP: 78% of an X-152 training
// step, in small elementwise kernels and a row gather's index_add.
//
// What it computes, per sample (image, output position, tap k,
// deformable group g) and per channel c of the group, with the corners,
// fractions (wy, wx), gate and mask m of deform_geometry.cuh (the ones
// K4 took, so the corners at integer coordinates are the plain
// version's floor corners and the derivative there is its one-sided
// one), the four corner values a_q of x and d = dcol[c]:
//
//   dx[corner q, c]  += d * cw_q * gate * m   (corners off the image, on
//                                              the zero ring, are dropped)
//   d dy             += gate * m * d * ((1 - wx)(a_bl - a_tl)
//                                       + wx (a_br - a_tr))
//   d dx (offset)    += gate * m * d * ((1 - wy)(a_tr - a_tl)
//                                       + wy (a_br - a_bl))
//   d m              += gate * d * sum_q cw_q a_q
//
// the last three summed over the group's channels. All in float32, dx
// rounded once into x's dtype by a second kernel;
// ops/deform_sampling.py::_col2im_grads is the plain version.
//
// Layout. dcol is K4's column layout (B, groups, Ho * Wo, K, C / groups)
// in x's dtype; x is read channels-last (B, H, W, C); K5 adds dx into a
// float32 channels-last accumulator (B, H, W, C), zeroed by the wrapper,
// which a second kernel (finish_kernel) writes into dx (B, C, H, W) in
// x's dtype through shared-memory tiles; the offsets' and the mask's
// gradients are float32 (B, dg * K * 2, Ho, Wo) and (B, dg * K, Ho, Wo),
// written once each.
//
// What bounds it on the card: dx is a scatter. Each (sample, channel)
// adds into four pixels, about 2.5 G float32 adds for one of X-152's
// stage-3 layers at B = 8, while the bytes it must move (dcol and x read
// once, dx written once) take 0.5 ms; device-memory atomics at that count
// bind first. So a block's output tile (tile_h x tile_w positions)
// reads pixels within its receptive field plus a margin (the offsets are
// a few pixels): its window. After the geometry the block sorts its
// samples' corners inside that window into per-pixel lists in shared
// memory (counts by integer shared atomics, a scan, then each corner's
// dcol row and weight placed), once for all channels; then each thread
// takes a (pixel, vector) of the window, sums its corners' dcol x weight
// in registers and adds the sum into dx once. Corners outside the window
// go to device memory directly, with atomicAdd on float4
// (red.global.add.v4.f32 on sm_90), neighbouring lanes on neighbouring
// channels, so a warp's reduction covers whole 128-byte lines of dx. (On
// an H100 at X-152's shapes, vector reductions for every corner ran 2.3x
// slower than the lists, and shared float adds in place of the lists
// 1.5x slower than those reductions; x's window staged in shared memory
// for the corners' reads, 1.2x slower than reading them through L1.) A
// layer whose window has more pixels than the lists' bins hold is
// refused by the host side.
//
// A block takes one tile of one image, all its channels: its samples'
// geometry goes to shared memory first, as K4's; then a 2-D block of
// lanes x rows threads walks (position, tap) rows and V-channel vectors
// (16 bytes of x and dcol or less), two rows at a time, for the offsets'
// and the mask's sums. A warp reads dcol as K4 writes it: where a conv
// group's share of a row is under 128 bytes, the warp spans as many rows
// as fill a line. A sample's sums of d x a_q over its deformable group's
// channels (one for each corner q) are taken by shuffles across the
// lanes of a warp that share the group; the offsets' and the mask's sums
// are linear in them (the formulas above), and go by shared adds across
// warps and channel slices, written once by one thread. The host side
// (ops/deform_sampling.py::col2im_plan) chooses V, lanes, rows and the
// tile from C, C / groups, C / dg, the kernel, stride and dilation, and
// the item size alone.

#include "deform_geometry.cuh"

namespace {

using deform::BF16;
using deform::F32;
using deform::Pack;
using deform::Word;

constexpr int kUnroll = 2;  // (position, tap) rows a thread loads at once

// A sample: its top-left corner, fractions, gate and mask (1 for v1),
// and its row of dcol in the image's plane (position * K + tap).
struct __align__(16) Sample {
  int yc, xc;
  float wy, wx, gate, m;
  int row, unused;
};

struct Params {
  const void* x;      // (nb, H, W, C) channels-last
  const void* dcol;   // (nb, C / cg, Ho * Wo, K, cg)
  const float* off;   // (nb, dg * K * 2, Ho, Wo), batch stride off_b
  const float* mask;  // (nb, dg * K, Ho, Wo), batch stride mask_b; or null
  float* dx;          // (nb, H, W, C) float32, zeroed
  float* doff;        // (nb, dg * K * 2, Ho, Wo)
  float* dmask;       // (nb, dg * K, Ho, Wo), or null
  int h, w, c, ho, wo, kh, kw, stride, pad, dil, cg, dg;
  long long off_b, mask_b;
  int tile_h, tile_w, tiles_h, tiles_w;
  int margin;  // the window's pixels beyond the taps' reach, each side
  int red;     // lanes of a warp whose vectors share a deformable group
};

// Adds V float32 values to dst: 16-byte vectors (one red.global.add.v4.f32
// each on sm_90) where V is a multiple of 4, else 8 bytes or 4.
template <int V>
__device__ inline void red_add(float* dst, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      atomicAdd(reinterpret_cast<float4*>(dst + i),
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
    }
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    atomicAdd(dst, v[0]);
  }
}

// The window's rows (or columns) for a tile of n positions along them.
__host__ __device__ inline int window_size(int n, int k, int stride, int dil,
                                           int margin) {
  return (n - 1) * stride + (k - 1) * dil + 2 * margin + 1;
}

// Shared memory of a block: samples and their three sums, the window's
// bins' starts and cursors, and four entries a sample (its dcol row and
// the corner's weight).
__host__ __device__ inline int shared_bytes(int cap, int bins) {
  return cap * (static_cast<int>(sizeof(Sample)) + 12) + (2 * bins + 1) * 4 +
         cap * 4 * 8;
}

template <typename Tr, int V>
__global__ void __launch_bounds__(256) col2im_kernel(const Params p) {
  using Raw = typename Tr::Raw;
  using W = typename Word<sizeof(Raw) * V>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int k_taps = p.kh * p.kw;
  const int cap = p.tile_h * p.tile_w * k_taps * p.dg;
  // the window: image rows wy0.., columns wx0..; a bin per pixel and
  // deformable group
  const int wh = window_size(p.tile_h, p.kh, p.stride, p.dil, p.margin);
  const int ww = window_size(p.tile_w, p.kw, p.stride, p.dil, p.margin);
  const int bins = wh * ww * p.dg;
  Sample* samples = reinterpret_cast<Sample*>(smem);
  float* acc = reinterpret_cast<float*>(samples + cap);  // 3 a sample
  int* start = reinterpret_cast<int*>(acc + 3 * cap);    // bins + 1
  int* cursor = start + bins + 1;                        // bins
  int* entry_row = cursor + bins;                        // 4 cap
  float* entry_w = reinterpret_cast<float*>(entry_row + 4 * cap);

  const int per_image = p.tiles_h * p.tiles_w;
  const int b = blockIdx.x / per_image;
  const int t = blockIdx.x - b * per_image;
  const int th = t / p.tiles_w;
  const int oh0 = th * p.tile_h;
  const int ow0 = (t - th * p.tiles_w) * p.tile_w;
  const int nw = min(p.tile_w, p.wo - ow0);
  const int np = min(p.tile_h, p.ho - oh0) * nw;
  const int npos = p.ho * p.wo;
  const int ns = np * k_taps * p.dg;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int wy0 = oh0 * p.stride - p.pad - p.margin;
  const int wx0 = ow0 * p.stride - p.pad - p.margin;

  // geometry: sample j is tile position j % np of (group, tap) j / np
  const float* off = p.off + b * p.off_b;
  const float* mask = p.mask ? p.mask + b * p.mask_b : nullptr;
  for (int j = tid; j < ns; j += nthreads) {
    const int gk = j / np;
    const int lp = j - gk * np;
    const int g = gk / k_taps;
    const int k = gk - g * k_taps;
    const int lr = lp / nw;
    const int oh = oh0 + lr;
    const int ow = ow0 + (lp - lr * nw);
    const int pos = oh * p.wo + ow;
    const int ti = k / p.kw;
    const deform::Coords g0 = deform::sample_coords(
        off[static_cast<long long>(2 * gk) * npos + pos],
        off[static_cast<long long>(2 * gk + 1) * npos + pos], oh, ow, ti,
        k - ti * p.kw, p.stride, p.pad, p.dil, p.h, p.w);
    Sample s;
    s.yc = g0.yc;
    s.xc = g0.xc;
    s.wy = g0.wy;
    s.wx = g0.wx;
    s.gate = g0.gate;
    s.m = mask ? mask[static_cast<long long>(gk) * npos + pos] : 1.0f;
    s.row = pos * k_taps + k;
    const int i = (lp * k_taps + k) * p.dg + g;
    samples[i] = s;
    acc[3 * i] = 0.0f;
    acc[3 * i + 1] = 0.0f;
    acc[3 * i + 2] = 0.0f;
  }
  for (int i = tid; i <= bins; i += nthreads) start[i] = 0;
  __syncthreads();

  // the bin of corner q of sample i, or -1 off the image, off the window
  // or where the gate is shut
  const auto bin_of = [&](const Sample& s, int q, int g) {
    const int y = s.yc + (q >> 1);
    const int xq = s.xc + (q & 1);
    const int wr = y - wy0;
    const int wc = xq - wx0;
    return (s.gate != 0.0f && y >= 0 && y < p.h && xq >= 0 && xq < p.w &&
            wr >= 0 && wr < wh && wc >= 0 && wc < ww)
               ? (wr * ww + wc) * p.dg + g : -1;
  };
  // the window's corners by bin: count, scan, place
  for (int j = tid; j < 4 * ns; j += nthreads) {
    const int i = j >> 2;
    const int bin = bin_of(samples[i], j & 3, i % p.dg);
    if (bin >= 0) atomicAdd(start + bin + 1, 1);
  }
  __syncthreads();
  if (tid < 32) {  // one warp: each lane a run of bins, then the runs'
    const int run = (bins + 31) / 32;
    const int lo = 1 + tid * run;
    const int hi = min(bins + 1, lo + run);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += start[i];
    int before = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, before, o);
      if (tid >= o) before += up;
    }
    before -= sum;
    for (int i = lo; i < hi; ++i) {
      before += start[i];
      start[i] = before;
    }
  }
  __syncthreads();
  for (int i = tid; i < bins; i += nthreads) cursor[i] = start[i];
  __syncthreads();
  for (int j = tid; j < 4 * ns; j += nthreads) {
    const int i = j >> 2;
    const int q = j & 3;
    const Sample s = samples[i];
    const int bin = bin_of(s, q, i % p.dg);
    if (bin < 0) continue;
    float cw[4];
    deform::bilinear(s.wy, s.wx, cw);
    const int slot = atomicAdd(cursor + bin, 1);
    entry_row[slot] = s.row;
    entry_w[slot] = (cw[q] * s.gate) * s.m;  // K4's corner weight
  }
  __syncthreads();

  const long long image = static_cast<long long>(p.h) * p.w * p.c;
  const Raw* x = static_cast<const Raw*>(p.x) + b * image;
  float* dx = p.dx + b * image;
  const long long plane = static_cast<long long>(npos) * k_taps * p.cg;
  const Raw* dcol = static_cast<const Raw*>(p.dcol) +
                    static_cast<long long>(b) * (p.c / p.cg) * plane;
  const int cdg = p.c / p.dg;
  const int nvec = p.c / V;
  const int nr = np * k_taps;
  const int lanes = blockDim.x;

  for (int v0 = 0; v0 < nvec; v0 += lanes) {
    const int v = v0 + threadIdx.x;
    const bool vok = v < nvec;
    const int c = v * V;
    const int gd = c / cdg;
    const int gc = c / p.cg;
    const Raw* xv = x + c;
    const Raw* dv = dcol + gc * plane + (c - gc * p.cg);
    // the samples: dcol against each corner (the offsets' and the mask's
    // sums follow from these four), and dx at corners outside the window.
    // Every thread takes the same trips through this loop: the shuffles
    // below need the whole warp
    for (int r0 = 0; r0 < nr; r0 += blockDim.y * kUnroll) {
      float part[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        part[u][0] = part[u][1] = part[u][2] = part[u][3] = 0.0f;
        const int r = r0 + threadIdx.y + u * blockDim.y;
        if (!vok || r >= nr) continue;
        const Sample s = samples[r * p.dg + gd];
        if (s.gate == 0.0f) continue;  // the whole sample is zero
        Pack<Tr, V> dp;
        dp.word = __ldg(reinterpret_cast<const W*>(
            dv + static_cast<long long>(s.row) * p.cg));
        Pack<Tr, V> a[4];
        int pix[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int y = s.yc + (q >> 1);
          const int xq = s.xc + (q & 1);
          pix[q] = (y >= 0 && y < p.h && xq >= 0 && xq < p.w)
                       ? y * p.w + xq : -1;
          if (pix[q] >= 0) {
            a[q].word = __ldg(reinterpret_cast<const W*>(
                xv + static_cast<long long>(pix[q]) * p.c));
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) a[q].raw[e] = 0;
          }
        }
        float cw[4];
        deform::bilinear(s.wy, s.wx, cw);
        float d[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          d[e] = Tr::load(dp.raw[e]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            part[u][q] = part[u][q] + d[e] * Tr::load(a[q].raw[e]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (pix[q] < 0) continue;
          if (bin_of(s, q, gd) >= 0) continue;  // the window's, below
          const float wq = (cw[q] * s.gate) * s.m;  // K4's corner weight
          float add[V];
#pragma unroll
          for (int e = 0; e < V; ++e) add[e] = wq * d[e];
          red_add<V>(dx + static_cast<long long>(pix[q]) * p.c + c, add);
        }
      }
      // each corner's sum over the deformable group's lanes of the warp;
      // then, per group of lanes, the offsets' and the mask's sums from
      // them (K5's formulas, linear in the corners' sums), one shared add
      // each
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        for (int o = 1; o < p.red; o <<= 1) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            part[u][q] += __shfl_xor_sync(0xffffffffu, part[u][q], o);
          }
        }
        const int r = r0 + threadIdx.y + u * blockDim.y;
        if (vok && r < nr && (threadIdx.x & (p.red - 1)) == 0) {
          const Sample s = samples[r * p.dg + gd];
          if (s.gate == 0.0f) continue;
          float cw[4];
          deform::bilinear(s.wy, s.wx, cw);
          const float sum[3] = {
              (1.0f - s.wx) * (part[u][2] - part[u][0]) +
                  s.wx * (part[u][3] - part[u][1]),
              (1.0f - s.wy) * (part[u][1] - part[u][0]) +
                  s.wy * (part[u][3] - part[u][2]),
              cw[0] * part[u][0] + cw[1] * part[u][1] + cw[2] * part[u][2] +
                  cw[3] * part[u][3]};
          float* sums = acc + 3 * (r * p.dg + gd);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            if (sum[i] != 0.0f) atomicAdd(sums + i, sum[i]);
          }
        }
      }
    }
    // the window's pixels: each bin's corners summed in registers, then
    // added into dx once
    for (int px = threadIdx.y; vok && px < wh * ww; px += blockDim.y) {
      const int bin = px * p.dg + gd;
      const int e1 = start[bin + 1];
      int e = start[bin];
      if (e == e1) continue;
      const int wr = px / ww;
      const int y = wy0 + wr;
      const int xq = wx0 + (px - wr * ww);
      float sum[V];
#pragma unroll
      for (int i = 0; i < V; ++i) sum[i] = 0.0f;
      for (; e < e1; ++e) {
        Pack<Tr, V> dp;
        dp.word = __ldg(reinterpret_cast<const W*>(
            dv + static_cast<long long>(entry_row[e]) * p.cg));
        const float wq = entry_w[e];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          sum[i] = sum[i] + wq * Tr::load(dp.raw[i]);
        }
      }
      red_add<V>(dx + (static_cast<long long>(y) * p.w + xq) * p.c + c,
                 sum);
    }
  }
  __syncthreads();

  // the offsets' and the mask's gradients, one thread a sample
  const long long planes = static_cast<long long>(b) * p.dg * k_taps * npos;
  float* doff = p.doff + 2 * planes;
  float* dmask = p.dmask ? p.dmask + planes : nullptr;
  for (int j = tid; j < ns; j += nthreads) {
    const int gk = j / np;
    const int lp = j - gk * np;
    const int g = gk / k_taps;
    const int k = gk - g * k_taps;
    const int lr = lp / nw;
    const int pos = (oh0 + lr) * p.wo + ow0 + (lp - lr * nw);
    const int i = (lp * k_taps + k) * p.dg + g;
    const float gm = samples[i].gate * samples[i].m;
    doff[static_cast<long long>(2 * gk) * npos + pos] = gm * acc[3 * i];
    doff[static_cast<long long>(2 * gk + 1) * npos + pos] =
        gm * acc[3 * i + 1];
    if (dmask) {
      dmask[static_cast<long long>(gk) * npos + pos] =
          samples[i].gate * acc[3 * i + 2];
    }
  }
}

// dx from the float32 accumulator (nb, H * W, C) into x's dtype and NCHW
// (nb, C, H * W): 32 x 32 tiles of (pixel, channel) through shared memory,
// read along the channels and written along the pixels.
template <typename Tr>
__global__ void __launch_bounds__(256) finish_kernel(const float* acc,
                                                      void* out, int hw,
                                                      int c) {
  __shared__ float tile[32][33];
  const long long image = static_cast<long long>(hw) * c;
  const float* a = acc + blockIdx.z * image;
  typename Tr::Raw* o = static_cast<typename Tr::Raw*>(out) +
                        blockIdx.z * image;
  const int p0 = blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int px = p0 + i;
    const int ch = c0 + threadIdx.x;
    tile[i][threadIdx.x] =
        (px < hw && ch < c) ? a[static_cast<long long>(px) * c + ch] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int ch = c0 + i;
    const int px = p0 + threadIdx.x;
    if (px < hw && ch < c) {
      o[static_cast<long long>(ch) * hw + px] =
          Tr::store(tile[threadIdx.x][i]);
    }
  }
}

template <typename Tr>
cudaError_t finish(const float* acc, void* out, int nb, int hw, int c,
                   cudaStream_t stream) {
  const dim3 grid((hw + 31) / 32, (c + 31) / 32, nb);
  finish_kernel<Tr><<<grid, dim3(32, 8), 0, stream>>>(acc, out, hw, c);
  return cudaGetLastError();
}

template <typename Tr, int V>
cudaError_t launch(const Params& p, int blocks, dim3 block, int smem,
                   cudaStream_t stream) {
  const auto kernel = col2im_kernel<Tr, V>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, block, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tr, int V>
cudaError_t launch_vec(int vec, const Params& p, int blocks, dim3 block,
                       int smem, cudaStream_t stream) {
  if constexpr (V == 0) {
    return cudaErrorInvalidValue;
  } else {
    if (vec == V) {
      if constexpr (sizeof(typename Tr::Raw) * V <= 16) {
        return launch<Tr, V>(p, blocks, block, smem, stream);
      } else {
        return cudaErrorInvalidValue;
      }
    }
    return launch_vec<Tr, V / 2>(vec, p, blocks, block, smem, stream);
  }
}

}  // namespace

extern "C" {

// x (nb, H, W, C) channels-last of the dtype code (0 float32, 1
// bfloat16), its address a multiple of vec elements; dcol (nb, C / cg,
// Ho * Wo, kh * kw, cg) contiguous of x's dtype; off, mask float32 (nb,
// ., Ho, Wo) with each image's planes contiguous, batch strides off_b
// and mask_b in elements, mask null for a v1 conv; acc float32 (nb, H,
// W, C) zeroed, K5's sums of dx; dx (nb, C, H, W) contiguous of x's
// dtype, written from acc by a second kernel; doff float32 (nb, dg * kh
// * kw * 2, Ho, Wo) and dmask float32 (nb, dg * kh * kw, Ho, Wo) (null
// for v1) contiguous. The launch (vec, tile, margin, lanes, rows, red)
// as ops/deform_sampling.py::col2im_plan chose it. Returns the first
// launch error's CUDA code.
int paa_deform_col2im(const void* x, const void* dcol, const float* off,
                      const float* mask, float* acc, void* dx, float* doff,
                      float* dmask, int dtype, int vec, int nb, int h,
                      int w, int c, int ho, int wo, int kh, int kw,
                      int stride, int pad, int dil, int cg, int dg,
                      long long off_b, long long mask_b, int tile_h,
                      int tile_w, int margin, int lanes, int rows, int red,
                      void* stream) {
  const int tiles_h = (ho + tile_h - 1) / tile_h;
  const int tiles_w = (wo + tile_w - 1) / tile_w;
  const Params p{x, dcol, off, mask, acc, doff, dmask, h, w, c, ho, wo, kh,
                 kw, stride, pad, dil, cg, dg, off_b, mask_b, tile_h,
                 tile_w, tiles_h, tiles_w, margin, red};
  const long long blocks = static_cast<long long>(nb) * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL || nb > 65535 || red < 1 || red > 32 ||
      (red & (red - 1)) || lanes % red) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = shared_bytes(
      tile_h * tile_w * kh * kw * dg,
      window_size(tile_h, kh, stride, dil, margin) *
          window_size(tile_w, kw, stride, dil, margin) * dg);
  const dim3 block(lanes, rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_vec<F32, 8>(vec, p, static_cast<int>(blocks), block, smem,
                               s);
      if (err == cudaSuccess) err = finish<F32>(acc, dx, nb, h * w, c, s);
      break;
    case 1:
      err = launch_vec<BF16, 8>(vec, p, static_cast<int>(blocks), block,
                                smem, s);
      if (err == cudaSuccess) err = finish<BF16>(acc, dx, nb, h * w, c, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
