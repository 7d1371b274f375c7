// Batched greedy (multi-label) NMS for Hopper, sm_90a.
//
// Replaces the TPU kernel paa_tpu/ops/nms_pallas.py::nms_pallas_batched
// (body _nms_kernel_batched): for each image of a (B, N) batch, max_out
// pick/suppress steps. Each step takes the highest live score (ties to
// the lowest index), computes the +1-convention IoU of that box against
// all N candidates, kills the pick and every same-label candidate (every
// candidate when class_aware is 0) with IoU > thresh, and records idx,
// score and valid in slot i. Invalid candidates carry -1e30. A row stops
// once its best live score is -1e30; its remaining slots keep
// (idx 0, score -1e30, valid 0), as in the TPU kernel.
//
// What bounds it on the card: not bytes (B*N*25 bytes in, a few hundred
// KB) and not operations (about 20 per candidate per step), but the
// max_out dependent steps of each image, each a block-wide argmax and a
// pass over N separated by barriers. The design keeps one image's
// candidates in shared memory for the whole loop (28 bytes each: x1, y1,
// x2, y2, area, live score, label; 140 KB at N = 5000), so a step never
// touches device memory; one CTA of 1024 threads serves one image, and
// the images of a batch run on separate SMs. N above what shared memory
// holds is refused by the wrapper; a tiled path belongs to the
// single-image kernel of two-stage heads.
//
// Bit-exactness: the IoU uses the JAX kernel's op order, every operation
// rounded on its own (__fadd_rn/__fmul_rn/__fdiv_rn, and the build uses
// -fmad=false), with the compare iou > thresh in float32. keep_idx and
// keep_valid therefore equal the plain PyTorch version's, and keep_scores
// are copies of input scores.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBytesPerCandidate = 28;

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

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

__global__ void __launch_bounds__(kThreads) nms_batched_kernel(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    const int* __restrict__ labels, const unsigned char* __restrict__ valid,
    int n, float thresh, int max_out, int class_aware,
    int* __restrict__ keep_idx, float* __restrict__ keep_scores,
    unsigned char* __restrict__ keep_valid) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + n;
  float* x2 = y1 + n;
  float* y2 = x2 + n;
  float* area = y2 + n;
  float* live = area + n;
  int* lab = reinterpret_cast<int*>(live + n);
  __shared__ float warp_best[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ float pick_score;
  __shared__ int pick_idx;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const float* bx = boxes + row * 4;
  for (int j = tid; j < n; j += kThreads) {
    const float a = bx[4 * j], c = bx[4 * j + 1];
    const float d = bx[4 * j + 2], e = bx[4 * j + 3];
    x1[j] = a;
    y1[j] = c;
    x2[j] = d;
    y2[j] = e;
    area[j] = __fmul_rn(__fadd_rn(__fsub_rn(d, a), 1.0f),
                        __fadd_rn(__fsub_rn(e, c), 1.0f));
    live[j] = valid[row + j] ? scores[row + j] : kNegInf;
    lab[j] = labels[row + j];
  }
  __syncthreads();

  int* out_idx = keep_idx + static_cast<size_t>(blockIdx.x) * max_out;
  float* out_score = keep_scores + static_cast<size_t>(blockIdx.x) * max_out;
  unsigned char* out_valid =
      keep_valid + static_cast<size_t>(blockIdx.x) * max_out;

  int i = 0;
  for (; i < max_out; ++i) {
    // block argmax of the live scores, ties to the lowest index
    float bs = -CUDART_INF_F;
    int bi = n;
    for (int j = tid; j < n; j += kThreads) {
      const float s = live[j];
      if (s > bs) {  // j ascends: the first maximum of this thread stays
        bs = s;
        bi = j;
      }
    }
    warp_argmax(bs, bi);
    if (lane == 0) {
      warp_best[warp] = bs;
      warp_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = warp_best[lane];
      bi = warp_idx[lane];
      warp_argmax(bs, bi);
      if (lane == 0) {
        pick_score = bs;
        pick_idx = bi;
      }
    }
    __syncthreads();
    const float best = pick_score;
    const int idx = pick_idx;
    if (!(best > kNegInf / 2)) break;  // row exhausted (uniform in block)
    if (tid == 0) {
      out_idx[i] = idx;
      out_score[i] = best;
      out_valid[i] = 1;
    }

    const float bx1 = x1[idx], by1 = y1[idx], bx2 = x2[idx], by2 = y2[idx];
    const float barea = area[idx];
    const int blab = lab[idx];
    for (int j = tid; j < n; j += kThreads) {
      const float w = fmaxf(
          __fadd_rn(__fsub_rn(fminf(bx2, x2[j]), fmaxf(bx1, x1[j])), 1.0f),
          0.0f);
      const float h = fmaxf(
          __fadd_rn(__fsub_rn(fminf(by2, y2[j]), fmaxf(by1, y1[j])), 1.0f),
          0.0f);
      const float inter = __fmul_rn(w, h);
      const float iou =
          __fdiv_rn(inter, __fsub_rn(__fadd_rn(barea, area[j]), inter));
      bool suppress = iou > thresh;
      if (class_aware) suppress = suppress && (lab[j] == blab);
      if (suppress || j == idx) live[j] = kNegInf;
    }
    __syncthreads();
  }
  for (int s = i + tid; s < max_out; s += kThreads) {
    out_idx[s] = 0;
    out_score[s] = kNegInf;
    out_valid[s] = 0;
  }
}

}  // namespace

extern "C" {

// Largest N one CTA can hold in shared memory on the current device.
int paa_nms_batched_max_candidates() {
  int dev = 0;
  int optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  // leave 1 KB for the kernel's static shared memory
  return (optin - 1024) / kBytesPerCandidate;
}

// boxes (B, N, 4) f32; scores (B, N) f32; labels (B, N) i32; valid (B, N)
// bool. keep_idx i32, keep_scores f32, keep_valid bool, each (B, max_out).
// All contiguous on the current device. Returns cudaGetLastError().
int paa_nms_batched(const float* boxes, const float* scores,
                    const int* labels, const unsigned char* valid, int batch,
                    int n, float thresh, int max_out, int class_aware,
                    int* keep_idx, float* keep_scores,
                    unsigned char* keep_valid, void* stream) {
  const size_t smem = static_cast<size_t>(n) * kBytesPerCandidate;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_batched_kernel<<<batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, labels, valid, n, thresh, max_out, class_aware,
      keep_idx, keep_scores, keep_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
