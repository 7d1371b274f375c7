// Greedy (multi-label) NMS over any number of candidates, for Hopper,
// sm_90a.
//
// Replaces the TPU kernel paa_tpu/ops/nms_pallas.py::nms_pallas (body
// _nms_kernel): for one image, max_out pick/suppress steps. Each step
// takes the highest live score (ties to the lowest index), computes the
// +1-convention IoU of that box against all N candidates, kills the pick
// and every same-label candidate (every candidate when class_aware is 0)
// with IoU > thresh, and records idx, score and valid in slot i. Invalid
// candidates carry -1e30. An image stops once its best live score is
// -1e30; its remaining slots keep (idx 0, score -1e30, valid 0), as in
// the TPU kernel. The launch takes a batch: one CTA per image.
//
// Where it runs: the two-stage box head, N = R * (C - 1) = 80,000
// candidates per image (28 bytes each, 2.24 MB), more than one CTA's
// 227 KB of shared memory can hold; nms_batched.cu serves the images
// that fit.
//
// What bounds it on the card: not bytes (each candidate's valid flag and
// score, and the box and label of the valid ones: about 1 us for 8
// images of 80,000 of which ~1,000 are valid) and not operations (an IoU
// per valid candidate per step), but max_out dependent steps per image,
// each a pass over the image's candidates and a block-wide argmax with a
// barrier. The design: a prologue copies the image's x1, y1, x2, y2,
// area, live score and label into a per-call scratch buffer in device
// memory, structure-of-arrays (the caller's tensors are never written),
// and finds the first pick. Then each step is ONE coalesced pass that
// suppresses against the pick and, among the survivors, finds the next
// pick, followed by one block argmax. Candidates that are already dead
// are skipped after a 4-byte read, and with class_aware a live
// candidate of another label after an 8-byte read, so a step touches the
// boxes of the live same-label candidates only. The 8 images' scratch
// (18 MB) stays in the 50 MB L2. One CTA per image uses 8 of 132 SMs;
// spreading an image over a thread-block cluster is later work.
//
// Bit-exactness: the area and IoU of nms_common.cuh, in the JAX kernel's
// op order. Skipping a dead or other-label candidate changes nothing:
// the TPU kernel leaves it as it was. keep_idx and keep_valid therefore
// equal the plain PyTorch version's, and keep_scores are copies of input
// scores.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "nms_common.cuh"

namespace {

using paa_nms::kNegInf;
using paa_nms::warp_argmax;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// scratch rows per image: x1, y1, x2, y2, area, live, label (the wrapper
// allocates (B, 7, N) float32)
constexpr int kScratchRows = 7;

// Block argmax of each thread's (bs, bi), ties to the lowest index; every
// thread returns the block's result. The partials alternate between two
// buffers by step parity, so one barrier per call suffices: a warp can
// write step s+1's partials only after every warp passed step s's
// barrier, and step s+2 reuses the buffer only after step s+1's barrier,
// which every warp reaches after reading step s's partials.
__device__ __forceinline__ void block_argmax(float& bs, int& bi,
                                             float (*part_s)[kWarps],
                                             int (*part_i)[kWarps],
                                             int parity) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(bs, bi);
  if (lane == 0) {
    part_s[parity][warp] = bs;
    part_i[parity][warp] = bi;
  }
  __syncthreads();
  bs = part_s[parity][lane];
  bi = part_i[parity][lane];
  warp_argmax(bs, bi);
  bs = __shfl_sync(0xffffffffu, bs, 0);
  bi = __shfl_sync(0xffffffffu, bi, 0);
}

__global__ void __launch_bounds__(kThreads) nms_global_kernel(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    const int* __restrict__ labels, const unsigned char* __restrict__ valid,
    int n, float thresh, int max_out, int class_aware,
    float* __restrict__ scratch, int* __restrict__ keep_idx,
    float* __restrict__ keep_scores, unsigned char* __restrict__ keep_valid) {
  __shared__ float part_s[2][kWarps];
  __shared__ int part_i[2][kWarps];

  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  float* x1 = scratch + row * kScratchRows;
  float* y1 = x1 + n;
  float* x2 = y1 + n;
  float* y2 = x2 + n;
  float* area = y2 + n;
  float* live = area + n;
  int* lab = reinterpret_cast<int*>(live + n);

  // prologue: structure-of-arrays copy, and the first pick
  float bs = -CUDART_INF_F;
  int bi = n;
  const float* bx = boxes + row * 4;
  for (int j = tid; j < n; j += kThreads) {
    const float4 b = reinterpret_cast<const float4*>(bx)[j];
    x1[j] = b.x;
    y1[j] = b.y;
    x2[j] = b.z;
    y2[j] = b.w;
    area[j] = paa_nms::box_area(b.x, b.y, b.z, b.w);
    const float s = valid[row + j] ? scores[row + j] : kNegInf;
    live[j] = s;
    lab[j] = labels[row + j];
    if (s > bs) {  // j ascends: the first maximum of this thread stays
      bs = s;
      bi = j;
    }
  }

  int* out_idx = keep_idx + static_cast<size_t>(blockIdx.x) * max_out;
  float* out_score = keep_scores + static_cast<size_t>(blockIdx.x) * max_out;
  unsigned char* out_valid =
      keep_valid + static_cast<size_t>(blockIdx.x) * max_out;

  int i = 0;
  for (; i < max_out; ++i) {
    // the barrier inside also publishes the prologue's and the last
    // pass's scratch writes to the whole block
    block_argmax(bs, bi, part_s, part_i, i & 1);
    const float best = bs;
    const int idx = bi;
    if (!(best > kNegInf / 2)) break;  // image exhausted (uniform in block)
    if (tid == 0) {
      out_idx[i] = idx;
      out_score[i] = best;
      out_valid[i] = 1;
    }

    const float bx1 = x1[idx], by1 = y1[idx], bx2 = x2[idx], by2 = y2[idx];
    const float barea = area[idx];
    const int blab = lab[idx];
    bs = -CUDART_INF_F;
    bi = n;
    for (int j = tid; j < n; j += kThreads) {
      const float s = live[j];
      if (s == kNegInf) continue;  // dead: the TPU kernel leaves it so
      bool kill = j == idx;
      if (!kill && (!class_aware || lab[j] == blab)) {
        kill = paa_nms::iou_gt(bx1, by1, bx2, by2, barea, x1[j], y1[j],
                               x2[j], y2[j], area[j], thresh);
      }
      if (kill) {
        live[j] = kNegInf;
      } else if (s > bs) {
        bs = s;
        bi = j;
      }
    }
  }
  for (int s = i + tid; s < max_out; s += kThreads) {
    out_idx[s] = 0;
    out_score[s] = kNegInf;
    out_valid[s] = 0;
  }
}

}  // namespace

extern "C" {

// boxes (B, N, 4) f32, 16-byte aligned; scores (B, N) f32; labels (B, N)
// i32; valid (B, N) bool; scratch (B, 7, N) f32, written. keep_idx i32,
// keep_scores f32, keep_valid bool, each (B, max_out). All contiguous on
// the current device. Returns cudaGetLastError().
int paa_nms_global(const float* boxes, const float* scores,
                   const int* labels, const unsigned char* valid, int batch,
                   int n, float thresh, int max_out, int class_aware,
                   float* scratch, int* keep_idx, float* keep_scores,
                   unsigned char* keep_valid, void* stream) {
  nms_global_kernel<<<batch, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, labels, valid, n, thresh, max_out, class_aware,
      scratch, keep_idx, keep_scores, keep_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
