// Greedy (multi-label) NMS over any number of candidates, for Hopper,
// sm_90a: the box head's NMS of two-stage models.
//
// Replaces the TPU kernel paa_tpu/ops/nms_pallas.py::nms_pallas (body
// _nms_kernel): for one image, max_out pick/suppress steps. Each step
// takes the highest live score (ties to the lowest index), computes the
// +1-convention IoU of that box against all N candidates, kills the pick
// and every same-label candidate (every candidate when class_aware is 0)
// with IoU > thresh, and records idx, score and valid in slot i. Invalid
// candidates carry -1e30. An image stops once its best live score is
// -1e30; its remaining slots keep (idx 0, score -1e30, valid 0), as in
// the TPU kernel. A launch takes a batch of images.
//
// Where it runs: the two-stage box head, N = R * (C - 1) = 80,000
// candidates per image (28 bytes each, 2.24 MB), ten times what one
// CTA's 227 KB of shared memory holds; nms_batched.cu serves the images
// that fit one CTA.
//
// What bounds it on the card: not bytes (each candidate's valid flag,
// the score, box and label of the valid ones: about 1 us for 8 images of
// 80,000 of which ~1,000 are valid) and not operations (an IoU per valid
// candidate per step), but max_out dependent steps per image, each a
// pass over the image's live candidates and an argmax across them.
//
// Two kernels; the wrapper (ops/nms.py) picks one from N alone.
//
// nms_cluster_kernel, the route up to 16 CTAs' capacity (142,400
// candidates per image on an H100): one thread-block cluster of cs CTAs
// per image. CTA rank r owns the input range [r * ceil(N / cs),
// (r + 1) * ceil(N / cs)). Its prologue reads that range once and
// compacts the valid candidates into its own shared memory with a
// block-wide ballot scan, in ascending input index: x1, y1, x2, y2, live
// score, label and the 16-bit offset of the input index in the range,
// 26 bytes each (the area is recomputed, to the same bits). 26 rather
// than 32 bytes is what lets N = 80,000 fit 9 CTAs (8,889 each) instead
// of 12: on an H100 nine clusters of 9 run at once, but only seven of
// 10 to 16 (cudaOccupancyMaxActiveClusters at one CTA per SM), so a
// batch of 8 images runs in one wave. The caller's tensors are never
// written and no scratch buffer exists. A step is one pass over the
// CTA's live candidates (suppress against the last pick, track the best
// survivor), a block argmax, and ONE cluster barrier: each CTA publishes
// its best (score, index, box, label) in its shared memory,
// double-buffered by step parity, and after the barrier every warp reads
// the cs partials over distributed shared memory and reduces them to the
// same pick (ties to the lower index, which is the lower rank). With
// ~1,000 valid candidates an image's CTAs hold ~110 each, so a step
// costs a barrier and a DSMEM round trip instead of a walk over 80,000
// slots.
//
// nms_global_kernel, the route above that capacity: one CTA of 1024
// threads per image over a per-call (B, 7, N) scratch buffer in device
// memory (L2 resident for a batch of a few such images). Its prologue
// copies x1, y1, x2, y2, area, live score and label there; a step is one
// coalesced pass that suppresses against the pick and tracks the next
// one (dead candidates skipped after a 4-byte read), then a block
// argmax.
//
// Bit-exactness: the area and IoU of nms_common.cuh, in the JAX kernel's
// op order. Skipping a dead or other-label candidate changes nothing:
// the TPU kernel leaves it as it was. keep_idx and keep_valid therefore
// equal the plain PyTorch version's, and keep_scores are copies of input
// scores.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "nms_common.cuh"

namespace cg = cooperative_groups;

namespace {

using paa_nms::better;
using paa_nms::kNegInf;
using paa_nms::warp_argmax;

constexpr unsigned kFull = 0xffffffffu;

// Block argmax of each thread's (bs, bi), ties to the lowest index; every
// thread returns the block's result. The partials alternate between two
// buffers by step parity, so one barrier per call suffices: a warp can
// write step s+1's partials only after every warp passed step s's
// barrier, and step s+2 reuses the buffer only after step s+1's barrier,
// which every warp reaches after reading step s's partials.
template <int kWarps>
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
  bs = lane < kWarps ? part_s[parity][lane] : -CUDART_INF_F;
  bi = lane < kWarps ? part_i[parity][lane] : INT_MAX;
  warp_argmax(bs, bi);
  bs = __shfl_sync(kFull, bs, 0);
  bi = __shfl_sync(kFull, bi, 0);
}

// ---------------------------------------------------------------------
// The cluster route

constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
// shared memory per candidate: x1, y1, x2, y2, live, label (4 bytes
// each) and the index's offset in the CTA's range (2 bytes)
constexpr int kCandidateBytes = 26;
// shared memory left to the kernel's static arrays
constexpr int kStaticReserve = 1024;

// A CTA's best live candidate, as its cluster reads it over DSMEM.
struct __align__(16) Pick {
  float score;
  int idx;  // input index in the image; N when the CTA has none
  int label;
  int pad;
  float4 box;
};

__global__ void __launch_bounds__(kClusterThreads) nms_cluster_kernel(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    const int* __restrict__ labels, const unsigned char* __restrict__ valid,
    int n, float thresh, int max_out, int class_aware,
    int* __restrict__ keep_idx, float* __restrict__ keep_scores,
    unsigned char* __restrict__ keep_valid) {
  extern __shared__ float smem[];
  __shared__ float part_s[2][kClusterWarps];
  __shared__ int part_i[2][kClusterWarps];
  __shared__ int part_n[2][kClusterWarps];
  __shared__ Pick pub[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int image = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int chunk = (n + cs - 1) / cs;  // the capacity of each CTA
  const int start = min(rank * chunk, n);
  const int end = min(start + chunk, n);
  float* x1 = smem;
  float* y1 = x1 + chunk;
  float* x2 = y1 + chunk;
  float* y2 = x2 + chunk;
  float* live = y2 + chunk;
  int* lab = reinterpret_cast<int*>(live + chunk);
  unsigned short* off = reinterpret_cast<unsigned short*>(lab + chunk);

  // prologue: compact the valid candidates of [start, end) in input
  // order. part_n alternates by chunk parity, as in block_argmax.
  const size_t row = static_cast<size_t>(image) * n;
  const float4* bx = reinterpret_cast<const float4*>(boxes + row * 4);
  int m = 0;
  int par = 0;
  for (int base = start; base < end; base += kClusterThreads, par ^= 1) {
    const int j = base + tid;
    const bool v = j < end && valid[row + j];
    const unsigned ballot = __ballot_sync(kFull, v);
    if (lane == 0) part_n[par][warp] = __popc(ballot);
    __syncthreads();
    int c = lane < kClusterWarps ? part_n[par][lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {  // inclusive scan over warps
      const int t = __shfl_up_sync(kFull, c, d);
      if (lane >= d) c += t;
    }
    const int total = __shfl_sync(kFull, c, 31);
    const int before = warp ? __shfl_sync(kFull, c, warp - 1) : 0;
    if (v) {
      const int pos = m + before + __popc(ballot & ((1u << lane) - 1u));
      const float4 b = bx[j];
      x1[pos] = b.x;
      y1[pos] = b.y;
      x2[pos] = b.z;
      y2[pos] = b.w;
      live[pos] = scores[row + j];
      lab[pos] = labels[row + j];
      off[pos] = static_cast<unsigned short>(j - start);
    }
    m += total;
  }
  __syncthreads();

  // each thread owns the slots j = tid (mod kClusterThreads); slot order
  // is input order, so (score, slot) ties break as (score, index)
  float bs = -CUDART_INF_F;
  int bi = INT_MAX;
  for (int j = tid; j < m; j += kClusterThreads) {
    const float s = live[j];
    if (s > bs) {
      bs = s;
      bi = j;
    }
  }

  int* out_idx = keep_idx + static_cast<size_t>(image) * max_out;
  float* out_score = keep_scores + static_cast<size_t>(image) * max_out;
  unsigned char* out_valid =
      keep_valid + static_cast<size_t>(image) * max_out;

  int i = 0;
  for (; i < max_out; ++i) {
    const int p = i & 1;
    block_argmax<kClusterWarps>(bs, bi, part_s, part_i, p);
    if (tid == 0) {  // publish; pub[p] is read after the barrier below
      Pick& q = pub[p];
      q.score = bs;
      if (bi < m) {
        q.idx = start + off[bi];
        q.label = lab[bi];
        q.box = make_float4(x1[bi], y1[bi], x2[bi], y2[bi]);
      } else {
        q.idx = n;
        q.label = 0;
        q.box = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    // Publishes every CTA's pick. pub[p] is written again at step i+2,
    // after the next barrier, which each CTA reaches only after reading
    // this step's picks: one barrier per step.
    cluster.sync();
    float ps = -CUDART_INF_F;
    int pi = INT_MAX;
    int plab = 0;
    float4 pbox = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lane < cs) {
      const Pick* r = cluster.map_shared_rank(&pub[p], lane);
      const int4 head = *reinterpret_cast<const int4*>(r);
      pbox = r->box;
      ps = __int_as_float(head.x);
      pi = head.y;
      plab = head.z;
    }
    float best = ps;
    int idx = pi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {  // every lane ends with it
      const float os = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, idx, off);
      if (better(os, oi, best, idx)) {
        best = os;
        idx = oi;
      }
    }
    if (!(best > kNegInf / 2)) break;  // exhausted (uniform in cluster)
    const int src = __ffs(__ballot_sync(kFull, lane < cs && pi == idx)) - 1;
    const float bx1 = __shfl_sync(kFull, pbox.x, src);
    const float by1 = __shfl_sync(kFull, pbox.y, src);
    const float bx2 = __shfl_sync(kFull, pbox.z, src);
    const float by2 = __shfl_sync(kFull, pbox.w, src);
    const int blab = __shfl_sync(kFull, plab, src);
    const float barea = paa_nms::box_area(bx1, by1, bx2, by2);
    if (rank == 0 && tid == 0) {
      out_idx[i] = idx;
      out_score[i] = best;
      out_valid[i] = 1;
    }

    bs = -CUDART_INF_F;
    bi = INT_MAX;
    for (int j = tid; j < m; j += kClusterThreads) {
      const float s = live[j];
      if (s == kNegInf) continue;  // dead: the TPU kernel leaves it so
      bool kill = start + off[j] == idx;
      if (!kill && (!class_aware || lab[j] == blab)) {
        const float cx1 = x1[j], cy1 = y1[j], cx2 = x2[j], cy2 = y2[j];
        kill = paa_nms::iou_gt(bx1, by1, bx2, by2, barea, cx1, cy1, cx2,
                               cy2, paa_nms::box_area(cx1, cy1, cx2, cy2),
                               thresh);
      }
      if (kill) {
        live[j] = kNegInf;
      } else if (s > bs) {
        bs = s;
        bi = j;
      }
    }
  }
  // no CTA leaves while another may still read its picks
  cluster.sync();
  if (rank == 0) {
    for (int s = i + tid; s < max_out; s += kClusterThreads) {
      out_idx[s] = 0;
      out_score[s] = kNegInf;
      out_valid[s] = 0;
    }
  }
}

cudaError_t cluster_config(int cs, int n, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  const int chunk = cs > 0 ? (n + cs - 1) / cs : 0;
  const size_t smem = static_cast<size_t>(chunk) * kCandidateBytes;
  cudaError_t err = cudaFuncSetAttribute(
      nms_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// ---------------------------------------------------------------------
// The scratch route

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// scratch rows per image: x1, y1, x2, y2, area, live, label (the wrapper
// allocates (B, 7, N) float32)
constexpr int kScratchRows = 7;

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
    block_argmax<kWarps>(bs, bi, part_s, part_i, i & 1);
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

// Candidates one CTA of the cluster route holds on the current device.
int paa_nms_cluster_capacity() {
  int dev = 0;
  int optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return (optin - kStaticReserve) / kCandidateBytes;
}

// cudaOccupancyMaxActiveClusters for clusters of cs CTAs at N candidates
// per image; a negative CUDA error code on failure.
int paa_nms_cluster_max_active(int cs, int n) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config(cs, n, &cfg, attr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cfg.gridDim = dim3(cs);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, nms_cluster_kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// boxes (B, N, 4) f32, 16-byte aligned; scores (B, N) f32; labels (B, N)
// i32; valid (B, N) bool. keep_idx i32, keep_scores f32, keep_valid bool,
// each (B, max_out). All contiguous on the current device; cs CTAs per
// image, each holding ceil(N / cs) candidates (at most
// paa_nms_cluster_capacity(), cs at most 16). Returns the launch's CUDA
// error code.
int paa_nms_cluster(const float* boxes, const float* scores,
                    const int* labels, const unsigned char* valid, int batch,
                    int n, float thresh, int max_out, int class_aware, int cs,
                    int* keep_idx, float* keep_scores,
                    unsigned char* keep_valid, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config(cs, n, &cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(batch * cs);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, nms_cluster_kernel, boxes, scores, labels,
                           valid, n, thresh, max_out, class_aware, keep_idx,
                           keep_scores, keep_valid);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// As paa_nms_cluster, one CTA per image over scratch (B, 7, N) f32,
// written.
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
