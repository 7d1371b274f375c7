// Batched greedy (multi-label) NMS for Hopper, sm_90a: sort each row
// once, then sweep it in tiles.
//
// Replaces the TPU kernel paa_tpu/ops/nms_pallas.py::nms_pallas_batched
// (body _nms_kernel_batched): for each image of a (B, N) batch, max_out
// pick/suppress steps. Each step takes the highest live score (ties to
// the lowest index), computes the +1-convention IoU of that box against
// all N candidates, kills the pick and every same-label candidate (every
// candidate when class_aware is 0) with IoU > thresh, and records idx,
// score and valid in slot i. Invalid candidates carry -1e30. A row stops
// once its best live score is -1e30, or at once if a valid score is NaN
// (the TPU kernel's max is then NaN); its remaining slots hold
// (idx 0, score -1e30, valid 0).
//
// What bounds it on the card: not bytes (B*N*25 bytes in, a few hundred
// KB) and not operations (an IoU per candidate and kept box), but the
// chain of dependent steps. Picking one box per step, as the TPU kernel
// does, costs a block-wide argmax and two barriers per pick: ~3 us, and
// up to 1,000 picks per row at the RPN. This kernel makes the chain one
// step per tile of 32 candidates instead. Greedy's i-th pick is the i-th
// candidate, in (score desc, index asc) order, that no earlier pick
// suppresses; so one CTA of 1024 threads per image
//
// 1. compacts the row's live candidates (valid, score > -5e29, not NaN)
//    into shared memory with a ballot scan, in index order, as 32-bit
//    sort keys (nms_common.cuh: score_key) and 16-bit indices;
// 2. sorts them by key with CUB's BlockRadixSort (the CUDA toolkit's
//    headers), which is stable, so equal scores keep index order; only
//    over the bits in which the row's keys differ, and with as few keys
//    per thread (1-8) as the row needs;
// 3. gathers the sorted candidates' boxes, areas and labels into shared
//    memory, in sorted order;
// 4. sweeps tiles of 32 sorted candidates, lane l of each warp holding
//    member l: warp w tests every member against kept boxes w, w + 32,
//    ... (one kept box per warp and step, 32 members at once), and warp
//    w also finds which earlier members of the tile would suppress
//    member w (a ballot: one column of the tile's "earlier suppresses
//    later" matrix). After a barrier, warp 0 resolves the tile with
//    ballots: every open member whose earlier suppressors are all
//    decided is kept iff none of them was kept, round after round (one
//    round when nothing in the tile overlaps); then it appends the picks,
//    up to max_out, and a second barrier ends the step. The sweep stops
//    at max_out picks or at the end of the list;
// 5. writes the picks' indices and input scores, and the empty slots,
//    and where asked the number of tiles the row swept.
//
// Shared memory per image of N candidates: the sorted candidates (float4
// box, area, label, 16-bit index: 26 bytes each), which during the sort
// hold the keys and indices in index order (6 bytes each) and CUB's
// temporary storage; and the picks' sorted positions (2 bytes each).
// 229,376 bytes at the capacity of 8,192 candidates: each thread sorts
// at most 8 keys.
//
// Bit-exactness: the area and IoU of nms_common.cuh, in the JAX kernel's
// op order; a kept box is the pick (the first argument of iou_gt), the
// candidate the second, as in the greedy step. keep_idx and keep_valid
// therefore equal the plain PyTorch version's, and keep_scores are
// copies of input scores.

#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>

#include "nms_common.cuh"

namespace {

using paa_nms::kNegInf;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // candidates per sweep step: one per warp
constexpr int kMaxItems = 8;  // sort: keys per thread
constexpr int kCapacity = kThreads * kMaxItems;

template <int kItems>
using BlockSort = cub::BlockRadixSort<unsigned, kThreads, kItems,
                                      unsigned short>;

__host__ __device__ constexpr size_t larger(size_t a, size_t b) {
  return a > b ? a : b;
}

// CUB's temporary storage: the largest of the instantiations sort_row
// takes (1, 2, 4, 6 and 8 keys per thread)
constexpr size_t kSortBytes = larger(
    larger(larger(sizeof(BlockSort<1>::TempStorage),
                  sizeof(BlockSort<2>::TempStorage)),
           larger(sizeof(BlockSort<4>::TempStorage),
                  sizeof(BlockSort<6>::TempStorage))),
    sizeof(BlockSort<kMaxItems>::TempStorage));

__host__ __device__ constexpr size_t round16(size_t b) {
  return (b + 15) / 16 * 16;
}

// The region that holds the sorted candidates, or, while sorting, the
// keys, the indices and CUB's storage behind them.
__host__ __device__ constexpr size_t region_bytes(int n) {
  return larger(round16(26 * static_cast<size_t>(n)),
                round16(6 * static_cast<size_t>(n)) + round16(kSortBytes));
}

__host__ __device__ constexpr size_t smem_bytes(int n) {
  return region_bytes(n) + 2 * static_cast<size_t>(n);
}

// Sort the m keys of ``key`` (index order), with their indices ``val``,
// over bits [begin, end); src[r] ends as the index at sorted position
// r * kThreads + threadIdx.x. Padding keys sort last, and a stable sort
// keeps every real key ahead of an equal one.
template <int kItems>
__device__ __forceinline__ void sort_row(const unsigned* key,
                                         const unsigned short* val, int m,
                                         int begin, int end, void* storage,
                                         unsigned short (&src)[kMaxItems]) {
  unsigned k[kItems];
  unsigned short v[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {  // blocked: thread t holds t * kItems..
    const int e = static_cast<int>(threadIdx.x) * kItems + i;
    k[i] = e < m ? key[e] : kFull;
    v[i] = e < m ? val[e] : 0;
  }
  BlockSort<kItems>(
      *reinterpret_cast<typename BlockSort<kItems>::TempStorage*>(storage))
      .SortBlockedToStriped(k, v, begin, end);
#pragma unroll
  for (int i = 0; i < kItems; ++i) src[i] = v[i];
}

__global__ void __launch_bounds__(kThreads) nms_batched_kernel(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    const int* __restrict__ labels, const unsigned char* __restrict__ valid,
    int n, float thresh, int max_out, int class_aware,
    int* __restrict__ tiles, int* __restrict__ keep_idx,
    float* __restrict__ keep_scores, unsigned char* __restrict__ keep_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t sn = static_cast<size_t>(n);
  // while sorting: keys and indices in index order, and CUB's storage
  unsigned* kin = reinterpret_cast<unsigned*>(smem);
  unsigned short* vin = reinterpret_cast<unsigned short*>(smem + 4 * sn);
  void* sort_storage = smem + round16(6 * sn);
  // after sorting, by sorted position
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(smem + 16 * sn);
  int* lab = reinterpret_cast<int*>(smem + 20 * sn);
  unsigned short* idx = reinterpret_cast<unsigned short*>(smem + 24 * sn);
  // the sorted positions of the picks, in pick order
  unsigned short* kept =
      reinterpret_cast<unsigned short*>(smem + region_bytes(n));

  __shared__ unsigned part[2][kWarps];
  __shared__ unsigned key_and, key_or;
  __shared__ unsigned tile_col[kTile];  // earlier members suppressing each
  __shared__ unsigned tile_hit;  // members a kept box suppresses
  __shared__ int s_picks;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;

  // 1. compact the live candidates in index order (part alternates by
  // chunk parity, so one barrier per chunk suffices)
  if (tid == 0) {
    key_and = kFull;
    key_or = 0u;
  }
  bool flag[kMaxItems];
  float score[kMaxItems];
#pragma unroll
  for (int r = 0; r < kMaxItems; ++r) {  // every load in flight at once
    const int j = r * kThreads + tid;
    flag[r] = j < n && valid[row + j];
    score[r] = j < n ? scores[row + j] : 0.0f;
  }
  int m = 0;
  bool nan_seen = false;
  unsigned kand = kFull, kor = 0u;
#pragma unroll
  for (int r = 0; r < kMaxItems; ++r) {
    if (r * kThreads >= n) break;
    const int par = r & 1;
    const int j = r * kThreads + tid;
    const float s = flag[r] ? score[r] : kNegInf;
    nan_seen |= s != s;
    const bool live = s > kNegInf / 2;  // false for NaN
    const unsigned ballot = __ballot_sync(kFull, live);
    if (lane == 0) part[par][warp] = __popc(ballot);
    __syncthreads();
    unsigned c = part[par][lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {  // inclusive scan over warps
      const unsigned t = __shfl_up_sync(kFull, c, d);
      if (lane >= d) c += t;
    }
    const int total = static_cast<int>(__shfl_sync(kFull, c, 31));
    const int before =
        warp ? static_cast<int>(__shfl_sync(kFull, c, warp - 1)) : 0;
    if (live) {
      const int pos = m + before + __popc(ballot & lanes_below);
      const unsigned k = paa_nms::score_key(s);
      kin[pos] = k;
      vin[pos] = static_cast<unsigned short>(j);
      kand &= k;
      kor |= k;
    }
    m += total;
  }
  kand = __reduce_and_sync(kFull, kand);
  kor = __reduce_or_sync(kFull, kor);
  if (lane == 0) {
    atomicAnd(&key_and, kand);
    atomicOr(&key_or, kor);
  }
  // a valid NaN: no picks in this row, as in the TPU kernel
  if (__syncthreads_or(nan_seen)) m = 0;

  // 2. the stable sort, over the bits in which the keys differ; with
  // one key, or keys all equal, index order is already sorted order
  unsigned short src[kMaxItems];
  const unsigned differ = key_and ^ key_or;
  if (m > 1 && differ != 0u) {
    const int begin = __ffs(differ) - 1;
    const int end = 32 - __clz(differ);
    switch ((m + kThreads - 1) / kThreads) {
      case 1: sort_row<1>(kin, vin, m, begin, end, sort_storage, src); break;
      case 2: sort_row<2>(kin, vin, m, begin, end, sort_storage, src); break;
      case 3:
      case 4: sort_row<4>(kin, vin, m, begin, end, sort_storage, src); break;
      case 5:
      case 6: sort_row<6>(kin, vin, m, begin, end, sort_storage, src); break;
      default:
        sort_row<kMaxItems>(kin, vin, m, begin, end, sort_storage, src);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kMaxItems; ++r) {
      const int p = r * kThreads + tid;
      src[r] = p < m ? vin[p] : 0;
    }
  }

  // 3. the sorted candidates' boxes and labels, by sorted position; they
  // overwrite the sort's region, so wait for every thread to leave it
  if (tid == 0) {
    s_picks = 0;
    tile_hit = 0u;
  }
  __syncthreads();
  const float4* bx = reinterpret_cast<const float4*>(boxes) + row;
#pragma unroll
  for (int r = 0; r < kMaxItems; ++r) {
    const int p = r * kThreads + tid;
    if (p < m) {
      const int j = src[r];
      const float4 b = bx[j];
      box[p] = b;
      area[p] = paa_nms::box_area(b.x, b.y, b.z, b.w);
      lab[p] = labels[row + j];
      idx[p] = src[r];
    }
  }
  __syncthreads();

  // 4. the sweep, one tile of kTile sorted candidates per step
  const bool aware = class_aware != 0;
  int picks = 0;
  int swept = 0;
  for (int base = 0; base < m && picks < max_out; base += kTile, ++swept) {
    const int members = min(kTile, m - base);
    // lane l of every warp holds member l of the tile
    const bool member = lane < members;
    const int p = base + (member ? lane : 0);
    const float4 mb = box[p];
    const float ma = area[p];
    const int ml = lab[p];
    // warp w tests the members against kept boxes w, w + kWarps, ...
    bool hit = false;
#pragma unroll 4
    for (int k = warp; k < picks; k += kWarps) {
      const int q = kept[k];
      if (!aware || lab[q] == ml) {
        hit |= paa_nms::suppresses(box[q], area[q], mb, ma, thresh);
      }
    }
    const unsigned hits = __ballot_sync(kFull, hit && member);
    if (lane == 0 && hits) atomicOr(&tile_hit, hits);
    // warp w < members: which earlier members suppress member w if kept
    if (warp < members) {
      const int c = base + warp;
      const float4 cb = box[c];
      const unsigned col = __ballot_sync(
          kFull, lane < warp && (!aware || ml == lab[c]) &&
                     paa_nms::suppresses(mb, ma, cb, area[c], thresh));
      if (lane == 0) tile_col[warp] = col;
    }
    __syncthreads();
    if (warp == 0) {
      const unsigned col = member ? tile_col[lane] : 0u;
      unsigned open = __ballot_sync(kFull, member) & ~tile_hit;
      __syncwarp();
      // decide, at once, every open member whose earlier suppressors are
      // all decided: kept iff none of them was kept. The lowest open
      // member is always ready, so each round decides one or more.
      unsigned keep = 0u;
      while (open) {
        const bool ready = ((open >> lane) & 1u) && (col & open) == 0u;
        keep |= __ballot_sync(kFull, ready && (col & keep) == 0u);
        open &= ~__ballot_sync(kFull, ready);
      }
      while (__popc(keep) > max_out - picks) {  // the last slots only
        keep &= ~(1u << (31 - __clz(keep)));
      }
      if ((keep >> lane) & 1u) {
        kept[picks + __popc(keep & lanes_below)] =
            static_cast<unsigned short>(base + lane);
      }
      if (lane == 0) {
        s_picks = picks + __popc(keep);
        tile_hit = 0u;
      }
    }
    __syncthreads();
    picks = s_picks;
  }

  // 5. the outputs
  int* out_idx = keep_idx + static_cast<size_t>(blockIdx.x) * max_out;
  float* out_score = keep_scores + static_cast<size_t>(blockIdx.x) * max_out;
  unsigned char* out_valid =
      keep_valid + static_cast<size_t>(blockIdx.x) * max_out;
  for (int k = tid; k < max_out; k += kThreads) {
    if (k < picks) {
      const int j = idx[kept[k]];
      out_idx[k] = j;
      out_score[k] = scores[row + j];
      out_valid[k] = 1;
    } else {
      out_idx[k] = 0;
      out_score[k] = kNegInf;
      out_valid[k] = 0;
    }
  }
  if (tiles != nullptr && tid == 0) tiles[blockIdx.x] = swept;
}

}  // namespace

extern "C" {

// Largest N one CTA takes on the current device: the sort's capacity,
// or less where shared memory holds fewer; -1 on a CUDA error.
int paa_nms_batched_max_candidates() {
  int dev = 0;
  int optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, nms_batched_kernel) != cudaSuccess)
    return -1;
  const size_t room = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  int n = kCapacity;
  while (n > 0 && smem_bytes(n) > room) --n;
  return n;
}

// boxes (B, N, 4) f32; scores (B, N) f32; labels (B, N) i32; valid (B, N)
// bool. tiles: (B,) i32 that receives the tiles each row swept, or null.
// keep_idx i32, keep_scores f32, keep_valid bool, each (B, max_out).
// All contiguous on the current device; 1 <= N <=
// paa_nms_batched_max_candidates(). Returns cudaGetLastError().
int paa_nms_batched(const float* boxes, const float* scores,
                    const int* labels, const unsigned char* valid, int batch,
                    int n, float thresh, int max_out, int class_aware,
                    int* tiles, int* keep_idx, float* keep_scores,
                    unsigned char* keep_valid, void* stream) {
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_batched_kernel<<<batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, labels, valid, n, thresh, max_out, class_aware, tiles,
      keep_idx, keep_scores, keep_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
