// GroupNorm (+ ReLU) for Hopper, sm_90a: the PAA head towers' 40
// GN+ReLU, and the GroupNorm of the GN bodies, FPN and ROI heads.
//
// Replaces the TPU kernel paa_tpu/ops/fused_gn.py::fused_group_norm_relu
// (body _gn_kernel, launched by _fused_forward): GroupNorm(G, eps) then,
// when asked (``relu``, the TPU kernel's own argument), ReLU; statistics
// in float32 per (image, group) in two passes (the mean, then the
// centred variance), the affine folded into a = w * rstd and
// b = bias - mean * a, out = relu(x * a + b) (or x * a + b) in the input
// dtype. The ReLU is a runtime flag read at the store, uniform over the
// launch: one kernel serves both forms.
//
// What bounds it on the card: bytes. It must read x and write y once,
// 2 * B * C * H * W * itemsize bytes, with about ten operations per
// element, far below the card's operations-per-byte balance. The P3
// tower input is 69 MB in bf16 at B = 8, more than the 50 MB L2, so a
// kernel that walks a group three times from device memory (sum, sum of
// squares, normalise) moves up to four times the bound's bytes.
//
// The design: the input is NCHW-contiguous, so an (image, group) is one
// contiguous run of (C / G) * H * W elements, and all B * G groups lie
// one after another. A launch gives each group a thread-block cluster of
// cs CTAs; rank r holds elements [r * share, (r + 1) * share) of the run
// in its shared memory, loaded once with 16-byte loads (a misaligned
// head and tail go element by element) and summed on the way in (pass
// 1), which hides the sum behind the loads' latency. The CTA's float32
// partial sum is published in its shared memory, and after a cluster
// barrier every CTA reads the cs partials over distributed shared
// memory and adds them in rank order, so all ranks hold the same mean;
// the centred sum of squares (pass 2, from shared memory) goes the same
// way and gives rstd; each CTA then writes relu(x * a + b) (or x * a + b)
// of its share
// from shared memory (pass 3). One read and one
// write of device memory: the bound's bytes. A group that fits one
// share takes one CTA, launched without a cluster, with a block sized to
// it (64 threads at P7); a group larger than 16 CTAs' share is read from
// device memory in each pass instead (the streaming instantiation,
// kResident = false). Sums are taken in a fixed order (per thread, then
// a butterfly per warp, then warps and ranks in order), so results
// repeat exactly from run to run. The host side
// (ops/group_norm.py::gn_plan) chooses cs, the share, the block size and
// the shared memory from the shape alone.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

// Element types by their bits; kVec elements make one 16-byte vector.
struct F32 {
  using Raw = unsigned;
  static constexpr int kVec = 4;
  __device__ static float load(Raw r) { return __uint_as_float(r); }
  __device__ static Raw store(float v) { return __float_as_uint(v); }
};
struct BF16 {
  using Raw = unsigned short;
  static constexpr int kVec = 8;
  __device__ static float load(Raw r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  __device__ static Raw store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
struct F16 {
  using Raw = unsigned short;
  static constexpr int kVec = 8;
  __device__ static float load(Raw r) {
    return __half2float(__ushort_as_half(r));
  }
  __device__ static Raw store(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Grid: B * G clusters of cs CTAs, one per group; rank r holds the
// group's elements [r * share, (r + 1) * share). x and y are 16-byte
// aligned.
template <typename Tr, bool kResident>
__global__ void __launch_bounds__(kMaxThreads) gn_relu_kernel(
    const typename Tr::Raw* __restrict__ x, const float* __restrict__ weight,
    const float* __restrict__ bias, typename Tr::Raw* __restrict__ y,
    int ge, int hw, int cpg, int num_groups, int share, float eps,
    bool relu) {
  using Raw = typename Tr::Raw;
  constexpr int kVec = Tr::kVec;
  constexpr unsigned kAll = (1u << kVec) - 1u;
  union Pack {
    uint4 u;
    Raw r[kVec];
  };
  extern __shared__ uint4 buf[];
  __shared__ float wpart[kMaxWarps];
  __shared__ float pub[2];  // the CTA's partial sums, read over DSMEM

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const long long group = blockIdx.x / cs;
  const long long gbase = group * ge;

  // this CTA's elements [lo, hi); buf vector k holds elements
  // base + k * kVec .. + kVec, so the copies are aligned on both sides
  const long long gend = gbase + ge;
  const long long lo = min(gbase + static_cast<long long>(rank) * share, gend);
  const long long hi = min(lo + share, gend);
  const long long base = lo - lo % kVec;
  const int nvec = hi > lo ? static_cast<int>((hi - base + kVec - 1) / kVec)
                           : 0;

  // Vector k as float32 and the mask of its elements inside [lo, hi):
  // from device memory (16-byte loads; kept in buf when resident) or from
  // buf. Each thread reads back only the vectors it kept itself
  // (k = tid, tid + nthreads, ... in every pass), so buf needs no
  // barrier of its own.
  auto load = [&](int k, float(&v)[kVec], bool from_buf) -> unsigned {
    const long long g = base + static_cast<long long>(k) * kVec;
    unsigned mask = kAll;
    if (g < lo || g + kVec > hi) {
      mask = 0;
      for (int e = 0; e < kVec; ++e)
        if (g + e >= lo && g + e < hi) mask |= 1u << e;
    }
    Pack p;
    if (from_buf) {
      p.u = buf[k];
    } else {
      if (mask == kAll) {
        p.u = __ldg(reinterpret_cast<const uint4*>(x + g));
      } else {
        for (int e = 0; e < kVec; ++e)
          p.r[e] = (mask >> e & 1u) ? x[g + e] : 0;
      }
      if (kResident) buf[k] = p.u;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = Tr::load(p.r[e]);
    return mask;
  };

  // the group's total of each thread's v: warps, then the CTA's warps in
  // order, then the cluster's ranks in order over DSMEM (a cluster of one
  // CTA needs only its block barriers)
  auto group_sum = [&](float v, int phase) -> float {
    v = warp_sum(v);
    if (lane == 0) wpart[warp] = v;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < nthreads / 32; ++w) s += wpart[w];
      pub[phase] = s;
    }
    if (cs == 1) {
      __syncthreads();
      return pub[phase];
    }
    cluster.sync();
    float total = 0.f;
    for (int r = 0; r < cs; ++r)
      total += *cluster.map_shared_rank(&pub[phase], r);
    return total;
  };

  // pass 1, as the share arrives: the sum (two accumulators, even and
  // odd elements, for a shorter dependency chain)
  float acc[2] = {0.f, 0.f};
#pragma unroll 4
  for (int k = tid; k < nvec; k += nthreads) {
    float v[kVec];
    const unsigned mask = load(k, v, false);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (mask == kAll || (mask >> e & 1u)) acc[e & 1] += v[e];
  }
  const float mean =
      group_sum(acc[0] + acc[1], 0) / static_cast<float>(ge);

  // pass 2: the centred sum of squares
  acc[0] = acc[1] = 0.f;
  for (int k = tid; k < nvec; k += nthreads) {
    float v[kVec];
    const unsigned mask = load(k, v, kResident);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float d = v[e] - mean;
      if (mask == kAll || (mask >> e & 1u))
        acc[e & 1] = __fmaf_rn(d, d, acc[e & 1]);
    }
  }
  const float var = group_sum(acc[0] + acc[1], 1) / static_cast<float>(ge);
  const float rstd = 1.0f / sqrtf(var + eps);
  // the partials have been read: arrive now, and wait before leaving so
  // that no CTA's shared memory goes while a neighbour may read it
  if (cs > 1) asm volatile("barrier.cluster.arrive;\n" ::: "memory");

  // the folded affine of the current channel c, whose elements are
  // [clo, clo + hw) of the group; set again only where a vector reaches
  // past it, so a vector inside one channel takes no division or load
  const int ch0 = static_cast<int>(group % num_groups) * cpg;
  int clo = 0;
  int chi = 0;  // empty until the first element
  float a = 0.f;
  float b = 0.f;
  auto set_channel = [&](int rel) {
    const int c = rel / hw;
    clo = c * hw;
    chi = clo + hw;
    a = weight[ch0 + c] * rstd;
    b = bias[ch0 + c] - mean * a;
  };
  for (int k = tid; k < nvec; k += nthreads) {
    float v[kVec];
    const unsigned mask = load(k, v, kResident);
    const long long g = base + static_cast<long long>(k) * kVec;
    const int rel0 = static_cast<int>(g - gbase);  // < 0 in a masked head
    Pack out;
    if (mask == kAll && rel0 >= clo && rel0 + kVec <= chi) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float r = fmaf(v[e], a, b);
        out.r[e] = Tr::store(relu && r < 0.f ? 0.f : r);  // NaN stays NaN
      }
      *reinterpret_cast<uint4*>(y + g) = out.u;
      continue;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      out.r[e] = 0;
      if (!(mask >> e & 1u)) continue;
      if (rel0 + e < clo || rel0 + e >= chi) set_channel(rel0 + e);
      const float r = fmaf(v[e], a, b);
      out.r[e] = Tr::store(relu && r < 0.f ? 0.f : r);
    }
    if (mask == kAll) {
      *reinterpret_cast<uint4*>(y + g) = out.u;
    } else {
      for (int e = 0; e < kVec; ++e)
        if (mask >> e & 1u) y[g + e] = out.r[e];
    }
  }
  if (cs > 1) asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

constexpr int kMaxDevices = 64;

// The kernel's attributes, set once per device: clusters up to 16 CTAs
// and dynamic shared memory up to the device's opt-in limit (the launch's
// own size decides occupancy).
template <typename Tr, bool kResident>
cudaError_t configure(int cs, int threads, int smem, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev]) {
    auto kernel = gn_relu_kernel<Tr, kResident>;
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - static_cast<int>(fa.sharedSizeBytes));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

struct Launch {
  const void* x;
  const float* w;
  const float* b;
  void* y;
  int groups;  // B * G
  int ge;      // elements per group
  int hw, cpg, num_groups, cs, share, threads, smem;
  float eps;
  bool relu;
  cudaStream_t stream;
};

template <typename Tr, bool kResident>
cudaError_t launch(const Launch& l) {
  using Raw = typename Tr::Raw;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      configure<Tr, kResident>(l.cs, l.threads, l.smem, &cfg, attr);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(l.groups * l.cs);
  cfg.stream = l.stream;
  if (l.cs == 1) cfg.numAttrs = 0;  // one CTA per cluster: a plain grid
  err = cudaLaunchKernelEx(&cfg, gn_relu_kernel<Tr, kResident>,
                           static_cast<const Raw*>(l.x), l.w, l.b,
                           static_cast<Raw*>(l.y), l.ge, l.hw, l.cpg,
                           l.num_groups, l.share, l.eps, l.relu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename Tr, bool kResident>
int max_active(int cs, int threads, int smem) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      configure<Tr, kResident>(cs, threads, smem, &cfg, attr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cfg.gridDim = dim3(cs);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters,
                                       gn_relu_kernel<Tr, kResident>, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// dtype: 0 float32, 1 bfloat16, 2 float16
template <typename Fn>
auto by_type(int dtype, int resident, Fn fn) {
  switch (dtype * 2 + (resident ? 1 : 0)) {
    case 0: return fn(F32{}, false);
    case 1: return fn(F32{}, true);
    case 2: return fn(BF16{}, false);
    case 3: return fn(BF16{}, true);
    case 4: return fn(F16{}, false);
    default: return fn(F16{}, true);
  }
}

}  // namespace

extern "C" {

// x, y (B, C, H, W) contiguous and 16-byte aligned, of the dtype code;
// w, b (C,) float32. groups = B * G, ge = (C / G) * H * W; cs, share,
// threads and smem as ops/group_norm.py::gn_plan chose them; relu 1
// applies the ReLU, 0 stores the GroupNorm alone.
// Returns the launch's CUDA error code.
int paa_group_norm_relu(const void* x, const float* w, const float* b,
                        void* y, int dtype, int groups, int ge, int hw,
                        int cpg, int num_groups, int cs, int share,
                        int threads, int resident, int smem, float eps,
                        int relu, void* stream) {
  const Launch l{x, w, b, y, groups, ge, hw, cpg, num_groups, cs, share,
                 threads, smem, eps, relu != 0,
                 static_cast<cudaStream_t>(stream)};
  const cudaError_t err = by_type(dtype, resident, [&](auto tr, bool r) {
    using Tr = decltype(tr);
    return r ? launch<Tr, true>(l) : launch<Tr, false>(l);
  });
  return static_cast<int>(err);
}

// cudaOccupancyMaxActiveClusters for a launch of that plan; a negative
// CUDA error code on failure.
int paa_group_norm_max_active(int dtype, int resident, int cs, int threads,
                              int smem) {
  return by_type(dtype, resident, [&](auto tr, bool r) {
    using Tr = decltype(tr);
    return r ? max_active<Tr, true>(cs, threads, smem)
             : max_active<Tr, false>(cs, threads, smem);
  });
}

}  // extern "C"
