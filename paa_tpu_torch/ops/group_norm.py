"""GroupNorm + ReLU for the head towers (port of the TPU kernel
paa_tpu/ops/fused_gn.py::fused_group_norm_relu, body ``_gn_kernel``).

GroupNorm(G, eps) followed by ReLU, as the reference's towers apply it
(make_layers.py group_norm -> nn.GroupNorm(32, C, eps=1e-5), then ReLU;
rpn/paa/paa.py:33-44). Statistics are float32, per (image, group), in
two passes: the mean, then the centred variance. The affine is folded
into a = scale * rsqrt(var + eps) and b = bias - mean * a, and the output
relu(x * a + b) is cast back to the input dtype.

``group_norm_relu`` dispatches on the tensor's device: the plain PyTorch
version for CPU tensors, the CUDA kernel K3 (csrc/group_norm.cu) for
CUDA tensors. There is no fallback between the two, and no shape gate:
the kernel serves every level down to P7 (7 x 11 positions at
800 x 1344). The kernel's header says what bounds it and how it is
built: each (image, group) is one contiguous run of an NCHW tensor,
split over a thread-block cluster of ``cs`` CTAs that hold it in shared
memory, read once from device memory. ``gn_plan`` makes the launch's
choices from the shape alone. The wrapper raises on any layout other
than NCHW-contiguous.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build

# the dtype codes of csrc/group_norm.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# A CTA's share of a group in shared memory. 36 KB lets six CTAs of 256
# threads share an SM, so that one loads while another computes or
# stores: on an H100 the P3 tower took 72 us per launch so, against 78 us
# at 72 KB shares of 512 threads (kernel_ab.py --k3-sweep).
CTA_BYTES = 36 * 1024
CLUSTER_THREADS = 256  # per CTA of a cluster (cs > 1)
MAX_CLUSTER = 16  # non-portable above 8
MAX_THREADS = 512
MIN_THREADS = 64


def group_norm_relu_plain(x, weight, bias, num_groups=32, eps=1e-5):
    """The plain PyTorch version, following the JAX package's
    ``_gn_relu_reference``. x: (B, C, H, W); weight, bias: (C,)."""
    b, c, h, w = x.shape
    xf = x.to(torch.float32).reshape(b, num_groups, (c // num_groups) * h * w)
    mean = xf.mean(dim=2, keepdim=True)
    var = (xf - mean).square().mean(dim=2, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    out = xn * weight.to(torch.float32)[:, None, None] + bias.to(
        torch.float32)[:, None, None]
    return torch.relu(out).to(x.dtype)


@dataclass(frozen=True)
class GNPlan:
    """One launch of K3: a cluster of ``cs`` CTAs of ``threads`` threads
    per group, each CTA holding ``share`` elements of it. ``resident``:
    the share sits in ``smem_bytes`` of shared memory (False: each pass
    reads device memory, for groups beyond MAX_CLUSTER CTAs' share)."""

    cs: int
    share: int
    threads: int
    resident: bool
    smem_bytes: int


def _cdiv(a, b):
    return -(-a // b)


def _pow2_at_least(v):
    return 1 << max(0, v - 1).bit_length()


@functools.lru_cache(maxsize=None)
def gn_plan(batch, channels, hw, num_groups, itemsize):
    """K3's launch for (B, C, H * W) in groups of ``num_groups`` at
    ``itemsize`` bytes per element."""
    vec = 16 // itemsize  # elements per 16-byte copy
    ge = channels // num_groups * hw
    gbytes = ge * itemsize
    cs = max(1, _cdiv(gbytes, CTA_BYTES))
    resident = cs <= MAX_CLUSTER
    cs = min(cs, MAX_CLUSTER)
    share = _cdiv(_cdiv(ge, cs), vec) * vec if cs > 1 else ge
    vectors = _cdiv(share, vec) + 1  # one more for a misaligned start
    # a lone CTA: about four vectors per thread (64 threads at P7, where
    # two groups to a CTA of 128 measured no faster on an H100)
    threads = CLUSTER_THREADS if cs > 1 else min(
        MAX_THREADS, max(MIN_THREADS, _pow2_at_least(_cdiv(vectors, 4))))
    return GNPlan(cs=cs, share=share, threads=threads,
                  resident=resident,
                  smem_bytes=16 * vectors if resident else 0)


@functools.cache
def _lib():
    lib = _build.load("group_norm")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.paa_group_norm_relu.argtypes = (
        [vp] * 4 + [ci] * 11 + [ctypes.c_float, vp])
    lib.paa_group_norm_relu.restype = ci
    lib.paa_group_norm_max_active.argtypes = [ci] * 5
    lib.paa_group_norm_max_active.restype = ci
    return lib


def _on(device):
    """``torch.cuda.device(device)`` unless it is the current device
    already (the switch costs host time on every launch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def gn_max_active_clusters(x, num_groups=32):
    """cudaOccupancyMaxActiveClusters of K3's launch for ``x`` (a CUDA
    tensor): how many clusters run at once."""
    b, c, h, w = x.shape
    plan = gn_plan(b, c, h * w, num_groups, x.element_size())
    with _on(x.device):
        return _lib().paa_group_norm_max_active(
            _DTYPES[x.dtype], int(plan.resident), plan.cs, plan.threads,
            plan.smem_bytes)


def _group_norm_relu_cuda(x, weight, bias, num_groups, eps):
    b, c, h, w = x.shape
    if not x.is_contiguous():
        raise ValueError(
            "group_norm_relu kernel takes NCHW-contiguous input, got "
            f"strides {x.stride()} for shape {tuple(x.shape)}"
        )
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm_relu kernel: no {x.dtype} path")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (c,) or p.dtype != torch.float32 or \
                p.device != x.device or not p.is_contiguous():
            raise ValueError(
                f"{name}: {p.dtype} {tuple(p.shape)} on {p.device}, the "
                f"kernel takes contiguous float32 ({c},) on {x.device}"
            )
    ge = c // num_groups * h * w
    if ge >= 2 ** 31 or b * num_groups >= 2 ** 31:
        raise ValueError(f"group_norm_relu kernel: {ge} elements per group")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    if x.data_ptr() % 16:  # the kernel copies 16-byte vectors
        x = x.clone()
    plan = gn_plan(b, c, h * w, num_groups, x.element_size())
    with _on(x.device):
        err = _lib().paa_group_norm_relu(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            _DTYPES[x.dtype], b * num_groups, ge, h * w, c // num_groups,
            num_groups, plan.cs, plan.share, plan.threads,
            int(plan.resident), plan.smem_bytes, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"group_norm_relu kernel launch failed: CUDA error {err}")
    group_norm_relu.launches += 1
    return y


def group_norm_relu(x, weight, bias, num_groups=32, eps=1e-5):
    """relu(GroupNorm(x)) for x (B, C, H, W) in float32, bfloat16 or
    float16 and float32 weight, bias (C,); returns x's dtype.

    CPU tensors take the plain version; CUDA tensors launch K3
    (csrc/group_norm.cu, counted in ``group_norm_relu.launches``) or
    raise."""
    if x.shape[1] % num_groups:
        raise ValueError(f"{x.shape[1]} channels in {num_groups} groups")
    if x.device.type == "cpu":
        return group_norm_relu_plain(x, weight, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_relu: no kernel for {x.device}")
    return _group_norm_relu_cuda(x, weight, bias, num_groups, eps)


group_norm_relu.launches = 0
