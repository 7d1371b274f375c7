"""GroupNorm + ReLU for the head towers (port of the TPU kernel
paa_tpu/ops/fused_gn.py::fused_group_norm_relu, body ``_gn_kernel``).

GroupNorm(G, eps) followed by ReLU, as the reference's towers apply it
(make_layers.py group_norm -> nn.GroupNorm(32, C, eps=1e-5), then ReLU;
rpn/paa/paa.py:33-44). Statistics are float32, per (image, group), in
two passes: the mean, then the centred variance. The affine is folded
into a = scale * rsqrt(var + eps) and b = bias - mean * a, and the output
relu(x * a + b) is cast back to the input dtype.

``group_norm_relu`` dispatches on the tensor's device: the plain PyTorch
version for CPU tensors, the Triton kernel for CUDA tensors. There is no
fallback between the two, and no shape gate: the kernel serves every
level down to P7 (7 x 11 positions at 800 x 1344).

The Triton kernel. What bounds it on the card: bytes. It reads x and
writes y, 2 * B * C * H * W * itemsize bytes, with about ten operations
per element, far below the card's operations-per-byte balance. Its
design: one program per (image, group) of an NCHW-contiguous tensor,
where the group is one contiguous run of (C / G) * H * W elements, so
every load is a coalesced stream. It walks that run three times (sum,
centred sum of squares, normalise): simple, exact to the two-pass
semantics, and up to four times the bound's bytes where the 50 MB L2
cache cannot hold the re-reads (the P3 tower input is 69 MB in bf16 at
B=8). The kernel takes only NCHW-contiguous input and the wrapper raises
on any other layout.
"""

from __future__ import annotations

import functools
import os

import torch

from . import _build

tl = None  # triton.language, bound at the first launch (see _kernel)

_BLOCK = 1024


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


def _gn_relu_kernel(x_ptr, w_ptr, b_ptr, y_ptr, hw, num_groups, cpg, eps,
                    BLOCK: tl.constexpr):
    """One program per (image, group); the group is the contiguous run
    x[base : base + cpg * hw] of an NCHW tensor."""
    pid = tl.program_id(0)
    group_size = cpg * hw
    base = pid.to(tl.int64) * group_size
    offs = tl.arange(0, BLOCK)

    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for start in range(0, group_size, BLOCK):
        m = start + offs < group_size
        acc += tl.load(x_ptr + base + start + offs, mask=m,
                       other=0.0).to(tl.float32)
    mean = tl.sum(acc, axis=0) / group_size

    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for start in range(0, group_size, BLOCK):
        m = start + offs < group_size
        v = tl.load(x_ptr + base + start + offs, mask=m,
                    other=0.0).to(tl.float32)
        d = tl.where(m, v - mean, 0.0)
        acc += d * d
    rstd = 1.0 / tl.sqrt(tl.sum(acc, axis=0) / group_size + eps)

    c0 = (pid % num_groups) * cpg
    for ci in range(0, cpg):
        a = tl.load(w_ptr + c0 + ci) * rstd
        sh = tl.load(b_ptr + c0 + ci) - mean * a
        row = base + ci * hw
        for start in range(0, hw, BLOCK):
            m = start + offs < hw
            v = tl.load(x_ptr + row + start + offs, mask=m,
                        other=0.0).to(tl.float32)
            out = tl.maximum(v * a + sh, 0.0)
            tl.store(y_ptr + row + start + offs,
                     out.to(y_ptr.dtype.element_ty), mask=m)


@functools.cache
def _kernel():
    """The jitted kernel. triton is imported here, at the first launch,
    because hosts without a card have no triton; the kernel body reads
    ``tl`` from this module's globals when Triton compiles it. Unless the
    caller chose a Triton cache, compiled kernels go to the package's
    build directory beside the nvcc libraries."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(_build.BUILD_DIR, "triton"))
    import triton
    import triton.language

    globals()["tl"] = triton.language
    return triton.jit(_gn_relu_kernel)


def _group_norm_relu_triton(x, weight, bias, num_groups, eps):
    b, c, h, w = x.shape
    if not x.is_contiguous():
        raise ValueError(
            "group_norm_relu kernel takes NCHW-contiguous input, got "
            f"strides {x.stride()} for shape {tuple(x.shape)}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"group_norm_relu kernel: no {x.dtype} path")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (c,) or p.dtype != torch.float32 or \
                p.device != x.device or not p.is_contiguous():
            raise ValueError(
                f"{name}: {p.dtype} {tuple(p.shape)} on {p.device}, the "
                f"kernel takes contiguous float32 ({c},) on {x.device}"
            )
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        _kernel()[(b * num_groups,)](
            x, weight, bias, y, h * w, num_groups, c // num_groups, eps,
            BLOCK=_BLOCK, num_warps=4,
        )
    group_norm_relu.launches += 1
    return y


def group_norm_relu(x, weight, bias, num_groups=32, eps=1e-5):
    """relu(GroupNorm(x)) for x (B, C, H, W) in float32, bfloat16 or
    float16 and float32 weight, bias (C,); returns x's dtype.

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel (counted in ``group_norm_relu.launches``) or raise."""
    if x.shape[1] % num_groups:
        raise ValueError(f"{x.shape[1]} channels in {num_groups} groups")
    if x.device.type == "cpu":
        return group_norm_relu_plain(x, weight, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_relu: no kernel for {x.device}")
    return _group_norm_relu_triton(x, weight, bias, num_groups, eps)


group_norm_relu.launches = 0
