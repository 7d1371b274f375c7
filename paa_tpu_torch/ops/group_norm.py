"""GroupNorm, optionally followed by ReLU (port of the TPU kernel
paa_tpu/ops/fused_gn.py::fused_group_norm_relu, body ``_gn_kernel``).

GroupNorm(G, eps) followed by ReLU, as the reference's towers apply it
(make_layers.py group_norm -> nn.GroupNorm(32, C, eps=1e-5), then ReLU;
rpn/paa/paa.py:33-44), or with ``relu=False`` GroupNorm alone (the TPU
kernel's ``relu`` argument): the GN bodies' norms before a residual add,
FPN's GN without USE_RELU. Statistics are float32, per (image, group),
in two passes: the mean, then the centred variance. The affine is folded
into a = scale * rsqrt(var + eps) and b = bias - mean * a, and the output
relu(x * a + b) (or x * a + b) is cast back to the input dtype.

``group_norm_relu`` dispatches on the tensor's device: the plain PyTorch
version for CPU tensors, the CUDA kernel K3 (csrc/group_norm.cu) for
CUDA tensors. Where autograd records (grad enabled, an input requiring
grad), CUDA tensors go through ``GroupNormReLU``, an autograd Function
whose forward is K3 and whose backward is the VJP of the plain version,
recomputed from the saved inputs: the JAX package's custom VJP
(fused_gn.py:161-177, ``jax.vjp`` of ``_gn_relu_reference``), which has
no backward kernel either. There is no fallback between the two, and
no shape gate: the kernel serves every level down to P7 (7 x 11
positions at 800 x 1344). The kernel's header says what bounds it and
how it is built: each (image, group) is one contiguous run of an NCHW
tensor, split over a thread-block cluster of ``cs`` CTAs that hold it
in shared memory, read once from device memory. ``gn_plan`` makes the
launch's choices from the shape alone. The wrapper raises on any layout
other than NCHW-contiguous.

The forward is the ``torch.library`` custom op
``paa_tpu_torch::group_norm_relu`` (one function for both devices: the
plain version for CPU tensors, K3 for CUDA tensors), so that
``torch.export`` records it as one node (serving.py); its fake
implementation gives the output's shape, and its registered autograd
is the same VJP of the plain version. ``group_norm_relu`` calls the op
where autograd does not record; where it records, CPU tensors go
through the plain version under autograd and CUDA tensors through
``GroupNormReLU``, as before the op existed.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass

import torch
from torch.profiler import record_function

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


def group_norm_relu_plain(x, weight, bias, num_groups=32, eps=1e-5,
                          relu=True):
    """The plain PyTorch version, following the JAX package's
    ``_gn_relu_reference``. x: (B, C, H, W); weight, bias: (C,).

    The ReLU is ``torch.maximum(out, 0)``, whose gradient, like that of
    the reference's ``jnp.maximum(out, 0.0)``, is half the upstream
    gradient where ``out`` is exactly 0 (``torch.relu`` gives 0 there).
    That happens in a group of zero variance with a zero bias, GN's
    initial value; GroupNormReLU's backward differentiates this
    function, so both training paths take the same rule. With
    ``relu=False`` it is GroupNorm alone, and its gradient GroupNorm's.

    It computes in float32, or in float64 for a float64 ``x`` (a
    float64 reference step)."""
    b, c, h, w = x.shape
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct).reshape(b, num_groups, (c // num_groups) * h * w)
    mean = xf.mean(dim=2, keepdim=True)
    var = (xf - mean).square().mean(dim=2, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    out = xn * weight.to(ct)[:, None, None] + bias.to(ct)[:, None, None]
    if relu:
        out = torch.maximum(out, out.new_zeros(()))
    return out.to(x.dtype)


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
        [vp] * 4 + [ci] * 11 + [ctypes.c_float, ci, vp])
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


def _group_norm_relu_cuda(x, weight, bias, num_groups, eps, relu=True):
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
            int(plan.resident), plan.smem_bytes, float(eps), int(relu),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"group_norm_relu kernel launch failed: CUDA error {err}")
    group_norm_relu.launches += 1
    return y


# the span of the backward's recompute, which tools/profile_train_step.py
# and the benchmark's train.gn_backward_ms read
SPAN_BACKWARD = "group_norm_relu/backward"


class GroupNormReLU(torch.autograd.Function):
    """relu(GroupNorm(x)), or GroupNorm(x) with ``relu`` False, with
    ``forward_fn`` (K3's launcher on the main path; a CPU test passes the
    plain version) as the forward, and the VJP of
    ``group_norm_relu_plain`` as the backward: it saves (x, weight, bias)
    and recomputes the plain version under autograd. Returns the
    gradient of x in x's dtype and those of weight and bias in
    float32."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, forward_fn,
                relu=True):
        ctx.save_for_backward(x, weight, bias)
        ctx.num_groups, ctx.eps, ctx.relu = num_groups, eps, relu
        return forward_fn(x, weight, bias, num_groups, eps, relu)

    @staticmethod
    def backward(ctx, grad):
        return _plain_vjp(ctx, grad)


def _plain_vjp(ctx, grad):
    """The gradients of (x, weight, bias) and None for the other inputs:
    the VJP of ``group_norm_relu_plain``, recomputed from the saved
    (x, weight, bias)."""
    saved = ctx.saved_tensors
    wanted = ctx.needs_input_grad[:3]
    with record_function(SPAN_BACKWARD), torch.enable_grad():
        inputs = [t.detach().requires_grad_(w)
                  for t, w in zip(saved, wanted)]
        y = group_norm_relu_plain(*inputs, ctx.num_groups, ctx.eps,
                                  ctx.relu)
        grads = iter(torch.autograd.grad(
            y, [t for t in inputs if t.requires_grad], grad))
    rest = len(ctx.needs_input_grad) - 3  # num_groups, eps(, fn), relu
    return (*(next(grads) if w else None for w in wanted),
            *(None,) * rest)


def _group_norm_relu_impl(x, weight, bias, num_groups, eps, relu):
    """``paa_tpu_torch::group_norm_relu`` on either device."""
    if x.device.type == "cpu":
        return group_norm_relu_plain(x, weight, bias, num_groups, eps, relu)
    return _group_norm_relu_cuda(x, weight, bias, num_groups, eps, relu)


@torch.library.custom_op("paa_tpu_torch::group_norm_relu", mutates_args=(),
                         device_types="cpu")
def _group_norm_relu_op(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, num_groups: int, eps: float,
                        relu: bool) -> torch.Tensor:
    return _group_norm_relu_impl(x, weight, bias, num_groups, eps, relu)


_group_norm_relu_op.register_kernel("cuda")(_group_norm_relu_impl)


@_group_norm_relu_op.register_fake
def _(x, weight, bias, num_groups, eps, relu):
    return torch.empty_like(x)


def _setup_context(ctx, inputs, output):
    x, weight, bias, num_groups, eps, relu = inputs
    ctx.save_for_backward(x, weight, bias)
    ctx.num_groups, ctx.eps, ctx.relu = num_groups, eps, relu


_group_norm_relu_op.register_autograd(_plain_vjp,
                                      setup_context=_setup_context)


def group_norm_relu(x, weight, bias, num_groups=32, eps=1e-5, relu=True):
    """relu(GroupNorm(x)), or GroupNorm(x) with ``relu`` False, for x
    (B, C, H, W) in float32, bfloat16 or float16 and float32 weight,
    bias (C,); returns x's dtype.

    CPU tensors take the plain version; CUDA tensors launch K3
    (csrc/group_norm.cu, counted in ``group_norm_relu.launches``) or
    raise, through ``GroupNormReLU`` where autograd records, else through
    the custom op ``paa_tpu_torch::group_norm_relu``."""
    if x.shape[1] % num_groups:
        raise ValueError(f"{x.shape[1]} channels in {num_groups} groups")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_norm_relu: no kernel for {x.device}")
    if torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad or bias.requires_grad):
        if x.device.type == "cpu":
            return group_norm_relu_plain(x, weight, bias, num_groups, eps,
                                         relu)
        return GroupNormReLU.apply(x, weight, bias, num_groups, eps,
                                   _group_norm_relu_cuda, relu)
    return _group_norm_relu_op(x, weight, bias, int(num_groups), float(eps),
                               bool(relu))


group_norm_relu.launches = 0
