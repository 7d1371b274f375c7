"""Shared layers (port of paa_tpu/modeling/layers.py).

Tensors are NCHW inside the port. Parameters stay float32; ``Conv``
casts its input and weights to the compute dtype (bfloat16 or float32),
as the JAX package's ``conv(dtype=...)`` does. Parameter names follow
the JAX package's flax scopes (see utils/jax_params.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dcn import DeformConv2dFunction
from ..ops.group_norm import group_norm_relu


def init_conv_weight(weight, normal_std, generator):
    """A conv weight (O, C/groups, kh, kw) as the JAX package initialises
    it: kaiming-uniform (a=1, bound sqrt(3 / fan_in), fan_in =
    C/groups*kh*kw) when ``normal_std`` is None, else normal(std)."""
    if normal_std is None:
        bound = math.sqrt(3.0 / weight[0].numel())
        weight.uniform_(-bound, bound, generator=generator)
    else:
        weight.normal_(0.0, normal_std, generator=generator)


class Conv(nn.Module):
    """Conv2d with torch-style explicit padding, float32 parameters and a
    compute dtype; ``groups`` (ResNeXt) and ``dilation`` as in
    ``F.conv2d``. Initialised as the JAX package does: kaiming-uniform
    (a=1, bound sqrt(3 / fan_in), fan_in = cin / groups * kh * kw, the
    JAX HWIO kernel's fan-in) by default, normal(std) when
    ``normal_std`` is given, zero with ``zero_init`` (DCN offset convs);
    bias zero or ``bias_value``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=False, dtype=torch.float32,
                 normal_std=None, bias_value=0.0, groups=1, dilation=1,
                 zero_init=False):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.dilation = dilation
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.normal_std = normal_std
        self.bias_value = bias_value
        self.zero_init = zero_init

    def reset_parameters(self, generator):
        with torch.no_grad():
            if self.zero_init:
                self.weight.zero_()
            else:
                init_conv_weight(self.weight, self.normal_std, generator)
            if self.bias is not None:
                self.bias.fill_(self.bias_value)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.stride, self.padding, self.dilation,
                        self.groups)


class DeformConv(nn.Module):
    """Offset conv + deformable sampling + weight contraction (port of
    the JAX package's ``DeformConv``, ops/dcn.py:557-629; DFConv2d).

    ``offset`` is a float32 conv with bias, zero-initialised (DFConv2d),
    whose dg*K*2 offset channels are followed, when ``modulated``, by
    dg*K mask logits through a sigmoid: in the JAX package it has no
    compute dtype, so it runs in its float32 parameters' precision.
    ``weight`` (O, C/groups, kh, kw) and the optional ``bias`` compute
    in ``dtype``. Initialised as the JAX module: kaiming-uniform (a=1)
    by default (the backbone), normal(std) when ``normal_std`` is given
    (the head tower); bias zero. The sampling and contraction go
    through ops/dcn.py's ``DeformConv2dFunction``, which records no graph
    where no gradient is wanted."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, dilation=1, groups=1, deformable_groups=1,
                 modulated=True, bias=False, dtype=torch.float32,
                 normal_std=None):
        super().__init__()
        k = kernel_size * kernel_size
        self.n_offsets = deformable_groups * k * 2
        self.offset = Conv(
            in_channels,
            self.n_offsets + (deformable_groups * k if modulated else 0),
            kernel_size, stride=stride, padding=padding, bias=True,
            dilation=dilation, zero_init=True)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.deformable_groups = deformable_groups
        self.modulated = modulated
        self.dtype = dtype
        self.normal_std = normal_std

    def reset_parameters(self, generator):
        """The sampled conv's weight and bias; ``offset`` is a ``Conv``
        and is reset on its own (to zero)."""
        with torch.no_grad():
            init_conv_weight(self.weight, self.normal_std, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        offset_mask = self.offset(x)
        offsets = offset_mask[:, :self.n_offsets]
        mask = (torch.sigmoid(offset_mask[:, self.n_offsets:])
                if self.modulated else None)
        out = DeformConv2dFunction.apply(
            x.to(self.dtype), offsets, mask, self.weight.to(self.dtype),
            self.stride, self.padding, self.dilation, self.groups,
            self.deformable_groups)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)[:, None, None]
        return out


class Linear(nn.Module):
    """Fully connected layer in float32 (flax ``nn.Dense`` with no dtype,
    as the JAX package's box head uses it). Initialised as the JAX
    package does: kaiming-uniform (a=1, bound sqrt(3 / in_features)) by
    default, normal(std) when ``normal_std`` is given; bias zero, none
    with ``bias=False`` (the GN box heads' fc6/fc7)."""

    def __init__(self, in_features, out_features, normal_std=None,
                 bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.normal_std = normal_std

    def reset_parameters(self, generator):
        with torch.no_grad():
            if self.normal_std is None:
                bound = math.sqrt(3.0 / self.weight.shape[1])
                self.weight.uniform_(-bound, bound, generator=generator)
            else:
                self.weight.normal_(0.0, self.normal_std,
                                    generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return F.linear(x.to(torch.float32), self.weight, self.bias)


class ConvTranspose(nn.Module):
    """A transposed conv: the mask predictors' 2x2 stride 2, the keypoint
    predictor's 4x4 stride 2 with ``padding`` 1 (flax's explicit (2, 2):
    kernel - 1 - padding per side). By default in float32 (flax
    ``nn.ConvTranspose`` with no dtype computes in float32 from a
    bfloat16 input), else in ``dtype``; kaiming-uniform (a=1) with the
    JAX kernel's fan-in (kh * kw * cin) by default, normal(std) when
    ``normal_std`` is given; bias zero. ``weight`` is torch's (cin, cout,
    kh, kw); the JAX kernel is its spatial flip (utils/jax_params.py)."""

    def __init__(self, in_channels, out_channels, kernel_size=2, stride=2,
                 padding=0, dtype=torch.float32, normal_std=None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.normal_std = normal_std
        self.weight = nn.Parameter(torch.empty(
            in_channels, out_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator):
        with torch.no_grad():
            cin, _, kh, kw = self.weight.shape
            if self.normal_std is None:
                bound = math.sqrt(3.0 / (cin * kh * kw))
                self.weight.uniform_(-bound, bound, generator=generator)
            else:
                self.weight.normal_(0.0, self.normal_std,
                                    generator=generator)
            self.bias.zero_()

    def forward(self, x):
        return F.conv_transpose2d(x.to(self.dtype),
                                  self.weight.to(self.dtype),
                                  self.bias.to(self.dtype),
                                  stride=self.stride, padding=self.padding)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics: y = x * (weight * rsqrt(var)) +
    (bias - mean * scale), with NO epsilon, as the reference's
    layers/batch_norm.py:19-24. The four tensors are buffers."""

    def __init__(self, features):
        super().__init__()
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var)
        shift = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


class SyncBatchNorm(nn.Module):
    """Trainable BatchNorm on the global batch's statistics (MODEL.USE_SYNCBN;
    the JAX package's SyncBatchNorm, flax ``nn.BatchNorm`` with momentum
    0.9 and eps 1e-5). Not ``torch.nn.SyncBatchNorm``: flax differs from
    it in three ways, which this module follows.

    - Training mode: float32 sums of x and x^2 over (N, H, W) and the
      element count on the local batch, summed over the ranks of a
      process group with the gradient flowing back through the sum; mean
      = E[x], var = max(E[x^2] - E[x]^2, 0) (flax's fast variance).
    - The running statistics move by running = 0.9 * running + 0.1 *
      batch, with the biased variance; there is no
      ``num_batches_tracked``. Every rank sums the same numbers, so every
      rank holds the same running statistics.
    - Eval mode normalizes by the running statistics.

    It computes in float32, or float64 for a float64 input, and so
    returns (flax promotes to its float32 parameters); the next conv
    casts the output to its compute dtype.
    ``weight`` and ``bias`` are flax's ``bn/scale`` and ``bn/bias``;
    ``running_mean`` and ``running_var`` its ``batch_stats`` ``bn/mean``
    and ``bn/var``."""

    def __init__(self, features, momentum=0.9, eps=1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def batch_stats(self, x):
        """(mean, var) of ``x`` over (N, H, W) and the ranks."""
        from ..utils import comm  # utils imports this module

        c = x.shape[1]
        sums = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                          x.new_full((1,), x.numel() // c)])
        if comm.get_world_size() > 1:
            from torch.distributed.nn.functional import all_reduce

            sums = all_reduce(sums)
        mean = sums[:c] / sums[-1]
        return mean, torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean,
                                 min=0.0)

    def forward(self, x):
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean, var = self.batch_stats(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class GroupNorm32(nn.Module):
    """GroupNorm (32 groups, eps 1e-5, the reference's make_layers.py
    group_norm) through the group_norm_relu kernel K3 on the card:
    followed by ReLU with ``relu`` True (the towers, a GN body's bn1/bn2,
    the ROI heads' GN before their ReLU: K3's fused form), alone with
    ``relu`` False (a GN body's bn3 and downsample before the residual
    add, FPN's GN without USE_RELU). The JAX package applies flax
    GroupNorm and a separate relu; tests/test_fused_gn.py pins the two
    to the same numbers. Its input is NCHW; a (R, C) input (the GN box
    head's fc GN) is normalised as (R, C, 1, 1)."""

    def __init__(self, features, num_groups=32, eps=1e-5, relu=True):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.relu = relu
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if x.dim() == 2:
            return self(x[:, :, None, None])[:, :, 0, 0]
        return group_norm_relu(x, self.weight, self.bias, self.num_groups,
                               self.eps, self.relu)


def gn_or_relu(gn, x, relu=True):
    """x through ``gn`` (a GroupNorm32, its ReLU fused or not), or with
    none through a ReLU when ``relu``: make_layers.py's conv blocks, with
    and without GN."""
    if gn is not None:
        return gn(x)
    return F.relu(x) if relu else x


class Scale(nn.Module):
    """Learnable scalar multiplier (reference layers Scale, init 1.0)."""

    def __init__(self, init_value=1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


def max_pool_3x3_s2(x):
    """3x3/2 max pool with pad 1 (reference F.max_pool2d(x, 3, 2, 1))."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def reset_parameters(module, generator):
    """Initialise every ``Conv``, ``ConvTranspose``, ``Linear`` and
    ``DeformConv`` under ``module`` from ``generator``, in module order;
    norms and scales keep their constructor values."""
    for m in module.modules():
        if isinstance(m, (Conv, ConvTranspose, Linear, DeformConv)):
            m.reset_parameters(generator)
