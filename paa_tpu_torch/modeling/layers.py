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


class Linear(nn.Module):
    """Fully connected layer in float32 (flax ``nn.Dense`` with no dtype,
    as the JAX package's box head uses it). Initialised as the JAX
    package does: kaiming-uniform (a=1, bound sqrt(3 / in_features)) by
    default, normal(std) when ``normal_std`` is given; bias zero."""

    def __init__(self, in_features, out_features, normal_std=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.normal_std = normal_std

    def reset_parameters(self, generator):
        with torch.no_grad():
            if self.normal_std is None:
                bound = math.sqrt(3.0 / self.weight.shape[1])
                self.weight.uniform_(-bound, bound, generator=generator)
            else:
                self.weight.normal_(0.0, self.normal_std,
                                    generator=generator)
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x.to(torch.float32), self.weight, self.bias)


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


class GroupNorm32(nn.Module):
    """GroupNorm (32 groups, eps 1e-5) followed by ReLU, through the
    group_norm_relu kernel on the card. The JAX package applies flax
    GroupNorm and a separate relu here; tests/test_fused_gn.py pins the
    two to the same numbers."""

    def __init__(self, features, num_groups=32, eps=1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return group_norm_relu(x, self.weight, self.bias, self.num_groups,
                               self.eps)


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
    """Initialise every ``Conv``, ``Linear`` and ``DeformConv`` under
    ``module`` from ``generator``, in module order; norms and scales keep
    their constructor values."""
    from ..ops.dcn import DeformConv  # ops/dcn.py imports this module

    for m in module.modules():
        if isinstance(m, (Conv, Linear, DeformConv)):
            m.reset_parameters(generator)
