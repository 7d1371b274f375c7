"""Deformable convolution v1/v2 in plain PyTorch (port of
paa_tpu/ops/dcn.py's exact "gather" lowering; reference
paa_core/csrc/cuda/deform_conv_kernel_cuda.cu and DFConv2d,
paa_core/layers/misc.py:113-185).

The JAX package's ``onehot``, ``auto`` and ``optimistic`` modes
(``TPU.DCN_MODE``, ``DCN_WINDOW_MARGIN``) are TPU lowerings of the same
function: ``auto`` computes what ``gather`` computes, and the port
computes that. Tensors are NCHW; the steps are the JAX package's:

1. geometry (``_geometry``): sample coordinates in float32 (bf16
   positions lose whole pixels beyond ~256), the top-left corner of
   each sample's 2x2 patch in the 1-padded frame, and the four bilinear
   corner weights with the reference's center gate (the whole sample is
   zero unless -1 < y < H and -1 < x < W) and the v2 mask folded in.
   Corners outside the image land on the zero ring of the padding;
2. sampling (``_sample_columns``): a patch table over the zero-extended
   grid holds, for each (y, x), the four pixels (y-1..y, x-1..x) side
   by side, so each sample is ONE row gather of 4C channels
   (``index_select`` of rows; no index is expanded to the channel
   width), then the corner weighting;
3. contraction (``_contract``): the (B*Ho*Wo, K*C) columns against the
   weight, per conv group: the GEMM the reference host code runs.

The gathered rows of a layer take B*Ho*Wo*K*4C values (5 GB at stage 3
of X-152-32x8d at B=8 in bf16), so steps 2-3 run over chunks of images
whose gathered rows stay under ``CHUNK_BYTES``.

Under autograd, ``DeformConv`` goes through ``DeformConv2dFunction``:
the counterpart of the JAX package's custom VJP (``sample_auto``,
ops/dcn.py:528-554). Autograd through ``deform_conv2d`` would keep every
chunk's gathered rows for the backward, those of every DCN layer of a
train step at once; the Function keeps only its inputs (x, offsets,
mask, weight) and recomputes each chunk's geometry, patch table,
sampling and contraction inside its backward, where it takes the
chunk's VJP and frees it before the next. Its gradients are autograd's
through ``deform_conv2d``, which stays as the plain version the tests
hold it against.

Offset channel layout as torch's deform_conv2d: per deformable group,
per kernel tap (row-major), a (dy, dx) pair; the mask's dg*K channels
follow all offsets in the offset conv's output and pass a sigmoid.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from ..modeling.layers import Conv, init_conv_weight

CHUNK_BYTES = 2 << 30  # gathered rows per chunk of images
# the spans of the forward's sampling and contraction, and of the
# backward's recompute and VJP, which chip_smoke.py's train profile and
# tools/profile_train_step.py read; of the benchmark's metrics,
# serve.dcn_forward_ms reads the first and train.dcn_backward_ms the
# second
SPAN_FORWARD = "deform_conv2d/forward"
SPAN_BACKWARD = "deform_conv2d/backward"


def _out_size(size, k, s, p, d):
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def _geometry(offsets, mask, h, w, kh, kw, s, p, d, dg):
    """Corner rows and weights of every sample.

    offsets: (B, dg*K*2, Ho, Wo); mask: (B, dg*K, Ho, Wo) or None.
    Returns y0p, x0p: (B, Ho, Wo, K, dg) int64, the top-left corner in
    the 1-padded frame (0 is the zero row/col above/left of the image,
    the bottom-right corner is (+1, +1)), and cw: (B, Ho, Wo, K, dg, 4)
    float32 corner weights in the order (tl, tr, bl, br)."""
    b, _, ho, wo = offsets.shape
    k = kh * kw
    f32 = torch.float32
    dev = offsets.device
    off = offsets.to(f32).view(b, dg, k, 2, ho, wo).permute(0, 4, 5, 2, 1, 3)
    base_y = (torch.arange(ho, dtype=f32, device=dev) * s - p)
    base_x = (torch.arange(wo, dtype=f32, device=dev) * s - p)
    taps = torch.arange(k, dtype=f32, device=dev)
    ky = torch.div(taps, kw, rounding_mode="floor") * d
    kx = torch.remainder(taps, kw) * d
    # (B, Ho, Wo, K, dg), summed in the JAX package's order
    ys = (base_y[:, None, None, None] + ky[None, None, :, None]) + off[..., 0]
    xs = (base_x[None, :, None, None] + kx[None, None, :, None]) + off[..., 1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    gate = ((ys > -1) & (ys < h) & (xs > -1) & (xs < w)).to(f32)
    y0p = y0.clamp(-1, h - 1).long() + 1
    x0p = x0.clamp(-1, w - 1).long() + 1
    cw = torch.stack([(1 - wy) * (1 - wx), (1 - wy) * wx,
                      wy * (1 - wx), wy * wx], dim=-1) * gate[..., None]
    if mask is not None:
        m = mask.to(f32).view(b, dg, k, ho, wo).permute(0, 3, 4, 2, 1)
        cw = cw * m[..., None]
    return y0p, x0p, cw


def _images_per_chunk(x, ho, wo, k):
    """Images per chunk: their gathered rows (Ho*Wo*K rows of 4C values
    each) stay under CHUNK_BYTES, one image at least."""
    b, c = x.shape[:2]
    per_image = ho * wo * k * 4 * c * x.element_size()
    return max(1, min(b, CHUNK_BYTES // max(per_image, 1)))


def _patch_table(x, dg):
    """(B, C, H, W) -> ((B*(H+1)*(W+1)*dg, 4*C/dg) rows, H+1, W+1): row
    ((b*(H+1) + y)*(W+1) + x)*dg + g holds deformable group g's channels
    of the padded input at (y, x), (y, x+1), (y+1, x), (y+1, x+1)."""
    b, c, h, w = x.shape
    xp = nn.functional.pad(x, (1, 1, 1, 1)).permute(0, 2, 3, 1)
    q = torch.stack([xp[:, :-1, :-1], xp[:, :-1, 1:],
                     xp[:, 1:, :-1], xp[:, 1:, 1:]], dim=3)
    q = q.view(b, h + 1, w + 1, 4, dg, c // dg).transpose(3, 4)
    return q.contiguous().view(-1, 4 * (c // dg)), h + 1, w + 1


def _sample_columns(table, rows, cw):
    """Gather the 2x2 patch of every sample and weight its corners.

    table: (R, 4*cg); rows: (N,) int64 into it; cw: (N, 4) in the
    table's dtype. Returns (N, cg)."""
    patches = table.index_select(0, rows).view(rows.shape[0], 4, -1)
    return (patches * cw[:, :, None]).sum(dim=1)


def _contract(col, weight, groups):
    """(N, K, C) columns x (O, C/groups, kh, kw) weight -> (N, O): per
    group g, the columns of its C/groups channels at every tap against
    weight[g*O/groups:(g+1)*O/groups] (deform_conv_cuda.cu:
    weight.view(g, O/g, C/g*k) @ col.view(g, C/g*k, hw))."""
    n, k, c = col.shape
    o, cin_g = weight.shape[:2]
    if groups == 1:
        w = weight.permute(2, 3, 1, 0).reshape(k * c, o)
        return col.reshape(n, k * c) @ w
    og = o // groups
    w = weight.view(groups, og, cin_g, k).permute(0, 3, 2, 1)
    col = col.view(n, k, groups, cin_g).permute(2, 0, 1, 3)
    out = torch.bmm(col.reshape(groups, n, k * cin_g),
                    w.reshape(groups, k * cin_g, og))
    return out.permute(1, 0, 2).reshape(n, o)


def deform_conv2d(x, offsets, mask, weight, stride=1, padding=1,
                  dilation=1, groups=1, deformable_groups=1):
    """Modulated (``mask`` given) or v1 (``mask`` None) deformable conv.

    x: (B, C, H, W); offsets: (B, dg*K*2, Ho, Wo) as (dy, dx) pairs;
    mask: (B, dg*K, Ho, Wo), already through the sigmoid, or None;
    weight: (O, C/groups, kh, kw) in x's dtype. Returns (B, O, Ho, Wo)
    in x's dtype. Coordinates and corner weights are float32; the
    corner weights are then cast to x's dtype, as in the JAX package."""
    b, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    k, dg = kh * kw, deformable_groups
    s, p, d = stride, padding, dilation
    ho, wo = _out_size(h, kh, s, p, d), _out_size(w, kw, s, p, d)
    if offsets.shape != (b, dg * k * 2, ho, wo):
        raise ValueError(f"offsets {tuple(offsets.shape)}, expected "
                         f"{(b, dg * k * 2, ho, wo)}")
    y0p, x0p, cw = _geometry(offsets, mask, h, w, kh, kw, s, p, d, dg)
    table, hp, wp = _patch_table(x, dg)
    image = torch.arange(b, device=x.device).view(b, 1, 1, 1, 1)
    group = torch.arange(dg, device=x.device)
    rows = ((image * hp + y0p) * wp + x0p) * dg + group
    cw = cw.to(x.dtype)

    step = _images_per_chunk(x, ho, wo, k)
    outs = []
    for i in range(0, b, step):
        j = min(b, i + step)
        n = (j - i) * ho * wo
        col = _sample_columns(table, rows[i:j].reshape(-1),
                              cw[i:j].reshape(-1, 4))
        outs.append(_contract(col.view(n, k, c), weight, groups))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.view(b, ho, wo, o).permute(0, 3, 1, 2).contiguous()


class DeformConv2dFunction(torch.autograd.Function):
    """``deform_conv2d`` whose backward keeps only its inputs.

    The forward is ``deform_conv2d`` itself, without a graph, and saves
    (x, offsets, mask, weight). The backward takes the forward's chunks
    of images again (``_images_per_chunk``); for each it recomputes
    ``deform_conv2d`` of the chunk's slices of x, offsets and mask (the
    chunk's own patch table, its rows based at the chunk's first image)
    under autograd, and takes ``torch.autograd.grad`` of it against
    those slices and the weight with the chunk's slice of the upstream
    gradient. The weight's gradient sums over the chunks. Each chunk's
    gathered rows live only while its VJP runs. Gradients come back in
    their inputs' dtypes; a v1 conv (no mask) passes ``mask=None``."""

    @staticmethod
    def forward(ctx, x, offsets, mask, weight, stride, padding, dilation,
                groups, deformable_groups):
        ctx.conv = (stride, padding, dilation, groups, deformable_groups)
        ctx.save_for_backward(x, offsets, mask, weight)
        with record_function(SPAN_FORWARD):
            return deform_conv2d(x, offsets, mask, weight, *ctx.conv)

    @staticmethod
    def backward(ctx, grad):
        x, offsets, mask, weight = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:4]
        kh, kw = weight.shape[2:]
        step = _images_per_chunk(x, *grad.shape[2:], kh * kw)
        parts = [[], [], []]  # the chunks' gradients of x, offsets, mask
        dweight = None
        with record_function(SPAN_BACKWARD), torch.enable_grad():
            w = weight.detach().requires_grad_(wanted[3])
            for i in range(0, x.shape[0], step):
                j = i + step
                ins = [None if t is None else
                       t[i:j].detach().requires_grad_(want)
                       for t, want in zip((x, offsets, mask), wanted)]
                out = deform_conv2d(*ins, w, *ctx.conv)
                leaves = [t for t in (*ins, w)
                          if t is not None and t.requires_grad]
                grads = iter(torch.autograd.grad(out, leaves, grad[i:j]))
                for part, t in zip(parts, ins):
                    if t is not None and t.requires_grad:
                        part.append(next(grads))
                if wanted[3]:
                    g = next(grads)
                    dweight = g if dweight is None else dweight + g
        dx, doffsets, dmask = (
            (part[0] if len(part) == 1 else torch.cat(part)) if part
            else None for part in parts)
        return dx, doffsets, dmask, dweight, None, None, None, None, None


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
    through ``DeformConv2dFunction``, which records no graph where no
    gradient is wanted."""

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

