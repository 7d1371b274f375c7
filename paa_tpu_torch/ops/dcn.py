"""Deformable convolution v1/v2 in plain PyTorch (port of
paa_tpu/ops/dcn.py's exact "gather" lowering; reference
paa_core/csrc/cuda/deform_conv_kernel_cuda.cu and DFConv2d,
paa_core/layers/misc.py:113-185).

The JAX package's ``onehot``, ``auto`` and ``optimistic`` modes
(``TPU.DCN_MODE``, ``DCN_WINDOW_MARGIN``) are TPU lowerings of the same
function: ``auto`` computes what ``gather`` computes, and the port
computes that. Tensors are NCHW; the steps are the JAX package's:

1. geometry and 2. sampling: those of ops/deform_sampling.py
   (``_sampling``: ``_geometry``, ``_patch_table``, ``_sample_columns``),
   which also holds K4;
3. contraction (``_contract``): the (B*Ho*Wo, K*C) columns against the
   weight, per conv group: the GEMM the reference host code runs.

The gathered rows of a layer take B*Ho*Wo*K*4C values (5 GB at stage 3
of X-152-32x8d at B=8 in bf16), so steps 2-3 run over chunks of images
whose gathered rows stay under ``CHUNK_BYTES``.

Under autograd, the ``DeformConv`` module (modeling/layers.py) goes
through ``DeformConv2dFunction``: the counterpart of the JAX package's
custom VJP (``sample_auto``, ops/dcn.py:528-554). Autograd through
``deform_conv2d`` would keep every chunk's gathered rows for the
backward, those of every DCN layer of a train step at once; the
Function keeps only its inputs (x, offsets, mask, weight), and its
backward takes one of two routes:

- CUDA tensors (``deform_conv2d_columns_backward``): explicit gradients
  by chunks of images whose columns stay under ``CHUNK_BYTES`` (one
  chunk a layer at X-152's B=8). The columns' gradient is the output's
  gradient times the weight (``_columns_grad``, the transpose of the
  forward's product); the weight's is the output's gradient times K4's
  columns, recomputed (``_weight_grad``); and K5, the hand-written
  kernel csrc/deform_col2im.cu (``deform_sampling.deform_col2im``, op
  ``paa_tpu_torch::deform_col2im``, launches counted in
  ``deform_col2im.launches``), takes the columns' gradient back through
  the sampling to x, the offsets and the mask;
- CPU tensors (``_recompute_backward``): each chunk's geometry, patch
  table, sampling and contraction recomputed under autograd and its VJP
  taken, the chunk's gathered rows freed before the next. Its gradients
  are autograd's through ``deform_conv2d``, which stays as the plain
  version the tests hold both routes against.

On CUDA tensors the forward takes K4 instead (``deform_conv2d_columns``):
the hand-written kernel csrc/deform_im2col.cu computes steps 1-2 in one
pass, writing the columns once in the layout the product reads, and
``_contract_columns`` multiplies them by the weight into the NCHW
output. It is the custom op ``paa_tpu_torch::deform_im2col``
(``deform_sampling.deform_im2col``, launches counted in
``deform_im2col.launches``); its plain version ``_im2col_columns`` takes
the steps above and rearranges their columns into K4's layout. CPU
tensors keep ``deform_conv2d``.

Offset channel layout as torch's deform_conv2d: per deformable group,
per kernel tap (row-major), a (dy, dx) pair; the mask's dg*K channels
follow all offsets in the offset conv's output and pass a sigmoid.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from .deform_sampling import (_out_size, _sample_columns, _sampling,
                              deform_col2im, deform_im2col)

# gathered rows (the plain version) or columns (K4) per chunk of images
CHUNK_BYTES = 2 << 30
# the spans of the forward's sampling and contraction, and of the
# backward's recompute and VJP, which tools/profile_train_step.py reads;
# of the benchmark's metrics, serve.dcn_forward_ms reads the first and
# train.dcn_backward_ms the second
SPAN_FORWARD = "deform_conv2d/forward"
SPAN_BACKWARD = "deform_conv2d/backward"


def _images_per_chunk(x, ho, wo, k, per_channel=4):
    """Images per chunk: the Ho*Wo*K*C*``per_channel`` values an image
    takes stay under CHUNK_BYTES, one image at least. The plain
    version's gathered rows hold 4 values per channel (the four
    corners), K4's columns 1."""
    b, c = x.shape[:2]
    per_image = ho * wo * k * per_channel * c * x.element_size()
    return max(1, min(b, CHUNK_BYTES // max(per_image, 1)))


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
    table, rows, cw = _sampling(x, offsets, mask, kh, kw, s, p, d, dg)

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


def _group_weight(weight, groups):
    """The weight (O, C/groups, kh, kw) as (groups, O/groups,
    K*C/groups), taps outer: each conv group's matrix against K4's
    columns."""
    o, cg = weight.shape[:2]
    return (weight.view(groups, o // groups, cg, -1).transpose(2, 3)
            .reshape(groups, o // groups, -1))


def _contract_columns(col, weight, ho, wo):
    """K4's columns (B, groups, Ho*Wo, K*C/groups) x the weight (O,
    C/groups, kh, kw) -> (B, O, Ho, Wo): per image and conv group g,
    weight[g*O/groups:(g+1)*O/groups] as (O/groups, K*C/groups), taps
    outer, times the group's columns transposed (deform_conv_cuda.cu's
    GEMM), written as NCHW without a permute."""
    b, groups = col.shape[:2]
    o = weight.shape[0]
    w = _group_weight(weight, groups)
    return torch.matmul(w, col.transpose(2, 3)).view(b, o, ho, wo)


def _columns_grad(grad, weight, groups):
    """The columns' gradient from the output's, grad (B, O, Ho, Wo):
    per image and conv group, the group's output gradient transposed
    times its weight matrix, (B, groups, Ho*Wo, K*C/groups) in K4's
    layout (the transpose of ``_contract_columns``)."""
    b, o = grad.shape[:2]
    dout = grad.reshape(b, groups, o // groups, -1)
    return torch.matmul(dout.transpose(2, 3), _group_weight(weight, groups))


def _weight_grad(grad, col, groups):
    """The weight's gradient in float32 from the output's, grad (B, O,
    Ho, Wo), and K4's columns (B, groups, Ho*Wo, K*C/groups): per conv
    group, the sum over the images of its output gradient times its
    columns, as (groups, O/groups, K*C/groups), taps outer."""
    b, o = grad.shape[:2]
    dout = grad.reshape(b, groups, o // groups, -1)
    return torch.matmul(dout, col).sum(0, dtype=torch.float32)


def deform_conv2d_columns(x, offsets, mask, weight, stride=1, padding=1,
                          dilation=1, groups=1, deformable_groups=1):
    """``deform_conv2d`` through ``deform_im2col``'s columns and
    ``_contract_columns``, in chunks of images whose columns stay under
    CHUNK_BYTES: one K4 launch per chunk on the card, where it is the
    forward's main path."""
    b, c, h, w = x.shape
    _, _, kh, kw = weight.shape
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    step = _images_per_chunk(x, ho, wo, kh * kw, per_channel=1)
    outs = []
    for i in range(0, b, step):
        j = i + step
        col = deform_im2col(x[i:j], offsets[i:j],
                            None if mask is None else mask[i:j], kh, kw,
                            stride, padding, dilation, groups,
                            deformable_groups)
        outs.append(_contract_columns(col, weight, ho, wo))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def deform_conv2d_columns_backward(x, offsets, mask, weight, grad, stride=1,
                                   padding=1, dilation=1, groups=1,
                                   deformable_groups=1,
                                   wanted=(True, True, True, True)):
    """The gradients of ``deform_conv2d_columns`` with respect to x, the
    offsets, the mask and the weight (those ``wanted``, None for the
    others) from the output's, ``grad``, without autograd, by chunks of
    images whose columns stay under CHUNK_BYTES (one chunk a layer at
    X-152's B=8): the weight's from K4's columns recomputed
    (``_weight_grad``), the columns' gradient (``_columns_grad``), then
    K5 (``deform_col2im``) for x's, the offsets' and the mask's, on one
    channels-last copy of x that K4 and K5 share. One K4 launch (where
    the weight's gradient is wanted) and one K5 launch a chunk on the
    card, where it is the backward's main path; CPU tensors take both
    ops' plain versions. Gradients come in their inputs' dtypes (dx
    contiguous); the weight's is summed in float32 first."""
    o, cg, kh, kw = weight.shape
    ho, wo = grad.shape[2:]
    conv = (stride, padding, dilation, groups, deformable_groups)
    step = _images_per_chunk(x, ho, wo, kh * kw, per_channel=1)
    xl = x.contiguous(memory_format=torch.channels_last)
    dx, doffsets, dmask, dweight = [], [], [], None
    for i in range(0, x.shape[0], step):
        j = i + step
        m = None if mask is None else mask[i:j]
        if wanted[3]:
            col = deform_im2col(xl[i:j], offsets[i:j], m, kh, kw, *conv)
            g = _weight_grad(grad[i:j], col, groups)
            dweight = g if dweight is None else dweight + g
            del col
        if any(wanted[:3]):
            dcol = _columns_grad(grad[i:j], weight, groups)
            gx, go, gm = deform_col2im(xl[i:j], offsets[i:j], m, dcol, kh,
                                       kw, *conv)
            del dcol
            dx.append(gx)
            doffsets.append(go)
            dmask.append(gm)
    def whole(parts):
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    dx = whole(dx) if wanted[0] else None
    doffsets = whole(doffsets).to(offsets.dtype) if wanted[1] else None
    dmask = whole(dmask).to(mask.dtype) if wanted[2] else None
    if dweight is not None:
        dweight = (dweight.view(groups, o // groups, kh * kw, cg)
                   .transpose(2, 3).reshape(weight.shape).to(weight.dtype))
    return dx, doffsets, dmask, dweight


def _recompute_backward(x, offsets, mask, weight, grad, conv, wanted):
    """The CPU's backward: per chunk of images (``_images_per_chunk``),
    ``deform_conv2d`` of the chunk's slices of x, offsets and mask (the
    chunk's own patch table, its rows based at the chunk's first image)
    recomputed under autograd, and ``torch.autograd.grad`` of it against
    those slices and the weight with the chunk's slice of ``grad``. The
    weight's gradient sums over the chunks. Each chunk's gathered rows
    live only while its VJP runs."""
    kh, kw = weight.shape[2:]
    step = _images_per_chunk(x, *grad.shape[2:], kh * kw)
    parts = [[], [], []]  # the chunks' gradients of x, offsets, mask
    dweight = None
    with torch.enable_grad():
        w = weight.detach().requires_grad_(wanted[3])
        for i in range(0, x.shape[0], step):
            j = i + step
            ins = [None if t is None else
                   t[i:j].detach().requires_grad_(want)
                   for t, want in zip((x, offsets, mask), wanted)]
            out = deform_conv2d(*ins, w, *conv)
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
    return dx, doffsets, dmask, dweight


class DeformConv2dFunction(torch.autograd.Function):
    """``deform_conv2d`` whose backward keeps only its inputs.

    The forward is ``deform_conv2d`` itself (``deform_conv2d_columns``,
    K4, for CUDA tensors), without a graph, and saves (x, offsets, mask,
    weight), on the card with x channels-last (one copy, read by K4 in
    the forward and by K4 and K5 in the backward). The backward takes one of two routes, inside the span
    SPAN_BACKWARD:

    - CUDA tensors: ``deform_conv2d_columns_backward``, explicit
      gradients by chunks of images (one a layer at X-152's B=8): the
      columns' gradient and the weight's as products, K4's columns
      recomputed for the latter, and K5 (csrc/deform_col2im.cu) for x's,
      the offsets' and the mask's;
    - CPU tensors: ``_recompute_backward``, autograd's VJP through
      ``deform_conv2d`` recomputed chunk by chunk, the reference that the
      tests hold the first route to.

    Gradients come back in their inputs' dtypes; a v1 conv (no mask)
    passes ``mask=None``."""

    @staticmethod
    def forward(ctx, x, offsets, mask, weight, stride, padding, dilation,
                groups, deformable_groups):
        ctx.conv = (stride, padding, dilation, groups, deformable_groups)
        if x.is_cuda:
            # K4 (forward and backward) and K5 read x channels-last: one
            # copy, kept for the backward
            x = x.contiguous(memory_format=torch.channels_last)
        ctx.save_for_backward(x, offsets, mask, weight)
        forward = deform_conv2d_columns if x.is_cuda else deform_conv2d
        with record_function(SPAN_FORWARD):
            return forward(x, offsets, mask, weight, *ctx.conv)

    @staticmethod
    def backward(ctx, grad):
        x, offsets, mask, weight = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:4]
        with record_function(SPAN_BACKWARD):
            if x.is_cuda:
                grads = deform_conv2d_columns_backward(
                    x, offsets, mask, weight, grad, *ctx.conv, wanted=wanted)
            else:
                grads = _recompute_backward(x, offsets, mask, weight, grad,
                                            ctx.conv, wanted)
        return (*grads, None, None, None, None, None)
