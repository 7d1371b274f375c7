"""The sampling step of a deformable convolution (ops/dcn.py): its plain
PyTorch steps, and K4, the CUDA kernel csrc/deform_im2col.cu that takes
them in one pass on the card.

This module imports no model code (ops/dcn.py does, for ``DeformConv``),
so that ``from paa_tpu_torch import ops`` registers the custom op
``paa_tpu_torch::deform_im2col`` in a process that loads a serving
artifact without the model (serving.py).

The plain steps are the JAX package's "gather" lowering
(paa_tpu/ops/dcn.py):

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
   width), then the corner weighting.

``_sampling`` takes step 1 and builds step 2's table and rows for a
batch; ``deform_conv2d`` samples them by chunks of images, and
``_im2col_columns`` (K4's plain version) all at once.

K4 (``deform_im2col``) computes both steps for CUDA tensors and writes
the columns once, in the layout the product reads (the kernel's header
says how); it is the custom op ``paa_tpu_torch::deform_im2col`` with a
fake, so that ``torch.export`` records it as one node, and its launches
are counted in ``deform_im2col.launches``. CPU tensors take the plain
version through the same op.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from . import _build
from .group_norm import _on


def _out_size(size, k, s, p, d):
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def _coords(offsets, mask, h, w, kh, kw, s, p, d, dg):
    """Every sample's top-left corner y0, x0 (float32 floors), fractions
    wy, wx and centre gate (1.0 where -1 < y < H and -1 < x < W, else
    0.0), each (B, Ho, Wo, K, dg) float32, and the mask in that layout
    (float32, or None)."""
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
    gate = ((ys > -1) & (ys < h) & (xs > -1) & (xs < w)).to(f32)
    m = (None if mask is None else
         mask.to(f32).view(b, dg, k, ho, wo).permute(0, 3, 4, 2, 1))
    return y0, x0, ys - y0, xs - x0, gate, m


def _padded_corner(y0, x0, h, w):
    """The top-left corners in the 1-padded frame (int64): 0 is the zero
    row/col above/left of the image, the bottom-right corner is (+1,
    +1)."""
    return y0.clamp(-1, h - 1).long() + 1, x0.clamp(-1, w - 1).long() + 1


def _bilinear(wy, wx):
    """The corner weights (tl, tr, bl, br) stacked last."""
    return torch.stack([(1 - wy) * (1 - wx), (1 - wy) * wx,
                        wy * (1 - wx), wy * wx], dim=-1)


def _geometry(offsets, mask, h, w, kh, kw, s, p, d, dg):
    """Corner rows and weights of every sample.

    offsets: (B, dg*K*2, Ho, Wo); mask: (B, dg*K, Ho, Wo) or None.
    Returns y0p, x0p: (B, Ho, Wo, K, dg) int64, the top-left corner in
    the 1-padded frame (``_padded_corner``), and cw: (B, Ho, Wo, K, dg,
    4) float32 corner weights in the order (tl, tr, bl, br), with the
    gate and the mask folded in."""
    y0, x0, wy, wx, gate, m = _coords(offsets, mask, h, w, kh, kw, s, p, d,
                                      dg)
    y0p, x0p = _padded_corner(y0, x0, h, w)
    cw = _bilinear(wy, wx) * gate[..., None]
    if m is not None:
        cw = cw * m[..., None]
    return y0p, x0p, cw


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


def _sampling(x, offsets, mask, kh, kw, s, p, d, dg):
    """Steps 1-2 up to the gather, for the whole batch: the patch table
    of x, each sample's row in it, rows (B, Ho, Wo, K, dg) int64, and
    its corner weights cw (B, Ho, Wo, K, dg, 4) cast to x's dtype.
    ``_sample_columns(table, rows[i:j].reshape(-1), cw[i:j].reshape(-1,
    4))`` samples images i..j-1 as (N, C/dg) rows, N in (image,
    position, tap, deformable group) order."""
    h, w = x.shape[2:]
    y0p, x0p, cw = _geometry(offsets, mask, h, w, kh, kw, s, p, d, dg)
    table, hp, wp = _patch_table(x, dg)
    return table, _table_rows(y0p, x0p, hp, wp, dg), cw.to(x.dtype)


def _table_rows(y0p, x0p, hp, wp, dg):
    """Each sample's row of the patch table: (B, Ho, Wo, K, dg) int64."""
    b = y0p.shape[0]
    image = torch.arange(b, device=y0p.device).view(b, 1, 1, 1, 1)
    group = torch.arange(dg, device=y0p.device)
    return ((image * hp + y0p) * wp + x0p) * dg + group


# ---- K4: the sampling as one kernel on the card ---------------------------

# the dtype codes of csrc/deform_im2col.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_THREADS = 256  # a block's, as the kernel's __launch_bounds__
# V-channel vectors a block writes, about: 64 a thread, so that the
# block's geometry is a small share of its work (on an H100, X-152's res3
# and res4 ran 3-4 points nearer their bound than at 8,192)
BLOCK_VECTORS = 16384
SAMPLE_BYTES = 32  # a sample's four corner offsets and weights
LINE_BYTES = 128
SMEM_BYTES = 48 * 1024  # shared memory a block takes without opting in


@dataclass(frozen=True)
class Im2colPlan:
    """One launch of K4: ``vec`` channels a vector, blocks of ``lanes``
    x ``rows`` threads, ``tile`` output positions a block (their samples
    in SAMPLE_BYTES each of shared memory)."""

    vec: int
    lanes: int
    rows: int
    tile: int


@functools.lru_cache(maxsize=None)
def im2col_plan(channels, cg, cdg, taps, dg, itemsize):
    """K4's launch for ``channels`` in conv groups of ``cg`` and
    deformable groups of ``cdg``, ``taps`` kernel taps, ``dg``
    deformable groups, ``itemsize`` bytes a value. A vector is 16 bytes
    or fewer, so that it lies inside one conv group's columns and one
    deformable group's sample; a block's lanes take a sample's vectors
    (256 at most), its rows further (position, tap) rows."""
    vec = 16 // itemsize
    while cg % vec or cdg % vec:
        vec //= 2
    vectors = channels // vec
    # a warp spans this many rows, so that each conv group's share of its
    # stores fills 128-byte lines (a row holds cg values of each group)
    span = max(1, LINE_BYTES // (cg * itemsize))
    lanes = min(vectors, MAX_THREADS if span == 1 else max(1, 32 // span))
    rows = MAX_THREADS // lanes
    fits = SMEM_BYTES // (taps * dg * SAMPLE_BYTES)
    if fits < 1:
        raise ValueError(f"deform_im2col kernel: {taps} taps x {dg} "
                         "deformable groups of samples exceed a block's "
                         "shared memory")
    tile = max(1, min(fits, BLOCK_VECTORS // (taps * vectors)))
    return Im2colPlan(vec=vec, lanes=lanes, rows=rows, tile=tile)


@functools.cache
def _lib():
    lib = _build.load("deform_im2col")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.paa_deform_im2col.argtypes = (
        [vp] * 4 + [ci] * 15 + [ctypes.c_longlong] * 2 + [ci] * 3 + [vp])
    lib.paa_deform_im2col.restype = ci
    return lib


def _check_im2col(x, offsets, mask, kh, kw, stride, padding, dilation,
                  groups, dg):
    """Raises on a layer K4 does not take."""
    if x.dim() != 4:
        raise ValueError(f"deform_im2col: x of shape {tuple(x.shape)}")
    b, c, h, w = x.shape
    if c % groups or c % dg:
        raise ValueError(f"deform_im2col: {c} channels in {groups} groups "
                         f"and {dg} deformable groups")
    if x.dtype not in _DTYPES:
        raise TypeError(f"deform_im2col: no {x.dtype} path")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"deform_im2col: no kernel for {x.device}")
    k = kh * kw
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    for name, t, ch in (("offsets", offsets, dg * k * 2),
                        ("mask", mask, dg * k)):
        if t is None:
            continue
        if t.shape != (b, ch, ho, wo):
            raise ValueError(f"{name} {tuple(t.shape)}, expected "
                             f"{(b, ch, ho, wo)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if h * w * c >= 2 ** 31 or dg * k * 2 * ho * wo >= 2 ** 31:
        raise ValueError(f"deform_im2col: {h * w * c} values an image")
    im2col_plan(c, c // groups, c // dg, k, dg, x.element_size())


def _im2col_columns(x, offsets, mask, kh, kw, stride=1, padding=1,
                    dilation=1, groups=1, deformable_groups=1):
    """K4's plain version: the columns ``deform_conv2d`` contracts, by
    its own steps (``_sampling``, the corner weighting in x's dtype), in
    K4's layout (B, groups, Ho*Wo, kh*kw*C/groups): for each image and
    conv group, a row per output position holding every tap's C/groups
    channels."""
    b, c, h, w = x.shape
    k = kh * kw
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    table, rows, cw = _sampling(x, offsets, mask, kh, kw, stride, padding,
                                dilation, deformable_groups)
    col = _sample_columns(table, rows.reshape(-1), cw.reshape(-1, 4))
    cg = c // groups
    return (col.view(b, ho * wo, k, groups, cg).permute(0, 3, 1, 2, 4)
            .reshape(b, groups, ho * wo, k * cg))


def _planes(t):
    """Offsets or a mask in float32 as _geometry reads them, each image's
    planes contiguous (an offset conv's output sliced by channel is
    already)."""
    t = t.to(torch.float32)
    return t if t[:1].is_contiguous() else t.contiguous()


def _channels_last(x, vec):
    """x channels-last (as it is, if it already is), its address a
    multiple of ``vec`` elements."""
    x = x.contiguous(memory_format=torch.channels_last)
    if x.data_ptr() % (vec * x.element_size()):
        x = x.clone(memory_format=torch.channels_last)
    return x


def _deform_im2col_cuda(x, offsets, mask, kh, kw, stride, padding,
                        dilation, groups, dg):
    b, c, h, w = x.shape
    k = kh * kw
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    plan = im2col_plan(c, c // groups, c // dg, k, dg, x.element_size())
    col = torch.empty((b, groups, ho * wo, k * (c // groups)),
                      dtype=x.dtype, device=x.device)
    if col.numel() == 0:
        return col

    offsets, mask = (None if t is None else _planes(t)
                     for t in (offsets, mask))
    with _on(x.device):
        x = _channels_last(x, plan.vec)
        err = _lib().paa_deform_im2col(
            x.data_ptr(), offsets.data_ptr(),
            None if mask is None else mask.data_ptr(), col.data_ptr(),
            _DTYPES[x.dtype], plan.vec, b, h, w, c, ho, wo, kh, kw, stride,
            padding, dilation, c // groups, dg, offsets.stride(0),
            0 if mask is None else mask.stride(0), plan.tile, plan.lanes,
            plan.rows, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"deform_im2col kernel launch failed: CUDA error {err}")
    deform_im2col.launches += 1
    return col


def _deform_im2col_impl(x, offsets, mask, kh, kw, stride, padding,
                        dilation, groups, deformable_groups):
    """``paa_tpu_torch::deform_im2col`` on either device."""
    fn = _im2col_columns if x.device.type == "cpu" else _deform_im2col_cuda
    return fn(x, offsets, mask, kh, kw, stride, padding, dilation, groups,
              deformable_groups)


@torch.library.custom_op("paa_tpu_torch::deform_im2col", mutates_args=(),
                         device_types="cpu")
def _deform_im2col_op(x: torch.Tensor, offsets: torch.Tensor,
                      mask: Optional[torch.Tensor], kh: int, kw: int,
                      stride: int, padding: int, dilation: int, groups: int,
                      deformable_groups: int) -> torch.Tensor:
    return _deform_im2col_impl(x, offsets, mask, kh, kw, stride, padding,
                               dilation, groups, deformable_groups)


_deform_im2col_op.register_kernel("cuda")(_deform_im2col_impl)


@_deform_im2col_op.register_fake
def _(x, offsets, mask, kh, kw, stride, padding, dilation, groups,
      deformable_groups):
    b, c, h, w = x.shape
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    return x.new_empty((b, groups, ho * wo, kh * kw * (c // groups)))


def deform_im2col(x, offsets, mask, kh, kw, stride=1, padding=1,
                  dilation=1, groups=1, deformable_groups=1):
    """The columns of a deformable conv (arguments as ``deform_conv2d``'s,
    the kernel's size for its weight): (B, groups, Ho*Wo, kh*kw*C/groups)
    in x's dtype (float32 or bfloat16), the sampled values of
    every tap for each image, conv group and output position.

    CPU tensors take the plain version (``_im2col_columns``); CUDA
    tensors launch K4 (csrc/deform_im2col.cu, counted in
    ``deform_im2col.launches``) on x made channels-last, or raise,
    through the custom op ``paa_tpu_torch::deform_im2col``. K4
    interpolates in float32 and rounds each column value once; the plain
    version rounds the corner weights and products to x's dtype first,
    as ``deform_conv2d`` does. Raises on a layout K4 does not take, on
    either device."""
    _check_im2col(x, offsets, mask, kh, kw, stride, padding, dilation,
                  groups, deformable_groups)
    return _deform_im2col_op(x, offsets, mask, int(kh), int(kw),
                             int(stride), int(padding), int(dilation),
                             int(groups), int(deformable_groups))


deform_im2col.launches = 0


# ---- K5: the sampling's gradient as one kernel on the card ----------------

def _col2im_grads(x, offsets, mask, dcol, kh, kw, stride=1, padding=1,
                  dilation=1, groups=1, deformable_groups=1):
    """K5's plain version: the gradients of ``_im2col_columns``'s columns
    with respect to x, the offsets and the mask, given the columns'
    gradient ``dcol`` (B, groups, Ho*Wo, kh*kw*C/groups), by explicit
    formulas on ``_coords``'s samples (not autograd). With d a channel's
    dcol, a_q its four corners (tl, tr, bl, br) and cw_q their bilinear
    weights (``_bilinear``): dx[corner q] += d * (cw_q * gate) * mask;
    d dy = gate * mask * sum d * ((1 - wx)(a_bl - a_tl) + wx (a_br -
    a_tr)); d dx = gate * mask * sum d * ((1 - wy)(a_tr - a_tl) + wy
    (a_br - a_bl)); d mask = gate * sum d * sum_q cw_q a_q; the sums over
    the deformable group's channels. Corners on the zero ring take no
    gradient. Computed in float32 (float64 for a float64 x). Returns
    (dx (B, C, H, W) in x's dtype, d offsets (B, dg*K*2, Ho, Wo) and d
    mask (B, dg*K, Ho, Wo), or None for a v1 conv, in float32; all
    contiguous)."""
    b, c, h, w = x.shape
    k, dg = kh * kw, deformable_groups
    cg, cdg = c // groups, c // dg
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    acc = torch.promote_types(x.dtype, torch.float32)
    y0, x0, wy, wx, gate, m = _coords(offsets, mask, h, w, kh, kw, stride,
                                      padding, dilation, dg)
    y0p, x0p = _padded_corner(y0, x0, h, w)
    table, hp, wp = _patch_table(x.to(acc), dg)
    rows = _table_rows(y0p, x0p, hp, wp, dg).reshape(-1)
    corners = table.index_select(0, rows).view(b, ho, wo, k, dg, 4, cdg)
    d = (dcol.to(acc).view(b, groups, ho, wo, k, cg)
         .permute(0, 2, 3, 4, 1, 5).reshape(b, ho, wo, k, dg, cdg))
    wy, wx, gate = (t.to(acc) for t in (wy, wx, gate))
    m = torch.ones_like(gate) if m is None else m.to(acc)
    cw = _bilinear(wy, wx)
    # dcol against each corner, summed over the group's channels
    pq = (corners * d[..., None, :]).sum(-1)
    tl, tr, bl, br = pq.unbind(-1)
    gm = gate * m
    ddy = gm * ((1 - wx) * (bl - tl) + wx * (br - tr))
    ddx = gm * ((1 - wy) * (tr - tl) + wy * (br - bl))
    doffsets = (torch.stack([ddy, ddx], dim=-1).permute(0, 4, 3, 5, 1, 2)
                .reshape(b, dg * k * 2, ho, wo).contiguous())
    dmask = None
    if mask is not None:
        dmask = ((gate * (cw * pq).sum(-1)).permute(0, 4, 3, 1, 2)
                 .reshape(b, dg * k, ho, wo).contiguous())
    # dx: each corner's share of dcol into the patch table's rows, then
    # the table's four corners back onto the 1-padded frame
    weights = (cw * gate[..., None]) * m[..., None]
    rows_grad = torch.zeros(b * hp * wp * dg, 4, cdg, dtype=acc,
                            device=x.device)
    rows_grad.index_add_(0, rows, (weights[..., None] * d[..., None, :])
                         .reshape(-1, 4, cdg))
    q = rows_grad.view(b, hp, wp, dg, 4, cdg)
    padded = torch.zeros(b, h + 2, w + 2, dg, cdg, dtype=acc,
                         device=x.device)
    padded[:, :-1, :-1] += q[..., 0, :]
    padded[:, :-1, 1:] += q[..., 1, :]
    padded[:, 1:, :-1] += q[..., 2, :]
    padded[:, 1:, 1:] += q[..., 3, :]
    dx = (padded[:, 1:-1, 1:-1].reshape(b, h, w, c).permute(0, 3, 1, 2)
          .to(x.dtype).contiguous())
    return dx, doffsets, dmask


# K5's tile of output positions a block (rows, columns), and the
# window's pixels beyond the taps' reach on each side (X-152's offsets
# are 1-3 px; corners beyond go to device memory directly)
COL2IM_TILE = (4, 16)
COL2IM_MARGIN = 3
# a sample's shared memory: its geometry (32), its three sums (12) and
# its four corners' entries (8 each)
COL2IM_SAMPLE_BYTES = 32 + 12 + 4 * 8
# a window's bins (a start and a cursor each), at most
BINS_BYTES = 16 * 1024


def _window_size(n, k, stride, dilation, margin):
    """Rows (or columns) of the pixels a tile of ``n`` output positions
    can read, ``margin`` beyond the taps' reach on each side (the
    kernel's ``window_size``)."""
    return (n - 1) * stride + (k - 1) * dilation + 2 * margin + 1


@dataclass(frozen=True)
class Col2imPlan:
    """One launch of K5: ``vec`` channels a vector, blocks of ``lanes`` x
    ``rows`` threads over tiles of ``tile_h`` x ``tile_w`` output
    positions and their window (``margin`` pixels beyond the taps' reach
    on each side), sums over ``red`` lanes by shuffles, ``smem`` bytes of
    shared memory a block."""

    vec: int
    lanes: int
    rows: int
    tile_h: int
    tile_w: int
    margin: int
    red: int
    smem: int


@functools.lru_cache(maxsize=None)
def col2im_plan(channels, cg, cdg, kh, kw, stride, dilation, dg, itemsize):
    """K5's launch for ``channels`` in conv groups of ``cg`` and
    deformable groups of ``cdg``, a ``kh`` x ``kw`` kernel at ``stride``
    and ``dilation``, ``dg`` deformable groups, ``itemsize`` bytes a
    value. A vector is 16 bytes of x and dcol or fewer, inside one conv
    group and one deformable group; a warp's lanes take a row's vectors,
    spanning as many rows as fill 128-byte lines of a conv group's dcol,
    as K4's stores do; a tile's samples (COL2IM_SAMPLE_BYTES each) fit
    48 KB. Raises where the window's bins (one a pixel and deformable
    group) exceed BINS_BYTES."""
    k = kh * kw
    vec = 16 // itemsize
    while cg % vec or cdg % vec:
        vec //= 2
    span = max(1, LINE_BYTES // (cg * itemsize))
    lanes = max(1, min(channels // vec, 32 // span))
    positions = SMEM_BYTES // (k * dg * COL2IM_SAMPLE_BYTES)
    if positions < 1:
        raise ValueError(f"deform_col2im kernel: {k} taps x {dg} deformable "
                         "groups of samples exceed a block's shared memory")
    tile_w = min(COL2IM_TILE[1], positions)
    tile_h = min(COL2IM_TILE[0], positions // tile_w)
    margin = COL2IM_MARGIN
    bins = dg * (_window_size(tile_h, kh, stride, dilation, margin)
                 * _window_size(tile_w, kw, stride, dilation, margin))
    if (2 * bins + 1) * 4 > BINS_BYTES:
        raise ValueError(f"deform_col2im kernel: a window of {bins} pixels "
                         f"x deformable groups (dilation {dilation}) "
                         "exceeds its bins' shared memory")
    red = 1
    if lanes & (lanes - 1) == 0:  # a power of two: rows align to warps
        red = lanes
        while (cdg // vec) % red:
            red //= 2
    cap = tile_h * tile_w * k * dg
    smem = cap * COL2IM_SAMPLE_BYTES + (2 * bins + 1) * 4
    return Col2imPlan(vec=vec, lanes=lanes, rows=MAX_THREADS // lanes,
                      tile_h=tile_h, tile_w=tile_w, margin=margin, red=red,
                      smem=smem)


@functools.cache
def _col2im_lib():
    lib = _build.load("deform_col2im")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.paa_deform_col2im.argtypes = (
        [vp] * 8 + [ci] * 15 + [ctypes.c_longlong] * 2 + [ci] * 6 + [vp])
    lib.paa_deform_col2im.restype = ci
    return lib


def _check_col2im(x, offsets, mask, dcol, kh, kw, stride, padding,
                  dilation, groups, dg):
    """Raises on a layer K5 does not take: what K4 refuses, and a dcol
    of another shape, dtype or device than K4's columns."""
    _check_im2col(x, offsets, mask, kh, kw, stride, padding, dilation,
                  groups, dg)
    b, c, h, w = x.shape
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    want = (b, groups, ho * wo, kh * kw * (c // groups))
    if dcol.shape != want:
        raise ValueError(f"dcol {tuple(dcol.shape)}, expected {want}")
    if dcol.dtype != x.dtype:
        raise TypeError(f"deform_col2im: dcol of {dcol.dtype}, x of "
                        f"{x.dtype}")
    if dcol.device != x.device:
        raise ValueError(f"dcol on {dcol.device}, x on {x.device}")
    col2im_plan(c, c // groups, c // dg, kh, kw, stride, dilation, dg,
                x.element_size())


def _col2im_outputs(x, mask, ho, wo, k, dg):
    """K5's outputs: dx (B, C, H, W) contiguous in x's dtype; the
    offsets' and the mask's gradients float32, the mask's (B, 0, Ho, Wo)
    for a v1 conv."""
    b, c, h, w = x.shape
    dx = x.new_empty((b, c, h, w))
    doffsets = x.new_empty((b, dg * k * 2, ho, wo), dtype=torch.float32)
    dmask = x.new_empty((b, 0 if mask is None else dg * k, ho, wo),
                        dtype=torch.float32)
    return dx, doffsets, dmask


def _deform_col2im_cuda(x, offsets, mask, dcol, kh, kw, stride, padding,
                        dilation, groups, dg):
    b, c, h, w = x.shape
    k = kh * kw
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    plan = col2im_plan(c, c // groups, c // dg, kh, kw, stride, dilation, dg,
                       x.element_size())
    dx, doffsets, dmask = _col2im_outputs(x, mask, ho, wo, k, dg)
    if doffsets.numel() == 0 or dx.numel() == 0:
        return dx.zero_(), doffsets.zero_(), dmask.zero_()
    # K5's sums of dx, channels-last float32, into dx by its second kernel
    acc = x.new_zeros((b, h, w, c), dtype=torch.float32)
    offsets, mask = (None if t is None else _planes(t)
                     for t in (offsets, mask))
    with _on(x.device):
        x = _channels_last(x, plan.vec)
        dcol = dcol.contiguous()
        if dcol.data_ptr() % (plan.vec * dcol.element_size()):
            dcol = dcol.clone()
        err = _col2im_lib().paa_deform_col2im(
            x.data_ptr(), dcol.data_ptr(), offsets.data_ptr(),
            None if mask is None else mask.data_ptr(), acc.data_ptr(),
            dx.data_ptr(), doffsets.data_ptr(),
            None if mask is None else dmask.data_ptr(),
            _DTYPES[x.dtype], plan.vec, b, h, w, c, ho, wo,
            kh, kw, stride, padding, dilation, c // groups, dg,
            offsets.stride(0), 0 if mask is None else mask.stride(0),
            plan.tile_h, plan.tile_w, plan.margin, plan.lanes, plan.rows,
            plan.red, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"deform_col2im kernel launch failed: CUDA error {err}")
    deform_col2im.launches += 1
    return dx, doffsets, dmask


def _deform_col2im_impl(x, offsets, mask, dcol, kh, kw, stride, padding,
                        dilation, groups, deformable_groups):
    """``paa_tpu_torch::deform_col2im`` on either device."""
    if x.device.type != "cpu":
        return _deform_col2im_cuda(x, offsets, mask, dcol, kh, kw, stride,
                                   padding, dilation, groups,
                                   deformable_groups)
    dx, doffsets, dmask = _col2im_grads(x, offsets, mask, dcol, kh, kw,
                                        stride, padding, dilation, groups,
                                        deformable_groups)
    if dmask is None:
        dmask = doffsets.new_empty((x.shape[0], 0, *doffsets.shape[2:]))
    return dx, doffsets, dmask


@torch.library.custom_op("paa_tpu_torch::deform_col2im", mutates_args=(),
                         device_types="cpu")
def _deform_col2im_op(x: torch.Tensor, offsets: torch.Tensor,
                      mask: Optional[torch.Tensor], dcol: torch.Tensor,
                      kh: int, kw: int, stride: int, padding: int,
                      dilation: int, groups: int, deformable_groups: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _deform_col2im_impl(x, offsets, mask, dcol, kh, kw, stride,
                               padding, dilation, groups, deformable_groups)


_deform_col2im_op.register_kernel("cuda")(_deform_col2im_impl)


@_deform_col2im_op.register_fake
def _(x, offsets, mask, dcol, kh, kw, stride, padding, dilation, groups,
      deformable_groups):
    h, w = x.shape[2:]
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    dx, doffsets, dmask = _col2im_outputs(x, mask, ho, wo, kh * kw,
                                          deformable_groups)
    return dx, doffsets, dmask


def deform_col2im(x, offsets, mask, dcol, kh, kw, stride=1, padding=1,
                  dilation=1, groups=1, deformable_groups=1):
    """The gradients of ``deform_im2col``'s columns with respect to x,
    the offsets and the mask, given the columns' gradient ``dcol`` (K4's
    layout and x's dtype; other arguments as ``deform_im2col``'s):
    (dx (B, C, H, W) contiguous in x's dtype, d offsets float32 (B,
    dg*K*2, Ho, Wo), d mask float32 (B, dg*K, Ho, Wo) or None for a v1
    conv).

    CPU tensors take the plain version (``_col2im_grads``); CUDA tensors
    launch K5 (csrc/deform_col2im.cu, counted in
    ``deform_col2im.launches``) on x made channels-last, or raise,
    through the custom op ``paa_tpu_torch::deform_col2im``. K5 adds in
    float32 with atomics, in no fixed order, and rounds dx once into x's
    dtype. Raises on a layout K5 does not take, on either device."""
    _check_col2im(x, offsets, mask, dcol, kh, kw, stride, padding, dilation,
                  groups, deformable_groups)
    dx, doffsets, dmask = _deform_col2im_op(
        x, offsets, mask, dcol, int(kh), int(kw), int(stride), int(padding),
        int(dilation), int(groups), int(deformable_groups))
    return dx, doffsets, None if mask is None else dmask


deform_col2im.launches = 0
