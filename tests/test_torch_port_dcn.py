"""The port's deformable convolution (paa_tpu_torch/ops/dcn.py) against
the JAX package's (paa_tpu/ops/dcn.py), on the CPU, float32.

- ``deform_conv2d`` on every case of tests/test_dcn_cuda_parity.py
  (fractional offsets, v1, stride 2 with pad 2 and dilation 2, pad 0,
  deformable groups, groups x deformable groups, offsets x8 out of
  bounds, kernel 5, batch 3, ResNeXt-shaped groups), built from the
  same numpy seeds, against ``mode="gather"`` on all and ``mode="auto"``
  on a few, within rtol = atol = 2e-4 as there; a few also against
  that file's loop transcription of the reference CUDA kernel.
- The gradients of x, offsets, mask and weight of one scalar loss
  against ``jax.grad`` of the same loss, within 1e-4 of each gradient's
  largest magnitude (offsets kept off the integer grid, where bilinear
  sampling has kinks).
- The bfloat16 forward against the float32 one on the same inputs:
  within ``BF16_REL`` of the float32 output's largest magnitude.
- ``DeformConv`` filled from flax's ``DeformConv`` params through
  ``load_jax_params`` gives flax's output, with the offset conv drawn
  from a seed (at its zero init the layer is a conv with mask 0.5).
- What surrounds K4 (ops/deform_sampling.py) in Python: its plain
  version's columns against those ``deform_conv2d`` contracts, the
  columns path against ``deform_conv2d``, the chunk count, the launch
  plan, the layouts the wrapper refuses, and the custom op under
  opcheck, in an export and in a serving artifact loaded without the
  model code.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.ops import dcn as jdcn
from paa_tpu_torch.ops import dcn, deform_sampling
from paa_tpu_torch.serving import save_exported
from paa_tpu_torch.utils import load_jax_params
from test_dcn_cuda_parity import ref_deform_conv_nchw

# bfloat16 against float32: x, the weight, the corner weights and the
# sampled columns each round to bf16 (2^-9 relative), the contraction
# accumulates in float32 and the output rounds once more; over the
# K * C/groups terms of an output that is a few 1e-3 of the largest
# output. chip_smoke.py's dcn_card_vs_cpu holds the card to this bound.
BF16_REL = 1.5e-2

# (seed, keyword arguments) of tests/test_dcn_cuda_parity.py's cases
CASES = {
    "v2_fractional_offsets": (0, {}),
    "v1_no_mask": (1, dict(modulated=False)),
    "stride2_pad2_dil2": (2, dict(H=9, W=10, stride=2, pad=2, dil=2)),
    "stride2_pad0": (3, dict(H=8, W=8, pad=0, stride=2)),
    "deformable_groups": (4, dict(C=8, O=6, dg=2)),
    "groups_and_deformable_groups": (5, dict(C=8, O=8, groups=2, dg=2)),
    "groups4_dg4": (6, dict(C=16, O=16, groups=4, dg=4, B=2)),
    "large_out_of_bounds_offsets": (7, dict(offset_scale=8.0)),
    "kernel5": (8, dict(ksize=5, pad=2, H=8, W=8)),
    "batch3": (9, dict(B=3)),
    "resnext_shaped_groups": (13, dict(C=32, O=32, groups=8, dg=1, H=20,
                                       W=24, offset_scale=0.5)),
}


def make_case(seed, B=1, C=4, H=6, W=7, O=4, ksize=3, stride=1, pad=1,
              dil=1, groups=1, dg=1, modulated=True, offset_scale=2.0):
    """tests/test_dcn_cuda_parity.py's run_both inputs, float64 NCHW."""
    rng = np.random.RandomState(seed)
    k = ksize * ksize
    ho = (H + 2 * pad - (dil * (ksize - 1) + 1)) // stride + 1
    wo = (W + 2 * pad - (dil * (ksize - 1) + 1)) // stride + 1
    x = rng.normal(0, 1, (B, C, H, W))
    offsets = rng.normal(0, offset_scale, (B, dg * 2 * k, ho, wo))
    mask = rng.uniform(0.1, 1.0, (B, dg * k, ho, wo)) if modulated else None
    weight = rng.normal(0, 0.2, (O, C // groups, ksize, ksize))
    conv = dict(stride=stride, pad=pad, dil=dil, groups=groups, dg=dg)
    return (x, offsets, mask, weight), conv


def _t(a, dtype=torch.float32):
    return None if a is None else torch.tensor(a, dtype=dtype)


def _j(a):
    """NCHW numpy -> NHWC float32 jax array."""
    return None if a is None else jnp.asarray(np.transpose(a, (0, 2, 3, 1)),
                                              jnp.float32)


def port_forward(inputs, conv, dtype=torch.float32):
    x, offsets, mask, weight = inputs
    return dcn.deform_conv2d(
        _t(x, dtype), _t(offsets), _t(mask), _t(weight, dtype),
        conv["stride"], conv["pad"], conv["dil"], conv["groups"],
        conv["dg"])


def jax_forward(inputs, conv, mode):
    x, offsets, mask, weight = inputs
    out = jdcn.deform_conv2d(
        _j(x), _j(offsets), _j(mask),
        jnp.asarray(np.transpose(weight, (2, 3, 1, 0)), jnp.float32),
        strides=conv["stride"], padding=conv["pad"],
        dilation=conv["dil"], groups=conv["groups"],
        deformable_groups=conv["dg"], mode=mode)
    return np.transpose(np.asarray(out), (0, 3, 1, 2))


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_gather(case):
    seed, kwargs = CASES[case]
    inputs, conv = make_case(seed, **kwargs)
    got = port_forward(inputs, conv).numpy()
    np.testing.assert_allclose(got, jax_forward(inputs, conv, "gather"),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", ["v2_fractional_offsets",
                                  "large_out_of_bounds_offsets",
                                  "resnext_shaped_groups"])
def test_matches_jax_auto(case):
    """``auto`` (one-hot windows, gather where a sample escapes them)
    computes the same function."""
    seed, kwargs = CASES[case]
    inputs, conv = make_case(seed, **kwargs)
    got = port_forward(inputs, conv).numpy()
    np.testing.assert_allclose(got, jax_forward(inputs, conv, "auto"),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", ["v2_fractional_offsets", "v1_no_mask",
                                  "stride2_pad2_dil2",
                                  "groups4_dg4",
                                  "large_out_of_bounds_offsets"])
def test_matches_reference_loops(case):
    seed, kwargs = CASES[case]
    inputs, conv = make_case(seed, **kwargs)
    want = ref_deform_conv_nchw(*inputs, conv["stride"], conv["pad"],
                                conv["dil"], conv["groups"], conv["dg"])
    np.testing.assert_allclose(port_forward(inputs, conv).numpy(), want,
                               rtol=2e-4, atol=2e-4)


def test_offsets_shape_is_checked():
    inputs, conv = make_case(0)
    x, offsets, mask, weight = inputs
    with pytest.raises(ValueError, match="offsets"):
        dcn.deform_conv2d(_t(x), _t(offsets[:, :-2]), _t(mask), _t(weight))


@pytest.mark.parametrize("case,kwargs", [
    ("modulated_groups_dg", dict(C=8, O=8, groups=2, dg=2, stride=1)),
    ("strided_v1", dict(C=4, O=6, groups=1, dg=1, stride=2, modulated=False)),
])
def test_gradients_match_jax(case, kwargs):
    rng = np.random.RandomState(11)
    B, H, W, ks = 2, 7, 8, 3
    C, O, groups, dg = kwargs["C"], kwargs["O"], kwargs["groups"], kwargs["dg"]
    stride, modulated = kwargs["stride"], kwargs.get("modulated", True)
    k = ks * ks
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.normal(0, 1, (B, C, H, W))
    # off the integer grid: bilinear sampling has kinks there
    offsets = (rng.uniform(0.1, 0.9, (B, dg * k * 2, ho, wo))
               + rng.randint(-2, 2, (B, dg * k * 2, ho, wo)))
    mask = rng.uniform(0.1, 1.0, (B, dg * k, ho, wo)) if modulated else None
    weight = rng.normal(0, 0.2, (O, C // groups, ks, ks))
    r = rng.normal(0, 1, (B, O, ho, wo))

    def jloss(xx, oo, mm, ww):
        out = jdcn.deform_conv2d(xx, oo, mm, ww, strides=stride, padding=1,
                                 groups=groups, deformable_groups=dg,
                                 mode="gather")
        return jnp.sum(out * _j(r))

    argnums = (0, 1, 2, 3) if modulated else (0, 1, 3)
    want = jax.grad(jloss, argnums)(
        _j(x), _j(offsets), _j(mask),
        jnp.asarray(np.transpose(weight, (2, 3, 1, 0)), jnp.float32))
    want = [np.transpose(np.asarray(g), (3, 2, 0, 1)) if i == len(want) - 1
            else np.transpose(np.asarray(g), (0, 3, 1, 2))
            for i, g in enumerate(want)]

    leaves = [_t(a).requires_grad_() for a in (x, offsets, mask, weight)
              if a is not None]
    xt, ot = leaves[0], leaves[1]
    mt = leaves[2] if modulated else None
    wt = leaves[-1]
    out = dcn.deform_conv2d(xt, ot, mt, wt, stride, 1, 1, groups, dg)
    (out * _t(r)).sum().backward()
    for leaf, g in zip(leaves, want):
        got = leaf.grad.numpy()
        assert got.shape == g.shape
        np.testing.assert_allclose(got, g, rtol=0,
                                   atol=1e-4 * np.abs(g).max())


@pytest.mark.parametrize("case", ["v2_fractional_offsets",
                                  "resnext_shaped_groups",
                                  "stride2_pad2_dil2"])
def test_bf16_forward_within_bound(case):
    seed, kwargs = CASES[case]
    inputs, conv = make_case(seed, **kwargs)
    want = port_forward(inputs, conv)
    got = port_forward(inputs, conv, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert err <= BF16_REL, err


def _jax_deform_conv_params(module, x, rng):
    """flax params of ``module`` on NHWC ``x`` with the offset conv drawn
    from ``rng``: fractional offsets of ~1 px, some samples off the
    image, and a non-zero bias."""
    params = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(0),
                                                  x)["params"])
    kernel = params["offset"]["kernel"]
    params["offset"] = {
        "kernel": rng.normal(0, 0.3, kernel.shape).astype(np.float32),
        "bias": rng.normal(0, 1.0, kernel.shape[-1]).astype(np.float32),
    }
    if "bias" in params:
        params["bias"] = rng.normal(0, 0.1, params["bias"].shape).astype(
            np.float32)
    return params


@pytest.mark.parametrize("groups,stride,modulated,bias", [
    (4, 1, True, False), (1, 2, True, False), (1, 1, True, True),
    (2, 1, False, False)])
def test_deform_conv_module_matches_flax(groups, stride, modulated, bias):
    rng = np.random.RandomState(groups * 10 + stride)
    b, h, w, c, o = 2, 9, 11, 16, 8
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    flax_mod = jdcn.DeformConv(features=o, strides=stride, groups=groups,
                               modulated=modulated, use_bias=bias,
                               mode="gather")
    params = _jax_deform_conv_params(flax_mod, jnp.asarray(x), rng)
    want = np.asarray(flax_mod.apply({"params": params}, jnp.asarray(x)))

    port = dcn.DeformConv(c, o, stride=stride, groups=groups,
                          modulated=modulated, bias=bias)
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_deform_conv_init_and_strict_load():
    """The port's DeformConv initialises as the JAX one (zero offset conv,
    kaiming-uniform or normal weight, zero bias) and its import stays
    strict."""
    from paa_tpu_torch.modeling.layers import reset_parameters

    port = dcn.DeformConv(16, 8, groups=4, bias=True, normal_std=0.01)
    reset_parameters(port, torch.Generator().manual_seed(0))
    assert not port.offset.weight.any() and not port.offset.bias.any()
    assert not port.bias.any()
    assert 0.005 < float(port.weight.detach().std()) < 0.02
    backbone = dcn.DeformConv(16, 8, groups=4)
    reset_parameters(backbone, torch.Generator().manual_seed(0))
    bound = np.sqrt(3.0 / (4 * 9))
    assert float(backbone.weight.abs().max()) <= bound
    assert float(backbone.weight.abs().max()) > 0.9 * bound
    params = {"kernel": np.zeros((3, 3, 4, 8), np.float32),
              "offset": {"kernel": np.zeros((3, 3, 16, 27), np.float32)}}
    with pytest.raises(KeyError, match="offset"):
        load_jax_params(backbone, params)


# ---- what surrounds K4 (csrc/deform_im2col.cu) in Python ------------------

def _contracted_columns(monkeypatch, inputs, conv, dtype):
    """The (N, K, C) columns ``deform_conv2d`` hands to ``_contract``."""
    seen = []
    plain = dcn._contract

    def spy(col, weight, groups):
        seen.append(col)
        return plain(col, weight, groups)

    monkeypatch.setattr(dcn, "_contract", spy)
    port_forward(inputs, conv, dtype)
    assert len(seen) == 1
    return seen[0]


def _im2col(inputs, conv, dtype=torch.float32):
    x, offsets, mask, weight = inputs
    k = weight.shape[-1]
    return deform_sampling._im2col_columns(
        _t(x, dtype), _t(offsets), _t(mask), k, k, conv["stride"],
        conv["pad"], conv["dil"], conv["groups"], conv["dg"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_im2col_columns_are_the_contracted_columns(case, dtype,
                                                   monkeypatch):
    """``_im2col_columns`` (K4's plain version) emits, in K4's layout
    (B, groups, Ho*Wo, K*C/groups), exactly the columns that
    ``deform_conv2d`` contracts: same values, taps outer and each conv
    group's channels inner."""
    seed, kwargs = CASES[case]
    inputs, conv = make_case(seed, **kwargs)
    want = _contracted_columns(monkeypatch, inputs, conv, dtype)
    got = _im2col(inputs, conv, dtype)
    b, groups, n, kc = got.shape
    k = inputs[3].shape[-1] ** 2
    assert (b * n, k, groups * kc // k) == tuple(want.shape)
    assert got.dtype == dtype
    regrouped = got.view(b, groups, n, k, kc // k).permute(0, 2, 3, 1, 4)
    assert torch.equal(regrouped.reshape(want.shape), want)


@pytest.mark.parametrize("chunk_bytes", [None, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_columns_path_matches_deform_conv2d(case, chunk_bytes, monkeypatch):
    """``deform_conv2d_columns`` (K4's path; on the CPU through the
    op's plain kernel) against ``deform_conv2d``: the same output within
    1e-5 of its largest magnitude (the product sums in another order),
    in one chunk or in chunks of one image."""
    if chunk_bytes is not None:
        monkeypatch.setattr(dcn, "CHUNK_BYTES", chunk_bytes)
    seed, kwargs = CASES[case]
    inputs, conv = make_case(seed, **kwargs)
    x, offsets, mask, weight = (_t(a) for a in inputs)
    args = (conv["stride"], conv["pad"], conv["dil"], conv["groups"],
            conv["dg"])
    want = dcn.deform_conv2d(x, offsets, mask, weight, *args)
    before = deform_sampling.deform_im2col.launches
    got = dcn.deform_conv2d_columns(x, offsets, mask, weight, *args)
    # CPU: the plain version
    assert deform_sampling.deform_im2col.launches == before
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("per_channel,itemsize,want", [
    (4, 2, 3),  # the plain version's rows at X-152's res3: 619 MB an image
    (1, 2, 8),  # K4's columns there: 155 MB, all 8 images in one chunk
    (1, 4, 6),  # float32 columns, 310 MB an image
    (4, 4, 1),  # over CHUNK_BYTES an image: one image
])
def test_images_per_chunk_counts_rows_or_columns(per_channel, itemsize,
                                                 want):
    """Images per chunk from Ho*Wo*K*C*per_channel values an image under
    CHUNK_BYTES (2 GiB): 4 per channel for the plain version's gathered
    rows, 1 for K4's columns; at least one image, at most the batch."""
    dtype = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    x = torch.empty(8, 512, 1, 1, dtype=dtype)
    if per_channel == 4 and itemsize == 4:
        x = torch.empty(8, 2048, 1, 1, dtype=dtype)
    assert dcn._images_per_chunk(x, 100, 168, 9, per_channel) == want
    if per_channel == 4:  # the default: the plain version's count
        assert dcn._images_per_chunk(x, 100, 168, 9) == want


# (C, groups, deformable groups, itemsize) -> (vec, lanes, rows, tile)
K4_PLANS = {
    "x152_res3": ((512, 32, 1, 2), (8, 8, 32, 28)),
    "x152_res4": ((1024, 32, 1, 2), (8, 16, 16, 14)),
    "x152_res5": ((2048, 32, 1, 2), (8, 256, 1, 7)),
    "tower": ((256, 1, 1, 2), (8, 32, 8, 56)),
    "x101_64x4d_res3": ((512, 64, 1, 2), (8, 4, 64, 28)),
    "float32_res3": ((512, 32, 1, 4), (4, 16, 16, 14)),
    "cg4_dg2": ((16, 4, 2, 2), (4, 2, 128, 85)),
    "cdg8_float32": ((24, 1, 3, 4), (4, 6, 42, 56)),
}


@pytest.mark.parametrize("name", sorted(K4_PLANS))
def test_im2col_plan(name):
    """K4's launch from C, C/groups, C/dg and the itemsize alone: 16-byte
    vectors or fewer, inside one conv group and one deformable group; a
    warp's stores fill 128-byte lines of a conv group's columns (lanes
    x vec x itemsize of a row, over rows); 256 threads at most; a block
    of about 16,384 vectors whose samples fit 48 KB of shared memory."""
    (c, groups, dg, itemsize), want = K4_PLANS[name]
    plan = deform_sampling.im2col_plan(c, c // groups, c // dg, 9, dg,
                                       itemsize)
    assert (plan.vec, plan.lanes, plan.rows, plan.tile) == want
    assert (c // groups) % plan.vec == 0 and (c // dg) % plan.vec == 0
    assert plan.vec * itemsize <= 16
    assert plan.lanes * plan.rows <= 256
    assert plan.tile * 9 * dg * 32 <= 48 * 1024


def _k4_case():
    inputs, conv = make_case(5, C=8, O=8, groups=2, dg=2)
    return [_t(a) for a in inputs[:3]]


@pytest.mark.parametrize("bad,error,match", [
    ("groups", ValueError, "channels in 3 groups"),
    ("deformable_groups", ValueError, "deformable groups"),
    ("float64", TypeError, "float64"),
    ("int32", TypeError, "int32"),
    ("offsets_shape", ValueError, "offsets"),
    ("mask_shape", ValueError, "mask"),
    ("offsets_device", ValueError, "offsets on meta"),
    ("three_dims", ValueError, "shape"),
    ("taps", ValueError, "shared memory"),
])
def test_deform_im2col_refuses_what_k4_cannot_take(bad, error, match):
    """The wrapper raises, on either device, on a layout K4 does not
    take: channels that the groups or deformable groups do not divide, a
    dtype without a kernel path, offsets or a mask of another shape or
    device, a tensor of other than 4 dims, more samples a position than
    a block's shared memory holds. The columns' op is not called."""
    x, offsets, mask = _k4_case()
    kw = dict(groups=2, deformable_groups=2)
    k = 3
    if bad == "groups":
        kw["groups"] = 3
    elif bad == "deformable_groups":
        kw["deformable_groups"] = 3
    elif bad in ("float64", "int32"):
        x = x.to(getattr(torch, bad))
    elif bad == "offsets_shape":
        offsets = offsets[:, :-2]
    elif bad == "mask_shape":
        mask = mask[:, :-1]
    elif bad == "offsets_device":
        offsets = offsets.to("meta")
    elif bad == "three_dims":
        x = x[0]
    elif bad == "taps":  # 81 taps x 20 deformable groups x 32 B > 48 KB
        k, kw["groups"], kw["deformable_groups"] = 9, 1, 20
        x = torch.zeros(1, 20, 12, 12)
        offsets = torch.zeros(1, 20 * 81 * 2, 4, 4)
        mask = None
    with pytest.raises(error, match=match):
        deform_sampling.deform_im2col(x, offsets, mask, k, k, 1,
                                      0 if k == 9 else 1, 1, **kw)


def test_deform_im2col_op_exports_through_its_fake():
    """``paa_tpu_torch::deform_im2col`` passes torch.library's op checks
    (schema, fake against the real kernel), and a module on the columns
    path exports with it as one node whose output equals the live
    module's."""
    x, offsets, mask = _k4_case()
    torch.library.opcheck(torch.ops.paa_tpu_torch.deform_im2col.default,
                          (x, offsets, mask, 3, 3, 1, 1, 1, 2, 2))
    torch.library.opcheck(torch.ops.paa_tpu_torch.deform_im2col.default,
                          (x, offsets, None, 3, 3, 1, 1, 1, 2, 2))
    weight = torch.randn(8, 4, 3, 3, generator=torch.Generator()
                         .manual_seed(0))

    class Columns(torch.nn.Module):
        def forward(self, x, offsets, mask):
            return dcn.deform_conv2d_columns(x, offsets, mask, weight, 1, 1,
                                             1, 2, 2)

    exported = torch.export.export(Columns(), (x, offsets, mask))
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count("paa_tpu_torch.deform_im2col.default") == 1
    torch.testing.assert_close(exported.module()(x, offsets, mask),
                               Columns()(x, offsets, mask), rtol=0, atol=0)


# (C, groups, deformable groups, stride, itemsize) -> (vec, lanes, rows,
# tile_h, tile_w, red)
K5_PLANS = {
    "x152_res3": ((512, 32, 1, 1, 2), (8, 8, 32, 4, 16, 8)),
    "x152_res3_stride2": ((512, 32, 1, 2, 2), (8, 8, 32, 4, 16, 8)),
    "x152_res4": ((1024, 32, 1, 1, 2), (8, 16, 16, 4, 16, 16)),
    "x152_res5": ((2048, 32, 1, 1, 2), (8, 32, 8, 4, 16, 32)),
    "tower": ((256, 1, 1, 1, 2), (8, 32, 8, 4, 16, 32)),
    "x101_64x4d_res3": ((512, 64, 1, 1, 2), (8, 4, 64, 4, 16, 4)),
    "float32_res3": ((512, 32, 1, 1, 4), (4, 16, 16, 4, 16, 16)),
    "cg4_dg2": ((16, 4, 2, 1, 2), (4, 2, 128, 2, 16, 2)),
    "cdg8_float32": ((24, 1, 3, 1, 4), (4, 6, 42, 1, 16, 1)),
}


@pytest.mark.parametrize("name", sorted(K5_PLANS))
def test_col2im_plan(name):
    """K5's launch from C, C/groups, C/dg, the kernel, stride and
    dilation and the itemsize alone: 16-byte vectors of x and dcol or
    fewer, inside one conv group and one deformable group; a warp's
    reads fill 128-byte lines of a conv group's dcol (lanes x vec x
    itemsize of a row, over rows, as K4's stores), 32 lanes at most; 256
    threads at most; a tile's samples, their sums and their corners'
    entries in 48 KB, the window's bins in BINS_BYTES; sums by shuffles
    over a power of two of lanes inside one deformable group."""
    (c, groups, dg, stride, itemsize), want = K5_PLANS[name]
    cg, cdg = c // groups, c // dg
    plan = deform_sampling.col2im_plan(c, cg, cdg, 3, 3, stride, 1, dg,
                                       itemsize)
    assert (plan.vec, plan.lanes, plan.rows, plan.tile_h, plan.tile_w,
            plan.red) == want
    assert cg % plan.vec == 0 and cdg % plan.vec == 0
    assert plan.vec * itemsize <= 16
    span = max(1, 128 // (cg * itemsize))
    assert plan.lanes == min(c // plan.vec, 32 // span)
    assert plan.lanes * plan.rows <= 256
    cap = plan.tile_h * plan.tile_w * 9 * dg
    assert cap * 76 <= 48 * 1024
    window = deform_sampling._window_size
    bins = dg * (window(plan.tile_h, 3, stride, 1, plan.margin)
                 * window(plan.tile_w, 3, stride, 1, plan.margin))
    assert plan.smem == cap * 76 + (2 * bins + 1) * 4
    assert (2 * bins + 1) * 4 <= deform_sampling.BINS_BYTES
    assert plan.lanes % plan.red == 0 and (cdg // plan.vec) % plan.red == 0
    assert plan.red & (plan.red - 1) == 0


def test_col2im_plan_refuses_a_window_past_its_bins():
    """A dilation whose window has more bins than BINS_BYTES hold is
    refused, by shape; dilation 2, the largest the tests' convs take,
    fits."""
    with pytest.raises(ValueError, match="window"):
        deform_sampling.col2im_plan(256, 256, 256, 3, 3, 1, 40, 1, 2)
    assert deform_sampling.col2im_plan(256, 256, 256, 3, 3, 2, 2, 1, 2)


@pytest.mark.parametrize("bad,error,match", [
    ("dcol_dtype", TypeError, "dcol of torch.bfloat16"),
    ("dcol_shape", ValueError, "dcol"),
    ("dcol_device", ValueError, "dcol on meta"),
    ("float64", TypeError, "float64"),
    ("groups", ValueError, "channels in 3 groups"),
    ("taps", ValueError, "shared memory"),
    ("window", ValueError, "window"),
])
def test_deform_col2im_refuses_what_k5_cannot_take(bad, error, match):
    """The wrapper raises, on either device, on a layout K5 does not
    take: a columns' gradient of another dtype, shape or device than
    K4's columns, a dilation whose window its bins cannot hold, and what
    K4 refuses. The gradients' op is not called."""
    x, offsets, mask = _k4_case()
    dcol = deform_sampling.deform_im2col(x, offsets, mask, 3, 3, 1, 1, 1, 2,
                                         2)
    kw = dict(groups=2, deformable_groups=2)
    k, conv = 3, [1, 1, 1]  # stride, padding, dilation
    if bad == "dcol_dtype":
        dcol = dcol.bfloat16()
    elif bad == "dcol_shape":
        dcol = dcol[:, :, 1:]
    elif bad == "dcol_device":
        dcol = dcol.to("meta")
    elif bad == "float64":
        x, dcol = x.double(), dcol.double()
    elif bad == "groups":
        kw["groups"] = 3
    elif bad == "taps":  # 81 taps x 20 deformable groups of samples
        k, kw["groups"], kw["deformable_groups"] = 9, 1, 20
        x = torch.zeros(1, 20, 12, 12)
        offsets = torch.zeros(1, 20 * 81 * 2, 4, 4)
        dcol = torch.zeros(1, 1, 16, 81 * 20)
        mask = None
        conv[1] = 0
    elif bad == "window":  # dilation 40: a window past BINS_BYTES
        conv[1:] = 40, 40
    with pytest.raises(error, match=match):
        deform_sampling.deform_col2im(x, offsets, mask, dcol, k, k, *conv,
                                      **kw)


def test_deform_col2im_op_exports_through_its_fake():
    """``paa_tpu_torch::deform_col2im`` passes torch.library's op checks
    (schema, fake against the real kernel: dx float32 channels-last, the
    offsets' and the mask's gradients float32, the mask's empty for a v1
    conv), and a module that calls it exports with it as one node whose
    outputs equal the live module's; on the CPU it launches nothing."""
    x, offsets, mask = _k4_case()
    dcol = torch.randn(1, 2, 42, 36, generator=torch.Generator()
                       .manual_seed(2))
    op = torch.ops.paa_tpu_torch.deform_col2im.default
    torch.library.opcheck(op, (x, offsets, mask, dcol, 3, 3, 1, 1, 1, 2, 2))
    torch.library.opcheck(op, (x, offsets, None, dcol, 3, 3, 1, 1, 1, 2, 2))
    got = deform_sampling.deform_col2im(x, offsets, None, dcol, 3, 3, 1, 1, 1,
                                        2, 2)
    assert got[2] is None

    class Gradients(torch.nn.Module):
        def forward(self, x, offsets, mask, dcol):
            return deform_sampling.deform_col2im(x, offsets, mask, dcol, 3,
                                                 3, 1, 1, 1, 2, 2)

    before = deform_sampling.deform_col2im.launches
    exported = torch.export.export(Gradients(), (x, offsets, mask, dcol))
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count("paa_tpu_torch.deform_col2im.default") == 1
    for g, w in zip(exported.module()(x, offsets, mask, dcol),
                    Gradients()(x, offsets, mask, dcol)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert deform_sampling.deform_col2im.launches == before


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a process that serves an artifact with torch and paa_tpu_torch.serving
# alone (tests/test_torch_port_serving.py's SERVE): serving's
# ``from . import ops`` has to register the op
SERVE_COLUMNS = """
import sys, torch
from paa_tpu_torch.serving import load_exported
call, meta = load_exported(sys.argv[1], device="cpu")
x, offset_mask = torch.load(sys.argv[2])
out = call(x, offset_mask)
loaded = sorted(m for m in sys.modules if m.startswith("paa_tpu"))
torch.save({"out": out, "loaded": loaded}, sys.argv[3])
"""


class _ColumnsConv(torch.nn.Module):
    """``deform_conv2d_columns`` of x with the offsets and the mask side
    by side, as ``DeformConv``'s offset conv gives them."""

    def __init__(self, weight):
        super().__init__()
        self.weight = torch.nn.Parameter(weight)

    def forward(self, x, offset_mask):
        n = offset_mask.shape[1] * 2 // 3
        return dcn.deform_conv2d_columns(x, offset_mask[:, :n],
                                         offset_mask[:, n:], self.weight,
                                         1, 1, 1, 2, 2)


def test_deform_im2col_artifact_serves_without_model_code(tmp_path):
    """An artifact that holds ``paa_tpu_torch::deform_im2col``, written
    by ``serving.save_exported``, loads and runs in a process that
    imports only torch and ``paa_tpu_torch.serving``: the live module's
    output, and neither the model code nor ops/dcn.py loaded."""
    x, offsets, mask = _k4_case()
    module = _ColumnsConv(torch.randn(
        8, 4, 3, 3, generator=torch.Generator().manual_seed(1)))
    offset_mask = torch.cat([offsets, mask], dim=1)
    with torch.no_grad():
        exported = torch.export.export(module, (x, offset_mask))
        want = module(x, offset_mask)
    path, inputs, served = (str(tmp_path / f) for f in (
        "columns.paat", "inputs.pt", "served.pt"))
    save_exported(path, exported, {"device": "cpu"})
    torch.save((x, offset_mask), inputs)
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_COLUMNS, path, inputs, served],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = torch.load(served)
    assert not [m for m in got["loaded"] if m.startswith((
        "paa_tpu_torch.modeling", "paa_tpu_torch.config",
        "paa_tpu_torch.data", "paa_tpu_torch.ops.dcn"))]
    torch.testing.assert_close(got["out"], want, rtol=0, atol=0)
