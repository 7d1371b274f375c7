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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.ops import dcn as jdcn
from paa_tpu_torch.ops import dcn
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
