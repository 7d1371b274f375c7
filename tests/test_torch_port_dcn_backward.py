"""The port's DCN backward that keeps only its inputs
(paa_tpu_torch/ops/dcn.py::DeformConv2dFunction) on the CPU: against
autograd through ``deform_conv2d`` (the plain version) and against
``jax.grad`` of the JAX package's ``deform_conv2d`` in its "auto" mode
(the custom VJP ``sample_auto``, which saves the raw inputs and
recomputes the sampling in its backward) and in its "gather" mode.

Cases: groups with deformable groups, strided and dilated, v1 (no
mask), offsets of up to ~8 px with many samples off the image, and a
batch whose chunks are forced below one image each (``CHUNK_BYTES``
patched), so that the backward recomputes chunk by chunk and sums the
weight's gradient over the chunks.

On the card the Function takes explicit gradients instead
(``deform_conv2d_columns_backward``: the columns' gradient and the
weight's as products, K5 for x, the offsets and the mask); K5's plain
version ``_col2im_grads`` and that route, run here through both ops'
plain versions, are held against autograd through ``deform_conv2d``:
modulated and v1, groups 1 and 4, deformable groups 1 and 2, strided,
dilated, samples off the image and exactly on the integer grid.

Tolerances:
- the forward equals ``deform_conv2d`` bit for bit (it is that call);
- against the plain version, float32 and bfloat16: the gradients of x,
  offsets and mask within 1e-6 of each one's largest magnitude (the
  same operations on the same rows; only the order in which autograd
  and the Function sum a tensor's contributions may differ), the
  weight's within 1e-5 in float32 and 1e-2 in bfloat16 (its gradient
  sums the chunks' in another order, and in bfloat16 each chunk's sum
  is rounded before the chunks are added);
- K5's plain version against autograd, float64 and float32: within
  1e-6 of each gradient's largest magnitude (the geometry is float32 in
  both; the sums' order differs); the card's route against the
  recompute: as the Function's above, and 1e-2 in bfloat16 (it sums the
  sampling's gradient in float32 from bfloat16 columns' gradients, the
  recompute in bfloat16);
- against ``jax.grad``: within 1e-4 of each gradient's largest
  magnitude, as tests/test_torch_port_dcn.py holds the plain version's
  (float32 sums in different orders; offsets kept off the integer grid,
  where bilinear sampling has kinks).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.ops import dcn as jdcn
from paa_tpu_torch.modeling.layers import DeformConv, reset_parameters
from paa_tpu_torch.ops import dcn
from paa_tpu_torch.ops import deform_sampling as ds

# name: (B, C, H, W, O, stride, dilation, groups, dg, modulated, scale)
CASES = {
    "groups_and_deformable_groups": (2, 8, 7, 8, 8, 1, 1, 2, 2, True, 2),
    "strided_dilated": (2, 4, 9, 10, 6, 2, 2, 1, 1, True, 2),
    "v1_no_mask": (2, 4, 7, 8, 4, 1, 1, 1, 1, False, 2),
    "offsets_off_the_image": (2, 4, 6, 7, 4, 1, 1, 1, 1, True, 8),
    "chunks_below_one_batch": (3, 8, 6, 7, 4, 1, 1, 2, 1, True, 2),
}


def make_case(name):
    """float64 numpy NCHW inputs of ``name`` and the conv's arguments.
    The offsets' fractional parts stay in [0.1, 0.9]."""
    b, c, h, w, o, s, d, g, dg, modulated, scale = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    k = 9
    ho = (h + 2 * d - 2 * d - 1) // s + 1
    wo = (w + 2 * d - 2 * d - 1) // s + 1
    x = rng.normal(0, 1, (b, c, h, w))
    offsets = (rng.uniform(0.1, 0.9, (b, dg * k * 2, ho, wo))
               + rng.randint(-scale, scale, (b, dg * k * 2, ho, wo)))
    mask = (rng.uniform(0.1, 1.0, (b, dg * k, ho, wo)) if modulated
            else None)
    weight = rng.normal(0, 0.2, (o, c // g, 3, 3))
    up = rng.normal(0, 1, (b, o, ho, wo))
    return (x, offsets, mask, weight), up, (s, d, d, g, dg)


def _leaves(inputs, dtype):
    """x and weight in ``dtype``, offsets and mask in float32 (as
    ``DeformConv`` passes them), each a fresh leaf."""
    x, offsets, mask, weight = inputs
    return [None if a is None else torch.tensor(
        a, dtype=dtype if i in (0, 3) else torch.float32).requires_grad_()
        for i, a in enumerate((x, offsets, mask, weight))]


def run(fn, inputs, up, conv, dtype=torch.float32):
    ins = _leaves(inputs, dtype)
    out = fn(*ins, *conv)
    out.backward(torch.tensor(up, dtype=dtype))
    return out.detach(), [None if t is None else t.grad for t in ins]


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunks of one image: the case's gathered rows are ~10 KB each."""
    monkeypatch.setattr(dcn, "CHUNK_BYTES", 16 * 1024)


def _close(got, want, share):
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.double(), want.double()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=share * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_plain_autograd(case, dtype, request):
    if case == "chunks_below_one_batch":
        request.getfixturevalue("small_chunks")
        b, c, h, w = CASES[case][:4]
        assert dcn._images_per_chunk(torch.empty(b, c, h, w, dtype=dtype),
                                     h, w, 9) == 1
    inputs, up, conv = make_case(case)
    want_y, want = run(dcn.deform_conv2d, inputs, up, conv, dtype)
    got_y, got = run(dcn.DeformConv2dFunction.apply, inputs, up, conv, dtype)
    assert torch.equal(got_y, want_y)
    for name, g, w in zip(("x", "offsets", "mask", "weight"), got, want):
        if w is None:
            assert g is None
            continue
        share = 1e-6 if name != "weight" else (
            1e-5 if dtype == torch.float32 else 1e-2)
        _close(g, w, share)


@pytest.mark.parametrize("mode", ["auto", "gather"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_function_gradients_match_jax(case, mode, request):
    if case == "chunks_below_one_batch":
        request.getfixturevalue("small_chunks")
    inputs, up, conv = make_case(case)
    s, p, d, g, dg = conv
    x, offsets, mask, weight = inputs

    def nhwc(a):
        return jnp.asarray(np.transpose(a, (0, 2, 3, 1)), jnp.float32)

    def jloss(xx, oo, mm, ww):
        out = jdcn.deform_conv2d(xx, oo, mm, ww, strides=s, padding=p,
                                 dilation=d, groups=g, deformable_groups=dg,
                                 mode=mode)
        return jnp.sum(out * nhwc(up))

    modulated = mask is not None
    argnums = (0, 1, 2, 3) if modulated else (0, 1, 3)
    want = jax.grad(jloss, argnums)(
        nhwc(x), nhwc(offsets), nhwc(mask) if modulated else None,
        jnp.asarray(np.transpose(weight, (2, 3, 1, 0)), jnp.float32))
    want = [np.transpose(np.asarray(w), (0, 3, 1, 2)) for w in want[:-1]] \
        + [np.transpose(np.asarray(want[-1]), (3, 2, 0, 1))]
    _, got = run(dcn.DeformConv2dFunction.apply, inputs, up, conv)
    got = [t for t in got if t is not None]
    assert len(got) == len(want)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def _saved_numels(fn):
    """The element counts of every tensor autograd saves while ``fn``
    runs (``saved_tensors_hooks``)."""
    numels = []

    def pack(t):
        numels.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, numels


def _module(groups=2, modulated=True, bias=True):
    conv = DeformConv(8, 8, groups=groups, modulated=modulated,
                          bias=bias)
    gen = torch.Generator().manual_seed(5)
    reset_parameters(conv, gen)
    with torch.no_grad():
        conv.offset.weight.normal_(0.0, 0.3, generator=gen)
        conv.offset.bias.normal_(0.0, 1.0, generator=gen)
        if bias:
            conv.bias.normal_(0.0, 0.1, generator=gen)
    return conv


@pytest.mark.parametrize("modulated", [True, False])
def test_deform_conv_saves_only_its_inputs(modulated, monkeypatch):
    """Under autograd ``DeformConv`` goes through the Function, which
    saves x, offsets, mask and weight: nothing saved is larger than the
    layer's offsets, where autograd through the plain version keeps the
    gathered rows (Ho*Wo*K*4C per image) and more. Its gradients of the
    input and every parameter equal the plain path's within the
    tolerances above."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 8, 10, 12, generator=gen)
    up = torch.randn(2, 8, 10, 12, generator=gen)
    grads, saved = {}, {}
    for route in ("function", "plain"):
        if route == "plain":
            monkeypatch.setattr(dcn.DeformConv2dFunction, "apply",
                                dcn.deform_conv2d)
        conv = _module(modulated=modulated)
        xx = x.clone().requires_grad_()
        y, numels = _saved_numels(lambda: conv(xx))
        backward = {type(f).__name__ for f, _ in y.grad_fn.next_functions
                    if f is not None}
        assert ("DeformConv2dFunctionBackward" in backward) == (
            route == "function")
        y.backward(up)
        saved[route] = numels
        grads[route] = {"x": xx.grad, **{n: p.grad for n, p in
                                         conv.named_parameters()}}
    offsets = 2 * 18 * 10 * 12
    gathered = 2 * 10 * 12 * 9 * 4 * 8
    assert max(saved["function"]) <= offsets < gathered
    assert max(saved["plain"]) >= gathered
    assert sum(saved["function"]) < sum(saved["plain"]) / 4
    assert set(grads["function"]) == set(grads["plain"])
    for n, w in grads["plain"].items():
        _close(grads["function"][n], w, 1e-5 if n == "weight" else 1e-6)


@pytest.mark.parametrize("mode", ["frozen", "no_grad", "inference_mode"])
def test_deform_conv_without_grad_takes_the_plain_version(mode):
    """Inference (no input requiring a gradient, no_grad or
    inference_mode): the Function records no graph and saves nothing,
    and its output is ``deform_conv2d``'s bit for bit."""
    conv = _module()
    x = torch.randn(1, 8, 6, 7, generator=torch.Generator().manual_seed(7))
    context = {"frozen": contextlib.nullcontext, "no_grad": torch.no_grad,
               "inference_mode": torch.inference_mode}[mode]
    if mode == "frozen":
        conv.requires_grad_(False)
    with context():
        y, numels = _saved_numels(lambda: conv(x))
        om = conv.offset(x)
        want = dcn.deform_conv2d(x, om[:, :conv.n_offsets],
                                 torch.sigmoid(om[:, conv.n_offsets:]),
                                 conv.weight, 1, 1, 1, 2, 1)
    assert y.grad_fn is None and numels == []
    assert torch.equal(y, want + conv.bias[:, None, None])


# K5's cases. name: (B, C, H, W, O, stride, dilation, groups, dg,
# modulated, scale of the offsets' whole parts, on the integer grid)
K5_CASES = {
    "v2_groups4": (2, 8, 7, 8, 8, 1, 1, 4, 1, True, 2, False),
    "v1_groups1": (2, 4, 7, 8, 4, 1, 1, 1, 1, False, 2, False),
    "v2_dg2": (2, 8, 7, 8, 8, 1, 1, 1, 2, True, 2, False),
    "v1_groups4_dg2": (2, 8, 6, 9, 8, 1, 1, 4, 2, False, 2, False),
    "stride2": (2, 4, 9, 10, 6, 2, 1, 1, 1, True, 2, False),
    "dilation2": (2, 4, 9, 10, 6, 1, 2, 1, 1, True, 2, False),
    "off_the_image": (2, 4, 6, 7, 4, 1, 1, 1, 1, True, 8, False),
    "on_the_grid": (2, 8, 7, 8, 8, 1, 1, 4, 2, True, 3, True),
}


def make_k5_case(name, dtype):
    """Inputs of ``name`` in ``dtype`` (x, offsets, mask, weight and an
    upstream gradient) and the conv's arguments. Off the grid the
    offsets' fractional parts stay in [0.1, 0.9]; on it they are 0, so
    every sample's corners sit on pixels and the gradients are the
    floor corners' one-sided ones."""
    b, c, h, w, o, s, d, g, dg, modulated, scale, on_grid = K5_CASES[name]
    rng = np.random.RandomState(100 + sorted(K5_CASES).index(name))
    ho = (h - 1) // s + 1
    wo = (w - 1) // s + 1
    shape = (b, dg * 18, ho, wo)
    frac = 0.0 if on_grid else rng.uniform(0.1, 0.9, shape)
    offsets = frac + rng.randint(-scale, scale + 1, shape)
    mask = rng.uniform(0.1, 1.0, (b, dg * 9, ho, wo)) if modulated else None
    arrays = (rng.normal(0, 1, (b, c, h, w)), offsets, mask,
              rng.normal(0, 0.2, (o, c // g, 3, 3)),
              rng.normal(0, 1, (b, o, ho, wo)))
    return ([None if a is None else torch.tensor(a, dtype=dtype)
             for a in arrays], (s, d, d, g, dg))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_col2im_plain_matches_autograd(case, dtype):
    """K5's plain version, given the columns' gradient that
    ``_columns_grad`` takes from the output's, against autograd through
    ``deform_conv2d``: x's, the offsets' and the mask's gradients."""
    (x, offsets, mask, weight, up), conv = make_k5_case(case, dtype)
    leaves = [t.clone().requires_grad_() for t in (x, offsets, mask)
              if t is not None]
    out = dcn.deform_conv2d(*leaves[:2], leaves[2] if mask is not None
                            else None, weight, *conv)
    want = torch.autograd.grad(out, leaves, up)
    dcol = dcn._columns_grad(up, weight, conv[3])
    got = ds._col2im_grads(x, offsets, mask, dcol, 3, 3, *conv)
    assert (got[2] is None) == (mask is None)
    assert all(t.is_contiguous() for t in got if t is not None)
    for g, w in zip([t for t in got if t is not None], want):
        assert g.dtype == w.dtype
        _close(g, w, 1e-6)
    if K5_CASES[case][-1]:
        assert float((want[1] != 0).float().mean()) > 0.3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_columns_backward_matches_recompute(case, dtype):
    """The card's backward route (``deform_conv2d_columns_backward``),
    here through K4's and K5's plain versions, against the CPU's
    recompute under autograd: each wanted gradient in its input's dtype
    (dx also in x's layout), None for the others; the weight's summed in
    float32."""
    (x, offsets, mask, weight, up), conv = make_k5_case(case, torch.float32)
    x, weight, up = (t.to(dtype) for t in (x, weight, up))
    modulated = mask is not None
    for wanted in ((True, True, modulated, True), (False, True, False, True),
                   (True, False, False, False)):
        got = dcn.deform_conv2d_columns_backward(
            x, offsets, mask, weight, up, *conv, wanted=wanted)
        want = dcn._recompute_backward(x, offsets, mask, weight, up, conv,
                                       wanted)
        for name, g, w in zip(("x", "offsets", "mask", "weight"), got, want):
            if w is None:
                assert g is None, name
                continue
            assert g.dtype == w.dtype, name
            if name == "x":  # the recompute's comes channels-last
                assert g.is_contiguous()
            share = 1e-2 if dtype == torch.bfloat16 else (
                1e-5 if name == "weight" else 1e-6)
            _close(g, w, share)
