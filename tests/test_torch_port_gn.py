"""The GroupNorm models of the PyTorch port against the JAX package, on the
CPU: K3's ``relu=False`` form (its plain version, which CPU tensors take),
the GN ResNet stem and bottleneck, FPN with USE_GN / USE_RELU, the Xconv
and GN FPN2MLP box heads, the GN, dilated and 1x1-predictor mask heads,
the C4 models' unshared mask head, the whole narrow GN Mask R-CNN
(configs/gn_baselines/e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml: GN body,
GN FPN, Xconv1fc GN box head, GN mask head) serving and one train step,
and the solver's labels of a GN body. The narrow model is
tests/test_torch_port_two_stage_train.py's (R-50-FPN body, 64 FPN
channels, 5 classes, 2 x 64 x 96, 64 rois per image) with 64-wide head
convs, float32, the JAX params carried across by ``load_jax_params``.

Every GroupNorm here normalises groups of 8 elements or more: flax's
GroupNorm takes the one-pass variance E[x^2] - E[x]^2 and the port (K3
and its plain version) the two-pass one, which at 2-element groups give
gradients up to 1.8x apart (ROADMAP section 3). The fc GN of FPN2MLP
runs at MLP_HEAD_DIM 256 (groups of 8) for that reason.

Tolerances, each with its reason:
- K3's plain ``relu=False`` against ``fused_group_norm_relu(...,
  relu=False)`` in interpret mode at a shape that takes the Pallas body
  (C 128, H * W 1,280): forward within 1e-6 relative and absolute (the
  statistics' sums in another order), gradients within 1e-5 of each
  tensor's largest magnitude (as tests/test_torch_port_train.py holds
  the ReLU form);
- modules against flax: outputs within 1e-4 of each tensor's largest
  magnitude (convolutions in another summation order, and the two
  variance formulas), their gradients within 1e-3 of it (the same,
  through the GN backward's sums);
- the whole model: detections' valid and labels equal, boxes within
  1e-3 px, scores within 1e-4, masks within 1e-4 (as
  tests/test_torch_port_two_stage.py); the train step's sampled
  anchors and rois, labels and num_pos equal, losses within 1e-4
  relative (as tests/test_torch_port_mask.py's first step), gradients
  and updates within 1e-2 of each tensor's largest magnitude of a
  float64 step's (``test_gn_mask_rcnn_train_step_matches_jax`` says why
  not 1e-3);
- where a referee is needed, the port's own step or head with its
  convolutions in float64 (``_in_float64``): the port's float32 values
  within the tolerance of it everywhere, the JAX package's wherever its
  own value is (``_agree``: flax's one-pass variance is off float64 at
  a few elements of nearly constant groups).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.modeling import fpn as jax_fpn
from paa_tpu.modeling import resnet as jax_resnet
from paa_tpu.modeling import roi_box_head as jax_box_head
from paa_tpu.modeling import roi_mask_head as jax_mask_head
from paa_tpu.modeling import two_stage as jax_two_stage
from paa_tpu.ops.fused_gn import fused_group_norm_relu
from paa_tpu.solver import param_labels as jax_param_labels
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.fpn import FPN
from paa_tpu_torch.modeling.layers import GroupNorm32
from paa_tpu_torch.modeling.resnet import Bottleneck, Stem
from paa_tpu_torch.modeling.roi_box_head import (
    FPN2MLPBoxHead, FPNXconvBoxHead)
from paa_tpu_torch.modeling.roi_mask_head import MaskHead
from paa_tpu_torch.ops import group_norm as gn
from paa_tpu_torch.solver import make_optimizer, param_labels
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_mask import (
    _assert_mask_step_matches, crop_gt_masks_raw, mask_batch, mask_loss_raw)
from test_torch_port_model import _seeded_params
from test_torch_port_two_stage_train import (
    HW, assert_step_matches, cfgs, roi_box_loss_with_samples,
    rpn_loss_with_masks, run_steps, two_stage_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GN_MASK = os.path.join(ROOT, "configs", "gn_baselines",
                       "e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml")
GN_SCRATCH = os.path.join(ROOT, "configs", "gn_baselines",
                          "scratch_e2e_faster_rcnn_R_50_FPN_3x_gn.yaml")
FROZEN_BN = os.path.join(ROOT, "configs", "e2e_faster_rcnn_R_50_FPN_1x.yaml")
HEADS = ["MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM", 64,
         "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (64, 64, 64, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---- K3's relu=False form ---------------------------------------------------

def test_plain_no_relu_matches_jax_kernel_and_vjp():
    """(1, 40, 32, 128) NHWC: C a multiple of 128 and H * W >= 1,024, so
    ``fused_group_norm_relu`` runs its Pallas body (interpret mode)."""
    rng = np.random.RandomState(21)
    x = rng.normal(0.3, 1.2, (1, 40, 32, 128)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    b = rng.normal(0, 0.2, 128).astype(np.float32)
    up = rng.normal(0, 1, x.shape).astype(np.float32)
    want, vjp = jax.vjp(
        lambda *a: fused_group_norm_relu(*a, 32, 1e-5, False),
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    wgrads = vjp(jnp.asarray(up))
    ins = [t.requires_grad_(True) for t in (_nchw(x), _t(s), _t(b))]
    y = gn.GroupNormReLU.apply(*ins, 32, 1e-5, gn.group_norm_relu_plain,
                               False)
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (_nhwc(y) < 0).any()  # no ReLU
    y.backward(_nchw(up))
    got = [_nhwc(ins[0].grad), ins[1].grad.numpy(), ins[2].grad.numpy()]
    for g, w in zip(got, wgrads):
        _close(g, w, 1e-5)
    # the wrapper on a CPU tensor takes the plain version of either form
    before = dict(gn.group_norm_relu.launches_by_form)
    direct = gn.group_norm_relu(_nchw(x), _t(s), _t(b), relu=False)
    assert torch.equal(direct, y.detach())
    assert gn.group_norm_relu.launches_by_form == before


def test_no_relu_gradient_has_no_half_rule():
    """A group of zero variance with a zero bias: the ReLU form's output
    is exactly 0 there (half the upstream gradient to the bias, the JAX
    package's rule); GroupNorm alone passes the whole of it."""
    x = torch.randn(1, 64, 4, 4, generator=torch.Generator().manual_seed(2))
    x[0, 0:2] = 1.0
    b = torch.zeros(64)
    up = torch.randn(1, 64, 4, 4, generator=torch.Generator().manual_seed(3))
    grads = {}
    for relu in (True, False):
        bias = b.clone().requires_grad_(True)
        gn.group_norm_relu(x, torch.ones(64), bias, relu=relu).backward(up)
        grads[relu] = bias.grad[0:2]
    full = up[0, 0:2].sum(dim=(1, 2))
    torch.testing.assert_close(grads[False], full, rtol=1e-6, atol=0)
    torch.testing.assert_close(grads[True], 0.5 * full, rtol=1e-6, atol=0)


# ---- the GN body, FPN and heads against flax --------------------------------

def _flax(module, *inputs):
    """The module's params from ``_seeded_params`` and a function of
    (params, inputs) for its output."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *inputs))["params"]
    params = _seeded_params(shapes, np.random.RandomState(4))
    return params, lambda p, *a: module.apply({"params": p}, *a)


@pytest.mark.parametrize("kind", ["stem", "bottleneck_down",
                                  "bottleneck_identity"])
def test_gn_stem_and_bottleneck_match_jax(kind):
    rng = np.random.RandomState(6)
    if kind == "stem":
        x = rng.normal(0, 50, (2, 32, 48, 3)).astype(np.float32)
        jmod = jax_resnet.Stem(64, norm="gn")
        port = Stem(64, norm="gn")
    else:
        cin = 64 if kind == "bottleneck_down" else 256
        x = rng.normal(0, 1, (2, 16, 24, cin)).astype(np.float32)
        stride = 2 if kind == "bottleneck_down" else 1
        jmod = jax_resnet.Bottleneck(64, 256, stride=stride,
                                     stride_in_1x1=False, norm="gn")
        port = Bottleneck(cin, 64, 256, stride=stride, stride_in_1x1=False,
                          norm="gn")
    params, fn = _flax(jmod, jnp.asarray(x))
    want = np.asarray(fn(params, jnp.asarray(x)))
    load_jax_params(port, params)
    assert all(isinstance(m, GroupNorm32) for n, m in port.named_modules()
               if "bn" in n)
    xt = _nchw(x).requires_grad_(True)
    out = port(xt)
    _close(_nhwc(out), want, 1e-4)
    assert port.bn1.relu and (not hasattr(port, "bn3") or
                              not port.bn3.relu)
    _check_grads(port, params, fn, x, xt, out)


def _check_grads(port, params, fn, x, xt, out, rel=1e-3):
    """d/d(input, params) of sum(out * up), up from a seed: the port's
    against jax.vjp's, within ``rel`` of each tensor's largest
    magnitude."""
    want_out = np.asarray(fn(params, jnp.asarray(x)))
    up = np.random.RandomState(5).normal(size=want_out.shape).astype(
        np.float32)
    _, vjp = jax.vjp(fn, params, jnp.asarray(x))
    gparams, gx = vjp(jnp.asarray(up))
    out.backward(_nchw(up) if out.dim() == 4 else _t(up))
    _close(_nhwc(xt.grad), np.asarray(gx), rel)
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    load_jax_params(port, jax.tree.map(np.asarray, gparams))
    for name, p in port.named_parameters():
        _close(grads[name].numpy(), p.detach().numpy(), rel)


@pytest.mark.parametrize("use_gn,use_relu", [(True, False), (True, True),
                                             (False, True)])
def test_fpn_gn_and_relu_match_jax(use_gn, use_relu):
    """The *-FPN wiring (C2 used, P6 pooled) with FPN.USE_GN and
    FPN.USE_RELU: convs without bias under GN, then GN (K3's relu=False
    form without USE_RELU), then the ReLU."""
    rng = np.random.RandomState(7)
    hws = [(16, 24), (8, 12), (4, 6), (2, 4)]
    chans = [32, 64, 128, 256]
    feats = [rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
             for (h, w), c in zip(hws, chans)]
    jmod = jax_fpn.FPN(out_channels=64, skip_c2=False, use_p6p7=False,
                       use_gn=use_gn, use_relu=use_relu)
    params, _ = _flax(jmod, [jnp.asarray(f) for f in feats])
    want = jmod.apply({"params": params}, [jnp.asarray(f) for f in feats])
    port = FPN(chans, 64, retina=False, use_gn=use_gn, use_relu=use_relu)
    load_jax_params(port, params)
    assert (port.fpn_inner1.bias is None) == use_gn
    xs = [_nchw(f).requires_grad_(True) for f in feats]
    got = port(xs)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(_nhwc(g), np.asarray(w), 1e-4)
    if use_relu:
        assert all((_nhwc(g) >= 0).all() for g in got)
    # gradients of the input maps and the params through P2..P6
    ups = [np.random.RandomState(8 + i).normal(size=np.shape(w)).astype(
        np.float32) for i, w in enumerate(want)]
    _, vjp = jax.vjp(lambda p, fs: jmod.apply({"params": p}, fs), params,
                     [jnp.asarray(f) for f in feats])
    gparams, gfeats = vjp(tuple(jnp.asarray(u) for u in ups))
    sum((g * _nchw(u)).sum() for g, u in zip(got, ups)).backward()
    for x, w in zip(xs, gfeats):
        _close(_nhwc(x.grad), np.asarray(w), 1e-3)
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    load_jax_params(port, jax.tree.map(np.asarray, gparams))
    for name, p in port.named_parameters():
        _close(grads[name].numpy(), p.detach().numpy(), 1e-3)


def _pool_case(rng, channels=64):
    feats = [rng.normal(size=(2, h, w, channels)).astype(np.float32)
             for h, w in [(16, 24), (8, 12), (4, 6), (2, 3)]]
    rois = np.asarray([[4, 6, 50, 40], [10, 2, 90, 60], [0, 0, 30, 63],
                       [30, 20, 34, 25], [1, 1, 95, 63]], np.float32)
    bidx = np.asarray([0, 1, 1, 0, 1], np.int32)
    return feats, rois, bidx


def _in_float64(module):
    """A copy of ``module`` whose convolutions compute in float64 (the
    GroupNorms follow their input; parameters stay float32)."""
    from paa_tpu_torch.modeling.layers import Conv, ConvTranspose

    module = copy.deepcopy(module)
    for m in module.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            m.dtype = torch.float64
    return module


def _grads(port, inputs, call, ups):
    """d/d(inputs, params) of sum(out_i * up_i) through ``call(port,
    inputs)``, as float64 numpy: inputs' NHWC, params by name."""
    xs = [_nchw(f).requires_grad_(True) for f in inputs]
    port.zero_grad(set_to_none=True)
    out = call(port, xs)
    out = out if isinstance(out, tuple) else (out,)
    total = 0
    for g, u in zip(out, ups):
        ut = _t(u).to(g.dtype)
        total = total + (g * (ut.permute(0, 3, 1, 2) if g.dim() == 4
                              else ut)).sum()
    total.backward()
    return ([_nhwc(x.grad).astype(np.float64) for x in xs],
            {n: p.grad.double().numpy() for n, p in port.named_parameters()},
            out)


def _agree(got, want, ref, rel, what):
    """``got`` (the port, float32) within ``rel`` of float64's ``ref``
    (of its largest magnitude) everywhere; returns the count of elements
    where the JAX package's ``want`` is not: flax's one-pass GroupNorm
    variance loses digits in a nearly constant group (a roi a few px wide
    pools the same pixel everywhere), where its gradient may be off by
    percents. Elsewhere both are within ``rel`` of the same referee."""
    tol = rel * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)
    return int((np.abs(want - ref) > tol).sum())


def _head_parity(jmod, port, feats, rois, bidx, rel_out=1e-4,
                 jax_off_share=0.0):
    """Outputs of a flax ROI head and the port's on the same params,
    pooled from NHWC ``feats``, within ``rel_out``; then the gradients of
    the maps and of every parameter through the sum of each output times
    an upstream from a seed, the port's within 1e-3 of float64's and of
    the JAX package's (``_agree``), which may be off float64's at no more
    than ``jax_off_share`` of the elements. Returns the port's
    outputs."""
    jf = [jnp.asarray(f) for f in feats]
    params, _ = _flax(jmod, jf, jnp.asarray(rois), jnp.asarray(bidx))
    load_jax_params(port, params)

    def fn(p, fs):
        return jmod.apply({"params": p}, fs, jnp.asarray(rois),
                          jnp.asarray(bidx))

    def call(module, xs):
        return module(xs, _t(rois), _t(bidx).long())

    want, vjp = jax.vjp(fn, params, jf)
    want = want if isinstance(want, tuple) else (want,)
    ups = [np.random.RandomState(30 + i).normal(size=np.shape(w)).astype(
        np.float32) for i, w in enumerate(want)]
    gparams, gfeats = vjp(tuple(jnp.asarray(u) for u in ups)
                          if len(ups) > 1 else jnp.asarray(ups[0]))
    ref_x, ref_p, _ = _grads(_in_float64(port), feats, call, ups)
    got_x, got_p, got = _grads(port, feats, call, ups)
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1) if g.dim() == 4 else g
        _close(g.detach().numpy(), np.asarray(w), rel_out)
    off = sum(_agree(g, np.asarray(w, np.float64), r, 1e-3, "maps")
              for g, w, r in zip(got_x, gfeats, ref_x))
    load_jax_params(port, jax.tree.map(np.asarray, gparams))
    for name, p in port.named_parameters():
        off += _agree(got_p[name], p.detach().double().numpy(),
                      ref_p[name], 1e-3, name)
    total = sum(g.size for g in got_x) + sum(g.size for g in got_p.values())
    assert off <= jax_off_share * total, f"{off} of {total} JAX grads off"
    return got


@pytest.mark.parametrize("use_gn,dilation", [(True, 1), (False, 2),
                                             (True, 2)])
def test_xconv_box_head_matches_jax(use_gn, dilation):
    feats, rois, bidx = _pool_case(np.random.RandomState(9))
    jmod = jax_box_head.FPNXconvBoxHead(
        num_classes=5, mlp_dim=32, conv_head_dim=64, num_stacked_convs=2,
        dilation=dilation, use_gn=use_gn)
    port = FPNXconvBoxHead(5, in_channels=64, mlp_dim=32, conv_head_dim=64,
                           num_stacked_convs=2, dilation=dilation,
                           use_gn=use_gn)
    assert (port.xconv1.bias is None) == use_gn
    assert hasattr(port, "xconv2_gn") == use_gn
    cls, deltas = _head_parity(jmod, port, feats, rois, bidx)
    assert cls.shape == (5, 5) and deltas.shape == (5, 5, 4)


def test_fpn2mlp_gn_box_head_matches_jax():
    """fc6 / fc7 without bias, then the fc GN over (R, 256, 1, 1): groups
    of 8."""
    feats, rois, bidx = _pool_case(np.random.RandomState(10), channels=32)
    jmod = jax_box_head.FPN2MLPBoxHead(num_classes=5, mlp_dim=256,
                                       use_gn=True)
    port = FPN2MLPBoxHead(5, in_channels=32, mlp_dim=256, use_gn=True)
    assert port.fc6.bias is None and port.fc7_gn.relu
    _head_parity(jmod, port, feats, rois, bidx)


@pytest.mark.parametrize("variant", ["gn", "dilated", "conv1x1"])
def test_mask_head_variants_match_jax(variant):
    feats, rois, bidx = _pool_case(np.random.RandomState(11), channels=32)
    kw = {"gn": dict(use_gn=True), "dilated": dict(dilation=2),
          "conv1x1": dict(use_deconv=False)}[variant]
    jmod = jax_mask_head.MaskHead(num_classes=4, conv_layers=(64, 64), **kw)
    port = MaskHead(4, in_channels=32, conv_layers=(64, 64), **kw)
    # the 4 x 5 px roi pools one pixel into its whole 14 x 14 map: its GN
    # groups are nearly constant, where flax's one-pass variance is off
    # float64's (2.4% of the gradients' elements); 0 elsewhere
    (got,) = _head_parity(jmod, port, feats, rois, bidx,
                          jax_off_share=0.05 if variant == "gn" else 0.0)
    size = 14 if variant == "conv1x1" else 28
    assert got.shape == (5, 4, size, size)
    assert (port.conv5_mask is None) == (variant == "conv1x1")


def test_c4_unshared_mask_head_matches_jax():
    """The C4 models' unshared mask head: one pooler scale, 1/16, on the
    single stride-16 map (the JAX package's MaskHead at its defaults)."""
    rng = np.random.RandomState(12)
    feats = [rng.normal(size=(2, 4, 6, 64)).astype(np.float32)]
    rois = np.asarray([[4, 6, 50, 40], [10, 2, 90, 60], [0, 0, 30, 63]],
                      np.float32)
    bidx = np.asarray([0, 1, 1], np.int32)
    jmod = jax_mask_head.MaskHead(num_classes=4, conv_layers=(32, 32),
                                  scales=(1.0 / 16,))
    port = MaskHead(4, in_channels=64, conv_layers=(32, 32),
                    scales=(1.0 / 16,))
    (got,) = _head_parity(jmod, port, feats, rois, bidx)
    assert got.shape == (3, 4, 28, 28)


# ---- the whole narrow GN Mask R-CNN -----------------------------------------

@pytest.fixture(scope="module")
def gn_mask_models():
    from paa_tpu.modeling import build_detection_model as jax_build

    jcfg, cfg = cfgs(GN_MASK, HEADS)
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = two_stage_params(shapes, np.random.RandomState(0))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    return jmodel, params, model


def test_gn_mask_rcnn_detect_matches_jax(gn_mask_models):
    jmodel, params, model = gn_mask_models
    m = model.module
    gns = [mod for mod in m.modules() if isinstance(mod, GroupNorm32)]
    # stem 1, 16 blocks x 3 + 4 downsamples, FPN 8, xconvs 4, mask 4
    assert len(gns) == 1 + 16 * 3 + 4 + 8 + 4 + 4
    assert sum(not g.relu for g in gns) == 16 + 4 + 8
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
    want = jmodel.make_eval_fn({"params": params})(jnp.asarray(images),
                                                   jnp.asarray(sizes))
    got = model.make_eval_fn()(torch.from_numpy(images),
                               torch.from_numpy(sizes))
    assert int(got["valid"].sum()) > 5
    for key in ("valid", "labels"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-4)
    assert got["masks"].shape == (2, 10, 28, 28)
    np.testing.assert_allclose(got["masks"].numpy(),
                               np.asarray(want["masks"]), rtol=0, atol=1e-4)


def _float64_step(cfg, params, batch):
    """The port's train step from ``params`` with its convolutions in
    float64 (``_in_float64``; the box head's FCs, the losses and SGD stay
    float32): the referee of the float32 steps. Returns its metrics and
    the applied gradients by name, in float64."""
    from paa_tpu_torch.engine import TrainState
    from test_torch_port_two_stage_train import SEED, replay_draws

    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    model.module = _in_float64(model.module)
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    metrics = model.make_bucket_train_step(
        HW, draws=replay_draws(SEED), return_aux=True)(state, batch)
    return metrics, {n: p.grad.double() for n, p in
                     model.module.named_parameters() if p.requires_grad}


def test_gn_mask_rcnn_train_step_matches_jax():
    """One step of the narrow GN Mask R-CNN in both packages and in the
    port with float64 convolutions: the sampled anchors, rois, labels and
    num_pos equal on all three, losses within 1e-4 relative. Gradients:
    through 53 GroupNorms and the ReLU kinks behind them (GN puts the
    ReLU inputs around 0), float32 rounding moves ~0.1% of the gradients'
    elements by more than 1e-3 of their tensor's largest magnitude, so
    the applied gradients and the updates are held within 1e-2 of it:
    the port's against the float64 step everywhere, and the JAX
    package's against it but at 1e-4 of the elements at most (its
    one-pass variance leaves ~1e-5 beyond); the updated parameters
    within 1e-6 of the JAX package's."""
    from paa_tpu.modeling import build_detection_model as jax_build
    from test_torch_port_two_stage_train import in_port_layout

    jcfg, cfg = cfgs(GN_MASK, HEADS)
    batch = mask_batch(2)
    model, out = run_steps(jcfg, cfg, batch, 1, patches=(
        (jax_two_stage, "rpn_loss", rpn_loss_with_masks),
        (jax_two_stage, "roi_box_loss", roi_box_loss_with_samples),
        (jax_mask_head, "crop_gt_masks_for_rois", crop_gt_masks_raw),
        (jax_mask_head, "mask_loss", mask_loss_raw)), seeded=two_stage_params)
    step = out[0]
    _assert_mask_step_matches(step, batch, 0)
    assert_step_matches(step["port"], step["jax"], batch)
    shapes = jax.eval_shape(lambda: jax_build(jcfg).init(
        jax.random.PRNGKey(0), HW))["params"]
    params = two_stage_params(shapes, np.random.RandomState(0))
    metrics, ref_grads = _float64_step(cfg, params, batch)
    for k in ("rpn_pos", "rpn_neg", "roi_labels", "roi_valid"):
        np.testing.assert_array_equal(metrics[k].numpy(),
                                      step["port"]["metrics"][k], err_msg=k)
    jax_grads = in_port_layout(model, step["jax"]["grads"])
    jax_after = in_port_layout(model, step["jax"]["params"])
    off = total = 0
    for name, g in step["port"]["grads"].items():
        off += _agree(g.double().numpy(), jax_grads[name].double().numpy(),
                      ref_grads[name].numpy(), 1e-2, name)
        total += g.numel()
    assert len(step["port"]["grads"]) > 150 and off <= 1e-4 * total
    # the updated parameters, as tests/test_torch_port_two_stage_train.py
    for name, p in step["port"]["params"].items():
        np.testing.assert_allclose(p.numpy(), jax_after[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    m = model.module
    # the GN body's affines outside the frozen stages train
    assert m.backbone.resnet.layer2_0.bn1.weight.grad.abs().sum() > 0
    assert m.backbone.resnet.layer1_0.bn1.weight.grad is None
    assert m.box_head.xconv4_gn.bias.grad.abs().sum() > 0


# ---- the solver's labels of a GN body ---------------------------------------

def _labels_by_name(path, freeze_at):
    from paa_tpu.modeling import build_detection_model as jax_build

    jcfg, cfg = cfgs(path, HEADS)
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    leaves, treedef = jax.tree.flatten(shapes)
    ids = jax.tree.unflatten(treedef, [
        np.full(s.shape, i, np.float32) for i, s in enumerate(leaves)])
    want = jax.tree.leaves(jax_param_labels(ids, freeze_at))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, ids)
    state = model.module.state_dict()
    got = param_labels(model.module, freeze_at)
    assert len(got) == len(leaves)
    for name, t in state.items():
        assert got[name] == want[int(t.flatten()[0])], name
    return got, model


@pytest.mark.parametrize("freeze_at", [0, 2])
def test_gn_body_affines_train_frozen_bn_does_not(freeze_at):
    """Every tensor's label equals its JAX leaf's, for the GN body (its
    ``bnX`` affines "weight" / "bias" outside the frozen stages, as
    ``paa_tpu``'s ``bn1/gn/scale``) and a FrozenBN body (its ``bnX``
    tensors "frozen" everywhere). A name rule (``bn\\d`` is FrozenBN)
    would freeze the GN affines."""
    got, model = _labels_by_name(GN_MASK, freeze_at)
    assert got["backbone.resnet.layer2_0.bn1.weight"] == "weight"
    assert got["backbone.resnet.layer2_0.downsample_bn.bias"] == "bias"
    assert got["backbone.resnet.stem.bn1.weight"] == (
        "frozen" if freeze_at else "weight")
    optimizer, _ = make_optimizer(model.cfg, model.module)
    trained = {id(p) for g in optimizer.param_groups for p in g["params"]}
    assert id(model.module.backbone.resnet.layer3_0.bn3.weight) in trained
    got, _ = _labels_by_name(FROZEN_BN, freeze_at)
    assert got["backbone.resnet.layer2_0.bn1.weight"] == "frozen"
    assert got["backbone.resnet.layer2_0.bn1.running_var"] == "frozen"


def test_scratch_gn_config_trains_the_whole_body():
    """scratch_e2e_faster_rcnn_R_50_FPN_3x_gn: FREEZE_CONV_BODY_AT 0, so
    the stem's conv and GN train; FPN2MLP with the fc GN."""
    cfg = get_cfg()
    cfg.merge_from_file(GN_SCRATCH)
    cfg.freeze()
    model = build_detection_model(cfg, device="cpu")
    m = model.module
    assert m.backbone.resnet.stem.conv1.weight.requires_grad
    assert m.backbone.resnet.stem.bn1.weight.requires_grad
    assert isinstance(m.box_head, FPN2MLPBoxHead)
    assert m.box_head.fc6.bias is None and m.box_head.fc6_gn.relu
    labels = param_labels(m, 0)
    assert "frozen" not in labels.values()


_BUILT = sorted(
    [os.path.join("gn_baselines", f) for f in os.listdir(
        os.path.join(ROOT, "configs", "gn_baselines"))]
    + [f for f in os.listdir(os.path.join(ROOT, "configs"))
       if f.startswith("rpn_")]
    + [os.path.join("quick_schedules", f) for f in os.listdir(
        os.path.join(ROOT, "configs", "quick_schedules"))
       if f.startswith("rpn_")])


@pytest.mark.parametrize("config", _BUILT)
def test_every_gn_and_rpn_config_builds(config):
    """Every config of configs/gn_baselines/ and the RPN-only ones build
    at full width on the CPU: the GN models with K3 in the body's 53
    norms and FPN's 8, the RPN-only ones with no ROI head."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", config))
    cfg.freeze()
    model = build_detection_model(cfg, device="cpu")
    gns = [m for m in model.module.modules() if isinstance(m, GroupNorm32)]
    if config.startswith("gn_baselines"):
        assert model.head_type == "two_stage" and len(gns) >= 53 + 8
        assert sum(not g.relu for g in gns) == 16 + 4 + 8
    else:
        assert model.head_type == "rpn" and not gns
        assert not hasattr(model.module, "box_head")
