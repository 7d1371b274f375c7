"""The ResNeXt, R-152, dilated and deformable PAA models of the PyTorch
port against the JAX package, on the CPU, float32, at narrow widths
(stem 16, res2 64, ResNeXt 8 groups x 4, 64 FPN channels) on 2 x 128 x
160 uint8 images, with the JAX params carried across by
``load_jax_params``.

Cases: ResNeXt without DCN; dcnv2 with groups (modulated DCN in stages
3-5 and in the last conv of both head towers); the same with the stride
in the 3x3 (STRIDE_IN_1X1 False, so the stride-2 convs are deformable);
a dilated res5 (RES5_DILATION 2) with DCN in it; and the R-152 body of
paa_dcnv2_X_152_32x8d_FPN_2x at narrow width. The JAX side samples with
``TPU.DCN_MODE`` "gather", the exact lowering the port computes.

The params are the JAX model's own tree filled from a numpy seed as in
tests/test_torch_port_model.py, and every DCN offset conv is drawn from
a seed too: at its zero init a DCN layer is a conv with a mask of 0.5
and proves nothing. The draw (kernel at 0.02 of kaiming-uniform, bias
normal(0, 1.5)) gives fractional offsets of 1-2 pixels on average and
up to ~6, with 10-20% of the samples of the larger maps off the image.

Tolerances as test_torch_port_model.py: features and head outputs
within 1e-4 of each tensor's largest magnitude; detection labels and
valid equal, boxes and scores within 1e-3. The dilated case compares
features and head outputs only: with res5 at stride 16 the head's
levels no longer match the anchor grid of ANCHOR_STRIDES, in either
package.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling.resnet import STAGE_SPECS as JAX_STAGE_SPECS
from paa_tpu.ops import dcn as jdcn
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.layers import DeformConv
from paa_tpu_torch.modeling.resnet import STAGE_SPECS
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_model import OVERRIDES, _seeded_params

HW = (128, 160)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
    "MODEL.RESNETS.RES2_OUT_CHANNELS", 64,
    "TPU.DCN_MODE", "gather",
]
GROUPS = ["MODEL.RESNETS.NUM_GROUPS", 8, "MODEL.RESNETS.WIDTH_PER_GROUP", 4]
DCNV2 = ["MODEL.RESNETS.STAGE_WITH_DCN", (False, True, True, True),
         "MODEL.RESNETS.WITH_MODULATED_DCN", True,
         "MODEL.PAA.USE_DCN_IN_TOWER", True]
CASES = {
    "resnext": GROUPS,
    "dcnv2_resnext": GROUPS + DCNV2,
    "dcnv2_stride_in_3x3": GROUPS + DCNV2 + [
        "MODEL.RESNETS.STRIDE_IN_1X1", False],
    "res5_dilation_dcn": [
        "MODEL.RESNETS.RES5_DILATION", 2,
        "MODEL.RESNETS.STAGE_WITH_DCN", (False, False, False, True),
        "MODEL.RESNETS.WITH_MODULATED_DCN", True],
    "dcnv2_x152": GROUPS + DCNV2 + [
        "MODEL.BACKBONE.CONV_BODY", "R-152-FPN-RETINANET"],
}
# cases whose head levels match the anchor grid (see the docstring)
EVAL_CASES = [c for c in sorted(CASES) if c != "res5_dilation_dcn"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _restore_jax_dcn_mode():
    """The JAX package's build sets a process-wide default DCN mode."""
    mode, margin = jdcn._DEFAULT_MODE, jdcn._DEFAULT_MARGIN
    yield
    jdcn.set_default_dcn_mode(mode, margin)


def _seed_offset_convs(tree, rng):
    """Every ``offset`` conv of a param tree drawn from ``rng`` (see the
    module docstring); other leaves kept."""
    out = {}
    for key, sub in tree.items():
        if key == "offset":
            kernel = sub["kernel"]
            bound = 0.02 * np.sqrt(3.0 / np.prod(kernel.shape[:-1]))
            out[key] = {
                "kernel": rng.uniform(-bound, bound, kernel.shape).astype(
                    np.float32),
                "bias": rng.normal(0.0, 1.5, sub["bias"].shape).astype(
                    np.float32),
            }
        elif isinstance(sub, dict):
            out[key] = _seed_offset_convs(sub, rng)
        else:
            out[key] = sub
    return out


def _cfg(get, case):
    cfg = get()
    cfg.merge_from_list(OVERRIDES + NARROW + CASES[case])
    cfg.freeze()
    return cfg


def _build(case):
    jmodel = jax_build(_cfg(jax_get_cfg, case))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    params = _seed_offset_convs(params, np.random.RandomState(3))
    model = build_detection_model(_cfg(get_cfg, case), device="cpu")
    load_jax_params(model.module, params)
    return jmodel, {"params": params}, model


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _build(case)
        return cache[case]

    return get


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _case_param(case):
    marks = [pytest.mark.slow] if case == "dcnv2_x152" else []
    return pytest.param(case, marks=marks, id=case)


@pytest.mark.parametrize("case", [_case_param(c) for c in sorted(CASES)])
def test_features_and_head_match_jax(built, case):
    jmodel, variables, model = built(case)
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, *HW, 3)).astype(np.float32)
    x = images - np.asarray(model.cfg.INPUT.PIXEL_MEAN, np.float32)

    def feats_and_out(m, xx):
        feats = m.backbone(xx)
        return feats, m.head(feats)

    want_f, want_o = jax.jit(lambda v, xx: nn.apply(
        feats_and_out, jmodel.module)(v, xx))(variables, x)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        got_f = model.module.backbone(xt)
        got_o = model.module.head(got_f)
    assert len(got_f) == len(want_f) == 5
    for g, w in zip(got_f, want_f):
        _close(g.permute(0, 2, 3, 1).numpy(), w, 1e-4)
    assert set(got_o) == set(want_o)
    for k in want_o:
        _close(got_o[k].numpy(), want_o[k], 1e-4)


@pytest.mark.parametrize("case", [_case_param(c) for c in EVAL_CASES])
def test_eval_fn_matches_jax(built, case):
    jmodel, variables, model = built(case)
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    sizes = np.asarray([[128.0, 160.0], [120.0, 150.0]], np.float32)
    want = jmodel.make_eval_fn(variables)(images, sizes)
    got = model.make_eval_fn()(torch.from_numpy(images),
                               torch.from_numpy(sizes))
    assert int(got["valid"].sum()) > 0
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-3)


def test_stage_specs_match_jax():
    """The FPN bodies' specs and, since the C4 models, the C4 bodies'
    (the C5 ones, the RPN-only model's, are not ported)."""
    assert STAGE_SPECS == {k: v for k, v in JAX_STAGE_SPECS.items()
                           if "-FPN" in k or k.endswith("-C4")}


PAA_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "paa",
                                            "*.yaml")))


@pytest.mark.parametrize("path", PAA_CONFIGS, ids=os.path.basename)
def test_every_paa_config_builds(path):
    """Each config of configs/paa/ builds at full width on the CPU, with
    a deformable conv2 in each block of the DCN stages and in the last
    conv of each tower, and its widths: the bottleneck of stage i is
    NUM_GROUPS * WIDTH_PER_GROUP * 2**i wide."""
    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg.freeze()
    module = build_detection_model(cfg, device="cpu").module
    r = cfg.MODEL.RESNETS
    blocks = STAGE_SPECS[cfg.MODEL.BACKBONE.CONV_BODY][0]
    want = sum(n for n, dcn in zip(blocks, r.STAGE_WITH_DCN) if dcn)
    want += 2 * cfg.MODEL.PAA.USE_DCN_IN_TOWER
    assert sum(isinstance(m, DeformConv) for m in module.modules()) == want
    resnet = module.backbone.resnet
    for i in range(4):
        block = getattr(resnet, f"layer{i + 1}_0")
        assert tuple(block.conv2.weight.shape) == (
            r.NUM_GROUPS * r.WIDTH_PER_GROUP * 2 ** i,
            r.WIDTH_PER_GROUP * 2 ** i, 3, 3)
    assert len(PAA_CONFIGS) == 8
