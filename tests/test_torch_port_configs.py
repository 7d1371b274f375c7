"""Every YAML under configs/ builds in the PyTorch port, as it does in the
JAX package: ``build_detection_model(cfg, device="cpu")`` at a narrow
width (bottlenecks 32 wide at res2, stem 32, res2 64, 64 FPN channels,
FBNet at SCALE_FACTOR 0.25, 64-wide box heads, 32-wide mask and keypoint
convs; every other key the file's), the same model class, head type and
strides as the JAX package's build of the same file, and the body the
file names. No config is refused: the JAX package builds every one, and
so does the port (a C4 or FBNet Keypoint R-CNN, which neither builds,
has no file; tests/test_torch_port_two_stage.py pins its refusal).
"""

import glob
import os

import pytest

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.fbnet import FBNetTrunk
from paa_tpu_torch.modeling.mobilenet import MobileNetV2
from paa_tpu_torch.modeling.resnet import ResNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
# configs that the JAX package refuses too, with the reason: none
REFUSED = {}


def _narrow(cfg):
    m = cfg.MODEL
    return ["MODEL.RESNETS.WIDTH_PER_GROUP",
            max(1, 32 // m.RESNETS.NUM_GROUPS),
            "MODEL.RESNETS.STEM_OUT_CHANNELS", 32,
            "MODEL.RESNETS.RES2_OUT_CHANNELS", 64,
            "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
            "MODEL.FBNET.SCALE_FACTOR", 0.25,
            "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 64,
            "MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM", 64,
            "MODEL.ROI_MASK_HEAD.CONV_LAYERS",
            (32,) * len(m.ROI_MASK_HEAD.CONV_LAYERS),
            "MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS",
            (32,) * len(m.ROI_KEYPOINT_HEAD.CONV_LAYERS)]


def _cfgs(path):
    out = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_file(os.path.join(ROOT, path))
        cfg.merge_from_list(_narrow(cfg))
        cfg.freeze()
        out.append(cfg)
    return out


def test_every_config_is_listed():
    assert len(CONFIGS) >= 99 and not set(REFUSED) - set(CONFIGS)
    assert sum("MNV2" in p for p in CONFIGS) == 5
    assert sum("fbnet" in p for p in CONFIGS) == 7


@pytest.mark.parametrize("path", CONFIGS)
def test_config_builds_as_in_jax(path):
    jcfg, cfg = _cfgs(path)
    if path in REFUSED:
        with pytest.raises(NotImplementedError):
            build_detection_model(cfg, device="cpu")
        return
    jmodel = jax_build(jcfg)
    model = build_detection_model(cfg, device="cpu")
    assert type(model).__name__ == type(jmodel).__name__
    assert getattr(model, "head_type", None) == getattr(
        jmodel, "head_type", getattr(model, "head_type", None))
    assert tuple(model.strides) == tuple(jmodel.strides)
    body = cfg.MODEL.BACKBONE.CONV_BODY
    trunk = model.module.backbone
    trunk = getattr(trunk, "resnet", None) or trunk.body
    kind = {"FBNet": FBNetTrunk, "MNV2-FPN-RETINANET": MobileNetV2}.get(
        body, ResNet)
    assert isinstance(trunk, kind)
