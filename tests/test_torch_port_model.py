"""The whole PAA-R50 inference slice of the PyTorch port against the JAX
package, at the narrow config the JAX serving tests use (R-50 body,
BACKBONE_OUT_CHANNELS=64, PRE_NMS_TOP_N=50, DETECTIONS_PER_IMG=10),
float32, uint8 input, with the JAX params carried across by
``load_jax_params``.

The params come from the JAX model's own tree (``jax.eval_shape`` of
``init``), filled from a numpy seed so that FrozenBN statistics and
GroupNorm affines are not identities; the cls_logits bias is raised so
that detections exist. Tolerances: FPN features and head outputs within
1e-4 of each tensor's largest magnitude (the convolutions sum in
different orders, and the CPU convolution code of either side has been
seen to move an output by ~1e-4 between runs of the same test);
detection labels and valid equal; boxes within 1e-3 and scores within
1e-3 absolute, the size a 1e-4 relative change of the largest logits
(about 5 here) can move a fused score."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling.fpn import _upsample_nearest as jax_upsample
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.detector import resolve_device
from paa_tpu_torch.modeling.fpn import _upsample_nearest
from paa_tpu_torch.utils import load_jax_params

HW = (64, 96)
OVERRIDES = [
    "MODEL.PAA_ON", True,
    "MODEL.RPN_ONLY", True,
    "MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET",
    "MODEL.RETINANET.USE_C5", False,
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
    "MODEL.PAA.PRE_NMS_TOP_N", 50,
    "TEST.DETECTIONS_PER_IMG", 10,
]


def _seeded_params(tree, rng, path=()):
    """Fill a flax param-shape tree from ``rng``."""
    if isinstance(tree, dict):
        return {k: _seeded_params(v, rng, path + (k,))
                for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        bound = np.sqrt(3.0 / fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    if name in ("running_var",):
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    if name in ("scale",) or (name == "weight" and len(path) > 1):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if path[-2:] == ("cls_logits", "bias"):
        return rng.uniform(-2.5, 0.5, shape).astype(np.float32)
    return rng.normal(0.0, 0.1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(OVERRIDES)
    jcfg.freeze()
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))

    cfg = get_cfg()
    cfg.merge_from_list(OVERRIDES)
    cfg.freeze()
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
    return jmodel, {"params": params}, model, images, sizes


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_features_and_head_match_jax(models):
    jmodel, variables, model, images, sizes = models
    x = images.astype(np.float32) - np.asarray(model.cfg.INPUT.PIXEL_MEAN,
                                                np.float32)

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


def test_eval_fn_matches_jax(models):
    jmodel, variables, model, images, sizes = models
    want = jmodel.make_eval_fn(variables)(jnp.asarray(images),
                                          jnp.asarray(sizes))
    # a model built from another seed, handed the carried-across state
    other = build_detection_model(model.cfg, device="cpu", seed=1)
    got = other.make_eval_fn(model.module.state_dict())(
        torch.from_numpy(images), torch.from_numpy(sizes))
    assert got["boxes"].shape == (2, 10, 4)
    assert int(got["valid"].sum()) > 0
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-3)


def test_anchor_order_matches_head_flatten_order(models):
    jmodel, _, model, _, _ = models
    anchors, counts = model.anchors_for(HW)
    want, want_counts = jmodel.anchors_for(HW)
    np.testing.assert_array_equal(anchors.numpy(), want)
    assert list(counts) == list(want_counts)
    assert model.feature_shapes(HW) == jmodel.feature_shapes(HW)


@pytest.mark.parametrize("src,dst", [((3, 5), (6, 10)), ((3, 5), (7, 9))])
def test_upsample_nearest_matches_jax(src, dst):
    """The exact 2x repeat FPN uses on padded inputs, and the general
    nearest resize of other shapes."""
    x = np.random.RandomState(0).normal(size=(2, *src, 4)).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(x), dst))
    got = _upsample_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_load_jax_params_is_strict(models):
    _, variables, model, _, _ = models
    params = jax.tree.map(lambda a: a, variables["params"])
    params["head"]["extra"] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(KeyError, match="no counterpart"):
        load_jax_params(model.module, params)
    params = jax.tree.map(lambda a: a, variables["params"])
    del params["head"]["scale4"]
    with pytest.raises(KeyError, match="without a JAX param"):
        load_jax_params(model.module, params)
    params = jax.tree.map(lambda a: a, variables["params"])
    params["head"]["bbox_pred"]["bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model.module, params)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
