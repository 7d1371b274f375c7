"""PAA post-processing of the PyTorch port against the JAX package, in all
three candidate-selection tiers (at most 128 candidates per image, at
most PRE_NMS_TOP_N, more than that), plus the uint8 device normalize.

Integer outputs (labels, valid, NMS keep indices) must be equal. Boxes
and scores within 1e-5 relative and absolute: both sides compute the
same float32 expressions, but sigmoid, exp and the voting sums may
round differently in the last bits. device_normalize must be
bit-identical."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paa_tpu.modeling import paa_inference as jax_pi
from paa_tpu.ops.image_norm import device_normalize as jax_normalize
from paa_tpu.ops.nms import nms_batched_auto
from paa_tpu.structures.boxes import clip_to_image as jax_clip
from paa_tpu_torch.modeling import paa_inference as port_pi
from paa_tpu_torch.modeling.anchors import AnchorGenerator
from paa_tpu_torch.ops.image_norm import (
    device_normalize,
    maybe_device_normalize,
)

NUM_CLASSES = 6
HW = (128, 160)
STRIDES = (8, 16, 32, 64, 128)
PP = dict(pre_nms_thresh=0.05, pre_nms_top_n=200, nms_thresh=0.6,
          detections_per_img=30, num_classes=NUM_CLASSES, score_voting=True)

# per-image candidate counts of level 0 (320 anchors x 6 classes); the
# tier follows the largest count: <= 128, <= 200, > 200
TIERS = {
    "compact-128": (100, 40),
    "compact-k": (190, 60),
    "top-k": (900, 150),
}


def _outputs(counts, seed):
    gen = AnchorGenerator(((64,), (128,), (256,), (512,), (1024,)), (1.0,),
                          STRIDES)
    shapes = [(-(-HW[0] // s), -(-HW[1] // s)) for s in STRIDES]
    anchors, level_counts = gen(shapes)
    n = anchors.shape[0]
    bsz = len(counts)
    rng = np.random.RandomState(seed)
    logits = rng.normal(-6.0, 1.0, (bsz, n, NUM_CLASSES)).astype(np.float32)
    for i, count in enumerate(counts):
        flat = logits[i, :level_counts[0]].reshape(-1)
        pos = rng.choice(flat.size, count, replace=False)
        flat[pos] = rng.uniform(-2.9, 3.0, count)
        # exact ties between candidates of one anchor row
        flat[pos[: count // 4]] = flat[pos[0]]
        logits[i, :level_counts[0]] = flat.reshape(-1, NUM_CLASSES)
        rest = logits[i, level_counts[0]:].reshape(-1)
        pos = rng.choice(rest.size, min(30, rest.size), replace=False)
        rest[pos] = rng.uniform(-2.9, 3.0, pos.size)
        logits[i, level_counts[0]:] = rest.reshape(-1, NUM_CLASSES)
    outputs = {
        "cls_logits": logits,
        "box_regression": rng.normal(0, 0.5, (bsz, n, 4)).astype(np.float32),
        "iou_pred": rng.normal(0, 1, (bsz, n)).astype(np.float32),
    }
    sizes = np.asarray([[128.0, 160.0], [100.0, 150.0]], np.float32)
    return outputs, sizes, anchors.astype(np.float32), level_counts


def _jax_candidates(outputs, sizes, anchors, level_counts, pp):
    parts, start = [], 0
    for count in level_counts:
        sl = slice(start, start + count)
        parts.append(jax_pi._select_level_batched(
            *(jnp.asarray(outputs[k][:, sl]) for k in
              ("cls_logits", "box_regression", "iou_pred")),
            jnp.asarray(anchors[sl]), pp,
        ))
        start += count
    b, s, l, v = (jnp.concatenate([p[j] for p in parts], axis=1)
                  for j in range(4))
    return jax_clip(b, jnp.asarray(sizes)), s, l, v


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_postprocess_matches_jax(tier):
    counts = TIERS[tier]
    outputs, sizes, anchors, level_counts = _outputs(counts, seed=len(tier))
    jpp = jax_pi.PostProcessConfig(**PP)
    ppp = port_pi.PostProcessConfig(**PP)
    t_out = {k: torch.from_numpy(v) for k, v in outputs.items()}
    t_sizes, t_anchors = torch.from_numpy(sizes), torch.from_numpy(anchors)

    # the candidate slots, level by level and concatenated
    got_c = port_pi.paa_candidates(t_out, t_sizes, t_anchors, level_counts,
                                   ppp)
    want_c = _jax_candidates(outputs, sizes, anchors, level_counts, jpp)
    got_c = [np.asarray(t) for t in got_c]
    want_c = [np.asarray(t) for t in want_c]
    valid = want_c[3]
    np.testing.assert_array_equal(got_c[3], valid)
    np.testing.assert_array_equal(got_c[2][valid], want_c[2][valid])
    np.testing.assert_allclose(got_c[1][valid], want_c[1][valid],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_c[0][valid], want_c[0][valid],
                               rtol=1e-5, atol=1e-5)

    # NMS keep indices on each side's own candidates
    got_keep = port_pi.nms_batched(*(torch.from_numpy(t) for t in got_c),
                                   0.6, 30)
    want_keep = nms_batched_auto(*(jnp.asarray(t) for t in want_c), 0.6, 30)
    np.testing.assert_array_equal(np.asarray(got_keep[2]),
                                  np.asarray(want_keep[2]))
    np.testing.assert_array_equal(np.asarray(got_keep[0]),
                                  np.asarray(want_keep[0]))

    got = port_pi.paa_postprocess(t_out, t_sizes, t_anchors, level_counts,
                                  ppp)
    want = jax_pi.paa_postprocess(
        {k: jnp.asarray(v) for k, v in outputs.items()}, jnp.asarray(sizes),
        jnp.asarray(anchors), level_counts, jpp,
    )
    assert np.asarray(got["valid"]).sum() >= 10
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert got["labels"].dtype == torch.int32


def test_tier_cases_cover_all_three_tiers():
    k, small = PP["pre_nms_top_n"], 128
    top = {name: max(c) for name, c in TIERS.items()}
    assert top["compact-128"] <= small < top["compact-k"] <= k < top["top-k"]


@pytest.mark.parametrize("std", [(1.0, 1.0, 1.0), (57.4, 57.1, 58.4)])
def test_device_normalize_bit_exact(std):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (3, 64, 96, 3)).astype(np.uint8)
    sizes = np.asarray([[64, 96], [50, 70], [33, 96]], np.float32)
    mean = (102.9801, 115.9465, 122.7717)
    got = device_normalize(torch.from_numpy(images), torch.from_numpy(sizes),
                           mean, std).numpy()
    want = np.asarray(jax_normalize(jnp.asarray(images), jnp.asarray(sizes),
                                    mean, std))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got[1, 50:] == 0).all() and (got[1, :, 70:] == 0).all()


def test_maybe_device_normalize_dispatch():
    x = torch.zeros(1, 4, 4, 3)
    assert maybe_device_normalize(x, None, (0, 0, 0), (1, 1, 1)) is x
    with pytest.raises(ValueError, match="image_sizes"):
        maybe_device_normalize(x.to(torch.uint8), None, (0, 0, 0), (1, 1, 1))
