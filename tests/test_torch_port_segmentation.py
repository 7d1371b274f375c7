"""The segmentation containers of the PyTorch port
(``structures/segmentation.py``) against the JAX package's on the CPU:
tests/test_segmentation.py's two-polygon fixture through every operation
of both containers (flips, crops, resizes, conversions, indexing), with
equal outputs; and the mask resize, cv2's INTER_NEAREST in numpy,
against ``cv2.resize`` over a hypothesis sweep, bit for bit. The port
rasterizes polygons without cv2 (structures/masks.py) and the JAX
package with ``cv2.fillPoly``: equal masks."""

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from paa_tpu.structures import segmentation as jseg
from paa_tpu_torch.structures import segmentation as seg
from test_segmentation import POLY, SIZE


def _mask(s):
    return np.asarray(s.get_mask_tensor())


def _same(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.size == want.size and len(got) == len(want)
    if isinstance(got, seg.SegmentationMask):
        assert got.mode == want.mode
        got, want = got.instances, want.instances
    if isinstance(got, seg.BinaryMaskList):
        assert got.masks.dtype == want.masks.dtype
        np.testing.assert_array_equal(got.masks, want.masks)
    elif isinstance(got, seg.PolygonList):
        for g, w in zip(got.instances, want.instances):
            assert g.size == w.size and len(g) == len(w)
            for a, b in zip(g.polygons, w.polygons):
                np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module", params=["poly", "mask"])
def pair(request):
    """The fixture in both packages, as polygons and as masks."""
    got = seg.SegmentationMask(POLY + POLY[:1], SIZE, "poly")
    want = jseg.SegmentationMask(POLY + POLY[:1], SIZE, "poly")
    if request.param == "mask":
        got, want = got.convert("mask"), want.convert("mask")
    _same(got, want)
    return got, want


OPS = {
    "flip_lr": lambda s: s.transpose(seg.FLIP_LEFT_RIGHT),
    "flip_tb": lambda s: s.transpose(seg.FLIP_TOP_BOTTOM),
    "crop": lambda s: s.crop([100, 100, 399, 399]),
    "crop_outside": lambda s: s.crop([-20.4, 5.6, 700, 300.5]),
    "resize_half": lambda s: s.resize((320, 240)),
    "resize_odd": lambda s: s.resize((211, 367)),
    "to_mask": lambda s: s.convert("mask"),
    "to_poly": lambda s: s.convert("poly"),
    "index_int": lambda s: s[1],
    "index_list": lambda s: s[[1, 0]],
    "index_bool": lambda s: s[np.array([True, False])],
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_operations_match_jax(pair, op):
    got, want = pair
    g, w = OPS[op](got), OPS[op](want)
    _same(g, w)
    np.testing.assert_array_equal(_mask(g), _mask(w))


def test_iteration_and_masks_match_jax(pair):
    got, want = pair
    parts = list(got)
    assert len(parts) == len(list(want)) == 2
    for g, w in zip(parts, want):
        np.testing.assert_array_equal(_mask(g), _mask(w))
    assert _mask(got).shape == (2, 480, 640) and _mask(got).sum() > 0


def test_reference_consistency_checks():
    """tests/test_segmentation.py's checks on the port: poly->mask->poly
    stays close, crop sizes, the resized area, double flips."""
    p = seg.SegmentationMask(POLY, SIZE, "poly")
    m = p.convert("mask")

    def l1(a, b):
        return np.abs(_mask(a).astype(np.float64)
                      - _mask(b).astype(np.float64)).sum()

    assert l1(p, p.convert("mask").convert("poly")) <= 8169.0
    box = [100, 100, 399, 399]
    assert l1(p.crop(box), m.crop(box)) <= 1.0e4
    assert p.crop(box).size == (299.0, 299.0) and m.crop(box).size == \
        (299, 299)
    ratio = _mask(p.resize((320, 240))).sum() / _mask(p).sum()
    assert 0.2 < ratio < 0.3
    for method in (seg.FLIP_LEFT_RIGHT, seg.FLIP_TOP_BOTTOM):
        assert l1(p.transpose(method), m.transpose(method)) <= 5.0e4
        np.testing.assert_array_equal(
            _mask(m.transpose(method).transpose(method)), _mask(m))


def test_empty_lists():
    got = seg.SegmentationMask([], SIZE, "poly").convert("mask")
    assert _mask(got).shape == (0, 480, 640)
    assert _mask(got.resize((10, 20))).shape == (0, 20, 10)


@settings(max_examples=300, deadline=None)
@given(h=st.integers(1, 90), w=st.integers(1, 90), oh=st.integers(1, 300),
       ow=st.integers(1, 300), seed=st.integers(0, 2 ** 31 - 1))
def test_resize_nearest_equals_cv2(h, w, oh, ow, seed):
    masks = (np.random.RandomState(seed).rand(2, h, w) > 0.5).astype(
        np.uint8)
    got = seg.resize_nearest(masks, ow, oh)
    for g, m in zip(got, masks):
        want = cv2.resize(m, (ow, oh), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(g, want.reshape(oh, ow))
