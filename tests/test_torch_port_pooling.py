"""ROIPool and deformable position-sensitive ROI pooling of the PyTorch
port (``ops/roi_align.py::roi_pool``, ``ops/deform_pool.py``) against the
JAX package on the CPU: tests/test_roi_align.py's and
tests/test_deform_pool.py's cases, random rois (outside the map, empty
bins, rounding at .5), no offsets, offsets and multi-class offsets, and
the gradient of the deformable pool against ``jax.grad``.

Tolerances: ROIPool equal (a max of the same values); the deformable
pool within 1e-5 of each output's largest magnitude (the bilinear terms
and the sum over samples in another order), its gradients within 1e-5
of each gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.ops.deform_pool import deform_psroi_pool as jax_deform_pool
from paa_tpu.ops.roi_align import roi_pool as jax_roi_pool
from paa_tpu_torch.ops.deform_pool import deform_psroi_pool
from paa_tpu_torch.ops.roi_align import roi_pool
from test_deform_pool import np_deform_psroi


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pools(feat_nchw, rois, bidx, output_size, scale):
    got = roi_pool(_t(feat_nchw), _t(rois), _t(bidx), output_size, scale)
    want = jax_roi_pool(jnp.asarray(feat_nchw.transpose(0, 2, 3, 1)),
                        jnp.asarray(rois), jnp.asarray(bidx), output_size,
                        scale)
    return got.numpy(), np.asarray(want)


def test_roi_pool_max_matches_jax():
    """tests/test_roi_align.py's case: one roi over an 8 x 8 ramp."""
    feat = np.arange(64, dtype=np.float32).reshape(1, 1, 8, 8)
    got, want = _pools(feat, np.asarray([[0.0, 0.0, 7.0, 7.0]], np.float32),
                       np.zeros(1, np.int32), (2, 2), 1.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :, :, 0], [[27, 31], [59, 63]])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("output_size,scale", [((7, 7), 0.25),
                                               ((3, 5), 0.125)])
def test_roi_pool_random_rois_match_jax(seed, output_size, scale):
    """Rois partly or wholly off the map, degenerate and at half-pixel
    corners (rounding to even), over two images: equal, and empty bins
    0."""
    rng = np.random.RandomState(seed)
    feat = rng.normal(size=(2, 6, 13, 17)).astype(np.float32)
    xy = rng.uniform(-40, 90, (24, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 70, (24, 2))], 1)
    rois[:4] = np.round(rois[:4] * 2 * scale) / (2 * scale)  # .5 corners
    rois[4] = [200, 200, 260, 240]  # off the map: every bin empty
    rois = rois.astype(np.float32)
    bidx = rng.randint(0, 2, 24).astype(np.int32)
    got, want = _pools(feat, rois, bidx, output_size, scale)
    assert got.shape == (24, *output_size, 6)
    np.testing.assert_array_equal(got, want)
    assert (got[4] == 0).all() and np.isfinite(got).all()


def _deform_case(no_trans, num_classes=1, seed=0, rois5=None):
    rng = np.random.RandomState(seed)
    b, d, g, p, s = 2, 4, 2, 3, 2
    feat = rng.normal(0, 1, (b, d * g * g, 12, 16)).astype(np.float32)
    if rois5 is None:  # tests/test_deform_pool.py's rois
        rois5 = np.array([[0, 8, 4, 40, 28], [1, 0, 0, 63, 47],
                          [0, 30, 20, 34, 24]], np.float32)
    trans = rng.normal(0, 1, (len(rois5), 2 * num_classes, p, p)
                       ).astype(np.float32)
    kw = dict(spatial_scale=0.25, out_size=p, out_channels=d, group_size=g,
              part_size=p, sample_per_part=s, trans_std=0.1)
    return feat, rois5, None if no_trans else trans, kw


def _jax_pool(feat, rois5, trans, kw):
    out = jax_deform_pool(
        jnp.asarray(feat.transpose(0, 2, 3, 1)), jnp.asarray(rois5[:, 1:]),
        jnp.asarray(rois5[:, 0].astype(np.int32)),
        None if trans is None else jnp.asarray(trans.transpose(0, 2, 3, 1)),
        **kw)
    return out.transpose(0, 3, 1, 2)


def _port_pool(feat, rois5, trans, kw):
    return deform_psroi_pool(feat, _t(rois5[:, 1:]),
                             _t(rois5[:, 0]).long(), trans, **kw)


def _random_rois(seed, n=10):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-20, 60, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.3, 50, (n, 2))], 1)
    return np.concatenate([rng.randint(0, 2, (n, 1)), boxes],
                          1).astype(np.float32)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


CASES = {"no_offsets": (True, 1, 0), "offsets": (False, 1, 0),
         "multiclass_offsets": (False, 2, 3)}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("rois", ["jax_test", "random"])
def test_deform_psroi_pool_matches_jax(name, rois):
    no_trans, classes, seed = CASES[name]
    feat, rois5, trans, kw = _deform_case(
        no_trans, classes, seed,
        None if rois == "jax_test" else _random_rois(seed + 11))
    got = _port_pool(_t(feat), rois5, None if trans is None else _t(trans),
                     kw).numpy()
    _close(got, _jax_pool(feat, rois5, trans, kw))
    # and the loop transcription of the reference kernel
    want = np_deform_psroi(feat, rois5, trans, kw["spatial_scale"], 3, 4, 2,
                           3, 2, 0.1, no_trans)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["offsets", "multiclass_offsets"])
def test_deform_psroi_pool_gradients_match_jax_grad(name):
    """d(sum(out * w))/d(features) and /d(trans) against jax.grad of the
    JAX package's pool, w a seeded weight per output."""
    no_trans, classes, seed = CASES[name]
    feat, rois5, trans, kw = _deform_case(no_trans, classes, seed,
                                          _random_rois(seed + 5))
    weight = np.random.RandomState(seed + 1).normal(
        size=(len(rois5), 4, 3, 3)).astype(np.float32)

    def loss(f, t):
        return jnp.sum(_jax_pool_t(f, t) * weight)

    def _jax_pool_t(f, t):
        out = jax_deform_pool(f, jnp.asarray(rois5[:, 1:]),
                              jnp.asarray(rois5[:, 0].astype(np.int32)), t,
                              **kw)
        return out.transpose(0, 3, 1, 2)

    want_f, want_t = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(feat.transpose(0, 2, 3, 1)),
        jnp.asarray(trans.transpose(0, 2, 3, 1)))
    f = _t(feat).requires_grad_()
    t = _t(trans).requires_grad_()
    (_port_pool(f, rois5, t, kw) * _t(weight)).sum().backward()
    _close(f.grad.numpy(), np.asarray(want_f).transpose(0, 3, 1, 2))
    _close(t.grad.numpy(), np.asarray(want_t).transpose(0, 3, 1, 2))
    assert float(t.grad.abs().sum()) > 0
