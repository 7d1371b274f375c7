"""NMS of the PyTorch port (plain version, which CPU tensors take) against
the JAX package's scan formulation and its Pallas kernels in interpret
mode: K1 (``nms_pallas_batched``) for ``nms_batched``, K2 (``nms_pallas``)
for the single-image ``nms``. Integer outputs must be equal; scores
within 1e-6 (they are copies of the input scores, so in practice
equal)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paa_tpu.ops.nms import nms as jax_nms
from paa_tpu.ops.nms import nms_batched_auto
from paa_tpu.ops.nms_pallas import nms_pallas, nms_pallas_batched
from paa_tpu_torch.ops import nms as port_nms


def _case(seed, bsz, n, n_labels=5):
    """Random boxes with exact score ties, one all-invalid row, and
    duplicate boxes (IoU exactly 1)."""
    rng = np.random.RandomState(seed)
    boxes = rng.uniform(0, 200, (bsz, n, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(5, 80, (bsz, n, 2))
    boxes[:, 1] = boxes[:, 0]
    scores = rng.uniform(0, 1, (bsz, n)).astype(np.float32)
    scores[:, 10:40] = scores[:, 5:6]  # exact ties, some suppress others
    labels = rng.randint(0, n_labels, (bsz, n)).astype(np.int32)
    valid = rng.rand(bsz, n) > 0.2
    valid[1] = False
    return boxes, scores, labels, valid


def _port(args, thresh, max_out, class_aware):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    return [np.asarray(x) for x in port_nms.nms_batched(
        *t, thresh, max_out, class_aware=class_aware)]


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-6)


@pytest.mark.parametrize("n", [300, 1000])
@pytest.mark.parametrize("class_aware", [True, False])
def test_plain_matches_jax_scan_and_pallas(n, class_aware):
    args = _case(n + class_aware, 3, n)
    jargs = [jnp.asarray(a) for a in args]
    got = _port(args, 0.6, 100, class_aware)
    assert got[2][0].sum() > 0 and not got[2][1].any()
    scan = nms_batched_auto(*jargs, 0.6, 100, class_aware=class_aware)
    _assert_same(got, scan)
    pallas = nms_pallas_batched(*jargs, 0.6, 100, class_aware=class_aware)
    _assert_same(got, pallas)


def test_plain_exhausts_before_max_out():
    """Fewer survivors than max_out: trailing slots hold idx 0, score
    -1e30, valid False in both packages."""
    args = _case(7, 2, 37)
    got = _port(args, 0.3, 64, True)
    assert not got[2][0, -1]
    _assert_same(got, nms_batched_auto(
        *[jnp.asarray(a) for a in args], 0.3, 64, class_aware=True))


def test_single_image_nms_is_a_batch_row():
    boxes, scores, labels, valid = _case(3, 3, 120)
    want = _port((boxes, scores, labels, valid), 0.5, 20, True)
    for row in range(3):
        got = port_nms.nms(
            torch.from_numpy(boxes[row]), torch.from_numpy(scores[row]),
            torch.from_numpy(labels[row]), torch.from_numpy(valid[row]),
            0.5, 20,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), w[row])


@pytest.mark.parametrize("class_aware", [True, False])
def test_single_image_nms_matches_jax_scan_and_pallas(class_aware):
    """The counterpart of paa_tpu's ``nms_auto``: K2 on the card."""
    args = [a[0] for a in _case(11 + class_aware, 2, 300)]
    got = [np.asarray(x) for x in port_nms.nms(
        *map(torch.from_numpy, args), 0.5, 64, class_aware=class_aware)]
    assert got[2].sum() > 0
    jargs = [jnp.asarray(a) for a in args]
    _assert_same(got, jax_nms(*jargs, 0.5, 64, class_aware=class_aware))
    _assert_same(got, nms_pallas(*jargs, 0.5, 64, class_aware=class_aware))


def test_nms_batched_above_k1_capacity_matches_jax():
    """N = 9000 is above what K1 holds on an H100 (8,265): on the card
    ``nms_batched`` takes K2 there, as the JAX package chunks images by
    its VMEM budget. On the CPU both entry points take the plain version,
    which must agree with the JAX package at that size."""
    args = _case(9, 2, 9000)
    want = nms_batched_auto(*[jnp.asarray(a) for a in args], 0.5, 40,
                            class_aware=True)
    got = _port(args, 0.5, 40, True)
    assert got[2][0].all()
    _assert_same(got, want)
    t = [torch.from_numpy(a) for a in args]
    _assert_same([np.asarray(x) for x in port_nms._nms_global(
        *t, 0.5, 40, class_aware=True)], want)


def test_cpu_tensors_never_launch_the_kernel():
    before = (port_nms.nms_batched.launches, port_nms._nms_global.launches)
    args = _case(0, 2, 50)
    _port(args, 0.6, 10, True)
    t = [torch.from_numpy(a) for a in args]
    port_nms._nms_global(*t, 0.6, 10)
    port_nms.nms(*(x[0] for x in t), 0.6, 10)
    assert (port_nms.nms_batched.launches,
            port_nms._nms_global.launches) == before


def test_other_devices_raise():
    t = torch.zeros(1, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port_nms.nms_batched(
            torch.zeros(1, 4, 4, device="meta"), t,
            t.to(torch.int32), t.to(torch.bool), 0.6, 2,
        )


@pytest.mark.parametrize("entry", ["_nms_global", "nms"])
def test_other_devices_raise_in_k2_entry_points(entry):
    t = torch.zeros(1, 4, device="meta")
    args = (torch.zeros(1, 4, 4, device="meta"), t, t.to(torch.int32),
            t.to(torch.bool))
    if entry == "nms":
        args = tuple(a[0] for a in args)
    with pytest.raises(ValueError, match="no kernel"):
        getattr(port_nms, entry)(*args, 0.6, 2)
