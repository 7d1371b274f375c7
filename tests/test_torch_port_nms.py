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

import nms_cases


_case = nms_cases.random_case


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
    """N = 9000 is above what K1 holds on an H100 (8,192): on the card
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


# K2's route from N alone (ops/nms.py::k2_plan), at the H100's 8,900
# candidates per CTA of the cluster route
@pytest.mark.parametrize("n,route", [
    (0, ("cluster", 1)), (1, ("cluster", 1)), (8900, ("cluster", 1)),
    (8901, ("cluster", 2)), (80000, ("cluster", 9)),
    (142400, ("cluster", 16)), (142401, ("scratch", 1)),
])
def test_k2_plan_smallest_cluster_that_holds_n(n, route):
    assert port_nms.k2_plan(n, 8900) == route


@pytest.mark.parametrize("n", [77, 5000, 8266, 33333, 80000, 99999, 130001,
                               10 ** 6])
@pytest.mark.parametrize("capacity", [1000, 7232, 8900])
def test_k2_plan_holds_every_candidate_with_the_fewest_ctas(n, capacity):
    route, cs = port_nms.k2_plan(n, capacity)
    need = -(-n // capacity)
    if need > port_nms.K2_MAX_CLUSTER:
        assert (route, cs) == ("scratch", 1)
        return
    assert route == "cluster" and cs == need
    assert -(-n // cs) <= capacity  # each CTA's range fits, all valid
    assert cs == 1 or -(-n // (cs - 1)) > capacity  # and no fewer do


def _assert_same_where_valid(got, want):
    """keep_valid equal everywhere, keep_idx and keep_scores where valid:
    the JAX package's routes write other values in empty slots."""
    want = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(got[2], want[2])
    v = want[2]
    np.testing.assert_array_equal(got[0][v], want[0][v])
    np.testing.assert_array_equal(got[1][v], want[1][v])


def _nan_case():
    boxes, scores, labels, valid = _case(21, 2, 300)
    valid[1] = np.random.RandomState(1).rand(300) > 0.2
    scores[0, 7], valid[0, 7] = np.nan, True  # ends row 0
    scores[1, 3], valid[1, 3] = np.nan, False  # invalid: harmless
    return boxes, scores, labels, valid


def test_nan_score_ends_its_row_as_in_jax():
    """A valid NaN score: no picks in its row, the other row unchanged,
    as in both of paa_tpu's routes (the port's plain version raised an
    index error here before)."""
    args = _nan_case()
    jargs = [jnp.asarray(a) for a in args]
    got = _port(args, 0.6, 20, True)
    assert not got[2][0].any() and got[2][1].all()
    assert (got[0][0] == 0).all() and (got[1][0] == -1e30).all()
    clean = [a.copy() for a in args]
    clean[3][0] = False
    np.testing.assert_array_equal(got[0][1], _port(clean, 0.6, 20, True)[0][1])
    for want in (nms_batched_auto(*jargs, 0.6, 20, class_aware=True),
                 nms_pallas_batched(*jargs, 0.6, 20, class_aware=True)):
        _assert_same_where_valid(got, want)
    for g, w in zip(got, _sweep_mirror(*args, 0.6, 20, True)):
        np.testing.assert_array_equal(g, w)


def _sweep_mirror(boxes, scores, labels, valid, thresh, max_out,
                  class_aware, tile=32):
    """K1's algorithm (csrc/nms_batched.cu) in numpy: per row, the live
    candidates (valid, score > -5e29) sorted by (score desc, index asc),
    swept in tiles; a member is kept iff no box kept before it, in an
    earlier tile or earlier in its own, suppresses it; stop at max_out.
    A valid NaN score leaves its row empty. The kernel's tiles hold 32;
    the picks do not depend on the tile (the any-tile test below)."""
    bsz, n = scores.shape
    one, thresh = np.float32(1), np.float32(thresh)
    x1, y1, x2, y2 = (boxes[..., i].astype(np.float32) for i in range(4))
    area = (x2 - x1 + one) * (y2 - y1 + one)
    keep_idx = np.zeros((bsz, max_out), np.int32)
    keep_scores = np.full((bsz, max_out), -1e30, np.float32)
    keep_valid = np.zeros((bsz, max_out), bool)
    for b in range(bsz):
        s = scores[b].astype(np.float32)
        if np.isnan(s[valid[b]]).any():
            continue
        live = np.flatnonzero(valid[b] & (s > -5e29))
        order = live[np.lexsort((live, -s[live]))]

        def sup(a, c):  # [i, j]: box a[i], once picked, suppresses c[j]
            w = np.maximum(np.minimum(x2[b, a][:, None], x2[b, c])
                           - np.maximum(x1[b, a][:, None], x1[b, c])
                           + one, 0)
            h = np.maximum(np.minimum(y2[b, a][:, None], y2[b, c])
                           - np.maximum(y1[b, a][:, None], y1[b, c])
                           + one, 0)
            inter = w * h
            with np.errstate(divide="ignore", invalid="ignore"):
                out = inter / (area[b, a][:, None] + area[b, c]
                               - inter) > thresh
            if class_aware:
                out &= labels[b, a][:, None] == labels[b, c]
            return out

        kept = []
        for t0 in range(0, len(order), tile):
            members = order[t0:t0 + tile]
            open_ = ~sup(np.asarray(kept, np.int64), members).any(axis=0)
            rows = sup(members, members)
            for i in range(len(members)):
                if open_[i] and len(kept) < max_out:
                    kept.append(members[i])
                    open_[i + 1:] &= ~rows[i, i + 1:]
            if len(kept) == max_out:
                break
        k = len(kept)
        keep_idx[b, :k] = kept
        keep_scores[b, :k] = s[kept]
        keep_valid[b, :k] = True
    return keep_idx, keep_scores, keep_valid


@pytest.mark.parametrize("name", nms_cases.EDGES)
def test_sort_and_sweep_equals_greedy(name):
    """K1's sort-and-tile-sweep (its numpy mirror) equals the greedy plain
    version in all three outputs, and paa_tpu's scan where valid (the
    main-path shapes at two rows)."""
    args, thresh, max_out, aware = nms_cases.edge_case(name, rows=2)
    got = _port(args, thresh, max_out, aware)
    for g, w in zip(_sweep_mirror(*args, thresh, max_out, aware), got):
        np.testing.assert_array_equal(g, w)
    _assert_same_where_valid(got, nms_batched_auto(
        *[jnp.asarray(a) for a in args], thresh, max_out,
        class_aware=aware))
    assert got[2].any()
    if name == "ties_across_tiles":  # ties by index, duplicates dropped
        want = nms_cases.tied_picks()
        np.testing.assert_array_equal(got[0][0, :len(want)], want)
    if name == "one_box_suppresses_all":
        assert (got[2].sum(axis=1) == args[3].any(axis=1)).all()
    if name == "max_out_below_survivors":
        assert got[2][0].all() and got[2][2].all()


@pytest.mark.parametrize("tile", [1, 3, 32, 64])
def test_sort_and_sweep_any_tile_equals_greedy(tile):
    """The tile size changes the steps, not the picks."""
    args = _case(40 + tile, 3, 400)
    want = _port(args, 0.45, 150, True)
    for g, w in zip(_sweep_mirror(*args, 0.45, 150, True, tile=tile), want):
        np.testing.assert_array_equal(g, w)
