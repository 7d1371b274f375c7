"""The PAA training loss of the PyTorch port against the JAX package,
piece by piece, in float32 on the CPU: the matcher, the focal loss, the
GMM, the box pieces (``encode_box``, ``box_iou_aligned``, xyxy<->xywh,
``giou_loss``), ``bottom_k_iterative`` and ``paa_loss`` with its
assignment internals. Inputs come from numpy seeds and go through both.

Integer outputs are equal: matches, ``iou_labels``, the candidates,
``pos_mask``, ``labels_paa``, ``num_pos``, GMM components. Tolerances
for floats, each with its reason:
- elementwise box math (encode, aligned IoU, GIoU, focal loss) within
  1e-6 relative, 1e-6 absolute: the same float32 operations in the same
  order; ``log``/``exp`` may differ in the last ulp between libraries;
- GMM scores within 1e-5 absolute: 100 EM iterations of sums over up to
  45 samples, reduced in different orders;
- the losses within 1e-5 relative, and their gradients with respect to
  the head outputs within 1e-5 of each tensor's largest magnitude: sums
  over every anchor and class, in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.modeling import box_coder as jbox_coder
from paa_tpu.modeling import paa_loss as jpaa
from paa_tpu.modeling.matcher import match_anchors as jmatch
from paa_tpu.ops.focal_loss import sigmoid_focal_loss as jfocal
from paa_tpu.ops.gmm import gmm_fit_predict as jgmm
from paa_tpu.structures import boxes as jboxes
from paa_tpu_torch.modeling import box_coder
from paa_tpu_torch.modeling import paa_loss as tpaa
from paa_tpu_torch.modeling.anchors import AnchorGenerator
from paa_tpu_torch.modeling.matcher import match_anchors
from paa_tpu_torch.ops import gmm as tgmm
from paa_tpu_torch.ops.focal_loss import sigmoid_focal_loss
from paa_tpu_torch.ops.gmm import gmm_fit_predict
from paa_tpu_torch.structures import boxes
from test_torch_port_train import _one_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _equal(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _close(got, want, rtol=0.0, atol=0.0, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _random_boxes(rng, shape, lo=0.0, hi=200.0, size=(2.0, 80.0)):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(*size, shape + (2,))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


# ---- matcher ----------------------------------------------------------

def _match_case(seed):
    """(B=3, G=5, N=60) IoUs: image 0 with ties (two GTs equal at the
    same anchors, a GT whose best IoU is reached at several anchors),
    image 1 with two padded GT rows, image 2 with no valid GT."""
    rng = np.random.RandomState(seed)
    gt = _random_boxes(rng, (3, 5))
    anchors = _random_boxes(rng, (60,), size=(10.0, 60.0))
    iou = np.asarray(jboxes.box_iou(jnp.asarray(gt), jnp.asarray(
        anchors)[None]))
    iou = np.array(iou)
    iou[0, 1] = iou[0, 0]           # two GTs with equal rows
    iou[0, 2, [3, 17, 40]] = 0.55   # a GT's best IoU at three anchors
    iou[0, 2, 3:] = np.minimum(iou[0, 2, 3:], 0.55)
    iou[0, 3, 10:20] = 0.1          # exactly at the threshold
    valid = np.ones((3, 5), bool)
    valid[1, 3:] = False
    valid[2] = False
    return iou.astype(np.float32), valid


@pytest.mark.parametrize("thresholds", [(0.1, 0.1), (0.5, 0.3)])
@pytest.mark.parametrize("low_quality", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_match_anchors_matches_jax(seed, thresholds, low_quality):
    iou, valid = _match_case(seed)
    want = jmatch(jnp.asarray(iou), jnp.asarray(valid), *thresholds,
                  allow_low_quality_matches=low_quality)
    got = match_anchors(_t(iou), _t(valid), *thresholds,
                        allow_low_quality_matches=low_quality)
    assert got.dtype == torch.int32
    _equal(got, want)
    assert (got[2] == -1).all()  # no valid GT: all background


# ---- focal loss -------------------------------------------------------

def test_sigmoid_focal_loss_and_grad_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.normal(-2.0, 3.0, (2, 50, 7)).astype(np.float32)
    logits[0, 0] = [-80.0, 80.0, 0.0, 30.0, -30.0, 1e-3, -1e-3]
    targets = rng.randint(-1, 8, (2, 50)).astype(np.int32)

    def jsum(x):
        return jfocal(x, jnp.asarray(targets), 2.0, 0.25).sum()

    want = jfocal(jnp.asarray(logits), jnp.asarray(targets), 2.0, 0.25)
    want_grad = jax.grad(jsum)(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got = sigmoid_focal_loss(x, _t(targets), 2.0, 0.25)
    got.sum().backward()
    _close(got, want, rtol=1e-6, atol=1e-6)
    _close(x.grad, want_grad, rtol=1e-6, atol=1e-6)


# ---- GMM --------------------------------------------------------------

def _padded(rows, k=64):
    vals = np.full((len(rows), k), 1e9, np.float32)
    valid = np.zeros((len(rows), k), bool)
    for i, x in enumerate(rows):
        vals[i, :len(x)] = x
        valid[i, :len(x)] = True
    return vals, valid


def _gmm_cases():
    """The inputs of tests/test_gmm.py: bimodal, batched and masked,
    degenerate rows (all invalid, one sample, identical samples), the
    sklearn edge rows; and rows that converge at different iterations."""
    rng = np.random.RandomState(0)
    bimodal = np.sort(np.concatenate([rng.normal(0.5, 0.1, 20),
                                      rng.normal(3.0, 0.3, 25)]))
    cases = {"bimodal": _padded([bimodal])}

    rng = np.random.RandomState(1)
    vals = np.full((2, 3, 32), 1e9, np.float32)
    valid = np.zeros((2, 3, 32), bool)
    for b in range(2):
        for g in range(3):
            n = rng.randint(2, 32)
            vals[b, g, :n] = np.sort(np.concatenate([
                rng.normal(0.3, 0.05, n // 2),
                rng.normal(2.0, 0.2, n - n // 2)]))
            valid[b, g, :n] = True
    cases["batched_masked"] = (vals, valid)

    vals = np.zeros((3, 8), np.float32)
    valid = np.zeros((3, 8), bool)
    valid[1, 0] = True
    vals[2, :4] = 0.5
    valid[2, :4] = True
    cases["degenerate"] = (vals, valid)

    rng = np.random.RandomState(7)
    cases["edges"] = _padded([
        np.sort(rng.normal(1.0, 0.3, 30)),
        np.sort(np.concatenate([rng.normal(0.9, 0.2, 12),
                                rng.normal(1.4, 0.2, 12)])),
        np.array([0.1, 0.11, 0.12, 3.0]),
        np.array([0.5, 0.6]),
    ])

    # clean splits converge in a few iterations, overlapping modes and
    # near-uniform rows take tens: every row freezes at its own point
    rng = np.random.RandomState(11)
    rows = [np.sort(np.concatenate([rng.normal(0.2, 0.01, 9),
                                    rng.normal(5.0, 0.01, 9)])),
            np.sort(rng.uniform(0.0, 1.0, 36)),
            np.sort(np.concatenate([rng.normal(1.0, 0.4, 20),
                                    rng.normal(1.8, 0.4, 16)])),
            np.sort(rng.exponential(1.0, 27))]
    cases["staggered"] = _padded([np.abs(r) for r in rows], 45)
    return cases


GMM_CASES = _gmm_cases()


def _converged_at(vals, valid, tol=1e-3, iters=100):
    """The iteration at which each row converges, by the JAX package's
    rule, from a float64 numpy EM (to show the rows stagger)."""
    out = []
    for x, m in zip(vals.reshape(-1, vals.shape[-1]),
                    valid.reshape(-1, vals.shape[-1])):
        x = x[m].astype(np.float64)
        means, var, w, prev = np.array([x.min(), x.max()]), np.ones(2), \
            np.full(2, 0.5), -np.inf
        for it in range(iters):
            lp = (-0.5 * ((x[:, None] - means) ** 2 / var + np.log(var)
                          + np.log(2 * np.pi)) + np.log(w))
            lse = np.logaddexp(lp[:, 0], lp[:, 1])
            lb = lse.mean()
            r = np.exp(lp - lse[:, None])
            nk = r.sum(0) + 1e-12
            means = (r * x[:, None]).sum(0) / nk
            var = (r * (x[:, None] - means) ** 2).sum(0) / nk + 1e-6
            w = nk / len(x)
            if abs(lb - prev) < tol:
                break
            prev = lb
        out.append(it)
    return out


@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_fit_predict_matches_jax(case):
    vals, valid = GMM_CASES[case]
    want_c, want_s = jax.jit(jgmm)(jnp.asarray(vals), jnp.asarray(valid))
    got_c, got_s = gmm_fit_predict(_t(vals), _t(valid))
    assert got_c.dtype == torch.int32
    _equal(got_c, want_c, case)
    # scores of the valid entries (padding at 1e9 scores ~-1e18 on both)
    m = valid
    _close(_np(got_s)[m], np.asarray(want_s)[m], atol=1e-5, what=case)
    assert np.isfinite(_np(got_s)[m]).all()


def test_gmm_rows_converge_at_different_iterations():
    vals, valid = GMM_CASES["staggered"]
    its = _converged_at(vals, valid)
    assert len(set(its)) == len(its), its  # all different
    assert max(its) < 100


@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_early_stop_gives_identical_outputs(case, monkeypatch):
    """The EM stops at the first of its reads (every ``CHECK_EVERY``
    iterations) that finds every row converged: the frozen rows would
    not move, so the outputs equal those of the full 100 iterations (a
    read every 100 iterations never comes) bit for bit, and so do those
    of a read after every iteration."""
    vals, valid = _t(GMM_CASES[case][0]), _t(GMM_CASES[case][1])
    kept = gmm_fit_predict(vals, valid)
    for every in (100, 1):
        monkeypatch.setattr(tgmm, "CHECK_EVERY", every)
        for g, w in zip(gmm_fit_predict(vals, valid), kept):
            assert torch.equal(g, w), every


# ---- box pieces -------------------------------------------------------

def test_encode_box_matches_jax():
    rng = np.random.RandomState(4)
    gt = _random_boxes(rng, (3, 40))
    anchors = _random_boxes(rng, (40,), size=(8.0, 120.0))
    want = jbox_coder.encode_box(jnp.asarray(gt), jnp.asarray(anchors)[None])
    got = box_coder.encode_box(_t(gt), _t(anchors)[None])
    _close(got, want, rtol=1e-6, atol=1e-6)
    # decode inverts encode (up to the exp clamp, not reached here)
    back = box_coder.decode_box(got, _t(anchors)[None])
    _close(back, gt, atol=1e-3)


def test_box_iou_aligned_and_xywh_match_jax():
    rng = np.random.RandomState(5)
    a = _random_boxes(rng, (4, 30))
    b = _random_boxes(rng, (4, 30))
    b[0, :5] = a[0, :5]  # identical boxes: IoU 1
    b[1, :5] = a[1, :5] + 500.0  # disjoint: IoU 0
    want = jboxes.box_iou_aligned(jnp.asarray(a), jnp.asarray(b))
    got = boxes.box_iou_aligned(_t(a), _t(b))
    _close(got, want, rtol=1e-6, atol=1e-6)
    _equal(got[0, :5], np.ones(5, np.float32))
    _equal(got[1, :5], np.zeros(5, np.float32))
    _close(boxes.xyxy_to_xywh(_t(a)), jboxes.xyxy_to_xywh(jnp.asarray(a)),
           atol=1e-5)
    xywh = np.array(jboxes.xyxy_to_xywh(jnp.asarray(a)))
    xywh[2, :3, 2:] = 0.5  # widths under one pixel clip to x2 == x1
    _close(boxes.xywh_to_xyxy(_t(xywh)),
           jboxes.xywh_to_xyxy(jnp.asarray(xywh)), atol=1e-5)


def test_giou_loss_and_grad_match_jax():
    rng = np.random.RandomState(6)
    anchors = _random_boxes(rng, (50,), size=(16.0, 128.0))
    pred = rng.normal(0.0, 0.6, (2, 50, 4)).astype(np.float32)
    pred[0, :3, 2:] = -8.0  # degenerate (near-zero) boxes
    target = rng.normal(0.0, 0.5, (2, 50, 4)).astype(np.float32)

    def jsum(p):
        return jpaa.giou_loss(p, jnp.asarray(target),
                              jnp.asarray(anchors)[None]).sum()

    want = jpaa.giou_loss(jnp.asarray(pred), jnp.asarray(target),
                          jnp.asarray(anchors)[None])
    want_grad = jax.jit(jax.grad(jsum))(jnp.asarray(pred))
    p = _t(pred).requires_grad_(True)
    got = tpaa.giou_loss(p, _t(target), _t(anchors)[None])
    got.sum().backward()
    _close(got, want, rtol=1e-5, atol=1e-6)
    _close(p.grad, want_grad, atol=1e-5 * np.abs(want_grad).max())


# ---- bottom-k and candidates -----------------------------------------

@pytest.mark.parametrize("k", [1, 4, 9])
def test_bottom_k_iterative_ties_match_jax(k):
    rng = np.random.RandomState(k)
    x = rng.randint(0, 4, (3, 5, 20)).astype(np.float32)  # many ties
    x[0, 0] = 7.0  # a row of equal values
    x[1, 1, :12] = tpaa.INF  # more INF than k leaves (masked anchors)
    want_v, want_i = jpaa.bottom_k_iterative(jnp.asarray(x), k)
    got_v, got_i = tpaa.bottom_k_iterative(_t(x), k)
    _equal(got_i, np.asarray(want_i).astype(np.int64))
    _equal(got_v, want_v)
    _equal(got_i[0, 0], np.arange(k))  # first index on ties


# ---- paa_loss ---------------------------------------------------------

TOPK = 4
LEVELS = [(10, 12), (5, 6)]


def _loss_case(seed):
    """Three images on two levels (120 + 30 anchors, sizes 32 and 64),
    5 classes, up to 5 GT slots: image 0 with three overlapping GTs
    (several candidates each) and a GT of 14 x 5 px inside the second,
    which reaches IoU 0.1 with no anchor and keeps one anchor through
    the low-quality recovery (one candidate); image 1 with two GTs and
    three padded slots; image 2 with none."""
    rng = np.random.RandomState(seed)
    gen = AnchorGenerator(sizes=((32,), (64,)), aspect_ratios=(1.0,),
                          strides=(8, 16))
    anchors, counts = gen(LEVELS)
    n, c = anchors.shape[0], 5
    gt_boxes = np.zeros((3, 5, 4), np.float32)
    gt_labels = np.zeros((3, 5), np.int32)
    gt_boxes[0, :4] = [[6, 6, 40, 44], [30, 20, 90, 75], [50, 8, 80, 38],
                       [82, 54, 96, 59]]
    gt_labels[0, :4] = [1, 3, 2, 5]
    gt_boxes[1, :2] = [[10, 30, 70, 78], [40, 2, 95, 40]]
    gt_labels[1, :2] = [4, 4]
    outputs = {
        "cls_logits": rng.normal(-3, 1.5, (3, n, c)).astype(np.float32),
        "box_regression": rng.normal(0, 0.4, (3, n, 4)).astype(np.float32),
        "iou_pred": rng.normal(0, 1, (3, n)).astype(np.float32),
    }
    return outputs, gt_boxes, gt_labels, anchors, counts


def _jax_loss(outputs, gt_boxes, gt_labels, anchors, counts, lc):
    def total(outs):
        losses, aux = jpaa.paa_loss(
            outs, jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
            jnp.asarray(anchors), counts, lc, return_aux=True)
        return sum(v for k, v in losses.items()
                   if k.startswith("loss_")), (losses, aux)

    outs = {k: jnp.asarray(v) for k, v in outputs.items()}
    (_, (losses, aux)), grads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(outs)
    return losses, aux, grads


def _port_loss(outputs, gt_boxes, gt_labels, anchors, counts, lc):
    outs = {k: _t(v).requires_grad_(True) for k, v in outputs.items()}
    losses, aux = tpaa.paa_loss(outs, _t(gt_boxes), _t(gt_labels),
                                _t(anchors), counts, lc, return_aux=True)
    sum(v for k, v in losses.items() if k.startswith("loss_")).backward()
    return losses, aux, {k: v.grad for k, v in outs.items()}


@pytest.mark.parametrize("use_iou_pred", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paa_loss_matches_jax(seed, use_iou_pred):
    case = _loss_case(seed)
    lc = tpaa.PAALossConfig(topk=TOPK, gmm_iters=100,
                            use_iou_pred=use_iou_pred)
    jlc = jpaa.PAALossConfig(topk=TOPK, gmm_iters=100,
                             use_iou_pred=use_iou_pred)
    want, want_aux, want_grads = _jax_loss(*case, jlc)
    got, got_aux, got_grads = _port_loss(*case, lc)

    assert set(got) == set(want)
    assert int(got["num_pos"]) == int(want["num_pos"]) > 0
    for k in ("labels_paa", "pos_mask", "iou_labels"):
        _equal(got_aux[k], want_aux[k], k)
    _close(got_aux["combined_loss"], want_aux["combined_loss"], rtol=1e-5,
           what="combined_loss")
    for k in want:
        if k.startswith("loss_"):
            _close(got[k], want[k], rtol=1e-5, atol=1e-7, what=k)
    for k, g in want_grads.items():
        g = np.asarray(g)
        if got_grads[k] is None:  # no loss reads it (use_iou_pred off)
            assert not g.any(), k
            continue
        _close(got_grads[k], g, atol=1e-5 * max(np.abs(g).max(), 1e-12),
               what=f"d/d {k}")

    # the zero-GT image has no positives and no matched anchors
    assert not got_aux["pos_mask"][2].any()
    assert (got_aux["iou_labels"][2] == 0).all()


@pytest.mark.parametrize("use_iou_pred", [True, False])
def test_paa_loss_no_gt_batch_matches_jax(use_iou_pred):
    """A batch with no valid GT in any image (num_pos 0): the losses
    divide by clamped counts, so they, the aux outputs and the gradients
    must still equal the JAX package's."""
    outputs, gt_boxes, gt_labels, anchors, counts = _loss_case(0)
    gt_labels = np.zeros_like(gt_labels)
    lc = tpaa.PAALossConfig(topk=TOPK, gmm_iters=100,
                            use_iou_pred=use_iou_pred)
    jlc = jpaa.PAALossConfig(topk=TOPK, gmm_iters=100,
                             use_iou_pred=use_iou_pred)
    case = (outputs, gt_boxes, gt_labels, anchors, counts)
    want, want_aux, want_grads = _jax_loss(*case, jlc)
    got, got_aux, got_grads = _port_loss(*case, lc)

    assert set(got) == set(want)
    assert int(got["num_pos"]) == int(want["num_pos"]) == 0
    for k in ("labels_paa", "pos_mask", "iou_labels"):
        _equal(got_aux[k], want_aux[k], k)
    assert not got_aux["pos_mask"].any()
    for k in want:
        if k.startswith("loss_"):
            _close(got[k], want[k], rtol=1e-5, atol=1e-7, what=k)
    for k, g in want_grads.items():
        g = np.asarray(g)
        if got_grads[k] is None:  # no loss reads it
            assert not g.any(), k
            continue
        _close(got_grads[k], g, atol=1e-5 * max(np.abs(g).max(), 1e-12),
               what=f"d/d {k}")


def test_paa_loss_candidates_match_jax():
    """The candidates (``_select_candidates``) and the positive mask
    (``_paa_positive_mask``) from the same combined loss; the case holds
    GTs with several candidates and one with a single candidate."""
    outputs, gt_boxes, gt_labels, anchors, counts = _loss_case(0)
    lc = tpaa.PAALossConfig(topk=TOPK)
    _, aux = tpaa.paa_loss({k: _t(v) for k, v in outputs.items()},
                           _t(gt_boxes), _t(gt_labels), _t(anchors),
                           counts, lc, return_aux=True)
    combined = aux["combined_loss"]
    matched = match_anchors(
        boxes.box_iou(_t(gt_boxes), _t(anchors)[None]),
        _t(gt_labels) > 0, 0.1, 0.1)
    args = (matched, aux["iou_labels"], counts, 5, TOPK)
    got_idx, got_valid = tpaa._select_candidates(combined, *args)
    want_idx, want_valid = jpaa._select_candidates(
        jnp.asarray(_np(combined)), jnp.asarray(_np(matched)),
        jnp.asarray(_np(aux["iou_labels"])), counts, 5, TOPK)
    _equal(got_idx, np.asarray(want_idx).astype(np.int64))
    _equal(got_valid, want_valid)
    n_valid = _np(got_valid).sum(-1)
    assert n_valid[0, 3] == 1 and (n_valid[0, :3] > 1).all(), n_valid
    assert (n_valid[2] == 0).all()

    got = tpaa._paa_positive_mask(combined, got_idx, got_valid, 100)
    want = jax.jit(jpaa._paa_positive_mask, static_argnums=3)(
        jnp.asarray(_np(combined)), want_idx, want_valid, 100)
    _equal(got, want)
    # the lone candidate of GT 3 is positive
    lone = _np(got_idx)[0, 3][_np(got_valid)[0, 3]]
    assert _np(got)[0, lone].all()


def test_positive_scatter_keeps_anchor_zero():
    """Non-positive candidate slots must not clear a positive at anchor 0
    (the JAX package's scatter is ``.at[i].max(v)``)."""
    combined = torch.tensor([[0.1, 5.0, 0.11, 9.0, 9.5, 4.0]])
    cand_idx = torch.tensor([[[0, 2, 5], [3, 4, 1]]])
    cand_valid = torch.tensor([[[True, True, True], [True, True, False]]])
    got = tpaa._paa_positive_mask(combined, cand_idx, cand_valid, 100)
    want = jax.jit(jpaa._paa_positive_mask, static_argnums=3)(
        jnp.asarray(_np(combined)), jnp.asarray(_np(cand_idx)),
        jnp.asarray(_np(cand_valid)), 100)
    _equal(got, want)
    _equal(got, [[True, False, True, True, False, False]])
