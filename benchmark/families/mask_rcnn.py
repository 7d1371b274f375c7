"""The Mask R-CNN family: what the benchmark's runner
(``harness/serve.py``, ``harness/control.py``) needs of a Mask R-CNN
configuration, on the plain reference ``benchmark/reference/mask_rcnn.py``.
Serving only; its functions are those ``families/paa.py`` lists for
serving, and ``control``.

What the check captures, by forward hooks on the program's module, on
one call of each pool batch through the entry: the RPN head's outputs
(``rpn_head``), the proposals the box head pools and its class logits
and deltas (``box_head``), and the detected boxes the mask head pools
and its logits (``mask_head``). Then, on the same images and weights,
each stage is held to the reference on the program's own inputs, so
that a fault shows in the stage that makes it:

- ``rpn_gap``: for objectness and deltas, per FPN level, rms(program -
  reference) / std(reference) of the RPN head's outputs, the
  reference's from its own float32 features; the worst;
- ``proposal_mismatch``: the reference's ``select_proposals`` on the
  program's RPN outputs against the program's proposals, slot by slot:
  the slots the reference holds valid whose box differs from the
  program's in any coordinate (the program hands its box head no
  validity; where the validity differs, a box differs, or the
  detections do);
- ``box_gap``: the reference's box head on its own features at the
  program's proposals against the program's logits and deltas (as
  ``rpn_gap``; the worst of the two);
- ``det_mismatch``, ``det_box_gap_px``, ``det_score_gap``: every window
  call's detections against the reference's box post-processing of the
  program's captured logits and deltas at its proposals
  (``checks.detections_gap``; the proposals' validity is the
  reference's);
- ``mask_gap``: the reference's mask head on its own features at the
  program's detected boxes against the program's mask logits (every
  channel);
- ``mask_prob_gap``: every window call's ``masks`` against the sigmoid
  of the captured logits at the channel of the call's own labels, taken
  on the program's device; the largest difference.

The control (``fp8``): the reference's whole inference one precision
below the configuration's, every conv's and fc layer's input and weight
rounded to fp8 e4m3, its proposals, box post-processing and mask
sigmoid computed in bfloat16, standing in for both what the program
hands the hooks and what its calls return.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from benchmark.harness import checks, weights as W
from benchmark.harness.flops import counted_flops
from benchmark.reference import mask_rcnn as ref_mrcnn
from benchmark.reference.model import normalize

RPN_KEYS = ("objectness", "box_regression")


class Gaps:
    """Accumulates rms(p - r) / std(r) per key."""

    def __init__(self):
        self.acc = {}

    def add(self, key, p, r):
        p, r = p.double(), r.double()
        a = self.acc.setdefault(key, [0.0, 0.0, 0.0, 0])
        a[0] += float(((p - r) ** 2).sum())
        a[1] += float(r.sum())
        a[2] += float((r * r).sum())
        a[3] += r.numel()

    def values(self):
        return {k: math.sqrt(se / n / max(ss / n - (s / n) ** 2, 1e-30))
                for k, (se, s, ss, n) in self.acc.items()}

    def worst(self):
        return max(self.values().values())


def state_shapes(config):
    """{name: shape} of the reference's state dict (the program's)."""
    with torch.device("meta"):
        m = ref_mrcnn.build(config["reference"])
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def flops(cell, backward=False):
    """FLOPs of a call: the reference's body, FPN and RPN head over the
    cell's (batch, 3, H, W) input, its box head on FPN_POST_NMS_TOP_N
    rois an image and its mask head on DETECTIONS_PER_IMG (the pools'
    gathers count nothing). Serving only."""
    if backward:
        raise ValueError("the mask_rcnn family has no training cells")
    ref, tr = cell.config["reference"], cell.traffic
    ch = ref["fpn"]["out_channels"]
    bh, mh = ref["box_head"], ref["mask_head"]
    b = tr["batch"]
    with torch.device("meta"):
        model = ref_mrcnn.build(ref)
        x = torch.empty(b, 3, *tr["hw"])
        box_pools = torch.empty(b * ref["rpn"]["fpn_post_nms_top_n"],
                                bh["resolution"], bh["resolution"], ch)
        mask_pools = torch.empty(b * bh["detections_per_img"],
                                 mh["resolution"], mh["resolution"], ch)

    def forward():
        out = dict(model.rpn_head(model.backbone(x)))
        out["cls"], out["deltas"] = model.box_head.predict(box_pools)
        out["masks"] = model.mask_head.predict(mask_pools)
        return out

    return counted_flops(forward)


def serve_pool(cell, seed, device):
    """The pool of (uint8 images, content sizes) batches."""
    return W.image_pool(cell.traffic, seed, device)


@contextlib.contextmanager
def capture(model):
    """Records, on the host, what each call's RPN head, box head and
    mask head take and give: [{"rpn", "proposals", "box_cls",
    "box_deltas", "det_rois", "mask_logits"}], one entry a call."""
    calls = []
    module = model.module

    def on_rpn(m, args, out):
        calls.append({"rpn": {k: out[k].cpu() for k in RPN_KEYS}})

    def on_box(m, args, out):
        calls[-1].update(proposals=args[1].cpu(), box_cls=out[0].cpu(),
                         box_deltas=out[1].cpu())

    def on_mask(m, args, out):
        calls[-1].update(det_rois=args[1].cpu(), mask_logits=out.cpu())

    hooks = [module.rpn_head.register_forward_hook(on_rpn),
             module.box_head.register_forward_hook(on_box),
             module.mask_head.register_forward_hook(on_mask)]
    try:
        yield calls
    finally:
        for h in hooks:
            h.remove()


def reference_anchors(ref, hw, device):
    anchors, counts = ref_mrcnn.anchors(ref["rpn"], hw)
    return anchors.to(device), counts


def _images(ref, images, sizes, device):
    return normalize(images.to(device), sizes.to(device), ref["pixel_mean"],
                     ref["pixel_std"])


def _stage_gaps(model, ref, cap, images, sizes, counts, block, gaps,
                device):
    """Adds one pool batch's RPN, box-head and mask-head gaps, the
    reference run on its own features in blocks of ``block`` images."""
    bsz = images.shape[0]
    kp = cap["proposals"].shape[0] // bsz
    kd = cap["det_rois"].shape[0] // bsz
    for i in range(0, bsz, block):
        n = min(block, bsz - i)
        feats = model.backbone(_images(ref, images[i:i + n],
                                       sizes[i:i + n], device))
        rpn_out = model.rpn_head(feats)
        start = 0
        for lvl, count in enumerate(counts):
            sl = slice(start, start + count)
            start += count
            for key in RPN_KEYS:
                gaps["rpn"].add(f"{key}.P{lvl + 2}",
                                cap["rpn"][key][i:i + n, sl].to(device),
                                rpn_out[key][:, sl])
        idx = torch.arange(n, device=device)
        rows = slice(i * kp, (i + n) * kp)
        cls, deltas = model.box_head(
            feats, cap["proposals"][rows].to(device),
            idx.repeat_interleave(kp))
        gaps["box"].add("cls_logits", cap["box_cls"][rows].to(device), cls)
        gaps["box"].add("box_deltas", cap["box_deltas"][rows].to(device),
                        deltas)
        rows = slice(i * kd, (i + n) * kd)
        logits = model.mask_head(feats, cap["det_rois"][rows].to(device),
                                 idx.repeat_interleave(kd))
        gaps["mask"].add("mask_logits", cap["mask_logits"][rows].to(device),
                         logits)


def _reference_post(ref, cap, sizes, anchors, counts, device):
    """The reference's proposals from the program's RPN outputs, their
    mismatch with the program's, and the reference's detections (on the
    host) from the program's box outputs at the program's proposals;
    with the count of valid proposals and of candidates."""
    bsz = sizes.shape[0]
    sizes = sizes.to(device)
    boxes, _, valid = ref_mrcnn.select_proposals(
        {k: cap["rpn"][k].to(device) for k in RPN_KEYS}, sizes, anchors,
        counts, ref["rpn"])
    props = cap["proposals"].to(device).reshape(bsz, -1, 4)
    mismatch = int((valid & (props != boxes).any(-1)).sum())
    k = props.shape[1]
    cls = cap["box_cls"].to(device).reshape(bsz, k, -1)
    deltas = cap["box_deltas"].to(device).reshape(bsz, k, cls.shape[-1], 4)
    bh = ref["box_head"]
    cand = ref_mrcnn.box_candidates(cls, deltas, props, valid, sizes, bh)[3]
    dets = ref_mrcnn.box_postprocess(cls, deltas, props, valid, sizes, bh)
    return (mismatch, {key: v.cpu() for key, v in dets.items()},
            int(valid.sum()), int(cand.sum()))


def judge(cell, wts, pool, captured, calls, outputs, device):
    """The numbers compared (each against its limit), their detail, and
    the number of window calls whose detections or masks fail the
    limits."""
    t = time.perf_counter()
    ref = cell.config["reference"]
    anchors, counts = reference_anchors(ref, cell.traffic["hw"], device)
    gaps = {"rpn": Gaps(), "box": Gaps(), "mask": Gaps()}
    mismatch, ref_dets, n_valid, n_cand = 0, [], 0, 0
    with checks.float32_exact(), torch.no_grad():
        with torch.device(device):
            model = ref_mrcnn.build(ref)
        model.load_state_dict(wts, strict=True)
        model.eval()
        for (images, sizes), cap in zip(pool, captured):
            _stage_gaps(model, ref, cap, images, sizes, counts,
                        cell.traffic["reference_block"], gaps, device)
            bad, dets, nv, nc = _reference_post(ref, cap, sizes, anchors,
                                                counts, device)
            mismatch += bad
            ref_dets.append(dets)
            n_valid, n_cand = n_valid + nv, n_cand + nc
        del model
    det = {"det_mismatch": 0, "det_box_gap_px": 0.0, "det_score_gap": 0.0}
    failed_calls, mask_gap, probs_of = 0, 0.0, {}
    for k, out in zip(calls, outputs):
        one, bad = checks.detections_gap([ref_dets[k]], [0], [out],
                                         cell.limits)
        # the sigmoid on the program's device, once a pool batch and labels
        labels = out["labels"].reshape(-1)
        key = (k, labels.numpy().tobytes())
        if key not in probs_of:
            probs_of[key] = ref_mrcnn.mask_probs(
                captured[k]["mask_logits"].to(device),
                labels.to(device)).cpu()
        probs = probs_of[key]
        gap = float((out["masks"].reshape(probs.shape) - probs).abs().max())
        if bad or gap > cell.limits.get("mask_prob_gap", math.inf):
            failed_calls += 1
        det["det_mismatch"] += one["det_mismatch"]
        for n in ("det_box_gap_px", "det_score_gap"):
            det[n] = max(det[n], one[n])
        mask_gap = max(mask_gap, gap)
    images = sum(im.shape[0] for im, _ in pool)
    numbers = {"rpn_gap": gaps["rpn"].worst(),
               "proposal_mismatch": mismatch,
               "box_gap": gaps["box"].worst(), **det,
               "mask_gap": gaps["mask"].worst(), "mask_prob_gap": mask_gap}
    detail = {"rpn_gap_by_level": gaps["rpn"].values(),
              "box_gap_by_output": gaps["box"].values(),
              "proposals_valid_per_image": n_valid / images,
              "candidates_per_image": n_cand / images,
              "detections_per_image": sum(
                  float(d["valid"].sum()) for d in ref_dets) / images,
              "check_s": time.perf_counter() - t}
    return numbers, detail, failed_calls


def control(cell, seed, device):
    """{fault: numbers} at the cell's size from ``seed``."""
    ref = cell.config["reference"]
    wts = W.make_weights(state_shapes(cell.config), cell.config["weights"],
                         seed, device)
    pool = serve_pool(cell, seed, device)
    anchors, counts = reference_anchors(ref, cell.traffic["hw"], device)
    block = cell.traffic["reference_block"]
    with checks.float32_exact(), torch.no_grad():
        with torch.device(device):
            model = ref_mrcnn.build(ref, "fp8")
        model.load_state_dict(wts, strict=True)
        model.eval()
        captured, outputs = [], []
        for images, sizes in pool:
            parts = []
            for i in range(0, images.shape[0], block):
                s = sizes[i:i + block].to(device)
                parts.append(ref_mrcnn.detect(
                    model, _images(ref, images[i:i + block], s, device), s,
                    anchors, counts, ref, torch.bfloat16))
            stages = [p[0] for p in parts]
            captured.append({
                "rpn": {k: torch.cat([s["rpn"][k] for s in stages]).cpu()
                        for k in RPN_KEYS},
                **{k: torch.cat([s[k] for s in stages]).cpu()
                   for k in stages[0] if k != "rpn"}})
            outputs.append({k: torch.cat([p[1][k] for p in parts]).cpu()
                            for k in parts[0][1]})
        del model
    numbers, detail, _ = judge(cell, wts, pool, captured,
                               list(range(len(pool))), outputs, device)
    return {"fp8": {**numbers, **detail}}
