"""The PAA family: what the benchmark's runner (``harness/serve.py``,
``harness/train.py``, ``harness/control.py``) needs of a PAA
configuration, on the plain reference in ``benchmark/reference/``.

A family module gives, as plain functions of the cell:

- ``state_shapes(config)``: {name: shape} of the reference's state dict
  (the program's), for ``weights.make_weights``;
- ``flops(cell, backward)``: the reference's work at the cell's shapes,
  for the mfu readers;
- ``serve_pool(cell, seed, device)``: the serving pool, each entry the
  arguments of one call of the program's ``make_eval_fn`` entry;
- ``capture(model)``: a context that records, for each call through the
  entry, what the serving check compares (here the head outputs, by a
  forward hook on the model's module);
- ``judge(cell, wts, pool, captured, calls, outputs, device)``: the
  serving numbers compared, their detail, and the window calls that
  fail;
- ``train_pool(cell, seed, device)``: the training batches, with the
  ground-truth keys the model's train step asks for;
- ``STEP_RECORDS``: the entries read from each train step's metrics;
  ``reference_run(cell, wts, batches, device, precision)``: the
  reference's steps as (records, first gradient norms, change norms);
  ``train_judge(records, grad, change, ref_run)``: the training numbers
  compared and their detail;
- ``control(cell, seed, device)``: {fault: numbers} of the correctness
  control and the planted faults at the cell's own size.

The control and the faults, read at a cell's own size: the numbers the
check would compute if they stood in the program's place. The
benchmark's own runs never run them.

- ``fp8`` (every cell): the reference itself computed one precision
  below the configuration's, every convolution's input and weight
  rounded to fp8 e4m3 (the network is stated in bfloat16); serving
  takes its detections from the reference's post-processing of its own
  head outputs, computed in bfloat16 (the post-processing is stated in
  float32).
- ``half_batch`` (training): the reference's steps on the first half of
  each batch, the losses the mean over that half.
- ``state_unchanged`` (training): the parameters never move (every
  change norm 0); the first gradient as the reference's.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark.harness import checks, weights as W
from benchmark.harness.flops import counted_flops
from benchmark.reference import boxes as ref_boxes
from benchmark.reference import model as ref_model
from benchmark.reference import postprocess as ref_post
from benchmark.reference import train as ref_train

HEAD_KEYS = ("cls_logits", "box_regression", "iou_pred")
LOSS_KEYS = ("loss_cls", "loss_reg", "loss_iou_pred", "loss")
STEP_RECORDS = (*LOSS_KEYS, "num_pos")


def state_shapes(config):
    """{name: shape} of the reference's state dict (the program's)."""
    with torch.device("meta"):
        m = ref_model.build(config["reference"])
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def flops(cell, backward=False):
    """FLOPs of the reference's forward over the cell's (batch, 3, H, W)
    input; with ``backward`` also of the backward that a loss over every
    output needs (the frozen stages' weights get no gradient)."""
    tr = cell.traffic
    with torch.device("meta"):
        model = ref_model.build(cell.config["reference"])
        x = torch.empty(tr["batch"], 3, *tr["hw"])
    return counted_flops(lambda: model(x), backward)


def serve_pool(cell, seed, device):
    """The pool of (uint8 images, content sizes) batches."""
    return W.image_pool(cell.traffic, seed, device)


@contextlib.contextmanager
def capture(model):
    """Records the head outputs of each call, on the host."""
    heads = []
    hook = model.module.register_forward_hook(
        lambda m, i, o: heads.append({k: o[k].cpu() for k in HEAD_KEYS}))
    try:
        yield heads
    finally:
        hook.remove()


def reference_anchors(ref, hw, device):
    a = ref["anchors"]
    shapes = ref_model.feature_shapes(hw, a["strides"])
    anchors, counts = ref_boxes.anchors(shapes, a["strides"], a["sizes"])
    return anchors.to(device), counts


def level_slices(counts):
    out, start = [], 0
    for c in counts:
        out.append(slice(start, start + c))
        start += c
    return out


def reference_heads(cell, wts, pool, device, precision, keys=HEAD_KEYS):
    """The reference's head outputs of every pool batch (on the host),
    computed in ``precision`` in blocks of images."""
    ref = cell.config["reference"]
    block = cell.traffic["reference_block"]
    with checks.float32_exact():
        with torch.device(device):
            model = ref_model.build(ref, precision)
        model.load_state_dict(wts, strict=True)
        model.eval()
        out = []
        with torch.no_grad():
            for images, sizes in pool:
                parts = []
                for i in range(0, images.shape[0], block):
                    x = ref_model.normalize(
                        images[i:i + block].to(device),
                        sizes[i:i + block].to(device),
                        ref["pixel_mean"], ref["pixel_std"])
                    parts.append({k: v.cpu() for k, v in model(x).items()})
                out.append({k: torch.cat([p[k] for p in parts])
                            for k in keys})
    return out


def reference_detections(cell, heads, pool, device, dtype=torch.float32):
    """The reference's post-processing of head outputs (the program's,
    or a control's), per pool batch, on the host; computed in ``dtype``
    (the control: bfloat16)."""
    ref = cell.config["reference"]
    anchors, counts = reference_anchors(ref, cell.traffic["hw"], device)
    dets = []
    with checks.float32_exact(), torch.no_grad():
        for (_, sizes), h in zip(pool, heads):
            d = ref_post.detect({k: h[k].to(device).float() for k in h},
                                sizes.to(device), anchors, counts,
                                ref["postprocess"], dtype)
            dets.append({k: v.cpu() for k, v in d.items()})
    return dets


def judge(cell, wts, pool, heads, calls, outputs, device):
    """The numbers compared (each against its limit), the head gap of
    every (output, level), and the number of window calls whose
    detections fail the limits."""
    t = time.perf_counter()
    ref_heads = reference_heads(cell, wts, pool, device, "float32")
    _, counts = reference_anchors(cell.config["reference"],
                                  cell.traffic["hw"], "cpu")
    gap = checks.HeadGap(HEAD_KEYS, len(counts))
    for p, r in zip(heads, ref_heads):
        for key in HEAD_KEYS:
            for li, sl in enumerate(level_slices(counts)):
                gap.add(key, li, p[key][:, sl].to(device),
                        r[key][:, sl].to(device))
    dets = reference_detections(cell, heads, pool, device)
    det, failed = checks.detections_gap(dets, calls, outputs, cell.limits)
    numbers = {"head_gap": gap.worst(), **det}
    detail = {"head_gap_by_level": gap.values(),
              "check_s": time.perf_counter() - t}
    return numbers, detail, failed


def train_pool(cell, seed, device):
    """The pool's batches: uint8 images, content sizes, GT boxes and
    labels."""
    tr = cell.traffic
    images = W.image_pool(tr, seed, device)
    gts = W.gt_pool(tr, seed, cell.config["reference"]["head"][
        "num_classes"])
    return [{"images": im, "image_sizes": sz, "gt_boxes": b,
             "gt_labels": l} for (im, sz), (b, l) in zip(images, gts)]


def reference_run(cell, wts, batches, device, precision="float32"):
    """The reference's steps: (records, first gradient norms, change
    norms), per tensor by name."""
    ref = cell.config["reference"]
    tr = cell.traffic
    anchors, counts = reference_anchors(ref, tr["hw"], device)
    with checks.float32_exact(), torch.device(device):
        model = ref_model.build(ref, precision)
    model.load_state_dict(wts, strict=True)
    start = {n: p.detach().clone() for n, p in model.named_parameters()
             if p.requires_grad}
    on_dev = [{k: v.to(device) for k, v in b.items()} for b in batches]
    with checks.float32_exact():
        records, first = ref_train.train_steps(
            model, on_dev, anchors, counts, ref, tr["reference_block"])
    params = dict(model.named_parameters())
    grad = {n: float(g.norm()) for n, g in first.items()}
    change = {n: float((params[n].detach() - start[n]).norm())
              for n in start}
    return records, grad, change


def train_judge(records, grad, change, ref_run, keys=LOSS_KEYS):
    """The training numbers of a run against the reference's, and the
    tensors of the worst gaps."""
    ref_records, ref_grad, ref_change = ref_run
    loss_gap = max(checks.rel_gap(p[k], r[k])
                   for p, r in zip(records, ref_records) for k in keys)
    pos_gaps = [checks.rel_gap(p["num_pos"], r["num_pos"])
                for p, r in zip(records, ref_records)]
    g, g_at, g_med, _ = checks.norm_gaps(grad, ref_grad, ref_grad)
    c, c_at, c_med, _ = checks.norm_gaps(change, ref_change, ref_grad)
    return {"loss_gap": loss_gap, "num_pos_gap": max(pos_gaps),
            "num_pos_gap_first": pos_gaps[0], "grad_gap": g,
            "change_gap": c, "grad_gap_median": g_med,
            "change_gap_median": c_med}, {"grad_gap_at": g_at,
                                          "change_gap_at": c_at}


def control(cell, seed, device):
    """{fault: numbers} at the cell's size from ``seed``."""
    wts = W.make_weights(state_shapes(cell.config), cell.config["weights"],
                         seed, device)
    if cell.kind == "serve":
        pool = serve_pool(cell, seed, device)
        heads = reference_heads(cell, wts, pool, device, "fp8")
        dets = reference_detections(cell, heads, pool, device,
                                    torch.bfloat16)
        numbers, detail, _ = judge(cell, wts, pool, heads,
                                   list(range(len(pool))), dets, device)
        return {"fp8": {**numbers, **detail}}
    n = cell.traffic["reference_steps"]
    batches = train_pool(cell, seed, device)[:n]
    ref = reference_run(cell, wts, batches, device)
    half = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]
    runs = {
        "fp8": reference_run(cell, wts, batches, device, "fp8"),
        "half_batch": reference_run(cell, wts, half, device),
        "state_unchanged": (ref[0], ref[1], {k: 0.0 for k in ref[2]}),
    }
    return {name: train_judge(*run, ref)[0] for name, run in runs.items()}
