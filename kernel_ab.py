#!/usr/bin/env python3
"""Time each kernel of the PyTorch port alone on an NVIDIA GPU, beside
its bound, its plain version and any library call that computes the
same function: K1 (batched NMS), K2 (box-head NMS) and K3
(GroupNorm+ReLU) by default, K4 and K5 (the deformable im2col and
col2im) on request. PERF.md's kernel table comes from its lines.

    python3 kernel_ab.py [--repo PATH] [--tag NAME]

Imports ``paa_tpu_torch`` from PATH (default: this file's directory),
builds its kernels there, and times them with CUDA events (``cuda_ms``:
each run of calls queued behind a device-side sleep, so that host launch
time does not show) on inputs made from fixed seeds, so two checkouts
see the same data. A bound is the least time of a kernel's work at the
H100's peaks (3.35 TB/s of HBM, 67 TFLOP/s of non-tensor float32):
its bytes read and written once, or for NMS the IoUs greedy needs
(``nms_bound``), whichever takes longer.

- K1 through ``ops.nms._nms_batched_cuda`` at two batches, each checked
  bit-equal to ``nms_batched_plain`` first: PAA-like, 8 images of 5
  levels x 1,000 (location, class) candidates on one anchor per location
  of P3-P7, 80 labels, 100 picks at IoU 0.6, class-aware; and RPN-like,
  the 40 rows of 8 images x 5 levels (P2-P6, three anchors per
  location, the smallest level's rows 819 long), 1,000 proposals per row
  sorted by objectness, 1,000 picks at IoU 0.7, class-agnostic. Where
  the candidates sit comes from a smooth random objectness over the
  image, so they cluster as a random network's do (~410 picks per RPN
  row; a seeded Faster R-CNN's RPN makes ~465). Each beside its bound
  and its plain version.
- K2 through ``ops.nms._nms_global``: a batch shaped like the Faster
  R-CNN box head's, 8 images of 1,000 rois x 80 classes = 80,000
  candidates, of which one class per roi is valid (1,000 per image),
  boxes jittered around 100 objects per image, 100 picks at IoU 0.5,
  class-aware; checked bit-equal to ``nms_batched_plain`` first, then
  timed beside its bound and its plain version.
- K3 through ``ops.group_norm.group_norm_relu`` at the five PAA tower
  shapes of an 8 x 800 x 1344 batch in bfloat16 (``gn_forward_cost``):
  per launch (the input stays in L2 where it fits, as the convolution
  that writes it leaves it) and per forward (8 launches per level),
  device time only, beside its plain version, ``F.group_norm`` +
  ``F.relu``, its bytes bound and ``copy_`` of the same tensor (the
  card's rate for the same bytes); the same at the training batch of 16
  with the gradient's recompute (the plain version's VJP); and the host
  time of one call.

Prints one JSON line. ``--k3-sweep`` times K3 alone at other launch
shapes instead (see ``k3_sweep``); ``--k2-occupancy`` prints how many
clusters of each size K2's cluster route runs at once; ``--k4`` times
K4 (the deformable im2col) at the X-152 path's DCN shapes (see
``time_k4``); ``--k5`` times K5 (the deformable col2im) with the whole
CUDA backward of each layer (see ``time_k5``). To compare
checkouts A and B, run it in turns on one card (A, B, B, A); each run
is its own process, since both checkouts name their package
``paa_tpu_torch``. The timing helpers are this checkout's.
"""

import argparse
import collections
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from chip_smoke import GN_PER_LEVEL, TOWER_HW, card

HW = (800, 1344)
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor f32
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SLEEP_CYCLES = 35_000_000  # ~20 ms at the H100's 1.755 GHz boost clock
# an IoU and its compare: 2 x (min, max, sub, add, max), mul, add, sub,
# div, compare; and a label compare
NMS_IOU_OPS, NMS_LABEL_OPS = 15, 1
# bytes read of every candidate (score, valid), of a valid one besides
# (box, label), and written per output slot (idx, score, valid)
NMS_BYTES_ALL, NMS_BYTES_VALID, NMS_BYTES_OUT = 4 + 1, 16 + 4, 4 + 4 + 1


def cuda_ms(fn, reps, warmup=2):
    """Device ms per call of ``fn`` over ``reps`` calls. Where ``fn``
    waits for the device itself, its waits count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # queue the calls behind a device-side sleep (~20 ms), so that the
    # host's launch time between them does not show in the device's time
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nms_bound(args, got, real_n=None):
    """Least time for the NMS of this input, and the IoUs it needs.
    Greedy's i-th pick is the i-th live candidate (valid, score > -5e29)
    in (score desc, index asc) order that no earlier pick suppresses, so
    the function needs no argmax: only, for each live candidate up to
    the last pick of a row that fills max_out (every live candidate of a
    row that ends short of it), a test against each kept box ranked
    ahead of it: a label compare when class-aware, and an IoU for the
    same label. A row with a valid NaN score needs none. Ops against the
    f32 peak. Bytes against HBM: every real candidate's score and valid
    flag, the box and label of the valid ones, the outputs. ``real_n``
    (per row) leaves out padding added to a row; invalid, it adds no
    operations. Returns (ms, "bytes" or "operations", IoUs)."""
    _, scores, labels, valid, _, max_out, aware = args
    bsz, n = scores.shape
    live = (valid & (scores > -5e29)
            & ~(valid & scores.isnan()).any(dim=1, keepdim=True))
    order = torch.where(live, scores, float("-inf")).sort(
        dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=scores.device).expand(bsz, n))
    pairs = ious = 0
    for b in range(bsz):
        kept = got[0][b][got[2][b]].long()
        kept_rank = rank[b, kept]
        last = kept_rank[-1] if len(kept) == max_out else n
        cand = live[b] & (rank[b] <= last)
        ahead = kept_rank[None, :] < rank[b][cand][:, None]
        pairs += int(ahead.sum())
        if aware:
            ahead &= labels[b][cand][:, None] == labels[b, kept][None, :]
        ious += int(ahead.sum())
    if real_n is None:
        real_n = [n] * bsz
    nbytes = (sum(real_n) * NMS_BYTES_ALL + int(valid.sum()) * NMS_BYTES_VALID
              + bsz * max_out * NMS_BYTES_OUT)
    ops = ious * NMS_IOU_OPS + (pairs * NMS_LABEL_OPS if aware else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations"), ious


def nms_timing(entry, plain, args, reps, real_n=None):
    """``entry`` (a kernel's launcher) on ``args`` after a bit-equality
    check against ``plain``: its device ms, the plain version's (one
    call: 15-1,500 ms at these inputs), the bound and what sets it."""
    got = entry(*args)
    want = plain(*args)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"{entry.__name__} differs from its plain "
                           "version")
    bound, by, ious = nms_bound(args, got, real_n)
    return got, {"ms": cuda_ms(lambda: entry(*args), reps),
                 "plain_ms": cuda_ms(lambda: plain(*args), 1, 0),
                 "bound_ms": bound, "bound_by": by, "ious_needed": ious,
                 "valid_picks": int(got[2].sum())}


def box_head_batch(dev, bsz=8, rois=1000, classes=80, objects=100, seed=0):
    """(boxes, scores, labels, valid) of bsz images x rois * classes."""
    rng = np.random.RandomState(seed)
    centre = rng.uniform(50, 1250, (bsz, objects, 2))
    size = rng.uniform(20, 300, (bsz, objects, 2))
    obj = rng.randint(0, objects, (bsz, rois))
    jitter = rng.normal(0, 0.08, (bsz, rois, classes, 4))
    c = np.take_along_axis(centre, obj[..., None], 1)[:, :, None]
    s = np.take_along_axis(size, obj[..., None], 1)[:, :, None]
    lo = c - s / 2 + jitter[..., :2] * s
    hi = c + s / 2 + jitter[..., 2:] * s
    boxes = np.concatenate([lo, np.maximum(hi, lo + 1)], -1)
    scores = rng.uniform(0.05, 1.0, (bsz, rois, classes))
    valid = np.zeros((bsz, rois, classes), bool)
    np.put_along_axis(valid, rng.randint(0, classes, (bsz, rois, 1)), True,
                      2)
    labels = np.broadcast_to(np.arange(1, classes + 1), (bsz, rois, classes))
    n = rois * classes
    return [torch.from_numpy(np.ascontiguousarray(a).reshape(
        (bsz, n, 4) if a is boxes else (bsz, n)).astype(t)).to(dev)
        for a, t in ((boxes, np.float32), (scores, np.float32),
                     (labels, np.int32), (valid, np.bool_))]


def level_rows(rng, bsz, n, strides, ratios, per_anchor, blobs=8):
    """Rows of one batch, level-major: for each level (stride s, anchors
    of size 8 s in each of ``ratios``) and image, the n candidates (at
    most the level's anchors times ``per_anchor``) with the highest
    objectness (Gaussian blobs over the image plus noise), their anchor
    boxes moved by small deltas and clipped, and a label per candidate
    (0 when per_anchor is 1, else one of 80 drawn for each of the
    anchor's per_anchor slots). Returns boxes, scores, labels, valid."""
    out = [[], [], [], []]
    for stride in strides:
        size = 8.0 * stride
        gh, gw = -(-HW[0] // stride), -(-HW[1] // stride)
        a = np.arange(gh * gw * len(ratios))
        cy = (a // len(ratios) // gw + 0.5) * stride
        cx = (a // len(ratios) % gw + 0.5) * stride
        r = np.asarray(ratios)[a % len(ratios)]
        for _ in range(bsz):
            c = rng.uniform(0, 1, (blobs, 2)) * (HW[1], HW[0])
            rad = rng.uniform(40, 200, blobs)
            obj = sum(np.exp(-((cx - x) ** 2 + (cy - y) ** 2) / (2 * q * q))
                      for (x, y), q in zip(c, rad))
            obj = np.repeat(obj, per_anchor) + rng.normal(
                0, 0.05, a.size * per_anchor)
            k = min(n, obj.size)
            top = np.argsort(-obj, kind="stable")[:k]
            anchor = top // per_anchor
            w = size / np.sqrt(r[anchor])
            h = size * np.sqrt(r[anchor])
            d = rng.normal(0, 0.1, (a.size, 4))[anchor]
            x, y = cx[anchor] + d[:, 0] * w, cy[anchor] + d[:, 1] * h
            w, h = w * np.exp(d[:, 2]), h * np.exp(d[:, 3])
            box = np.clip(np.stack([x - w / 2, y - h / 2, x + w / 2,
                                    y + h / 2], -1), 0,
                          (HW[1] - 1, HW[0] - 1) * 2)
            label = (rng.randint(1, 81, (a.size, per_anchor)).reshape(-1)
                     [top] if per_anchor > 1 else np.zeros(k, int))
            for o, v in zip(out, (box, 1 / (1 + np.exp(-obj[top])), label,
                                  np.ones(k, bool))):
                o.append(np.pad(v, ((0, n - k),) + ((0, 0),) * (v.ndim - 1)))
    return [np.stack(o) for o in out]


def k1_batches(dev, seed=0):
    """(what, args) of K1's PAA-like and RPN-like batches."""
    rng = np.random.RandomState(seed)
    # PAA: per image one row of 5 levels x 1000, 80 classes per anchor
    boxes, scores, labels, valid = level_rows(
        rng, 8, 1000, (8, 16, 32, 64, 128), (1.0,), 80)
    paa = [np.concatenate(np.split(t, 5), axis=1)
           for t in (boxes, scores, labels, valid)]
    rpn = level_rows(rng, 8, 1000, (4, 8, 16, 32, 64), (0.5, 1.0, 2.0), 1)
    rpn[1] = -np.sort(-rpn[1], axis=1)  # rows arrive sorted
    out = []
    for what, args, extra in (("paa", paa, (0.6, 100, True)),
                              ("rpn", rpn, (0.7, 1000, False))):
        t = [torch.from_numpy(np.ascontiguousarray(a).astype(dt)).to(dev)
             for a, dt in zip(args, (np.float32, np.float32, np.int32,
                                     np.bool_))]
        out.append((what, (*t, *extra)))
    return out


def time_k1(nms, dev):
    """K1 at both batches (``nms_timing``; the padding of the RPN rows'
    short levels left out of the bound)."""
    res = {}
    for what, args in k1_batches(dev):
        got, timing = nms_timing(nms._nms_batched_cuda,
                                 nms.nms_batched_plain, args, 30,
                                 args[3].sum(dim=1).tolist())
        res[what] = {**timing, "rows": args[1].shape[0],
                     "n": args[1].shape[1],
                     "most_picks_in_a_row": int(got[2].sum(dim=1).max())}
    return res


def gn_forward_cost(gn, dev, bsz, seed, backward=False):
    """K3 per forward of the towers at batch ``bsz`` (GN_PER_LEVEL
    launches at each level's shape, bfloat16): its ms beside the plain
    version's, ``F.group_norm`` + ``F.relu``, the bound (bytes: x read
    once, y written once, the affine) and ``copy_`` of the same tensor;
    with ``backward`` also the ms of the gradient's recompute (the plain
    version's VJP, for x, weight and bias). Returns the totals, the
    levels' rows and the last level's (x, weight, bias)."""
    gen = torch.Generator().manual_seed(seed)
    s = (torch.rand(256, generator=gen) + 0.5).to(dev)
    b = (torch.randn(256, generator=gen) * 0.2).to(dev)
    totals, per_level = {}, {}
    for h, w in TOWER_HW:
        x = torch.randn(bsz, 256, h, w, generator=gen).to(
            dev, torch.bfloat16)
        y = torch.empty_like(x)  # the same bytes moved by a plain copy
        level = {
            "ms": cuda_ms(lambda: gn.group_norm_relu(x, s, b), 50),
            "plain_ms": cuda_ms(lambda: gn.group_norm_relu_plain(x, s, b),
                                20),
            "library_ms": cuda_ms(lambda: F.relu(F.group_norm(
                x, 32, s.to(x.dtype), b.to(x.dtype), 1e-5)), 50),
            "bound_ms": 1e3 * (2 * x.numel() * x.element_size()
                               + 2 * 256 * 4) / HBM_BYTES_PER_S,
            "copy_ms": cuda_ms(lambda: y.copy_(x), 50),
        }
        if backward:
            ins = [t.detach().requires_grad_(True) for t in (x, s, b)]
            up = torch.randn_like(x)

            def vjp():
                with torch.enable_grad():
                    torch.autograd.grad(gn.group_norm_relu_plain(*ins),
                                        ins, up)

            level["backward_recompute_ms"] = cuda_ms(vjp, 10)
        for k, v in level.items():
            totals[k] = totals.get(k, 0.0) + GN_PER_LEVEL * v
        per_level[f"{h}x{w}"] = level
    return totals, per_level, (x, s, b)


def k3_sweep(gn, dev, card):
    """K3 per launch at each tower shape (bf16, and f32 at P3 and P4) for
    CTA shares of 36, 48 and 72 KB and clusters of 256 or 512 threads per
    CTA, by setting ``gn_plan``'s constants."""
    gen = torch.Generator().manual_seed(5)
    s = (torch.rand(256, generator=gen) + 0.5).to(dev)
    b = (torch.randn(256, generator=gen) * 0.2).to(dev)
    xs = [torch.randn(8, 256, h, w, generator=gen).to(dev, dt)
          for dt in (torch.bfloat16, torch.float32) for h, w in TOWER_HW
          if dt == torch.bfloat16 or h >= 50]
    for kb, threads in ((36, 256), (48, 256), (72, 256), (36, 512),
                        (72, 512)):
        gn.CTA_BYTES, gn.CLUSTER_THREADS = kb * 1024, threads
        gn.gn_plan.cache_clear()
        row = {}
        for x in xs:
            _, c, h, w = x.shape
            plan = gn.gn_plan(8, c, h * w, 32, x.element_size())
            row[f"{h}x{w} {str(x.dtype)[6:]}"] = {
                "us": 1e3 * cuda_ms(lambda: gn.group_norm_relu(x, s, b), 30),
                "cs": plan.cs, "threads": plan.threads,
                "max_active_clusters": gn.gn_max_active_clusters(x)}
        print(json.dumps({"cta_kb": kb, "cluster_threads": threads,
                          "per_launch": row, "card": card}))


# the X-152 dcnv2 path's DCN layers at B=8, 800 x 1344: name, channels,
# (Ho, Wo), groups and how many a forward runs (47 in the body, the two
# towers' at each level)
K4_SHAPES = [
    ("res3", 512, (100, 168), 32, 8), ("res4", 1024, (50, 84), 32, 36),
    ("res5", 2048, (25, 42), 32, 3), ("tower_p3", 256, (100, 168), 1, 2),
    ("tower_p4", 256, (50, 84), 1, 2), ("tower_p5", 256, (25, 42), 1, 2),
    ("tower_p6", 256, (13, 21), 1, 2), ("tower_p7", 256, (7, 11), 1, 2)]


def time_k4(dcn, dev, card):
    """K4 at each shape of K4_SHAPES in bfloat16, offsets normal(0, 2
    px), mask uniform, from fixed seeds: device ms of K4 on a
    channels-last x, of the channels-last copy of an NCHW x that precedes
    it, of the product on its columns, of the whole path
    (``deform_conv2d_columns``) and of the plain ``deform_conv2d``, with
    K4's bytes bound (x, the offsets and the mask read once, the columns
    written once, at 3.35 TB/s) and the whole layer's (x, offsets, mask,
    weight read, output written). The path's output against the plain
    version's in float32, as a share of its largest magnitude."""
    out = {"card": card, "batch": 8}
    for what, c, hw, groups, per_forward in K4_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(8, c, *hw, device=dev, generator=gen).to(
            torch.bfloat16)
        offsets = torch.randn(8, 18, *hw, device=dev, generator=gen) * 2
        mask = torch.rand(8, 9, *hw, device=dev, generator=gen)
        weight = (torch.randn(c, c // groups, 3, 3, device=dev,
                              generator=gen) * 0.05).to(torch.bfloat16)
        conv = (1, 1, 1, groups, 1)
        xl = x.contiguous(memory_format=torch.channels_last)
        col = dcn.deform_im2col(xl, offsets, mask, 3, 3, *conv)
        got = dcn.deform_conv2d_columns(x, offsets, mask, weight, *conv)
        want = dcn.deform_conv2d(x.float(), offsets, mask, weight.float(),
                                 *conv)
        side = 2 * x.numel() + 4 * (offsets.numel() + mask.numel())
        out[what] = {
            "per_forward": per_forward,
            "k4_ms": cuda_ms(lambda: dcn.deform_im2col(
                xl, offsets, mask, 3, 3, *conv), 20),
            "k4_bound_ms": (side + 2 * col.numel()) / HBM_BYTES_PER_S * 1e3,
            "channels_last_copy_ms": cuda_ms(lambda: x.contiguous(
                memory_format=torch.channels_last), 20),
            "product_ms": cuda_ms(lambda: dcn._contract_columns(
                col, weight, *hw), 20),
            "path_ms": cuda_ms(lambda: dcn.deform_conv2d_columns(
                x, offsets, mask, weight, *conv), 20),
            "layer_bound_ms": (side + 2 * (x.numel() + weight.numel()))
            / HBM_BYTES_PER_S * 1e3,
            "plain_ms": cuda_ms(lambda: dcn.deform_conv2d(
                x, offsets, mask, weight, *conv), 3, warmup=1),
            "bf16_err_share": float((got.float() - want).abs().max()
                                    / want.abs().max()),
        }
        del x, offsets, mask, weight, xl, col, got, want
        torch.cuda.empty_cache()
    out["path_ms_per_forward"] = sum(
        out[w]["path_ms"] * n for w, *_, n in K4_SHAPES)
    print(json.dumps(out))


def time_k5(dcn, dev, card):
    """K5 (the deformable col2im) at each shape of K4_SHAPES in bfloat16,
    inputs as ``time_k4``'s and a columns' gradient from an upstream
    gradient, from fixed seeds: device ms of K5, its bytes bound (dcol,
    x, the offsets and the mask read once, dx and the offsets' and the
    mask's gradients written once, at 3.35 TB/s), the whole CUDA backward of the layer
    (``deform_conv2d_columns_backward``) and its bytes bound (the
    columns' gradient written and read, the columns recomputed and read,
    x read twice, the upstream gradient read twice, dx written once), the
    plain recompute under autograd (``_recompute_backward``), and the
    backward's other steps alone (``steps_ms``). K5's gradients against
    its plain version on the first two images, as a share of each one's
    largest magnitude (dx rounded to bfloat16 on both sides)."""
    from paa_tpu_torch.ops import deform_sampling as ds

    out = {"card": card, "batch": 8}
    totals = collections.Counter()
    for what, c, hw, groups, per_forward in K4_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(8, c, *hw, device=dev, generator=gen).to(
            torch.bfloat16)
        offsets = torch.randn(8, 18, *hw, device=dev, generator=gen) * 2
        mask = torch.rand(8, 9, *hw, device=dev, generator=gen)
        weight = (torch.randn(c, c // groups, 3, 3, device=dev,
                              generator=gen) * 0.05).to(torch.bfloat16)
        up = torch.randn(8, c, *hw, device=dev, generator=gen).to(
            torch.bfloat16)
        conv = (1, 1, 1, groups, 1)
        xl = x.contiguous(memory_format=torch.channels_last)
        dcol = dcn._columns_grad(up, weight, groups)
        args = (offsets, mask, dcol, 3, 3, *conv)
        row = {"per_forward": per_forward}
        got = ds.deform_col2im(xl[:2], offsets[:2], mask[:2], dcol[:2], 3, 3,
                               *conv)
        want = ds._col2im_grads(xl[:2], offsets[:2], mask[:2], dcol[:2], 3,
                                3, *conv)
        row["k5_err_share"] = max(float((g - w).abs().max() / w.abs().max())
                                  for g, w in zip(got, want))
        del got, want
        row["k5_ms"] = cuda_ms(lambda: ds.deform_col2im(xl, *args), 10)
        side = 4 * (offsets.numel() + mask.numel())
        row["k5_bound_ms"] = (2 * dcol.numel() + 4 * x.numel() + 2 * side) \
            / HBM_BYTES_PER_S * 1e3
        row["backward_ms"] = cuda_ms(
            lambda: dcn.deform_conv2d_columns_backward(
                x, offsets, mask, weight, up, *conv), 10)
        row["backward_bound_ms"] = (
            8 * dcol.numel() + 4 * x.numel() + 4 * up.numel()
            + 2 * x.numel() + 2 * side) / HBM_BYTES_PER_S * 1e3
        row["plain_ms"] = cuda_ms(lambda: dcn._recompute_backward(
            x, offsets, mask, weight, up, conv, (True,) * 4), 2, warmup=1)
        # the backward's other steps
        col = ds.deform_im2col(xl, offsets, mask, 3, 3, *conv)
        row["steps_ms"] = {
            "channels_last_copy": cuda_ms(lambda: x.contiguous(
                memory_format=torch.channels_last), 10),
            "k4": cuda_ms(lambda: ds.deform_im2col(
                xl, offsets, mask, 3, 3, *conv), 10),
            "weight_grad": cuda_ms(lambda: dcn._weight_grad(
                up, col, groups), 10),
            "columns_grad": cuda_ms(lambda: dcn._columns_grad(
                up, weight, groups), 10),
        }
        del col
        for k in ("k5_ms", "k5_bound_ms", "backward_ms",
                  "backward_bound_ms", "plain_ms"):
            totals[k] += per_forward * row[k]
        for k, v in row["steps_ms"].items():
            totals[k] += per_forward * v
        out[what] = row
        del x, offsets, mask, weight, up, xl, dcol
        torch.cuda.empty_cache()
    out["per_step"] = dict(totals)
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--tag", default="")
    ap.add_argument("--k3-sweep", action="store_true",
                    help="time K3 alone at several CTA shares and block "
                    "sizes (this checkout's ops.group_norm only)")
    ap.add_argument("--k2-occupancy", action="store_true",
                    help="print cudaOccupancyMaxActiveClusters of K2's "
                    "cluster route for each cluster size at full CTAs "
                    "(this checkout's ops.nms only)")
    ap.add_argument("--k4", action="store_true",
                    help="time K4 at the X-152 path's DCN shapes (this "
                    "checkout's ops.dcn only)")
    ap.add_argument("--k5", action="store_true",
                    help="time K5, the CUDA backward and the plain "
                    "recompute at the X-152 path's DCN shapes (this "
                    "checkout's ops.dcn only)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    from paa_tpu_torch.ops import _build
    from paa_tpu_torch.ops import group_norm as gn
    from paa_tpu_torch.ops import nms

    dev = torch.device("cuda", 0)
    name = card()
    _build.build_all()

    if args.k3_sweep:
        k3_sweep(gn, dev, name)
        return 0
    if args.k4:
        from paa_tpu_torch.ops import dcn

        time_k4(dcn, dev, name)
        return 0
    if args.k5:
        from paa_tpu_torch.ops import dcn

        time_k5(dcn, dev, name)
        return 0
    if args.k2_occupancy:
        cap = nms.k2_capacity(dev)
        lib = nms._k2_lib()
        print(json.dumps({
            "k2_capacity": cap, "card": name,
            "max_active_clusters_by_cs": {
                cs: lib.paa_nms_cluster_max_active(cs, cs * cap)
                for cs in range(1, nms.K2_MAX_CLUSTER + 1)}}))
        return 0

    k1 = time_k1(nms, dev)
    _, k2 = nms_timing(nms._nms_global, nms.nms_batched_plain,
                       (*box_head_batch(dev), 0.5, 100, True), 30)
    k3, k3_per_launch, (x, s, b) = gn_forward_cost(gn, dev, 8, 5)
    k3_train, k3_train_per_launch, _ = gn_forward_cost(gn, dev, 16, 6,
                                                       backward=True)
    # host time of one K3 call at P7, where the kernel is shortest
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        gn.group_norm_relu(x, s, b)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print(json.dumps({
        "tag": args.tag, "repo": args.repo, "card": name, "k1": k1,
        "k2": k2, "k3_per_forward": k3, "k3_per_launch": k3_per_launch,
        "k3_train_per_forward": k3_train,
        "k3_train_per_launch": k3_train_per_launch,
        "k3_host_us_per_call": host_us,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
