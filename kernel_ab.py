#!/usr/bin/env python3
"""Time the PyTorch port's K1 (batched NMS), K2 (box-head NMS) and K3
(GroupNorm+ReLU) of one checkout on an NVIDIA GPU, to compare two
designs on one card.

    python3 kernel_ab.py [--repo PATH] [--tag NAME]

Imports ``paa_tpu_torch`` from PATH (default: this file's directory),
builds its kernels there, and times them with CUDA events (each run of
calls queued behind a device-side sleep, so that host launch time does
not show) on inputs made from fixed seeds, so two checkouts see the same
data:

- K1 through ``ops.nms._nms_batched_cuda`` at two batches, each checked
  bit-equal to ``nms_batched_plain`` first: PAA-like, 8 images of 5
  levels x 1,000 (location, class) candidates on one anchor per location
  of P3-P7, 80 labels, 100 picks at IoU 0.6, class-aware; and RPN-like,
  the 40 rows of 8 images x 5 levels (P2-P6, three anchors per
  location, the smallest level's rows 819 long), 1,000 proposals per row
  sorted by objectness, 1,000 picks at IoU 0.7, class-agnostic. Where
  the candidates sit comes from a smooth random objectness over the
  image, so they cluster as a random network's do (~410 picks per RPN
  row; the RPN of ``chip_smoke.py``'s Faster R-CNN cell makes ~465).
- K2 through ``ops.nms._nms_global``: a batch shaped like the Faster
  R-CNN box head's, 8 images of 1,000 rois x 80 classes = 80,000
  candidates, of which one class per roi is valid (1,000 per image),
  boxes jittered around 100 objects per image, 100 picks at IoU 0.5,
  class-aware; checked bit-equal to ``nms_batched_plain`` first.
- K3 through ``ops.group_norm.group_norm_relu`` at the five PAA tower
  shapes of an 8 x 800 x 1344 batch in bfloat16: per launch (the input
  stays in L2 where it fits, as the convolution that writes it leaves
  it) and per forward (8 launches per level), device time only, beside
  ``copy_`` of the same tensor (the card's rate for the same bytes);
  and the host time of one call.

Prints one JSON line. ``--k3-sweep`` times K3 alone at other launch
shapes instead (see ``k3_sweep``); ``--k2-occupancy`` prints how many
clusters of each size K2's cluster route runs at once; ``--k4`` times
K4 (the deformable im2col) at the X-152 path's DCN shapes (see
``time_k4``); ``--k5`` times K5 (the deformable col2im) with the whole
CUDA backward of each layer (see ``time_k5``). To compare
checkouts A and B, run it in turns on one card (A, B, B, A); each run
is its own process, since both checkouts name their package
``paa_tpu_torch``. The timing helpers come from this checkout's
chip_smoke.py.
"""

import argparse
import collections
import json
import os
import sys
import time

import numpy as np
import torch

from chip_smoke import GN_PER_LEVEL, TOWER_HW, card, cuda_ms

HW = (800, 1344)


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
    """K1's device ms at both batches, after a bit-equality check."""
    res = {}
    for what, args in k1_batches(dev):
        got = nms._nms_batched_cuda(*args)
        want = nms.nms_batched_plain(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"K1 differs from its plain version ({what})")
        res[what] = {
            "ms": cuda_ms(lambda: nms._nms_batched_cuda(*args), 30),
            "rows": args[1].shape[0], "n": args[1].shape[1],
            "valid_picks": int(got[2].sum()),
            "most_picks_in_a_row": int(got[2].sum(dim=1).max())}
    return res


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
HBM_BYTES_PER_S = 3.35e12


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
    cand = box_head_batch(dev)
    nms_args = (*cand, 0.5, 100, True)
    got = nms._nms_global(*nms_args)
    want = nms.nms_batched_plain(*nms_args)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError("K2 differs from its plain version")
    k2_ms = cuda_ms(lambda: nms._nms_global(*nms_args), 30)

    gen = torch.Generator().manual_seed(5)
    s = (torch.rand(256, generator=gen) + 0.5).to(dev)
    b = (torch.randn(256, generator=gen) * 0.2).to(dev)
    per_level, copy_ms, total = {}, {}, 0.0
    for h, w in TOWER_HW:
        x = torch.randn(8, 256, h, w, generator=gen).to(dev, torch.bfloat16)
        ms = cuda_ms(lambda: gn.group_norm_relu(x, s, b), 50)
        per_level[f"{h}x{w}"] = ms
        total += GN_PER_LEVEL * ms
        y = torch.empty_like(x)  # the same bytes moved by a plain copy
        copy_ms[f"{h}x{w}"] = cuda_ms(lambda: y.copy_(x), 50)
    # host time of one K3 call at P7, where the kernel is shortest
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        gn.group_norm_relu(x, s, b)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print(json.dumps({
        "tag": args.tag, "repo": args.repo, "card": name, "k1": k1,
        "k2_ms": k2_ms, "k2_valid_picks": int(got[2].sum()),
        "k3_ms_per_forward": total, "k3_ms_per_launch": per_level,
        "copy_ms_per_launch": copy_ms,
        "k3_host_us_per_call": host_us,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
