#!/usr/bin/env python3
"""Time the PyTorch port's K2 (box-head NMS) and K3 (GroupNorm+ReLU) of
one checkout on an NVIDIA GPU, to compare two designs on one card.

    python3 kernel_ab.py [--repo PATH] [--tag NAME]

Imports ``paa_tpu_torch`` from PATH (default: this file's directory),
builds its kernels there, and times them with CUDA events (each run of
calls queued behind a device-side sleep, so that host launch time does
not show) on inputs made from fixed seeds, so two checkouts see the same
data:

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
clusters of each size K2's cluster route runs at once. To compare
checkouts A and B, run it in turns on one card (A, B, B, A); each run
is its own process, since both checkouts name their package
``paa_tpu_torch``. The timing helpers come from this checkout's
chip_smoke.py.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from chip_smoke import GN_PER_LEVEL, TOWER_HW, card, cuda_ms


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
    if args.k2_occupancy:
        cap = nms.k2_capacity(dev)
        lib = nms._k2_lib()
        print(json.dumps({
            "k2_capacity": cap, "card": name,
            "max_active_clusters_by_cs": {
                cs: lib.paa_nms_cluster_max_active(cs, cs * cap)
                for cs in range(1, nms.K2_MAX_CLUSTER + 1)}}))
        return 0

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
        "tag": args.tag, "repo": args.repo, "card": name,
        "k2_ms": k2_ms, "k2_valid_picks": int(got[2].sum()),
        "k3_ms_per_forward": total, "k3_ms_per_launch": per_level,
        "copy_ms_per_launch": copy_ms,
        "k3_host_us_per_call": host_us,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
