"""Weights and inputs made from ``--seed``, on the device, in a few large
draws. The same seed gives the same tensors on the same device.

A configuration's ``weights`` rules name, by a regular expression on the
state-dict name, how each tensor is drawn; the first rule that matches
wins:

- ``kaiming_uniform``: uniform in +-sqrt(3 / fan_in), fan_in =
  C/groups * kh * kw (a 4-D conv weight);
- ``normal``: normal(0, ``std``);
- ``uniform``: uniform in [``low``, ``high``);
- ``const``: every element ``value``.

A rule's ``seed_offset`` (default 0) draws from its own generator,
seeded ``seed + seed_offset``. Every tensor of one (rule kind, seed
offset) comes from one draw, sliced in state-dict order.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

# generator seeds of the data, beside the weights' (seed + 0) and the
# rules' own offsets
IMAGES_OFFSET = 2
GT_STREAM = 3


def _rule(name, rules):
    for r in rules:
        if re.search(r["match"], name):
            return r
    raise KeyError(f"no weights rule matches {name!r}")


def make_weights(shapes, rules, seed, device):
    """{name: float32 tensor on ``device``} for ``shapes`` ({name:
    shape}, the state dict's order)."""
    groups = {}
    for name, shape in shapes.items():
        r = _rule(name, rules)
        key = (r["init"], r.get("seed_offset", 0))
        groups.setdefault(key, []).append((name, tuple(shape), r))
    out = {}
    for (init, offset), members in groups.items():
        if init == "const":
            for name, shape, r in members:
                out[name] = torch.full(shape, float(r["value"]),
                                       device=device)
            continue
        gen = torch.Generator(device=device).manual_seed(seed + offset)
        total = sum(math.prod(s) for _, s, _ in members)
        if init == "normal":
            flat = torch.randn(total, generator=gen, device=device)
        else:
            flat = torch.rand(total, generator=gen, device=device)
        at = 0
        for name, shape, r in members:
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            at += n
            if init == "normal":
                t = t * r["std"]
            elif init == "uniform":
                t = r["low"] + (r["high"] - r["low"]) * t
            elif init == "kaiming_uniform":
                if len(shape) != 4:
                    raise ValueError(f"{name}: kaiming_uniform of {shape}")
                bound = math.sqrt(3.0 / math.prod(shape[1:]))
                t = (2 * t - 1) * bound
            else:
                raise ValueError(f"{name}: unknown init {init!r}")
            out[name] = t.clone()
    return {name: out[name] for name in shapes}


def content_mask(images, content_hw):
    """Zero each image beyond its content (the loader's padding)."""
    h, w = content_hw
    images[:, h:] = 0
    images[:, :, w:] = 0
    return images


def image_pool(traffic, seed, device):
    """``pool`` batches of uint8 (B, H, W, 3) images, each on the host,
    drawn on ``device`` from ``seed + IMAGES_OFFSET``, the padding
    beyond the content zero; and the (B, 2) content sizes."""
    gen = torch.Generator(device=device).manual_seed(seed + IMAGES_OFFSET)
    b, (h, w) = traffic["batch"], traffic["hw"]
    sizes = torch.tensor([traffic["content_hw"]] * b, dtype=torch.float32)
    pool = []
    for _ in range(traffic["pool"]):
        x = torch.randint(0, 256, (b, h, w, 3), generator=gen,
                          dtype=torch.uint8, device=device)
        pool.append((content_mask(x, traffic["content_hw"]).cpu(),
                     sizes.clone()))
    return pool


def gt_pool(traffic, seed, num_classes):
    """GT boxes and labels of every image of the pool, in ``slots``
    padded rows: the counts are the fixed list ``gt_counts`` repeated
    over the pool's images and shuffled by the seed, so every seed
    gives the same number of GTs; sqrt(area) log-uniform in ``gt_side``
    (pixels, then a share of the content's shorter side), aspect ratio
    log-uniform in ``gt_aspect``, inside the content; labels uniform in
    1..num_classes."""
    rng = np.random.default_rng([seed, GT_STREAM])
    n_img = traffic["pool"] * traffic["batch"]
    h, w = traffic["content_hw"]
    slots = traffic["slots"]
    counts = np.resize(np.asarray(traffic["gt_counts"]), n_img)
    counts = rng.permutation(counts)
    boxes = np.zeros((n_img, slots, 4), np.float32)
    labels = np.zeros((n_img, slots), np.int32)
    lo, hi_share = traffic["gt_side"]
    a_lo, a_hi = traffic["gt_aspect"]
    for i, n in enumerate(counts):
        side = np.exp(rng.uniform(np.log(lo), np.log(hi_share * min(h, w)),
                                  n))
        aspect = np.exp(rng.uniform(np.log(a_lo), np.log(a_hi), n))
        bw, bh = side * np.sqrt(aspect), side / np.sqrt(aspect)
        x1 = rng.uniform(0, w - 1 - bw)
        y1 = rng.uniform(0, h - 1 - bh)
        boxes[i, :n] = np.stack([x1, y1, x1 + bw, y1 + bh], 1)
        labels[i, :n] = rng.integers(1, num_classes + 1, n)
    b = traffic["batch"]
    return [(torch.from_numpy(boxes[k * b:(k + 1) * b]),
             torch.from_numpy(labels[k * b:(k + 1) * b]))
            for k in range(traffic["pool"])]
