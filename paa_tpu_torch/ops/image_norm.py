"""On-device image normalization for uint8 input batches (port of
paa_tpu/ops/image_norm.py).

The host ships the padded batch as raw uint8 and the device casts,
normalizes and re-zeroes the padding. The result is bit-identical to
the JAX package's: the uint8->float32 cast is exact, the op order is
``(x - mean)`` then ``/ std`` (skipped when every std is 1), and the
padding is forced back to 0.0.
"""

from __future__ import annotations

import numpy as np
import torch

# the span around the copy of a host batch to the device (pageable: the
# host waits for it), in ``make_eval_fn``'s call and the train step's
# input; the benchmark's serve.sync_idle_ms and train.sync_idle_ms read
# the idle gaps that open inside it, as inside every ``sync/`` span
SPAN_SYNC_H2D = "sync/h2d_copy"


def device_normalize(images, image_sizes, pixel_mean, pixel_std):
    """(B, H, W, 3) uint8 + per-image valid (h, w) -> normalized float32
    (B, H, W, 3) with zeroed padding."""
    x = images.to(torch.float32)
    mean = torch.as_tensor(pixel_mean, dtype=torch.float32, device=x.device)
    x = x - mean
    std = np.asarray(pixel_std, np.float32)
    if np.any(std != 1.0):  # x / 1.0 == x: the host path skips it too
        x = x / torch.as_tensor(std, device=x.device)
    h, w = images.shape[1:3]
    sizes = image_sizes.to(torch.float32)
    ys = torch.arange(h, dtype=torch.float32, device=x.device)
    xs = torch.arange(w, dtype=torch.float32, device=x.device)
    valid = (ys[None, :, None] < sizes[:, 0, None, None]) & (
        xs[None, None, :] < sizes[:, 1, None, None]
    )
    return torch.where(valid[..., None], x, torch.zeros((), device=x.device))


def maybe_device_normalize(images, image_sizes, pixel_mean, pixel_std):
    """uint8 batches normalize on the device; float32 batches (already
    normalized on the host) pass through."""
    if images.dtype == torch.uint8:
        if image_sizes is None:
            raise ValueError(
                "uint8 image batches require image_sizes to re-zero "
                "the padded region on device"
            )
        return device_normalize(images, image_sizes, pixel_mean, pixel_std)
    return images
