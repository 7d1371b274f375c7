"""Serving export and load: a self-contained inference artifact (port of
paa_tpu/serving.py).

``export_inference`` traces a model's whole inference, from normalized
images to detections (backbone, heads, anchors, the static-shape
post-processing with its kernels), with ``torch.export`` at one static
input shape. The weights go into the artifact, the anchors as
constants, and the kernels K1, K2, K3 and K4 as the custom ops of
``paa_tpu_torch.ops`` (``paa_tpu_torch::nms_batched``, ``::nms``,
``::group_norm_relu``, ``::deform_im2col``), so that the artifact calls
the same kernels as the live model. The post-processing's data-dependent tier choice is a
``torch.cond`` in the artifact (modeling/paa_inference.py).

The file: the magic ``PAATORCH``, a little-endian u32 header length,
the JSON header (input and sizes shapes, output keys, the device it was
exported on), then the bytes of ``torch.export.save``. ``load_exported``
needs torch and the port's op library, not the config or the model
code. It runs on the card unless asked for the CPU.

Written by ``python -m paa_tpu_torch.tools.export_model``.
"""

from __future__ import annotations

import io
import json
import struct

import torch

from . import ops  # noqa: F401  registers the kernels' custom ops
from .ops.image_norm import maybe_device_normalize

_MAGIC = b"PAATORCH"


class _Inference(torch.nn.Module):
    """Normalize (float32 input passes through) and detect: the body of
    ``DetectionModel.make_eval_fn``'s eval_fn, without its host
    conversions."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.module = model.module  # the weights, as the module's state

    def forward(self, images, image_sizes):
        cfg = self.model.cfg
        x = maybe_device_normalize(images, image_sizes, cfg.INPUT.PIXEL_MEAN,
                                   cfg.INPUT.PIXEL_STD)
        return self.model.detect(x.permute(0, 3, 1, 2).contiguous(),
                                 image_sizes)


def export_inference(model, batch, hw):
    """Export ``model`` (a built detection model) at a static (batch,
    *hw) input on its device. Returns (exported, meta): a
    ``torch.export.ExportedProgram`` whose call takes float32 (batch, H,
    W, 3) normalized images and float32 (batch, 2) (h, w) sizes, and the
    JSON header."""
    model.module.eval()
    dev = model.device
    # the anchors made and cached now, outside the trace: the artifact
    # takes them as constants, and the live model keeps real tensors
    model.anchors_for(hw)
    images = torch.zeros(batch, *hw, 3, dtype=torch.float32, device=dev)
    sizes = torch.tensor([list(hw)] * batch, dtype=torch.float32,
                         device=dev)
    with torch.no_grad():
        exported = torch.export.export(_Inference(model), (images, sizes))
    # the example batch is not part of the artifact (103 MB of zeros at
    # 8 x 800 x 1344 in float32)
    exported.example_inputs = None
    meta = {
        "input_shape": [batch, *hw, 3],
        "sizes_shape": [batch, 2],
        "device": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "outputs": list(exported.call_spec.out_spec.context),
    }
    return exported, meta


def save_exported(path, exported, meta):
    """magic | u32 header length | JSON header | torch.export.save bytes."""
    header = json.dumps(meta).encode()
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(buf.getvalue())


def load_exported(path, device=None):
    """(call, meta): ``call(images, sizes)`` -> the detection dict, on
    ``device`` (default: the card; "cpu" asks for the CPU). Raises
    ValueError for a file that is not such an artifact."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "load_exported runs on a CUDA device; none is available. "
                "Pass device='cpu' to run on the CPU.")
        device = "cuda"
    device = torch.device(device)
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a paa_tpu_torch serving artifact")
        (hlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(hlen).decode())
        exported = torch.export.load(io.BytesIO(f.read()))
    if meta["device"] != device.type:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    module = exported.module()

    def call(images, image_sizes):
        with torch.inference_mode():
            return module(torch.as_tensor(images).to(device),
                          torch.as_tensor(image_sizes).to(device))

    return call, meta
