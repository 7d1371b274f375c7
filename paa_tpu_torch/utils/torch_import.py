"""Weight import from the reference's checkpoints into the port's modules
(port of paa_tpu/utils/torch_import.py; reference
paa_core/utils/{c2_model_loading,model_serialization,checkpoint}.py).

- ``load_torch_state_dict(module, state_dict)``: a ``paa_core`` state
  dict (the released PAA_R_50_FPN_1x ``.pth``, a Faster R-CNN
  R-50-FPN one, the dcnv2 and ResNeXt PAA ones) -> the port's module,
  for the R-50/R-101/R-152 and ResNeXt bodies with or without DCN, both
  FPN wirings, the PAA head (DCN tower included), the RPN head and the
  FPN2MLP box head.
- ``load_c2_pickle(module, path)``: a Detectron ``.pkl`` (an ImageNet
  body, or a Caffe2Detectron detection model's FPN, RPN and box head).
  A DCN block's sampled conv takes the plain ``branch2b`` blob; its
  offset conv has no blob and keeps its zero init, as DFConv2d's does
  (the reference renames conv2 to conv2.conv, c2_model_loading.py:
  148-166). A body deeper than the pickle's (the X-152 config loads
  X-101 weights) keeps its init in the blocks the pickle lacks, which
  come back in ``unwritten``.
- ``load_pretrained_into(cfg, module, weight)``: the DetectronCheckpointer
  dispatch on ``MODEL.WEIGHT`` (``catalog://``, ``http(s)://``, ``.pkl``,
  else a torch checkpoint).

Each returns ``(skipped, unwritten)``: the names of the file it matched
to no port tensor, and the port's state-dict keys it never wrote.

The port's tensors carry the JAX package's scope names
(``backbone.resnet.layer1_0.conv1.weight``, ``head.cls_tower.conv0``,
``head.scale3.scale``), so the reference keys are renamed. Three places
change more than the name:

- fc6's input columns. The reference flattens the pooled ROI features
  in NCHW order (c * R * R + h * R + w), the port in (R, R, C) order
  (modeling/roi_box_head.py), so fc6's weight columns are permuted with
  the box head's pooler resolution R;
- ``rpn.head.scales.N.scale`` has shape (1,), the port's
  ``head.scaleN.scale`` shape ();
- the towers' ``Sequential`` indices 3i and 3i + 1 are the conv and the
  GroupNorm of block i (3i + 2 is the parameter-free ReLU).

FrozenBatchNorm has no epsilon in either, so its four tensors copy as
they are; a tensor the file lacks keeps the module's value (at init,
weight and running_var 1, bias and running_mean 0). Detectron pickles
carry BatchNorm pre-folded into s and b, so their running statistics
stay at 0 and 1.
"""

from __future__ import annotations

import os
import pickle
import re

import numpy as np
import torch

# (reference key regex, port key template(s), transform); the first rule
# whose regex matches gives the candidates, tried in order
_RULES = [
    (r"backbone\.body\.stem\.(conv1\.weight|bn1\.\w+)",
     (r"backbone.resnet.stem.\1",), "copy"),
    (r"backbone\.body\.layer(\d)\.(\d+)\.(conv\d\.weight|bn\d\.\w+)",
     (r"backbone.resnet.layer\1_\2.\3",), "copy"),
    # a DCN block's DFConv2d (layers/misc.py:113-185): the sampled conv
    # under ``.conv``, the offset conv under ``.offset``; the port's
    # DeformConv keeps the former's weight on conv2 itself
    (r"backbone\.body\.layer(\d)\.(\d+)\.conv2\.conv\.weight",
     (r"backbone.resnet.layer\1_\2.conv2.weight",), "copy"),
    (r"backbone\.body\.layer(\d)\.(\d+)\.conv2\.offset\.(weight|bias)",
     (r"backbone.resnet.layer\1_\2.conv2.offset.\3",), "copy"),
    (r"backbone\.body\.layer(\d)\.(\d+)\.downsample\.0\.weight",
     (r"backbone.resnet.layer\1_\2.downsample_conv.weight",), "copy"),
    (r"backbone\.body\.layer(\d)\.(\d+)\.downsample\.1\.(\w+)",
     (r"backbone.resnet.layer\1_\2.downsample_bn.\3",), "copy"),
    (r"backbone\.fpn\.(fpn_inner\d|fpn_layer\d)\.(weight|bias)",
     (r"backbone.fpn.\1.\2",), "copy"),
    (r"backbone\.fpn\.top_blocks\.(p6|p7)\.(weight|bias)",
     (r"backbone.fpn.\1.\2",), "copy"),
    # the PAA head and the RPN head share the reference's "rpn.head"
    (r"rpn\.head\.(cls_logits|bbox_pred)\.(weight|bias)",
     (r"head.\1.\2", r"rpn_head.\1.\2"), "copy"),
    (r"rpn\.head\.iou_pred\.(weight|bias)", (r"head.iou_pred.\1",), "copy"),
    (r"rpn\.head\.scales\.(\d+)\.scale", (r"head.scale\1.scale",), "scalar"),
    (r"rpn\.head\.conv\.(weight|bias)", (r"rpn_head.conv.\1",), "copy"),
    (r"roi_heads\.box\.feature_extractor\.fc6\.weight",
     ("box_head.fc6.weight",), "fc_nchw"),
    (r"roi_heads\.box\.feature_extractor\.fc(6|7)\.(weight|bias)",
     (r"box_head.fc\1.\2",), "copy"),
    (r"roi_heads\.box\.predictor\.(cls_score|bbox_pred)\.(weight|bias)",
     (r"box_head.\1.\2",), "copy"),
]
_RULES = [(re.compile(p), t, k) for p, t, k in _RULES]
# the towers' Sequential slots; a DCN tower conv (USE_DCN_IN_TOWER) is a
# DFConv2d with ``.conv`` and ``.offset`` children
_TOWER = re.compile(r"rpn\.head\.(cls_tower|bbox_tower)\.(\d+)\."
                    r"(?:(conv|offset)\.)?(weight|bias)")


def torch_name_to_port_keys(name):
    """[(port state-dict key, transform), ...] for a reference key, the
    likeliest first; [] when the port has no counterpart. An optional
    ``module.`` prefix (a DistributedDataParallel checkpoint) is
    accepted."""
    if name.startswith("module."):
        name = name[len("module."):]
    m = _TOWER.fullmatch(name)
    if m:
        tower, idx, child, leaf = m.groups()
        block, within = divmod(int(idx), 3)
        if within == 2 or (child and within):  # the ReLU has no parameters
            return []
        sub = "conv" if within == 0 else "gn"
        offset = ".offset" if child == "offset" else ""
        return [(f"head.{tower}.{sub}{block}{offset}.{leaf}", "copy")]
    for pattern, templates, kind in _RULES:
        m = pattern.fullmatch(name)
        if m:
            return [(m.expand(t), kind) for t in templates]
    return []


def _fc_nchw_to_port(w, resolution):
    """fc6 weight (out, C * R * R), columns in NCHW-flatten order
    (c * R * R + h * R + w) -> the port's (R, R, C) order
    (h * R * C + w * C + c)."""
    out_dim, in_dim = w.shape
    r = resolution
    if in_dim % (r * r):
        raise ValueError(
            f"fc6 input width {in_dim} is not a multiple of the pooler "
            f"resolution squared ({r * r})")
    return (w.reshape(out_dim, in_dim // (r * r), r, r)
            .permute(0, 2, 3, 1).reshape(out_dim, in_dim))


def _transform(value, kind, module, key):
    if kind == "scalar":
        return value.reshape(())
    if kind == "fc_nchw":
        owner = module.get_submodule(key.rsplit(".", 2)[0])
        return _fc_nchw_to_port(value, owner.resolution)
    return value


def _as_tensor(value):
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.ascontiguousarray(value))


class _Writer:
    """Writes file tensors into ``module``'s parameters and buffers (in
    place, on their device and in their dtype), counting what it wrote."""

    def __init__(self, module):
        self.module = module
        self.targets = module.state_dict(keep_vars=True)
        self.written = set()

    def write(self, candidates, value):
        """Write ``value`` to the first candidate key the module has with
        the shape the transformed value takes; False when none fits."""
        value = _as_tensor(value)
        for key, kind in candidates:
            target = self.targets.get(key)
            if target is None:
                continue
            v = _transform(value, kind, self.module, key)
            if tuple(v.shape) != tuple(target.shape):
                continue
            with torch.no_grad():
                target.copy_(v)
            self.written.add(key)
            return True
        return False

    def unwritten(self):
        return sorted(set(self.targets) - self.written)


def _report(logger, what, matched, skipped, unwritten):
    if logger:
        logger.info(f"{what}: matched {matched} tensors, skipped "
                    f"{len(skipped)}, {len(unwritten)} port tensors not "
                    f"written")
        for name in skipped[:20]:
            logger.info(f"  skipped: {name}")


def load_torch_state_dict(module, state_dict, logger=None):
    """Copy a reference-keyed state dict (torch tensors or numpy arrays)
    into ``module`` in place; returns (skipped, unwritten)."""
    writer = _Writer(module)
    skipped = [name for name, value in state_dict.items()
               if not writer.write(torch_name_to_port_keys(name), value)]
    unwritten = writer.unwritten()
    _report(logger, "torch import", len(state_dict) - len(skipped),
            skipped, unwritten)
    return skipped, unwritten


_C2_SKIP = re.compile(r"(_momentum|weight_order|^fc1000_|^pred_[wb]$)")
_BRANCH2 = {"a": 1, "b": 2, "c": 3}


def c2_blob_to_torch_names(name):
    """A Detectron blob name -> the reference torch state-dict names it
    may fill, the likeliest first (c2_model_loading.py:12-113 renames
    blobs to torch suffixes that model_serialization.py:10-58 then
    matches; this maps each blob to the full names directly). Covers the
    ResNet bodies, the FPN laterals and outputs, the RPN head and the
    FPN2MLP box head; optimizer momenta, ``weight_order`` and the
    ImageNet classifier map to nothing (c2_model_loading.py:119-123)."""
    if _C2_SKIP.search(name):
        return []
    if name == "conv1_w":
        return ["backbone.body.stem.conv1.weight"]
    m = re.fullmatch(r"(?:res_)?conv1_(?:bn|gn)_([sb])", name)
    if m:
        return [f"backbone.body.stem.bn1.{_leaf(m.group(1))}"]
    m = re.fullmatch(r"res(\d)_(\d+)_branch2([abc])_w", name)
    if m:
        s, b, br = m.groups()
        return [f"backbone.body.layer{int(s) - 1}.{b}.conv{_BRANCH2[br]}"
                f".weight"]
    m = re.fullmatch(r"res(\d)_(\d+)_branch2([abc])_(?:bn|gn)_([sb])", name)
    if m:
        s, b, br, sb = m.groups()
        return [f"backbone.body.layer{int(s) - 1}.{b}.bn{_BRANCH2[br]}."
                f"{_leaf(sb)}"]
    m = re.fullmatch(r"res(\d)_(\d+)_branch1_w", name)
    if m:
        s, b = m.groups()
        return [f"backbone.body.layer{int(s) - 1}.{b}.downsample.0.weight"]
    m = re.fullmatch(r"res(\d)_(\d+)_branch1_(?:bn|gn)_([sb])", name)
    if m:
        s, b, sb = m.groups()
        return [f"backbone.body.layer{int(s) - 1}.{b}.downsample.1."
                f"{_leaf(sb)}"]
    # FPN: the block index is the stage's last block; only the stage
    # names the level (c2_model_loading.py:66-75)
    m = re.fullmatch(r"fpn_inner_res(\d)_\d+_sum(?:_lateral)?_([wb])", name)
    if m:
        return [f"backbone.fpn.fpn_inner{int(m.group(1)) - 1}."
                f"{_leaf(m.group(2))}"]
    m = re.fullmatch(r"fpn_res(\d)_\d+_sum_([wb])", name)
    if m:
        return [f"backbone.fpn.fpn_layer{int(m.group(1)) - 1}."
                f"{_leaf(m.group(2))}"]
    # RPN (FPN checkpoints suffix the level the shared head was traced at)
    m = re.fullmatch(r"conv_rpn(?:_fpn\d)?_([wb])", name)
    if m:
        return [f"rpn.head.conv.{_leaf(m.group(1))}"]
    m = re.fullmatch(r"rpn_(cls_logits|bbox_pred)(?:_fpn\d)?_([wb])", name)
    if m:
        return [f"rpn.head.{m.group(1)}.{_leaf(m.group(2))}"]
    m = re.fullmatch(r"fc(6|7)_([wb])", name)
    if m:
        return [f"roi_heads.box.feature_extractor.fc{m.group(1)}."
                f"{_leaf(m.group(2))}"]
    m = re.fullmatch(r"(cls_score|bbox_pred)_([wb])", name)
    if m:
        return [f"roi_heads.box.predictor.{m.group(1)}.{_leaf(m.group(2))}"]
    return []


def _leaf(c2_suffix):
    """Detectron's s/w -> weight, b -> bias."""
    return "bias" if c2_suffix == "b" else "weight"


def load_c2_pickle(module, pkl_path, logger=None):
    """Copy a Detectron ``.pkl`` (``{"blobs": {...}}`` or the bare blob
    dict) into ``module`` in place; returns (skipped, unwritten). The
    pickle is read with ``encoding="latin1"`` (Python 2 pickles)."""
    with open(pkl_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if "blobs" in data:
        data = data["blobs"]
    writer = _Writer(module)
    skipped = []
    for name, value in data.items():
        value = np.asarray(value)
        if not any(writer.write(torch_name_to_port_keys(t), value)
                   for t in c2_blob_to_torch_names(name)):
            skipped.append(name)
    unwritten = writer.unwritten()
    _report(logger, "c2 import", len(data) - len(skipped), skipped,
            unwritten)
    return skipped, unwritten


def resolve_weight(weight):
    """The local file a MODEL.WEIGHT string names: ``catalog://`` through
    config/paths_catalog.py's ModelCatalog, ``http(s)://`` through the
    weight cache (utils/misc.py ``cache_url``, which reads no network).
    Raises FileNotFoundError when the file is not there."""
    if weight.startswith("catalog://"):
        from ..config.paths_catalog import ModelCatalog

        weight = ModelCatalog.get(weight[len("catalog://"):])
    if weight.startswith(("http://", "https://")):
        from .misc import cache_url

        weight = cache_url(weight)
    if not os.path.isfile(weight):
        raise FileNotFoundError(f"weight file not found: {weight}")
    return weight


def load_pretrained_into(cfg, module, weight, logger=None):
    """DetectronCheckpointer's dispatch on a MODEL.WEIGHT string: a
    ``.pkl`` through ``load_c2_pickle``, anything else as a torch
    checkpoint (``{"model": state_dict}`` or a bare state dict) through
    ``load_torch_state_dict``. Loads ``module`` in place and returns
    (skipped, unwritten). Raises when the file is missing or unreadable,
    or when none of its tensors fits the module."""
    path = resolve_weight(weight)
    if path.endswith(".pkl"):
        skipped, unwritten = load_c2_pickle(module, path, logger)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        skipped, unwritten = load_torch_state_dict(
            module, ckpt.get("model", ckpt), logger)
    if len(unwritten) == len(module.state_dict()):
        raise ValueError(
            f"{weight} ({path}): none of its tensors fits the "
            f"{cfg.MODEL.BACKBONE.CONV_BODY} model")
    return skipped, unwritten
