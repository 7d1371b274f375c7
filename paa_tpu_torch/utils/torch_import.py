"""Weight import from the reference's checkpoints into the port's modules
(port of paa_tpu/utils/torch_import.py; reference
paa_core/utils/{c2_model_loading,model_serialization,checkpoint}.py).

- ``load_torch_state_dict(module, state_dict)``: a ``paa_core`` state
  dict (the released PAA_R_50_FPN_1x ``.pth``, a Faster R-CNN
  R-50-FPN one, the dcnv2 and ResNeXt PAA ones) -> the port's module,
  for the R-50/R-101/R-152 and ResNeXt bodies with or without DCN, both
  FPN wirings (P6 from P5 or C5), the PAA, ATSS and FCOS heads (DCN
  tower included), the RPN head, the FPN2MLP and Xconv box heads, the
  mask and keypoint heads, the C4 models (their body under
  ``backbone.body``, the res5 box head ``roi_heads.box.
  feature_extractor.head.layer4``, the C4 mask predictor or the
  unshared mask head), the GN models (below) and the RPN-only models. A
  RetinaNet head's towers raise (``_check_tower_layout``).
- ``load_c2_pickle(module, path)``: a Detectron ``.pkl`` (an ImageNet
  body, or a Caffe2Detectron detection model's FPN, RPN, box head, mask
  head and keypoint head). A C4 model takes the res5 blobs into its box
  head.
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
``head.scale3.scale``), so the reference keys are renamed. Four places
change more than the name:

- fc6's input columns. The reference flattens the pooled ROI features
  in NCHW order (c * R * R + h * R + w), the port in (R, R, C) order
  (modeling/roi_box_head.py), so fc6's weight columns are permuted with
  the box head's pooler resolution R;
- ``rpn.head.scales.N.scale`` has shape (1,), the port's
  ``head.scaleN.scale`` shape ();
- the towers' ``Sequential`` indices 3i and 3i + 1 are the conv and the
  GroupNorm of block i (3i + 2 is the parameter-free ReLU);
- the GN layouts (make_layers.py): FPN's ``fpn_innerN``/``fpn_layerN``,
  the box head's ``fc6``/``fc7`` and the mask head's ``mask_fcnN`` are
  ``Sequential(layer, GroupNorm)`` with GN, so index 0 is the layer and
  index 1 the port's ``*_gn``; the Xconv head's ``xconvs`` is one
  ``Sequential`` of [conv, GroupNorm, ReLU] per block with GN (conv at
  3i, GN at 3i + 1) and [conv, ReLU] without (conv at 2i): which, the
  file says by an ``xconvs.1.weight`` (``load_torch_state_dict`` looks
  before it maps). fc6's columns are permuted as FPN2MLP's. A GN body's
  ``bnX.weight``/``bias`` (no running statistics) and Detectron's
  ``_gn_s``/``_gn_b`` blobs land on its GroupNorm32 of the same name;
- ``mask_fcn_logits`` has NUM_CLASSES output channels in the reference
  and C - 1 in the port (and the JAX package), which drop channel 0:
  the reference's loss and inference never read it. ``conv5_mask`` and
  ``kps_score_lowres`` (ConvTranspose2d) keep torch's layout, so they
  copy as they are.

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
# (the FPN bodies live under ``backbone.resnet``, the C4 bodies under
# ``backbone.body``; a body's res5 fills the C4 box head's when the body
# has none)
_BODY = (r"backbone.resnet.", r"backbone.body.")
_RES5 = (r"box_head.",)
_RULES = [
    (r"backbone\.body\.stem\.(conv1\.weight|bn1\.\w+)",
     tuple(b + r"stem.\1" for b in _BODY), "copy"),
    (r"backbone\.body\.layer(4)\.(\d+)\.(conv\d\.weight|bn\d\.\w+)",
     tuple(b + r"layer\1_\2.\3" for b in _BODY + _RES5), "copy"),
    (r"backbone\.body\.layer(\d)\.(\d+)\.(conv\d\.weight|bn\d\.\w+)",
     tuple(b + r"layer\1_\2.\3" for b in _BODY), "copy"),
    # a DCN block's DFConv2d (layers/misc.py:113-185): the sampled conv
    # under ``.conv``, the offset conv under ``.offset``; the port's
    # DeformConv keeps the former's weight on conv2 itself
    (r"backbone\.body\.layer(\d)\.(\d+)\.conv2\.conv\.weight",
     (r"backbone.resnet.layer\1_\2.conv2.weight",), "copy"),
    (r"backbone\.body\.layer(\d)\.(\d+)\.conv2\.offset\.(weight|bias)",
     (r"backbone.resnet.layer\1_\2.conv2.offset.\3",), "copy"),
    (r"backbone\.body\.layer(\d)\.(\d+)\.downsample\.0\.weight",
     tuple(b + r"layer\1_\2.downsample_conv.weight"
           for b in _BODY + _RES5), "copy"),
    (r"backbone\.body\.layer(\d)\.(\d+)\.downsample\.1\.(\w+)",
     tuple(b + r"layer\1_\2.downsample_bn.\3" for b in _BODY + _RES5),
     "copy"),
    # the C4 box head's res5 (ResNet50Conv5ROIFeatureExtractor; the C4
    # Mask R-CNN's mask branch shares it, under roi_heads.mask too)
    (r"roi_heads\.(?:box|mask)\.feature_extractor\.head\.layer4\.(\d+)\."
     r"(conv\d\.weight|bn\d\.\w+)", (r"box_head.layer4_\1.\2",), "copy"),
    (r"roi_heads\.(?:box|mask)\.feature_extractor\.head\.layer4\.(\d+)\."
     r"downsample\.0\.weight", (r"box_head.layer4_\1.downsample_conv.weight",),
     "copy"),
    (r"roi_heads\.(?:box|mask)\.feature_extractor\.head\.layer4\.(\d+)\."
     r"downsample\.1\.(\w+)", (r"box_head.layer4_\1.downsample_bn.\2",),
     "copy"),
    (r"backbone\.fpn\.(fpn_inner\d|fpn_layer\d)(?:\.0)?\.(weight|bias)",
     (r"backbone.fpn.\1.\2",), "copy"),
    (r"backbone\.fpn\.(fpn_inner\d|fpn_layer\d)\.1\.(weight|bias)",
     (r"backbone.fpn.\1_gn.\2",), "copy"),
    (r"backbone\.fpn\.top_blocks\.(p6|p7)\.(weight|bias)",
     (r"backbone.fpn.\1.\2",), "copy"),
    # the PAA head and the RPN head share the reference's "rpn.head"
    (r"rpn\.head\.(cls_logits|bbox_pred)\.(weight|bias)",
     (r"head.\1.\2", r"rpn_head.\1.\2"), "copy"),
    # PAA's IoU branch; ATSS's and FCOS's centerness branch
    (r"rpn\.head\.(iou_pred|centerness)\.(weight|bias)",
     (r"head.\1.\2",), "copy"),
    (r"rpn\.head\.scales\.(\d+)\.scale", (r"head.scale\1.scale",), "scalar"),
    (r"rpn\.head\.conv\.(weight|bias)", (r"rpn_head.conv.\1",), "copy"),
    (r"roi_heads\.box\.feature_extractor\.fc6(?:\.0)?\.weight",
     ("box_head.fc6.weight",), "fc_nchw"),
    (r"roi_heads\.box\.feature_extractor\.fc(6|7)(?:\.0)?\.(weight|bias)",
     (r"box_head.fc\1.\2",), "copy"),
    (r"roi_heads\.box\.feature_extractor\.fc(6|7)\.1\.(weight|bias)",
     (r"box_head.fc\1_gn.\2",), "copy"),
    (r"roi_heads\.box\.predictor\.(cls_score|bbox_pred)\.(weight|bias)",
     (r"box_head.\1.\2",), "copy"),
    (r"roi_heads\.mask\.feature_extractor\.(mask_fcn\d)(?:\.0)?\."
     r"(weight|bias)", (r"mask_head.\1.\2",), "copy"),
    (r"roi_heads\.mask\.feature_extractor\.(mask_fcn\d)\.1\.(weight|bias)",
     (r"mask_head.\1_gn.\2",), "copy"),
    (r"roi_heads\.mask\.predictor\.conv5_mask\.(weight|bias)",
     (r"mask_head.conv5_mask.\1",), "copy"),
    (r"roi_heads\.mask\.predictor\.mask_fcn_logits\.(weight|bias)",
     (r"mask_head.mask_fcn_logits.\1",), "drop_background"),
    (r"roi_heads\.keypoint\.feature_extractor\.(conv_fcn\d+)\."
     r"(weight|bias)", (r"keypoint_head.\1.\2",), "copy"),
    (r"roi_heads\.keypoint\.predictor\.kps_score_lowres\.(weight|bias)",
     (r"keypoint_head.kps_score_lowres.\1",), "copy"),
]
_RULES = [(re.compile(p), t, k) for p, t, k in _RULES]
# the towers' Sequential slots; a DCN tower conv (USE_DCN_IN_TOWER) is a
# DFConv2d with ``.conv`` and ``.offset`` children
_TOWER = re.compile(r"rpn\.head\.(cls_tower|bbox_tower)\.(\d+)\."
                    r"(?:(conv|offset)\.)?(weight|bias)")
# the Xconv box head's stacked convs, one Sequential
_XCONVS = re.compile(r"roi_heads\.box\.feature_extractor\.xconvs\.(\d+)\."
                     r"(weight|bias)")


def xconvs_have_gn(names):
    """Whether a file's ``xconvs`` Sequential is the GN layout ([conv,
    GroupNorm, ReLU] per block): its index 1 then holds a weight (the
    first GroupNorm's), which is a ReLU without GN."""
    return any(n.endswith("feature_extractor.xconvs.1.weight")
               for n in names)


def torch_name_to_port_keys(name, xconv_gn=False):
    """[(port state-dict key, transform), ...] for a reference key, the
    likeliest first; [] when the port has no counterpart. An optional
    ``module.`` prefix (a DistributedDataParallel checkpoint) is
    accepted. ``xconv_gn``: the file's ``xconvs`` are the GN layout
    (``xconvs_have_gn``)."""
    if name.startswith("module."):
        name = name[len("module."):]
    m = _XCONVS.fullmatch(name)
    if m:
        block, within = divmod(int(m.group(1)), 3 if xconv_gn else 2)
        if within > int(xconv_gn):  # a ReLU
            return []
        sub = "_gn" if within else ""
        return [(f"box_head.xconv{block + 1}{sub}.{m.group(2)}", "copy")]
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
    if kind == "drop_background":
        return value[1:]
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


def _check_tower_layout(writer, names):
    """Raise on a head whose towers have no GroupNorm (RetinaNet's
    ``PlainTower``) when the file has tower keys: the reference RetinaNet
    head's towers are ``Sequential(conv, ReLU, ...)``, conv i at index
    2i, which the GroupNorm towers' rule (conv at 3i, GroupNorm at 3i +
    1) would write into the wrong convs."""
    if "head.cls_tower.conv0.weight" not in writer.targets or \
            "head.cls_tower.gn0.weight" in writer.targets:
        return
    if any(_TOWER.fullmatch(n.removeprefix("module.")) for n in names):
        raise NotImplementedError(
            "paa_tpu_torch does not import the reference RetinaNet head's "
            "towers (conv i at Sequential index 2i); paa_tpu's mapping "
            "reads them as GroupNorm towers (ROADMAP section 3)")


def load_torch_state_dict(module, state_dict, logger=None):
    """Copy a reference-keyed state dict (torch tensors or numpy arrays)
    into ``module`` in place; returns (skipped, unwritten)."""
    writer = _Writer(module)
    _check_tower_layout(writer, state_dict)
    xconv_gn = xconvs_have_gn(state_dict)
    skipped = [name for name, value in state_dict.items()
               if not writer.write(torch_name_to_port_keys(name, xconv_gn),
                                   value)]
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
    ResNet bodies, the FPN laterals and outputs, the RPN head, the
    FPN2MLP box head, the mask head (Detectron names its convs
    ``_[mask]_fcnN``) and the keypoint head; optimizer momenta,
    ``weight_order`` and the ImageNet classifier map to nothing
    (c2_model_loading.py:119-123)."""
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
    m = re.fullmatch(r"_\[mask\]_fcn(\d)_([wb])", name)
    if m:
        return [f"roi_heads.mask.feature_extractor.mask_fcn{m.group(1)}."
                f"{_leaf(m.group(2))}"]
    m = re.fullmatch(r"(mask_fcn_logits|conv5_mask)_([wb])", name)
    if m:
        return [f"roi_heads.mask.predictor.{m.group(1)}.{_leaf(m.group(2))}"]
    m = re.fullmatch(r"conv_fcn(\d+)_([wb])", name)
    if m:
        return [f"roi_heads.keypoint.feature_extractor.conv_fcn"
                f"{m.group(1)}.{_leaf(m.group(2))}"]
    m = re.fullmatch(r"kps_score_lowres_([wb])", name)
    if m:
        return [f"roi_heads.keypoint.predictor.kps_score_lowres."
                f"{_leaf(m.group(1))}"]
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
