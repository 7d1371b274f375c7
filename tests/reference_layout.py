"""The reference's checkpoint layouts, written out from its module
definitions, to synthesize checkpoints from a seed without the reference
or any download. Imports only numpy; the CPU tests and chip_smoke.py
share it.

- ``paa_core`` state dicts (``{"model": state_dict}`` ``.pth`` files):
  the R-50/R-101 body (modeling/backbone/resnet.py: ``stem.conv1``,
  ``stem.bn1``, ``layer{1..4}.{b}.conv{1..3}``/``bn{1..3}``,
  ``downsample.0``/``.1`` on each stage's first block; ResNeXt's conv2
  of shape (mid, mid / groups, 3, 3); R-152's (3, 8, 36, 3) blocks; in a
  DCN stage, conv2 a DFConv2d, layers/misc.py:113-185, with the sampled
  conv under ``conv2.conv`` and the offset conv, dg * 9 * 3 outputs
  when modulated, else dg * 9 * 2, with a bias, under ``conv2.offset``),
  the FPN
  (fpn.py: ``fpn_inner{k}``/``fpn_layer{k}`` with k counted from 1
  over the body's stages, so 2..4 when the RetinaNet wiring skips C2,
  and ``top_blocks.p6``/``p7``), the PAA head (rpn/paa/paa.py: towers
  as ``Sequential``s of [conv, GroupNorm, ReLU] x 4, the last conv a
  modulated DFConv2d with bias under USE_DCN_IN_TOWER, ``cls_logits``,
  ``bbox_pred``, ``iou_pred``, ``scales.{l}.scale`` of shape (1,)), the
  RPN head (rpn/rpn.py: ``conv``, ``cls_logits``, ``bbox_pred``) and the
  FPN2MLP box head (roi_box_feature_extractors.py ``fc6``/``fc7``, fc6
  over the NCHW-flattened pooled features; roi_box_predictors.py
  ``cls_score``/``bbox_pred``) and the FPN mask head
  (roi_mask_feature_extractors.py ``mask_fcn{1..4}``, 3x3 with bias;
  roi_mask_predictors.py MaskRCNNC4Predictor ``conv5_mask``, a
  ConvTranspose2d of weight (in, out, 2, 2), and ``mask_fcn_logits``
  with NUM_CLASSES outputs, background included), the keypoint head
  (roi_keypoint_feature_extractors.py ``conv_fcn{1..8}``, 3x3 with bias;
  roi_keypoint_predictors.py ``kps_score_lowres``, a ConvTranspose2d of
  weight (in, K, 4, 4)) and the C4 models (the body's three stages; the
  res5 box head ResNet50Conv5ROIFeatureExtractor under
  ``roi_heads.box.feature_extractor.head.layer4.{0,1,2}``, to 8 x
  RES2_OUT_CHANNELS channels, and FastRCNNPredictor's ``cls_score`` and
  ``bbox_pred`` on its mean; the C4 Mask R-CNN's predictor alone, its
  feature extractor the box head's, which a checkpoint lists once more
  under ``roi_heads.mask.feature_extractor``:
  ``with_shared_mask_extractor``). FrozenBatchNorm has
  four tensors and no
  ``num_batches_tracked``. The GN models (configs/gn_baselines,
  make_layers.py): a GN body's ``bn*``/``downsample.1`` GroupNorms hold
  ``weight`` and ``bias`` alone; with FPN.USE_GN ``fpn_inner{k}`` /
  ``fpn_layer{k}`` are ``Sequential(conv, GroupNorm)`` (``.0.weight``,
  no bias; ``.1.weight``/``.1.bias``), and so are the box head's
  ``fc6``/``fc7`` with ROI_BOX_HEAD.USE_GN and the mask head's
  ``mask_fcn{i}`` with ROI_MASK_HEAD.USE_GN; FPNXconv1fcFeatureExtractor
  keeps its convs in one ``xconvs`` Sequential, [conv, GroupNorm, ReLU]
  per block with GN and [conv (with bias), ReLU] without, then ``fc6``
  over the NCHW-flattened conv output. The RPN-only model has the body,
  the FPN (on an FPN body) and the RPN head alone. The anchor
  generators' ``cell_anchors`` buffers, which the port computes, are
  left out.
- Detectron ImageNet pickles (``{"blobs": {...}}``): the body's
  ``conv1_w``, ``res_conv1_bn_{s,b}``, ``res{2..5}_{b}_branch2{a,b,c}_w``
  and ``_bn_{s,b}``, ``res{s}_0_branch1_*``, with BatchNorm folded into
  s and b, and the classifier ``pred_{w,b}``.
"""

from collections import OrderedDict

import numpy as np

BLOCKS = {"R-50": (3, 4, 6, 3), "R-101": (3, 4, 23, 3),
          "R-152": (3, 8, 36, 3)}


def _bn(out, prefix, channels, gn=False):
    """A FrozenBatchNorm's four tensors, or a GroupNorm's two."""
    leaves = ("weight", "bias") if gn else (
        "weight", "bias", "running_mean", "running_var")
    for leaf in leaves:
        out[f"{prefix}.{leaf}"] = (channels,)


def _dfconv(out, prefix, cin, cout, groups, dg, modulated, bias):
    """A DFConv2d's keys: the sampled conv and the offset conv."""
    out[f"{prefix}.conv.weight"] = (cout, cin // groups, 3, 3)
    if bias:
        out[f"{prefix}.conv.bias"] = (cout,)
    out[f"{prefix}.offset.weight"] = (dg * 9 * (3 if modulated else 2),
                                      cin, 3, 3)
    out[f"{prefix}.offset.bias"] = (dg * 9 * (3 if modulated else 2),)


def resnet_keys(blocks, stem_out=64, res2_out=256, width=64, groups=1,
                stage_with_dcn=(False,) * 4, modulated=False, dg=1,
                gn=False):
    """The body's keys and shapes (either stride placement: it moves no
    tensor); ``gn``: GroupNorm in every norm's place."""
    out = OrderedDict()
    out["backbone.body.stem.conv1.weight"] = (stem_out, 3, 7, 7)
    _bn(out, "backbone.body.stem.bn1", stem_out, gn)
    cin = stem_out
    for i, count in enumerate(blocks):
        mid, cout = groups * width * 2 ** i, res2_out * 2 ** i
        for b in range(count):
            p = f"backbone.body.layer{i + 1}.{b}"
            out[f"{p}.conv1.weight"] = (mid, cin, 1, 1)
            _bn(out, f"{p}.bn1", mid, gn)
            if stage_with_dcn[i]:
                _dfconv(out, f"{p}.conv2", mid, mid, groups, dg, modulated,
                        bias=False)
            else:
                out[f"{p}.conv2.weight"] = (mid, mid // groups, 3, 3)
            _bn(out, f"{p}.bn2", mid, gn)
            out[f"{p}.conv3.weight"] = (cout, mid, 1, 1)
            _bn(out, f"{p}.bn3", cout, gn)
            if b == 0:
                out[f"{p}.downsample.0.weight"] = (cout, cin, 1, 1)
                _bn(out, f"{p}.downsample.1", cout, gn)
            cin = cout
    return out


def _layer(out, prefix, shape, gn):
    """conv_with_kaiming_uniform / make_fc / make_conv3x3: the layer with
    a bias, or with ``gn`` Sequential(layer without bias, GroupNorm)."""
    if gn:
        out[f"{prefix}.0.weight"] = shape
        _bn(out, f"{prefix}.1", shape[0], gn=True)
    else:
        out[f"{prefix}.weight"] = shape
        out[f"{prefix}.bias"] = (shape[0],)


def fpn_keys(retina, res2_out, channels, p6_from_c5=False, gn=False):
    out = OrderedDict()
    for k in range(2 if retina else 1, 5):
        cin = res2_out * 2 ** (k - 1)
        _layer(out, f"backbone.fpn.fpn_inner{k}", (channels, cin, 1, 1), gn)
        _layer(out, f"backbone.fpn.fpn_layer{k}",
               (channels, channels, 3, 3), gn)
    if retina:  # P6 from P5, or from C5 with RETINANET.USE_C5
        for p in ("p6", "p7"):
            cin = res2_out * 8 if p == "p6" and p6_from_c5 else channels
            out[f"backbone.fpn.top_blocks.{p}.weight"] = (channels, cin, 3, 3)
            out[f"backbone.fpn.top_blocks.{p}.bias"] = (channels,)
    return out


def paa_head_keys(channels, num_classes, num_anchors=1, num_convs=4,
                  num_levels=5, dcn_in_tower=False, branch="iou_pred"):
    """``num_classes`` without the background. The ATSS and FCOS heads
    (rpn/atss/atss.py, rpn/fcos/fcos.py) have the same layout with the
    ``centerness`` branch; ``branch`` None leaves it out."""
    out = OrderedDict()
    for tower in ("cls_tower", "bbox_tower"):
        for i in range(num_convs):
            p = f"rpn.head.{tower}"
            if dcn_in_tower and i == num_convs - 1:
                _dfconv(out, f"{p}.{3 * i}", channels, channels, 1, 1, True,
                        bias=True)
            else:
                out[f"{p}.{3 * i}.weight"] = (channels, channels, 3, 3)
                out[f"{p}.{3 * i}.bias"] = (channels,)
            out[f"{p}.{3 * i + 1}.weight"] = (channels,)
            out[f"{p}.{3 * i + 1}.bias"] = (channels,)
    for name, n in (("cls_logits", num_anchors * num_classes),
                    ("bbox_pred", num_anchors * 4),
                    (branch, num_anchors)):
        if name is None:
            continue
        out[f"rpn.head.{name}.weight"] = (n, channels, 3, 3)
        out[f"rpn.head.{name}.bias"] = (n,)
    for level in range(num_levels):
        out[f"rpn.head.scales.{level}.scale"] = (1,)
    return out


def retinanet_head_keys(channels, num_classes, num_anchors=9,
                        num_convs=4):
    """rpn/retinanet/retinanet.py: towers as ``Sequential``s of [conv,
    ReLU] x num_convs (conv i at index 2i), no norm, no scales."""
    out = OrderedDict()
    for tower in ("cls_tower", "bbox_tower"):
        for i in range(num_convs):
            out[f"rpn.head.{tower}.{2 * i}.weight"] = (channels, channels,
                                                       3, 3)
            out[f"rpn.head.{tower}.{2 * i}.bias"] = (channels,)
    for name, n in (("cls_logits", num_anchors * num_classes),
                    ("bbox_pred", num_anchors * 4)):
        out[f"rpn.head.{name}.weight"] = (n, channels, 3, 3)
        out[f"rpn.head.{name}.bias"] = (n,)
    return out


def rpn_head_keys(channels, num_anchors=3):
    out = OrderedDict()
    out["rpn.head.conv.weight"] = (channels, channels, 3, 3)
    out["rpn.head.conv.bias"] = (channels,)
    out["rpn.head.cls_logits.weight"] = (num_anchors, channels, 1, 1)
    out["rpn.head.cls_logits.bias"] = (num_anchors,)
    out["rpn.head.bbox_pred.weight"] = (4 * num_anchors, channels, 1, 1)
    out["rpn.head.bbox_pred.bias"] = (4 * num_anchors,)
    return out


def box_head_keys(channels, resolution, mlp, num_classes, gn=False,
                  xconvs=None):
    """``num_classes`` with the background; ``xconvs`` (count, width) for
    FPNXconv1fcFeatureExtractor (its fc6 without GN), else FPN2MLP."""
    out = OrderedDict()
    p = "roi_heads.box.feature_extractor"
    if xconvs is None:
        _layer(out, f"{p}.fc6", (mlp, channels * resolution * resolution),
               gn)
        _layer(out, f"{p}.fc7", (mlp, mlp), gn)
    else:
        count, width = xconvs
        cin = channels
        for i in range(count):
            j = i * (3 if gn else 2)
            out[f"{p}.xconvs.{j}.weight"] = (width, cin, 3, 3)
            if gn:
                _bn(out, f"{p}.xconvs.{j + 1}", width, gn=True)
            else:
                out[f"{p}.xconvs.{j}.bias"] = (width,)
            cin = width
        _layer(out, f"{p}.fc6", (mlp, cin * resolution * resolution), False)
    p = "roi_heads.box.predictor"
    out[f"{p}.cls_score.weight"] = (num_classes, mlp)
    out[f"{p}.cls_score.bias"] = (num_classes,)
    out[f"{p}.bbox_pred.weight"] = (4 * num_classes, mlp)
    out[f"{p}.bbox_pred.bias"] = (4 * num_classes,)
    return out


def mask_head_keys(channels, conv_layers, num_classes, gn=False,
                   deconv=True):
    """``num_classes`` with the background; ``deconv`` False for
    MaskRCNNConv1x1Predictor."""
    out = OrderedDict()
    cin = channels
    for i, cout in enumerate(conv_layers):
        _layer(out, f"roi_heads.mask.feature_extractor.mask_fcn{i + 1}",
               (cout, cin, 3, 3), gn)
        cin = cout
    p = "roi_heads.mask.predictor"
    if deconv:
        out[f"{p}.conv5_mask.weight"] = (cin, cin, 2, 2)
        out[f"{p}.conv5_mask.bias"] = (cin,)
    out[f"{p}.mask_fcn_logits.weight"] = (num_classes, cin, 1, 1)
    out[f"{p}.mask_fcn_logits.bias"] = (num_classes,)
    return out


def keypoint_head_keys(channels, conv_layers, num_keypoints):
    out = OrderedDict()
    cin = channels
    for i, cout in enumerate(conv_layers):
        p = f"roi_heads.keypoint.feature_extractor.conv_fcn{i + 1}"
        out[f"{p}.weight"] = (cout, cin, 3, 3)
        out[f"{p}.bias"] = (cout,)
        cin = cout
    p = "roi_heads.keypoint.predictor.kps_score_lowres"
    out[f"{p}.weight"] = (cin, num_keypoints, 4, 4)
    out[f"{p}.bias"] = (num_keypoints,)
    return out


def res5_head_keys(res2_out, width, groups, num_classes):
    """The C4 box head: res5's three bottlenecks (the first with the
    downsample) from the C4 map's 4 x res2_out channels to 8 x res2_out,
    then FastRCNNPredictor's ``cls_score`` and ``bbox_pred``
    (``num_classes`` with the background)."""
    res5 = resnet_keys((0, 0, 0, 3), res2_out=res2_out, width=width,
                       groups=groups)
    out = OrderedDict()
    for key, shape in res5.items():
        if key.startswith("backbone.body.layer4."):
            out[key.replace("backbone.body.layer4.",
                            "roi_heads.box.feature_extractor.head.layer4.",
                            1)] = shape
    # block 0 reads the C4 map, not the (empty) stage before it
    first = "roi_heads.box.feature_extractor.head.layer4.0"
    mid = groups * width * 8
    out[f"{first}.conv1.weight"] = (mid, 4 * res2_out, 1, 1)
    out[f"{first}.downsample.0.weight"] = (8 * res2_out, 4 * res2_out, 1, 1)
    p = "roi_heads.box.predictor"
    out[f"{p}.cls_score.weight"] = (num_classes, 8 * res2_out)
    out[f"{p}.cls_score.bias"] = (num_classes,)
    out[f"{p}.bbox_pred.weight"] = (4 * num_classes, 8 * res2_out)
    out[f"{p}.bbox_pred.bias"] = (4 * num_classes,)
    return out


def with_shared_mask_extractor(state):
    """``state`` with the C4 Mask R-CNN's mask feature extractor (the box
    head's res5, shared: roi_heads.py:19) listed again under
    ``roi_heads.mask.feature_extractor``, as its state dict lists it."""
    out = OrderedDict(state)
    for key, value in state.items():
        if key.startswith("roi_heads.box.feature_extractor.head."):
            out[key.replace("roi_heads.box.", "roi_heads.mask.", 1)] = value
    return out


def layout(cfg):
    """The reference state dict's keys and shapes for the PAA, ATSS,
    FCOS, RetinaNet, Faster R-CNN, Mask R-CNN, Keypoint R-CNN or RPN-only
    model of ``cfg`` (either package's config), on an FPN or a C4 body,
    FrozenBN or GN, with the GN and Xconv heads (the C4 Mask R-CNN's
    shared extractor once: ``with_shared_mask_extractor`` adds its
    second listing)."""
    m = cfg.MODEL
    r = m.RESNETS
    body = m.BACKBONE.CONV_BODY
    gn = r.TRANS_FUNC == "BottleneckWithGN"
    if body.endswith("-C4"):
        out = resnet_keys(BLOCKS[body[:-len("-C4")]][:3],
                          r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS,
                          r.WIDTH_PER_GROUP, r.NUM_GROUPS, gn=gn)
        out.update(rpn_head_keys(4 * r.RES2_OUT_CHANNELS,
                                 len(m.RPN.ANCHOR_SIZES)
                                 * len(m.RPN.ASPECT_RATIOS)))
        if m.RPN_ONLY:
            return out
        out.update(res5_head_keys(r.RES2_OUT_CHANNELS, r.WIDTH_PER_GROUP,
                                  r.NUM_GROUPS, m.ROI_BOX_HEAD.NUM_CLASSES))
        if m.MASK_ON:
            dim = m.ROI_MASK_HEAD.CONV_LAYERS[-1]
            p = "roi_heads.mask.predictor"
            out[f"{p}.conv5_mask.weight"] = (8 * r.RES2_OUT_CHANNELS, dim,
                                             2, 2)
            out[f"{p}.conv5_mask.bias"] = (dim,)
            out[f"{p}.mask_fcn_logits.weight"] = (
                m.ROI_BOX_HEAD.NUM_CLASSES, dim, 1, 1)
            out[f"{p}.mask_fcn_logits.bias"] = (m.ROI_BOX_HEAD.NUM_CLASSES,)
        return out
    retina = body.endswith("RETINANET")
    out = resnet_keys(BLOCKS[body.split("-FPN")[0]], r.STEM_OUT_CHANNELS,
                      r.RES2_OUT_CHANNELS, r.WIDTH_PER_GROUP, r.NUM_GROUPS,
                      r.STAGE_WITH_DCN, r.WITH_MODULATED_DCN,
                      r.DEFORMABLE_GROUPS, gn)
    channels = r.BACKBONE_OUT_CHANNELS
    dense = next((n for n in ("PAA", "ATSS", "FCOS", "RETINANET")
                  if m[f"{n}_ON"]), None)
    out.update(fpn_keys(retina, r.RES2_OUT_CHANNELS, channels,
                        dense is not None and m.RETINANET.USE_C5,
                        m.FPN.USE_GN))
    if dense == "RETINANET":
        h = m.RETINANET
        out.update(retinanet_head_keys(
            channels, h.NUM_CLASSES - 1,
            len(h.ASPECT_RATIOS) * h.SCALES_PER_OCTAVE, h.NUM_CONVS))
    elif dense is not None:
        h = m[dense]
        fcos = dense == "FCOS"
        branch = {"PAA": h.get("USE_IOU_PRED") and "iou_pred",
                  "ATSS": (h.get("USE_CENTERNESS_PRED")
                           or h.get("USE_IOU_PRED")) and "centerness",
                  "FCOS": "centerness"}[dense] or None
        out.update(paa_head_keys(
            channels, h.NUM_CLASSES - 1,
            1 if fcos else len(h.ASPECT_RATIOS) * h.SCALES_PER_OCTAVE,
            h.NUM_CONVS, len(h.FPN_STRIDES if fcos else h.ANCHOR_STRIDES),
            h.USE_DCN_IN_TOWER, branch))
    else:
        out.update(rpn_head_keys(channels, len(m.RPN.ASPECT_RATIOS)))
        if m.RPN_ONLY:
            return out
        bh = m.ROI_BOX_HEAD
        xconv = bh.FEATURE_EXTRACTOR == "FPNXconv1fcFeatureExtractor"
        out.update(box_head_keys(
            channels, bh.POOLER_RESOLUTION, bh.MLP_HEAD_DIM, bh.NUM_CLASSES,
            bh.USE_GN,
            (bh.NUM_STACKED_CONVS, bh.CONV_HEAD_DIM) if xconv else None))
        if m.MASK_ON:
            mh = m.ROI_MASK_HEAD
            out.update(mask_head_keys(
                channels, mh.CONV_LAYERS, bh.NUM_CLASSES, mh.USE_GN,
                mh.PREDICTOR != "MaskRCNNConv1x1Predictor"))
        if m.KEYPOINT_ON:
            out.update(keypoint_head_keys(
                channels, m.ROI_KEYPOINT_HEAD.CONV_LAYERS,
                m.ROI_KEYPOINT_HEAD.NUM_CLASSES))
    return out


def seeded_state_dict(shapes, seed, cls_bias=(-2.5, 0.5)):
    """float32 numpy tensors for ``shapes`` from ``seed``, none of them at
    an identity, so that a wrong mapping shows: weights kaiming-uniform
    (bound sqrt(3 / fan_in)), norm and Scale weights in [0.5, 1.5],
    running variances in [0.5, 2], means and biases normal(0, 0.1); the
    PAA cls_logits bias in ``cls_bias``, so that detections exist. A DCN
    offset conv's weight at 0.02 of the kaiming bound and its bias
    normal(0, 1.5): fractional offsets of a pixel or two, some samples
    off the image (a trained offset conv's scale; at its zero init a DCN
    layer is a plain conv with mask 0.5)."""
    rng = np.random.RandomState(seed)
    out = OrderedDict()
    for key, shape in shapes.items():
        offset = ".offset." in key
        if key.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, shape)
        elif key.endswith(".scale") or (key.endswith(".weight")
                                        and len(shape) == 1):
            v = rng.uniform(0.5, 1.5, shape)
        elif key.endswith(".weight"):
            bound = np.sqrt(3.0 / np.prod(shape[1:])) * (0.02 if offset
                                                         else 1.0)
            v = rng.uniform(-bound, bound, shape)
        elif key == "rpn.head.cls_logits.bias" and \
                "rpn.head.iou_pred.bias" in shapes:  # PAA, not the RPN
            v = rng.uniform(*cls_bias, shape)
        else:
            v = rng.normal(0.0, 1.5 if offset else 0.1, shape)
        out[key] = v.astype(np.float32)
    return out


def c2_body_name(key):
    """A reference body key -> its Detectron blob name; None for the
    running statistics, which Detectron folds into s and b, and for DCN
    offset convs, which Detectron bodies do not have. A DCN block's
    sampled conv is ``branch2b``."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[:2] != ["backbone", "body"] or leaf.startswith("running") \
            or "offset" in parts:
        return None
    sb = {"weight": "s", "bias": "b"}
    if parts[2] == "stem":
        return "conv1_w" if parts[3] == "conv1" else f"res_conv1_bn_{sb[leaf]}"
    stage, block, mod = int(parts[2][len("layer"):]) + 1, parts[3], parts[4]
    if mod == "downsample":
        base = f"res{stage}_{block}_branch1"
        return f"{base}_w" if parts[5] == "0" else f"{base}_bn_{sb[leaf]}"
    base = f"res{stage}_{block}_branch2{'abc'[int(mod[-1]) - 1]}"
    return f"{base}_w" if mod.startswith("conv") else f"{base}_bn_{sb[leaf]}"


def fold_frozen_bn(state):
    """The body's FrozenBatchNorm folded as Detectron stores it:
    s = weight / sqrt(var) and b = bias - mean * s (no epsilon), the
    running statistics then 0 and 1."""
    out = OrderedDict(state)
    for key in state:
        if key.endswith(".running_mean"):
            base = key[:-len(".running_mean")]
            s = state[base + ".weight"] / np.sqrt(state[base + ".running_var"])
            out[base + ".weight"] = s.astype(np.float32)
            out[base + ".bias"] = (state[base + ".bias"]
                                   - state[key] * s).astype(np.float32)
            out[key] = np.zeros_like(state[key])
            out[base + ".running_var"] = np.ones_like(state[key])
    return out


def c2_imagenet_blobs(body_state, seed):
    """A Detectron ImageNet pickle's blobs for the body tensors of
    ``body_state`` (folded), with a seeded 1000-way classifier
    ``pred_{w,b}`` that the import skips."""
    folded = fold_frozen_bn(body_state)
    blobs = OrderedDict()
    for key, value in folded.items():
        name = c2_body_name(key)
        if name is not None:
            blobs[name] = value
    rng = np.random.RandomState(seed)
    width = folded[[k for k in folded if k.endswith("conv3.weight")][-1]
                   ].shape[0]
    blobs["pred_w"] = rng.normal(0, 0.01, (1000, width)).astype(np.float32)
    blobs["pred_b"] = np.zeros(1000, np.float32)
    return blobs
