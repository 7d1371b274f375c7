"""The benchmark's plain reference against the measured program,
``paa_tpu_torch``, on the CPU at narrow widths and in float32: the head
outputs, the post-processing, the loss and the SGD steps. The
configuration files' reference sections against the program's config.

    python -m pytest benchmark/tests -q
"""

import numpy as np
import pytest
import torch

from benchmark.families import paa
from benchmark.harness import cells, checks, program, train
from benchmark.harness import weights as W
from benchmark.reference import loss as ref_loss
from benchmark.reference import model as ref_model
from benchmark.reference import postprocess as ref_post
from benchmark.tests import tiny

CONFIGS = ("paa_r50_1x", "paa_x152_dcnv2_2x")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _Cell:
    def __init__(self, config, traffic):
        self.config, self.traffic, self.limits = config, traffic, {}


def _setup(name, seed=3):
    conf = tiny.narrow_config(name)
    tr = tiny.narrow_traffic("serve")
    wts = W.make_weights(paa.state_shapes(conf), conf["weights"], seed,
                         CPU)
    return conf, tr, wts


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_section_matches_program_config(name):
    """What the reference reads of a configuration is what the program
    builds from the same file's keys."""
    conf = cells.read_json(f"{cells.HERE}/configs/{name}.json")
    cfg, ref = program.program_cfg(conf), conf["reference"]
    r, p, s = cfg.MODEL.RESNETS, cfg.MODEL.PAA, cfg.SOLVER
    assert ref["body"] == {
        "blocks": {"R-50-FPN-RETINANET": [3, 4, 6, 3],
                   "R-152-FPN-RETINANET": [3, 8, 36, 3]}[
                       cfg.MODEL.BACKBONE.CONV_BODY],
        "stem_out": r.STEM_OUT_CHANNELS, "res2_out": r.RES2_OUT_CHANNELS,
        "groups": r.NUM_GROUPS, "width_per_group": r.WIDTH_PER_GROUP,
        "stride_in_1x1": r.STRIDE_IN_1X1,
        "stage_with_dcn": list(r.STAGE_WITH_DCN),
        "freeze_at": cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT}
    assert not any(r.STAGE_WITH_DCN) or r.WITH_MODULATED_DCN
    assert r.DEFORMABLE_GROUPS == 1 and not cfg.MODEL.USE_SYNCBN
    assert ref["fpn"] == {"out_channels": r.BACKBONE_OUT_CHANNELS,
                          "p6_from_c5": cfg.MODEL.RETINANET.USE_C5}
    assert ref["head"] == {"num_classes": p.NUM_CLASSES - 1,
                           "num_convs": p.NUM_CONVS,
                           "dcn_in_tower": p.USE_DCN_IN_TOWER}
    assert ref["anchors"] == {"sizes": list(p.ANCHOR_SIZES),
                              "strides": list(p.ANCHOR_STRIDES)}
    assert tuple(p.ASPECT_RATIOS) == (1.0,) and p.SCALES_PER_OCTAVE == 1
    assert ref["postprocess"] == {
        "pre_nms_thresh": p.INFERENCE_TH, "pre_nms_top_n": p.PRE_NMS_TOP_N,
        "nms_thresh": p.NMS_TH,
        "detections_per_img": cfg.TEST.DETECTIONS_PER_IMG,
        "score_voting": p.INFERENCE_SCORE_VOTING}
    assert ref["loss"] == {
        "gamma": p.LOSS_GAMMA, "alpha": p.LOSS_ALPHA,
        "iou_threshold": p.IOU_THRESHOLD, "topk": p.TOPK,
        "reg_loss_weight": p.REG_LOSS_WEIGHT,
        "iou_loss_weight": p.IOU_LOSS_WEIGHT, "gmm_iters": cfg.TPU.GMM_ITERS}
    assert ref["solver"] == {
        "base_lr": s.BASE_LR, "momentum": s.MOMENTUM,
        "weight_decay": s.WEIGHT_DECAY,
        "weight_decay_bias": s.WEIGHT_DECAY_BIAS,
        "bias_lr_factor": s.BIAS_LR_FACTOR,
        "dcn_offsets_lr_factor": s.DCONV_OFFSETS_LR_FACTOR,
        "gamma": s.GAMMA, "steps": list(s.STEPS),
        "warmup_factor": s.WARMUP_FACTOR, "warmup_iters": s.WARMUP_ITERS,
        "warmup_method": s.WARMUP_METHOD}
    assert ref["pixel_mean"] == list(cfg.INPUT.PIXEL_MEAN)
    assert ref["pixel_std"] == list(cfg.INPUT.PIXEL_STD)
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16" == \
        {"bfloat16": "bfloat16"}[conf["precision"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_state_dict_names_and_frozen_stages_match(name):
    """One state dict loads into both sides; the same tensors train."""
    conf, _, wts = _setup(name)
    model = program.build_model(conf, wts, CPU)
    ref = ref_model.build(conf["reference"])
    ref.load_state_dict(wts, strict=True)
    prog_train = {n for n, p in model.module.named_parameters()
                  if p.requires_grad}
    ref_train = {n for n, p in ref.named_parameters() if p.requires_grad}
    assert prog_train == ref_train
    opt = program.train_state(model).optimizer
    names = {id(p): n for n, p in model.module.named_parameters()}
    from benchmark.reference.train import group_settings, label
    for g in opt.param_groups:
        for p in g["params"]:
            factor, wd = group_settings(conf["reference"]["solver"],
                                        label(names[id(p)]))
            assert (g["lr_factor"], g["weight_decay"]) == (factor, wd)


@pytest.mark.parametrize("name,tol", [("paa_r50_1x", 1e-4),
                                      ("paa_x152_dcnv2_2x", 1e-3)])
def test_head_outputs_match_program(name, tol):
    """Same images and weights: the reference's head outputs are the
    program's, float32, to 1e-4 of their spread (the reference runs one
    image at a time and the program the batch, so convolutions sum in
    another order), 1e-3 with DCN (its samples sum in another order)."""
    conf, tr, wts = _setup(name)
    model = program.build_model(conf, wts, CPU)
    pool = W.image_pool(tr, 3, CPU)
    captured = []
    hook = model.module.register_forward_hook(
        lambda m, i, o: captured.append(o))
    model.make_eval_fn()(*pool[0])
    hook.remove()
    cell = _Cell(conf, tr)
    ref_heads = paa.reference_heads(cell, wts, pool[:1], CPU, "float32")
    for key in paa.HEAD_KEYS:
        p, r = captured[0][key].float(), ref_heads[0][key]
        assert float((p - r).abs().max()) <= tol * float(r.std()) + 1e-6


@pytest.mark.parametrize("name", CONFIGS)
def test_postprocess_matches_program(name):
    """The reference's post-processing of the program's head outputs
    gives the program's detections: labels and validity equal, boxes
    and scores to float32 rounding."""
    conf, tr, wts = _setup(name)
    model = program.build_model(conf, wts, CPU)
    pool = W.image_pool(tr, 3, CPU)
    heads = []
    hook = model.module.register_forward_hook(
        lambda m, i, o: heads.append({k: o[k] for k in paa.HEAD_KEYS}))
    eval_fn = model.make_eval_fn()
    outs = [eval_fn(*b) for b in pool]
    hook.remove()
    dets = paa.reference_detections(_Cell(conf, tr), heads, pool, CPU)
    numbers, _ = checks.detections_gap(dets, [0, 1], outs, {})
    assert numbers["det_mismatch"] == 0
    assert numbers["det_box_gap_px"] < 1e-3
    assert numbers["det_score_gap"] < 1e-6
    assert all(bool(o["valid"].any()) for o in outs)  # the lift works


@pytest.mark.parametrize("seed", range(4))
def test_greedy_nms_matches_program_plain(seed):
    from paa_tpu_torch.ops.nms import nms_batched_plain

    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 300, (3, 400, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(4, 90, (3, 400, 2))], 2).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, (3, 400)).astype(np.float32))
    scores[:, 100:150] = scores[:, :1]  # ties
    labels = torch.from_numpy(rng.randint(1, 4, (3, 400)).astype(np.int32))
    valid = torch.from_numpy(rng.rand(3, 400) > 0.3)
    got = ref_post.greedy_nms(boxes, scores, labels, valid, 0.6, 50)
    want = nms_batched_plain(boxes, scores, labels, valid, 0.6, 50, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_loss_matches_program():
    from paa_tpu_torch.modeling.paa_loss import paa_loss

    conf, _, wts = _setup("paa_r50_1x")
    tr = tiny.narrow_traffic("train")
    cell = _Cell(conf, tr)
    model = program.build_model(conf, wts, CPU)
    b = paa.train_pool(cell, 3, CPU)[0]
    x = ref_model.normalize(b["images"], b["image_sizes"],
                            conf["reference"]["pixel_mean"],
                            conf["reference"]["pixel_std"])
    with torch.no_grad():
        out = model.module(x)
    anchors, counts = model.anchors_for(tuple(tr["hw"]))
    want, aux = paa_loss(out, b["gt_boxes"], b["gt_labels"], anchors,
                         counts, model.loss_fn()[1], return_aux=True)
    lc = conf["reference"]["loss"]
    a = ref_loss.assign(out, b["gt_boxes"], b["gt_labels"], anchors, counts,
                        lc)
    got = ref_loss.losses(out, a, anchors, lc, a["num_pos"], a["iou_sum"])
    assert torch.equal(a["pos"], aux["pos_mask"])
    for k in got:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6)


@pytest.mark.parametrize("name,change_tol", [("paa_r50_1x", 1e-3),
                                             ("paa_x152_dcnv2_2x", 2e-2)])
def test_train_steps_match_program(name, change_tol):
    """Two SGD steps from the same weights on the same batches, the
    reference's batch in one block as the program's: losses, the first
    gradient and the change agree to float32 rounding. With DCN the
    second step's samples can fall on the other side of a pixel in the
    two, which moves one tensor's change by under 1% (layer2_2.conv1 at
    seed 3; the DCN's gradients alone agree to 1e-5)."""
    conf = tiny.narrow_config(name)
    tr = dict(tiny.narrow_traffic("train"), reference_block=2)
    cell = _Cell(conf, tr)
    wts = W.make_weights(paa.state_shapes(conf), conf["weights"], 3, CPU)
    model = program.build_model(conf, wts, CPU)
    state = program.train_state(model)
    step = model.make_bucket_train_step(tuple(tr["hw"]))
    pool = paa.train_pool(cell, 3, CPU)
    got = train.first_steps(step, state, pool, 2, paa.STEP_RECORDS)
    numbers, _ = paa.train_judge(*got, paa.reference_run(cell, wts,
                                                         pool[:2], CPU))
    assert numbers["loss_gap"] < 1e-4 and numbers["num_pos_gap"] == 0
    assert numbers["grad_gap"] < 1e-3 and numbers["change_gap"] < change_tol
