#!/usr/bin/env python3
"""Drive the PyTorch port (paa_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

It checks and does not measure: the benchmark (BENCHMARK.json,
benchmark/) times and traces the cells end to end and by layer, and
kernel_ab.py times each kernel alone beside its bound and plain version.

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line); the numbers of phases that timed or profiled
(9's timing, 10, 14, 23) are not reused:

1. Build the CUDA kernels from paa_tpu_torch/csrc (one nvcc per source,
   in parallel, sm_90a): K1 nms_batched.cu, K2 nms_global.cu, K3
   group_norm.cu, K4 deform_im2col.cu, K5 deform_col2im.cu.
2. K1, the batched NMS kernel, against its plain PyTorch version on the
   card: B=8, N=5000 and 77, max_out=100, IoU 0.6, class-aware and
   class-agnostic, with exact score ties and all-invalid rows; the RPN's
   shape (40 rows of N=1000, max_out 1000, class-agnostic, IoU 0.7);
   equal top scores over three of K1's sweep tiles, with duplicate boxes
   across both tile boundaries; and a row with a valid NaN score (no
   picks). keep_idx and keep_valid equal, keep_scores bit-equal.
3. K2, the NMS kernel for any N, against its plain version: B=8 at
   N=80,000, at K1's capacity + 1 (through ``nms_batched``, which must
   route there) and at N=300; the single-image ``nms`` at N=80,000;
   max_out 100 and 1000; class-aware and agnostic; exact score ties and
   an all-invalid row. Then each route of K2 (clusters of 1, 2 and 16
   CTAs, and the scratch kernel above 16 CTAs' capacity), score ties on
   both sides of every boundary between CTA ranges, every valid
   candidate in one CTA's range, fewer valid candidates than max_out,
   and an all-invalid image. All three outputs bit-equal.
4. K3, the GroupNorm+ReLU kernel, in both its forms (the ReLU fused,
   and relu=False: GroupNorm alone), against its plain version at the
   five tower shapes of an 8 x 800 x 1344 batch, at shapes whose launch
   takes each cluster size from 1 to 4, 8 and 16 and the streaming
   instantiation, and with groups that start off 16-byte boundaries:
   float32 (TF32 off) within 1e-5, bfloat16 within one bf16 ulp (plus
   1e-6 near zero). Phase 30 holds it so at every other shape of the
   run.
5. The PAA main path: PAA-R50 (configs/paa/paa_R_50_FPN_1x.yaml, full
   width, 80 classes) in bfloat16 with weights from a seed serves three
   requests of 8 x 800 x 1344 uint8 images through ``make_eval_fn``.
   Checks shapes, finiteness, boxes inside the image, detections > 0, and
   the launch counts of the run (K1 once and K3 40 times per request).
6. The same model in float32 on the card (TF32 off) against the same
   model on the CPU, whose wrappers take the plain versions, at a small
   input: head outputs and detections agree.
7. The Faster R-CNN main path: configs/e2e_faster_rcnn_R_50_FPN_1x.yaml
   at full width (256 FPN channels, 81 classes, MLP 1024, RPN
   1000/1000/1000) in bfloat16, weights from seed 0 and the foreground
   cls_score bias from seed 1, serves three 8 x 800 x 1344 requests.
   Same checks, labels in 1..80, and the launch counts of the run (K1
   once for the RPN and K2 once for the box head per request).
8. The Faster R-CNN in float32 on the card against the CPU at a small
   input, as phase 6.
9. K1 against its plain version on the inputs that the first request
   of phase 5 (PAA's candidates) and of phase 7 (the Faster R-CNN RPN's
   rows) gave it, and K2 on that request's box head candidates (at least
   1,000 an image above the score threshold): bit-equal.
11. Training, K3's gradient: the autograd Function around K3 (forward
    K3, backward the VJP of the plain version, recomputed) against
    autograd through the plain version at the towers' shapes of a
    16 x 800 x 1344 batch, float32 and bfloat16: forward within K3's
    tolerances, gradients of x, weight and bias equal.
12. The training main path: PAA-R50 at full width in bfloat16 (params
    and losses float32), weights from seed 0, through
    ``make_bucket_train_step`` and ``do_train``: TRAIN_STEPS (5) SGD
    steps (the config's lr 0.01, constant warmup 1/3, weight decay 1e-4,
    momentum 0.9) on one batch of 16 uint8 images of 800 x 1344 (content
    800 x 1333) with 100 GT slots, 3-12 valid per image. Every loss
    finite, num_pos > 0, the last step's loss below the first's, K3
    launched 40 times per step and no NMS.
13. One training step in float32 (TF32 off) on the card and on the CPU
    at 2 x 256 x 320 from the same weights and batch: losses, num_pos,
    the positive mask and the updated parameters agree; the same step
    on the card with a fault planted in K3's gradient does not.

15. (Run after phase 9.) PAA-R50 COCO-style evaluation, dataset to AP
    table, at full width: 32 PPM images at COCO's common sizes (written
    to a temporary directory, 3-12 boxes each over the 80 sparse
    category ids) through the port's ``inference``: the bucketed loader
    (800 x 1333 in (800, 1344) / (1344, 800), raw uint8 batches of 8,
    short tails padded with image_id -1), make_eval_fn in bfloat16 with
    the serving cell's seeded weights and cls bias (K3 40 and K1 once
    per batch), the COCO evaluator, coco_results.json and bbox.json.
    Checks that the loader's batches hold every image once, the launch
    counts of the run (per batch of the loader), the 12 metrics, a
    detection for every real image and none for padding; prints the AP
    table (random weights: not an accuracy).
16. The same eval path in float32 (TF32 off) on the card and on the CPU
    from the same weights: four PPM images at MIN_SIZE_TEST 256 in the
    buckets (256, 320) / (320, 256), against ground truth made of the
    CPU's five best detections per image on a first pass. Detections
    matched as in phase 6, the 12 metrics within 1e-3.

17. (Run after phase 29.) The AP gate: a seeded
    reference-format ``{"model": state_dict}`` checkpoint of full-width
    PAA-R50 (paa_core's key names, tests/reference_layout.py) through
    ``paa_tpu_torch.tools.reproduce_ap``: every port tensor written, none
    skipped, the tensors on the card equal to the file's; the gate over
    synth_coco_32 (800 x 1333, B=8, bf16) exits 0 at the AP of a first
    pass, 1 at that AP + 0.1 and 2 with the weights missing; K1 once and
    K3 40 times per eval batch.
18. Training from ImageNet weights: a seeded Detectron R-50 pickle at
    the real shapes under a temporary ModelCatalog.WEIGHTS_DIR, through
    ``paa_tpu_torch.tools.train_net`` with the config's MODEL.WEIGHT
    catalog://ImageNetPretrained/MSRA/R-50 on synth_coco_32 at full
    width (bf16, IMS_PER_BATCH 8, MAX_ITER 4, CHECKPOINT_PERIOD 2): the
    body equals the pickle's blobs after the import, finite losses, K3
    40 times per step; the run stopped after its iteration-2 checkpoint
    resumes there in a second run, reaches 4 and writes the AP table.
19. Data parallelism: two ranks on the one card with gloo (NCCL refuses
    two ranks on one device), started as torchrun starts them. One
    float32 DDP step of full-width PAA-R50 on a global batch of 8 at
    256 x 320 (4 per rank) against the one-process step: positive mask
    and num_pos equal, updates within phase 13's limits. Then a two-rank
    eval of synth_coco_32 against one
    process: the same detections and the 12 metrics. Then SyncBN
    (MODEL.USE_SYNCBN): one float32 step of PAA-R50 with a SyncBatchNorm
    in each body norm on a global batch of 16 at 256 x 320, two ranks
    of 8 (batch statistics all-reduced) against one process of 16, the
    ReLU decisions shared: normalized activations and running
    statistics within 1e-4, losses and updates within phase 13's limits.

20. (Run after phase 31, with the earlier paths' models freed.) The
    X-152 dcnv2 main path:
    configs/paa/paa_dcnv2_X_152_32x8d_FPN_2x.yaml at full width (32x8d
    ResNeXt at R-152 depth, modulated DCN as conv2 of every block of
    stages 3-5 and as the towers' last conv, 256 FPN channels, 80
    classes) in bfloat16, weights from seed 0, the cls_logits bias from
    seed 1 in [-3.5, -2.5] and every DCN offset conv from seed 2 (as
    the CPU tests draw them: fractional offsets of a pixel or two),
    serves three 8 x 800 x 1344 requests through ``make_eval_fn``: the
    checks of phase 5, K1 3, K3 120 and K4 171 launches (47 body DCNs
    and the two towers' at 5 levels a request).
21. One ``DeformConv`` at the path's stage-3 (512 channels, 100 x 168,
    32 groups), stage-4 (1024, 50 x 84, 32 groups) and P3 tower (256,
    100 x 168, with bias) shapes, B=1, offset conv from a seed, on the
    card (K4) against the CPU (the plain version): float32 (TF32 off)
    within rtol = atol = 2e-4,
    bfloat16 within DCN_BF16_REL of the largest float32 output.
22. The X-152 dcnv2 model in float32 on the card against the CPU at
    2 x 256 x 320, as phase 6.

24. (Run after phase 68, with the X-152 serving model freed.) The DCN
    backward that keeps only its inputs (ops/dcn.py's
    DeformConv2dFunction: on the card the columns' gradient, K4 for the
    weight's and K5) against autograd through deform_conv2d on the
    card at phase 21's shapes, B=2: the gradients of x, offsets, mask
    and weight in float32 (TF32 off) and bfloat16 within
    DCN_GRAD_LIMITS; the peak memory of one stage-3 layer's forward and
    backward at B=8 in bfloat16 with each, the Function's the lower.
25. The X-152 dcnv2 training main path: the config at full width in
    bfloat16 with its SOLVER, weights from seed 0 and the offset convs
    from seed 2, DCN_TRAIN_STEPS (2) steps of do_train on one repeated
    batch of 8 (else 4, else 2: the largest that fits) uint8 800 x 1344
    images with 3-12 GTs in 100 slots: every loss finite, num_pos > 0, the
    last loss below the first, K3 40, K4 114 (the forward's 57 and the
    backward's columns for the weights' gradients) and K5 57 launches per
    step and no NMS; one step at each of the ladder's buckets
    (800, 1344) and (1344, 800).
26. One float32 train step (TF32 off) of that model on the card against
    the CPU and against a float64 step on the CPU at 2 x 256 x 320, each
    float32 step with the backbone's and the FPN's ReLU decisions that
    rounding put on the other side of 0 pinned to float64's (the pinned
    elements printed): all three within phase 13's limits of each
    other; a card step with the offsets' gradient x1.05 planted in the
    DCN backward must land beyond them. ``python3 chip_smoke.py
    --dcnv2-step-readings SEED...`` runs these steps at other batches.
27. Multi-scale testing of the X-152 dcnv2 config: ``inference`` with
    TEST.BBOX_AUG.ENABLED and the config's own 26 augmentations
    (soft-vote) over TTA_IMAGES (1) 480 x 640 PPM images at full width in
    bfloat16: K1 once and K3 40 times per augmentation and batch, a
    detection per image, the 12 metrics.
28. The TTA path in float32 on the card against the CPU with full-width
    PAA-R50 at a reduced list (the identity at 256, scales 192 and 320
    with scale ranges, all flipped): detections matched as in phase 6,
    the 12 metrics within 1e-3.
29. Phase 18 on the X-152 dcnv2 config, from a seeded Detectron
    X-101-32x8d pickle through its catalog:// MODEL.WEIGHT.
30. K3 against its plain version, as phase 4, at every input shape and
    form at which the paths of phases 5-58 launched it (the TTA buckets
    up to 1824 x 3008, the training ladder's, the GN body's stem at
    400 x 672 and the fc GN's (R, 1024, 1, 1) among them).

31. (Run after phase 13, before phase 20.) The dense detectors
    beside PAA at full width (256 FPN channels, 80 classes), bfloat16,
    weights from seed 0 and the cls bias from seed 1, each through the
    phases of PAA-R50 (``phase_dense``): ATSS
    (configs/atss/atss_R_50_FPN_1x.yaml), FCOS
    (configs/fcos/fcos_imprv_R_50_FPN_1x.yaml: NORM_REG_TARGETS,
    centerness on the regression tower, center sampling, GIoU) and
    RetinaNet (configs/retinanet/retinanet_R-50-FPN_1x.yaml: 9 anchors
    per location, P6 from C5, plain towers). Three 8 x 800 x 1344
    requests (phase 5's checks; K1 once and K3 40 times per request,
    no K3 for RetinaNet); K1 against its plain version on the inputs
    the first request gave it (recorded), bit-equal; the f32 model on
    the card against the CPU (phase 6); TRAIN_STEPS (5) do_train steps
    at the config's IMS_PER_BATCH (16; RetinaNet 8) with K3 40 times per
    step for ATSS and FCOS (phase 12); the f32 train step on the card
    against the CPU and float64 (phase 13), the assignment's labels
    equal, and for FCOS a third card step with its centerness targets
    x1.05, which must land beyond the limits.
    RetinaNet's steps take FrozenBN statistics calibrated on its
    seeded body (its towers have no norm; with the seed's identity
    statistics P3-P7 reach ~1e3 and its steps diverge); its one-step
    comparison keeps the seeded ones, as every head's.
32. (Run after phase 28.) ATSS multi-scale testing as phase 27: the
    identity, 3 scales of the X-152 list (400, 1000, 1800, their scale
    ranges, MAX_SIZE 3000) and their flips, 8 augmentations, soft-vote,
    TTA_IMAGES (1) images of 480 x 640: K1 once and K3 40 times per
    augmentation.
33. ``paa_tpu_torch.tools.test_net`` on the FCOS config over
    synth_coco_32 at full width from the seeded weights: exit 0, the 12
    metrics, a detection on every image, K1 once and K3 40 times per
    eval batch.

34. (Run after phase 33.) Mask R-CNN serving:
    configs/e2e_mask_rcnn_R_50_FPN_1x.yaml at full width (Faster R-CNN's
    phase 7 model and biases, the mask head's 4 x 256 convs, deconv and
    80 class channels; the mask logits' biases from seed 2 in
    [0.5, 1.5]) in bfloat16, three 8 x 800 x 1344 requests: phase 7's
    checks, K1 3 and K2 3 launches, masks (8, 100, 28, 28) float32 in
    [0, 1]; K1 against its plain version on the RPN's rows of the first
    request; the f32 model on the card against the CPU at 2 x 256 x 320
    (phase 8),
    and the masks of the detections at the same box within
    MASK_PROB_TOL.
35. Faster R-CNN and Mask R-CNN training at full width in bfloat16: 10
    do_train steps each at IMS_PER_BATCH 16 on one batch of 800 x 1344
    images (3-12 GTs, for Mask R-CNN each with its octagon's
    box-normalized mask), FrozenBN calibrated on the seeded body:
    finite losses that fall, num_pos > 0, K1 once per step at the
    training RPN's rows (80 rows of up to 2,000 candidates, 2,000
    picks), held bit-equal to its plain version on the first step's
    rows.
36. One float32 Mask R-CNN train step on the card and on the CPU
    against a float64 CPU step at 2 x 256 x 320 (128 rois per image,
    phase 35's calibrated FrozenBN), the same draws injected, and the
    proposals and the ReLU decisions at the kink pinned to float64's:
    sampled anchors and rois, labels, GT indices and num_pos equal,
    losses within 1e-4, updates within phase 13's limits; a planted
    x1.05 in the mask logits' gradient must land beyond them.
37. ``paa_tpu_torch.tools.test_net`` on Mask R-CNN over synth_coco_32
    at full width with cv2 blocked: exit 0, the bbox and segm tables,
    K1 and K2 once per batch; then the eval path in f32 on the card
    against the CPU at 256 px: the 24 AP values within 1e-3.
38. K1 against its plain version at every input shape phases 34-37
    launched it at (recorded), the training RPN's 2,000-pick rows
    among them.

39. (Run after phase 38.) Keypoint R-CNN serving:
    configs/e2e_keypoint_rcnn_R_50_FPN_1x.yaml at full width (R-50-FPN,
    256 channels, 2 classes, the keypoint head's 8 x 512 convs on 14 x 14
    pools, the 4 x 4 deconv to 17 channels and the bilinear x2 to
    56 x 56), bf16, weights from seed 0 and the foreground bias from
    seed 1, three 8 x 800 x 1344 requests: phase 7's checks, K1 6
    launches (the RPN's 40 rows of 1,000 and the box head's 8 rows of
    1,000, class-aware, 100 picks; 1,000 x 1 candidates fit K1), the
    heatmaps (8, 100, 17, 56, 56) float32, the first image's detections
    decoded on the host with every keypoint inside its box within 1 px;
    K1 against its plain version at both recorded inputs; the f32 model
    on the card against the CPU (phase 8) and its detect with 20 detections per
    image against the CPU and float64: heatmaps at the same box within
    KP_HEATMAP_TOL.
40. Keypoint R-CNN training at B=16 (phase 35's recipe, each GT a person
    with 17 keypoints, calibrated FrozenBN): K1 once per step at the
    training RPN's 80 rows of 2,000; finite losses that fall over
    TRAIN_STEPS (5) steps.
41. C4 Faster and Mask R-CNN serving (configs/e2e_faster_rcnn_R_50_C4_1x
    and e2e_mask_rcnn_R_50_C4_1x: R-50 to C4, 1,024 channels at stride
    16, 15 anchors per location, the res5 box head on 14 x 14 pools, 81
    classes, the C4 mask predictor at 14 x 14), bf16, FrozenBN
    calibrated on the seeded body and res5, three 8 x 800 x 1344
    requests each: K1 3 (the RPN's 8 rows of 6,000, 1,000 picks) and K2
    3 (the box head's 80,000 per image) launches, masks (8, 100, 14,
    14); both kernels against their plain versions at the first
    request's inputs.
42. C4 Faster and Mask R-CNN training at the configs' IMS_PER_BATCH 8:
    the RPN's 8 rows of 12,000 candidates (of 63,000 anchors) with 2,000
    picks go to K2's cluster route, once per step; K2 held bit-equal to
    its plain version there; finite losses that fall.
43. One f32 C4 Mask R-CNN train step on the card and on the CPU against
    float64 (phase 36 at 64 rois per image).
44. ``paa_tpu_torch.tools.test_net`` on Keypoint R-CNN over the 32-image
    synthetic person-keypoint COCO (its DATASETS.TEST, served by
    tools/synth_catalog.py) with cv2 blocked: exit 0, the bbox and
    keypoints (OKS) tables, K1 twice per batch. Then K1 and K2
    against their plain versions at every input phases 39-44 gave them.

45. (Run after phase 44.) GN Mask R-CNN serving:
    configs/gn_baselines/e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml at
    full width (the GN R-50 body: K3 in each of its 53 norms, with the
    ReLU fused where one follows and alone (relu=False) before the
    residual add; GN FPN without ReLU; the Xconv1fc head's four 3x3 convs
    with GN; the GN mask head), bf16, weights from seed 0 and the
    foreground and mask biases of phase 34, three 8 x 800 x 1344
    requests: K1 3, K2 3 and K3 69 launches a request (28 relu=False),
    masks; K1 and K2 against their plain versions at the first request's
    inputs; the f32 model on the card against the CPU, its masks
    compared.
46. Its training at IMS_PER_BATCH 16, FREEZE_CONV_BODY_AT 2, seeded GN
    (no FrozenBN to calibrate): K1 once and K3 69 times per step (each
    GroupNorm in its form), losses over TRAIN_STEPS (5) steps that
    fall.
47. One f32 GN Mask R-CNN train step on the card and on the CPU against
    float64 (phase 36's checks and pins, 128 rois per image), and the
    planted x1.05 beyond the limits.
48. scratch_e2e_faster_rcnn_R_50_FPN_3x_gn training at B=16 with the
    whole GN body trainable (FREEZE_CONV_BODY_AT 0) and FPN2MLP's fc GN
    over (R, 1024, 1, 1): K3 63 times a step (each GroupNorm in its
    form), losses that fall.
49. ``paa_tpu_torch.tools.test_net`` on the GN Mask R-CNN over
    synth_coco_32 with cv2 blocked: exit 0, the bbox and segm tables,
    K1, K2 and 69 K3 launches per batch.
50. rpn_R_50_FPN_1x (calibrated FrozenBN): three 8 x 800 x 1344 requests
    (K1 once a request at the five levels' 40 rows of 1,000 with 1,000
    picks; 2,000 proposals an image), K1 bit-equal there; TRAIN_STEPS
    training steps at B=16 (the RPN loss
    alone, no NMS); ``test_net`` to the box_proposal table (AR at 100 and
    1,000, all areas) from a checkpoint of the seeded weights; the f32
    proposals on the card against the CPU (validity and pick order
    equal, boxes within RPN_BOX_TOL px).
51. rpn_R_50_C4_1x: serving at B=8, its RPN's 8 rows of 12,000
    (PRE_NMS_TOP_N_TEST, above K1's 8,192) on K2 with 2,000 picks, K2
    bit-equal there; training at the default IMS_PER_BATCH 16; the
    box_proposal table.

52. (Run after phase 51.) FCOS-MNV2
    (configs/fcos/fcos_bn_bs16_MNV2_FPN_1x.yaml: the MobileNetV2 body,
    its C3-C5 into FPN, 256 channels, P6/P7 from P5) through
    ``phase_dense``: three 8 x 800 x 1344 bf16 requests (K1 once, K3 40
    times in the towers), K1 at the first request's candidates, the f32
    model on the card against the CPU, TRAIN_STEPS (5) do_train steps at
    IMS_PER_BATCH 16.
53. FBNet Mask R-CNN (configs/e2e_mask_rcnn_fbnet_600.yaml, arch
    "default", WIDTH_DIVISOR 8, FrozenBN calibrated in the trunk and the
    heads' stages) serving at its test size, three 8 x 608 x 1024 bf16
    requests: K1 at the RPN's 8 rows of 6,000 (200 picks), K2 at the box
    head's 8 x 16,000, masks (8, 100, 12, 12); both kernels bit-equal to
    their plain versions at those inputs.
54. Its f32 model and masks on the card against the CPU at 2 x 256 x
    320, and its f32 train step against the CPU and float64 (phase 36's
    checks, pins and planted x1.05).
55. Its training at B=16 (one card's share of the config's 128 over 8
    GPUs, BASE_LR scaled by 16 / 128) at 608 x 1024: K1 once per step
    at the RPN's 16 rows of 6,000 (the config's PRE_NMS_TOP_N_TRAIN)
    with 2,000 picks; ``test_net``
    over synth_coco_32 with cv2 blocked, the bbox and segm tables.
56. FBNet cham_v1a Faster R-CNN (depthwise 5 x 5 and 7 x 7) serving at
    608 x 1024 (K2 at its box head) and xirb16d_dsmask Mask R-CNN at
    320 x 640 (its mask stage 6 -> 3 -> 6 -> 12; K1 at its box head's
    8 x 8,000).
57. PAA-R50 with MODEL.USE_SYNCBN True: TRAIN_STEPS (5) do_train steps
    at B=16 on batch statistics; then an eval request, every
    SyncBatchNorm in eval mode on its running statistics.
58. ``train_net`` 3 iterations with USE_SYNCBN over synth_coco_32; its
    model_final holds the running statistics, and ``test_net --ckpt``
    loads them (equal) and writes the AP table.

59. (Run after phase 19.) Pascal VOC at full width:
    configs/pascal_voc/e2e_faster_rcnn_R_50_C4_1x_1_gpu_voc.yaml (21
    classes, RPN 6,000 / 300 test proposals, 128-512 anchors, B=1 as the
    config; calibrated FrozenBN, phase 7's foreground bias lift) over
    the synthetic catalog's voc_2007_test (16 PPM images of VOC's sizes
    under .jpg names, difficult objects kept) through ``build_dataset``,
    the loader and ``compute_on_dataset``, then ``do_voc_evaluation``:
    a finite mAP and the 20-class table, K1 twice an image (the RPN's
    1 x 6,000 with 300 picks, the box head's 1 x 6,000 with 100), K1
    bit-equal to its plain version at both.
60. That eval path of the narrow C4 model in f32 on the card against the
    CPU over 4 images whose ground truth is the CPU's first-pass
    detections: detections matched, each class's AP within 1e-3.
61. 4 do_train steps of the full-width VOC model from the loader over
    voc_2007_train + voc_2007_val (a ConcatDataset; one image without a
    GT): finite losses, K2 once a step at the training RPN's 1 x 12,000.
62. The serving artifact: PAA-R50 exported at B=8 x 800 x 1344 bf16
    (``serving.export_inference``), saved, loaded and served by a
    process that imports torch and ``paa_tpu_torch.serving`` alone:
    three requests, K1 3 and K3 120 launches, detections matched to the
    live eval fn's.
63. ``roi_pool`` and ``deform_psroi_pool`` (with its gradients) on the
    card against the CPU.

64. (Run after phase 63.) The overfit gate
    (paa_tpu_torch/tools/quick_overfit.py ``run``): PAA-R50 at 128 FPN
    channels, 2 tower convs and 3 classes in float32, its first 150 of
    1,500 iterations at B=4 on 8 synthetic PPM images of class-coloured
    rectangles through the loader and ``do_train``, then ``inference``
    over them: first loss above 1.5, the last 20 iterations' mean below
    0.6x the first; K3 20 times a forward, K1 twice in the eval; K1
    bit-equal at the eval's input.
65. The demo (paa_tpu_torch/demo/predictor.py ``COCODemo``): the flagship
    config at full width in float32 with phase 5's weights and cls bias
    on one 480 x 640 BGR image (padded to 800 x 1088): every card
    detection matched on the CPU and back; K1 1 and K3 40 launches a
    call.
66. ``python -m paa_tpu_torch.tools.profile_train_step --batch 2 --steps
    1`` in a process of its own, side by side with phase 67's: exit 0,
    its span table, device time in the input, forward, backward and
    optimizer spans, K3's launches.
67. The benchmark tools (``python -m paa_tpu_torch.tools.<name>``),
    each in a process of its own, side by side with phase 66's, at
    reduced depth: bench (PAA-R50, B=8, 3 iterations,
    ``--cls-bias-lift``), bench_dcnv2 --train (R-101 dcnv2 at B=2, a
    first and one timed step), bench_tta (2 images, one pass after the
    first) and bench_loader (16 JPEGs, 1 and 4 threads): exit 0, the
    last line's JSON with the JAX tool's keys, this card's name, value
    > 0, the clocks at both ends of each timed window, K1/K3 launches
    as each tool's calls need. Meanwhile, in the script's own process
    at B=2: bench's timed call, bench_dcnv2's serving (R-101 dcnv2, 2
    iterations) and one bench_tta pass, with the same checks, K1
    bit-equal to its plain version at every input they gave it, and
    their K3 shapes (B=2 at 800 x 1344, the R-50 TTA buckets) among
    those that phase_k3_at_path_shapes holds.
68. (Run after phase 22.) K4 against its plain version
    (``_im2col_columns``) on the same card tensors at every layer shape
    at which phase 20's path launched it: B=8 at 800 x 1344, the body's
    res3, res4 and res5 and the towers' P3-P7, launched as often as a
    forward needs (47 and 10); offsets normal(0, 2 px), the mask
    uniform. float32 within 1e-6 of the largest column, bfloat16 within
    one bfloat16 rounding (2^-8 relative) of the plain float32 columns
    of the same values; the largest errors go into K4's entry of the
    ``kernels`` line.
69. (Run after phase 24.) K5 against its plain version
    (``_col2im_grads``) on the same card tensors at every layer shape at
    which phase 24's do_train launched it, which must be K4_PATH_SHAPES
    at B=8 in bfloat16, once a layer a step: K5 once at B=8 in float32
    and bfloat16, each two-image slice of its gradients within 1e-5 of
    the plain version's largest magnitude on that slice; the largest
    errors go into K5's entry of the ``kernels`` line.

Phase 13 also runs the step a third time on the CPU with the network in
float64 (every convolution, FrozenBN and GroupNorm), the referee of the
two float32 steps, and phase 11 checks K3's Function at a group of zero
variance with a zero bias (the ReLU input exactly 0: half the upstream
gradient, as the JAX package's custom VJP gives).

The line before the last is the ``kernels`` JSON: each kernel's largest
error against its plain version over the phases that compare them (0.0
where they must be bit-equal) and its launches a call or a step on the
main paths, as phases 5, 7, 12, 20 and 25 assert them; the card's name
and power limit (nvidia-smi) come on a line before it; the last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits with 2.
"""

import collections
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

BATCH, HW, SIZE = 8, (800, 1344), (800.0, 1333.0)
# training: SOLVER.IMS_PER_BATCH images, GT slots, steps of the main path
TRAIN_BATCH, MAX_GT, TRAIN_STEPS = 16, 100, 5
TOWER_HW = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
GN_PER_LEVEL = 8  # 2 towers x 4 GroupNorm+ReLU
ROOT = os.path.dirname(os.path.abspath(__file__))
PAA_CONFIG = os.path.join(ROOT, "configs", "paa", "paa_R_50_FPN_1x.yaml")
FRCNN_CONFIG = os.path.join(ROOT, "configs",
                            "e2e_faster_rcnn_R_50_FPN_1x.yaml")
MRCNN_CONFIG = os.path.join(ROOT, "configs", "e2e_mask_rcnn_R_50_FPN_1x.yaml")
DCNV2_CONFIG = os.path.join(ROOT, "configs", "paa",
                            "paa_dcnv2_X_152_32x8d_FPN_2x.yaml")
# the dense detectors beside PAA: each serves, trains and is held
# against the CPU by the phases of PAA-R50, called once per head
DENSE_CONFIGS = {
    "atss": os.path.join(ROOT, "configs", "atss", "atss_R_50_FPN_1x.yaml"),
    "fcos": os.path.join(ROOT, "configs", "fcos",
                         "fcos_imprv_R_50_FPN_1x.yaml"),
    "retinanet": os.path.join(ROOT, "configs", "retinanet",
                              "retinanet_R-50-FPN_1x.yaml"),
}
# one deformable conv in bfloat16 against float32, within this share of
# the float32 output's largest magnitude (tests/test_torch_port_dcn.py's
# BF16_REL)
DCN_BF16_REL = 1.5e-2
# the COCO evaluator's 12 bbox metrics
METRICS = ("AP", "AP50", "AP75", "APs", "APm", "APl",
           "AR1", "AR10", "AR100", "ARs", "ARm", "ARl")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def nms_case(seed, bsz, n, dev):
    """Boxes over an 800 x 1333 image with heavy overlap, exact score
    ties and one all-invalid row (the last)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 1200, (bsz, n, 2))
    wh = rng.uniform(8, 300, (bsz, n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=2).astype(np.float32)
    boxes[:, 1::7] = boxes[:, 0::7][:, : boxes[:, 1::7].shape[1]]
    scores = rng.uniform(0.05, 1.0, (bsz, n)).astype(np.float32)
    scores[:, 100:400] = scores[:, 50:51]
    labels = rng.randint(1, 81, (bsz, n)).astype(np.int32)
    valid = rng.rand(bsz, n) > 0.1
    valid[-1] = False
    return [torch.from_numpy(a).to(dev) for a in (boxes, scores, labels,
                                                  valid)]


def same_keeps(got, want, what):
    for g, w, name in zip(got, want, ("keep_idx", "keep_scores",
                                     "keep_valid")):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"{what}: kernel != plain in {name}")


def rpn_case(seed, dev, rows=5 * BATCH, n=1000):
    """Rows shaped like the RPN's: five levels of BATCH images, N=1000
    proposals per row sorted by objectness, the smallest level's rows
    819 long (13 x 21 x 3 anchors at 800 x 1344), one label."""
    boxes, scores, _, _ = nms_case(seed, rows, n, dev)
    scores = scores.sort(dim=1, descending=True).values
    valid = torch.ones(rows, n, dtype=torch.bool, device=dev)
    valid[-BATCH:, 819:] = False
    return [boxes, scores, torch.zeros_like(valid, dtype=torch.int32),
            valid]


def shared(name):
    """A numpy-only module of tests/ that this script shares with the
    tests: nms_cases (the NMS inputs), reference_layout (the reference's
    checkpoint layouts)."""
    path = os.path.join(ROOT, "tests")
    if path not in sys.path:
        sys.path.insert(0, path)
    import importlib

    return importlib.import_module(name)


def tie_case(dev):
    """Equal top scores over three of K1's sweep tiles, with copies of
    boxes across both tile boundaries (tests/nms_cases.py): the picks
    must take them in index order and drop the copies."""
    args = nms_case(9, BATCH, 300, "cpu")
    shared("nms_cases").with_ties(*(a.numpy() for a in args))
    return [a.to(dev) for a in args]


def phase_nms(dev):
    from paa_tpu_torch.ops import nms

    cases = [(f"N={n} class_aware={aware}", nms_case(n, BATCH, n, dev),
              0.6, 100, aware) for n in (5000, 77) for aware in (True, False)]
    cases.append(("RPN rows 40x1000 max_out=1000 agnostic IoU 0.7",
                  rpn_case(11, dev), 0.7, 1000, False))
    cases.append(("equal top scores over three tiles", tie_case(dev), 0.5,
                  100, True))
    nan = nms_case(13, BATCH, 5000, dev)
    nan[1][2, 4321], nan[3][2, 4321] = float("nan"), True
    cases.append(("a valid NaN score in row 2", nan, 0.6, 100, True))
    for what, args, thresh, max_out, aware in cases:
        before = nms.nms_batched.launches
        got = nms.nms_batched(*args, thresh, max_out, aware)
        check(nms.nms_batched.launches == before + 1,
              f"nms_batched {what}: K1 not launched once")
        same_keeps(got, nms.nms_batched_plain(*args, thresh, max_out, aware),
                   f"nms_batched {what}")
        # picks in every row with a valid score, unless one is NaN
        rows = got[2].any(dim=1).tolist()
        valid = args[3]
        expect = (valid.any(dim=1)
                  & ~(valid & args[1].isnan()).any(dim=1)).tolist()
        check(rows == expect,
              f"nms_batched {what}: rows with picks {rows}, not {expect}")
        if what.startswith("equal"):
            keep = shared("nms_cases").tied_picks().tolist()
            check(got[0][0, :len(keep)].tolist() == keep,
                  f"nms_batched {what}: picks {got[0][0, :8].tolist()}")
    print(json.dumps({"phase": "nms_vs_plain", "ok": True,
                      "cases": [c[0] for c in cases]}))


def phase_nms_global(dev):
    """K2 against its plain version through ``_nms_global`` (the batched
    dispatch), ``nms_batched`` above K1's capacity and ``nms``."""
    from paa_tpu_torch.ops import nms

    limit = nms.k1_max_candidates(dev)
    cases = [  # (entry point, N, max_out, class_aware)
        ("_nms_global", 80000, 100, True),
        ("_nms_global", 80000, 100, False),
        ("_nms_global", 80000, 1000, True),
        ("nms_batched", limit + 1, 100, True),
        ("nms_batched", limit + 1, 1000, False),
        ("_nms_global", 300, 100, True), ("_nms_global", 300, 1000, False),
        ("nms", 80000, 100, True), ("nms", 80000, 1000, False),
    ]
    done = []
    for entry, n, max_out, aware in cases:
        what = f"{entry} N={n} max_out={max_out} class_aware={aware}"
        args = nms_case(n + max_out, BATCH, n, dev)
        before = (nms.nms_batched.launches, nms._nms_global.launches)
        if entry == "nms":  # one image: the first row
            got = [t[None] for t in nms.nms(*(a[0] for a in args), 0.5,
                                            max_out, aware)]
            args = [a[:1] for a in args]
        else:
            got = getattr(nms, entry)(*args, 0.5, max_out, aware)
        after = (nms.nms_batched.launches, nms._nms_global.launches)
        check(after == (before[0], before[1] + 1),
              f"{what}: launches K1/K2 went {before} -> {after}, "
              "expected K2 once")
        same_keeps(got, nms.nms_batched_plain(*args, 0.5, max_out, aware),
                   what)
        check(bool(got[2][0].any()), f"{what}: no picks in row 0")
        if entry != "nms":
            check(not bool(got[2][-1].any()),
                  f"{what}: picks in the all-invalid row")
        done.append(what)
    done += k2_route_cases(dev)
    print(json.dumps({"phase": "nms_global_vs_plain", "ok": True,
                      "k1_capacity": limit,
                      "k2_cluster_capacity": nms.k2_capacity(dev),
                      "B": BATCH, "cases": done}))


def _only_valid(args, idx):
    valid = torch.zeros_like(args[3])
    valid[:, torch.as_tensor(list(idx), dtype=torch.long,
                             device=valid.device)] = True
    return args[:3] + [valid]


def k2_route_cases(dev):
    """K2's routes and the cluster route's edges, each against the plain
    version through ``_nms_global``."""
    from paa_tpu_torch.ops import nms

    cap = nms.k2_capacity(dev)
    n = 80000
    chunk = -(-n // nms.k2_plan(n, cap)[1])
    cases = [(f"route N={m}", m, lambda a: a, 100, ("cluster", cs))
             for m, cs in ((cap, 1), (cap + 1, 2), (16 * cap, 16))]
    cases.append((f"route N={16 * cap + 1}", 16 * cap + 1, lambda a: a,
                   100, ("scratch", 1)))

    def ties(a):  # equal top scores either side of each range boundary
        edges = [r * chunk + d for r in range(1, n // chunk + 1)
                 for d in (-1, 0) if r * chunk + d < n]
        for i, j in enumerate(edges):
            a[0][:, j] = torch.tensor([1e4 * i, 0.0, 1e4 * i + 5, 5.0])
        a[1][:, edges] = 2.0
        a[3][:] = True
        return a

    cases += [
        ("ties across CTA ranges, all valid", n, ties, 100, None),
        ("all valid in one CTA's range", n,
         lambda a: _only_valid(a, range(5 * chunk, 5 * chunk + 900)), 100,
         None),
        ("50 valid, max_out 100", n,
         lambda a: _only_valid(a, range(7, n, n // 50)), 100, None),
        ("all-invalid images", n, lambda a: _only_valid(a, []), 100, None),
    ]
    done = []
    for what, m, prep, max_out, route in cases:
        if route is not None:
            check(nms.k2_plan(m, cap) == route,
                  f"K2 {what}: route {nms.k2_plan(m, cap)}, not {route}")
        args = prep(nms_case(m, BATCH, m, dev))
        before = nms._nms_global.launches
        got = nms._nms_global(*args, 0.5, max_out, True)
        check(nms._nms_global.launches == before + 1,
              f"K2 {what}: not launched once")
        same_keeps(got, nms.nms_batched_plain(*args, 0.5, max_out, True),
                   f"K2 {what}")
        if what.startswith("ties"):
            check(got[0][0, :2].tolist() == [chunk - 1, chunk],
                  f"K2 {what}: first picks {got[0][0, :4].tolist()}")
        done.append(f"K2 {what} ({nms.k2_plan(m, cap)})")
    return done


def _bf16_ulp(x):
    mag = x.abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# K3 shapes beyond the towers (B, C, H, W): with them the launch takes
# every cluster size from 1 to 4, 8 and 16, the streaming instantiation
# (a group beyond 16 CTAs' share), one channel of 8 positions per group,
# and groups off 16-byte boundaries (C=64 in 32 groups at odd H*W, once
# with cs 3)
GN_EXTRA_SHAPES = [
    (2, 256, 48, 48), (1, 256, 72, 96), (1, 256, 192, 192),
    (1, 256, 200, 200), (1, 32, 2, 4), (3, 64, 5, 7), (1, 64, 101, 199),
]


def k3_vs_plain(x, s, b, what, relu=True):
    """K3 against group_norm_relu_plain on x (float32, on the card) and
    on x in bfloat16, with the same scale and bias, in the form ``relu``:
    float32 within 1e-5, bfloat16 within one bfloat16 ulp of the larger
    side (+1e-6). Returns the largest errors."""
    from paa_tpu_torch.ops import group_norm as gn

    got = gn.group_norm_relu(x, s, b, relu=relu)
    err32 = float((got - gn.group_norm_relu_plain(
        x, s, b, relu=relu)).abs().max())
    check(err32 <= 1e-5, f"group_norm_relu f32 {what}: err {err32}")
    xb = x.to(torch.bfloat16)
    got = gn.group_norm_relu(xb, s, b, relu=relu).float()
    want = gn.group_norm_relu_plain(xb, s, b, relu=relu).float()
    err = (got - want).abs()
    ulp = _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    check(bool((err <= ulp + 1e-6).all()),
          f"group_norm_relu bf16 {what}: beyond one ulp, max err "
          f"{float(err.max())}")
    return {"f32": err32, "bf16": float(err.max())}


def phase_group_norm(dev):
    from paa_tpu_torch.ops import group_norm as gn

    torch.backends.cudnn.allow_tf32 = False  # f32 compare: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)
    worst, plans = {}, set()
    shapes = [(BATCH, 256, h, w) for h, w in TOWER_HW] + GN_EXTRA_SHAPES
    for shape in shapes:
        bsz, c, h, w = shape
        what = "x".join(map(str, shape))
        x = (torch.randn(*shape, generator=gen) * 1.5 + 0.4).to(dev)
        s = (torch.rand(c, generator=gen) + 0.5).to(dev)
        b = (torch.randn(c, generator=gen) * 0.2).to(dev)
        worst[what] = k3_vs_plain(x, s, b, what)
        worst[f"{what} no_relu"] = k3_vs_plain(x, s, b, what, relu=False)
        for size in (4, 2):
            p = gn.gn_plan(bsz, c, h * w, 32, size)
            plans.add((p.cs, p.resident))
    cs_seen = sorted({p[0] for p in plans if p[1]})
    check(set(range(1, 5)) | {8, 16} <= set(cs_seen)
          and any(not p[1] for p in plans),
          f"group_norm_relu: launches covered {sorted(plans)}")
    print(json.dumps({"phase": "group_norm_vs_plain", "ok": True,
                      "resident_cluster_sizes": cs_seen,
                      "plans_cs_resident": sorted(plans),
                      "max_abs_err": worst}))
    return {k: max(e[k] for e in worst.values()) for k in ("f32", "bf16")}


def phase_k3_at_path_shapes(dev, shapes, bench_shapes):
    """K3 against its plain version as phase_group_norm holds it (float32
    and bfloat16) at every input shape and form (``relu``) at which this
    process's paths launched it (``recording_k3_launches``), inputs from a
    seed on the card: the serving, eval and training forwards, each
    bucket of the X-152 TTA list at B=TTA_IMAGES up to 1824 x 3008 (P3
    228 x 376) and the training ladder's (1344, 800) among them; of the
    GN paths (phases 45-49) the body's stem at 400 x 672 (2 channels a
    group, streamed from device memory), its relu=False norms, the
    Xconv head's 7 x 7 and the fc GN's 1 x 1 over the rois; the
    benchmark tools' (phase 67, ``bench_shapes``: B=2 at 800 x 1344 and
    the R-50 TTA buckets). Returns the largest errors."""
    sizes = {shape for shape, _ in shapes}
    check(bench_shapes <= shapes,
          f"k3_at_path_shapes: the benchmark tools' shapes were not "
          f"recorded: {sorted(bench_shapes - shapes)}")
    check((TTA_IMAGES, 256, 228, 376) in sizes
          and any(shape[2:] == (168, 100) for shape in sizes),
          f"k3_at_path_shapes: the TTA's largest bucket or the (1344, "
          f"800) train bucket was not recorded: {sorted(sizes)[-5:]}")
    check((TRAIN_BATCH, 64, 400, 672) in sizes
          and any(shape[1:] == (256, 7, 7) for shape in sizes)
          and any(shape[1:] == (1024, 1, 1) for shape in sizes)
          and any(not relu for _, relu in shapes),
          f"k3_at_path_shapes: the GN paths' stem, Xconv, fc GN or "
          f"relu=False launches were not recorded")
    gen = torch.Generator(dev).manual_seed(17)
    worst = {"f32": 0.0, "bf16": 0.0}
    for shape, relu in sorted(shapes):
        c = shape[1]
        x = torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.4
        s = torch.rand(c, generator=gen, device=dev) + 0.5
        b = torch.randn(c, generator=gen, device=dev) * 0.2
        err = k3_vs_plain(x, s, b, "x".join(map(str, shape)), relu)
        worst = {k: max(v, err[k]) for k, v in worst.items()}
        del x
    largest = max(sizes, key=math.prod)
    print(json.dumps({"phase": "k3_at_path_shapes", "ok": True,
                      "shapes": len(sizes), "shape_forms": len(shapes),
                      "no_relu_shapes": sum(not r for _, r in shapes),
                      "largest": largest, "max_abs_err": worst}))
    torch.cuda.empty_cache()
    return worst


def build_cfg(dtype, path, extra=()):
    from paa_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", dtype, *extra])
    cfg.freeze()
    return cfg


def seeded_model(dtype, device, path=PAA_CONFIG):
    """The full-width dense model of ``path`` (PAA-R50 by default; ATSS,
    FCOS, RetinaNet) with weights from seed 0 and the cls_logits bias
    drawn from seed 1 around the 0.05 threshold (logit -2.944), so that
    an untrained net yields candidates."""
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.tools.bench_common import lift_cls_bias

    return lift_cls_bias(build_detection_model(build_cfg(dtype, path),
                                               device=device, seed=0))


def seed_offset_convs(module, seed):
    """Every DCN offset conv under ``module`` drawn from ``seed`` as the
    CPU tests draw them (tests/test_torch_port_backbones.py): the kernel
    uniform at 0.02 of the kaiming bound, the bias normal(0, 1.5), so
    fractional offsets of a pixel or two (at their zero init a DCN layer
    is a plain conv with a mask of 0.5)."""
    from paa_tpu_torch.modeling.layers import DeformConv

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, DeformConv):
                w, b = m.offset.weight, m.offset.bias
                bound = 0.02 * math.sqrt(3.0 / w[0].numel())
                w.copy_(torch.empty(w.shape).uniform_(-bound, bound,
                                                      generator=gen))
                b.copy_(torch.empty(b.shape).normal_(0.0, 1.5,
                                                     generator=gen))


def seeded_dcnv2(dtype, device):
    """Full-width paa_dcnv2_X_152_32x8d_FPN_2x as ``seeded_model``, with
    the offset convs drawn from seed 2."""
    model = seeded_model(dtype, device, DCNV2_CONFIG)
    seed_offset_convs(model.module, 2)
    return model


def seeded_frcnn(dtype, device, path=FRCNN_CONFIG):
    """Full-width Faster R-CNN R-50-FPN (or the two-stage model of
    ``path``) with weights from seed 0 and the 80 foreground cls_score
    biases drawn from seed 1 in [25, 35]. The
    random box head's logits spread with a std of ~30 across classes,
    so a roi's softmax is nearly one-hot whatever the bias; lifting the
    foreground one std above the background keeps the background from
    winning, so each of the 1000 rois of an image gives a foreground
    candidate above the 0.05 threshold."""
    from paa_tpu_torch.modeling import build_detection_model

    model = build_detection_model(build_cfg(dtype, path),
                                  device=device, seed=0)
    gen = torch.Generator().manual_seed(1)
    bias = model.module.box_head.cls_score.bias
    with torch.no_grad():
        bias[1:].copy_(torch.empty(bias.numel() - 1).uniform_(
            25.0, 35.0, generator=gen))
    return model


def request(seed, bsz, hw, size):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (bsz, *hw, 3)).astype(np.uint8)
    sizes = np.tile(np.asarray(size, np.float32), (bsz, 1))
    return torch.from_numpy(images), torch.from_numpy(sizes)


# the kernels' launch counters of ops.launch_counts (ROIAlign's calls
# and rois, the others, are not launches)
KERNEL_COUNTERS = ("nms_batched", "nms_global", "group_norm_relu",
                   "deform_im2col", "deform_col2im")


def kernel_launches(counts):
    """The kernels' counters of an ``ops.launch_counts()`` dict (or of a
    tool's ``launches``, made from one): every launch check compares
    these."""
    return {k: counts[k] for k in KERNEL_COUNTERS}


def launch_counts():
    from paa_tpu_torch import ops

    return kernel_launches(ops.launch_counts())


def zero_launch_counts():
    from paa_tpu_torch.ops import deform_sampling, group_norm, nms

    nms.nms_batched.launches = 0
    nms._nms_global.launches = 0
    group_norm.group_norm_relu.launches = 0
    deform_sampling.deform_im2col.launches = 0
    deform_sampling.deform_col2im.launches = 0


def k3_forms(launches):
    """K3's launches of ``recording_k3_launches`` by form: {"relu":
    GroupNorm + ReLU, "no_relu": GroupNorm alone}."""
    relu = sum(r for _, _, r in launches)
    return {"relu": relu, "no_relu": len(launches) - relu}


def check_detections(dets, what, min_score, size=SIZE):
    """Shapes, finiteness, boxes in the image (content ``size``), scores
    and labels in range for every request; returns the valid detections
    per request."""
    n_valid = []
    for det in dets:
        check(tuple(det["boxes"].shape) == (BATCH, 100, 4)
              and tuple(det["scores"].shape) == (BATCH, 100)
              and tuple(det["labels"].shape) == (BATCH, 100)
              and tuple(det["valid"].shape) == (BATCH, 100),
              f"{what}: detection shapes")
        boxes, valid = det["boxes"], det["valid"]
        check(bool(torch.isfinite(boxes).all())
              and bool(torch.isfinite(det["scores"]).all()),
              f"{what}: non-finite output")
        vb = boxes[valid]
        # score voting averages clipped boxes: a few float32 ulps of slack
        slack = 1e-3
        check(bool((vb >= 0).all())
              and bool((vb[:, 0::2] <= size[1] - 1 + slack).all())
              and bool((vb[:, 1::2] <= size[0] - 1 + slack).all()),
              f"{what}: boxes outside the image")
        s = det["scores"][valid]
        check(bool((s > min_score).all()) and bool((s <= 1).all()),
              f"{what}: scores out of range")
        labels = det["labels"][valid]
        check(bool((labels >= 1).all()) and bool((labels <= 80).all()),
              f"{what}: labels out of range")
        n_valid.append(int(valid.sum()))
    check(min(n_valid) > 0, f"{what}: no detections {n_valid}")
    return n_valid


def serve(model, what, seed, expected, min_score, extra_check=None,
          detections=True, hw=HW, size=SIZE):
    """Three requests (B x ``hw``, content ``size``) through make_eval_fn
    with the launch counts set to 0 just before and read just after;
    ``check_detections`` unless ``detections`` is False (the RPN-only
    model's proposals); ``extra_check(dets)``, if given, checks the three
    requests' outputs further and returns fields to print. Returns the
    launch counts."""
    eval_fn = model.make_eval_fn()
    reqs = [request(seed + i, BATCH, hw, size) for i in range(3)]
    zero_launch_counts()
    dets = [eval_fn(images, sizes) for images, sizes in reqs]
    launches = launch_counts()
    check(launches == expected,
          f"{what}: launches {launches}, expected {expected}")
    n_valid = (check_detections(dets, what, min_score, size) if detections
               else [int(d["valid"].sum()) for d in dets])
    extra = extra_check(dets) if extra_check else {}
    print(json.dumps({"phase": what, "ok": True, "requests": 3,
                      "batch": BATCH, "hw": hw, "launches": launches,
                      "valid_detections": n_valid, **extra}))
    return launches


def dcn_per_forward(model):
    """K4 launches of one forward: the body's deformable convs once each,
    the head's (the towers' last conv) once per pyramid level; one chunk
    of images each at the batches these phases run."""
    from paa_tpu_torch.modeling.layers import DeformConv

    def count(module):
        return sum(isinstance(m, DeformConv) for m in module.modules())

    head = count(model.module.head)
    return count(model.module) - head + len(model.strides) * head


def dcn_per_forward_of(path):
    """``dcn_per_forward`` of the config at ``path``, built on the meta
    device."""
    from paa_tpu_torch.modeling import build_detection_model

    return dcn_per_forward(build_detection_model(
        build_cfg("bfloat16", path), device="meta"))


def gn_per_forward(model):
    """K3 launches of one forward: the GroupNorm+ReLU layers of the
    model (its head's towers), once per pyramid level; 0 for RetinaNet's
    plain towers."""
    from paa_tpu_torch.modeling.layers import GroupNorm32

    return len(model.strides) * sum(
        isinstance(m, GroupNorm32) for m in model.module.modules())


def phase_main_path(dev, path=PAA_CONFIG, what="main_path"):
    """Three full-width requests of the dense model of ``path`` (PAA-R50
    by default): K1 once and K3 ``gn_per_forward`` times per request.
    Returns the launch counts."""
    model = seeded_model("bfloat16", dev, path)
    return serve(
        model, what, 10,
        {"nms_batched": 3, "nms_global": 0,
         "group_norm_relu": 3 * gn_per_forward(model),
         "deform_im2col": 3 * dcn_per_forward(model), "deform_col2im": 0},
        0.0)


def phase_frcnn_main_path(dev):
    return serve(
        seeded_frcnn("bfloat16", dev), "faster_rcnn_main_path", 40,
        {"nms_batched": 3, "nms_global": 3, "group_norm_relu": 0,
         "deform_im2col": 0, "deform_col2im": 0}, 0.05)


def match_detections(gpu, cpu, what):
    """Each card detection must have a CPU detection of its label within
    0.5 px; 95% must, and the counts agree within 5%."""
    matched = total = 0
    for i in range(gpu["valid"].shape[0]):
        gv, cv = gpu["valid"][i], cpu["valid"][i]
        for box, label in zip(gpu["boxes"][i][gv], gpu["labels"][i][gv]):
            total += 1
            same = cpu["labels"][i][cv] == label
            d = (cpu["boxes"][i][cv][same] - box).abs().amax(dim=1)
            matched += int(d.numel() > 0 and float(d.min()) <= 0.5)
    n_cpu = int(cpu["valid"].sum())
    check(total > 0 and abs(total - n_cpu) <= 0.05 * n_cpu
          and matched >= 0.95 * total,
          f"{what}: {matched}/{total} card detections matched, "
          f"{n_cpu} on the CPU")
    return {"detections": total, "matched": matched,
            "cpu_detections": n_cpu}


def card_vs_cpu(dev, build, outputs, what):
    """The f32 model of ``build`` on the card against the same model on
    the CPU (plain versions) at 2 x 256 x 320; ``outputs(model, x)``
    gives the tensors compared within 1e-3 of their largest magnitude."""
    from paa_tpu_torch.ops.image_norm import device_normalize

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, sizes = request(99, 2, (256, 320), (256.0, 300.0))
    outs, dets = [], []
    for device in (dev, "cpu"):
        model = build("float32", device)
        x = device_normalize(images.to(device), sizes.to(device),
                             model.cfg.INPUT.PIXEL_MEAN,
                             model.cfg.INPUT.PIXEL_STD)
        with torch.inference_mode():
            outs.append({k: v.float().cpu() for k, v in outputs(
                model, x.permute(0, 3, 1, 2).contiguous()).items()})
        dets.append({k: v.cpu() for k, v in
                     model.make_eval_fn()(images, sizes).items()})
    errs = {}
    for k, want in outs[1].items():
        errs[k] = float((outs[0][k] - want).abs().max()
                        / want.abs().max())
        check(errs[k] <= 1e-3, f"{what}: {k} rel err {errs[k]}")
    print(json.dumps({"phase": what, "ok": True, "hw": [256, 320],
                      "rel_err": errs,
                      **match_detections(*dets, what)}))


def phase_reference(dev, path=PAA_CONFIG, what="card_vs_cpu"):
    card_vs_cpu(dev, lambda dtype, device: seeded_model(dtype, device, path),
                lambda m, x: m.module(x), what)


def phase_frcnn_reference(dev):
    card_vs_cpu(dev, seeded_frcnn, lambda m, x: m.module.backbone_rpn(x)[1],
                "faster_rcnn_card_vs_cpu")


def phase_nms_at_main_path_inputs(paa_k1, rpn_k1, box_k2):
    """Phase 9: K1 against its plain version on the inputs that the first
    request of phase 5 (PAA's candidates) and of phase 7 (the Faster
    R-CNN RPN's rows) gave it, and K2 on that request's box head
    candidates, at least 1,000 an image above the score threshold (the
    seeded foreground bias); all three outputs bit-equal."""
    per_image = box_k2[3].sum(dim=1).tolist()
    check(min(per_image) >= 1000,
          f"box head: candidates per image {per_image}, expected at least "
          f"1000")
    shapes = [k1_at_path_inputs(paa_k1, "paa"),
              k1_at_path_inputs(rpn_k1, "faster_rcnn_rpn"),
              k2_at_path_inputs(box_k2, "faster_rcnn_box_head")]
    print(json.dumps({"phase": "nms_at_main_path_inputs", "ok": True,
                      "shapes": shapes,
                      "box_head_candidates_per_image": per_image}))


def train_batch(seed, bsz, hw, size, max_gt=MAX_GT, max_side=512):
    """A batch in the loader's contract: uint8 images (content ``size``)
    and 3-12 GT boxes per image (COCO averages about 7) in ``max_gt``
    slots, sqrt(area) log-uniform in 16-``max_side`` px, aspect ratio
    log-uniform in 1/2-2, inside the content, labels 1-80; the other
    slots padding (label 0)."""
    images, sizes = request(seed, bsz, hw, size)
    rng = np.random.RandomState(seed + 1)
    boxes = np.zeros((bsz, max_gt, 4), np.float32)
    labels = np.zeros((bsz, max_gt), np.int32)
    h, w = size
    for b in range(bsz):
        n = rng.randint(3, 13)
        side = np.exp(rng.uniform(np.log(16), np.log(max_side), n))
        aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0), n))
        bw, bh = side * np.sqrt(aspect), side / np.sqrt(aspect)
        x1 = rng.uniform(0, w - 1 - bw)
        y1 = rng.uniform(0, h - 1 - bh)
        boxes[b, :n] = np.stack([x1, y1, x1 + bw, y1 + bh], axis=1)
        labels[b, :n] = rng.randint(1, 81, n)
    return {"images": images, "image_sizes": sizes,
            "gt_boxes": torch.from_numpy(boxes),
            "gt_labels": torch.from_numpy(labels)}


def train_state(model):
    from paa_tpu_torch.engine import TrainState
    from paa_tpu_torch.solver import make_optimizer

    return TrainState(model.module, make_optimizer(model.cfg,
                                                   model.module)[0])


EVAL_IMAGES = 32


def synth_dataset(root, n_images, seed):
    """A COCO-style dataset of ``n_images`` PPM images at COCO's common
    sizes (640x480, 480x640, 427x640, 500x375, ...) with low-frequency
    content and 3-12 boxes each over COCO's 80 sparse category ids."""
    from paa_tpu_torch.data.coco import COCODataset
    from paa_tpu_torch.data.synth import synth_coco

    ann_file, img_dir = synth_coco(root, n_images, seed=seed)
    return COCODataset(ann_file, img_dir,
                       remove_images_without_annotations=False)


def read_bbox_json(folder):
    with open(os.path.join(folder, "bbox.json")) as f:
        return json.load(f)


def phase_eval_main_path(dev):
    """PAA-R50 COCO-style evaluation, dataset to AP table, at full width:
    32 PPM images through the port's ``inference`` (the bucketed loader
    at 800 x 1333 in (800, 1344) / (1344, 800), raw uint8 batches of 8
    with the short tails padded by image_id -1, make_eval_fn in bfloat16
    with K3 and K1, the COCO evaluator), with the serving cell's seeded
    weights and cls bias; the launch counts set to 0 just before and
    read just after: K1 once and K3 40 times per batch of the loader,
    whose batches hold every image once."""
    import logging

    from paa_tpu_torch.data.loader import make_data_loader
    from paa_tpu_torch.engine.inference import inference

    tmp = tempfile.mkdtemp(prefix="paa_eval_")
    dataset = synth_dataset(os.path.join(tmp, "coco"), EVAL_IMAGES, 11)
    model = seeded_model("bfloat16", dev)
    cfg = model.cfg
    loaded = list(make_data_loader(cfg, dataset, is_train=False))
    n_loaded = sum(int((b["image_ids"] >= 0).sum()) for b in loaded)
    check(n_loaded == EVAL_IMAGES, f"eval_main_path: loader gave {n_loaded}")
    batches = len(loaded)
    out_dir = os.path.join(tmp, "inference")
    zero_launch_counts()
    results = inference(cfg, model, dataset, output_folder=out_dir,
                        logger=logging.getLogger("chip_smoke.eval"))
    launches = launch_counts()
    expected = {"nms_batched": batches, "nms_global": 0,
                "group_norm_relu": GN_PER_LEVEL * len(TOWER_HW) * batches,
                "deform_im2col": 0, "deform_col2im": 0}
    check(launches == expected and batches > 0,
          f"eval_main_path: launches {launches}, expected {expected}")
    check(sorted(results) == sorted(METRICS) and all(
        math.isfinite(v) and -1.0 <= v <= 1.0 for v in results.values()),
        f"eval_main_path: results {results}")
    with open(os.path.join(out_dir, "coco_results.json")) as f:
        check(json.load(f) == results, "eval_main_path: coco_results.json")
    dets = read_bbox_json(out_dir)
    per_image = {}
    for d in dets:
        per_image[d["image_id"]] = per_image.get(d["image_id"], 0) + 1
    ids = sorted(r.id for r in dataset.records)
    check(-1 not in per_image, "eval_main_path: a padding image predicted")
    check(sorted(per_image) == ids,
          f"eval_main_path: images without detections "
          f"{sorted(set(ids) - set(per_image))}")
    check(all(len(d["bbox"]) == 4 and all(map(math.isfinite, d["bbox"]))
              and d["bbox"][2] > 0 and d["bbox"][3] > 0
              and 0 < d["score"] <= 1 for d in dets),
          "eval_main_path: malformed detection")
    print(json.dumps({"phase": "eval_main_path", "ok": True,
                      "images": EVAL_IMAGES, "batches": batches,
                      "batch": cfg.TEST.IMS_PER_BATCH,
                      "buckets": [list(b) for b in cfg.TPU.TEST_BUCKETS],
                      "dtype": "bfloat16", "launches": launches,
                      "detections": len(dets)}))
    print(json.dumps({"ap_table": "random weights (seed 0, cls bias seed "
                      "1), a synthetic dataset: not an accuracy",
                      **results}))
    shutil.rmtree(tmp, ignore_errors=True)


def _detections_by_image(dets, image_ids):
    """bbox.json entries as match_detections' padded tensors: xyxy boxes
    (+1 convention back from xywh) and category ids, per image."""
    n = max([sum(d["image_id"] == i for d in dets) for i in image_ids]
            + [1])
    boxes = torch.zeros(len(image_ids), n, 4)
    labels = torch.zeros(len(image_ids), n, dtype=torch.int64)
    valid = torch.zeros(len(image_ids), n, dtype=torch.bool)
    for row, img_id in enumerate(image_ids):
        mine = [d for d in dets if d["image_id"] == img_id]
        for j, d in enumerate(mine):
            x, y, w, h = d["bbox"]
            boxes[row, j] = torch.tensor([x, y, x + w - 1, y + h - 1])
            labels[row, j] = d["category_id"]
            valid[row, j] = True
    return {"boxes": boxes, "labels": labels, "valid": valid}


def top_detections_gt(ann_file, bbox_json, out_file, per_image=5):
    """A copy of ``ann_file`` whose ground truth is each image's
    ``per_image`` best detections of a first pass, so that the AP of
    random weights is far from 0; each with the polygon of the octagon
    in its box (data/synth.py), for the segm table."""
    from paa_tpu_torch.data.synth import box_octagon

    with open(ann_file) as f:
        data = json.load(f)
    with open(bbox_json) as f:
        dets = json.load(f)
    data["annotations"] = []
    for img in data["images"]:
        mine = sorted((d for d in dets if d["image_id"] == img["id"]),
                      key=lambda d: -d["score"])[:per_image]
        for d in mine:
            poly, area = box_octagon(*d["bbox"])
            data["annotations"].append(dict(
                id=len(data["annotations"]) + 1, image_id=img["id"],
                bbox=d["bbox"], area=area, segmentation=[poly],
                category_id=d["category_id"], iscrowd=0))
    with open(out_file, "w") as f:
        json.dump(data, f)
    return len(data["annotations"])


def eval_card_vs_cpu(dev, cfg, seed, what, build=seeded_model):
    """The whole eval path of ``cfg`` (``inference``, dataset to AP
    table) in float32 (TF32 off) on the card and on the CPU (plain
    versions) from ``build(dtype, device)``'s weights (phase 5's by
    default), over four PPM images from ``seed``. So that the AP is not
    0 for random weights, the ground truth is the CPU's five best
    detections of each image on a first pass. Detections matched as in
    phase 6; every AP value (the 12 bbox ones, and for Mask R-CNN the 12
    segm ones) within 1e-3. Returns the printed fields and the card
    run's launch counts (set to 0 just before it)."""
    import logging

    from paa_tpu_torch.data.coco import COCODataset
    from paa_tpu_torch.data.synth import synth_coco
    from paa_tpu_torch.engine.inference import inference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="paa_eval_ref_")
    ann_file, img_dir = synth_coco(os.path.join(tmp, "coco"), 4, seed=seed)
    first = COCODataset(ann_file, img_dir,
                        remove_images_without_annotations=False)
    logger = logging.getLogger("chip_smoke.eval")
    models = {d: build("float32", d) for d in (dev, "cpu")}
    folder = os.path.join(tmp, "first")
    inference(cfg, models["cpu"], first, output_folder=folder, logger=logger)
    ids = [r.id for r in first.records]
    top5 = os.path.join(tmp, "cpu_top5.json")
    n_gt = top_detections_gt(ann_file, os.path.join(folder, "bbox.json"),
                             top5)
    dataset = COCODataset(top5, img_dir,
                          remove_images_without_annotations=False)
    results, dets = [], []
    for device in (dev, "cpu"):
        folder = os.path.join(tmp, str(device))
        zero_launch_counts()
        results.append(inference(cfg, models[device], dataset,
                                 output_folder=folder, logger=logger))
        if device == dev:
            launches = launch_counts()
        dets.append(read_bbox_json(folder))
    matched = match_detections(*[_detections_by_image(d, ids)
                                 for d in dets], what)
    ap_err = {k: abs(results[0][k] - v) for k, v in results[1].items()}
    check(sorted(k for k in ap_err if "/" not in k) == sorted(METRICS)
          and sorted(ap_err) == sorted(results[0])
          and max(ap_err.values()) <= 1e-3 and results[1]["AP"] > 0,
          f"{what}: AP {results}")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"images": len(ids), "gt": n_gt, "ap_card": results[0],
            "ap_abs_err": ap_err, **matched}, launches


def phase_eval_card_vs_cpu(dev):
    """``eval_card_vs_cpu`` on the PAA-R50 eval path: the images resized
    to 256 (at most 320) in the buckets (256, 320) and (320, 256)."""
    cfg = build_cfg("float32", PAA_CONFIG, [
        "INPUT.MIN_SIZE_TEST", 256, "INPUT.MAX_SIZE_TEST", 320,
        "TPU.TEST_BUCKETS", ((256, 320), (320, 256)),
        "TEST.IMS_PER_BATCH", 2])
    out, _ = eval_card_vs_cpu(dev, cfg, 12, "eval_card_vs_cpu")
    print(json.dumps({"phase": "eval_card_vs_cpu", "ok": True, **out}))


def phase_gn_grad(dev):
    """The autograd Function around K3 against autograd through the
    plain version, at the towers' shapes of a training batch."""
    from paa_tpu_torch.ops import group_norm as gn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(8)
    worst = {}
    for h, w in TOWER_HW:
        shape = (TRAIN_BATCH, 256, h, w)
        x32 = torch.randn(*shape, generator=gen) * 1.5 + 0.4
        s = (torch.rand(256, generator=gen) + 0.5).to(dev)
        b = (torch.randn(256, generator=gen) * 0.2).to(dev)
        up32 = torch.randn(*shape, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            what = f"{dtype} {'x'.join(map(str, shape))}"
            x, up = x32.to(dev, dtype), up32.to(dev, dtype)
            ins = [t.clone().requires_grad_(True) for t in (x, s, b)]
            before = gn.group_norm_relu.launches
            y = gn.group_norm_relu(*ins)
            check(gn.group_norm_relu.launches == before + 1
                  and type(y.grad_fn).__name__ == "GroupNormReLUBackward",
                  f"gn grad {what}: K3 not launched through the Function")
            y.backward(up)
            refs = [t.clone().requires_grad_(True) for t in (x, s, b)]
            want = gn.group_norm_relu_plain(*refs)
            want.backward(up)
            y, want = y.detach(), want.detach()
            err = (y.float() - want.float()).abs()
            if dtype == torch.float32:
                check(float(err.max()) <= 1e-5,
                      f"gn grad {what}: forward err {float(err.max())}")
            else:
                ulp = _bf16_ulp(torch.maximum(y.float().abs(),
                                              want.float().abs()))
                check(bool((err <= ulp + 1e-6).all()),
                      f"gn grad {what}: forward beyond one ulp")
            for got, ref, n in zip(ins, refs, ("x", "weight", "bias")):
                check(got.grad.dtype == ref.grad.dtype
                      and torch.equal(got.grad, ref.grad),
                      f"gn grad {what}: d{n} differs by "
                      f"{float((got.grad - ref.grad).abs().max())}")
            worst[what] = float(err.max())
    tie = gn_zero_variance_tie(dev)
    print(json.dumps({"phase": "gn_grad_vs_plain", "ok": True,
                      "gradients": "equal", "forward_max_abs_err": worst,
                      "zero_variance_tie_dbias": tie}))


def gn_zero_variance_tie(dev):
    """K3 through the Function at a group of zero variance with a zero
    bias (1 x 64 x 4 x 4, channels 0-1 all 1.0, weight 1, bias[0:2] 0):
    the ReLU input is exactly 0, where the JAX package's custom VJP
    (``jnp.maximum``) gives half the upstream gradient, so d bias of
    channels 0-1 is half their upstream sum, as the plain version's."""
    from paa_tpu_torch.ops import group_norm as gn

    gen = torch.Generator().manual_seed(9)
    x = torch.randn(1, 64, 4, 4, generator=gen) * 1.2 + 0.3
    x[0, 0:2] = 1.0
    b = torch.randn(64, generator=gen) * 0.2
    b[0:2] = 0.0
    up = torch.randn(1, 64, 4, 4, generator=gen).to(dev)
    ins = [t.to(dev).requires_grad_(True) for t in (x, torch.ones(64), b)]
    before = gn.group_norm_relu.launches
    gn.group_norm_relu(*ins).backward(up)
    check(gn.group_norm_relu.launches == before + 1,
          "gn zero-variance tie: K3 not launched")
    want = 0.5 * up[0, 0:2].sum(dim=(1, 2))
    got = ins[2].grad[0:2]
    check(bool(torch.allclose(got, want, rtol=1e-6, atol=0)),
          f"gn zero-variance tie: d bias {got.tolist()}, want "
          f"{want.tolist()}")
    return got.tolist()


def calibrated_frozen_bn(path, extra=()):
    """FrozenBN statistics for the seeded body of ``path``: each
    FrozenBatchNorm's running mean and variance set, in forward order, to
    the per-channel mean and variance (at least 1e-5) of its input over a
    calibration batch (seed 98, 2 x 256 x 320, float32 on the CPU), so
    that the random body's activations keep unit scale, as the
    BatchNorm-folded ImageNet body the configs load does. With the seeded
    model's identity statistics P3-P7 reach ~1e3, which RetinaNet's
    plain towers (no norm) carry into its logits: its train steps
    diverge to NaN by the fourth step, on the CPU as on the card. A head
    with FrozenBatchNorm is calibrated after the body: an FBNet RPN head
    on the body's map, a C4 model's res5 (its box head) and FBNet's box
    and mask heads on the batch's GT boxes. ``extra`` overrides the
    config (a narrow body). Returns the buffers as a state-dict
    subset."""
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.modeling.layers import FrozenBatchNorm
    from paa_tpu_torch.ops.image_norm import device_normalize

    model = build_detection_model(build_cfg("float32", path, extra),
                                  device="cpu", seed=0)

    def calibrate(module, inputs):
        x = inputs[0].to(torch.float32)
        module.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        module.running_var.copy_(x.var(dim=(0, 2, 3)).clamp(min=1e-5))

    hooks = [m.register_forward_pre_hook(calibrate)
             for m in model.module.modules()
             if isinstance(m, FrozenBatchNorm)]
    batch = train_batch(98, 2, (256, 320), (256.0, 300.0))
    x = device_normalize(batch["images"], batch["image_sizes"],
                         model.cfg.INPUT.PIXEL_MEAN, model.cfg.INPUT.PIXEL_STD)
    def frozen(name):
        head = getattr(model.module, name, None)
        return head is not None and any(isinstance(m, FrozenBatchNorm)
                                        for m in head.modules())

    with torch.inference_mode():
        features = model.module.backbone(x.permute(0, 3, 1, 2).contiguous())
        valid = batch["gt_labels"] > 0
        rois = (batch["gt_boxes"][valid], valid.nonzero()[:, 0])
        if frozen("rpn_head"):
            model.module.rpn_head(features)
        if frozen("box_head"):
            model.module.box(features, *rois)
        if frozen("mask_head"):
            model.module.mask(features, *rois)
    for h in hooks:
        h.remove()
    return {k: v.clone() for k, v in model.module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def seeded_train_model(cfg, device, frozen_bn=None):
    """``build_detection_model`` from seed 0, with ``frozen_bn`` (from
    ``calibrated_frozen_bn``) loaded when given."""
    from paa_tpu_torch.modeling import build_detection_model

    model = build_detection_model(cfg, device=device, seed=0)
    if frozen_bn is not None:
        model.module.load_state_dict(frozen_bn, strict=False)
    return model


def phase_train_main_path(dev, path=PAA_CONFIG, what="train_main_path",
                          frozen_bn=None, extra=()):
    """TRAIN_STEPS steps of do_train at full width on one batch of the config's
    SOLVER.IMS_PER_BATCH images (16; RetinaNet's 8); the launch counts
    set to 0 just before and read just after. ``frozen_bn``, if given,
    replaces the seeded FrozenBN statistics; ``extra`` overrides the
    config. Returns the trained model and the launch counts."""
    from paa_tpu_torch.engine import do_train

    cfg = build_cfg("bfloat16", path,
                    ["SOLVER.MAX_ITER", TRAIN_STEPS, *extra])
    model = seeded_train_model(cfg, dev, frozen_bn)
    state = train_state(model)
    batch = train_batch(70, cfg.SOLVER.IMS_PER_BATCH, HW, SIZE)
    seen = {}
    zero_launch_counts()
    do_train(cfg, model, state, [batch] * TRAIN_STEPS,
             metric_hook=lambda i, m: seen.update({i: m}))
    launches = launch_counts()
    expected = {"nms_batched": 0, "nms_global": 0,
                "group_norm_relu": gn_per_forward(model) * TRAIN_STEPS,
                "deform_im2col": 2 * dcn_per_forward(model) * TRAIN_STEPS,
                "deform_col2im": dcn_per_forward(model) * TRAIN_STEPS}
    check(launches == expected,
          f"{what}: launches {launches}, expected {expected}")
    check(sorted(seen) == list(range(1, TRAIN_STEPS + 1)),
          f"{what}: metrics of steps {sorted(seen)}")
    for i, m in seen.items():
        check(all(math.isfinite(v) for v in m.values()),
              f"{what}: step {i} {m}")
        check(m["num_pos"] > 0, f"{what}: step {i} no positives")
    check(seen[TRAIN_STEPS]["loss"] < seen[1]["loss"],
          f"{what}: loss {seen[1]['loss']} -> "
          f"{seen[TRAIN_STEPS]['loss']}")
    n_gt = (batch["gt_labels"] > 0).sum(dim=1).tolist()
    print(json.dumps({
        "phase": what, "ok": True, "batch": cfg.SOLVER.IMS_PER_BATCH,
        "hw": HW, "max_gt": MAX_GT, "gt_per_image": n_gt,
        "steps": TRAIN_STEPS, "dtype": "bfloat16", "launches": launches,
        "losses": {k: [seen[i][k] for i in sorted(seen)]
                   for k in seen[1]}}))
    return model, launches


def _assigned_labels(loss, outputs, gt_boxes, gt_labels, anchors, counts,
                     lc):
    """The labels of the assignment that the ATSS, FCOS or RetinaNet loss
    ``loss`` computes inside (its assignment function, run again on the
    same inputs)."""
    from paa_tpu_torch.modeling import atss_loss, fcos_loss, retinanet_head

    gt_boxes = gt_boxes.to(torch.float32)
    if loss is atss_loss.atss_loss:
        return atss_loss.atss_assignment(gt_boxes, gt_labels, anchors,
                                         counts, lc)[0]
    if loss is fcos_loss.fcos_loss:
        return fcos_loss.fcos_assign(gt_boxes, gt_labels, anchors[:, :2],
                                     counts, lc)[0]
    return retinanet_head.retinanet_assign(gt_boxes, gt_labels, anchors,
                                           lc)[0]


def _with_pos_mask(loss):
    """``loss`` that also reports its positive mask among the step's
    metrics (the train step sums only the ``loss_*`` entries): PAA's
    from ``return_aux``; for the other heads the labels of their
    assignment (their positives are the labels > 0), so that comparing
    them compares the classes too."""
    from paa_tpu_torch.modeling.paa_loss import paa_loss

    def call(*args, **kwargs):
        if loss is paa_loss:
            out, aux = loss(*args, return_aux=True, **kwargs)
            return {**out, "pos_mask": aux["pos_mask"]}
        return {**loss(*args, **kwargs),
                "pos_mask": _assigned_labels(loss, *args)}
    return call


def train_once(model, batch):
    """One train step of ``model`` on ``batch`` with a fresh optimizer:
    (host metrics, the step's positive mask, the parameters before and
    after it), all on the CPU. "After" is the step's update as SGD
    computed it, before - lr x its first momentum buffer (g + wd x p), in
    float64: the float32 parameters store an update of a few ulps of
    their weights only to the ulp (FPN P7's, whose update is mostly
    weight decay, is 3-6 ulps of its largest weight), which the update
    comparisons would read as an error of a sixth to a third of it."""
    loss_call, loss_cfg = model.loss_fn()
    model.loss_fn = lambda: (_with_pos_mask(loss_call), loss_cfg)
    state = train_state(model)
    params = dict(model.module.named_parameters())
    before = {n: p.detach().cpu().clone() for n, p in params.items()}
    metrics = model.make_bucket_train_step(
        tuple(batch["images"].shape[1:3]))(state, batch)
    pos_mask = metrics.pop("pos_mask").cpu()
    return ({k: float(v) for k, v in metrics.items()}, pos_mask, before,
            sgd_update(state, params, before))


def sgd_update(state, params, before):
    """The parameters after a first SGD step as it computed them, in
    float64: before - lr x the momentum buffer (see ``train_once``)."""
    lr = {id(p): g["lr"] for g in state.optimizer.param_groups
          for p in g["params"]}
    after = {}
    for n, p in params.items():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        after[n] = before[n].double() if buf is None else (
            before[n].double() - lr[id(p)] * buf.detach().cpu().double())
    return after


def update_norm_err(got, want, before):
    """|update of got - update of want| over |update of want|, 2-norms."""
    upd = want - before
    return float((got - want).norm() / upd.norm().clamp(min=1e-30))


def update_errors(got, want, before):
    """The four parameter tensors whose update (after - before) in
    ``got`` is farthest from that in ``want``: by the difference's norm
    over the update's norm, and by its largest element over the update's
    largest element."""
    share, norm = {}, {}
    for n, p in want.items():
        upd = p - before[n]
        diff = got[n] - before[n] - upd
        share[n] = float(diff.abs().max() / upd.abs().max().clamp(min=1e-30))
        norm[n] = float(diff.norm() / upd.norm().clamp(min=1e-30))
    def worst_first(kv):  # a NaN (a broken update) ranks worst
        return -math.inf if math.isnan(kv[1]) else -kv[1]

    return (sorted(norm.items(), key=worst_first)[:4],
            sorted(share.items(), key=worst_first)[:4])


def _gn_plain_stats_detached(x, weight, bias, num_groups=32, eps=1e-5,
                             relu=True):
    """group_norm_relu_plain with its group statistics taken as constants:
    a wrong gradient of x (the mean and variance terms are missing)."""
    b, c, h, w = x.shape
    xf = x.to(torch.float32).reshape(b, num_groups, -1)
    mean = xf.mean(dim=2, keepdim=True).detach()
    var = (xf - mean).square().mean(dim=2, keepdim=True).detach()
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    out = xn * weight[:, None, None] + bias[:, None, None]
    return (torch.relu(out) if relu else out).to(x.dtype)


# about 3x the worst of the card's step against the CPU's, and of either
# against the float64 referee, on an H100 80GB HBM3 (3.1e-3 and 9.7e-3;
# PERF.md, PR 6)
UPDATE_NORM_TOL, UPDATE_SHARE_TOL = 9e-3, 2.9e-2


def _gn_faults():
    """Faults planted in K3's gradient: GroupNormReLU's backward
    recomputes through the module's group_norm_relu_plain, which each
    fault replaces for one step."""
    from paa_tpu_torch.ops import group_norm as gn

    plain = gn.group_norm_relu_plain
    return {"gn_stats_detached": (gn, "group_norm_relu_plain",
                                  _gn_plain_stats_detached),
            "gn_dx_x1.05": (gn, "group_norm_relu_plain",
                            lambda x, *args: plain(
                                x.detach() + (x - x.detach()) * 1.05,
                                *args))}


def _fcos_centerness_fault():
    """FCOS's centerness targets scaled by 1.05 (they weight the IoU loss
    and are the branch's BCE targets)."""
    from paa_tpu_torch.modeling import fcos_loss

    plain = fcos_loss.compute_centerness_targets_ltrb
    return {"fcos_centerness_x1.05": (
        fcos_loss, "compute_centerness_targets_ltrb",
        lambda r: plain(r) * 1.05)}


def phase_train_reference(dev, path=PAA_CONFIG, what="train_card_vs_cpu",
                          faults=_gn_faults):
    """One float32 train step on the card against the same on the CPU
    (plain versions), from the same weights and batch at 2 x 256 x 320:
    losses within 1e-4 relative, num_pos and the positive mask (for
    ATSS, FCOS and RetinaNet the assignment's labels) equal;
    each parameter tensor's update (after - before) within
    UPDATE_NORM_TOL of its norm, and every element within
    UPDATE_SHARE_TOL of the tensor's largest update. Both float32 steps
    are also held to those limits against a float64 step on the CPU
    (``float64_referee``). Why the limits are not tighter: the two sides
    round in float32 in different orders and by different algorithms.
    The referee shows it: the card's convolutions round ~4x coarser than
    the CPU's (``conv_precision_probe``), cuDNN's algorithms add ~3e-4 of
    update error in the head and the FPN that PyTorch's own convolutions
    on the card do not, and K3 adds nothing (its plain forward gives the
    same updates); the head's GroupNorm gradients subtract group means,
    which amplifies what differs. On an H100 80GB HBM3 the worst tensor
    was at 3.1e-3 of its norm and 9.7e-3 of its largest element, the
    same in every run, both against the CPU and against float64
    (PERF.md). The same step on the card with each fault of ``faults()``
    planted must land beyond the limits: for PAA-R50 two in K3's
    gradient (the group statistics taken as constants; x's gradient 1.05
    times the right one, ``_gn_faults``), for FCOS its centerness
    targets x1.05; ``faults`` None plants none."""
    from paa_tpu_torch.modeling import build_detection_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = build_cfg("float32", path)
    batch = train_batch(99, 2, (256, 320), (256.0, 300.0))
    runs = [train_once(build_detection_model(cfg, device=d, seed=0), batch)
            for d in (dev, "cpu")]
    (m_gpu, pos_gpu, before, p_gpu), (m_cpu, pos_cpu, _, p_cpu) = runs
    loss_err = {k: abs(m_gpu[k] - v) / max(abs(v), 1e-12)
                for k, v in m_cpu.items()}
    worst_norm, worst_share = update_errors(p_gpu, p_cpu, before)
    referee = float64_referee(dev, cfg, batch, before, p_gpu, p_cpu,
                              pos_cpu)
    referee["conv_probe"] = conv_precision_probe(dev)
    check(m_gpu["num_pos"] == m_cpu["num_pos"] > 0
          and torch.equal(pos_gpu, pos_cpu),
          f"{what}: positive masks differ")
    check(max(loss_err.values()) <= 1e-4, f"{what}: {loss_err}")
    check(worst_norm[0][1] <= UPDATE_NORM_TOL
          and worst_share[0][1] <= UPDATE_SHARE_TOL,
          f"{what}: updates {worst_norm} {worst_share}")
    planted = {}
    for fault, (module, attr, fn) in (faults() if faults else {}).items():
        plain = getattr(module, attr)
        setattr(module, attr, fn)
        try:
            _, _, _, p_bad = train_once(
                build_detection_model(cfg, device=dev, seed=0), batch)
        finally:
            setattr(module, attr, plain)
        f_norm, f_share = update_errors(p_bad, p_cpu, before)
        planted[fault] = {"worst_update_norm_err": f_norm[0],
                          "worst_update_share": f_share[0]}
        check(f_norm[0][1] > UPDATE_NORM_TOL
              or f_share[0][1] > UPDATE_SHARE_TOL,
              f"{what}: planted {fault} within the limits: "
              f"{f_norm} {f_share}")
    print(json.dumps({"phase": what, "ok": True,
                      "hw": [256, 320], "num_pos": m_gpu["num_pos"],
                      "loss_rel_err": loss_err,
                      "worst_update_norm_err": worst_norm,
                      "worst_update_share": worst_share,
                      "float64_referee": referee,
                      "planted_faults": planted}))


def conv_precision_probe(dev):
    """How far one float32 convolution of the head towers (B=2 at the
    five pyramid levels of a 256 x 320 input, 3 x 3, 256 channels) is
    from float64: the largest relative 2-norm error over the levels of
    the output, the input gradient and the weight gradient, on the CPU
    and on the card (TF32 off), by level."""
    gen = torch.Generator().manual_seed(13)
    w = torch.randn(256, 256, 3, 3, generator=gen,
                    dtype=torch.float64) / 48.0
    out = {}
    for h, wd in ((32, 40), (16, 20), (8, 10), (4, 5), (2, 3)):
        x = torch.randn(2, 256, h, wd, generator=gen, dtype=torch.float64)
        up = torch.randn(2, 256, h, wd, generator=gen, dtype=torch.float64)

        def run(device, dtype):
            xs, ws = (t.to(device, dtype).clone().requires_grad_(True)
                      for t in (x, w))
            y = F.conv2d(xs, ws, padding=1)
            y.backward(up.to(device, dtype))
            return [t.detach().cpu().double()
                    for t in (y, xs.grad, ws.grad)]

        want = run("cpu", torch.float64)
        out[f"{h}x{wd}"] = {
            side: {n: float(f"{float((g - r).norm() / r.norm()):.3g}")
                   for n, g, r in zip(("fprop", "dgrad", "wgrad"),
                                      run(d, torch.float32), want)}
            for side, d in (("cpu", "cpu"), ("card", dev))}
    return out


def in_float64(model):
    """``model`` with every convolution, transposed convolution and
    DeformConv computing in float64 (FrozenBN and GroupNorm follow their
    inputs; the box head's FCs, the loss, the GMM, the parameters and SGD
    stay float32)."""
    from paa_tpu_torch.modeling import layers

    for m in model.module.modules():
        if isinstance(m, (layers.Conv, layers.ConvTranspose,
                          layers.DeformConv)):
            m.dtype = torch.float64
    return model


def float64_referee(dev, cfg, batch, before, p_gpu, p_cpu, pos_cpu):
    """The same step once more on the CPU with the network in float64
    (every convolution, FrozenBN and GroupNorm; the loss and the GMM
    stay float32, the parameters and SGD too): its positive mask must be
    the float32 steps', and each float32 step, the card's and the CPU's,
    within the update limits of it. Two more card steps say where the
    card's error comes from: one with cuDNN off (PyTorch's own
    convolutions, TF32 off) and one with the towers' GroupNorm+ReLU
    forward the plain version in place of K3."""
    from paa_tpu_torch.modeling import build_detection_model, layers
    from paa_tpu_torch.ops import group_norm as gn

    model = in_float64(build_detection_model(cfg, device="cpu", seed=0))
    _, pos64, before64, p64 = train_once(model, batch)
    check(all(torch.equal(before[n], before64[n]) for n in before)
          and torch.equal(pos64, pos_cpu),
          "train_card_vs_cpu: the float64 step's positives differ")
    torch.backends.cudnn.enabled = False
    try:
        _, _, _, p_native = train_once(
            build_detection_model(cfg, device=dev, seed=0), batch)
    finally:
        torch.backends.cudnn.enabled = True
    kernel = layers.group_norm_relu
    layers.group_norm_relu = lambda x, w, b, g, eps, relu=True: \
        gn.GroupNormReLU.apply(x, w, b, g, eps, gn.group_norm_relu_plain, relu)
    try:
        _, _, _, p_plain_gn = train_once(
            build_detection_model(cfg, device=dev, seed=0), batch)
    finally:
        layers.group_norm_relu = kernel
    sides = {"card_f32": p_gpu, "cpu_f32": p_cpu,
             "card_f32_cudnn_off": p_native,
             "card_f32_plain_gn": p_plain_gn}
    out = {}
    for side, params in sides.items():
        norm, share = update_errors(params, p64, before)
        out[side] = {"worst_update_norm_err": norm[0],
                     "worst_update_share": share[0]}
        if side in ("card_f32", "cpu_f32"):
            check(norm[0][1] <= UPDATE_NORM_TOL
                  and share[0][1] <= UPDATE_SHARE_TOL,
                  f"train_card_vs_cpu: {side} against float64: "
                  f"{norm} {share}")
    # the norm error of every tensor that some side has above 1e-4, in
    # the module's order (sides as above)
    errs = {n: [update_norm_err(p[n], p64[n], before[n])
                for p in sides.values()] for n in before}
    out["norm_err_above_1e-4"] = {
        n: [float(f"{e:.3g}") for e in v] for n, v in errs.items()
        if max(v) > 1e-4}
    return out


def phase_dcnv2_main_path(dev):
    """The X-152 dcnv2 main path: paa_dcnv2_X_152_32x8d_FPN_2x at full
    width (32x8d ResNeXt, R-152 depth, modulated DCN in stages 3-5 and
    the towers' last conv) in bfloat16, weights from seed 0, cls bias
    from seed 1, offset convs from seed 2, serving three 8 x 800 x 1344
    requests through make_eval_fn: K1 once, K3 40 and K4 57 times per
    request. Returns the launch counts."""
    model = seeded_dcnv2("bfloat16", dev)
    return serve(
        model, "dcnv2_x152_main_path", 70,
        {"nms_batched": 3, "nms_global": 0, "group_norm_relu": 120,
         "deform_im2col": 3 * dcn_per_forward(model), "deform_col2im": 0},
        0.0)


DCN_SHAPES = [  # name, channels, (H, W), groups, head tower conv
    ("stage3", 512, (100, 168), 32, False),
    ("stage4", 1024, (50, 84), 32, False),
    ("tower_p3", 256, (100, 168), 1, True),
]


def phase_dcn_card_vs_cpu(dev):
    """One DeformConv (offset conv from seed, as in the main path) at the
    main path's stage-3, stage-4 and P3 tower shapes, B=1, on the card
    against the CPU: float32 (TF32 off) within rtol = atol = 2e-4, and
    bfloat16 on the card within DCN_BF16_REL of the CPU's float32
    output's largest magnitude."""
    from paa_tpu_torch.modeling.layers import reset_parameters
    from paa_tpu_torch.modeling.layers import DeformConv

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for i, (what, c, hw, groups, tower) in enumerate(DCN_SHAPES):
        conv = DeformConv(c, c, groups=groups, bias=tower,
                          normal_std=0.01 if tower else None)
        gen = torch.Generator().manual_seed(100 + i)
        reset_parameters(conv, gen)
        seed_offset_convs(conv, 200 + i)
        if tower:
            with torch.no_grad():
                conv.bias.normal_(0.0, 0.1, generator=gen)
        x = torch.randn((1, c, *hw), generator=gen)
        with torch.inference_mode():
            want = conv(x)
            conv.to(dev)
            got32 = conv(x.to(dev)).cpu()
            conv.dtype = torch.bfloat16
            got16 = conv(x.to(dev)).float().cpu()
        err32 = (got32 - want).abs()
        check(bool((err32 <= 2e-4 + 2e-4 * want.abs()).all()),
              f"dcn_card_vs_cpu {what}: float32 max err "
              f"{float(err32.max())}")
        rel16 = float((got16 - want).abs().max() / want.abs().max())
        check(rel16 <= DCN_BF16_REL,
              f"dcn_card_vs_cpu {what}: bfloat16 rel err {rel16}")
        out[what] = {"channels": c, "hw": hw, "groups": groups,
                     "f32_max_abs_err": float(err32.max()),
                     "bf16_rel_err": rel16}
    print(json.dumps({"phase": "dcn_card_vs_cpu", "ok": True,
                      "bf16_bound": DCN_BF16_REL, "shapes": out}))


def phase_dcnv2_card_vs_cpu(dev):
    card_vs_cpu(dev, seeded_dcnv2, lambda m, x: m.module(x),
                "dcnv2_card_vs_cpu")


# ---- training and test-time augmentation of the X-152 dcnv2 config -----

# the X-152 dcnv2 training cell's batch: the largest of these that fits
DCN_TRAIN_BATCHES = (8, 4, 2)
# the X-152 training main path's steps (cut from TRAIN_STEPS' 10 to 5 to
# keep the script near its time with phases 39-44 added, to 3 with
# phases 64-66 and to 2 with phase 67; its loss falls monotonically from
# the first step)
DCN_TRAIN_STEPS = 2
# DeformConv2dFunction against autograd through deform_conv2d on the
# card, within this share of each gradient's largest magnitude: K5's
# atomics and the plain version's index_add (the row gather's backward)
# add in no fixed order, a few float32 roundings (~1e-6) or, in
# bfloat16, where every add of the plain version rounds to 8 bits, a few
# bfloat16 roundings (~1e-2)
DCN_GRAD_LIMITS = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
TTA_IMAGES = 1


def dcn_layer_inputs(dev, c, hw, groups, tower, bsz, seed):
    """One DeformConv's raw inputs at a main-path shape: x, the offsets
    and the mask that its offset conv (drawn from a seed as in phase 20)
    gives on x, its weight and an upstream gradient, float32 on ``dev``."""
    from paa_tpu_torch.modeling.layers import reset_parameters
    from paa_tpu_torch.modeling.layers import DeformConv

    conv = DeformConv(c, c, groups=groups, bias=tower,
                      normal_std=0.01 if tower else None)
    gen = torch.Generator().manual_seed(300 + seed)
    reset_parameters(conv, gen)
    seed_offset_convs(conv, 400 + seed)
    x = torch.randn((bsz, c, *hw), generator=gen).to(dev)
    up = torch.randn((bsz, c, *hw), generator=gen).to(dev)
    conv.to(dev)
    with torch.no_grad():
        om = conv.offset(x)
        offsets = om[:, :conv.n_offsets].contiguous()
        mask = torch.sigmoid(om[:, conv.n_offsets:]).contiguous()
    return x, offsets, mask, conv.weight.detach().clone(), up


def _dcn_leaves(x, offsets, mask, weight, dtype):
    """x and weight in ``dtype``, offsets and mask float32 (as DeformConv
    passes them), each a fresh leaf."""
    return [t.to(dtype if i in (0, 3) else torch.float32).clone()
            .requires_grad_() for i, t in enumerate((x, offsets, mask,
                                                     weight))]


def dcn_layer_grads(fn, x, offsets, mask, weight, up, dtype, groups):
    ins = _dcn_leaves(x, offsets, mask, weight, dtype)
    fn(*ins, 1, 1, 1, groups, 1).backward(up.to(dtype))
    return [t.grad for t in ins]


def dcn_layer_peak_gb(dev, fn, x, offsets, mask, weight, up, dtype, groups):
    """Peak device memory of one layer's forward and backward through
    ``fn``, above what was allocated before it (its inputs)."""
    ins = _dcn_leaves(x, offsets, mask, weight, dtype)
    upd = up.to(dtype)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn(*ins, 1, 1, 1, groups, 1).backward(upd)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    del ins, upd
    torch.cuda.empty_cache()
    return peak / 2**30


# the X-152 path's DCN layers at B=8, 800 x 1344: (channels, Ho, Wo,
# groups) and how many a forward runs (47 in the body, the two towers'
# at each level), as kernel_ab.py's K4_SHAPES
K4_PATH_SHAPES = {
    "res3": ((512, 100, 168, 32), 8), "res4": ((1024, 50, 84, 32), 36),
    "res5": ((2048, 25, 42, 32), 3), "tower_p3": ((256, 100, 168, 1), 2),
    "tower_p4": ((256, 50, 84, 1), 2), "tower_p5": ((256, 25, 42, 1), 2),
    "tower_p6": ((256, 13, 21, 1), 2), "tower_p7": ((256, 7, 11, 1), 2)}


def phase_k4_at_path_shapes(dev, launches, requests):
    """Phase 68: K4 at every shape of ``launches``, those that
    ``recording_k4_launches`` recorded over phase 20's ``requests``
    requests, which must be K4_PATH_SHAPES's at B=8 in bfloat16, each as
    often as the requests' forwards need. Returns the largest errors."""
    from paa_tpu_torch.ops import deform_sampling as ds

    layers = {layer: what for what, (layer, _) in K4_PATH_SHAPES.items()}
    keys = sorted(set(launches), key=str)
    counts = collections.Counter(
        layers.get((*k[0][1:], k[7])) for k in launches)
    want = {what: requests * n for what, (_, n) in K4_PATH_SHAPES.items()}
    check(dict(counts) == want and all(
        k[0][0] == BATCH and k[1] == torch.bfloat16
        and k[2:7] == (3, 3, 1, 1, 1) and k[8] == 1 for k in keys),
        f"k4_at_path_shapes: launches {dict(counts)} at {keys}, expected "
        f"{want}")
    gen = torch.Generator(dev).manual_seed(19)
    worst = {"f32": 0.0, "bf16": 0.0}
    for key in keys:
        shape, _, kh, kw, stride, pad, dil, groups, dg, modulated = key
        what = layers[(*shape[1:], groups)]
        b, c, h, w = shape
        ho = ds._out_size(h, kh, stride, pad, dil)
        wo = ds._out_size(w, kw, stride, pad, dil)
        x = torch.randn(shape, generator=gen, device=dev)
        offsets = torch.randn(b, dg * kh * kw * 2, ho, wo, generator=gen,
                              device=dev) * 2
        mask = (torch.rand(b, dg * kh * kw, ho, wo, generator=gen,
                           device=dev) if modulated else None)
        args = (offsets, mask, kh, kw, stride, pad, dil, groups, dg)
        got = ds.deform_im2col(x, *args)
        plain = ds._im2col_columns(x, *args)
        scale = float(plain.abs().max())
        err = float((got - plain).abs().max()) / scale
        check(err <= 1e-6, f"k4_at_path_shapes: {what} float32 off by "
              f"{err} of the largest column")
        worst["f32"] = max(worst["f32"], err)
        del got, plain
        x = x.to(torch.bfloat16)
        got = ds.deform_im2col(x, *args).float()
        plain = ds._im2col_columns(x.float(), *args)
        scale = float(plain.abs().max())
        # one rounding to bfloat16: half an ulp, 2^-8 of the value at most
        excess = float(((got - plain).abs() - 2 ** -8 * plain.abs()).max())
        check(excess <= 1e-6 * scale, f"k4_at_path_shapes: {what} "
              f"bfloat16 beyond one rounding by {excess / scale} of the "
              f"largest column")
        worst["bf16"] = max(worst["bf16"],
                            float((got - plain).abs().max()) / scale)
        del got, plain, x, offsets, mask
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "k4_at_path_shapes", "ok": True,
                      "B": BATCH, "shapes": len(keys),
                      "launches": len(launches), "max_rel_err": worst}))
    return worst


def phase_dcn_backward_card(dev):
    """ops/dcn.py's DeformConv2dFunction (whose backward keeps only x,
    offsets, mask and weight, and on the card takes
    ``deform_conv2d_columns_backward``: the columns' gradient, K4's
    columns for the weight's, K5 for the rest) against autograd through
    deform_conv2d on the card, at the X-152 path's stage-3, stage-4 and
    P3 tower shapes, B=2, offsets from a seed: the gradients of x,
    offsets, mask and weight in float32 (TF32 off) and bfloat16 within
    DCN_GRAD_LIMITS of each one's largest magnitude. Then the peak
    memory of one stage-3 layer's forward and backward in bfloat16 at the
    training cell's first batch (8) with each: the Function's must be
    the lower."""
    from paa_tpu_torch.ops import dcn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("x", "offsets", "mask", "weight")
    out = {}
    for i, (what, c, hw, groups, tower) in enumerate(DCN_SHAPES):
        inputs = dcn_layer_inputs(dev, c, hw, groups, tower, 2, i)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            got = dcn_layer_grads(dcn.DeformConv2dFunction.apply, *inputs,
                                  dtype, groups)
            want = dcn_layer_grads(dcn.deform_conv2d, *inputs, dtype,
                                   groups)
            for n, g, w in zip(names, got, want):
                check(g.dtype == w.dtype, f"dcn_backward {what} d{n} dtype")
                w = w.float()
                err = float((g.float() - w).abs().max() / w.abs().max())
                check(err <= DCN_GRAD_LIMITS[dtype],
                      f"dcn_backward {what} {dtype} d{n}: rel err {err}")
                errs[f"{str(dtype)[6:]}_d{n}"] = err
        out[what] = errs
        del inputs
    what, c, hw, groups, tower = DCN_SHAPES[0]
    bsz = DCN_TRAIN_BATCHES[0]
    inputs = dcn_layer_inputs(dev, c, hw, groups, tower, bsz, 0)
    peaks = {route: dcn_layer_peak_gb(dev, fn, *inputs, torch.bfloat16,
                                      groups)
             for route, fn in (("function", dcn.DeformConv2dFunction.apply),
                               ("plain_autograd", dcn.deform_conv2d))}
    del inputs
    torch.cuda.empty_cache()
    check(peaks["function"] < peaks["plain_autograd"],
          f"dcn_backward: peak memory {peaks}")
    print(json.dumps({"phase": "dcn_backward_card", "ok": True,
                      "batch": 2, "limits": {str(k)[6:]: v for k, v in
                                             DCN_GRAD_LIMITS.items()},
                      "max_rel_err": out,
                      "stage3_layer_peak_gb": {
                          "batch": bsz, "dtype": "bfloat16",
                          "chunk_images": dcn._images_per_chunk(
                              torch.empty(bsz, c, 1, 1,
                                          dtype=torch.bfloat16),
                              *hw, 9, per_channel=1),
                          **peaks}}))


def phase_k5_at_path_shapes(dev, launches, steps):
    """Phase 69: K5 (the deformable col2im, the gradient of K4's
    sampling) at every shape of ``launches``, those that
    ``recording_k5_launches`` recorded over phase 24's ``steps`` steps of
    do_train, which must be K4_PATH_SHAPES's at B=8 in bfloat16, each
    layer once a step (one chunk a layer); offsets normal(0, 2 px), the
    mask uniform. K5 called once at B=8 in float32 and in bfloat16,
    each two-image slice of its gradients against its plain version
    ``_col2im_grads`` on the same slice (each image's gradients depend
    on that image alone), within 1e-5 of each gradient's largest
    magnitude (both sum the same values in float32, in another order; in
    bfloat16 dx also within one bfloat16 ulp of each value). Returns the
    largest errors."""
    from paa_tpu_torch.ops import dcn
    from paa_tpu_torch.ops import deform_sampling as ds

    layers = {layer: what for what, (layer, _) in K4_PATH_SHAPES.items()}
    keys = sorted(set(launches), key=str)
    counts = collections.Counter(
        layers.get((*k[0][1:], k[7])) for k in launches)
    want = {what: steps * n for what, (_, n) in K4_PATH_SHAPES.items()}
    check(dict(counts) == want and all(
        k[0][0] == BATCH and k[1] == torch.bfloat16
        and k[2:7] == (3, 3, 1, 1, 1) and k[8] == 1 and k[9] for k in keys),
        f"k5_at_path_shapes: launches {dict(counts)} at {keys}, expected "
        f"{want}")
    gen = torch.Generator(dev).manual_seed(23)
    worst = {"f32": 0.0, "bf16": 0.0}
    for key in keys:
        shape, _, kh, kw, stride, pad, dil, groups, dg, _ = key
        what = layers[(*shape[1:], groups)]
        b, c, h, w = shape
        ho = ds._out_size(h, kh, stride, pad, dil)
        wo = ds._out_size(w, kw, stride, pad, dil)
        x = torch.randn(shape, generator=gen, device=dev)
        offsets = torch.randn(b, dg * kh * kw * 2, ho, wo, generator=gen,
                              device=dev) * 2
        mask = torch.rand(b, dg * kh * kw, ho, wo, generator=gen,
                          device=dev)
        weight = torch.randn(c, c // groups, kh, kw, generator=gen,
                             device=dev) * 0.05
        up = torch.randn(b, c, ho, wo, generator=gen, device=dev)
        conv = (stride, pad, dil, groups, dg)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            xs = x.to(dtype)
            dcol = dcn._columns_grad(up.to(dtype), weight.to(dtype), groups)
            got = ds.deform_col2im(xs, offsets, mask, dcol, kh, kw, *conv)
            for i in range(0, b, 2):
                j = i + 2
                plain = ds._col2im_grads(xs[i:j], offsets[i:j], mask[i:j],
                                         dcol[i:j], kh, kw, *conv)
                for grad, g, ref in zip(("dx", "doffsets", "dmask"), got,
                                        plain):
                    g, ref = g[i:j].float(), ref.float()
                    # dx in bfloat16: the two float32 sums rounded once
                    # each, one ulp apart at most
                    rounding = (2 ** -7 * ref.abs() if grad == "dx"
                                and dtype == torch.bfloat16 else 0)
                    excess = float(((g - ref).abs() - rounding).max()
                                   / ref.abs().max())
                    check(excess <= 1e-5, f"k5_at_path_shapes: {what} "
                          f"{tag} {grad} of images {i}-{j - 1} off by "
                          f"{excess} of the largest gradient")
                    worst[tag] = max(worst[tag], float(
                        (g - ref).abs().max() / ref.abs().max()))
                del plain
            del xs, dcol, got
        del x, offsets, mask, weight, up
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "k5_at_path_shapes", "ok": True,
                      "B": BATCH, "shapes": len(keys),
                      "launches": len(launches), "max_rel_err": worst}))
    return worst


def seeded_dcnv2_train(cfg, device):
    """The X-152 dcnv2 model of ``cfg`` with weights from seed 0 and its
    offset convs from seed 2 (as phase 20; the cls bias at the focal
    prior, as a training run starts)."""
    from paa_tpu_torch.modeling import build_detection_model

    model = build_detection_model(cfg, device=device, seed=0)
    seed_offset_convs(model.module, 2)
    return model


def phase_dcnv2_train_main_path(dev):
    """The X-152 dcnv2 training main path at full width in bfloat16,
    the config's SOLVER: DCN_TRAIN_STEPS (2) steps of do_train on one
    repeated batch of uint8 800 x 1344 images (content 800 x 1333) with
    3-12 GTs in 100 slots, at the largest batch of DCN_TRAIN_BATCHES
    that fits; the launch counts set to 0 just before and read just
    after. Then one step at each of two buckets of the config's ladder,
    (800, 1344) and (1344, 800). Returns the launch counts and K5's
    launches over do_train (``recording_k5_launches``)."""
    import gc

    from paa_tpu_torch.engine import do_train

    cfg = build_cfg("bfloat16", DCNV2_CONFIG,
                    ["SOLVER.MAX_ITER", DCN_TRAIN_STEPS])
    too_big = []
    for bsz in DCN_TRAIN_BATCHES:
        model = seeded_dcnv2_train(cfg, dev)
        state = train_state(model)
        batch = train_batch(71, bsz, HW, SIZE)
        seen = {}
        zero_launch_counts()
        fits = True
        try:
            with recording_k5_launches() as k5_launches:
                do_train(cfg, model, state, [batch] * DCN_TRAIN_STEPS,
                         metric_hook=lambda i, m: seen.update({i: m}))
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            fits = False
        if fits:
            break
        too_big.append(bsz)
        del model, state, batch
        gc.collect()
        torch.cuda.empty_cache()
    else:
        check(False, f"dcnv2_train: no batch of {DCN_TRAIN_BATCHES} fits")
    launches = launch_counts()
    expected = {"nms_batched": 0, "nms_global": 0,
                "group_norm_relu": GN_PER_LEVEL * len(TOWER_HW)
                * DCN_TRAIN_STEPS,
                "deform_im2col": 2 * dcn_per_forward(model)
                * DCN_TRAIN_STEPS,
                "deform_col2im": dcn_per_forward(model) * DCN_TRAIN_STEPS}
    check(launches == expected,
          f"dcnv2_train: launches {launches}, expected {expected}")
    check(sorted(seen) == list(range(1, DCN_TRAIN_STEPS + 1)),
          f"dcnv2_train: metrics of steps {sorted(seen)}")
    for i, m in seen.items():
        check(all(math.isfinite(v) for v in m.values()),
              f"dcnv2_train: step {i} {m}")
        check(m["num_pos"] > 0, f"dcnv2_train: step {i} no positives")
    check(seen[DCN_TRAIN_STEPS]["loss"] < seen[1]["loss"],
          f"dcnv2_train: loss {seen[1]['loss']} -> "
          f"{seen[DCN_TRAIN_STEPS]['loss']}")
    buckets = {}
    for i, (hw, size) in enumerate((((800, 1344), (800.0, 1333.0)),
                                    ((1344, 800), (1333.0, 800.0)))):
        step = model.make_bucket_train_step(hw)
        zero_launch_counts()
        m = step(state, train_batch(72 + i, bsz, hw, size))
        m = {k: float(v) for k, v in m.items()}
        got = launch_counts()["group_norm_relu"]
        check(all(math.isfinite(v) for v in m.values()) and m["num_pos"] > 0
              and got == GN_PER_LEVEL * len(TOWER_HW),
              f"dcnv2_train: bucket {hw}: {m}, K3 {got}")
        buckets["x".join(map(str, hw))] = {"loss": m["loss"],
                                           "num_pos": m["num_pos"]}
    n_gt = (batch["gt_labels"] > 0).sum(dim=1).tolist()
    print(json.dumps({
        "phase": "dcnv2_x152_train_main_path", "ok": True, "hw": HW,
        "batch": bsz, "too_big": too_big, "max_gt": MAX_GT,
        "gt_per_image": n_gt, "steps": DCN_TRAIN_STEPS,
        "dtype": "bfloat16", "launches": launches,
        "losses": {k: [seen[i][k] for i in sorted(seen)] for k in seen[1]},
        "buckets": buckets}))
    del model, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches, k5_launches


def build_off_the_grid(cfg, device):
    """The X-152 dcnv2 model of ``cfg`` with weights from seed 0 and its
    offset convs from ``seed_offsets_off_the_grid`` (seed 5)."""
    from paa_tpu_torch.modeling import build_detection_model

    model = build_detection_model(cfg, device=device, seed=0)
    seed_offsets_off_the_grid(model.module, 5)
    return model


def _offsets_grad_x105(plain):
    """deform_col2im whose offsets' gradient is 1.05 times the right one:
    a fault in the DCN backward, which DeformConv2dFunction's backward
    takes on the card through ops/dcn.py's deform_col2im (K5)."""
    def faulty(*args):
        dx, doffsets, dmask = plain(*args)
        return dx, doffsets * 1.05, dmask
    return faulty


def seed_offsets_off_the_grid(module, seed):
    """Every DCN offset conv under ``module`` with a zero kernel and a
    bias from ``seed`` that puts each tap's samples at a constant offset
    of 0.05-0.25 px either way, and mask logits in [-0.25, 0.25]. The
    offsets are then exact and the same on every device, away from the
    integer grid, where bilinear sampling has kinks: its gradient of the
    offsets jumps there, so a rounding difference that moves a sample
    across a grid line changes that sample's gradient by the whole jump
    (``kink_crossings``). The biases stay small because a step's update
    of them is ~1e-5: next to a bias of 1 or more (a float32 ulp of
    1.2e-7 to 2.4e-7) the update itself would round by a few percent.
    The kernel still receives its gradient and trains."""
    from paa_tpu_torch.modeling.layers import DeformConv

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, DeformConv):
                w, b, n = m.offset.weight, m.offset.bias, m.n_offsets
                w.zero_()
                sign = torch.randint(0, 2, (n,), generator=gen) * 2 - 1
                b[:n].copy_(sign * (torch.rand(n, generator=gen) * 0.2
                                    + 0.05))
                b[n:].copy_(torch.rand(b.numel() - n, generator=gen) * 0.5
                            - 0.25)


def kink_crossings(dev, cfg, batch):
    """With the offset convs of phase 20 (seed 2), how many samples of
    the float32 forward at ``batch`` sit in another bilinear cell on the
    card than on the CPU (their top-left corner rows differ), over every
    DCN layer: each such sample's offsets' gradient differs by a jump,
    not by rounding. The card's forward takes K4, whose corners are the
    plain geometry's bit for bit (tests/test_torch_port_cuda.py::
    test_k4_corners_bit_exact_on_the_grid): its corners are read by
    running ``_geometry`` on the card on each layer's offsets."""
    from paa_tpu_torch.ops import dcn, deform_sampling
    from paa_tpu_torch.ops.image_norm import device_normalize

    corners = []
    plain, columns = deform_sampling._geometry, dcn.deform_conv2d_columns

    def spy(*args):
        y0p, x0p, cw = plain(*args)
        corners[-1].append((y0p.cpu(), x0p.cpu()))
        return y0p, x0p, cw

    def card_spy(x, offsets, mask, weight, stride, padding, dilation,
                 groups, dg):
        deform_sampling._geometry(offsets, mask, *x.shape[2:],
                                  *weight.shape[2:], stride, padding,
                                  dilation, dg)
        return columns(x, offsets, mask, weight, stride, padding, dilation,
                       groups, dg)

    deform_sampling._geometry = spy
    dcn.deform_conv2d_columns = card_spy
    try:
        for device in (dev, "cpu"):
            corners.append([])
            model = seeded_dcnv2_train(cfg, device)
            x = device_normalize(batch["images"].to(device),
                                 batch["image_sizes"].to(device),
                                 cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
            with torch.inference_mode():
                model.module(x.permute(0, 3, 1, 2).contiguous())
            del model
    finally:
        deform_sampling._geometry = plain
        dcn.deform_conv2d_columns = columns
    moved = sum(int(((yg != yc) | (xg != xc)).sum())
                for (yg, xg), (yc, xc) in zip(*corners))
    total = sum(y.numel() for y, _ in corners[1])
    return {"layers": len(corners[1]), "samples": total,
            "in_another_cell": moved}


# a pinned ReLU decision sits at the kink: its float32 input and the
# float64 record's value both within this share of the largest magnitude
# of that call's record (float32 rounding moves an input by ~1e-6 of it)
PIN_SHARE = 1e-3
# the modules whose forward applies a ReLU: F.relu in the ResNet, the FPN
# and FBNet's blocks, group_norm_relu (K3 on the card) in the head's
# towers and the GN models' norms (its relu=True form)
RELU_CALLERS = ("Stem", "Bottleneck", "FPN", "GroupNorm32", "ConvNormRelu")


@contextlib.contextmanager
def relu_decisions(module, record=None, pin=False):
    """While open, watches every ReLU of ``module``'s forward, in call
    order: torch.nn.functional.relu (the ResNet's and the FPN's) and
    ``layers.group_norm_relu`` (GroupNorm+ReLU, K3 on the card, whose
    input to the ReLU is that of F.group_norm; its relu=False form has
    no decision and passes through). It
    yields a dict of what it saw: ``calls``, and without ``record`` the
    ReLU ``inputs`` of the calls (float32 copies on the CPU). With
    ``record`` (the ``inputs`` of a float64 step) it lists under
    ``flips``, per call, the elements whose ReLU decision (input > 0)
    is not the record's: the module and which of its ReLUs, how many,
    the first one's input and record value, and the largest share of
    the record's largest magnitude that such an input or record value
    reaches. With ``pin`` these elements take the record's decision
    (their input where the record's is positive, else 0, and the
    gradient to match), so that the step follows float64's branch of
    each ReLU; every other element is the call's own output."""
    from paa_tpu_torch.modeling import layers

    relu, gn_relu = F.relu, layers.group_norm_relu
    where = {"name": "", "n": 0}
    seen = {"calls": 0, "inputs": [], "flips": []}

    def entered(name):
        def hook(mod, args):
            where.update(name=name, n=0)
        return hook

    def decide(out, on, pre):
        """``out``: the call's output; ``on``: its ReLU decisions;
        ``pre()``: its ReLU input."""
        k = seen["calls"]
        seen["calls"] += 1
        where["n"] += 1
        if record is None:
            seen["inputs"].append(pre().detach().float().cpu())
            return out
        ref = record[k].to(out.device)
        ref_on = ref > 0
        moved = ref_on != on
        n = int(moved.sum())
        if not n:
            return out
        x = pre()
        xd = x.detach()
        at = tuple(moved.nonzero()[0].tolist())
        far = torch.maximum(xd[moved].abs().float(), ref[moved].abs())
        seen["flips"].append({
            "relu": f"{where['name']}#{where['n']}", "elements": n,
            "x": float(xd[at]), "float64": float(ref[at]),
            "share": float(far.max() / ref.abs().max())})
        if not pin:
            return out
        return torch.where(moved, torch.where(ref_on, x, torch.zeros_like(x)),
                           out)

    def watched(x, inplace=False):  # the model's ReLUs are not in place
        on = x > 0
        return decide(relu(x), on, lambda: x)

    def watched_gn(x, weight, bias, groups, eps, relu=True):
        y = gn_relu(x, weight, bias, groups, eps, relu)
        if not relu:  # GroupNorm alone: no decision
            return y
        return decide(y, y > 0, lambda: F.group_norm(
            x, groups, weight.to(x.dtype), bias.to(x.dtype), eps))

    hooks = [m.register_forward_pre_hook(entered(name))
             for name, m in module.named_modules()
             if type(m).__name__ in RELU_CALLERS]
    F.relu, layers.group_norm_relu = watched, watched_gn
    try:
        yield seen
    finally:
        F.relu, layers.group_norm_relu = relu, gn_relu
        for h in hooks:
            h.remove()


def dcnv2_steps_vs_float64(dev, cfg, seed, planted=False):
    """The float32 train steps (TF32 off) of the full-width X-152 dcnv2
    model of ``build_off_the_grid`` on the card and on the CPU against
    the same step on the CPU in float64 (``in_float64``), at 2 x 256 x
    320 from batch ``seed``: the float64 step records its ReLU inputs
    (``relu_decisions``). Each float32 step runs twice: as it is, and
    with the ReLU decisions that float32 rounding took on the other side
    of the kink pinned to float64's. Checked: the positive mask and
    num_pos equal in every step, the card's losses within 1e-4 relative
    of the CPU's, and every pinned element at the kink (PIN_SHARE).
    With ``planted``, a pinned card step with the fault of
    ``_offsets_grad_x105`` too. Returns the readings: each pair's worst
    update errors (``update_errors``) and the pinned elements."""
    from paa_tpu_torch.ops import dcn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = train_batch(seed, 2, (256, 320), (256.0, 300.0))
    model = in_float64(build_off_the_grid(cfg, "cpu"))
    with relu_decisions(model.module) as ref:
        _, pos64, before, p64 = train_once(model, batch)
    del model
    record, steps, flips = ref["inputs"], {}, {}
    runs = [(f"{side}{'_pinned' if pin else ''}", device, pin)
            for pin in (False, True) for side, device in (("card", dev),
                                                          ("cpu", "cpu"))]
    if planted:
        runs.append(("card_pinned_planted", dev, True))
    for what, device, pin in runs:
        model = build_off_the_grid(cfg, device)
        plain = dcn.deform_col2im
        if what.endswith("planted"):
            dcn.deform_col2im = _offsets_grad_x105(plain)
        try:
            with relu_decisions(model.module, record, pin) as seen:
                steps[what] = train_once(model, batch)
        finally:
            dcn.deform_col2im = plain
        del model
        m, pos = steps[what][:2]
        check(seen["calls"] == ref["calls"]
              and m["num_pos"] > 0 and torch.equal(pos, pos64),
              f"dcnv2_steps {seed} {what}: {seen['calls']} ReLU calls of "
              f"{ref['calls']}, or the positive mask differs")
        if pin:
            flips[what] = seen["flips"]
            check(all(f["share"] <= PIN_SHARE for f in seen["flips"]),
                  f"dcnv2_steps {seed} {what}: pinned away from the kink "
                  f"{seen['flips']}")
    for pin in ("", "_pinned"):
        m_gpu, m_cpu = steps[f"card{pin}"][0], steps[f"cpu{pin}"][0]
        loss_err = {k: abs(m_gpu[k] - v) / max(abs(v), 1e-12)
                    for k, v in m_cpu.items()}
        check(max(loss_err.values()) <= 1e-4,
              f"dcnv2_steps {seed}{pin}: losses {loss_err}")
    pairs = {"card_vs_cpu": ("card", "cpu")}
    for side in steps:
        pairs[f"{side}_vs_float64"] = (side, None)
    pairs["card_pinned_vs_cpu_pinned"] = ("card_pinned", "cpu_pinned")
    if planted:
        pairs["card_pinned_planted_vs_cpu_pinned"] = ("card_pinned_planted",
                                                      "cpu_pinned")
    readings = {}
    for pair, (a, b) in pairs.items():
        want = p64 if b is None else steps[b][3]
        norm, share = update_errors(steps[a][3], want, before)
        # how large each worst tensor's update is against the float32
        # resolution of its weights
        ulps = {n: update_ulps(want[n], before[n])
                for n, _ in norm[:2] + share[:2]}
        readings[pair] = {"worst_update_norm_err": norm[:2],
                          "worst_update_share": share[:2],
                          "update_in_ulps_of_largest_weight": ulps}
    return {"batch_seed": seed, "num_pos": steps["card"][0]["num_pos"],
            "readings": readings, "pinned": flips}


def update_ulps(after, before):
    """The largest update (after - before) in float32 ulps of the largest
    weight before it."""
    top = before.abs().max()
    ulp = torch.nextafter(top, torch.tensor(math.inf)) - top
    return float((after - before).abs().max() / ulp)


def within_update_limits(reading):
    return (reading["worst_update_norm_err"][0][1] <= UPDATE_NORM_TOL
            and reading["worst_update_share"][0][1] <= UPDATE_SHARE_TOL)


def phase_dcnv2_train_card_vs_cpu(dev):
    """One float32 train step (TF32 off) of the full-width X-152 dcnv2
    model on the card against the CPU and against a float64 step, at
    2 x 256 x 320 (``dcnv2_steps_vs_float64``, batch 99). Every sample of
    its DCN layers sits off the integer grid at an exact offset
    (``seed_offsets_off_the_grid``), as the CPU tests keep DCN offsets:
    with phase 20's seeded offset convs the card's float32 offset convs
    move some samples into another bilinear cell than the CPU's
    (``kink_crossings``, printed), whose offsets' gradients then differ
    by a jump, not by rounding. The ReLUs have the same kink, which
    offsets cannot avoid: at R-152 depth a float32 step, the card's or
    the CPU's, puts a few ReLU inputs within rounding of 0 on the other
    side of it than float64 does (the backbone's, the FPN's and the
    head towers' GroupNorm+ReLU), and each such element moves the
    weight gradients of its block by a few percent. So the steps are
    held with those decisions pinned to float64's (``relu_decisions``;
    the pinned elements are printed): the pinned card step within phase
    13's update limits (UPDATE_NORM_TOL, UPDATE_SHARE_TOL) of the pinned
    CPU step and of the float64 step, and the pinned CPU step within
    them of the float64 step, as phase 13 holds both sides. The steps
    as they are, unpinned, are printed beside. A pinned card step with
    a fault planted in the DCN backward (the offsets' gradient x1.05)
    must land beyond the limits of the float64 step and of the pinned
    CPU step."""
    cfg = build_cfg("float32", DCNV2_CONFIG)
    crossings = kink_crossings(dev, cfg,
                               train_batch(99, 2, (256, 320), (256.0, 300.0)))
    out = dcnv2_steps_vs_float64(dev, cfg, 99, planted=True)
    readings = out["readings"]
    for pair in ("card_pinned_vs_cpu_pinned", "card_pinned_vs_float64",
                 "cpu_pinned_vs_float64"):
        check(within_update_limits(readings[pair]),
              f"dcnv2_train_card_vs_cpu: {pair} {readings[pair]}")
    for pair in ("card_pinned_planted_vs_float64",
                 "card_pinned_planted_vs_cpu_pinned"):
        check(not within_update_limits(readings[pair]),
              f"dcnv2_train_card_vs_cpu: planted fault within the limits "
              f"({pair}): {readings[pair]}")
    print(json.dumps({"phase": "dcnv2_train_card_vs_cpu", "ok": True,
                      "hw": [256, 320], **out,
                      "seeded_offset_convs_kink_crossings": crossings}))


def dcnv2_step_readings(seeds):
    """``python3 chip_smoke.py --dcnv2-step-readings SEED...``: phase 26's
    steps (``dcnv2_steps_vs_float64`` with the planted fault) at each
    batch seed, one JSON line each, the pairs' readings beside the
    update limits; a failed check is printed and the next seed runs."""
    from paa_tpu_torch.ops import _build

    _build.build_all()
    dev = torch.device("cuda", 0)
    cfg = build_cfg("float32", DCNV2_CONFIG)
    print(card())
    for seed in seeds:
        try:
            out = dcnv2_steps_vs_float64(dev, cfg, seed, planted=True)
            out["within_limits"] = {pair: within_update_limits(r) for pair, r
                                    in out["readings"].items()}
        except RuntimeError as e:
            out = {"batch_seed": seed, "failed": str(e)}
        print(json.dumps({"phase": "dcnv2_step_readings", **out,
                          "limits": [UPDATE_NORM_TOL, UPDATE_SHARE_TOL]}),
              flush=True)
    return 0


def phase_dcnv2_x152_tta(dev):
    """Multi-scale testing of the X-152 dcnv2 config: ``phase_tta`` with
    the config's own list (the identity, its flip and 12 scales up to
    1800 with MAX_SIZE 3000, each flipped: 26 augmentations; soft-vote
    at VOTE_TH 0.66), the weights and cls bias of phase 20."""
    cfg = build_cfg("bfloat16", DCNV2_CONFIG, [
        "TEST.BBOX_AUG.ENABLED", True, "TEST.IMS_PER_BATCH", TTA_IMAGES])
    phase_tta("dcnv2_x152_tta", cfg, seeded_dcnv2("bfloat16", dev), 26)


# ATSS's TTA: three scales of the X-152 config's list (its smallest, its
# largest, one between) with their scale ranges, each flipped, and the
# identity and its flip: 8 augmentations
ATSS_TTA = ["TEST.BBOX_AUG.ENABLED", True, "TEST.IMS_PER_BATCH", TTA_IMAGES,
            "TEST.BBOX_AUG.H_FLIP", True,
            "TEST.BBOX_AUG.SCALES", (400, 1000, 1800),
            "TEST.BBOX_AUG.SCALE_RANGES", ((96, 10000), (0, 10000),
                                           (0, 96)),
            "TEST.BBOX_AUG.MAX_SIZE", 3000,
            "TEST.BBOX_AUG.SCALE_H_FLIP", True, "TEST.BBOX_AUG.VOTE", True,
            "TEST.BBOX_AUG.MERGE_TYPE", "soft-vote"]


def phase_atss_tta(dev):
    """``phase_tta`` of atss_R_50_FPN_1x at ATSS_TTA's 8 augmentations,
    serving's seeded weights and cls bias."""
    path = DENSE_CONFIGS["atss"]
    phase_tta("atss_tta", build_cfg("bfloat16", path, ATSS_TTA),
              seeded_model("bfloat16", dev, path), 8)


def phase_tta(what, cfg, model, n_augs):
    """Multi-scale testing: ``inference`` with TEST.BBOX_AUG.ENABLED over
    TTA_IMAGES PPM images of 480 x 640 in one batch, full width,
    bfloat16, ``cfg``'s ``n_augs`` augmentations; the launch counts set
    to 0 just before and read just after: K1 once and K3
    ``gn_per_forward`` times per augmentation and batch. A detection for
    every image and the 12 metrics written."""
    import logging

    from paa_tpu_torch.data.coco import COCODataset
    from paa_tpu_torch.data.synth import synth_coco
    from paa_tpu_torch.engine import bbox_aug
    from paa_tpu_torch.engine.inference import inference

    tmp = tempfile.mkdtemp(prefix="paa_tta_")
    ann_file, img_dir = synth_coco(os.path.join(tmp, "coco"), TTA_IMAGES,
                                   seed=13, sizes=((640, 480),))
    dataset = COCODataset(ann_file, img_dir,
                          remove_images_without_annotations=False)
    augs = bbox_aug.build_aug_list(cfg)
    check(len(augs) == n_augs, f"{what}: {len(augs)} augmentations")
    shapes, plain = [], bbox_aug.aug_batch

    def recorded(*args):
        images, sizes = plain(*args)
        shapes.append(images.shape[1:3])
        return images, sizes

    bbox_aug.aug_batch = recorded
    out_dir = os.path.join(tmp, "inference")
    try:
        zero_launch_counts()
        results = inference(cfg, model, dataset, output_folder=out_dir,
                            logger=logging.getLogger("chip_smoke.tta"))
    finally:
        bbox_aug.aug_batch = plain
    launches = launch_counts()
    runs = len(shapes)
    check(runs == len(augs), f"{what}: {runs} model runs")
    expected = {"nms_batched": runs, "nms_global": 0,
                "group_norm_relu": gn_per_forward(model) * runs,
                "deform_im2col": dcn_per_forward(model) * runs,
                "deform_col2im": 0}
    check(launches == expected,
          f"{what}: launches {launches}, expected {expected}")
    check(sorted(results) == sorted(METRICS) and all(
        math.isfinite(v) and -1.0 <= v <= 1.0 for v in results.values()),
        f"{what}: results {results}")
    with open(os.path.join(out_dir, "coco_results.json")) as f:
        check(json.load(f) == results, f"{what}: coco_results.json")
    dets = read_bbox_json(out_dir)
    per_image = {}
    for d in dets:
        per_image[d["image_id"]] = per_image.get(d["image_id"], 0) + 1
    check(sorted(per_image) == sorted(r.id for r in dataset.records),
          f"{what}: detections per image {per_image}")
    check(all(all(map(math.isfinite, d["bbox"])) and 0 < d["score"] <= 1
              for d in dets), f"{what}: malformed detection")
    print(json.dumps({"phase": what, "ok": True,
                      "images": TTA_IMAGES, "image_hw": [480, 640],
                      "augmentations": len(augs),
                      "batches": runs // len(augs), "launches": launches,
                      "detections": len(dets)}))
    print(json.dumps({"ap_table": f"random weights, {len(augs)} "
                      "augmentations, a synthetic dataset: not an accuracy",
                      **results}))
    del model
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)


def phase_tta_card_vs_cpu(dev):
    """``eval_card_vs_cpu`` on the TTA eval path of full-width PAA-R50
    (phase 5's weights) at a reduced list: the identity at 256 (at most
    400) and its flip, scales 192 and 320 with scale ranges, each
    flipped; soft-vote, two images per batch. On the card K1 once and
    K3 40 times per augmentation and batch."""
    cfg = build_cfg("float32", PAA_CONFIG, [
        "INPUT.MIN_SIZE_TEST", 256, "INPUT.MAX_SIZE_TEST", 400,
        "TEST.IMS_PER_BATCH", 2, "TEST.BBOX_AUG.ENABLED", True,
        "TEST.BBOX_AUG.H_FLIP", True, "TEST.BBOX_AUG.SCALES", (192, 320),
        "TEST.BBOX_AUG.SCALE_RANGES", ((0, 192), (32, 10000)),
        "TEST.BBOX_AUG.SCALE_H_FLIP", True, "TEST.BBOX_AUG.VOTE", True,
        "TEST.BBOX_AUG.MERGE_TYPE", "soft-vote"])
    out, launches = eval_card_vs_cpu(dev, cfg, 14, "tta_card_vs_cpu")
    runs = 6 * 2  # augmentations x batches
    check(launches == {"nms_batched": runs, "nms_global": 0,
                       "group_norm_relu": 40 * runs, "deform_im2col": 0,
                       "deform_col2im": 0},
          f"tta_card_vs_cpu: launches {launches}")
    print(json.dumps({"phase": "tta_card_vs_cpu", "ok": True,
                      "augmentations": 6, "launches": launches, **out}))


SYNTH_CATALOG = os.path.join(ROOT, "paa_tpu_torch", "tools",
                             "synth_catalog.py")
SYNTH_32 = ("synth_coco_32",)


def synth_opts(out_dir, dtype="bfloat16"):
    """The CLIs' overrides for the synthetic COCO of 32 PPM images
    (tools/synth_catalog.py, written under $PAA_TPU_TORCH_SYNTH_DIR)."""
    return [str(v) for v in (
        "TPU.COMPUTE_DTYPE", dtype, "PATHS_CATALOG", SYNTH_CATALOG,
        "DATASETS.TRAIN", SYNTH_32, "DATASETS.TEST", SYNTH_32,
        "OUTPUT_DIR", out_dir)]


def read_results(out_dir, dataset):
    with open(os.path.join(out_dir, "inference", dataset,
                           "coco_results.json")) as f:
        return json.load(f)


def phase_ap_gate(dev):
    """The AP-gate runbook (paa_tpu_torch/tools/reproduce_ap.py) on the
    card from a seeded reference-format checkpoint of full-width
    PAA-R50: {"model": state_dict} with paa_core's key names
    (tests/reference_layout.py), the cls_logits bias in [-3.5, -2.5] so
    that an untrained net yields candidates. ``load_model`` must write
    every port tensor and skip nothing, and the tensors on the card
    must equal the file's after the documented transforms (a (1,) Scale
    becomes a scalar). Then ``main`` over synth_coco_32 (800 x 1333,
    B=8, bf16): a first pass with a tolerance that admits any AP (the
    launch counts set to 0 just before and read just after: K1 once and
    K3 40 times per batch), a second pass against its five best
    detections per image as ground truth, the gate at that AP +/- 0.003
    (exit 0), at that AP + 0.1 (exit 1), and with the weights missing
    (exit 2)."""
    import logging

    from paa_tpu_torch.data.coco import COCODataset
    from paa_tpu_torch.data.loader import make_data_loader
    from paa_tpu_torch.data.synth import synth_coco
    from paa_tpu_torch.tools import reproduce_ap
    from paa_tpu_torch.utils.torch_import import torch_name_to_port_keys

    rl = shared("reference_layout")
    tmp = tempfile.mkdtemp(prefix="paa_gate_")
    os.environ["PAA_TPU_TORCH_SYNTH_DIR"] = os.path.join(tmp, "synth")
    out_dir = os.path.join(tmp, "out")
    cfg = build_cfg("bfloat16", PAA_CONFIG, ["OUTPUT_DIR", out_dir])
    state = rl.seeded_state_dict(rl.layout(cfg), seed=21,
                                 cls_bias=(-3.5, -2.5))
    weights = os.path.join(tmp, "PAA_R_50_FPN_1x.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}},
               weights)
    logger = logging.getLogger("chip_smoke.ap_gate")
    model, skipped, unwritten = reproduce_ap.load_model(cfg, weights, logger,
                                                        dev)
    check(skipped == [] and unwritten == [],
          f"ap_gate: skipped {skipped[:5]}, unwritten {unwritten[:5]}")
    on_card = model.module.state_dict()
    for key, value in state.items():
        port_key, kind = next((k, t) for k, t in torch_name_to_port_keys(key)
                              if k in on_card)
        want = torch.from_numpy(value)
        if kind == "scalar":
            want = want.reshape(())
        got = on_card[port_key]
        check(got.device.type == dev.type and torch.equal(got.cpu(), want),
              f"ap_gate: {port_key} differs from the file's {key}")
    del model, on_card

    def gate(*argv):
        return reproduce_ap.main(["--config-file", PAA_CONFIG, *argv,
                                  "--device", str(dev), "--output-dir",
                                  out_dir, *synth_opts(out_dir)])

    zero_launch_counts()
    rc = gate("--weights", weights, "--expected", "0", "--tol", "2")
    launches = launch_counts()
    first = read_results(out_dir, SYNTH_32[0])
    # the catalog's dataset, written by the first pass
    ann_file, img_dir = synth_coco(
        os.path.join(tmp, "synth", SYNTH_32[0]), EVAL_IMAGES)
    batches = sum(1 for _ in make_data_loader(
        cfg, COCODataset(ann_file, img_dir, False), is_train=False))
    expected = {"nms_batched": batches, "nms_global": 0,
                "group_norm_relu": GN_PER_LEVEL * len(TOWER_HW) * batches,
                "deform_im2col": 0, "deform_col2im": 0}
    check(rc == 0 and launches == expected,
          f"ap_gate: first pass rc {rc}, launches {launches}, expected "
          f"{expected}")
    ann = os.path.join(tmp, "top5.json")
    n_gt = top_detections_gt(
        ann_file, os.path.join(out_dir, "inference", SYNTH_32[0],
                               "bbox.json"), ann)
    custom = ("--ann-file", ann, "--img-dir", img_dir)
    rc_second = gate("--weights", weights, *custom, "--expected", "0",
                     "--tol", "2")
    ap = read_results(out_dir, "custom")["AP"]
    rcs = {"second_pass": rc_second,
           "gate_at_ap": gate("--weights", weights, *custom, "--expected",
                              str(ap)),
           "gate_at_ap_plus_0.1": gate("--weights", weights, *custom,
                                       "--expected", str(ap + 0.1)),
           "weights_missing": gate("--weights",
                                   os.path.join(tmp, "missing.pth"),
                                   *custom)}
    check(rcs == {"second_pass": 0, "gate_at_ap": 0,
                  "gate_at_ap_plus_0.1": 1, "weights_missing": 2}
          and ap > 0.1, f"ap_gate: exit codes {rcs}, AP {ap}")
    print(json.dumps({"phase": "ap_gate", "ok": True,
                      "tensors": len(state), "first_pass_ap": first["AP"],
                      "gt": n_gt, "gate_ap": ap, "exit_codes": rcs,
                      "launches": launches, "batches": batches}))
    shutil.rmtree(tmp, ignore_errors=True)


class Preempted(Exception):
    """Stops a train_net run after its iteration-2 checkpoint, as a
    preempted job stops."""


# what phase 18 trains with train_net: the config, the body of the
# ImageNet pickle that its MODEL.WEIGHT names in the catalog, and the
# seed of that pickle's weights (its blobs' from the next one)
TRAIN_NET_CASES = {
    "train_net_from_pkl": (PAA_CONFIG, "R-50", "R-50.pkl", 31),
    "dcnv2_train_net_from_pkl": (DCNV2_CONFIG, "R-101", "X-101-32x8d.pkl",
                                 41),
}


def phase_train_net_from_pkl(dev, what):
    """python -m paa_tpu_torch.tools.train_net from ImageNet weights, for
    each case of TRAIN_NET_CASES (``what``): a seeded Detectron pickle of
    the body at the real shapes (BatchNorm folded, the 1000-way
    classifier beside; for the X-152 dcnv2 config the X-101-32x8d that
    it starts from) under a temporary ModelCatalog.WEIGHTS_DIR, reached
    through the config's MODEL.WEIGHT (catalog://ImageNetPretrained/
    MSRA/R-50, .../FAIR/20171220/X-101-32x8d). First the import alone on
    the card: every body tensor equals its blob, the running statistics
    stay 0 and 1, only the classifier is skipped. Then ``train_net.main``
    at full width in bf16 on synth_coco_32 (the config's bucket ladder)
    with IMS_PER_BATCH 8, MAX_ITER 4 and CHECKPOINT_PERIOD 2, stopped
    after the iteration-2 checkpoint: finite losses, K3 40 times per
    step (launch counts set to 0 just before and read just after), the
    frozen stem and first stage of the checkpoint equal to the pickle's
    blobs. A second run resumes from ``last_checkpoint`` at iteration 2,
    reaches 4 and evaluates synth_coco_32 to the AP table (K3 40 per
    step and per eval batch, K1 once per eval batch)."""
    import logging
    import pickle

    from paa_tpu_torch.config.paths_catalog import ModelCatalog
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.tools import train_net
    from paa_tpu_torch.utils.torch_import import (
        load_pretrained_into, torch_name_to_port_keys)

    config, blocks, pkl_name, seed = TRAIN_NET_CASES[what]
    rl = shared("reference_layout")
    tmp = tempfile.mkdtemp(prefix="paa_train_net_")
    os.environ["PAA_TPU_TORCH_SYNTH_DIR"] = os.path.join(tmp, "synth")
    weights_dir = os.path.join(tmp, "weights")
    os.makedirs(weights_dir)
    ModelCatalog.WEIGHTS_DIR = weights_dir
    cfg = build_cfg("bfloat16", config)
    r = cfg.MODEL.RESNETS
    body = rl.seeded_state_dict(rl.resnet_keys(
        rl.BLOCKS[blocks], r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS,
        r.WIDTH_PER_GROUP, r.NUM_GROUPS), seed)
    blobs = rl.c2_imagenet_blobs(body, seed=seed + 1)
    pkl = os.path.join(weights_dir, pkl_name)
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    # the blob each body tensor of the port holds after the import (an
    # FPN body's name: the first candidate)
    want = {}
    for key, value in rl.fold_frozen_bn(body).items():
        want[torch_name_to_port_keys(key)[0][0]] = value
    logger = logging.getLogger("chip_smoke.train_net")
    model = build_detection_model(cfg, device=dev)
    skipped, unwritten = load_pretrained_into(cfg, model.module,
                                              cfg.MODEL.WEIGHT, logger)
    on_card = model.module.state_dict()
    stats = {k for k in want if "running" in k}
    check(sorted(skipped) == ["pred_b", "pred_w"]
          and not (set(want) - stats) & set(unwritten),
          f"{what}: skipped {skipped}, unwritten {unwritten[:5]}")
    for key, value in want.items():
        check(torch.equal(on_card[key].cpu(), torch.from_numpy(value)),
              f"{what}: {key} is not its blob")
    k4 = dcn_per_forward(model)
    del model, on_card

    out_dir = os.path.join(tmp, "out")
    head = ["--config-file", config, "--device", str(dev)]
    opts = [*synth_opts(out_dir), "SOLVER.IMS_PER_BATCH", "8",
            "SOLVER.MAX_ITER", "4", "SOLVER.CHECKPOINT_PERIOD", "2"]
    seen, preempt = {}, [True]

    def hook(it, metrics):
        seen[it] = metrics
        if preempt[0] and it == 2:
            raise Preempted

    zero_launch_counts()
    try:
        train_net.main(head + ["--skip-test"] + opts, metric_hook=hook)
        check(False, f"{what}: the first run was not stopped")
    except Preempted:
        pass
    first_launches = launch_counts()
    check(first_launches == {"nms_batched": 0, "nms_global": 0,
                             "group_norm_relu": 3 * 40,
                             "deform_im2col": 6 * k4,
                             "deform_col2im": 3 * k4},
          f"{what}: first run launches {first_launches}")
    check(sorted(seen) == [1, 2] and all(
        math.isfinite(v) for m in seen.values() for v in m.values())
        and all(m["num_pos"] > 0 for m in seen.values()),
        f"{what}: first run metrics {seen}")
    with open(os.path.join(out_dir, "last_checkpoint")) as f:
        check(f.read().strip() == "model_0000002",
              f"{what}: last_checkpoint")
    ckpt = torch.load(os.path.join(out_dir, "model_0000002"),
                      map_location="cpu", weights_only=True)
    frozen = [k for k in want if k.startswith(("backbone.resnet.stem.",
                                               "backbone.resnet.layer1_"))]
    for key in frozen + sorted(stats):
        check(torch.equal(ckpt["model"][key], torch.from_numpy(want[key])),
              f"{what}: {key} moved from its blob")
    first = dict(seen)

    seen.clear()
    preempt[0] = False
    zero_launch_counts()
    rc = train_net.main(head + opts, metric_hook=hook)
    launches = launch_counts()
    results = read_results(out_dir, SYNTH_32[0])
    batches = launches["nms_batched"]
    check(rc == 0 and sorted(seen) == [3, 4] and launches == {
        "nms_batched": batches, "nms_global": 0,
        "group_norm_relu": 40 * (2 + batches),
        "deform_im2col": k4 * (4 + batches), "deform_col2im": 2 * k4}
        and batches > 0,
        f"{what}: second run rc {rc}, iterations {sorted(seen)}, "
        f"launches {launches}")
    ckpt = torch.load(os.path.join(out_dir, "model_final"),
                      map_location="cpu", weights_only=True)
    check(ckpt["extra"] == {"iteration": 4} and ckpt["step"] == 4
          and sorted(results) == sorted(METRICS),
          f"{what}: final {ckpt['extra']}, results {results}")
    print(json.dumps({"phase": what, "ok": True, "blobs": len(blobs),
                      "batch": 8, "losses": {
                          k: [m[k] for _, m in sorted({**first, **seen}
                                                      .items())]
                          for k in seen[3]},
                      "first_run_launches": first_launches,
                      "launches": launches, "eval_batches": batches,
                      "ap_table": results}))
    shutil.rmtree(tmp, ignore_errors=True)


DDP_WORLD, DDP_BATCH, DDP_HW, DDP_SIZE = 2, 8, (256, 320), (256.0, 300.0)


def _ddp_model(dev):
    """Full-width PAA-R50 in float32 from seed 0, cuDNN off (see
    phase_ddp_two_ranks)."""
    from paa_tpu_torch.modeling import build_detection_model

    torch.backends.cudnn.enabled = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return build_detection_model(build_cfg("float32", PAA_CONFIG),
                                 device=dev, seed=0)


def ddp_worker(job_path, out_path):
    """One rank of phase_ddp_two_ranks (``chip_smoke.py --ddp-worker JOB
    OUT``, launched with torchrun's environment): gloo on the one card;
    the first step on its interleaved share of the global batch, then
    the eval of the job's dataset and the SyncBN step."""
    import logging
    import pickle

    import torch.distributed as dist

    from paa_tpu_torch.data.coco import COCODataset
    from paa_tpu_torch.engine.inference import inference
    from paa_tpu_torch.utils import comm

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dev = comm.init_distributed(job["device"], backend="gloo")
    rank, world = comm.get_rank(), comm.get_world_size()
    batch = {k: v[rank::world] for k, v in job["batch"].items()}
    metrics, pos_mask, _, after = train_once(_ddp_model(dev), batch)
    torch.backends.cudnn.enabled = True
    model = seeded_model("bfloat16", dev)
    dataset = COCODataset(job["ann_file"], job["img_dir"], False)
    results = inference(model.cfg, model, dataset,
                        output_folder=job["eval_dir"],
                        logger=logging.getLogger("chip_smoke.ddp"))
    del model
    sync = job["syncbn"]
    rows = slice(rank, None, world)
    s_metrics, _, _, s_after, s_probe, s_stats, s_calls = syncbn_ddp_step(
        dev, {k: v[rows] for k, v in sync["batch"].items()}, sync["pins"],
        rows)
    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "syncbn": {"metrics": s_metrics, "probe": s_probe,
                      "stats": s_stats, "relu_calls": s_calls,
                      "params": s_after if rank == 0 else None},
           "device": str(dev), "metrics": metrics,
           "pos_mask": pos_mask.numpy(), "results": results,
           "digests": {n: [float(p.double().sum()),
                           float(p.double().abs().sum())]
                       for n, p in after.items()}}
    if rank == 0:
        out["params"] = {n: p.numpy() for n, p in after.items()}
    with open(f"{out_path}.{rank}", "wb") as f:
        pickle.dump(out, f)
    comm.synchronize()
    dist.destroy_process_group()
    return 0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ddp_workers(job_path, out_path, deadline_s=600):
    """Two ranks of ddp_worker on the one card, as torchrun would start
    them (LOCAL_RANK 0 for both: one card); raises if one fails or the
    deadline passes, and kills what still runs."""
    port = _free_port()
    procs = []
    for rank in range(DDP_WORLD):
        env = {**os.environ, "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "WORLD_SIZE": str(DDP_WORLD),
               "RANK": str(rank), "LOCAL_RANK": "0"}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ddp-worker",
             job_path, out_path], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.time() + deadline_s
    failure = None
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                failure = "a rank exited non-zero"
                break
            if time.time() > deadline:
                failure = "the ranks timed out"
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] or "" for p in procs]
    if failure or any(p.returncode for p in procs):
        raise RuntimeError(f"ddp_two_ranks: {failure}" + "".join(
            f"\n--- rank {i} (rc={p.returncode}) ---\n{log[-3000:]}"
            for i, (p, log) in enumerate(zip(procs, logs))))


def phase_ddp_two_ranks(dev):
    """Data parallelism over torch.distributed: two ranks on the one card
    with the gloo backend over CUDA tensors (NCCL refuses two ranks on
    one device; NCCL across cards waits for a machine with more than
    one), each launched as torchrun launches a rank.

    Training: full-width PAA-R50 in float32 (TF32 off) from seed 0, a
    global batch of 8 at 256 x 320 (3-12 GTs per image), 4 images per
    rank (interleaved, as the loader shares a global batch). One DDP
    step against the one-process step on the same 8 images: losses
    within 1e-4 relative, num_pos and the positive mask equal, every
    parameter's update within the f32 train-step limits of phase 13
    (UPDATE_NORM_TOL, UPDATE_SHARE_TOL), the two ranks' parameters
    equal. cuDNN is off in this comparison on both sides: cuDNN picks
    its algorithms by the batch's shape, so a 4-image forward rounds
    otherwise than an 8-image one, and the GMM's two-candidate
    foreground ties flip on one-ulp changes of the candidate losses
    (ROADMAP.md section 3); PyTorch's own convolutions compute each
    image alike at any batch size.

    Eval: synth_coco_32 (800 x 1333, B=8, bf16, the serving cell's
    seeded weights) through ``inference`` on both ranks (round-robin
    batches, predictions gathered, the main rank evaluates) against one
    process, with the ground truth the one process's five best
    detections per image: detections matched as in phase 6, the 12
    metrics within 1e-6.

    SyncBN (MODEL.USE_SYNCBN, after the eval): the same float32 PAA-R50
    with a SyncBatchNorm in each of the body's 53 norms, one step on a
    global batch of SYNCBN_DDP_BATCH (16) at 256 x 320 in one process
    against two ranks of 8 (``syncbn_ddp_step``; their batch statistics
    all-reduced, the gradient through the sums), every rank's ReLUs
    taking the one process's decisions on its rows (``pinned_relus``):
    the probe SyncBatchNorm's normalized output
    and every running statistic within SYNCBN_TOL of the one process's
    (of each tensor's largest magnitude), the two ranks' statistics
    equal (DDP's broadcast_buffers copies equal values), losses within
    1e-4 relative, the update within phase 13's limits."""
    import logging
    import pickle

    from paa_tpu_torch.data.coco import COCODataset
    from paa_tpu_torch.data.synth import synth_coco
    from paa_tpu_torch.engine.inference import inference

    tmp = tempfile.mkdtemp(prefix="paa_ddp_")
    batch = {k: v.numpy() for k, v in train_batch(
        77, DDP_BATCH, DDP_HW, DDP_SIZE, max_gt=20).items()}
    one_metrics, one_mask, before, one_after = train_once(
        _ddp_model(dev), {k: torch.from_numpy(v) for k, v in batch.items()})
    torch.backends.cudnn.enabled = True

    logger = logging.getLogger("chip_smoke.ddp")
    first_dir = os.path.join(tmp, "first")
    ann_file, img_dir = synth_coco(os.path.join(tmp, "coco"), EVAL_IMAGES,
                                   seed=41)
    model = seeded_model("bfloat16", dev)
    inference(model.cfg, model, COCODataset(ann_file, img_dir, False),
              output_folder=first_dir, logger=logger)
    ann = os.path.join(tmp, "top5.json")
    top_detections_gt(ann_file, os.path.join(first_dir, "bbox.json"), ann)
    top5 = COCODataset(ann, img_dir, False)
    one_dir = os.path.join(tmp, "one")
    one_results = inference(model.cfg, model, top5, output_folder=one_dir,
                            logger=logger)
    del model
    torch.cuda.empty_cache()
    # SyncBN: one process's step on the global batch, its ReLU decisions
    # recorded for the ranks
    sync_batch = {k: torch.from_numpy(v.numpy()) for k, v in train_batch(
        78, SYNCBN_DDP_BATCH, DDP_HW, DDP_SIZE, max_gt=20).items()}
    pins = []
    (s_metrics, _, s_before, s_after, s_probe, s_stats,
     s_calls) = syncbn_ddp_step(dev, sync_batch, pins, None)
    torch.cuda.empty_cache()

    job = {"device": str(dev), "batch": batch, "ann_file": ann,
           "img_dir": img_dir,
           "eval_dir": os.path.join(tmp, "two"),
           "syncbn": {"batch": sync_batch, "pins": pins}}
    job_path, out_path = os.path.join(tmp, "job.pkl"), os.path.join(
        tmp, "out.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    run_ddp_workers(job_path, out_path)
    ranks = []
    for rank in range(DDP_WORLD):
        with open(f"{out_path}.{rank}", "rb") as f:
            ranks.append(pickle.load(f))
    for rank, out in enumerate(ranks):
        check((out["rank"], out["world"], out["backend"], out["device"])
              == (rank, DDP_WORLD, "gloo", str(dev)),
              f"ddp_two_ranks: rank {rank} {out['backend']} {out['device']}")
    mask = torch.zeros_like(one_mask)
    for rank, out in enumerate(ranks):
        mask[rank::DDP_WORLD] = torch.from_numpy(out["pos_mask"])
    check(torch.equal(mask, one_mask) and all(
        out["metrics"]["num_pos"] == one_metrics["num_pos"] > 0
        for out in ranks),
        f"ddp_two_ranks: positive masks differ "
        f"({int((mask != one_mask).sum())} anchors)")
    loss_err = {k: max(abs(out["metrics"][k] - v) / max(abs(v), 1e-12)
                       for out in ranks) for k, v in one_metrics.items()}
    check(max(loss_err.values()) <= 1e-4, f"ddp_two_ranks: {loss_err}")
    check(all(out["digests"] == ranks[0]["digests"] for out in ranks),
          "ddp_two_ranks: the ranks' parameters differ")
    two_after = {n: torch.from_numpy(v)
                 for n, v in ranks[0]["params"].items()}
    worst_norm, worst_share = update_errors(two_after, one_after, before)
    check(worst_norm[0][1] <= UPDATE_NORM_TOL
          and worst_share[0][1] <= UPDATE_SHARE_TOL,
          f"ddp_two_ranks: updates {worst_norm} {worst_share}")

    with open(os.path.join(job["eval_dir"], "bbox.json")) as f:
        two_dets = json.load(f)
    ids = [r.id for r in top5.records]
    matched = match_detections(
        _detections_by_image(two_dets, ids),
        _detections_by_image(read_bbox_json(one_dir), ids), "ddp_two_ranks")
    two_results = ranks[0]["results"]
    ap_err = {k: abs(two_results[k] - v) for k, v in one_results.items()}
    check(ranks[1]["results"] == {} and sorted(ap_err) == sorted(METRICS)
          and max(ap_err.values()) <= 1e-6 and one_results["AP"] > 0.1,
          f"ddp_two_ranks: AP {two_results} vs {one_results}")

    # SyncBN: each rank's normalized activations are its rows of one
    # process's, the running statistics and the update one process's
    def share(got, want):
        return float((got - want).abs().max() / want.abs().max())

    probe_err = max(share(out["syncbn"]["probe"],
                          s_probe[rank::DDP_WORLD])
                    for rank, out in enumerate(ranks))
    stats_err = max(share(out["syncbn"]["stats"][k], v)
                    for out in ranks for k, v in s_stats.items())
    s_loss_err = {k: max(abs(out["syncbn"]["metrics"][k] - v)
                         / max(abs(v), 1e-12) for out in ranks)
                  for k, v in s_metrics.items() if k != "num_pos"}
    s_norm, s_share = update_errors(ranks[0]["syncbn"]["params"], s_after,
                                    s_before)
    # the body's 49 ReLUs, P7's, the towers' 8 GroupNorm+ReLU x 5 levels
    check(all(out["syncbn"]["relu_calls"] == s_calls == 90 for out in ranks)
          and probe_err <= SYNCBN_TOL and stats_err <= SYNCBN_TOL
          and all(torch.equal(ranks[1]["syncbn"]["stats"][k], v)
                  for k, v in ranks[0]["syncbn"]["stats"].items())
          and max(s_loss_err.values()) <= 1e-4
          and s_norm[0][1] <= UPDATE_NORM_TOL
          and s_share[0][1] <= UPDATE_SHARE_TOL,
          f"ddp_two_ranks syncbn: probe {probe_err}, statistics "
          f"{stats_err}, losses {s_loss_err}, updates {s_norm} {s_share}")
    print(json.dumps({
        "phase": "ddp_two_ranks", "ok": True, "backend": "gloo",
        "why_not_nccl": "NCCL refuses two ranks on one device; NCCL "
                        "across cards is not verified (one card)",
        "world": DDP_WORLD, "global_batch": DDP_BATCH, "hw": DDP_HW,
        "dtype": "float32", "cudnn": False,
        "num_pos": one_metrics["num_pos"], "loss_rel_err": loss_err,
        "worst_update_norm_err": worst_norm,
        "worst_update_share": worst_share, "ap_one": one_results,
        "ap_abs_err": ap_err, **matched,
        "syncbn": {"global_batch": SYNCBN_DDP_BATCH,
                   "per_rank": SYNCBN_DDP_BATCH // DDP_WORLD,
                   "probe": SYNCBN_PROBE, "probe_rel_err": probe_err,
                   "running_stats_rel_err": stats_err,
                   "tolerance": SYNCBN_TOL, "loss_rel_err": s_loss_err,
                   "worst_update_norm_err": s_norm,
                   "worst_update_share": s_share,
                   "relu_decisions_pinned": s_calls}}))
    shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def recording_k1_inputs():
    """Records the inputs of every K1 launch made while it is open (the
    launcher behind ``nms_batched``, wrapped): the list it yields fills
    with each launch's positional arguments as the path runs."""
    from paa_tpu_torch.ops import nms

    seen, launch = [], nms._nms_batched_cuda

    def recorded(*args, **kwargs):
        seen.append(args)
        return launch(*args, **kwargs)

    nms._nms_batched_cuda = recorded
    try:
        yield seen
    finally:
        nms._nms_batched_cuda = launch


def k1_at_path_inputs(args, what):
    """K1 against its plain version on the inputs a path's request gave it
    (``recording_k1_inputs``): keep_idx, keep_scores and keep_valid
    bit-equal. Returns the input's (rows, candidates, max_out)."""
    from paa_tpu_torch.ops import nms

    same_keeps(nms.nms_batched(*args), nms.nms_batched_plain(*args),
               f"nms_batched on the {what} candidates")
    return (*args[1].shape, args[5])


def phase_dense(dev, head, path=None, train_reference=True):
    """The serving, training and card-vs-CPU phases of PAA-R50, on the
    config of DENSE_CONFIGS[``head``] (or ``path``) at full width:

    - three 8 x 800 x 1344 bf16 requests (``phase_main_path``: K1 once
      and K3 40 times per request, none for RetinaNet), K1 held
      bit-equal to its plain version on the first request's own inputs;
    - the f32 model on the card against the CPU at 2 x 256 x 320
      (``phase_reference``);
    - TRAIN_STEPS bf16 steps of do_train at the config's IMS_PER_BATCH
      (16; 8 for RetinaNet) with K3 40 times per step for ATSS and FCOS
      (``phase_train_main_path``);
    - with ``train_reference``, one f32 train step on the card against
      the CPU and float64 (``phase_train_reference``), with FCOS's
      centerness targets x1.05 planted in a third step, which must land
      beyond the limits.

    RetinaNet's training steps take FrozenBN statistics calibrated on
    its seeded body (``calibrated_frozen_bn``): its towers have no norm.
    Its one-step comparison keeps the seeded statistics, as every head's:
    the calibrated ones centre the body's ReLU inputs at 0, where
    float32 and float64 decide apart, so that the CPU's own f32 step
    misses float64 by 2.1e-2 of a tensor's update norm with them and
    2.8e-3 without."""
    path = path or DENSE_CONFIGS[head]
    frozen_bn = calibrated_frozen_bn(path) if head == "retinanet" else None
    with recording_k1_inputs() as k1_inputs:
        phase_main_path(dev, path, f"{head}_main_path")
    k1_at_path_inputs(k1_inputs[0], head)
    del k1_inputs
    torch.cuda.empty_cache()
    phase_reference(dev, path, f"{head}_card_vs_cpu")
    phase_train_main_path(dev, path, f"{head}_train_main_path", frozen_bn)
    torch.cuda.empty_cache()
    if train_reference:
        phase_train_reference(dev, path, f"{head}_train_card_vs_cpu",
                              _fcos_centerness_fault if head == "fcos"
                              else None)


def phase_dense_test_net(dev, head="fcos"):
    """``python -m paa_tpu_torch.tools.test_net`` (its ``main``, in this
    process) on the config of DENSE_CONFIGS[``head``] over synth_coco_32
    at full width in bf16 from the seeded weights (a dry run; the class
    threshold at 0.005, below the focal prior 0.01 of the untrained
    head, so that every image has detections): exit 0, the 12 metrics,
    K1 once and K3 40 times per eval batch (launch counts set to 0 just
    before and read just after)."""
    from paa_tpu_torch.modeling.detector import DENSE_HEADS
    from paa_tpu_torch.tools import test_net

    tmp = tempfile.mkdtemp(prefix="paa_test_net_")
    os.environ["PAA_TPU_TORCH_SYNTH_DIR"] = os.path.join(tmp, "synth")
    out_dir = os.path.join(tmp, "out")
    node = DENSE_HEADS[head][0]
    zero_launch_counts()
    rc = test_net.main(["--config-file", DENSE_CONFIGS[head],
                        *synth_opts(out_dir),
                        f"MODEL.{node}.INFERENCE_TH", "0.005"])
    launches = launch_counts()
    check(rc == 0, f"{head}_test_net: exit {rc}")
    batches = launches["nms_batched"]
    gn = 0 if head == "retinanet" else GN_PER_LEVEL * len(TOWER_HW)
    check(batches >= 4 and launches == {
        "nms_batched": batches, "nms_global": 0,
        "group_norm_relu": gn * batches, "deform_im2col": 0,
        "deform_col2im": 0},
        f"{head}_test_net: launches {launches}")
    results = read_results(out_dir, SYNTH_32[0])
    check(sorted(results) == sorted(METRICS) and all(
        math.isfinite(v) and -1.0 <= v <= 1.0 for v in results.values()),
        f"{head}_test_net: results {results}")
    dets = read_bbox_json(os.path.join(out_dir, "inference", SYNTH_32[0]))
    check(len({d["image_id"] for d in dets}) == 32,
          f"{head}_test_net: images with detections")
    print(json.dumps({"phase": f"{head}_test_net", "ok": True,
                      "images": 32, "launches": launches,
                      "detections": len(dets)}))
    print(json.dumps({"ap_table": "random weights, a synthetic dataset: "
                      "not an accuracy", **results}))
    shutil.rmtree(tmp, ignore_errors=True)


# ---- two-stage training and Mask R-CNN -------------------------------------

TWO_STAGE_CONFIGS = {"faster_rcnn": FRCNN_CONFIG, "mask_rcnn": MRCNN_CONFIG}
# the sampled anchors and rois a two-stage train step reports beside its
# losses (``make_bucket_train_step(..., return_aux=True)``)
TWO_STAGE_AUX = ("rpn_pos", "rpn_neg", "rois", "roi_labels", "roi_valid",
                 "roi_gt_idx", "mask_targets")
# the rois per image of the two-stage f32 steps compared with the CPU and
# float64 (the config's 512 cut to 128: the CPU's float64 mask head over
# 1,024 rois takes minutes)
REFERENCE_ROIS = 128
# the f32 step's sampled rois (proposals, floats) against the CPU's, in
# px, and the share of its 28 x 28 mask targets (crops thresholded at 0.5)
# that a roi that far off may flip
ROI_PX_TOL, MASK_TARGET_SHARE_TOL = 1e-2, 1e-3
# a mask probability of a card detection and of the CPU's at the same box
# (within 0.01 px) within this much of each other (float32; the mask head
# pools at the box)
MASK_PROB_TOL = 1e-3


def seeded_mrcnn(dtype, device, path=MRCNN_CONFIG):
    """``seeded_frcnn`` on Mask R-CNN (or the Mask R-CNN of ``path``),
    with the mask logits' biases drawn from seed 2 in [0.5, 1.5], so that
    an untrained mask head's masks cover much of each box (a segm AP away
    from 0 against the octagons of ``top_detections_gt``)."""
    model = seeded_frcnn(dtype, device, path)
    gen = torch.Generator().manual_seed(2)
    bias = model.module.mask_head.mask_fcn_logits.bias
    with torch.no_grad():
        bias.copy_(torch.empty(bias.shape).uniform_(0.5, 1.5, generator=gen))
    return model


def check_masks(dets, size=28):
    """Each request's "masks" (B, 100, ``size``, ``size``) float32 in
    [0, 1]."""
    for det in dets:
        m = det["masks"]
        check(tuple(m.shape) == (BATCH, 100, size, size)
              and m.dtype == torch.float32
              and bool(torch.isfinite(m).all())
              and float(m.min()) >= 0 and float(m.max()) <= 1,
              f"mask_rcnn: masks {tuple(m.shape)} {m.dtype}")
    m = dets[0]["masks"][dets[0]["valid"]]
    return {"masks": list(dets[0]["masks"].shape),
            "mask_pixels_above_half": float((m > 0.5).float().mean())}


def mask_rcnn_card_vs_cpu(dev, build=seeded_mrcnn, what="mask_rcnn"):
    """The f32 Mask R-CNN of ``build`` on the card against the CPU at
    2 x 256 x 320 (``card_vs_cpu``: RPN outputs, detections matched), and
    each card detection's mask against the CPU's at the same box (label
    equal, box within 0.01 px) within MASK_PROB_TOL."""
    card_vs_cpu(dev, build, lambda m, x: m.module.backbone_rpn(x)[1],
                f"{what}_card_vs_cpu")
    images, sizes = request(99, 2, (256, 320), (256.0, 300.0))
    dets = [{k: v.cpu() for k, v in build("float32", d).make_eval_fn()(
        images, sizes).items()} for d in (dev, "cpu")]
    gpu, cpu = dets
    compared, worst = 0, 0.0
    for i in range(gpu["valid"].shape[0]):
        for j in torch.nonzero(gpu["valid"][i]).flatten().tolist():
            same = cpu["valid"][i] & (cpu["labels"][i] == gpu["labels"][i, j])
            d = (cpu["boxes"][i] - gpu["boxes"][i, j]).abs().amax(dim=1)
            d = torch.where(same, d, torch.inf)
            k = int(d.argmin())
            if float(d[k]) <= 0.01:
                compared += 1
                worst = max(worst, float(
                    (gpu["masks"][i, j] - cpu["masks"][i, k]).abs().max()))
    check(compared >= 0.9 * int(gpu["valid"].sum()) and compared > 0
          and worst <= MASK_PROB_TOL,
          f"{what}_card_vs_cpu: {compared} masks compared, worst {worst}")
    print(json.dumps({"phase": f"{what}_masks_card_vs_cpu", "ok": True,
                      "masks_compared": compared,
                      "detections": int(gpu["valid"].sum()),
                      "max_abs_err": worst, "tolerance": MASK_PROB_TOL}))


def phase_mask_rcnn_serving(dev):
    """Phase 34: full-width Mask R-CNN serving (three 8 x 800 x 1344 bf16
    requests: K1 3, K2 3, masks (8, 100, 28, 28) in [0, 1]), K1 against
    its plain version on the first request's RPN rows, and the f32 model
    on the card against the CPU with the masks compared."""
    model = seeded_mrcnn("bfloat16", dev)
    with recording_k1_inputs() as k1_inputs:
        serve(model, "mask_rcnn_main_path", 50,
              {"nms_batched": 3, "nms_global": 3, "group_norm_relu": 0,
               "deform_im2col": 0, "deform_col2im": 0}, 0.05, check_masks)
    k1_at_path_inputs(k1_inputs[0], "mask_rcnn_rpn")
    del model, k1_inputs
    torch.cuda.empty_cache()
    mask_rcnn_card_vs_cpu(dev)


def box_octagon_masks(gt_boxes, gt_labels):
    """(B, G, 112, 112) uint8 box-normalized masks of the octagon in each
    valid GT box (data/synth.py's polygon), rasterized without cv2."""
    from paa_tpu_torch.data.synth import box_octagon
    from paa_tpu_torch.structures.masks import rasterize_instances

    out = []
    for boxes, labels in zip(gt_boxes.numpy(), gt_labels.numpy()):
        n = int((labels > 0).sum())
        polys = [[box_octagon(x1, y1, x2 - x1, y2 - y1)[0]]
                 for x1, y1, x2, y2 in boxes[:n]]
        out.append(rasterize_instances(polys, boxes[:n], len(labels)))
    return torch.from_numpy(np.stack(out))


def two_stage_batch(seed, bsz, hw, size, masks, max_side=512):
    """``train_batch`` with, for Mask R-CNN, each GT's octagon mask."""
    batch = train_batch(seed, bsz, hw, size, max_side=max_side)
    if masks:
        batch["gt_masks"] = box_octagon_masks(batch["gt_boxes"],
                                              batch["gt_labels"])
    return batch


def two_stage_config(kind):
    """The config of a two-stage path: Faster and Mask R-CNN R-50-FPN
    (TWO_STAGE_CONFIGS), Keypoint R-CNN, the C4 models (C4_CONFIGS), the
    GN models (GN_CONFIGS), the RPN-only ones (RPN_CONFIGS) and the FBNet
    ones (FBNET_CONFIGS)."""
    return {**TWO_STAGE_CONFIGS, "keypoint_rcnn": KRCNN_CONFIG,
            **C4_CONFIGS, **GN_CONFIGS, **RPN_CONFIGS,
            **FBNET_CONFIGS}[kind]


def phase_two_stage_train(dev, kind, frozen_bn, k3_per_step=0, hw=HW,
                          size=SIZE, extra=()):
    """Phases 35, 40, 42, 46, 48, 50 and 51: TRAIN_STEPS steps of
    do_train of the full-width bf16 model of ``two_stage_config(kind)``
    at its IMS_PER_BATCH (16; the C4 models' 8) on one repeated batch
    (3-12 GTs in 100 slots; for Mask R-CNN their octagons'
    box-normalized masks, for Keypoint R-CNN persons with 17 keypoints),
    with FrozenBN statistics calibrated on the seeded body
    (``calibrated_frozen_bn``: at the seed's identity statistics the
    random FPN's ~1e3 features put the RPN's deltas and the classifier's
    logits in the hundreds, and both packages' box losses go NaN; a GN
    body normalises and takes none): losses finite, num_pos > 0, the
    last loss below the first, the RPN's NMS once per step (its rows of
    PRE_NMS_TOP_N_TRAIN candidates, POST_NMS_TOP_N_TRAIN picks: K1, or K2
    above K1's capacity as the C4 RPN's 12,000; none for the RPN-only
    model, which trains on the RPN loss alone), K3 ``k3_per_step`` times
    per step (the GN models' forward) and no other NMS (launch counts
    set to 0 just before and read just after); that NMS kernel against
    its plain version on the first step's rows. The batch is B x ``hw``
    (content ``size``; GTs up to 0.7 of its shorter side); ``extra``
    overrides the config. Returns K3's launches by form (``k3_forms``)
    and the NMS kernel's name and input (rows, candidates, max_out),
    both None for the RPN-only model."""
    from paa_tpu_torch.engine import do_train
    from paa_tpu_torch.ops import nms

    what = f"{kind}_train"
    cfg = build_cfg("bfloat16", two_stage_config(kind),
                    ["SOLVER.MAX_ITER", TRAIN_STEPS, *extra])
    model = seeded_train_model(cfg, dev, frozen_bn)
    state = train_state(model)
    if cfg.MODEL.KEYPOINT_ON:
        batch = keypoint_batch(70, cfg.SOLVER.IMS_PER_BATCH, hw, size)
    else:
        batch = two_stage_batch(70, cfg.SOLVER.IMS_PER_BATCH, hw, size,
                                cfg.MODEL.MASK_ON,
                                max_side=min(512, 0.7 * min(size)))
    _, counts = model.anchors_for(hw)
    per_row = min(cfg.MODEL.RPN.PRE_NMS_TOP_N_TRAIN, max(counts))
    kernel = ("nms_global" if per_row > nms.k1_max_candidates(dev)
              else "nms_batched")
    rpn_only = model.head_type == "rpn"
    seen = {}
    with recording_k1_inputs() as k1_inputs, \
            recording_k2_inputs() as k2_inputs, \
            recording_k3_launches() as k3_launches:
        zero_launch_counts()
        do_train(cfg, model, state, [batch] * TRAIN_STEPS,
                 metric_hook=lambda i, m: seen.update({i: m}))
        launches = launch_counts()
    forms = k3_forms(k3_launches)
    expected = {"nms_batched": 0, "nms_global": 0,
                "group_norm_relu": k3_per_step * TRAIN_STEPS,
                "deform_im2col": 0, "deform_col2im": 0}
    if not rpn_only:
        expected[kernel] = TRAIN_STEPS
    check(launches == expected,
          f"{what}: launches {launches}, expected {expected}")
    check(sorted(seen) == list(range(1, TRAIN_STEPS + 1)),
          f"{what}: metrics of steps {sorted(seen)}")
    for i, m in seen.items():
        check(all(math.isfinite(v) for v in m.values()) and m["num_pos"] > 0,
              f"{what}: step {i} {m}")
    check(seen[TRAIN_STEPS]["loss"] < seen[1]["loss"],
          f"{what}: loss {seen[1]['loss']} -> {seen[TRAIN_STEPS]['loss']}")
    args = None if rpn_only else (
        k2_inputs if kernel == "nms_global" else k1_inputs)[0]
    check(args is None or not any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args),
        f"{what}: the NMS saw a tensor under autograd")
    if rpn_only:
        kernel = key = None
    elif kernel == "nms_global":
        key = k2_at_path_inputs(args, f"{kind}_train_rpn")
    else:
        key = k1_at_path_inputs(args, f"{kind}_train_rpn")
    print(json.dumps({
        "phase": what, "ok": True, "batch": cfg.SOLVER.IMS_PER_BATCH,
        "hw": hw, "max_gt": MAX_GT, "steps": TRAIN_STEPS,
        "dtype": "bfloat16", "launches": launches, "k3_by_form": forms,
        "frozen_bn": "calibrated" if frozen_bn else "none or seeded",
        "freeze_conv_body_at": cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
        "rpn_nms": kernel, "rpn_nms_input": key,
        "losses": {k: [seen[i][k] for i in sorted(seen)] for k in seen[1]}}))
    del model, state, batch, k1_inputs, k2_inputs, args
    torch.cuda.empty_cache()
    return forms, (kernel, key)


def fixed_draws(device, seed=97):
    """``draws`` for ``make_bucket_train_step`` with the same uniforms on
    every device: drawn on the CPU from (seed, step, name), then moved."""
    def draws(step):
        def draw(name, shape):
            gen = torch.Generator().manual_seed(
                seed * 1000 + step * 10 + (name == "roi"))
            return tuple(torch.rand(shape, generator=gen).to(device)
                         for _ in range(2))
        return draw
    return draws


def two_stage_train_once(model, batch):
    """One two-stage train step with a fresh optimizer and ``fixed_draws``:
    (host losses, the sampled anchors and rois on the CPU, the
    parameters before, the update as SGD computed it; ``train_once``)."""
    state = train_state(model)
    params = dict(model.module.named_parameters())
    before = {n: p.detach().cpu().clone() for n, p in params.items()}
    metrics = model.make_bucket_train_step(
        tuple(batch["images"].shape[1:3]), draws=fixed_draws(model.device),
        return_aux=True)(state, batch)
    aux = {k: metrics.pop(k).cpu() for k in TWO_STAGE_AUX if k in metrics}
    return ({k: float(v) for k, v in metrics.items()}, aux, before,
            sgd_update(state, params, before))


@contextlib.contextmanager
def pinned_proposals(record=None, pin=None):
    """Wraps the two-stage loss's ``select_proposals``: with ``record`` (a
    list) each call's (proposals, scores, valid) is appended to it on the
    CPU; with ``pin`` (such a list) each call computes its own, counts
    the slots that differ from the pinned ones (validity, or a box
    farther than ROI_PX_TOL) and returns the pinned ones. The counts
    fill the dict it yields."""
    from paa_tpu_torch.modeling import two_stage

    plain, stats, calls = two_stage.select_proposals, {}, [0]

    def wrapped(*args):
        out = plain(*args)
        if record is not None:
            record.append(tuple(t.cpu() for t in out))
        if pin is not None:
            want = pin[calls[0]]
            calls[0] += 1
            boxes, valid = out[0].cpu(), out[2].cpu()
            stats["differing_slots"] = stats.get("differing_slots", 0) + int(
                ((boxes - want[0]).abs().amax(dim=-1).nan_to_num(0)
                 > ROI_PX_TOL) .logical_or(valid != want[2]).sum())
            stats["slots"] = stats.get("slots", 0) + valid.numel()
            out = tuple(t.to(out[0].device) for t in want)
        return out

    two_stage.select_proposals = wrapped
    try:
        yield stats
    finally:
        two_stage.select_proposals = plain


def _mask_logit_grad_x105():
    """A fault in the mask loss: its logits' gradient 1.05 times the
    right one."""
    from paa_tpu_torch.modeling import two_stage

    plain = two_stage.mask_loss
    return {"mask_logits_grad_x1.05": (
        two_stage, "mask_loss",
        lambda logits, *args: plain(
            logits.detach() + (logits - logits.detach()) * 1.05, *args))}


def phase_two_stage_train_reference(dev, frozen_bn, path=MRCNN_CONFIG,
                                    rois=REFERENCE_ROIS,
                                    what="mask_rcnn_train_card_vs_cpu"):
    """Phases 36 and 43: one float32 Mask R-CNN train step of ``path``
    (R-50-FPN; or C4 with ``rois`` C4_REFERENCE_ROIS) (TF32 off; its RPN,
    box and mask losses) on the card and on the CPU against the same
    step on the CPU in float64 (every convolution in float64; the box
    head's float32 FCs, the losses, parameters and SGD stay float32), at
    2 x 256 x 320 with REFERENCE_ROIS rois per image, the same weights
    (phase 35's calibrated FrozenBN: with the seed's identity statistics
    the random FPN's ~1e3 features give deltas and logits in the
    hundreds, and the box loss is NaN on every side), batch and
    ``fixed_draws``. The float64 step records its proposals and its ReLU
    inputs; each float32 step takes float64's proposals
    (``pinned_proposals``: the RPN's top-k and NMS are decisions that
    rounding may take apart) and float64's decision at each ReLU input
    that rounding put on the other side of 0 (``relu_decisions``: the
    calibrated body centres them at 0), each pinned element within
    PIN_SHARE of the kink; the pins are counted and printed. K1 is held
    bit-equal to its plain version on the training rows in phase 38.
    Checked: the sampled anchors (positive and negative), the sampled
    rois' labels, validity and GT indices, and num_pos equal on all
    three; the rois within ROI_PX_TOL px and the mask targets equal but
    for MASK_TARGET_SHARE_TOL of them; finite losses, the card's within
    1e-4 relative of the CPU's; each parameter tensor's update within
    phase 13's limits between the two float32 steps and of each against
    float64. The pinned card step with the mask logits' gradient x1.05
    planted must land beyond them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = build_cfg("float32", path,
                    ["MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", rois])
    batch = two_stage_batch(99, 2, (256, 320), (256.0, 300.0), True)
    proposals = []
    model = in_float64(seeded_train_model(cfg, "cpu", frozen_bn))
    with pinned_proposals(record=proposals), \
            relu_decisions(model.module) as ref:
        m64, aux64, before, p64 = two_stage_train_once(model, batch)
    del model
    steps, pins = {}, {}

    def pinned_step(side, device):
        model = seeded_train_model(cfg, device, frozen_bn)
        with pinned_proposals(pin=proposals) as proposal_pins, \
                relu_decisions(model.module, ref["inputs"], pin=True) as seen:
            out = two_stage_train_once(model, batch)
        check(seen["calls"] == ref["calls"]
              and all(f["share"] <= PIN_SHARE for f in seen["flips"]),
              f"{what} {side}: {seen['calls']} ReLU calls of "
              f"{ref['calls']}, or pinned away from the kink "
              f"{seen['flips']}")
        pins[side] = {"proposals": proposal_pins, "relu_elements": sum(
            f["elements"] for f in seen["flips"]),
            "relu_calls": len(seen["flips"])}
        return out

    for side, device in (("card", dev), ("cpu", "cpu")):
        steps[side] = pinned_step(side, device)
    (m_gpu, aux_gpu, _, p_gpu), (m_cpu, aux_cpu, _, p_cpu) = \
        steps["card"], steps["cpu"]
    for k in ("rpn_pos", "rpn_neg", "roi_labels", "roi_valid", "roi_gt_idx"):
        check(torch.equal(aux_gpu[k], aux64[k])
              and torch.equal(aux_cpu[k], aux64[k]),
              f"{what}: sampled {k} differ")
    # the rois are proposals (floats) and the targets their crops
    roi_err = {side: float((aux["rois"] - aux64["rois"]).abs().max())
               for side, aux in (("card", aux_gpu), ("cpu", aux_cpu))}
    target_share = {side: float((aux["mask_targets"]
                                 != aux64["mask_targets"]).float().mean())
                    for side, aux in (("card", aux_gpu), ("cpu", aux_cpu))}
    check(max(roi_err.values()) <= ROI_PX_TOL
          and max(target_share.values()) <= MASK_TARGET_SHARE_TOL,
          f"{what}: rois {roi_err} px, mask targets {target_share}")
    check(m_gpu["num_pos"] == m_cpu["num_pos"] == m64["num_pos"] > 0
          and int(aux64["roi_labels"].gt(0).sum()) > 0,
          f"{what}: num_pos {m_gpu['num_pos']} {m_cpu['num_pos']}")
    loss_err = {k: abs(m_gpu[k] - v) / max(abs(v), 1e-12)
                for k, v in m_cpu.items()}
    check(all(math.isfinite(v) for m in (m_gpu, m_cpu, m64)
              for v in m.values())
          and all(e <= 1e-4 for e in loss_err.values()),
          f"{what}: losses {m_gpu} {m_cpu} {m64}")
    readings = {}
    for side, got, want in (("card_vs_cpu", p_gpu, p_cpu),
                            ("card_vs_float64", p_gpu, p64),
                            ("cpu_vs_float64", p_cpu, p64)):
        norm, share = update_errors(got, want, before)
        readings[side] = {"worst_update_norm_err": norm[0],
                          "worst_update_share": share[0]}
        check(norm[0][1] <= UPDATE_NORM_TOL
              and share[0][1] <= UPDATE_SHARE_TOL,
              f"{what}: {side} {norm} {share}")
    planted = {}
    for fault, (module, attr, fn) in _mask_logit_grad_x105().items():
        plain = getattr(module, attr)
        setattr(module, attr, fn)
        try:
            _, _, _, p_bad = pinned_step(f"planted {fault}", dev)
        finally:
            setattr(module, attr, plain)
        f_norm, f_share = update_errors(p_bad, p_cpu, before)
        planted[fault] = {"worst_update_norm_err": f_norm[0],
                          "worst_update_share": f_share[0]}
        check(not (f_norm[0][1] <= UPDATE_NORM_TOL
                   and f_share[0][1] <= UPDATE_SHARE_TOL),
              f"{what}: planted {fault} within the limits: {f_norm}")
    print(json.dumps({
        "phase": what, "ok": True, "hw": [256, 320],
        "rois_per_image": rois, "num_pos": m_gpu["num_pos"],
        "pinned": pins, "roi_max_abs_err_px": roi_err,
        "mask_targets_differing_share": target_share,
        "sampled": {k: int(v.sum()) if v.dtype == torch.bool else
                    list(v.shape) for k, v in aux64.items()},
        "losses": m_gpu, "loss_rel_err": loss_err, **readings,
        "planted_faults": planted}))


def phase_mask_rcnn_test_net(dev, path=MRCNN_CONFIG,
                             what="mask_rcnn_test_net", k3_per_batch=0,
                             reference=True):
    """Phases 37 and 49: ``paa_tpu_torch.tools.test_net`` (its ``main``,
    in this process) on the Mask R-CNN of ``path`` over synth_coco_32 at
    full width in bf16 from the seeded weights, with cv2 blocked (the
    card machine has none; the polygons' fill and the masks' paste run
    in numpy) and SCORE_THRESH 0 (100 detections, so 100 pasted masks,
    per image): exit 0, the bbox and segm tables, a detection on every
    image, K1 and K2 once and K3 ``k3_per_batch`` times per eval batch.
    Then, with ``reference``, the same eval path in float32 on the card
    and on the CPU at 256 px (``eval_card_vs_cpu``): the 24 AP values
    within 1e-3."""
    from paa_tpu_torch.tools import test_net

    tmp = tempfile.mkdtemp(prefix="paa_mask_test_net_")
    os.environ["PAA_TPU_TORCH_SYNTH_DIR"] = os.path.join(tmp, "synth")
    out_dir = os.path.join(tmp, "out")
    cv2 = sys.modules.get("cv2", False)
    sys.modules["cv2"] = None  # import cv2 raises ImportError
    try:
        zero_launch_counts()
        # every candidate above 0: 100 detections and masks per image
        rc = test_net.main(["--config-file", path,
                            *synth_opts(out_dir),
                            "MODEL.ROI_HEADS.SCORE_THRESH", "0.0"])
        launches = launch_counts()
    finally:
        if cv2 is False:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = cv2
    check(rc == 0, f"{what}: exit {rc}")
    batches = launches["nms_batched"]
    check(batches >= 4 and launches == {
        "nms_batched": batches, "nms_global": batches,
        "group_norm_relu": k3_per_batch * batches, "deform_im2col": 0,
        "deform_col2im": 0},
        f"{what}: launches {launches}")
    results = read_results(out_dir, SYNTH_32[0])
    segm = {k[5:]: v for k, v in results.items() if k.startswith("segm/")}
    check(sorted(k for k in results if "/" not in k) == sorted(METRICS)
          and sorted(segm) == sorted(METRICS) and all(
              math.isfinite(v) and -1.0 <= v <= 1.0
              for v in results.values()),
          f"{what}: results {results}")
    dets = read_bbox_json(os.path.join(out_dir, "inference", SYNTH_32[0]))
    check(len({d["image_id"] for d in dets}) == 32,
          f"{what}: images with detections")
    print(json.dumps({"phase": what, "ok": True,
                      "images": 32, "cv2": "blocked", "launches": launches,
                      "detections": len(dets)}))
    print(json.dumps({"ap_table": "random weights, a synthetic dataset: "
                      "not an accuracy", "path": what, **results}))
    shutil.rmtree(tmp, ignore_errors=True)
    if not reference:
        return
    cfg = build_cfg("float32", MRCNN_CONFIG, [
        "INPUT.MIN_SIZE_TEST", 256, "INPUT.MAX_SIZE_TEST", 320,
        "TPU.TEST_BUCKETS", ((256, 320), (320, 256)),
        "TEST.IMS_PER_BATCH", 2])
    out, _ = eval_card_vs_cpu(dev, cfg, 13, "mask_rcnn_eval_card_vs_cpu",
                              build=seeded_mrcnn)
    print(json.dumps({"phase": "mask_rcnn_eval_card_vs_cpu", "ok": True,
                      **out}))


def phase_k1_at_recorded_inputs(inputs, what="k1_at_recorded_inputs",
                                required=None):
    """Phase 38 (and after phase 44): K1 against its plain version,
    bit-equal, at every distinct input shape (rows, candidates, max_out)
    at which phases 34-37 (39-44) launched it (recorded): the
    ``required`` shapes among them, by default training RPN rows of
    2,000 picks."""
    from paa_tpu_torch.ops import nms

    shapes = {}
    for args in inputs:
        key = (*args[1].shape, args[5])
        if key not in shapes:
            shapes[key] = args
    for key, args in shapes.items():
        same_keeps(nms.nms_batched(*args), nms.nms_batched_plain(*args),
                   f"nms_batched at {key}")
    if required is None:
        check(any(k[1] >= 2000 and k[2] >= 2000 for k in shapes),
              f"{what}: no training RPN rows in {list(shapes)}")
    else:
        check(set(required) <= set(shapes),
              f"{what}: {required} not among {list(shapes)}")
    print(json.dumps({"phase": what, "ok": True,
                      "shapes": [list(k) for k in shapes]}))


def phase_two_stage(dev):
    """Phases 34-38 (after phase 33): Mask R-CNN serving, Faster R-CNN
    and Mask R-CNN training, the f32 Mask R-CNN step against the CPU and
    float64, Mask R-CNN's test_net with cv2 blocked, and K1 at every
    input those runs gave it."""
    with recording_k1_inputs() as k1_inputs:
        phase_mask_rcnn_serving(dev)
        frozen_bn = calibrated_frozen_bn(FRCNN_CONFIG)
        for kind in TWO_STAGE_CONFIGS:
            phase_two_stage_train(dev, kind, frozen_bn)
        phase_two_stage_train_reference(dev, frozen_bn)
        phase_mask_rcnn_test_net(dev)
    phase_k1_at_recorded_inputs(k1_inputs)
    del k1_inputs
    torch.cuda.empty_cache()


# ---- Keypoint R-CNN and the C4 two-stage bodies ----------------------------

KRCNN_CONFIG = os.path.join(ROOT, "configs",
                            "e2e_keypoint_rcnn_R_50_FPN_1x.yaml")
C4_CONFIGS = {
    "faster_rcnn_c4": os.path.join(ROOT, "configs",
                                   "e2e_faster_rcnn_R_50_C4_1x.yaml"),
    "mask_rcnn_c4": os.path.join(ROOT, "configs",
                                 "e2e_mask_rcnn_R_50_C4_1x.yaml"),
}
# the detections of a serving request whose heatmaps are decoded on the
# host in the serving check, and the slack (px) allowed about each box
KP_DECODED, KP_BOX_SLACK = 100, 1.0
# the f32 Keypoint R-CNN detect on the card against the CPU and float64:
# detections per image (the CPU's float64 keypoint head over 100 per image
# takes minutes) and the heatmaps of a detection at the same box (within
# 0.01 px) within this share of their largest magnitude
KP_DETECTIONS_REF, KP_HEATMAP_TOL = 20, 1e-3
# the rois per image of the f32 C4 Mask R-CNN step against the CPU and
# float64 (the config's 512 cut to 64: the CPU's float64 res5 over
# 1,024 rois takes minutes)
C4_REFERENCE_ROIS = 64
# the keypoint config's own test set, which tools/synth_catalog.py serves
# as a 32-image synthetic person-keypoint COCO
KP_DATASETS = ("keypoints_coco_2017_val",)


def seeded_krcnn(dtype, device):
    """Full-width Keypoint R-CNN R-50-FPN as ``seeded_frcnn`` (its one
    foreground class's cls_score bias from seed 1 in [25, 35], so every
    roi gives a candidate above the threshold: 1,000 per image, which K1
    holds)."""
    return seeded_frcnn(dtype, device, KRCNN_CONFIG)


def seeded_c4(kind, frozen_bn, dtype, device):
    """The full-width C4 model of C4_CONFIGS[``kind``] from seed 0 with
    ``frozen_bn`` (its calibrated FrozenBN, body and res5) and, for Mask
    R-CNN, the mask logits' biases from seed 2 in [0.5, 1.5] as
    ``seeded_mrcnn``."""
    model = seeded_train_model(build_cfg(dtype, C4_CONFIGS[kind]), device,
                               frozen_bn)
    if model.module.mask_head is not None:
        gen = torch.Generator().manual_seed(2)
        bias = model.module.mask_head.mask_fcn_logits.bias
        with torch.no_grad():
            bias.copy_(torch.empty(bias.shape).uniform_(0.5, 1.5,
                                                        generator=gen))
    return model


def check_keypoints(dets):
    """Each request's "kp_heatmaps" (B, 100, 17, 56, 56) float32 and
    finite; the first image's first KP_DECODED detections decoded on the
    host (``heatmaps_to_keypoints``), every keypoint inside its box
    within KP_BOX_SLACK px, its score in (0, 1]."""
    from paa_tpu_torch.structures.keypoints import heatmaps_to_keypoints

    for det in dets:
        m = det["kp_heatmaps"]
        check(tuple(m.shape) == (BATCH, 100, 17, 56, 56)
              and m.dtype == torch.float32 and bool(torch.isfinite(m).all()),
              f"keypoint_rcnn: kp_heatmaps {tuple(m.shape)} {m.dtype}")
    valid = dets[0]["valid"][0].cpu()
    boxes = dets[0]["boxes"][0].cpu()[valid][:KP_DECODED].numpy()
    kps = heatmaps_to_keypoints(
        dets[0]["kp_heatmaps"][0].cpu()[valid][:KP_DECODED], boxes)
    x, y, score = kps[..., 0], kps[..., 1], kps[..., 2]
    # a box under a pixel wide (x2 < x1 + 1, the +1 convention's width
    # below 1) is decoded over one pixel from x1, as the reference does
    x2 = np.maximum(boxes[:, 2], boxes[:, 0] + 1)
    y2 = np.maximum(boxes[:, 3], boxes[:, 1] + 1)
    inside = ((x >= boxes[:, None, 0] - KP_BOX_SLACK)
              & (x <= x2[:, None] + KP_BOX_SLACK)
              & (y >= boxes[:, None, 1] - KP_BOX_SLACK)
              & (y <= y2[:, None] + KP_BOX_SLACK))
    check(len(kps) > 0 and inside.all() and (score > 0).all()
          and (score <= 1).all(),
          f"keypoint_rcnn: {int((~inside).sum())} keypoints outside their "
          f"box of {inside.size}")
    return {"kp_heatmaps": list(dets[0]["kp_heatmaps"].shape),
            "keypoints_decoded": int(inside.size),
            "mean_box_px": [float((boxes[:, 2] - boxes[:, 0]).mean()),
                            float((boxes[:, 3] - boxes[:, 1]).mean())]}


def check_c4_masks(dets):
    """Each request's "masks" (B, 100, 14, 14) float32 in [0, 1] (the C4
    predictor's 14 x 14)."""
    for det in dets:
        m = det["masks"]
        check(tuple(m.shape) == (BATCH, 100, 14, 14)
              and m.dtype == torch.float32
              and bool(torch.isfinite(m).all())
              and float(m.min()) >= 0 and float(m.max()) <= 1,
              f"mask_rcnn_c4: masks {tuple(m.shape)} {m.dtype}")
    m = dets[0]["masks"][dets[0]["valid"]]
    return {"masks": list(dets[0]["masks"].shape),
            "mask_pixels_above_half": float((m > 0.5).float().mean())}


@contextlib.contextmanager
def recording_k2_inputs():
    """Records the inputs of every K2 launch made while it is open (the
    batched entry ``nms._nms_global``, wrapped; its launch counter moves
    to the wrapper and back): the list it yields fills with each call's
    positional arguments."""
    from paa_tpu_torch.ops import nms

    seen, launch = [], nms._nms_global

    def recorded(*args, **kwargs):
        args = args + tuple(kwargs.values())
        seen.append(args)
        return launch(*args)

    recorded.launches = launch.launches
    nms._nms_global = recorded
    try:
        yield seen
    finally:
        launch.launches = recorded.launches
        nms._nms_global = launch


def k2_at_path_inputs(args, what):
    """K2 against its plain version on the inputs a path gave it
    (``recording_k2_inputs``): keep_idx, keep_scores and keep_valid
    bit-equal. Returns the input's (rows, candidates, max_out)."""
    from paa_tpu_torch.ops import nms

    same_keeps(nms._nms_global(*args), nms.nms_batched_plain(*args),
               f"nms_global on the {what} candidates")
    return (*args[1].shape, args[5])


def keypoint_rcnn_card_vs_cpu(dev):
    """The f32 Keypoint R-CNN on the card against the CPU at 2 x 256 x 320
    (``card_vs_cpu``: RPN outputs, detections matched), then its detect
    with KP_DETECTIONS_REF detections per image on the card, on the CPU
    and on the CPU in float64 (every convolution): each card detection's
    heatmaps against those of the detection at the same box (label
    equal, box within 0.01 px) within KP_HEATMAP_TOL of their largest
    magnitude, and its decoded keypoints' positions (the argmax) within
    a pixel of them."""
    from paa_tpu_torch.structures.keypoints import heatmaps_to_keypoints

    card_vs_cpu(dev, seeded_krcnn, lambda m, x: m.module.backbone_rpn(x)[1],
                "keypoint_rcnn_card_vs_cpu")
    images, sizes = request(99, 2, (256, 320), (256.0, 300.0))
    dets = {}
    for side, device in (("card", dev), ("cpu", "cpu"), ("float64", "cpu")):
        model = seeded_krcnn("float32", device)
        model.cfg.defrost()
        model.cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG = KP_DETECTIONS_REF
        if side == "float64":
            in_float64(model)
        dets[side] = {k: v.cpu() for k, v in model.make_eval_fn()(
            images, sizes).items()}
    gpu = dets["card"]
    out = {}
    for side in ("cpu", "float64"):
        ref = dets[side]
        compared, worst, moved = 0, 0.0, 0
        for i in range(gpu["valid"].shape[0]):
            for j in torch.nonzero(gpu["valid"][i]).flatten().tolist():
                same = ref["valid"][i] & (ref["labels"][i]
                                          == gpu["labels"][i, j])
                d = (ref["boxes"][i] - gpu["boxes"][i, j]).abs().amax(dim=1)
                d = torch.where(same, d, torch.inf)
                k = int(d.argmin())
                if float(d[k]) > 0.01:
                    continue
                compared += 1
                a, b = gpu["kp_heatmaps"][i, j], ref["kp_heatmaps"][i, k]
                worst = max(worst, float((a - b).abs().max()
                                         / b.abs().max()))
                box = gpu["boxes"][i, j:j + 1].numpy()
                pa = heatmaps_to_keypoints(a[None], box)[0]
                pb = heatmaps_to_keypoints(b[None], box)[0]
                moved += int((np.abs(pa[:, :2] - pb[:, :2]) > 1.0).any(
                    axis=1).sum())
        check(compared >= 0.9 * int(gpu["valid"].sum()) and compared > 0
              and worst <= KP_HEATMAP_TOL,
              f"keypoint_rcnn_card_vs_{side}: {compared} compared, "
              f"worst {worst}")
        out[side] = {"detections_compared": compared,
                     "heatmap_max_rel_err": worst,
                     "keypoints_moved_over_1px": moved}
    check(out["cpu"]["keypoints_moved_over_1px"]
          <= 0.01 * 17 * out["cpu"]["detections_compared"],
          f"keypoint_rcnn_card_vs_cpu: keypoints moved {out}")
    print(json.dumps({"phase": "keypoint_rcnn_heatmaps_card_vs_cpu",
                      "ok": True, "detections": int(gpu["valid"].sum()),
                      "tolerance": KP_HEATMAP_TOL, **out}))


def phase_keypoint_rcnn_serving(dev):
    """Phase 39: full-width Keypoint R-CNN serving (three 8 x 800 x 1344
    bf16 requests: K1 twice per request, the RPN's 40 rows of 1,000 and
    the box head's 8 rows of 1,000 class-aware with 100 picks; heatmaps
    (8, 100, 17, 56, 56), keypoints inside their boxes), K1 against its
    plain version on the first request's inputs at both, and the f32
    model on the card against the CPU and float64 with the heatmaps
    compared. Returns K1's inputs (rows, candidates, max_out)."""
    model = seeded_krcnn("bfloat16", dev)
    with recording_k1_inputs() as k1_inputs:
        serve(model, "keypoint_rcnn_main_path", 70,
              {"nms_batched": 6, "nms_global": 0, "group_norm_relu": 0,
               "deform_im2col": 0, "deform_col2im": 0}, 0.05,
              check_keypoints)
    check([a[1].shape[0] for a in k1_inputs[:2]] == [5 * BATCH, BATCH]
          and k1_inputs[1][6] is True and k1_inputs[1][5] == 100,
          f"keypoint_rcnn: K1's inputs {[a[1].shape for a in k1_inputs]}")
    keys = [k1_at_path_inputs(k1_inputs[0], "keypoint_rcnn_rpn"),
            k1_at_path_inputs(k1_inputs[1], "keypoint_rcnn_box_head")]
    del model, k1_inputs
    torch.cuda.empty_cache()
    keypoint_rcnn_card_vs_cpu(dev)
    return keys


def phase_c4_serving(dev, kind, frozen_bn):
    """Phase 41: full-width C4 Faster or Mask R-CNN serving (three
    8 x 800 x 1344 bf16 requests, calibrated FrozenBN: K1 once per
    request at the RPN's 8 rows of 6,000 with 1,000 picks, K2 once at the
    box head's 80,000 candidates per image; for Mask R-CNN masks
    (8, 100, 14, 14)), K1 and K2 against their plain versions on the
    first request's inputs. Returns K1's and K2's inputs (rows,
    candidates, max_out)."""
    model = seeded_c4(kind, frozen_bn, "bfloat16", dev)
    with recording_k1_inputs() as k1_inputs, \
            recording_k2_inputs() as k2_inputs:
        serve(model, f"{kind}_main_path", 80,
              {"nms_batched": 3, "nms_global": 3, "group_norm_relu": 0,
               "deform_im2col": 0, "deform_col2im": 0}, 0.05,
              check_c4_masks if kind == "mask_rcnn_c4" else None)
    # one level: the RPN's rows are the images, PRE_NMS_TOP_N_TEST (6,000)
    # candidates, POST_NMS_TOP_N_TEST (1,000) picks; the box head's
    # candidates are those picks x 80 classes
    rpn = model.cfg.MODEL.RPN
    _, counts = model.anchors_for(HW)
    n = min(rpn.PRE_NMS_TOP_N_TEST, counts[0])
    picks = min(rpn.POST_NMS_TOP_N_TEST, n)
    want = [(BATCH, n, picks), (BATCH, min(picks, rpn.FPN_POST_NMS_TOP_N_TEST)
                                * (model.cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES
                                   - 1), 100)]
    got = [(*a[1].shape, a[5]) for a in (k1_inputs[0], k2_inputs[0])]
    check(got == want, f"{kind}: K1 and K2 at {got}, expected {want}")
    keys = (k1_at_path_inputs(k1_inputs[0], f"{kind}_rpn"),
            k2_at_path_inputs(k2_inputs[0], f"{kind}_box_head"))
    del model, k1_inputs, k2_inputs
    torch.cuda.empty_cache()
    return keys


def keypoint_batch(seed, bsz, hw, size):
    """``train_batch`` for Keypoint R-CNN: every GT a person (label 1)
    with the synthetic COCO's 17 keypoints in its box
    (data/synth.py ``box_keypoints``); 'gt_keypoints' (B, MAX_GT, 17, 3)
    float32, zero in the padding slots."""
    from paa_tpu_torch.data.synth import box_keypoints

    batch = train_batch(seed, bsz, hw, size)
    labels = batch["gt_labels"].clamp(max=1)
    boxes = batch["gt_boxes"].numpy()
    rng = np.random.RandomState(seed + 2)
    kps = np.zeros((*labels.shape, 17, 3), np.float32)
    for b, g in zip(*np.nonzero(labels.numpy())):
        x1, y1, x2, y2 = boxes[b, g]
        kps[b, g] = np.reshape(box_keypoints(rng, x1, y1, x2 - x1,
                                             y2 - y1)[0], (17, 3))
    return {**batch, "gt_labels": labels,
            "gt_keypoints": torch.from_numpy(kps)}


def phase_keypoint_and_c4(dev):
    """Phases 39-44 (after phase 38): Keypoint R-CNN serving (39) and
    training (40, ``phase_two_stage_train``: B=16, K1 once per step at
    the training RPN's 80 rows of 2,000); C4 Faster and Mask R-CNN
    serving (41) and training (42: B=8, the RPN's 8 rows of 12,000
    candidates per image, above K1's 8,192, K2 once per step with 2,000
    picks), calibrated FrozenBN; the f32 C4 Mask R-CNN step against the
    CPU and float64 (43, ``phase_two_stage_train_reference``); Keypoint
    R-CNN ``test_net`` over a synthetic person-keypoint COCO with cv2
    blocked (44); then K1 and K2 at every input those runs gave them,
    bit-equal to their plain versions, the inputs the phases held
    among them."""
    k1, k2 = [], []
    with recording_k1_inputs() as k1_inputs, \
            recording_k2_inputs() as k2_inputs:
        k1 += phase_keypoint_rcnn_serving(dev)
        fpn_bn = calibrated_frozen_bn(KRCNN_CONFIG)
        c4_bn = calibrated_frozen_bn(C4_CONFIGS["faster_rcnn_c4"])
        for kind in C4_CONFIGS:
            rpn, box_head = phase_c4_serving(dev, kind, c4_bn)
            k1.append(rpn)
            k2.append(box_head)
        # the training RPN's rows go to K1 or K2 by their length
        for kind, frozen_bn in (("keypoint_rcnn", fpn_bn),
                                *((kind, c4_bn) for kind in C4_CONFIGS)):
            _, (kernel, key) = phase_two_stage_train(dev, kind, frozen_bn)
            (k2 if kernel == "nms_global" else k1).append(key)
        phase_two_stage_train_reference(
            dev, c4_bn, C4_CONFIGS["mask_rcnn_c4"], C4_REFERENCE_ROIS,
            "mask_rcnn_c4_train_card_vs_cpu")
        phase_keypoint_rcnn_test_net(dev)
    phase_k1_at_recorded_inputs(k1_inputs, "k1_at_recorded_inputs_kp_c4",
                                k1)
    shapes = phase_k2_at_recorded_inputs(k2_inputs)
    check(set(k2) <= set(shapes),
          f"k2_at_recorded_inputs: {k2} not among {shapes}")
    del k1_inputs, k2_inputs
    torch.cuda.empty_cache()


def phase_k2_at_recorded_inputs(inputs):
    """K2 against its plain version, bit-equal, at every distinct input
    shape (rows, candidates, max_out) at which phases 39-44 launched it
    (recorded; the C4 box head's 80,000 per image and the C4 training
    RPN's 12,000 with 2,000 picks must be among them); returns the
    shapes checked."""
    from paa_tpu_torch.ops import nms

    shapes = {}
    for args in inputs:
        key = (*args[1].shape, args[5])
        if key not in shapes:
            shapes[key] = args
    for key, args in shapes.items():
        same_keeps(nms._nms_global(*args), nms.nms_batched_plain(*args),
                   f"nms_global at {key}")
    print(json.dumps({"phase": "k2_at_recorded_inputs", "ok": True,
                      "shapes": [list(k) for k in shapes]}))
    return list(shapes)


def phase_keypoint_rcnn_test_net(dev):
    """Phase 44: ``paa_tpu_torch.tools.test_net`` (its ``main``, in this
    process) on Keypoint R-CNN over the synthetic person-keypoint COCO
    of 32 PPM images (the config's own DATASETS.TEST,
    keypoints_coco_2017_val, which tools/synth_catalog.py serves) at full
    width in bf16 from the seeded weights, with cv2 blocked (the
    heatmaps' cubic resize runs without it): exit 0, the bbox and
    keypoints tables, a detection on every image, K1 twice per batch
    (RPN and box head)."""
    from paa_tpu_torch.tools import test_net

    tmp = tempfile.mkdtemp(prefix="paa_kp_test_net_")
    os.environ["PAA_TPU_TORCH_SYNTH_DIR"] = os.path.join(tmp, "synth")
    out_dir = os.path.join(tmp, "out")
    cv2 = sys.modules.get("cv2", False)
    sys.modules["cv2"] = None  # import cv2 raises ImportError
    try:
        zero_launch_counts()
        rc = test_net.main(["--config-file", KRCNN_CONFIG,
                            *synth_opts(out_dir),
                            "DATASETS.TEST", str(KP_DATASETS)])
        launches = launch_counts()
    finally:
        if cv2 is False:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = cv2
    check(rc == 0, f"keypoint_rcnn_test_net: exit {rc}")
    batches = launches["nms_batched"] // 2
    check(batches >= 4 and launches == {
        "nms_batched": 2 * batches, "nms_global": 0,
        "group_norm_relu": 0, "deform_im2col": 0, "deform_col2im": 0},
        f"keypoint_rcnn_test_net: launches {launches}")
    dataset = KP_DATASETS[0]
    results = read_results(out_dir, dataset)
    oks = {k[10:]: v for k, v in results.items()
           if k.startswith("keypoints/")}
    check(sorted(k for k in results if "/" not in k) == sorted(METRICS)
          and len(oks) == 10 and all(math.isfinite(v) and -1.0 <= v <= 1.0
                                     for v in results.values()),
          f"keypoint_rcnn_test_net: results {results}")
    dets = read_bbox_json(os.path.join(out_dir, "inference", dataset))
    check(len({d["image_id"] for d in dets}) == 32,
          "keypoint_rcnn_test_net: images with detections")
    print(json.dumps({"phase": "keypoint_rcnn_test_net", "ok": True,
                      "images": 32, "cv2": "blocked", "launches": launches,
                      "detections": len(dets)}))
    print(json.dumps({"ap_table": "random weights, a synthetic dataset: "
                      "not an accuracy", **results}))
    shutil.rmtree(tmp, ignore_errors=True)


# ---- the GN baselines and the RPN-only model --------------------------------

GN_CONFIGS = {
    "mask_rcnn_gn": os.path.join(
        ROOT, "configs", "gn_baselines",
        "e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml"),
    "faster_rcnn_gn_scratch": os.path.join(
        ROOT, "configs", "gn_baselines",
        "scratch_e2e_faster_rcnn_R_50_FPN_3x_gn.yaml"),
}
RPN_CONFIGS = {
    "rpn_fpn": os.path.join(ROOT, "configs", "rpn_R_50_FPN_1x.yaml"),
    "rpn_c4": os.path.join(ROOT, "configs", "rpn_R_50_C4_1x.yaml"),
}
# the f32 RPN-only proposals on the card against the CPU's from the same
# RPN outputs: boxes within this many px
RPN_BOX_TOL = 1e-2


def seeded_gn_mrcnn(dtype, device):
    """Full-width GN Mask R-CNN (e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn:
    GN body, GN FPN, the Xconv1fc GN box head, the GN mask head) as
    ``seeded_mrcnn``: weights from seed 0, the foreground cls_score
    biases from seed 1 in [25, 35], the mask logits' from seed 2."""
    return seeded_mrcnn(dtype, device, GN_CONFIGS["mask_rcnn_gn"])


def gn_launches_per_forward(model):
    """K3's launches in one forward of ``model``, by form: each
    GroupNorm32 once (the body's and FPN's over the batch, the ROI heads'
    over their rois)."""
    from paa_tpu_torch.modeling.layers import GroupNorm32

    gns = [m for m in model.module.modules() if isinstance(m, GroupNorm32)]
    return {"relu": sum(g.relu for g in gns),
            "no_relu": sum(not g.relu for g in gns)}


@contextlib.contextmanager
def recording_k3_launches():
    """Records (shape, dtype, relu) of every K3 launch made while it is
    open, in launch order (the launcher behind ``group_norm_relu``,
    wrapped): the list it yields fills as the paths run."""
    from paa_tpu_torch.ops import group_norm as gn

    seen, launch = [], gn._group_norm_relu_cuda

    def recorded(x, *args):
        seen.append((tuple(x.shape), x.dtype,
                     args[4] if len(args) > 4 else True))
        return launch(x, *args)

    gn._group_norm_relu_cuda = recorded
    try:
        yield seen
    finally:
        gn._group_norm_relu_cuda = launch


@contextlib.contextmanager
def recording_k4_launches():
    """Records (x's shape, dtype, kh, kw, stride, padding, dilation,
    groups, deformable groups, modulated) of every K4 launch made while
    it is open, in launch order (the launcher behind ``deform_im2col``,
    wrapped): the list it yields fills as the paths run."""
    from paa_tpu_torch.ops import deform_sampling as ds

    seen, launch = [], ds._deform_im2col_cuda

    def recorded(x, offsets, mask, *conv):
        seen.append((tuple(x.shape), x.dtype, *conv, mask is not None))
        return launch(x, offsets, mask, *conv)

    ds._deform_im2col_cuda = recorded
    try:
        yield seen
    finally:
        ds._deform_im2col_cuda = launch


@contextlib.contextmanager
def recording_k5_launches():
    """Records (x's shape, dtype, kh, kw, stride, padding, dilation,
    groups, deformable groups, modulated) of every K5 launch made while
    it is open, in launch order (the launcher behind ``deform_col2im``,
    wrapped), as ``recording_k4_launches`` does K4's."""
    from paa_tpu_torch.ops import deform_sampling as ds

    seen, launch = [], ds._deform_col2im_cuda

    def recorded(x, offsets, mask, dcol, *conv):
        seen.append((tuple(x.shape), x.dtype, *conv, mask is not None))
        return launch(x, offsets, mask, dcol, *conv)

    ds._deform_col2im_cuda = recorded
    try:
        yield seen
    finally:
        ds._deform_col2im_cuda = launch


def phase_gn_mask_rcnn_serving(dev):
    """Phase 45: full-width GN Mask R-CNN serving (three 8 x 800 x 1344
    bf16 requests: K1 once (the RPN's 40 rows of 1,000), K2 once (the box
    head's 80,000 per image) and K3 once per GroupNorm per request, by
    form: the body's bn3 and downsample and the FPN's GN without ReLU;
    masks (8, 100, 28, 28)); K1 and K2 against their plain versions on
    the first request's inputs; the f32 model on the card against the
    CPU, its masks compared."""
    model = seeded_gn_mrcnn("bfloat16", dev)
    per = gn_launches_per_forward(model)
    with recording_k1_inputs() as k1_inputs, \
            recording_k2_inputs() as k2_inputs, \
            recording_k3_launches() as k3_launches:
        serve(model, "mask_rcnn_gn_main_path", 90,
              {"nms_batched": 3, "nms_global": 3,
               "group_norm_relu": 3 * sum(per.values()), "deform_im2col": 0,
               "deform_col2im": 0},
              0.05, check_masks)
    forms = k3_forms(k3_launches)
    check(forms == {k: 3 * v for k, v in per.items()} and per["no_relu"],
          f"mask_rcnn_gn: K3 by form {forms}, expected 3 x {per}")
    k1_at_path_inputs(k1_inputs[0], "mask_rcnn_gn_rpn")
    k2_at_path_inputs(k2_inputs[0], "mask_rcnn_gn_box_head")
    del model, k1_inputs, k2_inputs
    torch.cuda.empty_cache()
    mask_rcnn_card_vs_cpu(dev, seeded_gn_mrcnn, "mask_rcnn_gn")


def seeded_rpn_only(kind, frozen_bn, dtype, device):
    """The full-width RPN-only model of RPN_CONFIGS[``kind``] from seed 0
    with ``frozen_bn`` (its calibrated FrozenBN)."""
    return seeded_train_model(build_cfg(dtype, RPN_CONFIGS[kind]), device,
                              frozen_bn)


def check_proposals(dets):
    """Each request's proposals: boxes (B, K, 4) finite and inside the
    image, scores finite, labels = valid, K = FPN_POST_NMS_TOP_N_TEST
    (2,000) at most, valid proposals on every image."""
    for det in dets:
        b, k = det["valid"].shape
        boxes, valid = det["boxes"], det["valid"]
        check(b == BATCH and k <= 2000 and tuple(boxes.shape) == (b, k, 4)
              and bool(torch.isfinite(boxes).all())
              and bool(torch.isfinite(det["scores"]).all())
              and torch.equal(det["labels"], valid.to(torch.int32))
              and bool(valid.any(dim=1).all()),
              f"rpn_only: proposals {tuple(boxes.shape)}")
        vb = boxes[valid]
        check(bool((vb >= 0).all())
              and bool((vb[:, 0::2] <= SIZE[1] - 1).all())
              and bool((vb[:, 1::2] <= SIZE[0] - 1).all()),
              "rpn_only: proposals outside the image")
    return {"proposals": list(dets[0]["boxes"].shape)}


def rpn_card_vs_cpu(dev, kind, frozen_bn):
    """The f32 RPN-only model on the card against the CPU at
    2 x 256 x 320 (TF32 off): the RPN's outputs within 1e-3 of their
    largest magnitude; the card's proposals against ``select_proposals``
    on the CPU from the card's own RPN outputs: each proposal's validity
    and its place in the pick order equal, objectness equal, boxes within
    RPN_BOX_TOL px. The seeded RPN's objectness logits crowd (their
    gaps are printed beside the outputs' difference), so the two
    devices' whole paths may order near-equal proposals apart; the share
    of their slots that agree is printed, not held."""
    from paa_tpu_torch.modeling.rpn import select_proposals
    from paa_tpu_torch.ops.image_norm import device_normalize

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, sizes = request(99, 2, (256, 320), (256.0, 300.0))
    side = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        model = seeded_rpn_only(kind, frozen_bn, "float32", device)
        anchors, counts = model.anchors_for((256, 320))
        with torch.inference_mode():
            x = device_normalize(images.to(device), sizes.to(device),
                                 model.cfg.INPUT.PIXEL_MEAN,
                                 model.cfg.INPUT.PIXEL_STD)
            out = model.module(x.permute(0, 3, 1, 2).contiguous())
            props = select_proposals(out, sizes.to(device), anchors, counts,
                                     model.postprocess_config())
        side[where] = ({k: v.cpu() for k, v in out.items()},
                       [t.cpu() for t in props], anchors.cpu(), counts,
                       model.postprocess_config())
    (out_g, props_g, _, _, pp), (out_c, props_c, anchors, counts, _) = \
        side["card"], side["cpu"]
    rel = {k: float((out_g[k] - v).abs().max() / v.abs().max())
           for k, v in out_c.items()}
    with torch.inference_mode():
        want = select_proposals(out_g, sizes, anchors, counts, pp)
    box_err = float((props_g[0] - want[0]).abs().max())
    valid = props_g[2]
    check(all(v <= 1e-3 for v in rel.values())
          and torch.equal(valid, want[2]) and int(valid.sum()) > 0
          and torch.equal(props_g[1][valid], want[1][valid])
          and box_err <= RPN_BOX_TOL,
          f"{kind}_card_vs_cpu: RPN outputs {rel}, validity equal "
          f"{torch.equal(valid, want[2])}, boxes {box_err} px")
    top = out_c["objectness"].sort(dim=1, descending=True).values[:, :2000]
    gaps = (top[:, :-1] - top[:, 1:]).flatten()
    same = (props_c[2] == valid) & ((props_c[0] - props_g[0]).abs().amax(
        dim=-1) <= RPN_BOX_TOL)
    print(json.dumps({"phase": f"{kind}_card_vs_cpu", "ok": True,
                      "hw": [256, 320], "proposals": int(valid.sum()),
                      "rpn_outputs_rel_err": rel,
                      "box_max_abs_err_px": box_err,
                      "box_tolerance_px": RPN_BOX_TOL,
                      "objectness_median_gap": float(gaps.median()),
                      "objectness_max_abs_err": float(
                          (out_g["objectness"] - out_c["objectness"]).abs()
                          .max()),
                      "end_to_end_slots_agreeing": float(
                          same.float().mean())}))


def phase_rpn_test_net(dev, kind, frozen_bn_state):
    """``paa_tpu_torch.tools.test_net`` on the RPN-only config of ``kind``
    over synth_coco_32 at full width in bf16 with cv2 blocked, from a
    checkpoint of the seeded model with its calibrated FrozenBN (``--ckpt``):
    exit 0, the box_proposal table (AR, ARs, ARm, ARl at 100 and 1,000
    proposals per image) in box_proposals.json, its NMS kernel once per
    batch."""
    from paa_tpu_torch.tools import test_net

    tmp = tempfile.mkdtemp(prefix=f"paa_{kind}_test_net_")
    os.environ["PAA_TPU_TORCH_SYNTH_DIR"] = os.path.join(tmp, "synth")
    out_dir = os.path.join(tmp, "out")
    # the weights as utils/checkpoint.py's load_weights reads them
    ckpt = os.path.join(tmp, "model_seeded.pth")
    torch.save({"model": seeded_rpn_only(
        kind, frozen_bn_state, "bfloat16", "cpu").module.state_dict(),
        "extra": {}}, ckpt)
    cv2 = sys.modules.get("cv2", False)
    sys.modules["cv2"] = None  # import cv2 raises ImportError
    try:
        zero_launch_counts()
        rc = test_net.main(["--config-file", RPN_CONFIGS[kind], "--ckpt",
                            ckpt, *synth_opts(out_dir)])
        launches = launch_counts()
    finally:
        if cv2 is False:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = cv2
    check(rc == 0, f"{kind}_test_net: exit {rc}")
    kernel = "nms_global" if kind == "rpn_c4" else "nms_batched"
    batches = launches[kernel]
    check(batches >= 4 and launches == {
        "nms_batched": 0, "nms_global": 0, "group_norm_relu": 0,
        "deform_im2col": 0, "deform_col2im": 0, kernel: batches},
        f"{kind}_test_net: launches {launches}")
    with open(os.path.join(out_dir, "inference", SYNTH_32[0],
                           "box_proposals.json")) as f:
        table = json.load(f)
    check(list(table) == [f"AR{s}@{n}" for n in (100, 1000)
                          for s in ("", "s", "m", "l")]
          and all(math.isfinite(v) and 0.0 <= v <= 1.0
                  for v in table.values()),
          f"{kind}_test_net: box_proposal table {table}")
    print(json.dumps({"phase": f"{kind}_test_net", "ok": True,
                      "images": 32, "cv2": "blocked",
                      "launches": launches}))
    print(json.dumps({"box_proposal_table": "random weights, a synthetic "
                      "dataset: not an accuracy", "path": kind, **table}))
    shutil.rmtree(tmp, ignore_errors=True)


def phase_rpn_only_serving(dev, kind, frozen_bn):
    """Phases 50 and 51's serving: three 8 x 800 x 1344 bf16 requests of
    the full-width RPN-only model of ``kind`` (calibrated FrozenBN): the
    FPN model's five levels in one K1 launch a request (40 rows of
    PRE_NMS_TOP_N_TEST 1,000, 1,000 picks each, 2,000 proposals an
    image); the C4 model's 8 rows of 12,000 (PRE_NMS_TOP_N_TEST, above
    K1's 8,192) in one K2 launch with POST_NMS_TOP_N_TEST 2,000 picks;
    that kernel against its plain version on the first request's rows,
    bit-equal."""
    model = seeded_rpn_only(kind, frozen_bn, "bfloat16", dev)
    kernel = "nms_global" if kind == "rpn_c4" else "nms_batched"
    expected = {"nms_batched": 0, "nms_global": 0, "group_norm_relu": 0,
                "deform_im2col": 0, "deform_col2im": 0, kernel: 3}
    with recording_k1_inputs() as k1_inputs, \
            recording_k2_inputs() as k2_inputs:
        serve(model, f"{kind}_main_path", 100, expected, None,
              check_proposals, detections=False)
    rpn = model.cfg.MODEL.RPN
    _, counts = model.anchors_for(HW)
    n = min(rpn.PRE_NMS_TOP_N_TEST, max(counts))
    args = (k2_inputs if kernel == "nms_global" else k1_inputs)[0]
    want = (len(counts) * BATCH, n, min(rpn.POST_NMS_TOP_N_TEST, n))
    got = (*args[1].shape, args[5])
    check(got == want, f"{kind}: its NMS at {got}, expected {want}")
    if kernel == "nms_global":
        k2_at_path_inputs(args, f"{kind}_rpn")
    else:
        k1_at_path_inputs(args, f"{kind}_rpn")
    del model, k1_inputs, k2_inputs, args
    torch.cuda.empty_cache()


def phase_gn_and_rpn_only(dev):
    """Phases 45-51 (after phase 44): GN Mask R-CNN serving (45) and
    training at B=16 with FREEZE_CONV_BODY_AT 2 (46); the f32 GN Mask
    R-CNN on the card against the CPU, its detections and masks, and one
    train step against the CPU and float64 with the proposal and ReLU
    pins and the planted x1.05 (47); the scratch GN Faster R-CNN's
    training at B=16, the whole body trainable, FPN2MLP with its fc GN
    (48); test_net of the GN Mask R-CNN over synth_coco_32 with cv2
    blocked (49); rpn_R_50_FPN_1x (50) and rpn_R_50_C4_1x (51): serving,
    training at IMS_PER_BATCH (16; the C4 config sets none and takes the
    default, 16), test_net to the box_proposal table, and for FPN its
    f32 proposals on the card against the CPU. The GN trainings' K3
    launches by form: each GroupNorm once a step in its form."""
    phase_gn_mask_rcnn_serving(dev)
    for kind in GN_CONFIGS:
        per = gn_launches_per_forward(seeded_train_model(
            build_cfg("bfloat16", GN_CONFIGS[kind]), "cpu"))
        forms, _ = phase_two_stage_train(dev, kind, None,
                                         k3_per_step=sum(per.values()))
        check(forms == {k: TRAIN_STEPS * v for k, v in per.items()},
              f"{kind}_train: K3 by form {forms}, expected {TRAIN_STEPS} "
              f"x {per}")
        if kind == "mask_rcnn_gn":
            phase_two_stage_train_reference(
                dev, None, GN_CONFIGS[kind], REFERENCE_ROIS,
                "mask_rcnn_gn_train_card_vs_cpu")
    per = gn_launches_per_forward(seeded_gn_mrcnn("bfloat16", "cpu"))
    phase_mask_rcnn_test_net(
        dev, GN_CONFIGS["mask_rcnn_gn"], "mask_rcnn_gn_test_net",
        k3_per_batch=sum(per.values()), reference=False)
    for kind in RPN_CONFIGS:
        frozen_bn = calibrated_frozen_bn(RPN_CONFIGS[kind])
        phase_rpn_only_serving(dev, kind, frozen_bn)
        phase_two_stage_train(dev, kind, frozen_bn)
        phase_rpn_test_net(dev, kind, frozen_bn)
        if kind == "rpn_fpn":
            rpn_card_vs_cpu(dev, kind, frozen_bn)
    torch.cuda.empty_cache()


# ---- the mobile bodies and SyncBatchNorm -----------------------------------

MNV2_CONFIG = os.path.join(ROOT, "configs", "fcos",
                           "fcos_bn_bs16_MNV2_FPN_1x.yaml")
FBNET_CONFIGS = {
    "fbnet_mask_rcnn": os.path.join(ROOT, "configs",
                                    "e2e_mask_rcnn_fbnet_600.yaml"),
    "fbnet_chamv1a": os.path.join(ROOT, "configs",
                                  "e2e_faster_rcnn_fbnet_chamv1a_600.yaml"),
    "fbnet_dsmask": os.path.join(
        ROOT, "configs", "e2e_mask_rcnn_fbnet_xirb16d_dsmask.yaml"),
}
# each FBNet config's padded input and content at its test size (600 /
# 1,000 and 320 / 640: MIN_SIZE_TEST / MAX_SIZE_TEST, padded to 32)
FBNET_HW = {
    "fbnet_mask_rcnn": ((608, 1024), (600.0, 1000.0)),
    "fbnet_chamv1a": ((608, 1024), (600.0, 1000.0)),
    "fbnet_dsmask": ((320, 640), (320.0, 640.0)),
}
SYNCBN_OPTS = ["MODEL.USE_SYNCBN", True]
# a SyncBatchNorm whose output the SyncBN checks read (stage 3's first)
SYNCBN_PROBE = "backbone.resnet.layer3_0.bn2"
# the SyncBN two-rank step (phase 19): the global batch and the limits of
# the normalized activations and running statistics against one process,
# each a share of the tensor's largest magnitude (float32 sums of the
# ranks' partial sums, in another order than one process's)
SYNCBN_DDP_BATCH, SYNCBN_TOL = 16, 1e-4


def seeded_fbnet(kind, frozen_bn, dtype, device):
    """The full-width FBNet model of FBNET_CONFIGS[``kind``] from seed 0
    with ``frozen_bn`` (calibrated: the trunk and the RPN, box and mask
    heads' stages), the 80 foreground cls_score biases from seed 1 in
    [25, 35] (``seeded_frcnn``) and, for Mask R-CNN, the mask logits'
    biases from seed 2 in [0.5, 1.5] (``seeded_mrcnn``)."""
    model = seeded_train_model(build_cfg(dtype, FBNET_CONFIGS[kind]), device,
                               frozen_bn)
    with torch.no_grad():
        bias = model.module.box_head.cls_score.bias
        bias[1:].copy_(torch.empty(bias.numel() - 1).uniform_(
            25.0, 35.0, generator=torch.Generator().manual_seed(1)))
        if model.module.mask_head is not None:
            bias = model.module.mask_head.mask_fcn_logits.bias
            bias.copy_(torch.empty(bias.shape).uniform_(
                0.5, 1.5, generator=torch.Generator().manual_seed(2)))
    return model


def phase_fbnet_serving(dev, kind, frozen_bn):
    """Phases 53 and 56: full-width FBNet serving at the config's test size
    (three 8-image bf16 requests, calibrated FrozenBN): K1 once per
    request at the RPN's 8 rows of PRE_NMS_TOP_N_TEST (6,000) candidates
    with POST_NMS_TOP_N_TEST picks, and the box head's NMS over those
    picks x 80 classes per image: K1 at the 320 configs' 100 x 80 =
    8,000 (within its 8,192), K2 at the _600 configs' 200 x 80 = 16,000;
    for Mask R-CNN masks (8, 100, 12, 12). Both kernels against their
    plain versions on the first request's inputs."""
    from paa_tpu_torch.ops import nms

    hw, size = FBNET_HW[kind]
    model = seeded_fbnet(kind, frozen_bn, "bfloat16", dev)
    rpn = model.cfg.MODEL.RPN
    _, counts = model.anchors_for(hw)
    n = min(rpn.PRE_NMS_TOP_N_TEST, counts[0])
    picks = min(rpn.POST_NMS_TOP_N_TEST, n)
    box_n = min(picks, rpn.FPN_POST_NMS_TOP_N_TEST) * (
        model.cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES - 1)
    on_k2 = box_n > nms.k1_max_candidates(dev)
    expected = {"nms_batched": 3 if on_k2 else 6,
                "nms_global": 3 if on_k2 else 0, "group_norm_relu": 0,
                "deform_im2col": 0, "deform_col2im": 0}
    masks = model.module.mask_head is not None
    with recording_k1_inputs() as k1_inputs, \
            recording_k2_inputs() as k2_inputs:
        serve(model, f"{kind}_main_path", 90, expected, 0.05,
              (lambda dets: check_masks(dets, 12)) if masks else None,
              hw=hw, size=size)
    box_args = k2_inputs[0] if on_k2 else k1_inputs[1]
    got = [(*a[1].shape, a[5]) for a in (k1_inputs[0], box_args)]
    want = [(BATCH, n, picks), (BATCH, box_n, 100)]
    check(got == want, f"{kind}: the RPN's and the box head's NMS at {got},"
                       f" expected {want}")
    k1_at_path_inputs(k1_inputs[0], f"{kind}_rpn")
    (k2_at_path_inputs if on_k2 else k1_at_path_inputs)(
        box_args, f"{kind}_box_head")
    del model, k1_inputs, k2_inputs
    torch.cuda.empty_cache()


@contextlib.contextmanager
def pinned_relus(record=None, pin=None, rows=slice(None)):
    """Every ReLU of PAA-R50's forward, patched: the body's and FPN P7's
    (``F.relu`` of modeling/resnet.py and fpn.py) and the head towers'
    GroupNorm+ReLU (``layers.group_norm_relu``, through K3's relu=False
    form and the decision after it). With ``record`` (a list) each
    call's decisions (input <= 0) are appended to it on the CPU,
    bit-packed; with ``pin`` (such a list) the k-th call takes the k-th
    decisions on ``rows`` of the recorded batch. BatchNorm on batch
    statistics centres every ReLU input of the body at 0, so float32 sums
    in another order move elements across the kink, and each backward
    through a norm spreads such an element over its channel or group: the
    SyncBN steps compared across processes take one process's decisions.
    Yields the number of calls."""
    from paa_tpu_torch.modeling import fpn, layers, resnet

    calls, gn_relu = [0], layers.group_norm_relu

    def decide(x):
        if record is not None:
            below = x <= 0
            record.append((tuple(below.shape), np.packbits(
                below.cpu().numpy())))
        else:
            shape, bits = pin[calls[0]]
            below = torch.from_numpy(np.unpackbits(
                bits, count=int(np.prod(shape))).reshape(shape).astype(
                bool))[rows].to(x.device)
        calls[0] += 1
        return torch.where(below, 0.0, x)

    def pinned_gn(x, weight, bias, groups=32, eps=1e-5, relu=True):
        y = gn_relu(x, weight, bias, groups, eps, False)
        return decide(y) if relu else y

    class Functional:
        def __getattr__(self, attr):
            return getattr(F, attr)

        @staticmethod
        def relu(x):
            return decide(x)

    resnet.F = fpn.F = Functional()
    layers.group_norm_relu = pinned_gn
    try:
        yield calls
    finally:
        resnet.F = fpn.F = F
        layers.group_norm_relu = gn_relu


def syncbn_ddp_step(dev, batch, pins, rows=slice(None)):
    """One float32 SyncBN PAA-R50 step (TF32 and cuDNN off, as the DDP
    comparison runs) on ``batch`` with the body's ReLU decisions recorded
    into ``pins`` (a list; ``rows`` None) or pinned from it on ``rows``:
    (host metrics, the positive mask, the parameters before and after,
    the SyncBatchNorm probe's output, every running statistic, on the
    CPU, and the ReLU calls)."""
    from paa_tpu_torch.modeling import build_detection_model

    torch.backends.cudnn.enabled = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_detection_model(build_cfg("float32", PAA_CONFIG,
                                            SYNCBN_OPTS), device=dev, seed=0)
    seen = []
    model.module.get_submodule(SYNCBN_PROBE).register_forward_hook(
        lambda m, i, o: seen.append(o.detach().cpu()))
    record = pins if rows is None else None
    with pinned_relus(record=record, pin=None if record is not None
                      else pins, rows=rows or slice(None)) as calls:
        metrics, pos_mask, before, after = train_once(model, batch)
    torch.backends.cudnn.enabled = True
    stats = {k: v.detach().cpu().clone() for k, v in
             model.module.state_dict().items() if "running" in k}
    return metrics, pos_mask, before, after, seen[0], stats, calls[0]


def phase_syncbn_train(dev):
    """Phase 57: PAA-R50 with MODEL.USE_SYNCBN True (a trainable
    SyncBatchNorm in each of the body's 53 norms, batch statistics in
    training mode) at full width in bf16: TRAIN_STEPS do_train steps at
    B=16 (K3 40 per step in the head); then an eval request on the
    trained model: every SyncBatchNorm in eval mode, the running
    statistics unmoved by it and used (the probe's output equals the
    running-statistics formula on its input), the detections' shapes and
    finite values, and the running statistics moved by the training from
    their init."""
    from paa_tpu_torch.modeling.layers import SyncBatchNorm

    trained, _ = phase_train_main_path(
        dev, PAA_CONFIG, "syncbn_train_main_path", extra=SYNCBN_OPTS)
    norms = [m for m in trained.module.modules()
             if isinstance(m, SyncBatchNorm)]
    check(len(norms) == 53, f"syncbn: {len(norms)} SyncBatchNorm")
    stats = {k: v.clone() for k, v in trained.module.state_dict().items()
             if "running" in k}
    moved = sum(not torch.equal(v, torch.zeros_like(v) if "mean" in k
                                else torch.ones_like(v))
                for k, v in stats.items())
    seen = []
    probe = trained.module.get_submodule(SYNCBN_PROBE)
    hook = probe.register_forward_hook(
        lambda m, i, o: seen.append((i[0].float(), o)))
    images, sizes = request(95, BATCH, HW, SIZE)
    det = trained.make_eval_fn()(images, sizes)
    hook.remove()
    x, y = seen[0]
    scale = probe.weight * torch.rsqrt(probe.running_var + probe.eps)
    want = (x - probe.running_mean[:, None, None]) * scale[:, None, None] \
        + probe.bias[:, None, None]
    err = float((y - want).abs().max() / want.abs().max())
    check(not any(m.training for m in norms) and err <= 1e-5
          and moved == len(stats)
          and all(torch.equal(v, trained.module.state_dict()[k])
                  for k, v in stats.items())
          and tuple(det["boxes"].shape) == (BATCH, 100, 4)
          and bool(torch.isfinite(det["boxes"]).all()),
          f"syncbn eval: probe err {err}, {moved} of {len(stats)} statistics"
          f" moved")
    print(json.dumps({"phase": "syncbn_eval_after_train", "ok": True,
                      "norms": len(norms), "statistics_moved": moved,
                      "probe_rel_err": err,
                      "valid_detections": int(det["valid"].sum())}))
    del trained
    torch.cuda.empty_cache()


def phase_syncbn_train_net(dev):
    """Phase 58: ``paa_tpu_torch.tools.train_net`` with MODEL.USE_SYNCBN
    True on PAA-R50 at full width in bf16 over synth_coco_32 (seeded
    weights, MODEL.WEIGHT empty), IMS_PER_BATCH 8, 3 iterations: finite
    losses, K3 40 per step; its model_final holds every SyncBatchNorm's
    running statistics, moved from their init. Then
    ``paa_tpu_torch.tools.test_net --ckpt model_final``: the statistics
    its model holds after the load equal the checkpoint's (test_net's
    ``load_weights`` watched), exit 0, the 12 metrics, K1 once and K3 40
    times per eval batch."""
    from paa_tpu_torch.tools import test_net, train_net
    from paa_tpu_torch.utils import checkpoint

    tmp = tempfile.mkdtemp(prefix="paa_syncbn_train_net_")
    os.environ["PAA_TPU_TORCH_SYNTH_DIR"] = os.path.join(tmp, "synth")
    out_dir = os.path.join(tmp, "out")
    opts = [*synth_opts(out_dir), "MODEL.USE_SYNCBN", "True",
            "MODEL.WEIGHT", "", "SOLVER.IMS_PER_BATCH", "8",
            "SOLVER.MAX_ITER", "3", "SOLVER.CHECKPOINT_PERIOD", "3"]
    head = ["--config-file", PAA_CONFIG, "--device", str(dev)]
    seen = {}
    zero_launch_counts()
    rc = train_net.main(head + ["--skip-test"] + opts,
                        metric_hook=lambda i, m: seen.update({i: m}))
    train_launches = launch_counts()
    check(rc == 0 and sorted(seen) == [1, 2, 3] and all(
        math.isfinite(v) for m in seen.values() for v in m.values())
        and train_launches == {"nms_batched": 0, "nms_global": 0,
                               "group_norm_relu": 3 * 40,
                               "deform_im2col": 0, "deform_col2im": 0},
        f"syncbn_train_net: rc {rc}, iterations {sorted(seen)}, "
        f"launches {train_launches}")
    final = os.path.join(out_dir, "model_final")
    ckpt = torch.load(final, map_location="cpu", weights_only=True)["model"]
    stats = {k: v for k, v in ckpt.items() if "running" in k}
    moved = sum(not torch.equal(v, torch.zeros_like(v) if "mean" in k
                                else torch.ones_like(v))
                for k, v in stats.items())
    check(len(stats) == 2 * 53 and moved == len(stats),
          f"syncbn_train_net: {len(stats)} statistics, {moved} moved")
    plain, loaded = checkpoint.load_weights, {}

    def watched(module, path):
        extra = plain(module, path)
        loaded.update({k: v.detach().cpu().clone()
                       for k, v in module.state_dict().items()
                       if "running" in k})
        return extra

    checkpoint.load_weights = watched
    try:
        zero_launch_counts()
        rc = test_net.main(head + ["--ckpt", final] + opts)
        launches = launch_counts()
    finally:
        checkpoint.load_weights = plain
    results = read_results(out_dir, SYNTH_32[0])
    batches = launches["nms_batched"]
    check(rc == 0 and sorted(loaded) == sorted(stats) and all(
        torch.equal(loaded[k], v) for k, v in stats.items())
        and sorted(results) == sorted(METRICS) and batches >= 4
        and launches == {"nms_batched": batches, "nms_global": 0,
                         "group_norm_relu": 40 * batches,
                         "deform_im2col": 0, "deform_col2im": 0},
        f"syncbn_test_net: rc {rc}, {len(loaded)} statistics loaded, "
        f"launches {launches}, results {results}")
    print(json.dumps({"phase": "syncbn_train_net", "ok": True,
                      "losses": [seen[i]["loss"] for i in sorted(seen)],
                      "statistics": len(stats),
                      "train_launches": train_launches,
                      "test_net_launches": launches, "ap_table": results}))
    shutil.rmtree(tmp, ignore_errors=True)


def phase_mobile_and_syncbn(dev):
    """Phases 52-58 (after phase 51): FCOS-MNV2 (52: serving, the f32 model
    on the card against the CPU, training at B=16, ``phase_dense``);
    FBNet Mask R-CNN _600 (53: serving; 54: the f32 model and masks on
    the card against the CPU, and the f32 train step against the CPU and
    float64 with the proposals and ReLU decisions pinned, the planted
    x1.05 beyond; 55: training at B=16, ``test_net`` over synth_coco_32
    with cv2 blocked); FBNet cham_v1a and xirb16d_dsmask serving (56);
    PAA-R50 with MODEL.USE_SYNCBN training and eval (57) and train_net /
    test_net (58)."""
    phase_dense(dev, "fcos_mnv2", MNV2_CONFIG, train_reference=False)
    frozen_bn = {kind: calibrated_frozen_bn(path)
                 for kind, path in FBNET_CONFIGS.items()}
    for kind in FBNET_CONFIGS:
        phase_fbnet_serving(dev, kind, frozen_bn[kind])
        if kind == "fbnet_mask_rcnn":
            mask_rcnn_card_vs_cpu(
                dev, lambda dtype, device: seeded_fbnet(
                    kind, frozen_bn[kind], dtype, device), kind)
    kind = "fbnet_mask_rcnn"
    hw, size = FBNET_HW[kind]
    # one card's share of the config's 128 images over 8 GPUs, at the
    # linearly scaled learning rate (at the config's 0.06 the seeded
    # model's losses swing and its RPN's boxes reach NaN by step 20)
    cfg = build_cfg("bfloat16", FBNET_CONFIGS[kind])
    phase_two_stage_train(
        dev, kind, frozen_bn[kind], hw=hw, size=size,
        extra=["SOLVER.IMS_PER_BATCH", 16, "SOLVER.BASE_LR",
               cfg.SOLVER.BASE_LR * 16 / cfg.SOLVER.IMS_PER_BATCH])
    phase_two_stage_train_reference(dev, frozen_bn[kind],
                                    FBNET_CONFIGS[kind], REFERENCE_ROIS,
                                    f"{kind}_train_card_vs_cpu")
    phase_mask_rcnn_test_net(dev, FBNET_CONFIGS[kind], f"{kind}_test_net",
                             reference=False)
    phase_syncbn_train(dev)
    phase_syncbn_train_net(dev)
    torch.cuda.empty_cache()


# ---- phases 59-63: Pascal VOC, the serving artifact, the poolers ------------

VOC_CONFIG = os.path.join(ROOT, "configs", "pascal_voc",
                          "e2e_faster_rcnn_R_50_C4_1x_1_gpu_voc.yaml")
VOC_IMAGES = 16  # the synthetic catalog's voc_2007_* tree
VOC_TRAIN_STEPS = 4
# tests/test_torch_port_c4.py's narrow C4 body (res5 and the RPN's conv
# stay at their fixed widths), for the card-vs-CPU eval path
VOC_NARROW = ["MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
              "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
              "MODEL.RESNETS.STEM_OUT_CHANNELS", 16]
VOC_REF = VOC_NARROW + ["INPUT.MIN_SIZE_TEST", 256, "INPUT.MAX_SIZE_TEST",
                        320, "TPU.TEST_BUCKETS", ((256, 320), (320, 256)),
                        "TEST.IMS_PER_BATCH", 2]


def seeded_voc(frozen_bn, dtype, device, extra=()):
    """The VOC C4 Faster R-CNN (VOC_CONFIG: 21 classes, its RPN's 6,000
    / 300 test proposals and 128-512 anchors) from seed 0 with
    ``frozen_bn`` (calibrated) and the 20 foreground cls_score biases
    from seed 1 in [25, 35], as ``seeded_frcnn``; ``extra`` overrides
    the config (the synthetic catalog)."""
    model = seeded_train_model(
        build_cfg(dtype, VOC_CONFIG, ["PATHS_CATALOG", SYNTH_CATALOG,
                                      *extra]), device, frozen_bn)
    gen = torch.Generator().manual_seed(1)
    bias = model.module.box_head.cls_score.bias
    with torch.no_grad():
        bias[1:].copy_(torch.empty(bias.numel() - 1).uniform_(
            25.0, 35.0, generator=gen))
    return model


def voc_predictions(model, dataset):
    """``compute_on_dataset`` over ``dataset`` with the model's config,
    the boxes back to xyxy (the VOC evaluation's glue): (predictions,
    images)."""
    from paa_tpu_torch.data.loader import make_data_loader
    from paa_tpu_torch.engine.inference import compute_on_dataset
    from paa_tpu_torch.evaluation import voc_eval

    preds, _, n_images, _ = compute_on_dataset(
        model, make_data_loader(model.cfg, dataset, is_train=False))
    return voc_eval.predictions_from_xywh(preds), n_images


def phase_voc_eval(dev, frozen_bn):
    """Phase 59: the VOC eval path at full width: the synthetic catalog's
    voc_2007_test (16 PPM images of VOC's sizes under .jpg names,
    difficult objects kept) through ``build_dataset``, the loader
    (800 x 1333 in (800, 1344) / (1344, 800), the config's
    TEST.IMS_PER_BATCH 1), ``compute_on_dataset`` in bf16 and
    ``do_voc_evaluation``: a finite mAP and the 20-class table (random
    weights: not an accuracy), K1 twice an image (the RPN's 1 x 6,000
    with 300 picks, the box head's 20 x 300 = 6,000 with 100 picks) and
    no other kernel, K1 bit-equal to its plain version at both inputs."""
    import logging

    from paa_tpu_torch.data.build import build_dataset
    from paa_tpu_torch.data.voc import PascalVOCDataset
    from paa_tpu_torch.evaluation import voc_eval

    model = seeded_voc(frozen_bn, "bfloat16", dev)
    cfg = model.cfg
    dataset = build_dataset(cfg, cfg.DATASETS.TEST, is_train=False)
    check(isinstance(dataset, PascalVOCDataset) and len(dataset) ==
          VOC_IMAGES and dataset.keep_difficult,
          f"voc_eval: dataset {type(dataset).__name__} of {len(dataset)}")
    with recording_k1_inputs() as k1_inputs:
        zero_launch_counts()
        preds, n_images = voc_predictions(model, dataset)
        launches = launch_counts()
        result = voc_eval.do_voc_evaluation(
            dataset, preds, logger=logging.getLogger("chip_smoke.voc"))
    batches = -(-VOC_IMAGES // cfg.TEST.IMS_PER_BATCH)
    expected = {"nms_batched": 2 * batches, "nms_global": 0,
                "group_norm_relu": 0, "deform_im2col": 0, "deform_col2im": 0}
    check(launches == expected and n_images == VOC_IMAGES,
          f"voc_eval: launches {launches}, expected {expected}; "
          f"{n_images} images")
    check(result["ap"].shape == (21,) and math.isfinite(result["map"])
          and all(len(p["labels"]) > 0 for p in preds.values()),
          f"voc_eval: {result}")
    rpn = cfg.MODEL.RPN
    _, counts = model.anchors_for(tuple(cfg.TPU.TEST_BUCKETS[0]))
    n = min(rpn.PRE_NMS_TOP_N_TEST, counts[0])
    picks = min(rpn.POST_NMS_TOP_N_TEST, n)
    want = {(1, n, picks), (1, picks * (cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES
                                        - 1),
                            cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG)}
    shapes = {(*a[1].shape, a[5]) for a in k1_inputs}
    check(shapes == want, f"voc_eval: K1 at {shapes}, expected {want}")
    for what, max_out in (("voc_c4_rpn", picks), ("voc_c4_box_head", 100)):
        k1_at_path_inputs(next(a for a in k1_inputs if a[5] == max_out),
                          what)
    # a class without a GT has no AP (NaN): null in the table
    table = {dataset.map_class_id_to_class_name(i):
             None if math.isnan(ap) else float(ap)
             for i, ap in enumerate(result["ap"]) if i}
    print(json.dumps({"phase": "voc_eval", "ok": True, "config":
                      os.path.relpath(VOC_CONFIG, ROOT),
                      "images": n_images, "batch": cfg.TEST.IMS_PER_BATCH,
                      "launches": launches, "mAP": result["map"],
                      "ap_by_class": table}))
    del model, k1_inputs
    torch.cuda.empty_cache()


def match_voc_predictions(card_preds, cpu_preds, what):
    """``match_detections`` on two packages' VOC predictions ({index:
    boxes xyxy, scores, labels}): each card detection has a CPU one of
    its label within 0.5 px, 95% must, and the counts agree within
    5%."""
    matched = total = n_cpu = 0
    for idx, g in card_preds.items():
        c = cpu_preds[idx]
        n_cpu += len(c["labels"])
        for box, label in zip(g["boxes"], g["labels"]):
            total += 1
            same = c["labels"] == label
            d = np.abs(c["boxes"][same] - box).max(axis=1) if same.any() \
                else np.zeros(0)
            matched += int(d.size > 0 and float(d.min()) <= 0.5)
    check(total > 0 and abs(total - n_cpu) <= 0.05 * n_cpu
          and matched >= 0.95 * total,
          f"{what}: {matched}/{total} card detections matched, "
          f"{n_cpu} on the CPU")
    return {"detections": total, "matched": matched,
            "cpu_detections": n_cpu}


def phase_voc_card_vs_cpu(dev):
    """Phase 60: the VOC eval path of the narrow C4 model (VOC_REF: the
    CPU tests' body, 256 x 320 buckets, B=2) in float32 (TF32 off) on the
    card and on the CPU from the same weights, over a 4-image synthetic
    VOC tree whose ground truth is the CPU's three best detections of
    each image on a first pass (``voc_ground_truth``; one image all
    difficult). Detections matched as ``match_detections``; each class's
    AP within 1e-3; the mAP above 0."""
    from paa_tpu_torch.data.synth import synth_voc, voc_ground_truth
    from paa_tpu_torch.data.voc import PascalVOCDataset
    from paa_tpu_torch.evaluation import voc_eval

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="paa_voc_ref_")
    root = synth_voc(os.path.join(tmp, "VOC2007"), 4, seed=5)
    frozen_bn = calibrated_frozen_bn(VOC_CONFIG, VOC_NARROW)
    models = {d: seeded_voc(frozen_bn, "float32", d, VOC_REF)
              for d in (dev, "cpu")}
    first, _ = voc_predictions(models["cpu"],
                                  PascalVOCDataset(root, "test", True))
    voc_ground_truth(PascalVOCDataset(root, "test", True), first)
    dataset = PascalVOCDataset(root, "test", True)
    preds, results = {}, {}
    for device in (dev, "cpu"):
        preds[device], _ = voc_predictions(models[device], dataset)
        results[device] = voc_eval.do_voc_evaluation(dataset,
                                                     preds[device])
    matched = match_voc_predictions(preds[dev], preds["cpu"],
                                    "voc_card_vs_cpu")
    ap_card, ap_cpu = results[dev]["ap"], results["cpu"]["ap"]
    check(np.array_equal(np.isnan(ap_card), np.isnan(ap_cpu))
          and np.nanmax(np.abs(ap_card - ap_cpu)) <= 1e-3
          and results["cpu"]["map"] > 0,
          f"voc_card_vs_cpu: AP {ap_card} vs {ap_cpu}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"phase": "voc_card_vs_cpu", "ok": True,
                      "images": len(dataset), "map_card":
                      results[dev]["map"], "map_cpu": results["cpu"]["map"],
                      "ap_abs_err": float(np.nanmax(np.abs(ap_card
                                                           - ap_cpu))),
                      **matched}))


def phase_voc_train(dev, frozen_bn):
    """Phase 61: VOC_TRAIN_STEPS do_train steps of the full-width bf16
    VOC C4 model (seed 0, calibrated FrozenBN) from the loader over its
    DATASETS.TRAIN, the synthetic
    voc_2007_train + voc_2007_val as one ConcatDataset (difficult
    objects dropped: one image has no GT), at the config's
    IMS_PER_BATCH 1 and BASE_LR 0.001: finite losses, K2 once a step
    (the training RPN's 1 x 12,000, PRE_NMS_TOP_N_TRAIN, above K1's
    8,192) and no other kernel, K2 bit-equal to its plain version at the
    first step's rows."""
    from paa_tpu_torch.data.build import build_dataset
    from paa_tpu_torch.data.concat import ConcatDataset
    from paa_tpu_torch.data.loader import make_data_loader
    from paa_tpu_torch.engine import do_train
    from paa_tpu_torch.ops import nms

    # the serving phases' foreground bias lift is left out: it puts the
    # classifier's loss at ~15 and sends the box loss to NaN within 4
    # steps
    cfg = build_cfg("bfloat16", VOC_CONFIG, [
        "PATHS_CATALOG", SYNTH_CATALOG, "SOLVER.MAX_ITER", VOC_TRAIN_STEPS])
    model = seeded_train_model(cfg, dev, frozen_bn)
    dataset = build_dataset(cfg, cfg.DATASETS.TRAIN, is_train=True)
    check(isinstance(dataset, ConcatDataset) and len(dataset) ==
          VOC_IMAGES and any(len(r.labels) == 0 for r in dataset.records),
          f"voc_train: {type(dataset).__name__} of {len(dataset)}")
    # the RPN's rows take K2 above K1's capacity, as phase 42's
    per_row = min(cfg.MODEL.RPN.PRE_NMS_TOP_N_TRAIN,
                  max(max(model.anchors_for(tuple(hw))[1])
                      for hw in cfg.TPU.TRAIN_BUCKETS))
    kernel = ("nms_global" if per_row > nms.k1_max_candidates(dev)
              else "nms_batched")
    state = train_state(model)
    seen = {}
    with recording_k1_inputs() as k1_inputs, \
            recording_k2_inputs() as k2_inputs:
        zero_launch_counts()
        do_train(cfg, model, state, make_data_loader(cfg, dataset, True),
                 metric_hook=lambda i, m: seen.update({i: m}))
        launches = launch_counts()
    expected = {"nms_batched": 0, "nms_global": 0, "group_norm_relu": 0,
                "deform_im2col": 0, "deform_col2im": 0,
                kernel: VOC_TRAIN_STEPS}
    check(launches == expected,
          f"voc_train: launches {launches}, expected {expected}")
    check(sorted(seen) == list(range(1, VOC_TRAIN_STEPS + 1))
          and all(math.isfinite(v) for m in seen.values()
                  for v in m.values()), f"voc_train: {seen}")
    print(json.dumps({"phase": "voc_train", "ok": True, "steps":
                      VOC_TRAIN_STEPS, "batch": cfg.SOLVER.IMS_PER_BATCH,
                      "rpn_rows": [1, per_row], "rpn_nms": kernel,
                      "launches": launches, "losses": [
                          seen[i]["loss"] for i in sorted(seen)]}))
    del model, state
    torch.cuda.empty_cache()
    # the RPN's NMS at the first step's rows, against its plain version
    if kernel == "nms_global":
        k2_at_path_inputs(k2_inputs[0], "voc_c4_train_rpn")
    else:
        k1_at_path_inputs(k1_inputs[0], "voc_c4_train_rpn")


# serves an artifact in a process of its own, with torch and
# paa_tpu_torch.serving alone: argv artifact, requests, outputs
ARTIFACT_SERVE = r"""
import json, sys
import torch
from paa_tpu_torch.serving import load_exported
from paa_tpu_torch.ops import deform_sampling, group_norm, nms
call, meta = load_exported(sys.argv[1])
reqs = torch.load(sys.argv[2])
call(*reqs[0])
torch.cuda.synchronize()
nms.nms_batched.launches = nms._nms_global.launches = 0
group_norm.group_norm_relu.launches = 0
deform_sampling.deform_im2col.launches = 0
deform_sampling.deform_col2im.launches = 0
dets = []
for images, sizes in reqs:
    dets.append({k: v.cpu() for k, v in call(images, sizes).items()})
launches = {"nms_batched": nms.nms_batched.launches,
            "nms_global": nms._nms_global.launches,
            "group_norm_relu": group_norm.group_norm_relu.launches,
            "deform_im2col": deform_sampling.deform_im2col.launches,
            "deform_col2im": deform_sampling.deform_col2im.launches}
torch.save(dets, sys.argv[3])
loaded = sorted(m for m in sys.modules if m.startswith("paa_tpu"))
print(json.dumps({"meta": meta, "launches": launches, "modules": loaded}))
"""


def phase_serving_artifact(dev):
    """Phase 62: PAA-R50 at full width (bf16, phase 5's seeded weights
    and cls bias) exported at B=8 x 800 x 1344 on the card
    (``serving.export_inference``) and saved; a process that imports
    torch and ``paa_tpu_torch.serving`` alone (no config, no model code)
    loads it and serves three requests (float32 normalized images, as
    the artifact takes them): K1 3 and K3 120 launches, every detection
    matched to the live eval fn's on the same requests
    (``match_detections``), whose launches are the same."""
    from paa_tpu_torch.ops.image_norm import device_normalize
    from paa_tpu_torch.serving import export_inference, save_exported

    model = seeded_model("bfloat16", dev)
    tmp = tempfile.mkdtemp(prefix="paa_serving_")
    exported, meta = export_inference(model, BATCH, HW)
    path = os.path.join(tmp, "paa_r50.paat")
    save_exported(path, exported, meta)
    del exported
    mean, std = model.cfg.INPUT.PIXEL_MEAN, model.cfg.INPUT.PIXEL_STD
    reqs = []
    for i in range(3):
        images, sizes = request(90 + i, BATCH, HW, SIZE)
        images, sizes = images.to(dev), sizes.to(dev)
        reqs.append((device_normalize(images, sizes, mean, std), sizes))
    torch.save(reqs, os.path.join(tmp, "requests.pt"))
    eval_fn = model.make_eval_fn()
    zero_launch_counts()
    live = [{k: v.cpu() for k, v in eval_fn(*r).items()} for r in reqs]
    live_launches = launch_counts()
    expected = {"nms_batched": 3, "nms_global": 0, "group_norm_relu": 120,
                "deform_im2col": 0, "deform_col2im": 0}
    check(live_launches == expected,
          f"serving_live: launches {live_launches}, expected {expected}")
    del model, eval_fn
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, "-c", ARTIFACT_SERVE, path,
         os.path.join(tmp, "requests.pt"), os.path.join(tmp, "served.pt")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"serving_artifact: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check(out["launches"] == expected,
          f"serving_artifact: launches {out['launches']}, expected "
          f"{expected}")
    check(not [m for m in out["modules"] if m.startswith((
        "paa_tpu_torch.modeling", "paa_tpu_torch.config",
        "paa_tpu_torch.data"))] and "paa_tpu" not in out["modules"],
        f"serving_artifact: the serving process loaded {out['modules']}")
    served = torch.load(os.path.join(tmp, "served.pt"))
    n_valid = check_detections(served, "serving_artifact", 0.05)
    matched = [match_detections(s, l, "serving_artifact")
               for s, l in zip(served, live)]
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({
        "phase": "serving_artifact", "ok": True, "batch": BATCH, "hw": HW,
        "dtype": "bfloat16", "meta": out["meta"],
        "launches": out["launches"], "live_launches": live_launches,
        "valid_detections": n_valid, "matched": matched}))


def phase_poolers_card_vs_cpu(dev):
    """Phase 63: ``roi_pool`` (128 rois over two 256 x 50 x 84 maps,
    7 x 7 at 1/16, equal: a max) and ``deform_psroi_pool`` (R-FCN's
    layout: 7 x 7 groups of 8 channels over 392 x 50 x 84, 100 rois, 2
    classes' offsets, 4 x 4 samples a bin; the pooled values within 1e-5
    of their largest, the gradients of the features and the offsets
    within 1e-4 of theirs: the card's index adds run in another order)
    on the card against the CPU."""
    from paa_tpu_torch.ops.deform_pool import deform_psroi_pool
    from paa_tpu_torch.ops.roi_align import roi_pool

    gen = torch.Generator().manual_seed(63)
    xy = torch.rand(128, 2, generator=gen) * 1100
    rois = torch.cat([xy, xy + 16 + torch.rand(128, 2, generator=gen) * 400],
                     1)
    bidx = torch.randint(0, 2, (128,), generator=gen)
    feat = torch.randn(2, 256, 50, 84, generator=gen)
    got = roi_pool(feat.to(dev), rois.to(dev), bidx.to(dev), (7, 7), 1 / 16)
    want = roi_pool(feat, rois, bidx, (7, 7), 1 / 16)
    check(torch.equal(got.cpu(), want), "roi_pool: card vs CPU")
    kw = dict(spatial_scale=1 / 16, out_size=7, out_channels=8,
              group_size=7, part_size=7, sample_per_part=4, trans_std=0.1)
    feat = torch.randn(2, 8 * 49, 50, 84, generator=gen)
    trans = torch.randn(100, 4, 7, 7, generator=gen)
    up = torch.randn(100, 8, 7, 7, generator=gen)
    out, grads = [], []
    for device in (dev, "cpu"):
        f = feat.to(device).requires_grad_()
        t = trans.to(device).requires_grad_()
        y = deform_psroi_pool(f, rois[:100].to(device),
                              bidx[:100].to(device), t, **kw)
        y.backward(up.to(device))
        out.append(y.detach().cpu())
        grads.append((f.grad.cpu(), t.grad.cpu()))
    errs = {"pooled": float((out[0] - out[1]).abs().max()
                            / out[1].abs().max())}
    for key, g, w in zip(("d_features", "d_offsets"), *grads):
        errs[key] = float((g - w).abs().max() / w.abs().max())
    check(errs["pooled"] <= 1e-5 and errs["d_features"] <= 1e-4
          and errs["d_offsets"] <= 1e-4, f"deform_psroi_pool: {errs}")
    print(json.dumps({"phase": "poolers_card_vs_cpu", "ok": True,
                      "rel_err": errs}))


def phase_voc_serving_poolers(dev):
    """Phases 59-63 (after phase 19): the VOC eval path, its card-vs-CPU
    check and training; the serving artifact; the poolers."""
    frozen_bn = calibrated_frozen_bn(VOC_CONFIG)
    phase_voc_eval(dev, frozen_bn)
    phase_voc_card_vs_cpu(dev)
    phase_voc_train(dev, frozen_bn)
    phase_serving_artifact(dev)
    phase_poolers_card_vs_cpu(dev)


# the overfit gate's iterations in phase 64: the whole gate (1,500) took
# 166 s of training on the card, beyond the script's room, so the phase
# runs its first 150 (at 150 the port's CPU run's last 20 iterations
# average 0.37x the first loss, against the 0.6x checked)
GATE_ITERS = 150
# the gate's K3 launches: 2 towers x 2 GroupNorm+ReLU x 5 levels a forward
GATE_K3_PER_FORWARD = 20
DEMO_IMAGE_HW = (480, 640)
# two detections of one label are the same within this many pixels
DEMO_BOX_TOL, DEMO_SCORE_TOL = 0.5, 1e-3


def phase_overfit_gate(dev):
    """Phase 64: the overfit gate (paa_tpu_torch/tools/quick_overfit.py,
    ``run``) on the card: PAA-R50 at 128 FPN channels, 2 tower convs and
    3 classes in float32 trained GATE_ITERS iterations at B=4 on the 8
    synthetic PPM images through the loader and ``do_train``, then
    ``inference`` over them: a first loss above 1.5 (untrained) and the
    last 20 iterations' mean below 0.6x the first (tests/test_overfit.py's
    whole gate at 1,500 iterations is ``python -m
    paa_tpu_torch.tools.quick_overfit --assert``). K3 20
    launches a forward (GATE_K3_PER_FORWARD) in training and evaluation,
    K1 once an eval batch (2), K2 none; K1 bit-equal to its plain version
    at the eval's first batch."""
    from paa_tpu_torch.tools import quick_overfit

    with tempfile.TemporaryDirectory() as tmp, \
            recording_k1_inputs() as k1_inputs:
        zero_launch_counts()
        r = quick_overfit.run(GATE_ITERS, tmp, device=dev)
        launches = launch_counts()
    eval_batches = 2  # 4 images in each of the two buckets
    expected = {"nms_batched": eval_batches, "nms_global": 0,
                "group_norm_relu": GATE_K3_PER_FORWARD * (
                    GATE_ITERS + eval_batches), "deform_im2col": 0,
                "deform_col2im": 0}
    check(launches == expected,
          f"overfit_gate: launches {launches}, expected {expected}")
    gate = {"first_loss > 1.5": r["first_loss"] > 1.5,
            "final_loss < 0.6 first_loss":
                r["final_loss"] < 0.6 * r["first_loss"]}
    check(all(gate.values()), f"overfit_gate: {gate}: {r}")
    print(json.dumps({"phase": "overfit_gate", "ok": True,
                      "iterations": GATE_ITERS, "gate": list(gate),
                      **{k: r[k] for k in ("first_loss", "final_loss", "ap",
                                           "ap50")},
                      "launches": launches}))
    k1_at_path_inputs(k1_inputs[0], "overfit_gate_eval")


def match_all_detections(got, want, what):
    """Each detection of ``got`` (boxes, scores, labels) has one of
    ``want`` of its label within DEMO_BOX_TOL px and DEMO_SCORE_TOL in
    score, and each of ``want`` one of ``got``'s; only detections within
    1e-4 of the lower of the two sides' last kept scores are exempt (a
    tie there may swap which one is kept)."""
    check(len(got[2]) and len(want[2]),
          f"{what}: {len(got[2])} vs {len(want[2])} detections")
    cut = max(float(got[1].min()), float(want[1].min())) + 1e-4
    unmatched = []
    for a, b in ((got, want), (want, got)):
        for box, score, label in zip(*a):
            if score < cut:
                continue
            same = b[2] == label
            d = np.abs(b[0][same] - box).max(axis=1)
            ok = d.size and d.min() <= DEMO_BOX_TOL and abs(
                b[1][same][d.argmin()] - score) <= DEMO_SCORE_TOL
            if not ok:
                unmatched.append((box.tolist(), float(score), int(label)))
    check(not unmatched, f"{what}: {len(got[2])} vs {len(want[2])} detections, "
          f"unmatched {unmatched[:5]}")
    return {"detections": len(got[2]), "other_side": len(want[2]),
            "exempt_below_score": cut}


def phase_demo(dev):
    """Phase 65: the demo (paa_tpu_torch/demo/predictor.py, ``COCODemo``)
    of the flagship config at full width in float32 (TF32 off, as the
    phases after phase 4 run), weights from seed 0 and the cls bias of
    phase 5 (``lift_cls_bias``), on one seeded 480 x 640 BGR image
    (resized to 800 x 1067 and padded to 800 x 1088, a shape no bucket
    has), at confidence threshold 0: the card's detections against the
    same demo on the CPU, every one matched (``match_all_detections``);
    K1 once and K3 40 times a call; K1 bit-equal to its plain version at
    its input."""
    from paa_tpu_torch.demo.predictor import COCODemo
    from paa_tpu_torch.tools.bench_common import lift_cls_bias

    image = np.random.RandomState(65).randint(
        0, 256, (*DEMO_IMAGE_HW, 3)).astype(np.uint8)
    cfg = build_cfg("float32", PAA_CONFIG)
    out = {}
    for side, device in (("card", dev), ("cpu", "cpu")):
        demo = COCODemo(cfg, confidence_threshold=0.0, device=device)
        lift_cls_bias(demo.model)
        if side == "cpu":
            out["cpu"] = demo.compute_prediction(image)
            continue
        with recording_k1_inputs() as k1_inputs:
            zero_launch_counts()
            out["card"] = demo.compute_prediction(image)
            launches = launch_counts()
        del demo
        torch.cuda.empty_cache()
    expected = {"nms_batched": 1, "nms_global": 0,
                "group_norm_relu": GN_PER_LEVEL * len(TOWER_HW),
                "deform_im2col": 0, "deform_col2im": 0}
    check(launches == expected,
          f"demo: launches {launches}, expected {expected}")
    matched = match_all_detections(out["card"], out["cpu"], "demo")
    print(json.dumps({"phase": "demo", "ok": True,
                      "image_hw": DEMO_IMAGE_HW, "dtype": "float32",
                      "launches": launches, **matched}))
    k1_at_path_inputs(k1_inputs[0], "demo")


def check_profile_train_step_cli(run):
    """Phase 66: ``python -m paa_tpu_torch.tools.profile_train_step
    --batch 2 --steps 1`` (PAA-R50, bf16, 800 x 1344) in a process of its
    own, ``run`` its (exit code, stdout, stderr): exit 0, its span table
    printed, and in its JSON line the input, the body (whose span the
    forward's holds), the backward and the optimizer with device time in
    each, the spans' host ms outside their nested spans at most the
    wall, K3's launches (40 a forward; no K1 or K2 in a PAA step)."""
    rc, stdout, stderr = run
    check(rc == 0, f"profile_train_step: exit {rc}: {stdout[-2000:]} "
                   f"{stderr[-2000:]}")
    r = json.loads(stdout.strip().splitlines()[-1])
    spans = r["by_span"]
    four = ("input", "body", "backward", "optimizer")
    check("== spans" in stdout and all(
        spans.get(s, {}).get("device_busy_ms", 0) > 0 for s in four)
        and sum(v["host_self_ms"] for v in spans.values() if
                "host_self_ms" in v) <= r["wall_ms_per_step"],
        f"profile_train_step: spans {spans}")
    launches = r["launches"]
    check(launches["group_norm_relu"] > 0 and launches["nms_batched"] ==
          launches["nms_global"] == 0,
          f"profile_train_step: launches {launches}")
    print(json.dumps({"phase": "profile_train_step_cli", "ok": True,
                      "device": r["device"], "spans": sorted(spans),
                      "launches": launches}))


# phase 66: the train-step profiler's CLI
PROFILE_CLI = ["profile_train_step", "--config-file", PAA_CONFIG,
               "--batch", "2", "--steps", "1"]
# phase 67: the benchmark tools at reduced depth, each in a process of
# its own (name: argv after ``-m paa_tpu_torch.tools.``), and the
# kernels' launches each must report: bench 2 warm-up and 3 timed calls,
# bench_dcnv2 --train a first and a timed step, bench_tta 2 passes of 6
# augmentations; K3 40 times a forward
BENCH_TOOLS = {
    "bench": ["bench", "--batch", "8", "--iters", "3", "--cls-bias-lift"],
    "bench_dcnv2_train": ["bench_dcnv2", "--batch", "2", "--iters", "1",
                          "--train"],
    "bench_tta": ["bench_tta", "--batch", "2", "--batches", "1"],
    # 4 a batch: of 16 images one training bucket gets 14 (bench_loader
    # exits with an error when no bucket gets a whole batch)
    "bench_loader": ["bench_loader", "--images", "16", "--threads", "1,4",
                     "--batches", "2", "--batch-size", "4"],
}
BENCH_FORWARDS = {"bench": 5, "bench_dcnv2_train": 2, "bench_tta": 12}
BENCH_NMS = {"bench": 5, "bench_dcnv2_train": 0, "bench_tta": 12}
# phase 67 in this process, at B=2: bench's timed call (2 warm-up calls
# and 1 timed), bench_dcnv2's serving (2 and 2) and one bench_tta pass
# (6 augmentations); each forward launches K1 once, K3 40 times
BENCH_IN_PROCESS_FORWARDS = {"bench": 3, "bench_dcnv2": 4, "bench_tta": 6}
DCNV2_R101_CONFIG = os.path.join(ROOT, "configs", "paa",
                                 "paa_dcnv2_R_101_FPN_2x.yaml")


def run_together(cmds, deadline_s, meanwhile=None):
    """Runs each command of ``cmds`` ({name: argv}) in a process of its
    own, all started together from the repo's root, calls
    ``meanwhile()`` (if given) while they run, and waits for all.
    Returns ({name: (exit code, stdout, stderr)}, what ``meanwhile``
    returned); a process still running after ``deadline_s`` is killed,
    and every process is gone when this returns or raises."""
    with tempfile.TemporaryDirectory() as tmp:
        procs, t0 = {}, time.perf_counter()
        try:
            for what, argv in cmds.items():
                out = open(os.path.join(tmp, f"{what}.out"), "w+")
                err = open(os.path.join(tmp, f"{what}.err"), "w+")
                procs[what] = (subprocess.Popen(argv, cwd=ROOT, stdout=out,
                                                stderr=err), out, err)
            during = meanwhile() if meanwhile is not None else None
            done = {}
            for what, (proc, out, err) in procs.items():
                left = deadline_s - (time.perf_counter() - t0)
                try:
                    rc = proc.wait(timeout=max(left, 1))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    rc = proc.wait()
                out.seek(0)
                err.seek(0)
                done[what] = (rc, out.read(), err.read())
        finally:
            for proc, out, err in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
                err.close()
    return done, during


def check_tool_launches(what, got, forwards, nms_calls):
    """K1 ``nms_calls`` times; K3 40 times a forward; K4 only on
    bench_dcnv2's R-101 dcnv2 path, ``dcn_per_forward`` times a forward
    and as often again in a training step's backward, beside K5."""
    dcn = dcn_per_forward_of(DCNV2_R101_CONFIG) if "dcnv2" in what else 0
    backwards = forwards if "train" in what else 0
    expected = {"nms_batched": nms_calls, "nms_global": 0,
                "group_norm_relu": GN_PER_LEVEL * len(TOWER_HW) * forwards,
                "deform_im2col": dcn * (forwards + backwards),
                "deform_col2im": dcn * backwards}
    got = kernel_launches(got)
    check(got == expected, f"{what}: launches {got}, expected {expected}")


def bench_tools_in_process(dev):
    """Phase 67's paths in this process, so that K1 and K3 are held to
    their plain versions at the inputs these paths give them: bench's
    timed call (``bench.serve``: PAA-R50 with the lift, B=2, 1 timed
    call), bench_dcnv2's serving (``bench_dcnv2.run``: R-101 dcnv2, B=2,
    2 timed calls) and one bench_tta pass (``bench_tta.build_engine``:
    its 2 raw images through 6 augmentations, 3 padded shapes). Each
    launch count as its calls need (BENCH_IN_PROCESS_FORWARDS), bench's
    NMS candidates > 0, a detection for each TTA image, the clocks read
    at both ends of each timed window; then K1 bit-equal to its plain
    version at every input these runs gave it (``recording_k1_inputs``).
    K3's shapes, among them the B=2 towers at 800 x 1344 and the TTA's
    buckets (all checked to be among them), are held by
    ``phase_k3_at_path_shapes`` with the others'. Returns the K3 shapes
    launched."""
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.ops import nms
    from paa_tpu_torch.tools import bench, bench_dcnv2, bench_tta
    from paa_tpu_torch.tools.bench_common import lift_cls_bias

    runs = {}
    with recording_k1_inputs() as k1_inputs, \
            recording_k3_launches() as k3_seen:
        model = lift_cls_bias(build_detection_model(
            bench.bench_cfg(), device=dev, seed=0))
        runs["bench"] = bench.serve(model, bench.HW, 2, 1, dev)
        del model
        runs["bench_dcnv2"] = bench_dcnv2.run(
            bench_dcnv2.load_cfg(DCNV2_R101_CONFIG), bench.HW, 2, 2, dev)
        engine = bench_tta.build_engine(dev)
        before = launch_counts()
        results = engine.detect_batch(bench_tta.raw_images(2))
        runs["bench_tta"] = {
            "launches": {k: v - before[k] for k, v in launch_counts().items()},
            "detections": [len(r[0]) for r in results],
            "input_shapes": sorted(engine.model._anchors)}
        feature_shapes = engine.model.feature_shapes
        del engine
    torch.cuda.empty_cache()
    for path, r in runs.items():
        n = BENCH_IN_PROCESS_FORWARDS[path]
        check_tool_launches(f"{path} in process", r["launches"], n, n)
        if "clocks" in r:
            check(all(isinstance(r["clocks"][end]["sm_mhz"], float)
                      for end in ("start", "end")),
                  f"{path} in process: clocks {r['clocks']}")
    check(runs["bench"]["work_per_image"]["nms_candidates"] > 0
          and runs["bench_dcnv2"]["value"] > 0,
          f"bench tools in process: {runs['bench']['work_per_image']}, "
          f"{runs['bench_dcnv2']['value']}")
    check(min(runs["bench_tta"]["detections"]) > 0
          and len(runs["bench_tta"]["input_shapes"]) == 3,
          f"bench_tta in process: {runs['bench_tta']}")
    for i, args in enumerate(k1_inputs):
        same_keeps(nms.nms_batched(*args), nms.nms_batched_plain(*args),
                   f"nms_batched at bench tools' input {i}")
    k3_shapes = {(shape, relu) for shape, _, relu in k3_seen}
    towers = {(2, 256, *fs) for hw in [bench.HW,
                                       *runs["bench_tta"]["input_shapes"]]
              for fs in feature_shapes(hw)}
    check(towers <= {shape for shape, _ in k3_shapes},
          f"bench tools in process: K3 not at every B=2 tower shape "
          f"{sorted(towers)}: {sorted(k3_shapes)}")
    print(json.dumps({
        "phase": "bench_tools_in_process", "ok": True,
        "k1_inputs_bit_equal": len(k1_inputs),
        "k1_valid_candidates": [int(args[3].sum()) for args in k1_inputs],
        "k3_shapes": sorted(k3_shapes),
        **{f"{path}_launches": r["launches"] for path, r in runs.items()},
        "tta_detections": runs["bench_tta"]["detections"],
        "tta_input_shapes": runs["bench_tta"]["input_shapes"]}))
    return k3_shapes


def phase_cli_tools(dev, name):
    """Phases 66 and 67: the train-step profiler's CLI (phase 66,
    ``check_profile_train_step_cli``) and the benchmark tools (``python
    -m paa_tpu_torch.tools.<tool>``): bench (B=8, 3 iterations, the
    cls-bias lift), bench_dcnv2 --train (R-101 dcnv2 at B=2, a first and
    one timed step), bench_tta (2 images, 1 pass after the first) and
    bench_loader (16 JPEGs, 1 and 4 threads, 2 batches of 4), each in a
    process of its own, the five started together (``run_together``),
    and while they run ``bench_tools_in_process`` in this process (run
    one after another, the processes took 106-142 s of the script,
    mostly each one's start and first calls). Each tool: exit 0, its
    last line one JSON object with the JAX tool's keys, ``device.name``
    this card's (``name``: nvidia-smi's name and power limit), ``value``
    > 0; the model tools' clocks read at both ends of the timed window,
    their K1/K3 launches (BENCH_FORWARDS, BENCH_NMS; no K2), bench's NMS
    candidates per image > 0 (the lift), a finite train loss, TTA's 3
    padded input shapes for 6 augmentations and the X-152 bound 26 ->
    13. Returns the K3 shapes launched in this process."""
    card_name = name.split(",")[0].strip()
    keys = {"bench": ("metric", "value", "unit", "vs_baseline", "batch",
                      "first_call_s"),
            "bench_dcnv2": ("metric", "value", "unit", "batch",
                            "first_call_s"),
            "bench_tta": ("metric", "value", "unit", "augs"),
            "bench_loader": ("metric", "value", "unit", "stages_ms",
                             "per_img_ms", "img_per_s_per_core", "loader",
                             "host_cores")}
    with tempfile.TemporaryDirectory() as tmp:
        argvs = {path: argv + (["--root", tmp] if path == "bench_loader"
                               else [])
                 for path, argv in BENCH_TOOLS.items()}
        argvs["profile_train_step"] = PROFILE_CLI
        runs, k3_shapes = run_together(
            {path: [sys.executable, "-m", f"paa_tpu_torch.tools.{argv[0]}",
                    *argv[1:]] for path, argv in argvs.items()}, 600,
            meanwhile=lambda: bench_tools_in_process(dev))
    check_profile_train_step_cli(runs.pop("profile_train_step"))
    for path, argv in BENCH_TOOLS.items():
        rc, stdout, stderr = runs[path]
        check(rc == 0, f"{path}: exit {rc}: {stdout[-2000:]} "
                       f"{stderr[-2000:]}")
        r = json.loads(stdout.strip().splitlines()[-1])
        want = keys[argv[0]]
        check(all(k in r for k in want) and r["value"] > 0
              and r["device"]["name"] == card_name,
              f"{path}: keys {sorted(r)} (want {want}), value "
              f"{r.get('value')}, device {r.get('device')} on {card_name}")
        if path in BENCH_FORWARDS:
            check_tool_launches(path, r["launches"], BENCH_FORWARDS[path],
                                BENCH_NMS[path])
            check(all(isinstance(r["clocks"][end]["sm_mhz"], float)
                      for end in ("start", "end")),
                  f"{path}: clocks {r['clocks']}")
        if path == "bench":
            check(r["work_per_image"]["nms_candidates"] > 0,
                  f"bench: work {r['work_per_image']}")
        if path == "bench_dcnv2_train":
            check(math.isfinite(r["loss"]), f"{path}: loss {r['loss']}")
        if path == "bench_tta":
            check(r["input_shapes"] == 3 and r["augs"] == 6
                  and r["x152_bound"] == {"augs": 26, "input_shapes": 13},
                  f"bench_tta: {r}")
        print(json.dumps({"phase": f"bench_tools_{path}", "ok": True,
                          "argv": argv,
                          **{k: r[k] for k in ("metric", "unit", "launches")
                             if k in r}}))
    return k3_shapes


# the kernels of the ``kernels`` line: op name and CUDA source
KERNELS = (("nms_batched", "nms_batched.cu"), ("nms_global", "nms_global.cu"),
           ("group_norm_relu", "group_norm.cu"),
           ("deform_im2col", "deform_im2col.cu"),
           ("deform_col2im", "deform_col2im.cu"))


def kernels_line(errors, per):
    """The ``kernels`` JSON: each kernel's largest error against its plain
    version in the phases that compare them (``errors``; 0.0 where they
    must be bit-equal) and its launches a call or a step on each main
    path of ``per`` ({path: launch counts a call or step}, as the
    phases asserted them) that launches it."""
    return {"kernels": [
        {"name": k, "source": f"paa_tpu_torch/csrc/{src}",
         "max_err": errors[k],
         "launches": {path: n[k] for path, n in per.items() if n[k]}}
        for k, src in KERNELS]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paa_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    name = card()
    _build.build_all()
    print(json.dumps({"phase": "build", "torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    phase_nms(dev)
    phase_nms_global(dev)
    k3_err = phase_group_norm(dev)
    with recording_k3_launches() as k3_launches:
        with recording_k1_inputs() as paa_k1:
            paa = phase_main_path(dev)
        phase_reference(dev)
        with recording_k1_inputs() as frcnn_k1, \
                recording_k2_inputs() as frcnn_k2:
            frcnn = phase_frcnn_main_path(dev)
        phase_frcnn_reference(dev)
        phase_nms_at_main_path_inputs(paa_k1[0], frcnn_k1[0], frcnn_k2[0])
        del paa_k1, frcnn_k1, frcnn_k2
        phase_eval_main_path(dev)
        phase_eval_card_vs_cpu(dev)
        phase_gn_grad(dev)
        _, paa_train = phase_train_main_path(dev)
        phase_train_reference(dev)
        # ATSS, FCOS and RetinaNet through PAA-R50's serving, training and
        # card-vs-CPU phases
        for head in DENSE_CONFIGS:
            phase_dense(dev, head)
        with recording_k4_launches() as k4_launches:
            dcnv2 = phase_dcnv2_main_path(dev)
        phase_dcn_card_vs_cpu(dev)
        phase_dcnv2_card_vs_cpu(dev)
        k4_err = phase_k4_at_path_shapes(dev, k4_launches, 3)
        del k4_launches
        phase_dcn_backward_card(dev)
        dcnv2_train, k5_launches = phase_dcnv2_train_main_path(dev)
        k5_err = phase_k5_at_path_shapes(dev, k5_launches, DCN_TRAIN_STEPS)
        del k5_launches
        phase_dcnv2_train_card_vs_cpu(dev)
        phase_dcnv2_x152_tta(dev)
        phase_tta_card_vs_cpu(dev)
        phase_atss_tta(dev)
        phase_dense_test_net(dev)
        # Mask R-CNN serving, two-stage training, Mask R-CNN's test_net
        phase_two_stage(dev)
        # Keypoint R-CNN and the C4 models: serving, training, test_net
        phase_keypoint_and_c4(dev)
        # the GN baselines and the RPN-only models
        phase_gn_and_rpn_only(dev)
        # the mobile bodies (FCOS-MNV2, FBNet) and SyncBN
        phase_mobile_and_syncbn(dev)
        phase_train_net_from_pkl(dev, "dcnv2_train_net_from_pkl")
        phase_ap_gate(dev)
        phase_train_net_from_pkl(dev, "train_net_from_pkl")
        phase_ddp_two_ranks(dev)
        # Pascal VOC, the serving artifact, the poolers
        phase_voc_serving_poolers(dev)
        phase_overfit_gate(dev)
        phase_demo(dev)
        # the train-step profiler's CLI, the benchmark tools
        bench_k3_shapes = phase_cli_tools(dev, name)
    path_err = phase_k3_at_path_shapes(
        dev, {(shape, relu) for shape, _, relu in k3_launches},
        bench_k3_shapes)
    del k3_launches
    errors = {"nms_batched": 0.0, "nms_global": 0.0,
              "group_norm_relu": {k: max(v, path_err[k])
                                  for k, v in k3_err.items()},
              "deform_im2col": k4_err, "deform_col2im": k5_err}
    per = {"paa serving, a call": (paa, 3),
           "paa training, a step": (paa_train, TRAIN_STEPS),
           "faster_rcnn serving, a call": (frcnn, 3),
           "x152 serving, a call": (dcnv2, 3),
           "x152 training, a step": (dcnv2_train, DCN_TRAIN_STEPS)}
    print(name)
    print(json.dumps(kernels_line(errors, {
        path: {k: v // n for k, v in launches.items()}
        for path, (launches, n) in per.items()})))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(ddp_worker(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--dcnv2-step-readings"]:
        sys.exit(dcnv2_step_readings([int(a) for a in sys.argv[2:]]))
    sys.exit(main())
