"""Default configuration tree for paa_tpu_torch.

A copy of the JAX package's tree (paa_tpu/config/defaults.py), so that
the same YAML configs (configs/paa/*.yaml etc.) and dotted overrides
merge into either package. The ``TPU`` node is kept for that reason.
The PyTorch port reads ``TPU.COMPUTE_DTYPE`` from it and ignores the
lowering knobs ``NMS_IMPL``, ``FUSED_GN``, ``SPACE_TO_DEPTH`` and
``DCN_MODE``: they choose a TPU lowering, not a semantics.
"""

import os

from .cfg_node import CN

_C = CN()

# ---------------------------------------------------------------------------
# MODEL
# ---------------------------------------------------------------------------
_C.MODEL = CN()
_C.MODEL.RPN_ONLY = False
_C.MODEL.PAA_ON = False
_C.MODEL.ATSS_ON = False
_C.MODEL.FCOS_ON = False
_C.MODEL.RETINANET_ON = False
_C.MODEL.MASK_ON = False
_C.MODEL.KEYPOINT_ON = False
_C.MODEL.DEVICE = "tpu"
_C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
_C.MODEL.CLS_AGNOSTIC_BBOX_REG = False
_C.MODEL.WEIGHT = ""
_C.MODEL.USE_SYNCBN = False

# ---------------------------------------------------------------------------
# INPUT
# ---------------------------------------------------------------------------
_C.INPUT = CN()
_C.INPUT.MIN_SIZE_TRAIN = (800,)
_C.INPUT.MIN_SIZE_RANGE_TRAIN = (-1, -1)
_C.INPUT.MAX_SIZE_TRAIN = 1333
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.MAX_SIZE_TEST = 1333
# BGR means in the Caffe2 convention: image loaded as BGR in [0, 255]
_C.INPUT.PIXEL_MEAN = [102.9801, 115.9465, 122.7717]
_C.INPUT.PIXEL_STD = [1.0, 1.0, 1.0]
_C.INPUT.TO_BGR255 = True

# ---------------------------------------------------------------------------
# DATASETS / DATALOADER
# ---------------------------------------------------------------------------
_C.DATASETS = CN()
_C.DATASETS.TRAIN = ()
_C.DATASETS.TEST = ()

_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 4
_C.DATALOADER.SIZE_DIVISIBILITY = 0
_C.DATALOADER.ASPECT_RATIO_GROUPING = True

# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------
_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.CONV_BODY = "R-50-C4"
_C.MODEL.BACKBONE.FREEZE_CONV_BODY_AT = 2
_C.MODEL.BACKBONE.USE_GN = False

_C.MODEL.FPN = CN()
_C.MODEL.FPN.USE_GN = False
_C.MODEL.FPN.USE_RELU = False

_C.MODEL.GROUP_NORM = CN()
_C.MODEL.GROUP_NORM.DIM_PER_GP = -1
_C.MODEL.GROUP_NORM.NUM_GROUPS = 32
_C.MODEL.GROUP_NORM.EPSILON = 1e-5

_C.MODEL.RESNETS = CN()
_C.MODEL.RESNETS.NUM_GROUPS = 1
_C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
_C.MODEL.RESNETS.STRIDE_IN_1X1 = True
_C.MODEL.RESNETS.TRANS_FUNC = "BottleneckWithFixedBatchNorm"
_C.MODEL.RESNETS.STEM_FUNC = "StemWithFixedBatchNorm"
_C.MODEL.RESNETS.RES5_DILATION = 1
_C.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = 256 * 4
_C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
_C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
_C.MODEL.RESNETS.STAGE_WITH_DCN = (False, False, False, False)
_C.MODEL.RESNETS.WITH_MODULATED_DCN = False
_C.MODEL.RESNETS.DEFORMABLE_GROUPS = 1

# ---------------------------------------------------------------------------
# Classic RPN (reference defaults.py:128-169)
# ---------------------------------------------------------------------------
_C.MODEL.RPN = CN()
_C.MODEL.RPN.USE_FPN = False
_C.MODEL.RPN.ANCHOR_SIZES = (32, 64, 128, 256, 512)
_C.MODEL.RPN.ANCHOR_STRIDE = (16,)
_C.MODEL.RPN.ASPECT_RATIOS = (0.5, 1.0, 2.0)
_C.MODEL.RPN.STRADDLE_THRESH = 0
_C.MODEL.RPN.FG_IOU_THRESHOLD = 0.7
_C.MODEL.RPN.BG_IOU_THRESHOLD = 0.3
_C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
_C.MODEL.RPN.POSITIVE_FRACTION = 0.5
_C.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = 12000
_C.MODEL.RPN.PRE_NMS_TOP_N_TEST = 6000
_C.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 2000
_C.MODEL.RPN.POST_NMS_TOP_N_TEST = 1000
_C.MODEL.RPN.NMS_THRESH = 0.7
_C.MODEL.RPN.MIN_SIZE = 0
_C.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN = 2000
_C.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST = 2000
_C.MODEL.RPN.RPN_HEAD = "SingleConvRPNHead"

# ---------------------------------------------------------------------------
# ROI heads (two-stage; reference defaults.py:173-221)
# ---------------------------------------------------------------------------
_C.MODEL.ROI_HEADS = CN()
_C.MODEL.ROI_HEADS.USE_FPN = False
_C.MODEL.ROI_HEADS.FG_IOU_THRESHOLD = 0.5
_C.MODEL.ROI_HEADS.BG_IOU_THRESHOLD = 0.5
_C.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
_C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
_C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
_C.MODEL.ROI_HEADS.SCORE_THRESH = 0.05
_C.MODEL.ROI_HEADS.NMS = 0.5
_C.MODEL.ROI_HEADS.DETECTIONS_PER_IMG = 100

_C.MODEL.ROI_BOX_HEAD = CN()
_C.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR = "FPN2MLPFeatureExtractor"
_C.MODEL.ROI_BOX_HEAD.PREDICTOR = "FPNPredictor"
_C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
_C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 2
_C.MODEL.ROI_BOX_HEAD.POOLER_SCALES = (0.25, 0.125, 0.0625, 0.03125)
_C.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 81
_C.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 1024
_C.MODEL.ROI_BOX_HEAD.USE_GN = False
_C.MODEL.ROI_BOX_HEAD.DILATION = 1
_C.MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM = 256
_C.MODEL.ROI_BOX_HEAD.NUM_STACKED_CONVS = 4

_C.MODEL.ROI_MASK_HEAD = CN()
_C.MODEL.ROI_MASK_HEAD.FEATURE_EXTRACTOR = "ResNet50Conv5ROIFeatureExtractor"
_C.MODEL.ROI_MASK_HEAD.PREDICTOR = "MaskRCNNC4Predictor"
_C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_MASK_HEAD.POOLER_SCALES = (1.0 / 16,)
_C.MODEL.ROI_MASK_HEAD.MLP_HEAD_DIM = 1024
_C.MODEL.ROI_MASK_HEAD.CONV_LAYERS = (256, 256, 256, 256)
_C.MODEL.ROI_MASK_HEAD.RESOLUTION = 14
_C.MODEL.ROI_MASK_HEAD.SHARE_BOX_FEATURE_EXTRACTOR = True
_C.MODEL.ROI_MASK_HEAD.POSTPROCESS_MASKS = False
_C.MODEL.ROI_MASK_HEAD.POSTPROCESS_MASKS_THRESHOLD = 0.5
_C.MODEL.ROI_MASK_HEAD.DILATION = 1
_C.MODEL.ROI_MASK_HEAD.USE_GN = False

# Keypoint R-CNN head (reference defaults.py:242-252)
_C.MODEL.ROI_KEYPOINT_HEAD = CN()
_C.MODEL.ROI_KEYPOINT_HEAD.FEATURE_EXTRACTOR = "KeypointRCNNFeatureExtractor"
_C.MODEL.ROI_KEYPOINT_HEAD.PREDICTOR = "KeypointRCNNPredictor"
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SCALES = (1.0 / 16,)
_C.MODEL.ROI_KEYPOINT_HEAD.MLP_HEAD_DIM = 1024
_C.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = tuple(512 for _ in range(8))
_C.MODEL.ROI_KEYPOINT_HEAD.RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES = 17
_C.MODEL.ROI_KEYPOINT_HEAD.SHARE_BOX_FEATURE_EXTRACTOR = True

# FBNet backbone family (reference defaults.py:472-503)
_C.MODEL.FBNET = CN()
_C.MODEL.FBNET.ARCH = "default"
_C.MODEL.FBNET.ARCH_DEF = ""
_C.MODEL.FBNET.BN_TYPE = "bn"
_C.MODEL.FBNET.SCALE_FACTOR = 1.0
_C.MODEL.FBNET.WIDTH_DIVISOR = 1
_C.MODEL.FBNET.DW_CONV_SKIP_BN = True
_C.MODEL.FBNET.DW_CONV_SKIP_RELU = True
_C.MODEL.FBNET.DET_HEAD_LAST_SCALE = 1.0
_C.MODEL.FBNET.DET_HEAD_BLOCKS = ()
_C.MODEL.FBNET.DET_HEAD_STRIDE = 0
_C.MODEL.FBNET.KPTS_HEAD_LAST_SCALE = 0.0
_C.MODEL.FBNET.KPTS_HEAD_BLOCKS = ()
_C.MODEL.FBNET.KPTS_HEAD_STRIDE = 0
_C.MODEL.FBNET.MASK_HEAD_LAST_SCALE = 0.0
_C.MODEL.FBNET.MASK_HEAD_BLOCKS = ()
_C.MODEL.FBNET.MASK_HEAD_STRIDE = 0
_C.MODEL.FBNET.RPN_HEAD_BLOCKS = 0
_C.MODEL.FBNET.RPN_BN_TYPE = ""

# ---------------------------------------------------------------------------
# PAA head (reference paa_core/config/defaults.py:292-331)
# ---------------------------------------------------------------------------
_C.MODEL.PAA = CN()
_C.MODEL.PAA.NUM_CLASSES = 81  # number of classes INCLUDING background
_C.MODEL.PAA.ANCHOR_SIZES = (64, 128, 256, 512, 1024)
_C.MODEL.PAA.ASPECT_RATIOS = (1.0,)
_C.MODEL.PAA.ANCHOR_STRIDES = (8, 16, 32, 64, 128)
_C.MODEL.PAA.STRADDLE_THRESH = 0
_C.MODEL.PAA.OCTAVE = 2.0
_C.MODEL.PAA.SCALES_PER_OCTAVE = 1
_C.MODEL.PAA.NUM_CONVS = 4
_C.MODEL.PAA.USE_DCN_IN_TOWER = False
_C.MODEL.PAA.LOSS_ALPHA = 0.25
_C.MODEL.PAA.LOSS_GAMMA = 2.0
_C.MODEL.PAA.IOU_THRESHOLD = 0.1
_C.MODEL.PAA.TOPK = 9
_C.MODEL.PAA.REG_LOSS_WEIGHT = 1.3
_C.MODEL.PAA.PRIOR_PROB = 0.01
_C.MODEL.PAA.INFERENCE_TH = 0.05
_C.MODEL.PAA.NMS_TH = 0.6
_C.MODEL.PAA.PRE_NMS_TOP_N = 1000
_C.MODEL.PAA.USE_IOU_PRED = True
_C.MODEL.PAA.IOU_LOSS_WEIGHT = 0.5
_C.MODEL.PAA.INFERENCE_SCORE_VOTING = False
_C.MODEL.PAA.REG_LOSS_TYPE = "iou"
# PAA also reads ATSS.REGRESSION_TYPE through the shared BoxCoder
# (reference paa_core/modeling/rpn/atss/atss.py:14-97).

# ---------------------------------------------------------------------------
# ATSS head
# ---------------------------------------------------------------------------
_C.MODEL.ATSS = CN()
_C.MODEL.ATSS.NUM_CLASSES = 81
_C.MODEL.ATSS.ANCHOR_SIZES = (64, 128, 256, 512, 1024)
_C.MODEL.ATSS.ASPECT_RATIOS = (1.0,)
_C.MODEL.ATSS.ANCHOR_STRIDES = (8, 16, 32, 64, 128)
_C.MODEL.ATSS.STRADDLE_THRESH = 0
_C.MODEL.ATSS.OCTAVE = 2.0
_C.MODEL.ATSS.SCALES_PER_OCTAVE = 1
_C.MODEL.ATSS.NUM_CONVS = 4
_C.MODEL.ATSS.USE_DCN_IN_TOWER = False
_C.MODEL.ATSS.LOSS_ALPHA = 0.25
_C.MODEL.ATSS.LOSS_GAMMA = 2.0
_C.MODEL.ATSS.POSITIVE_TYPE = "ATSS"
_C.MODEL.ATSS.FG_IOU_THRESHOLD = 0.5
_C.MODEL.ATSS.BG_IOU_THRESHOLD = 0.4
_C.MODEL.ATSS.TOPK = 9
_C.MODEL.ATSS.REGRESSION_TYPE = "BOX"
_C.MODEL.ATSS.REG_LOSS_WEIGHT = 2.0
# IoU-prediction ablation keys used by the reference's atss/ret_*.yaml
# configs (absent from the reference's own defaults — those configs are
# broken upstream; here the branch predicts IoU instead of centerness)
_C.MODEL.ATSS.USE_IOU_PRED = False
_C.MODEL.ATSS.IOU_LOSS_WEIGHT = 0.5
_C.MODEL.ATSS.USE_CENTERNESS_PRED = True
_C.MODEL.ATSS.PRIOR_PROB = 0.01
_C.MODEL.ATSS.INFERENCE_TH = 0.05
_C.MODEL.ATSS.NMS_TH = 0.6
_C.MODEL.ATSS.PRE_NMS_TOP_N = 1000

# ---------------------------------------------------------------------------
# FCOS head
# ---------------------------------------------------------------------------
_C.MODEL.FCOS = CN()
_C.MODEL.FCOS.NUM_CLASSES = 81
_C.MODEL.FCOS.FPN_STRIDES = [8, 16, 32, 64, 128]
_C.MODEL.FCOS.PRIOR_PROB = 0.01
_C.MODEL.FCOS.INFERENCE_TH = 0.05
_C.MODEL.FCOS.NMS_TH = 0.6
_C.MODEL.FCOS.PRE_NMS_TOP_N = 1000
_C.MODEL.FCOS.LOSS_ALPHA = 0.25
_C.MODEL.FCOS.LOSS_GAMMA = 2.0
_C.MODEL.FCOS.NUM_CONVS = 4
_C.MODEL.FCOS.CENTER_SAMPLING_RADIUS = 0.0
_C.MODEL.FCOS.IOU_LOSS_TYPE = "iou"
_C.MODEL.FCOS.NORM_REG_TARGETS = False
_C.MODEL.FCOS.CENTERNESS_ON_REG = False
_C.MODEL.FCOS.USE_DCN_IN_TOWER = False

# ---------------------------------------------------------------------------
# RetinaNet head
# ---------------------------------------------------------------------------
_C.MODEL.RETINANET = CN()
_C.MODEL.RETINANET.NUM_CLASSES = 81
_C.MODEL.RETINANET.ANCHOR_SIZES = (32, 64, 128, 256, 512)
_C.MODEL.RETINANET.ASPECT_RATIOS = (0.5, 1.0, 2.0)
_C.MODEL.RETINANET.ANCHOR_STRIDES = (8, 16, 32, 64, 128)
_C.MODEL.RETINANET.STRADDLE_THRESH = 0
_C.MODEL.RETINANET.OCTAVE = 2.0
_C.MODEL.RETINANET.SCALES_PER_OCTAVE = 3
_C.MODEL.RETINANET.USE_C5 = True
_C.MODEL.RETINANET.NUM_CONVS = 4
_C.MODEL.RETINANET.BBOX_REG_WEIGHT = 4.0
_C.MODEL.RETINANET.BBOX_REG_BETA = 0.11
_C.MODEL.RETINANET.PRE_NMS_TOP_N = 1000
_C.MODEL.RETINANET.FG_IOU_THRESHOLD = 0.5
_C.MODEL.RETINANET.BG_IOU_THRESHOLD = 0.4
_C.MODEL.RETINANET.LOSS_ALPHA = 0.25
_C.MODEL.RETINANET.LOSS_GAMMA = 2.0
_C.MODEL.RETINANET.PRIOR_PROB = 0.01
_C.MODEL.RETINANET.INFERENCE_TH = 0.05
_C.MODEL.RETINANET.NMS_TH = 0.4

# ---------------------------------------------------------------------------
# SOLVER
# ---------------------------------------------------------------------------
_C.SOLVER = CN()
_C.SOLVER.MAX_ITER = 40000
_C.SOLVER.BASE_LR = 0.001
_C.SOLVER.BIAS_LR_FACTOR = 2
_C.SOLVER.DCONV_OFFSETS_LR_FACTOR = 1.0
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.WEIGHT_DECAY = 0.0005
_C.SOLVER.WEIGHT_DECAY_BIAS = 0.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000,)
_C.SOLVER.WARMUP_FACTOR = 1.0 / 3
_C.SOLVER.WARMUP_ITERS = 500
_C.SOLVER.WARMUP_METHOD = "linear"
_C.SOLVER.CHECKPOINT_PERIOD = 2500
_C.SOLVER.IMS_PER_BATCH = 16

# ---------------------------------------------------------------------------
# TEST
# ---------------------------------------------------------------------------
_C.TEST = CN()
_C.TEST.EXPECTED_RESULTS = []
_C.TEST.EXPECTED_RESULTS_SIGMA_TOL = 4
_C.TEST.IMS_PER_BATCH = 8
_C.TEST.DETECTIONS_PER_IMG = 100

_C.TEST.BBOX_AUG = CN()
_C.TEST.BBOX_AUG.ENABLED = False
_C.TEST.BBOX_AUG.H_FLIP = False
_C.TEST.BBOX_AUG.SCALES = ()
_C.TEST.BBOX_AUG.MAX_SIZE = 4000
_C.TEST.BBOX_AUG.SCALE_H_FLIP = False
_C.TEST.BBOX_AUG.VOTE = False
_C.TEST.BBOX_AUG.VOTE_TH = 0.66
_C.TEST.BBOX_AUG.SCALE_RANGES = ()
_C.TEST.BBOX_AUG.MERGE_TYPE = "vote"

# ---------------------------------------------------------------------------
# TPU-native knobs (no reference analogue)
# ---------------------------------------------------------------------------
_C.TPU = CN()
# Static padded-shape buckets (H, W) that images are resized+padded into so
# XLA compiles a fixed number of programs. Replaces the reference's
# pad-to-batch-max dynamic shapes (paa_core/structures/image_list.py:54-61).
_C.TPU.TRAIN_BUCKETS = ((800, 1344), (1344, 800))
_C.TPU.TEST_BUCKETS = ((800, 1344), (1344, 800))
# Max ground-truth boxes per image after padding (COCO max is 93).
_C.TPU.MAX_GT = 100
# Compute dtype of the conv/matmul path ("bfloat16" or "float32");
# parameters stay float32.
_C.TPU.COMPUTE_DTYPE = "float32"
# Mesh axis sizes: data parallelism only by default (matching the
# reference's DDP-only story, SURVEY.md 2.3).
_C.TPU.MESH_DATA = -1  # -1 = all devices
# EM iterations of the vectorized 2-component GMM fit that replaces
# sklearn.mixture.GaussianMixture (reference rpn/paa/loss.py:192-203).
_C.TPU.GMM_ITERS = 100
# base seed for on-device sampling (ROI subsampling rng streams)
_C.TPU.SEED = 0
# NMS implementation: 'auto' picks Pallas on TPU / scan elsewhere at
# trace time; pin 'pallas' or 'scan' for AOT cross-platform tracing
_C.TPU.NMS_IMPL = "auto"
# ship batches to the device as RAW padded uint8 and normalize + re-zero
# padding inside the jitted program (ops/image_norm.py): 4x less
# host->device traffic than host-normalized float32, bit-identical
# results (the uint8->f32 cast is exact and the op order matches
# data/transforms.py normalize_image). False restores the host-side
# fused normalize-into-batch path.
_C.TPU.DEVICE_NORMALIZE = True
# Deformable-conv sampling lowering (ops/dcn.py): 'gather' = bilinear
# quad-gather im2col (exact, bound by XLA's TPU gather emitter);
# 'onehot' = windowed one-hot matmul on the MXU (no gathers; exact
# while offsets stay within the window margin); 'auto' = onehot with a
# runtime lax.cond fallback to gather whenever any active sample
# escapes its window, so it is exact for arbitrary offsets like the
# reference CUDA kernel (csrc/cuda/deform_conv_kernel_cuda.cu);
# 'optimistic' (inference-only) = cond-free onehot program that reports
# per-image escape flags — the inference engine re-runs escaped batches
# through a lazily-compiled gather-pinned model, keeping end-to-end
# exactness without any per-layer cond. Measured on v5e (PERF.md "DCN
# cold compile"): it does NOT beat 'auto' — the per-layer escape-flag
# reductions defeat XLA's dedup of identical DCN layer bodies, so the
# cold compile is LONGER (583 s vs auto's 350 s for dcnv2-R101) at the
# same steady-state speed; kept as a documented negative result. Pin
# 'onehot' (132 s compile, fastest steady state) when offsets are known
# to stay in-margin; 'auto' is the exact-for-arbitrary-offsets default.
_C.TPU.DCN_MODE = "auto"
# offset headroom (pixels) of the onehot tile windows: 'auto' stays on
# the fast one-hot path while every active sample's bilinear corners
# land within this margin beyond the static receptive field; raise it
# if trained offsets are large enough to trip the gather fallback
# (window area — and the one-hot matmul cost — grows ~linearly)
_C.TPU.DCN_WINDOW_MARGIN = 2
# exact space-to-depth stem: replace the 7x7/2 conv on the 3-channel
# image with the equivalent 4x4/1 conv on the 2x2-space-to-depth input
# (weight import transforms the kernel). Off by default: in the full
# fused program it measured neutral-to-slightly-slower on v5e at
# 800x1344 (the isolated stem conv is 2x faster, but the input
# transpose eats the gain); kept as an option for other shapes/chips
_C.TPU.SPACE_TO_DEPTH = False

# Fuse GroupNorm + ReLU in the head towers into one Pallas kernel
# (single HBM pass; ops/fused_gn.py). Numerically equivalent to the
# flax GroupNorm path (same f32 statistics). Measured SLOWER on v5e
# (266.3 -> 221.7 img/s e2e; see PERF.md) — XLA's fused GN lowering
# wins there; kept for chip generations where the trade flips.
_C.TPU.FUSED_GN = False
# jax.profiler trace capture: when PROFILE_DIR is set, do_train records
# a trace of steps [PROFILE_START, PROFILE_START + PROFILE_STEPS)
_C.TPU.PROFILE_DIR = ""
_C.TPU.PROFILE_START = 10
_C.TPU.PROFILE_STEPS = 5

# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------
_C.OUTPUT_DIR = "."
_C.PATHS_CATALOG = os.path.join(os.path.dirname(__file__), "paths_catalog.py")
