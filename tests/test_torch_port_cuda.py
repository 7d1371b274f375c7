"""The port's hand-written kernels against their plain PyTorch versions on
an NVIDIA GPU, at small and edge shapes and at the two-stage head's
80,000 candidates (chip_smoke.py covers the main paths' shapes). Every
test needs a card and skips without one. The file imports neither JAX nor the JAX package, so on a machine without JAX it
runs with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from paa_tpu_torch.ops import group_norm as gn
from paa_tpu_torch.ops import nms

import nms_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _nms_case(seed, bsz, n, dev):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 300, (bsz, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 90, (bsz, n, 2))],
                           axis=2).astype(np.float32)
    scores = rng.uniform(0, 1, (bsz, n)).astype(np.float32)
    scores[:, n // 3: n // 2] = scores[:, :1]  # exact ties
    labels = rng.randint(0, 4, (bsz, n)).astype(np.int32)
    valid = rng.rand(bsz, n) > 0.3
    valid[0] = False
    return [torch.from_numpy(a).to(dev) for a in (boxes, scores, labels,
                                                  valid)]


@pytest.mark.parametrize("bsz,n,max_out", [
    (1, 1, 4), (2, 33, 50), (3, 1000, 100), (4, 8000, 100), (1, 4097, 300),
])
@pytest.mark.parametrize("class_aware", [True, False])
def test_nms_kernel_matches_plain(dev, bsz, n, max_out, class_aware):
    args = _nms_case(n, bsz, n, dev)
    before = nms.nms_batched.launches
    got = nms.nms_batched(*args, 0.6, max_out, class_aware)
    assert nms.nms_batched.launches == before + 1
    want = nms.nms_batched_plain(*args, 0.6, max_out, class_aware)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


def test_nms_kernel_refuses_what_it_cannot_hold(dev):
    """K1 itself refuses N above its shared memory; ``nms_batched``
    routes such N to K2 instead (test_nms_batched_routes_by_capacity)."""
    args = _nms_case(0, 1, 9000, dev)
    with pytest.raises(ValueError, match="shared memory"):
        nms._nms_batched_cuda(*args, 0.6, 10, True)
    args[2] = args[2].to(torch.int64)
    with pytest.raises(TypeError, match="labels"):
        nms.nms_batched(*_nms_case(0, 1, 10, dev)[:2], args[2][:, :10],
                        args[3][:, :10], 0.6, 10)


@pytest.mark.parametrize("name", nms_cases.EDGES)
def test_nms_kernel_sort_and_sweep_edges(dev, name):
    """K1 bit-equal to its plain version at the edges of its sort and
    tile sweep (tests/nms_cases.py, the cases the CPU tests hold against
    the JAX package) and at the main paths' shapes (PAA 8x5000, 100
    picks; the RPN's 40x1000, 1000 picks, class-agnostic, IoU 0.7)."""
    arrays, thresh, max_out, aware = nms_cases.edge_case(name)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]
    before = nms.nms_batched.launches
    got = nms.nms_batched(*args, thresh, max_out, aware)
    assert nms.nms_batched.launches == before + 1
    want = nms.nms_batched_plain(*args, thresh, max_out, aware)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
    assert bool(got[2].any())
    if name == "ties_across_tiles":
        picks = nms_cases.tied_picks()
        assert got[0][0, :len(picks)].tolist() == picks.tolist()


def test_nms_kernel_reports_tiles_swept(dev):
    """Each row's tiles of 32, counted by the kernel: up to the tile of
    the max_out-th pick, or every live candidate's tile; none in a row
    without live candidates."""
    arrays, thresh, max_out, aware = nms_cases.edge_case(
        "max_out_below_survivors")
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    tiles = torch.full((3,), -1, dtype=torch.int32, device=dev)
    got = nms._nms_batched_cuda(*args, thresh, max_out, aware, tiles=tiles)
    torch.cuda.synchronize()
    assert tiles[1].item() == 0  # the all-invalid row
    for row in (0, 2):  # 5 picks: the tile of the 5th pick's rank
        s, live = args[1][row], args[3][row]
        j = got[0][row, -1].long()
        ahead = (s > s[j]) | ((s == s[j]) & (torch.arange(300, device=dev)
                                             < j))
        rank = int((live & ahead).sum())
        assert tiles[row].item() == rank // 32 + 1
    arrays, thresh, _, aware = nms_cases.edge_case("max_out_above_valid")
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    tiles = torch.zeros(2, dtype=torch.int32, device=dev)
    nms._nms_batched_cuda(*args, thresh, 64, aware, tiles=tiles)
    assert tiles.tolist() == [1, 0]  # 8 valid candidates: one tile
    with pytest.raises(TypeError, match="tiles"):
        nms._nms_batched_cuda(*args, thresh, 64, aware,
                              tiles=tiles.to(torch.int64))


def test_nms_kernel_takes_unaligned_boxes(dev):
    """K1 loads a box as one float4: a box view that starts off a
    16-byte boundary is copied, not read misaligned."""
    args = _nms_case(4, 2, 200, dev)
    flat = torch.cat([torch.zeros(1, device=dev), args[0].reshape(-1)])
    args[0] = flat[1:].view(2, 200, 4)
    assert args[0].data_ptr() % 16 != 0
    got = nms._nms_batched_cuda(*args, 0.5, 30, True)
    want = nms.nms_batched_plain(*args, 0.5, 30)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _nan_n(n, dev):
    return 16 * nms.k2_capacity(dev) + 1 if n == "scratch" else n


@pytest.mark.parametrize("entry,n", [
    ("nms_batched", 300), ("nms_batched", 5000), ("_nms_global", 300),
    ("_nms_global", 80000), ("_nms_global", "scratch"),
])
def test_nms_kernels_nan_score_ends_its_row(dev, entry, n):
    """A valid NaN score leaves its row without picks, in K1 and in both
    routes of K2 (the NaN in a later CTA's range at N=80,000); an invalid
    NaN changes nothing. Bit-equal to the plain version."""
    n = _nan_n(n, dev)
    args = _nms_case(n + 2, 3, n, dev)
    args[3][0] = True
    j = n - 5  # in the last CTA's range of a cluster
    args[1][1, j], args[3][1, j] = float("nan"), True
    args[1][2, 3], args[3][2, 3] = float("nan"), False
    got = getattr(nms, entry)(*args, 0.6, 50, True)
    want = nms.nms_batched_plain(*args, 0.6, 50, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not bool(got[2][1].any())
    assert bool(got[2][0].all()) and bool(got[2][2].all())
    assert bool((got[0][1] == 0).all()) and bool((got[1][1] == -1e30).all())


def _k2_n(n, dev):
    return nms.k1_max_candidates(dev) + 1 if n == "k1+1" else n


@pytest.mark.parametrize("bsz,n,max_out", [
    (1, 1, 4), (2, 77, 100), (8, "k1+1", 100), (2, 80000, 100),
    (3, 300, 1000),
])
@pytest.mark.parametrize("class_aware", [True, False])
def test_nms_global_kernel_matches_plain(dev, bsz, n, max_out,
                                         class_aware):
    n = _k2_n(n, dev)
    args = _nms_case(n + 1, bsz, n, dev)
    before = nms._nms_global.launches
    got = nms._nms_global(*args, 0.6, max_out, class_aware)
    assert nms._nms_global.launches == before + 1
    want = nms.nms_batched_plain(*args, 0.6, max_out, class_aware)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
    assert not bool(got[2][0].any())  # the all-invalid row
    if bsz > 1:
        assert bool(got[2][1].any())


@pytest.mark.parametrize("above", [False, True])
def test_nms_batched_routes_by_capacity(dev, above):
    """K1 up to its capacity, K2 above it: the shape alone chooses."""
    n = nms.k1_max_candidates(dev) + int(above)
    args = _nms_case(7, 2, n, dev)
    before = (nms.nms_batched.launches, nms._nms_global.launches)
    got = nms.nms_batched(*args, 0.5, 100)
    after = (nms.nms_batched.launches, nms._nms_global.launches)
    assert after == (before[0] + int(not above), before[1] + int(above))
    want = nms.nms_batched_plain(*args, 0.5, 100)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_single_image_nms_launches_k2(dev):
    args = _nms_case(5, 2, 500, dev)
    before = nms._nms_global.launches
    got = nms.nms(*(a[1] for a in args), 0.5, 60)
    assert nms._nms_global.launches == before + 1
    want = nms.nms_batched_plain(*args, 0.5, 60)
    for g, w in zip(got, want):
        assert torch.equal(g, w[1])


def test_nms_global_takes_unaligned_boxes(dev):
    """A box view that starts off a 16-byte boundary is copied, not
    read misaligned."""
    args = _nms_case(2, 2, 200, dev)
    flat = torch.cat([torch.zeros(1, device=dev), args[0].reshape(-1)])
    args[0] = flat[1:].view(2, 200, 4)
    assert args[0].data_ptr() % 16 != 0
    got = nms._nms_global(*args, 0.5, 30)
    want = nms.nms_batched_plain(*args, 0.5, 30)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _k2_route_case(n, dev):
    cap = nms.k2_capacity(dev)
    return {"cap": cap, "cap+1": cap + 1, "16cap": 16 * cap,
            "16cap+1": 16 * cap + 1}[n]


@pytest.mark.parametrize("n,route", [
    ("cap", ("cluster", 1)), ("cap+1", ("cluster", 2)),
    ("16cap", ("cluster", 16)), ("16cap+1", ("scratch", 1)),
])
def test_nms_global_routes_by_n(dev, n, route):
    """cs = 1, 2 and the largest, and the scratch route above 16 CTAs'
    capacity: each bit-equal to the plain version."""
    n = _k2_route_case(n, dev)
    assert nms.k2_plan(n, nms.k2_capacity(dev)) == route
    args = _nms_case(n, 2, n, dev)
    got = nms._nms_global(*args, 0.6, 100, True)
    want = nms.nms_batched_plain(*args, 0.6, 100, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[2][1].any())


def _sparse_case(dev, n, valid_idx, seed=0):
    """N candidates of which only ``valid_idx`` are valid (both rows)."""
    args = _nms_case(seed, 2, n, dev)
    valid = torch.zeros(2, n, dtype=torch.bool, device=dev)
    valid[:, torch.as_tensor(valid_idx, dtype=torch.long, device=dev)] = True
    return args[:3] + [valid]


def test_nms_cluster_ties_across_ctas_go_to_the_lower_index(dev):
    """Equal top scores on both sides of each boundary between CTA
    ranges, with boxes that do not overlap: the lower index is picked
    first, so the picks ascend across ranks."""
    n = 80000
    _, cs = nms.k2_plan(n, nms.k2_capacity(dev))
    chunk = -(-n // cs)
    edges = [r * chunk + d for r in range(1, cs) for d in (-1, 0)]
    args = _nms_case(3, 2, n, dev)
    for i, j in enumerate(edges):  # far apart, equal scores
        args[0][:, j] = torch.tensor([10000.0 * i, 0, 10000.0 * i + 5, 5])
    args[1][:, edges] = 2.0
    args[3][:] = True
    got = nms._nms_global(*args, 0.5, 100, True)
    want = nms.nms_batched_plain(*args, 0.5, 100, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0][0, :len(edges)].tolist() == edges


def test_nms_cluster_all_valid_in_one_cta(dev):
    n = 80000
    _, cs = nms.k2_plan(n, nms.k2_capacity(dev))
    chunk = -(-n // cs)
    args = _sparse_case(dev, n, range(5 * chunk, 5 * chunk + 900))
    got = nms._nms_global(*args, 0.6, 100, True)
    want = nms.nms_batched_plain(*args, 0.6, 100, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[2].all())


def test_nms_cluster_max_out_above_valid_count(dev):
    """50 valid candidates, max_out 100: the tail slots hold (0, -1e30,
    False) as in the plain version."""
    n = 80000
    args = _sparse_case(dev, n, range(7, n, n // 50))
    got = nms._nms_global(*args, 0.6, 100, False)
    want = nms.nms_batched_plain(*args, 0.6, 100, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not bool(got[2][:, -1].any()) and bool(got[2][:, 0].all())


def test_nms_cluster_all_invalid_image(dev):
    args = _sparse_case(dev, 80000, [])
    got = nms._nms_global(*args, 0.6, 100, True)
    assert not bool(got[2].any())
    assert bool((got[1] == -1e30).all()) and bool((got[0] == 0).all())


# One channel per group (C=32) at 8 positions is the smallest group here.
# A group with (near) zero variance is left out: the folded affine
# x * a + (b - mean * a) of the kernel, like the TPU kernel's, then
# cancels two terms of size |x| * rsqrt(var + eps), a rounding effect.
def _gn_check(dev, shape, dtype, num_groups=32, seed=None):
    gen = torch.Generator().manual_seed(shape[2] if seed is None else seed)
    x = (torch.randn(*shape, generator=gen) * 2 + 0.5).to(dev, dtype)
    c = shape[1]
    s = (torch.rand(c, generator=gen) + 0.5).to(dev)
    b = (torch.randn(c, generator=gen) * 0.3).to(dev)
    before = gn.group_norm_relu.launches
    got = gn.group_norm_relu(x, s, b, num_groups).float()
    assert gn.group_norm_relu.launches == before + 1
    want = gn.group_norm_relu_plain(x, s, b, num_groups).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        mag = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool(((got - want).abs() <= ulp + 1e-6).all())


@pytest.mark.parametrize("shape", [
    (1, 32, 2, 4), (2, 64, 3, 5), (2, 256, 7, 11), (1, 256, 40, 33),
    (3, 96, 17, 9),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernel_matches_plain(dev, shape, dtype):
    _gn_check(dev, shape, dtype)


# (shape, dtype) -> the plan's cluster size; 4.5 KB of bf16 per 256
# channels' position, so H*W = 2304 k gives cs = k (36 KB shares);
# 40,000 positions need 18 CTAs' shares and stream from device memory
_CLUSTER_CASES = [
    ((2, 256, 48, 48), torch.bfloat16, 1, True),
    ((2, 256, 48, 96), torch.bfloat16, 2, True),
    ((1, 256, 72, 96), torch.bfloat16, 3, True),
    ((1, 256, 96, 96), torch.bfloat16, 4, True),
    ((1, 256, 100, 168), torch.bfloat16, 8, True),
    ((1, 256, 192, 192), torch.bfloat16, 16, True),
    ((1, 256, 192, 192), torch.float32, 16, False),
    ((1, 256, 200, 200), torch.bfloat16, 16, False),
    ((1, 64, 101, 199), torch.bfloat16, 3, True),  # odd H*W, cs > 1
]


@pytest.mark.parametrize("shape,dtype,cs,resident", _CLUSTER_CASES)
def test_group_norm_kernel_every_cluster_size(dev, shape, dtype, cs,
                                               resident):
    b, c, h, w = shape
    plan = gn.gn_plan(b, c, h * w, 32, torch.finfo(dtype).bits // 8)
    assert (plan.cs, plan.resident) == (cs, resident)
    _gn_check(dev, shape, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernel_misaligned_groups(dev, dtype):
    """C=64 in 32 groups at odd H*W: each group is 2 * 35 elements, so
    group starts fall off 16-byte boundaries; and an input view that
    itself starts off a boundary."""
    _gn_check(dev, (3, 64, 5, 7), dtype)
    flat = torch.randn(1 + 2 * 64 * 35, device=dev).to(dtype)
    x = flat[1:].view(2, 64, 5, 7)
    assert x.data_ptr() % 16 != 0
    w = torch.linspace(0.5, 1.5, 64, device=dev)
    got = gn.group_norm_relu(x, w, w - 1).float()
    want = gn.group_norm_relu_plain(x, w, w - 1).float()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
    tol = 1e-5 if dtype == torch.float32 else torch.exp2(
        torch.floor(torch.log2(mag)) - 7) + 1e-6
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("hw", [(100, 168), (50, 84), (25, 42), (13, 21),
                                (7, 11)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernel_tower_shapes(dev, hw, dtype):
    _gn_check(dev, (8, 256, *hw), dtype)


def test_group_norm_kernel_repeats_exactly(dev):
    x = torch.randn(8, 256, 100, 168, device=dev, dtype=torch.bfloat16)
    w = torch.ones(256, device=dev)
    assert torch.equal(gn.group_norm_relu(x, w, w),
                       gn.group_norm_relu(x, w, w))


def test_group_norm_kernel_refuses_channels_last(dev):
    x = torch.randn(2, 64, 4, 4, device=dev).to(
        memory_format=torch.channels_last)
    w = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="NCHW-contiguous"):
        gn.group_norm_relu(x, w, w)


# ---- training: the autograd Function around K3, and a train step -------

@pytest.mark.parametrize("shape", [(2, 256, 25, 42), (4, 64, 13, 21)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_function_gradients_match_plain(dev, shape, dtype):
    """Where autograd records, ``group_norm_relu`` launches K3 once
    through ``GroupNormReLU``; its gradients (the plain version's VJP,
    recomputed) equal autograd through the plain version."""
    gen = torch.Generator().manual_seed(shape[2])
    x = (torch.randn(*shape, generator=gen) * 1.5 + 0.4).to(dev, dtype)
    w = (torch.rand(shape[1], generator=gen) + 0.5).to(dev)
    b = (torch.randn(shape[1], generator=gen) * 0.2).to(dev)
    up = torch.randn(*shape, generator=gen).to(dev, dtype)
    ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
    before = gn.group_norm_relu.launches
    y = gn.group_norm_relu(*ins)
    assert gn.group_norm_relu.launches == before + 1
    assert type(y.grad_fn).__name__ == "GroupNormReLUBackward"
    y.backward(up)
    refs = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want = gn.group_norm_relu_plain(*refs)
    want.backward(up)
    assert torch.equal(y.detach(), gn.group_norm_relu(x, w, b))
    for got, ref in zip(ins, refs):
        assert got.grad.dtype == ref.grad.dtype
        assert torch.equal(got.grad, ref.grad)
    # inference keeps the direct launch, outside autograd
    with torch.no_grad():
        assert gn.group_norm_relu(*ins).grad_fn is None


def test_train_step_launches_k3_40_times(dev):
    """One train step of a narrow PAA-R50 (64 FPN channels, 2 x 64 x 96
    uint8 input) on the card: K3 40 times (8 per level x 5 levels),
    finite losses, positives, gradients on the towers' GroupNorm
    affines and none on the frozen stem."""
    from paa_tpu_torch.config import get_cfg
    from paa_tpu_torch.engine import TrainState
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.solver import make_optimizer

    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.PAA_ON", True, "MODEL.RPN_ONLY", True,
        "MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET",
        "MODEL.RETINANET.USE_C5", False,
        "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
        "TPU.COMPUTE_DTYPE", "bfloat16"])
    cfg.freeze()
    model = build_detection_model(cfg, device=dev)
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    rng = np.random.RandomState(0)
    batch = {
        "images": rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8),
        "image_sizes": np.asarray([[64, 96], [60, 90]], np.float32),
        "gt_boxes": np.asarray([[[4, 6, 40, 50], [30, 10, 90, 60]]] * 2,
                               np.float32),
        "gt_labels": np.asarray([[3, 7], [12, 0]], np.int32),
    }
    step = model.make_bucket_train_step((64, 96))
    before = gn.group_norm_relu.launches
    metrics = step(state, batch)
    torch.cuda.synchronize()
    assert gn.group_norm_relu.launches == before + 40
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert int(metrics["num_pos"]) > 0 and state.step == 1
    head = model.module.head
    assert head.cls_tower.gn0.weight.grad is not None
    assert bool(head.bbox_tower.gn3.bias.grad.abs().sum() > 0)
    assert model.module.backbone.resnet.stem.conv1.weight.grad is None


def _reference_checkpoint_cases():
    """(config overrides, seeded reference state dict) of the narrow
    PAA-R50 and Faster R-CNN R-50-FPN (tests/reference_layout.py)."""
    import os

    import reference_layout as rl
    from paa_tpu_torch.config import get_cfg

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cases = []
    for config, extra in (
            (None, ["MODEL.PAA_ON", True, "MODEL.RPN_ONLY", True,
                    "MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET",
                    "MODEL.RETINANET.USE_C5", False]),
            (os.path.join(root, "configs", "e2e_faster_rcnn_R_50_FPN_1x.yaml"),
             ["MODEL.ROI_BOX_HEAD.NUM_CLASSES", 5,
              "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 64])):
        cfg = get_cfg()
        if config:
            cfg.merge_from_file(config)
        cfg.merge_from_list(extra + ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS",
                                     64])
        cfg.freeze()
        cases.append((cfg, rl.seeded_state_dict(rl.layout(cfg), seed=5)))
    return cases


def test_checkpoint_import_on_the_card_equals_the_cpu(dev):
    """utils/torch_import.py into a module on the card lands on the CPU
    import's tensors, every key written, nothing skipped."""
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.utils.torch_import import load_torch_state_dict

    for cfg, state in _reference_checkpoint_cases():
        loaded = {}
        for device in (dev, "cpu"):
            module = build_detection_model(cfg, device=device).module
            assert load_torch_state_dict(module, state) == ([], [])
            loaded[str(device)] = module.state_dict()
        for key, value in loaded["cpu"].items():
            got = loaded[str(dev)][key]
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), value), key


def test_load_pretrained_into_keeps_the_module_on_its_device(dev, tmp_path):
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.utils.torch_import import load_pretrained_into

    cfg, state = _reference_checkpoint_cases()[0]
    path = tmp_path / "model.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}},
               path)
    model = build_detection_model(cfg, device=dev)
    assert load_pretrained_into(cfg, model.module, str(path)) == ([], [])
    assert {t.device.type for t in model.module.state_dict().values()} == \
        {"cuda"}
    assert torch.equal(model.module.head.cls_logits.bias.cpu(),
                       torch.from_numpy(state["rpn.head.cls_logits.bias"]))


def _dcn_inputs(seed, b=2, c=64, hw=(20, 28), groups=4):
    """x, offsets (fractional parts in [0.1, 0.9], some samples off the
    image), mask, weight and an upstream gradient, float32 on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, *hw, generator=gen)
    offsets = (torch.rand(b, 18, *hw, generator=gen) * 0.8 + 0.1
               + torch.randint(-4, 4, (b, 18, *hw), generator=gen))
    mask = torch.rand(b, 9, *hw, generator=gen) * 0.9 + 0.1
    weight = torch.randn(c, c // groups, 3, 3, generator=gen) * 0.1
    up = torch.randn(b, c, *hw, generator=gen)
    return x, offsets, mask, weight, up


def _dcn_grads(fn, x, offsets, mask, weight, up, dtype, groups=4):
    ins = [t.clone().to(dtype if i in (0, 3) else torch.float32)
           .requires_grad_() for i, t in enumerate((x, offsets, mask,
                                                    weight))]
    out = fn(*ins, 1, 1, 1, groups, 1)
    out.backward(up.to(out.device, dtype))
    return [t.grad.float().cpu() for t in ins]


@pytest.mark.parametrize("chunk_bytes", [None, 64 * 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dcn_function_gradients_match_plain(dev, dtype, chunk_bytes,
                                            monkeypatch):
    """ops/dcn.py's DeformConv2dFunction (the backward that keeps only
    its inputs and recomputes each chunk) against autograd through
    deform_conv2d on the card, and in float32 against the CPU: the
    card's index_add is order-nondeterministic, so within 1e-5 of each
    gradient's largest magnitude in float32 (1e-4 against the CPU) and
    2e-2 in bfloat16; chunks of one image with ``chunk_bytes``."""
    from paa_tpu_torch.ops import dcn

    if chunk_bytes is not None:
        monkeypatch.setattr(dcn, "CHUNK_BYTES", chunk_bytes)
    cpu = _dcn_inputs(3)
    ins = [t.to(dev) for t in cpu]
    got = _dcn_grads(dcn.DeformConv2dFunction.apply, *ins, dtype)
    want = _dcn_grads(dcn.deform_conv2d, *ins, dtype)
    share = 1e-5 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=share * float(w.abs().max()))
    if dtype == torch.float32:
        ref = _dcn_grads(dcn.DeformConv2dFunction.apply, *cpu, dtype)
        for g, w in zip(got, ref):
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=1e-4 * float(w.abs().max()))
