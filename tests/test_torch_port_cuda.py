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


def test_nms_kernel_at_a_retinanet_row(dev):
    """K1 at the candidates of a RetinaNet request (retinanet_R-50-FPN_1x
    at 800 x 1344: five levels of 1000 slots, 5,000 per row, B=8): boxes
    at the nine anchors of every location with small offsets, so that
    same-class boxes overlap densely, 80 classes, IoU 0.4, 100 picks.
    Bit-equal to the plain version."""
    from paa_tpu_torch.config import get_cfg
    from paa_tpu_torch.modeling.anchors import make_anchor_generator_retinanet

    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.RETINANET.SCALES_PER_OCTAVE", 3])
    anchors, _ = make_anchor_generator_retinanet(cfg)(
        [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)])
    rng = np.random.RandomState(4)
    idx = np.stack([rng.choice(len(anchors), 5000, replace=False)
                    for _ in range(8)])
    boxes = anchors[idx] + rng.normal(0, 4, (8, 5000, 4))
    boxes = np.clip(boxes, 0, 1332).astype(np.float32)
    scores = rng.uniform(0.05, 1, (8, 5000)).astype(np.float32)
    labels = rng.randint(1, 81, (8, 5000)).astype(np.int32)
    valid = rng.rand(8, 5000) > 0.1
    args = [torch.from_numpy(a).to(dev) for a in (boxes, scores, labels,
                                                  valid)]
    before = nms.nms_batched.launches
    got = nms.nms_batched(*args, 0.4, 100, True)
    assert nms.nms_batched.launches == before + 1
    want = nms.nms_batched_plain(*args, 0.4, 100, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) == 800


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
def _gn_check(dev, shape, dtype, num_groups=32, seed=None, relu=True):
    gen = torch.Generator().manual_seed(shape[2] if seed is None else seed)
    x = (torch.randn(*shape, generator=gen) * 2 + 0.5).to(dev, dtype)
    c = shape[1]
    s = (torch.rand(c, generator=gen) + 0.5).to(dev)
    b = (torch.randn(c, generator=gen) * 0.3).to(dev)
    before = gn.group_norm_relu.launches
    got = gn.group_norm_relu(x, s, b, num_groups, relu=relu).float()
    assert gn.group_norm_relu.launches == before + 1
    want = gn.group_norm_relu_plain(x, s, b, num_groups, relu=relu).float()
    assert bool((got < 0).any()) != relu
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


# K3's relu=False form (GroupNorm alone: a GN body's bn3 and downsample,
# FPN's GN) at shapes of the GN paths, small: the stem's 2 channels per
# group (non-resident at 800 x 1344), a res5 bn3, the Xconv head's
# 7 x 7 and the fc GN's 1 x 1 (R rows as the batch), and the same with
# the ReLU
@pytest.mark.parametrize("shape", [
    (1, 64, 400, 672), (2, 2048, 25, 42), (64, 256, 7, 7), (512, 1024, 1, 1),
    (3, 64, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_kernel_both_forms_at_gn_path_shapes(dev, shape, dtype,
                                                        relu):
    _gn_check(dev, shape, dtype, relu=relu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_function_no_relu_gradients_match_plain(dev, dtype):
    """``relu=False`` through ``GroupNormReLU``: K3 once, gradients equal
    autograd through the plain GroupNorm."""
    shape = (2, 256, 25, 42)
    gen = torch.Generator().manual_seed(11)
    x = (torch.randn(*shape, generator=gen) * 1.5 + 0.4).to(dev, dtype)
    w = (torch.rand(256, generator=gen) + 0.5).to(dev)
    b = (torch.randn(256, generator=gen) * 0.2).to(dev)
    up = torch.randn(*shape, generator=gen).to(dev, dtype)
    ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
    before = gn.group_norm_relu.launches
    y = gn.group_norm_relu(*ins, relu=False)
    assert gn.group_norm_relu.launches == before + 1
    assert type(y.grad_fn).__name__ == "GroupNormReLUBackward"
    y.backward(up)
    refs = [t.clone().requires_grad_(True) for t in (x, w, b)]
    gn.group_norm_relu_plain(*refs, relu=False).backward(up)
    for got, ref in zip(ins, refs):
        assert torch.equal(got.grad, ref.grad)


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
    its inputs: on the card the columns' gradient, K4's columns and K5,
    chunk by chunk) against autograd through deform_conv2d on the card,
    and in float32 against the CPU: K5's atomics and the card's
    index_add are order-nondeterministic, so within 1e-5 of each
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


# ---- K4, the deformable im2col kernel ---------------------------------------

# chip_smoke.py's DCN_BF16_REL: K4 and the product in bfloat16 against
# the plain version in float32, a share of the output's largest magnitude
DCN_BF16_REL = 1.5e-2

# C/groups classes of the repo's DCN configs: (C, groups)
K4_WIDTHS = {"cg8": (512, 64), "cg16": (512, 32), "cg32": (1024, 32),
             "cg64": (2048, 32), "cg256": (256, 1), "cg512": (512, 1)}
# (deformable groups, stride, dilation, modulated)
K4_CONVS = {"v2": (1, 1, 1, True), "v1_dg2": (2, 1, 1, False),
            "v2_dg2_stride2_dil2": (2, 2, 2, True)}


def _k4_inputs(seed, b, c, hw, groups, dg, stride, dil, modulated):
    """x, offsets, mask (or None) and weight, float32 on the CPU. The
    offsets' whole parts put many samples off the image (a few far off)
    and their fractions are 0, 2^-20, 1 - 2^-20 or uniform: corners on
    the grid and next to it."""
    gen = torch.Generator().manual_seed(seed)
    ho = (hw[0] + 2 * dil - 2 * dil - 1) // stride + 1
    wo = (hw[1] + 2 * dil - 2 * dil - 1) // stride + 1
    shape = (b, dg * 18, ho, wo)
    whole = torch.randint(-6, 6, shape, generator=gen).float()
    whole[:, :, ::5, ::7] *= 20
    frac = torch.rand(shape, generator=gen)
    pick = torch.randint(0, 4, shape, generator=gen)
    frac = torch.where(pick == 0, 0.0, frac)
    frac = torch.where(pick == 1, 2.0 ** -20, frac)
    frac = torch.where(pick == 2, 1 - 2.0 ** -20, frac)
    x = torch.randn(b, c, *hw, generator=gen)
    mask = (torch.rand(b, dg * 9, ho, wo, generator=gen)
            if modulated else None)
    weight = torch.randn(c, c // groups, 3, 3, generator=gen) * 0.05
    return x, whole + frac, mask, weight


@pytest.mark.parametrize("conv", sorted(K4_CONVS))
@pytest.mark.parametrize("width", sorted(K4_WIDTHS))
def test_k4_matches_plain(dev, width, conv):
    """K4 and the product (``deform_conv2d_columns``) against the plain
    ``deform_conv2d`` on the card: float32 within 1e-5 of the output's
    largest magnitude, bfloat16 within DCN_BF16_REL of the float32 plain
    output's; one K4 launch each."""
    from paa_tpu_torch.ops import dcn

    c, groups = K4_WIDTHS[width]
    dg, stride, dil, modulated = K4_CONVS[conv]
    x, offsets, mask, weight = (
        None if t is None else t.to(dev) for t in _k4_inputs(
            c + dg, 2, c, (13, 21), groups, dg, stride, dil, modulated))
    args = (stride, dil, dil, groups, dg)
    want = dcn.deform_conv2d(x, offsets, mask, weight, *args)
    for dtype, share in ((torch.float32, 1e-5),
                         (torch.bfloat16, DCN_BF16_REL)):
        before = dcn.deform_im2col.launches
        got = dcn.deform_conv2d_columns(x.to(dtype), offsets, mask,
                                        weight.to(dtype), *args)
        torch.cuda.synchronize()
        assert dcn.deform_im2col.launches == before + 1
        assert got.dtype == dtype and got.shape == want.shape
        assert got.is_contiguous()
        torch.testing.assert_close(got.float(), want, rtol=0,
                                   atol=share * float(want.abs().max()))


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_columns_match_plain_columns(dev, dtype, layout):
    """K4's columns against ``_im2col_columns`` (the plain steps in K4's
    layout) on the same card tensors: float32 within 1e-6 of the largest
    column (the plain version weights in float32 too and sums in another
    order), bfloat16 within one bfloat16 rounding of both sides. x comes
    NCHW or as a strided view (both copied to channels-last first) or
    channels-last (read as it is)."""
    from paa_tpu_torch.ops import deform_sampling as ds

    x, offsets, mask, weight = (t.to(dev) for t in _k4_inputs(
        7, 2, 64, (10, 12), 4, 2, 1, 1, True))
    x = x.to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "strided":
        x = torch.cat([x, x], dim=1)[:, ::2]
    got = ds.deform_im2col(x, offsets, mask, 3, 3, 1, 1, 1, 4, 2)
    want = ds._im2col_columns(x, offsets, mask, 3, 3, 1, 1, 1, 4, 2)
    share = 1e-6 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=share * float(want.float().abs().max()))


def _on_grid_inputs(dg, modulated):
    """x of small integers, and offsets whose fraction is 0, 2^-20, 1 -
    2^-20 or -2^-20 along one axis and 0 along the other (whole parts
    -8..8, so samples sit on the grid, next to it and off the image), on
    the CPU; the mask powers of two. Each column value is then one or two
    exact products whose sum float32 holds exactly, whatever the order."""
    gen = torch.Generator().manual_seed(21)
    b, c, hw = 2, 64, 12
    x = torch.randint(-7, 8, (b, c, hw, hw), generator=gen).float()
    shape = (b, dg, 9, 2, hw, hw)
    whole = torch.randint(-8, 9, shape, generator=gen).float()
    fracs = torch.tensor([0.0, 2.0 ** -20, 1 - 2.0 ** -20, -2.0 ** -20])
    frac = fracs[torch.randint(0, 4, shape, generator=gen)]
    axis = torch.randint(0, 2, (b, dg, 9, 1, hw, hw), generator=gen)
    frac = torch.where(torch.arange(2).view(1, 1, 1, 2, 1, 1) == axis,
                       frac, 0.0)
    offsets = (whole + frac).view(b, dg * 18, hw, hw)
    mask = (2.0 ** -torch.randint(0, 3, (b, dg * 9, hw, hw), generator=gen)
            if modulated else None)
    return x, offsets, mask


@pytest.mark.parametrize("modulated", [True, False])
@pytest.mark.parametrize("dg", [1, 2])
def test_k4_corners_bit_exact_on_the_grid(dev, dg, modulated):
    """K4 picks ``_geometry``'s corners and weights bit for bit: in
    float32, on samples on and next to the integer grid, its columns
    equal the plain version's on the card exactly, and those equal the
    plain version's on the CPU (so the values are exact, and a corner
    taken one pixel off would show). kink_crossings in chip_smoke.py
    reads the plain geometry on the card for K4's on this ground."""
    from paa_tpu_torch.ops import deform_sampling as ds

    x, offsets, mask = _on_grid_inputs(dg, modulated)
    args = (3, 3, 1, 1, 1, 4, dg)
    on_cpu = ds._im2col_columns(x, offsets, mask, *args)
    x, offsets, mask = (None if t is None else t.to(dev)
                        for t in (x, offsets, mask))
    got = ds.deform_im2col(x, offsets, mask, *args)
    want = ds._im2col_columns(x, offsets, mask, *args)
    assert torch.equal(want.cpu(), on_cpu)
    assert torch.equal(got, want)
    # many samples lie inside the image (0.42), many off the integer grid
    assert float((want != 0).float().mean()) > 0.3
    assert float((want != want.round()).float().mean()) > 0.2


def test_k4_launches_once_per_chunk(dev, monkeypatch):
    """One K4 launch per layer per chunk of images: the whole batch in
    one chunk under CHUNK_BYTES, one image a chunk when CHUNK_BYTES holds
    one image's columns; the output is the same."""
    from paa_tpu_torch.ops import dcn

    x, offsets, mask, weight = (t.to(dev) for t in _k4_inputs(
        3, 3, 256, (12, 14), 8, 1, 1, 1, True))
    before = dcn.deform_im2col.launches
    whole = dcn.deform_conv2d_columns(x, offsets, mask, weight, 1, 1, 1, 8)
    assert dcn.deform_im2col.launches == before + 1
    monkeypatch.setattr(dcn, "CHUNK_BYTES", 12 * 14 * 9 * 256 * 4)
    chunked = dcn.deform_conv2d_columns(x, offsets, mask, weight, 1, 1, 1,
                                        8)
    assert dcn.deform_im2col.launches == before + 1 + 3
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_deform_conv_on_the_card_launches_k4(dev):
    """``DeformConv`` on CUDA tensors: one K4 launch a forward, without a
    graph and where autograd records, and one more in the backward (the
    columns recomputed for the weight's gradient) beside one K5 launch;
    the same output as the plain version on the CPU within 1e-5 of its
    largest magnitude."""
    from paa_tpu_torch.modeling.layers import DeformConv, reset_parameters
    from paa_tpu_torch.ops import dcn

    conv = DeformConv(64, 64, groups=4, bias=True)
    gen = torch.Generator().manual_seed(11)
    reset_parameters(conv, gen)
    with torch.no_grad():
        conv.offset.weight.normal_(0.0, 0.3, generator=gen)
        conv.bias.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(2, 64, 15, 19, generator=gen)
    with torch.no_grad():
        want = conv(x)
    conv.to(dev)
    before = dcn.deform_im2col.launches
    with torch.no_grad():
        got = conv(x.to(dev))
    assert dcn.deform_im2col.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    xx = x.to(dev).requires_grad_()
    k5 = dcn.deform_col2im.launches
    conv(xx).sum().backward()
    torch.cuda.synchronize()
    assert dcn.deform_im2col.launches == before + 3
    assert dcn.deform_col2im.launches == k5 + 1
    assert xx.grad is not None and conv.weight.grad is not None


def test_k4_op_exports_through_its_fake(dev):
    """A ``DeformConv`` exported on the card records K4 as one
    ``paa_tpu_torch::deform_im2col`` node (traced through its fake); the
    exported program launches it once and equals the live module."""
    from paa_tpu_torch.modeling.layers import DeformConv, reset_parameters
    from paa_tpu_torch.ops import dcn

    conv = DeformConv(32, 32, groups=2)
    gen = torch.Generator().manual_seed(12)
    reset_parameters(conv, gen)
    with torch.no_grad():
        conv.offset.weight.normal_(0.0, 0.3, generator=gen)
    conv.to(dev)
    x = torch.randn(2, 32, 11, 13, generator=gen).to(dev)
    with torch.no_grad():
        exported = torch.export.export(conv, (x,))
        targets = [str(n.target) for n in exported.graph.nodes
                   if n.op == "call_function"]
        assert targets.count("paa_tpu_torch.deform_im2col.default") == 1
        before = dcn.deform_im2col.launches
        got = exported.module()(x)
        assert dcn.deform_im2col.launches == before + 1
        want = conv(x)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


def test_k4_refuses_what_it_cannot_take(dev):
    """The wrapper raises on a float64 x and on offsets on another
    device; the launcher takes an offset conv's channel slice as it is
    (its images' planes are contiguous)."""
    from paa_tpu_torch.ops import deform_sampling as ds

    x, offsets, mask, weight = (t.to(dev) for t in _k4_inputs(
        5, 2, 32, (8, 9), 1, 1, 1, 1, True))
    with pytest.raises(TypeError, match="float64"):
        ds.deform_im2col(x.double(), offsets, mask, 3, 3)
    with pytest.raises(ValueError, match="offsets on"):
        ds.deform_im2col(x, offsets.cpu(), mask, 3, 3)
    om = torch.cat([offsets, mask], dim=1)
    sliced = ds.deform_im2col(x, om[:, :18], om[:, 18:], 3, 3)
    torch.testing.assert_close(
        sliced, ds.deform_im2col(x, offsets, mask, 3, 3), rtol=0, atol=0)


# ---- K5, the deformable col2im kernel ---------------------------------------

def _k5_grad_inputs(seed, c, groups, dg, stride, dil, modulated, dtype):
    """``_k4_inputs`` at B=2 and 13 x 21 on the card, x in ``dtype``, and
    a columns' gradient dcol in K4's layout and x's dtype."""
    x, offsets, mask, _ = (None if t is None else t.to("cuda")
                           for t in _k4_inputs(seed, 2, c, (13, 21), groups,
                                               dg, stride, dil, modulated))
    ho, wo = offsets.shape[2:]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dcol = torch.randn(2, groups, ho * wo, 9 * (c // groups), generator=gen,
                       device="cuda").to(dtype)
    return x.to(dtype), offsets, mask, dcol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("conv", sorted(K4_CONVS))
@pytest.mark.parametrize("width", sorted(K4_WIDTHS))
def test_k5_matches_plain(dev, width, conv, dtype):
    """K5 against its plain version ``_col2im_grads`` on the same card
    tensors, at every conv-group width class and conv of K4's tests: dx,
    the offsets' and the mask's gradients within 1e-5 of each one's
    largest magnitude in float32 and in bfloat16 (both read the same
    bfloat16 values and sum in float32; only the order of the adds
    differs, K5's by atomics), dx in bfloat16 also within one bfloat16
    ulp of each value (2^-7 of it: each side rounds its float32 sum
    once); one K5 launch each."""
    from paa_tpu_torch.ops import deform_sampling as ds

    c, groups = K4_WIDTHS[width]
    dg, stride, dil, modulated = K4_CONVS[conv]
    x, offsets, mask, dcol = _k5_grad_inputs(c + dg, c, groups, dg, stride,
                                             dil, modulated, dtype)
    args = (3, 3, stride, dil, dil, groups, dg)
    before = ds.deform_col2im.launches
    got = ds.deform_col2im(x, offsets, mask, dcol, *args)
    torch.cuda.synchronize()
    assert ds.deform_col2im.launches == before + 1
    want = ds._col2im_grads(x, offsets, mask, dcol, *args)
    assert (got[2] is None) == (not modulated)
    for name, g, w in zip(("dx", "doffsets", "dmask"), got, want):
        if w is None:
            continue
        assert g.dtype == (dtype if name == "dx" else torch.float32)
        assert g.shape == w.shape and g.is_contiguous()
        g, w = g.float(), w.float()
        rtol = 2 ** -7 if name == "dx" and dtype == torch.bfloat16 else 0
        torch.testing.assert_close(g, w, rtol=rtol,
                                   atol=1e-5 * float(w.abs().max()))
    # samples on the image, off it and at its edge all took part
    assert float((want[1] != 0).float().mean()) > 0.2


def test_k5_launches_once_per_chunk(dev, monkeypatch):
    """The card's backward of ``DeformConv2dFunction``: one K5 launch
    (and one K4 launch, the columns recomputed for the weight) per layer
    per chunk of images, the whole batch in one chunk under CHUNK_BYTES,
    one image a chunk when CHUNK_BYTES holds one image's columns; none
    where neither x, the offsets nor the mask wants a gradient. The
    gradients are the same either way, within the float32 sums' order."""
    from paa_tpu_torch.ops import dcn

    x, offsets, mask, weight = (t.to(dev) for t in _k4_inputs(
        3, 3, 256, (12, 14), 8, 1, 1, 1, True))
    up = torch.randn(3, 256, 12, 14, device=dev)

    def grads(*wanted):
        ins = [t.clone().requires_grad_(w)
               for t, w in zip((x, offsets, mask, weight), wanted)]
        out = dcn.DeformConv2dFunction.apply(*ins, 1, 1, 1, 8, 1)
        before = (dcn.deform_col2im.launches, dcn.deform_im2col.launches)
        out.backward(up)
        torch.cuda.synchronize()
        return ([t.grad for t in ins],
                (dcn.deform_col2im.launches - before[0],
                 dcn.deform_im2col.launches - before[1]))

    whole, launches = grads(True, True, True, True)
    assert launches == (1, 1)
    assert grads(False, False, False, True)[1] == (0, 1)
    monkeypatch.setattr(dcn, "CHUNK_BYTES", 12 * 14 * 9 * 256 * 4)
    chunked, launches = grads(True, True, True, True)
    assert launches == (3, 3)
    for g, w in zip(chunked, whole):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def test_k5_refuses_what_it_cannot_take(dev):
    """The wrapper raises on a dcol of another dtype, shape or device
    than K4's columns of x, as on what K4 refuses."""
    from paa_tpu_torch.ops import deform_sampling as ds

    x, offsets, mask, dcol = _k5_grad_inputs(5, 32, 1, 1, 1, 1, True,
                                             torch.float32)
    with pytest.raises(TypeError, match="dcol of torch.bfloat16"):
        ds.deform_col2im(x, offsets, mask, dcol.bfloat16(), 3, 3)
    with pytest.raises(ValueError, match="dcol"):
        ds.deform_col2im(x, offsets, mask, dcol[:, :, 1:], 3, 3)
    with pytest.raises(ValueError, match="dcol on cpu"):
        ds.deform_col2im(x, offsets, mask, dcol.cpu(), 3, 3)
    with pytest.raises(TypeError, match="float64"):
        ds.deform_col2im(x.double(), offsets, mask, dcol.double(), 3, 3)


# a process that serves an artifact with torch and paa_tpu_torch.serving
# alone, as chip_smoke.py's serving phase does
K4_SERVE = """
import json, sys, torch
from paa_tpu_torch.serving import load_exported
from paa_tpu_torch.ops import deform_sampling
call, meta = load_exported(sys.argv[1])
out = call(*torch.load(sys.argv[2]))
torch.cuda.synchronize()
torch.save(out.cpu(), sys.argv[3])
loaded = sorted(m for m in sys.modules if m.startswith("paa_tpu"))
print(json.dumps({"launches": deform_sampling.deform_im2col.launches,
                  "loaded": loaded}))
"""


def test_deform_conv_artifact_serves_without_model_code(dev, tmp_path):
    """A ``DeformConv`` exported on the card and saved as a serving
    artifact runs in a process that imports only torch and
    ``paa_tpu_torch.serving``: one K4 launch, the live module's output,
    and neither the model code nor ops/dcn.py loaded."""
    import json
    import os
    import subprocess
    import sys

    from paa_tpu_torch.modeling.layers import DeformConv, reset_parameters
    from paa_tpu_torch.serving import save_exported

    class Served(torch.nn.Module):
        """The conv of two inputs, as an artifact's call takes them."""

        def __init__(self, conv):
            super().__init__()
            self.conv = conv

        def forward(self, x, scale):
            return self.conv(x) * scale

    conv = DeformConv(64, 64, groups=4, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(13)
    reset_parameters(conv, gen)
    with torch.no_grad():
        conv.offset.weight.normal_(0.0, 0.3, generator=gen)
    module = Served(conv).to(dev)
    inputs = (torch.randn(2, 64, 15, 19, generator=gen).to(dev),
              torch.full((1,), 0.5, device=dev))
    with torch.no_grad():
        exported = torch.export.export(module, inputs)
        want = module(*inputs)
    path, saved, served = (str(tmp_path / f) for f in (
        "conv.paat", "inputs.pt", "served.pt"))
    save_exported(path, exported, {"device": "cuda"})
    torch.save(inputs, saved)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", K4_SERVE, path, saved,
                           served], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["launches"] == 1
    assert not [m for m in out["loaded"] if m.startswith((
        "paa_tpu_torch.modeling", "paa_tpu_torch.config",
        "paa_tpu_torch.data", "paa_tpu_torch.ops.dcn"))]
    torch.testing.assert_close(torch.load(served), want.cpu(), rtol=0,
                               atol=0)


# ---- the kernels as custom ops, and the serving artifact -------------------

@pytest.mark.parametrize("relu", [True, False])
def test_custom_ops_on_the_card_equal_plain(dev, relu):
    """``paa_tpu_torch::nms_batched`` (K1; K2 above K1's capacity),
    ``::nms`` (K2) and ``::group_norm_relu`` (K3) called as ops on CUDA
    tensors: each launches its kernel once and equals its plain
    version."""
    from paa_tpu_torch.ops import group_norm as gn

    ops = torch.ops.paa_tpu_torch
    for n, counter in ((1000, nms.nms_batched), (9000, nms._nms_global)):
        args = _nms_case(n, 2, n, dev)
        before = counter.launches
        got = ops.nms_batched(*args, 0.6, 50, relu)
        assert counter.launches == before + 1
        want = nms.nms_batched_plain(*args, 0.6, 50, relu)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    args = [t[1] for t in _nms_case(7, 2, 3000, dev)]
    before = nms._nms_global.launches
    got = ops.nms(*args, 0.5, 40, relu)
    assert nms._nms_global.launches == before + 1
    want = nms.nms_batched_plain(*(t[None] for t in args), 0.5, 40, relu)
    for g, w in zip(got, want):
        assert torch.equal(g, w[0])
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 256, 25, 42, generator=gen).to(dev)
    w = (torch.rand(256, generator=gen) + 0.5).to(dev)
    b = torch.randn(256, generator=gen).to(dev)
    before = gn.group_norm_relu.launches
    with torch.no_grad():
        got = ops.group_norm_relu(x, w, b, 32, 1e-5, relu)
    assert gn.group_norm_relu.launches == before + 1
    torch.testing.assert_close(
        got, gn.group_norm_relu_plain(x, w, b, 32, 1e-5, relu), rtol=0,
        atol=1e-5)


def test_export_on_the_card_round_trips(dev, tmp_path):
    """A slim PAA-R50 exported on the card, saved and loaded: the served
    detections equal the live eval fn's (labels and valid equal, boxes
    and scores within 1e-5), and a served call launches K1 once and K3
    40 times."""
    from paa_tpu_torch.config import get_cfg
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.ops import group_norm as gn
    from paa_tpu_torch.serving import (
        export_inference, load_exported, save_exported)

    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.PAA_ON", True, "MODEL.RPN_ONLY", True,
        "MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET",
        "MODEL.RETINANET.USE_C5", False,
        "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64])
    cfg.freeze()
    model = build_detection_model(cfg, device=dev, seed=0)
    with torch.no_grad():
        model.module.head.cls_logits.bias.fill_(-3.0)
    exported, meta = export_inference(model, 2, (256, 320))
    assert meta["device"] == "cuda"
    save_exported(str(tmp_path / "m.paat"), exported, meta)
    call, _ = load_exported(str(tmp_path / "m.paat"))
    gen = torch.Generator().manual_seed(0)
    images = (torch.rand(2, 256, 320, 3, generator=gen) * 4 - 2).to(dev)
    sizes = torch.tensor([[256.0, 320.0], [240.0, 300.0]], device=dev)
    live = model.make_eval_fn()(images, sizes)
    before = (nms.nms_batched.launches, gn.group_norm_relu.launches)
    served = call(images, sizes)
    torch.cuda.synchronize()
    assert (nms.nms_batched.launches - before[0],
            gn.group_norm_relu.launches - before[1]) == (1, 40)
    assert int(live["valid"].sum()) > 0
    for k in ("labels", "valid"):
        assert torch.equal(served[k], live[k]), k
    for k in ("boxes", "scores"):
        torch.testing.assert_close(served[k], live[k], rtol=0, atol=1e-5)


def test_two_stage_export_on_the_card_round_trips(dev, tmp_path):
    """Faster R-CNN R-50-FPN at full width (256 channels, 81 classes, the
    RPN's 1,000 proposals) exported on the card at 2 x 256 x 320, its 80
    foreground biases lifted as chip_smoke.py's ``seeded_frcnn`` does: a
    served call launches K1 once (the RPN) and K2 once (the box head's
    80,000 candidates an image), and its detections equal the live eval
    fn's (labels and valid equal, boxes and scores within 1e-5)."""
    import os

    from paa_tpu_torch.config import get_cfg
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.serving import (
        export_inference, load_exported, save_exported)

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "e2e_faster_rcnn_R_50_FPN_1x.yaml"))
    cfg.freeze()
    model = build_detection_model(cfg, device=dev, seed=0)
    gen = torch.Generator().manual_seed(1)
    bias = model.module.box_head.cls_score.bias
    with torch.no_grad():
        bias[1:].copy_(torch.empty(bias.numel() - 1).uniform_(
            25.0, 35.0, generator=gen).to(dev))
    exported, meta = export_inference(model, 2, (256, 320))
    save_exported(str(tmp_path / "frcnn.paat"), exported, meta)
    call, _ = load_exported(str(tmp_path / "frcnn.paat"))
    images = (torch.rand(2, 256, 320, 3, generator=gen) * 4 - 2).to(dev)
    sizes = torch.tensor([[256.0, 320.0], [240.0, 300.0]], device=dev)
    live = model.make_eval_fn()(images, sizes)
    before = (nms.nms_batched.launches, nms._nms_global.launches)
    served = call(images, sizes)
    torch.cuda.synchronize()
    assert (nms.nms_batched.launches - before[0],
            nms._nms_global.launches - before[1]) == (1, 1)
    assert int(live["valid"].sum()) > 0
    for k in ("labels", "valid"):
        assert torch.equal(served[k], live[k]), k
    for k in ("boxes", "scores"):
        torch.testing.assert_close(served[k], live[k], rtol=0, atol=1e-5)


def test_fpn_pooler_queues_without_a_host_sync(dev):
    """The FPN pooler reaches the card with its level tables by
    non-blocking copies: under CUDA's sync debug mode "error" a call
    that copies and waits, or reads back, raises. Its pools equal the
    CPU's (float32, positions rounded alike; 1e-5 for the card's fused
    multiply-adds in the bilinear sums)."""
    from paa_tpu_torch.ops.roi_align import multilevel_roi_align

    gen = torch.Generator().manual_seed(0)
    features = [torch.randn(2, 8, 64 // s, 96 // s, generator=gen)
                for s in (1, 2, 4, 8)]
    xy = torch.rand(40, 2, generator=gen) * torch.tensor([320.0, 200.0])
    rois = torch.cat([xy, xy + 4 + torch.rand(40, 2, generator=gen) * 600],
                     1)
    batch_idx = torch.arange(40) % 2
    want = multilevel_roi_align(features, rois, batch_idx)
    args = ([f.to(dev) for f in features], rois.to(dev), batch_idx.to(dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = multilevel_roi_align(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
