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


# One channel per group (C=32) at 8 positions is the smallest group here.
# A group with (near) zero variance is left out: the folded affine
# x * a + (b - mean * a) of the kernel, like the TPU kernel's, then
# cancels two terms of size |x| * rsqrt(var + eps), a rounding effect.
@pytest.mark.parametrize("shape", [
    (1, 32, 2, 4), (2, 64, 3, 5), (2, 256, 7, 11), (1, 256, 40, 33),
    (3, 96, 17, 9),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernel_matches_plain(dev, shape, dtype):
    gen = torch.Generator().manual_seed(shape[2])
    x = (torch.randn(*shape, generator=gen) * 2 + 0.5).to(dev, dtype)
    c = shape[1]
    s = (torch.rand(c, generator=gen) + 0.5).to(dev)
    b = (torch.randn(c, generator=gen) * 0.3).to(dev)
    before = gn.group_norm_relu.launches
    got = gn.group_norm_relu(x, s, b).float()
    assert gn.group_norm_relu.launches == before + 1
    want = gn.group_norm_relu_plain(x, s, b).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        mag = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool(((got - want).abs() <= ulp + 1e-6).all())


def test_group_norm_kernel_refuses_channels_last(dev):
    x = torch.randn(2, 64, 4, 4, device=dev).to(
        memory_format=torch.channels_last)
    w = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="NCHW-contiguous"):
        gn.group_norm_relu(x, w, w)
