"""The port's hand-written kernels against their plain PyTorch versions on
an NVIDIA GPU, at small and edge shapes (chip_smoke.py covers the main
path's shapes). Every test needs a card and skips without one. The file
imports neither JAX nor the JAX package, so on a machine without JAX it
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
    args = _nms_case(0, 1, 9000, dev)
    with pytest.raises(ValueError, match="shared memory"):
        nms.nms_batched(*args, 0.6, 10)
    args[2] = args[2].to(torch.int64)
    with pytest.raises(TypeError, match="labels"):
        nms.nms_batched(*_nms_case(0, 1, 10, dev)[:2], args[2][:, :10],
                        args[3][:, :10], 0.6, 10)


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
