"""GroupNorm(32)+ReLU of the PyTorch port (plain version, which CPU
tensors take) against the JAX package's ``_gn_relu_reference`` and its
Pallas kernel K3 (``fused_group_norm_relu``, interpret mode on CPU),
on both sides of the JAX kernel's shape gate (H*W = 1280 takes the
kernel, H*W = 77 the reference). Tolerances: float32 within 1e-6
relative and 1e-6 absolute (unit-scale data; the two sides sum in
different orders, which moves outputs by a few float32 ulps); bfloat16
within one bf16 ulp of the larger magnitude, plus the same 1e-6 floor
for outputs near zero, where the float32 values before rounding differ
by more than a bf16 ulp of so small a number."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paa_tpu.ops.fused_gn import _gn_relu_reference, fused_group_norm_relu
from paa_tpu_torch.modeling.layers import GroupNorm32
from paa_tpu_torch.ops import group_norm as port_gn

C = 256


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(0.3, 1.2, shape).astype(np.float32)
    s = rng.uniform(0.5, 1.5, (C,)).astype(np.float32)
    b = rng.normal(0, 0.2, (C,)).astype(np.float32)
    return x, s, b


def _port(x_nhwc, s, b, dtype):
    x = torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2).contiguous()
    y = port_gn.group_norm_relu(x, torch.from_numpy(s), torch.from_numpy(b))
    assert y.dtype == dtype
    return y.permute(0, 2, 3, 1).to(torch.float32).numpy()


def _bf16_ulp(a):
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("hw", [(40, 32), (7, 11)])
def test_plain_matches_jax_f32(hw):
    x, s, b = _inputs((2, *hw, C), seed=hw[0])
    got = _port(x, s, b, torch.float32)
    for fn in (_gn_relu_reference, fused_group_norm_relu):
        want = np.asarray(fn(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                             32, 1e-5, True))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got == 0).any() and (got > 0).any()


@pytest.mark.parametrize("hw", [(40, 32), (7, 11)])
def test_plain_matches_jax_bf16(hw):
    x, s, b = _inputs((2, *hw, C), seed=hw[1])
    got = _port(x, s, b, torch.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    for fn in (_gn_relu_reference, fused_group_norm_relu):
        want = np.asarray(fn(xj, jnp.asarray(s), jnp.asarray(b), 32, 1e-5,
                             True).astype(jnp.float32))
        err = np.abs(got - want)
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(err <= ulp + 1e-6), err.max()


def test_group_norm32_module_uses_the_wrapper():
    x, s, b = _inputs((1, 5, 6, C), seed=3)
    mod = GroupNorm32(C)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(s))
        mod.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    before = port_gn.group_norm_relu.launches
    got = mod(xt).permute(0, 2, 3, 1).detach().numpy()
    assert port_gn.group_norm_relu.launches == before  # CPU: plain path
    want = np.asarray(_gn_relu_reference(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 32, 1e-5, True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bad_group_count_and_device_raise():
    w = torch.ones(C)
    with pytest.raises(ValueError, match="groups"):
        port_gn.group_norm_relu(torch.zeros(1, C, 2, 2), w, w, num_groups=30)
    with pytest.raises(ValueError, match="no kernel"):
        port_gn.group_norm_relu(torch.zeros(1, C, 2, 2, device="meta"), w, w)


# K3's launch from the shape alone (ops/group_norm.py::gn_plan): the
# five tower shapes of an 8 x 800 x 1344 batch in bf16 and f32
@pytest.mark.parametrize("hw,itemsize,cs,threads", [
    ((100, 168), 2, 8, 256), ((50, 84), 2, 2, 256), ((25, 42), 2, 1, 512),
    ((13, 21), 2, 1, 128), ((7, 11), 2, 1, 64),
    ((100, 168), 4, 15, 256), ((50, 84), 4, 4, 256), ((25, 42), 4, 1, 512),
    ((13, 21), 4, 1, 256), ((7, 11), 4, 1, 64),
])
def test_gn_plan_tower_shapes(hw, itemsize, cs, threads):
    plan = port_gn.gn_plan(8, 256, hw[0] * hw[1], 32, itemsize)
    assert (plan.cs, plan.threads, plan.resident) == (cs, threads, True)


@pytest.mark.parametrize("shape", [
    (8, 256, 100, 168), (8, 256, 7, 11), (1, 32, 2, 4), (3, 64, 5, 7),
    (1, 64, 101, 199), (2, 96, 17, 9), (1, 256, 192, 192),
    (1, 256, 200, 200), (5, 128, 1, 1), (1, 512, 64, 64),
])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_gn_plan_covers_each_group_within_its_limits(shape, itemsize):
    """The contract csrc/group_norm.cu relies on: the ranks' shares of a
    group cover it in whole 16-byte vectors with no rank left empty, the
    block is whole warps, and a resident share fits the shared memory it
    is given (and six such CTAs an SM's 228 KB)."""
    b, c, h, w = shape
    vec = 16 // itemsize
    ge = c // 32 * h * w
    plan = port_gn.gn_plan(b, c, h * w, 32, itemsize)
    assert 1 <= plan.cs <= port_gn.MAX_CLUSTER
    assert plan.cs * plan.share >= ge > (plan.cs - 1) * plan.share
    assert plan.cs == 1 or plan.share % vec == 0
    assert plan.threads <= port_gn.MAX_THREADS and plan.threads % 32 == 0
    assert plan.resident == (
        -(-ge * itemsize // port_gn.CTA_BYTES) <= port_gn.MAX_CLUSTER)
    if plan.resident:
        assert plan.smem_bytes >= 16 * (-(-plan.share // vec) + 1)
        assert 6 * (plan.smem_bytes + 1024) <= 228 * 1024
    else:
        assert plan.smem_bytes == 0
