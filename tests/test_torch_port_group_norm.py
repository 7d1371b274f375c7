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
