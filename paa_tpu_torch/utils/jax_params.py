"""Carry the JAX package's parameters across into the port's modules.

``load_jax_params(module, params, batch_stats=None)`` takes the flax
param tree as nested dicts of numpy arrays (``model.init(...)["params"]``
after ``np.asarray``), and the ``batch_stats`` tree of a SyncBN model
beside it, and fills the port's module. The port's submodules carry
the flax scope names (``backbone.resnet.stem.conv1``,
``head.cls_tower.gn0``, ``head.scale3``, ...), so the walk is
mechanical; only the leaves change form:

- a conv ``kernel`` (kh, kw, cin/groups, cout) becomes ``weight``
  (cout, cin/groups, kh, kw); ``bias`` stays ``bias``;
- a ``DeformConv`` keeps its sampled conv's ``kernel`` (and ``bias``)
  beside a child conv ``offset`` (flax's ``conv2/{kernel, offset/{kernel,
  bias}}``): the kernel becomes ``weight`` as a conv's, and ``offset``
  is walked as a conv;
- a transposed conv's ``kernel`` (kh, kw, cin, cout) becomes
  ``ConvTranspose.weight`` (cin, cout, kh, kw) flipped in space: flax's
  ``nn.ConvTranspose`` (``transpose_kernel=False``, 2x2, stride 2,
  'SAME') computes out[2i + a] = x[i] K[1 - a], torch's out[2i + a] =
  x[i] W[a];
- a dense ``kernel`` (in, out) becomes ``Linear.weight`` (out, in). The
  box head's fc6 reads ROI features flattened in (7, 7, C) order in both
  packages (ops/roi_align.py pools them channels-last; the Xconv head
  flattens its NCHW convs' output in that order too), so its rows need
  no other permutation; a dense layer without a bias (the GN box heads'
  fc6/fc7) has none on either side;
- GroupNorm's ``gn/scale`` and ``gn/bias`` become ``weight`` and ``bias``
  (the heads' ``*_gn`` scopes, and a GN body's ``bnX`` and
  ``downsample_bn``, which are GroupNorm32 in the port too);
- FrozenBatchNorm's ``weight``, ``bias``, ``running_mean`` and
  ``running_var`` fill the buffers of the same names;
- SyncBatchNorm's ``bn/scale`` and ``bn/bias`` become ``weight`` and
  ``bias``, and its ``bn/mean`` and ``bn/var`` of the ``batch_stats``
  tree (MODEL.USE_SYNCBN) ``running_mean`` and ``running_var``;
- ``Scale``'s ``scale`` becomes a scalar.

It is strict: every leaf must be used, every port parameter and buffer
set, and every shape agree; otherwise it raises.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..modeling.layers import (
    Conv, ConvTranspose, DeformConv, FrozenBatchNorm, GroupNorm32, Linear,
    Scale, SyncBatchNorm)


def _leaves(mod, tree, stats, path):
    """(port tensor name, numpy value) pairs for one leaf module; ``stats``
    is its subtree of ``batch_stats`` (None where there is none)."""
    def keys(expected, tree=tree, where=path):
        if set(tree) != set(expected):
            raise KeyError(
                f"{where}: JAX leaves {sorted(tree)} vs port "
                f"{sorted(expected)}")

    if isinstance(mod, (Conv, DeformConv)):
        children = ["offset"] if isinstance(mod, DeformConv) else []
        keys(["kernel"] + (["bias"] if mod.bias is not None else [])
             + children)
        out = [("weight", np.transpose(tree["kernel"], (3, 2, 0, 1)))]
        if mod.bias is not None:
            out.append(("bias", tree["bias"]))
        out += [(f"{c}.{name}", value) for c in children
                for name, value in _leaves(mod.offset, tree[c], None,
                                           f"{path}/{c}")]
        return out
    if isinstance(mod, ConvTranspose):
        keys(["kernel", "bias"])
        return [("weight", np.ascontiguousarray(np.transpose(
            tree["kernel"], (2, 3, 0, 1))[:, :, ::-1, ::-1])),
                ("bias", tree["bias"])]
    if isinstance(mod, Linear):
        has_bias = mod.bias is not None
        keys(["kernel"] + (["bias"] if has_bias else []))
        return [("weight", np.transpose(tree["kernel"]))] + (
            [("bias", tree["bias"])] if has_bias else [])
    if isinstance(mod, FrozenBatchNorm):
        names = ["weight", "bias", "running_mean", "running_var"]
        keys(names)
        return [(n, tree[n]) for n in names]
    if isinstance(mod, SyncBatchNorm):
        keys(["bn"])
        keys(["scale", "bias"], tree["bn"], f"{path}/bn")
        if stats is None:
            raise KeyError(f"{path}: a SyncBatchNorm needs its batch_stats")
        keys(["bn"], stats, f"batch_stats {path}")
        keys(["mean", "var"], stats["bn"], f"batch_stats {path}/bn")
        return [("weight", tree["bn"]["scale"]), ("bias", tree["bn"]["bias"]),
                ("running_mean", stats["bn"]["mean"]),
                ("running_var", stats["bn"]["var"])]
    if isinstance(mod, GroupNorm32):
        keys(["gn"])
        gn = tree["gn"]
        if set(gn) != {"scale", "bias"}:
            raise KeyError(f"{path}/gn: JAX leaves {sorted(gn)}")
        return [("weight", gn["scale"]), ("bias", gn["bias"])]
    if isinstance(mod, Scale):
        keys(["scale"])
        return [("scale", tree["scale"])]
    return None


def load_jax_params(module, params, batch_stats=None):
    """Fill ``module`` from the flax param tree ``params`` and, for a
    SyncBN model, its ``batch_stats`` tree; see the module docstring for
    the mapping. Returns ``module``."""
    state = module.state_dict(keep_vars=True)
    filled = set()

    def visit(mod, tree, stats, prefix):
        path = prefix.rstrip(".") or "<root>"
        leaves = _leaves(mod, tree, stats, path)
        if leaves is None:
            for key in (stats or {}):
                if key not in tree:
                    raise KeyError(f"JAX batch_stats {prefix}{key} has no "
                                   f"param subtree")
            for key, sub in tree.items():
                child = mod._modules.get(key)
                if child is None or not isinstance(sub, Mapping):
                    raise KeyError(
                        f"JAX param {prefix}{key} has no counterpart in the "
                        f"port's {type(mod).__name__}"
                    )
                visit(child, sub, (stats or {}).get(key), f"{prefix}{key}.")
            return
        for name, value in leaves:
            target = state[prefix + name]
            value = np.asarray(value, dtype=np.float32)
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"{prefix}{name}: JAX shape {value.shape} vs port "
                    f"{tuple(target.shape)}"
                )
            with torch.no_grad():
                target.copy_(torch.from_numpy(value))
            filled.add(prefix + name)

    visit(module, params, batch_stats, "")
    missing = sorted(set(state) - filled)
    if missing:
        raise KeyError(f"port tensors without a JAX param: {missing}")
    return module
