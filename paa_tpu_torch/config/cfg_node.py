"""Minimal yacs-compatible configuration node.

The reference framework drives everything from a yacs ``CfgNode`` tree
(see reference paa_core/config/defaults.py and tools/train_net.py:157-159:
YAML merge + dotted-key CLI override list + freeze). yacs is not available
in this environment, so this is a small, behaviour-compatible replacement
supporting exactly the surface the framework uses:

- attribute access (``cfg.MODEL.PAA.TOPK``)
- ``merge_from_file(yaml_path)`` with type coercion and tuple-string parsing
- ``merge_from_list(["KEY.SUBKEY", value, ...])``
- ``freeze()`` / ``clone()`` / ``dump()``
"""

from __future__ import annotations

import ast
import copy
import io

import yaml


class CfgNode(dict):
    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        init_dict = init_dict or {}
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no attribute '{name}'")

    def __setattr__(self, name, value):
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set '{name}' on an immutable CfgNode"
            )
        self[name] = value

    def __setitem__(self, name, value):
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set '{name}' on an immutable CfgNode"
            )
        dict.__setitem__(self, name, value)

    # -- mutability --------------------------------------------------------
    def freeze(self):
        self._set_immutable(True)

    def defrost(self):
        self._set_immutable(False)

    def is_frozen(self):
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, flag):
        object.__setattr__(self, CfgNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    def clone(self):
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        node = CfgNode()
        memo[id(self)] = node
        for k, v in self.items():
            dict.__setitem__(node, k, copy.deepcopy(v, memo))
        object.__setattr__(node, CfgNode.IMMUTABLE, False)
        return node

    # -- merging -----------------------------------------------------------
    def merge_from_file(self, cfg_filename):
        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self._merge_dict(loaded, [])

    def merge_from_other_cfg(self, other):
        self._merge_dict(other, [])

    def _merge_dict(self, d, key_path):
        for k, v in d.items():
            full = ".".join(key_path + [k])
            if k not in self:
                raise KeyError(f"Non-existent config key: {full}")
            cur = self[k]
            if isinstance(cur, CfgNode):
                if not isinstance(v, dict):
                    raise ValueError(f"Cannot merge non-dict into node {full}")
                cur._merge_dict(v, key_path + [k])
            else:
                self[k] = _coerce(v, cur, full)

    def merge_from_list(self, opts):
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            parts = key.split(".")
            node = self
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], CfgNode):
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(value, node[leaf], key)

    # -- io ------------------------------------------------------------------
    def dump(self):
        def to_plain(node):
            out = {}
            for k, v in node.items():
                out[k] = to_plain(v) if isinstance(v, CfgNode) else v
            return out

        stream = io.StringIO()
        yaml.safe_dump(to_plain(self), stream, default_flow_style=False)
        return stream.getvalue()

    def __str__(self):
        return self.dump()

    def __repr__(self):
        return f"CfgNode({dict.__repr__(self)})"


def _coerce(value, reference, key):
    """Coerce ``value`` to the type of ``reference`` the way yacs does.

    Handles tuple-as-string YAML values like ``"(64, 128, 256)"`` that the
    reference configs use (e.g. configs/paa/paa_R_50_FPN_1x.yaml ANCHOR_SIZES).
    """
    if isinstance(value, str):
        try:
            parsed = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            parsed = value
        value = parsed

    if reference is None or value is None:
        return value
    ref_t, val_t = type(reference), type(value)
    if ref_t is val_t:
        return value
    # tuple/list interchange
    if isinstance(reference, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(reference, list) and isinstance(value, tuple):
        return list(value)
    # numeric promotions
    if isinstance(reference, float) and isinstance(value, int):
        return float(value)
    if isinstance(reference, bool) is not isinstance(value, bool) and (
        isinstance(reference, bool) or isinstance(value, bool)
    ):
        raise ValueError(f"Type mismatch for key {key}: {ref_t} vs {val_t}")
    if isinstance(reference, int) and isinstance(value, float) and value.is_integer():
        return int(value)
    raise ValueError(
        f"Type mismatch ({ref_t.__name__} vs {val_t.__name__}) for key {key}: {value!r}"
    )


CN = CfgNode
