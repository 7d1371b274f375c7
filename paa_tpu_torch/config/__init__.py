from .cfg_node import CfgNode, CN
from .defaults import _C as cfg


def get_cfg():
    """Return a fresh, mutable copy of the default config tree."""
    return cfg.clone()


__all__ = ["CfgNode", "CN", "cfg", "get_cfg"]
