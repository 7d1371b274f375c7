"""Registry (a copy of paa_tpu/utils/registry.py; reference
paa_core/utils/registry.py:9-45): a dict with decorator-style
registration, for backbone and head dispatch by name."""

from __future__ import annotations


def _register_generic(module_dict, module_name, module):
    assert module_name not in module_dict, module_name
    module_dict[module_name] = module


class Registry(dict):
    """
    e.g.:
        BACKBONES = Registry()

        @BACKBONES.register("R-50-FPN")
        def build_r50_fpn(cfg): ...

        # or direct:
        BACKBONES.register("R-50-FPN", build_r50_fpn)

    A name registers once; a second registration raises AssertionError.
    """

    def register(self, module_name, module=None):
        if module is not None:
            _register_generic(self, module_name, module)
            return module

        def register_fn(fn):
            _register_generic(self, module_name, fn)
            return fn

        return register_fn
