from .jax_params import load_jax_params

__all__ = ["load_jax_params"]
