"""paa_tpu_torch: the PyTorch/CUDA port of paa_tpu for NVIDIA Hopper.

Module paths mirror ``paa_tpu`` so each counterpart is easy to find.
The package imports torch, numpy and yaml, and nothing of JAX or of the
JAX package. Every Pallas kernel of the JAX package that the port has
reached is a kernel written by hand for the card (``ops/``), beside its
plain PyTorch version, which CPU tensors take.
"""

__version__ = "0.1.0"
