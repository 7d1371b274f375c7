#!/usr/bin/env python
"""Package build for paa_tpu.

Plays the role of the reference's setup.py (reference setup.py:27-63
builds the paa_core._C CUDA/C++ extension): here the only native piece
is the COCO evaluation kernel (paa_tpu/csrc/cocoeval.cpp), compiled to a
plain shared library consumed over ctypes (pybind11 is deliberately not
required). The library also self-builds lazily on first use
(paa_tpu/evaluation/_native.py), so installing without a toolchain still
works — evaluation then falls back to numpy.
"""

import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class build_py_with_native(build_py):
    def run(self):
        here = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(here, "paa_tpu", "csrc", "cocoeval.cpp")
        out = os.path.join(here, "paa_tpu", "csrc", "_cocoeval.so")
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", out, src],
                check=True,
            )
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"warning: native cocoeval build skipped ({e}); "
                  "numpy fallback will be used")
        super().run()


setup(
    name="paa_tpu",
    version="0.2.0",
    description=(
        "TPU-native detection framework: PAA/ATSS/FCOS/RetinaNet and "
        "Faster/Mask/Keypoint R-CNN in JAX/Flax with Pallas kernels"
    ),
    packages=find_packages(
        include=["paa_tpu", "paa_tpu.*", "paa_tpu_torch", "paa_tpu_torch.*"]
    ),
    package_data={
        "paa_tpu": ["csrc/*.cpp", "csrc/*.so"],
        # the PyTorch port's CUDA sources, built with nvcc at first use
        "paa_tpu_torch": ["csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy",
        "opencv-python-headless", "pyyaml",
    ],
    cmdclass={"build_py": build_py_with_native},
)
