"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``paa_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edit rebuilds and an unchanged
source is loaded from ``paa_tpu_torch/_build/`` (listed in
.gitignore). ``-fmad=false`` keeps every ``a*b+c`` as a rounded
multiply and a rounded add: the NMS kernels' integer outputs must equal
their plain PyTorch version, and a fused multiply-add moves a
borderline IoU across the threshold. No source includes PyTorch's
headers, so a build takes seconds.

``load_host`` does the same for a host-only ``csrc/<name>.cpp`` (the
COCO matcher, evaluation/_native.py) with ``g++``. A failed build of
either raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of paa_tpu_torch are built "
            "on first use and need the CUDA toolkit"
        )
    return path


GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def _target(name, ext=".cu", flags=NVCC_FLAGS):
    """The source of ``name`` and its library, named by a hash of the
    source, the shared headers (csrc/*.cuh) and the flags."""
    src = os.path.join(CSRC, name + ext)
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def sources():
    return sorted(
        f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def build_all():
    """Compile every source that has no up-to-date library, one nvcc per
    source, in parallel. Returns {name: seconds spent building}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in sources():
        src, out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        jobs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ), tmp, out, time.perf_counter())
    spent = {}
    errors = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        spent[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log.decode()}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return spent


@functools.cache
def load(name):
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    _, out = _target(name)
    if not os.path.exists(out):
        build_all()
    return ctypes.CDLL(out)


@functools.cache
def load_host(name):
    """The ctypes handle of the host-only ``csrc/<name>.cpp``, built with
    g++ into ``_build/`` first if needed."""
    src, out = _target(name, ".cpp", GXX_FLAGS)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}.cpp:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(out)
