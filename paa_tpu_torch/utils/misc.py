"""Small utilities of the CLIs (port of paa_tpu/utils/misc.py; reference
utils/{miscellaneous,collect_env,model_zoo}.py): the saved config, the
environment dump of the start-up log (torch, CUDA and the GPUs), and the
local weight cache of http(s) MODEL.WEIGHT urls, which reads no
network. ``find_contours`` waits for the mask head (ROADMAP item 10).
"""

from __future__ import annotations

import os


def save_config(cfg, path):
    """Write the merged config next to the run's outputs (reference
    train_net.py:172-175 output_config_path)."""
    with open(path, "w") as f:
        f.write(cfg.dump())


def collect_env_info() -> str:
    """The environment of the start-up log: python, torch and its CUDA
    build, the GPUs torch sees, numpy."""
    import platform
    import sys

    import numpy
    import torch

    lines = [
        f"python: {sys.version.split()[0]} ({platform.platform()})",
        f"torch: {torch.__version__} (CUDA build {torch.version.cuda})",
    ]
    if torch.cuda.is_available():
        lines += [f"cuda:{i}: {torch.cuda.get_device_name(i)}"
                  for i in range(torch.cuda.device_count())]
    else:
        lines.append("cuda: no device")
    lines.append(f"numpy: {numpy.__version__}")
    return "\n".join(lines)


def cache_url(url: str, model_dir: str | None = None) -> str:
    """The cached local file of an http(s) weight url (reference
    utils/model_zoo.py cache_url: the url's fragment or basename names
    the file; Detectron's shared ``model_final.pkl`` basenames take the
    url's path). Nothing is downloaded: the file must already be in the
    cache directory ($PAA_TPU_WEIGHTS_DIR, else $TORCH_HOME/models, else
    ~/.torch/models); a missing entry raises FileNotFoundError with the
    path it expected."""
    from urllib.parse import urlparse

    if model_dir is None:
        model_dir = os.environ.get(
            "PAA_TPU_WEIGHTS_DIR",
            os.path.join(
                os.path.expanduser(os.getenv("TORCH_HOME", "~/.torch")),
                "models",
            ),
        )
    parts = urlparse(url)
    filename = parts.fragment or os.path.basename(parts.path)
    if filename == "model_final.pkl":
        filename = parts.path.replace("/", "_")
    cached = os.path.join(model_dir, filename)
    if not os.path.exists(cached):
        raise FileNotFoundError(
            f"weight url {url} is not cached; place the file at {cached} "
            f"(nothing is downloaded)")
    return cached
