"""The system under test, ``paa_tpu_torch``, as a user builds and calls
it: the configuration's keys merged into the package's defaults, the
model from ``build_detection_model``, the benchmark's weights loaded
into it, then ``make_eval_fn`` (serving) or ``make_bucket_train_step``
with the config's SGD (training). Nothing else of the package is used,
besides its kernel launch counters."""

from __future__ import annotations


def program_cfg(config):
    from paa_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_list([v for kv in config["cfg"].items() for v in kv])
    cfg.freeze()
    return cfg


def build_model(config, weights, device):
    """The configuration's model on ``device`` with ``weights`` loaded
    (every tensor of its state dict)."""
    from paa_tpu_torch.modeling import build_detection_model

    model = build_detection_model(program_cfg(config), device=device)
    model.module.load_state_dict(weights, strict=True)
    return model


def train_state(model):
    """The model's SGD train state (the config's parameter groups)."""
    from paa_tpu_torch.engine import TrainState
    from paa_tpu_torch.solver import make_optimizer

    return TrainState(model.module, make_optimizer(model.cfg,
                                                   model.module)[0])


def launch_counts():
    from paa_tpu_torch.ops import launch_counts as counts

    return counts()
