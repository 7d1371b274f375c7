from .build import make_lr_schedule, make_optimizer, param_labels, set_lr

__all__ = ["make_lr_schedule", "make_optimizer", "param_labels", "set_lr"]
