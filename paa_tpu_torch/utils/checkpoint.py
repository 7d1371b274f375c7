"""Checkpoints with the reference's pointer-file semantics (port of
paa_tpu/utils/checkpoint.py; reference paa_core/utils/checkpoint.py:
13-141).

``save(name, state, **extra)`` writes the module's state_dict, the
optimizer's state (momentum buffers, groups), the update count and
``extra`` (the iteration) to ``save_dir/name`` with ``torch.save``, and
records ``name`` in the ``last_checkpoint`` file. ``load(state)`` with
no path resumes from that file; otherwise it loads the given path.
``load_weights(module, path)`` restores only the module's weights, for
evaluation. A checkpoint whose optimizer state
tools/remove_solver_states.py stripped loads through ``load_weights``;
``load`` (a resume) raises ``SolverStateStripped`` on it.

Under a process group only the main process writes, and a
``DistributedDataParallel`` module is saved as the module inside it, so
a checkpoint has no ``module.`` prefix and loads into one process;
every rank loads.
"""

from __future__ import annotations

import os

import torch

from .comm import is_main_process, unwrap


class SolverStateStripped(RuntimeError):
    """A resume from a checkpoint that holds no optimizer state."""


class Checkpointer:
    def __init__(self, save_dir="", save_to_disk=True, logger=None):
        self.save_dir = save_dir
        self.save_to_disk = save_to_disk
        self.logger = logger

    def _log(self, msg):
        if self.logger:
            self.logger.info(msg)

    def save(self, name, state, **extra):
        if not (self.save_dir and self.save_to_disk and is_main_process()):
            return
        path = os.path.abspath(os.path.join(self.save_dir, name))
        self._log(f"Saving checkpoint to {path}")
        torch.save({"model": unwrap(state.module).state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step, "extra": dict(extra)}, path)
        self.tag_last_checkpoint(name)

    def has_checkpoint(self):
        return os.path.exists(os.path.join(self.save_dir, "last_checkpoint"))

    def get_checkpoint_file(self):
        try:
            with open(os.path.join(self.save_dir, "last_checkpoint")) as f:
                return f.read().strip()
        except OSError:
            return ""

    def tag_last_checkpoint(self, name):
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(name)

    def load(self, state, path=None):
        """Restore a checkpoint into ``state`` (module, optimizer, step) in
        place. Returns its ``extra`` dict, or {} when there is nothing to
        load."""
        if not path:
            if not self.has_checkpoint():
                self._log("No checkpoint found. Initializing model from "
                          "scratch")
                return {}
            path = os.path.join(self.save_dir, self.get_checkpoint_file())
        path = os.path.abspath(path)
        self._log(f"Loading checkpoint from {path}")
        module = unwrap(state.module)
        device = next(module.parameters()).device
        data = torch.load(path, map_location=device, weights_only=True)
        if data.get("optimizer") is None:
            raise SolverStateStripped(
                f"{path} holds no optimizer state (stripped by "
                f"tools/remove_solver_states.py): a resume needs a full "
                f"checkpoint; load_weights reads this one for evaluation")
        module.load_state_dict(data["model"])
        state.optimizer.load_state_dict(data["optimizer"])
        state.step = data["step"]
        return data["extra"]


def load_weights(module, path):
    """Load the module weights of a checkpoint written by
    ``Checkpointer.save`` into ``module``; returns the checkpoint's
    ``extra`` dict."""
    device = next(module.parameters()).device
    data = torch.load(path, map_location=device, weights_only=True)
    module.load_state_dict(data["model"])
    return data["extra"]
