"""Strip the optimizer state from a checkpoint of the port (port of
tools/remove_solver_states.py), keeping the model's weights, the update
count and the ``extra`` dict; a smaller file to hand out.

    python -m paa_tpu_torch.tools.remove_solver_states CKPT [--out PATH]

CKPT is a file written by ``utils/checkpoint.py``'s ``Checkpointer``
(``model``, ``optimizer``, ``step``, ``extra``). The output (default
``<CKPT>_nosolver.pth``, a ``.pth`` suffix of CKPT replaced) has
``optimizer`` None: ``load_weights``, ``test_net --ckpt`` and the demo
read it, and a resume from it (``Checkpointer.load``) raises
``SolverStateStripped``. Touches no device.
"""

import argparse
import os


def stripped_path(path):
    """``<path>_nosolver.pth``, a ``.pth`` suffix of ``path`` replaced."""
    root, ext = os.path.splitext(path)
    return (root if ext == ".pth" else path) + "_nosolver.pth"


def remove_solver_states(path, out=None):
    """Write ``path`` without its optimizer state to ``out`` (default
    ``stripped_path(path)``); returns the output path."""
    import torch

    data = torch.load(path, map_location="cpu", weights_only=True)
    out = out or stripped_path(path)
    torch.save({"model": data["model"], "optimizer": None,
                "step": data["step"], "extra": data.get("extra", {})}, out)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="strip the optimizer state from a checkpoint")
    parser.add_argument("ckpt", help="a checkpoint file of the port")
    parser.add_argument("--out", default=None,
                        help="output path (default: <ckpt>_nosolver.pth)")
    args = parser.parse_args(argv)
    out = remove_solver_states(os.path.abspath(args.ckpt),
                               args.out and os.path.abspath(args.out))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
