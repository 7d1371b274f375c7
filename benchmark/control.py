"""Reads the correctness control and the planted faults of a cell at its
own size on the card, for setting the cell's limits
(``limits/<cell>.json``); the benchmark's runs never run it:

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed ({fault: numbers}) and exits non-zero
without a CUDA device.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)

    import torch

    from benchmark.harness import cells, control

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    got = control.readings(cell, args.seeds, torch.device("cuda", 0),
                           lambda m: print(m, file=sys.stderr, flush=True))
    for seed, numbers in got.items():
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "readings": numbers}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
