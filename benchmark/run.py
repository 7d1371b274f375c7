"""Runs one cell of BENCHMARK.json once, on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Exits non-zero, printing no result, without a CUDA device or with fewer
than the cell asks for. See ``harness/main.py`` for what it prints.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root: the program (paa_tpu_torch) and this folder
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark.harness import cells, main as harness

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0), T0)


if __name__ == "__main__":
    sys.exit(main())
