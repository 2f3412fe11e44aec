"""Run one cell of the port's benchmark and print its result line.

    python3 proofbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The last line of standard output is the result (a JSON object); the
numbers that decided ``correct`` are the last lines of standard error.  A
run without a card, or with fewer than the cell needs, exits 2 and prints
no result; so does a run in which the JAX package or jax was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[0] = ROOT   # the checkout's root, not proofbench/
    from proofbench import harness

    cell = harness.Cell.load(args.workload)
    import torch

    chips = cell.workload.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: {args.workload} needs {chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", STARTED)
    found = harness.loaded_forbidden()
    if found:
        print(f"no result: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 2
    harness.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
