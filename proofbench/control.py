"""The control of the check that decides ``correct``, at a cell's own
size, on the card.

The cells state no precision; the guarantee they state is that a proof
binds its input.  The control breaks it: the program proves an input that
differs from the judged one in one operation (``perturb``: the first
write's value plus one, or the first lookup's slot moved by one), and the
reference judges that proof against the input the harness made.  For each
seed the program's own proof of the input is judged as well, so one run
gives both readings of each compared number: the sound one (the lower) and
the control's (the upper).

    python3 proofbench/control.py --workload <cell> --seeds 11,12,13

prints one JSON line a seed.  The benchmark's runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def perturb(inp):
    """A copy of ``inp`` that differs in one operation."""
    from array import array

    if hasattr(inp, "value"):
        value = array("q", inp.value)
        value[0] += 1
        return type(inp)(inp.log_k, inp.is_write, inp.addr, value)
    index = array("l", inp.index)
    index[0] = (index[0] + 1) % len(inp.entries)
    return type(inp)(inp.log_k, inp.entries, index)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of `correct`")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    import torch

    from proofbench import generate, harness
    from proofbench.reference import pst

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell.load(args.workload)
    harness.apply_env(cell.config)
    session = harness.Session(cell, 0, "cuda")
    cell.traffic = dict(cell.traffic, inputs=1)
    session.setup()
    prover, log_t = session.prover, cell.traffic["log_t"]
    taus = pst.srs_taus(log_t)
    eq_tau = pst.eq_table(taus)
    for seed in (int(s) for s in args.seeds.split(",")):
        inp = generate.make_inputs(cell.traffic, cell.config, seed)[0]
        cols = prover.columns(inp)
        at_tau = cols.at_eq(eq_tau)
        out = {"workload": cell.name, "seed": seed}
        for side, given in (("sound", inp), ("control", perturb(inp))):
            t0 = time.perf_counter()
            data = prover.to_bytes(prover.prove(
                prover.program_input(given), session.pp, "cuda", None))
            t1 = time.perf_counter()
            failed = prover.judge(data, cols, taus, at_tau)
            out[side] = {"failed_checks": len(failed), "prove_s": t1 - t0,
                         "judge_s": time.perf_counter() - t1,
                         "failed": failed[:12]}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
