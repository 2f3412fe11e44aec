"""Where a cell's prove time goes, span by span, from one traced window:

    python3 proofbench/span_report.py --workload <cell> --seed <n> \
        --seconds <s> [--out <file.json>]

from the root of a checkout, on a machine with a card.  It sets the cell
up as ``run.py`` does, proves its inputs back to back under
``torch.profiler`` for ``--seconds`` (the first prove always), each with a
fresh ``PhaseTimer``, and prints one JSON object: each span name's mean
wall seconds a prove (process CPU seconds too, for a phase) and self time
(its seconds less its direct children's), every prove's stages, the
device memory each phase left allocated and the phase in which the
window's peak was reached, the work counters, and the trace's breakdown
by span (``spans.Timeline``).  ``--out`` also writes every span of every prove.
Nothing here decides ``correct``: the proofs are not judged.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def summarize(timers) -> dict:
    """The spans of each prove's timer, reduced to what the report
    prints."""
    n = len(timers)
    wall, cpu, own = {}, {}, {}
    proves = []
    for timer in timers:
        kids = [0.0] * len(timer.spans)
        for sp in timer.spans:
            if sp.parent is not None:
                kids[sp.parent] += sp.seconds
        stages = {}
        for sp, k in zip(timer.spans, kids):
            wall[sp.name] = wall.get(sp.name, 0.0) + sp.seconds / n
            if sp.cpu_s is not None:
                cpu[sp.name] = cpu.get(sp.name, 0.0) + sp.cpu_s / n
            own[sp.name] = own.get(sp.name, 0.0) + (sp.seconds - k) / n
            if sp.parent is None:
                wall_s, cpu_s = stages.get(sp.name, (0.0, 0.0))
                stages[sp.name] = (wall_s + sp.seconds, cpu_s + sp.cpu_s)
        proves.append({name: [w, c] for name, (w, c) in stages.items()})
    fenced = [sp for sp in timers[0].spans if sp.fenced] if timers else []
    peak = max((sp.max_allocated or 0 for t in timers for sp in t.spans),
               default=0)
    at_peak = [sp for t in timers for sp in t.spans
               if sp.fenced and sp.max_allocated == peak]
    reached = min(at_peak, key=lambda sp: sp.end).name if at_peak else None
    return {
        "spans": {name: {"wall_s": wall[name], "cpu_s": cpu.get(name),
                         "self_s": own[name]}
                  for name in sorted(wall, key=lambda k: -wall[k])},
        "proves": proves,
        "memory_first_prove": [[sp.name, sp.allocated, sp.max_allocated]
                               for sp in fenced],
        "peak_bytes": peak, "peak_reached_in": reached,
        "counters": [t.counters for t in timers],
    }


def report(cell, seed: int, seconds: float, device: str):
    """Set ``cell`` up on ``device`` and prove for ``seconds`` under the
    profiler: (the report, each prove's timer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from proofbench import harness, spans
    from tnsh_torch.utils.profiling import PhaseTimer

    cuda = device != "cpu"
    harness.apply_env(cell.config)
    session = harness.Session(cell, seed, device)
    session.setup()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    timers, prove_s = [], []
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))
    prof.start()
    t0 = time.perf_counter()
    last = 0.0
    while not timers or time.perf_counter() - t0 + last <= seconds:
        i = len(timers)
        timer = PhaseTimer()
        start = time.perf_counter()
        with record_function(f"{spans.PROVE}{i}"):
            proof = session.prover.prove(
                session.program_inputs[i % len(session.program_inputs)],
                session.pp, device, timer)
            session.prover.to_bytes(proof)
            del proof
        last = time.perf_counter() - start
        timers.append(timer)
        prove_s.append(last)
    if cuda:
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(harness.OUT_DIR, exist_ok=True)
    path = os.path.join(harness.OUT_DIR, "span_trace.json")
    prof.export_chrome_trace(path)
    try:
        timeline = spans.Timeline.load(path)
    finally:
        os.remove(path)
    return dict(summarize(timers), workload=cell.name, seed=seed,
                prove_s=prove_s, breakdown=timeline.breakdown(),
                busy_s=timeline.busy_s, window_s=timeline.window_s,
                device=torch.cuda.get_device_name(0) if cuda else "cpu"
                ), timers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    sys.path[0] = ROOT
    import torch

    from proofbench import harness

    if not torch.cuda.is_available():
        print("no result: needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out, timers = report(harness.Cell.load(args.workload), args.seed,
                         args.seconds, "cuda")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(out, every_span=[
                [[sp.name, sp.parent, sp.start, sp.end, sp.cpu_s,
                  sp.allocated, sp.max_allocated] for sp in t.spans]
                for t in timers]), f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
