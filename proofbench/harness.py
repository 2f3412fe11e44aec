"""One run of one cell: set-up, the measured window, the check that decides
``correct``, and the metrics.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own under ``proofbench/``, found by name:

  * ``workloads/<cell>.json``: the configuration and traffic it pairs, and
    how many of its proofs the reference judges (``judge_max``);
  * ``configs/<config>.json``: the deployment: the prover (an adapter in
    ``provers/<prover>.py``), K = 2^log_k, the environment the program
    runs under;
  * ``traffic/<mix>.json``: the parameters ``generate.py`` reads;
  * ``metrics/<metric>.py``: a reader ``read(run)`` of one metric, which
    returns ``None`` where it finds nothing to read.

``BENCHMARK.json`` says which metrics a cell reports: the end-to-end ones
without ``--trace`` and the per-layer ones with it, each where its
``workloads`` list names the cell or where it has no such list.

The window is a closed loop with one client, a prover node: it proves the
cell's inputs one after another, cycling through them, each with a fresh
``PhaseTimer`` (the one the prover would make for itself), and serialises
each proof.  It starts no prove that the window's remaining seconds cannot
hold at the last prove's pace; the first always starts.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import random
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
#: where a traced run writes its profiler trace (inside the checkout)
OUT_DIR = os.path.join(ROOT, "build", "proofbench")
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "tnsh")
#: log T of the warm-up prove at set-up: its commitments and openings take
#: the MSM kernels (1024 points or more), so every kernel and library loads
WARMUP_LOG_T = 11
#: the provers read only the transcript seed of ``setup_params``, the same
#: at every size, so a small univariate SRS serves
TRANSCRIPT_PARAMS_LOG = 4


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def prover_module(name: str):
    return importlib.import_module(f"proofbench.provers.{name}")


def metric_reader(name: str):
    """The module of ``metrics/<name>.py`` (a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "proofbench_metric_" + name.replace(".", "_"),
        os.path.join(BENCH, "metrics", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict

    @classmethod
    def load(cls, name: str) -> "Cell":
        workload = load_json("workloads", name)
        return cls(name, workload, load_json("configs", workload["config"]),
                   load_json("traffic", workload["traffic"]))


@dataclass
class Run:
    """What a run measured: the metric readers read this."""

    cell: Cell
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    #: each completed prove's wall seconds, in window order
    prove_s: List[float] = field(default_factory=list)
    #: each completed prove's PhaseTimer phases (seconds by stage)
    stages: List[Dict[str, float]] = field(default_factory=list)
    #: torch.cuda.max_memory_allocated over the window, reset at its start
    peak_bytes: Optional[int] = None
    #: the sum-check kernels' launches over the window, by input shape
    launch_shapes: Dict[str, Dict[tuple, int]] = field(default_factory=dict)
    #: the traced window's device timeline (trace runs only)
    timeline: Optional[object] = None
    #: the SM clock the operation bound assumes, Hz (trace runs only)
    clock_hz: Optional[float] = None


def apply_env(config: dict) -> None:
    """Set the environment the configuration states (null: unset)."""
    for key, val in config.get("env", {}).items():
        if val is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(val)


def sm_clock_hz() -> Optional[float]:
    """The card's highest SM clock as nvidia-smi reports it."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.strip().splitlines()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Session:
    """A cell's program state from set-up to the end of the window."""

    def __init__(self, cell: Cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.prover = prover_module(cell.config["prover"])
        self.inputs = []
        self.program_inputs = []
        self.proofs = []   # (input index, bytes)
        self.failures = []

    def setup(self) -> None:
        """Build or load the kernels and the engine, make the inputs from
        the seed, build the SRS and put it on the card, and warm up."""
        import torch

        from tnsh_torch import _build
        from tnsh_torch.commit.mkzg import (
            MultilinearKZG,
            setup_multilinear_params,
        )
        from tnsh_torch.core.params import setup_params

        from . import generate

        cfg, traffic = self.cell.config, self.cell.traffic
        split, t0 = {}, time.perf_counter()

        def done(stage: str) -> None:
            nonlocal t0
            split[stage] = time.perf_counter() - t0
            t0 = time.perf_counter()

        if self.device != "cpu":
            _build.build_all()
        done("build")
        self.inputs = generate.make_inputs(traffic, cfg, self.seed)
        done("inputs")
        self.program_inputs = [self.prover.program_input(i)
                               for i in self.inputs]
        done("program_inputs")
        self.pp = setup_params(TRANSCRIPT_PARAMS_LOG)[0]
        params_t, _ = setup_multilinear_params(traffic["log_t"])
        done("srs")
        MultilinearKZG.prepare_device(params_t, self.device)
        done("srs_upload")
        if self.device != "cpu":
            # every kernel and library loaded once, on a small input drawn
            # apart from the cell's
            small = dict(traffic, log_t=WARMUP_LOG_T, inputs=1)
            inp = generate.make_inputs(small, cfg, 0)[0]
            params_w, _ = setup_multilinear_params(WARMUP_LOG_T)
            MultilinearKZG.prepare_device(params_w, self.device)
            self.prover.prove(self.prover.program_input(inp), self.pp,
                              self.device, None)
            torch.cuda.synchronize()
        gc.collect()
        done("warmup")
        print("setup split (s): " + json.dumps(split), file=sys.stderr)

    def window(self, seconds: float, run: Run) -> None:
        import torch

        from tnsh_torch.commit import kzg
        from tnsh_torch.utils.profiling import (
            PhaseTimer,
            launch_shapes,
            reset_launch_counts,
        )

        cuda = self.device != "cpu"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        kzg.reset_route_counts()
        hazards_before = kzg.hazard_count()
        profiler = _Profiler(cuda) if run.trace else None
        n = len(self.program_inputs)
        if profiler:
            profiler.start()
        t0 = time.perf_counter()
        last = 0.0
        i = 0
        while True:
            now = time.perf_counter() - t0
            if i and now + last > seconds:
                break
            k = i % n
            timer = PhaseTimer()
            spans = []
            timer.listeners.append(_stage_recorder(spans))
            start = time.perf_counter()
            try:
                with (profiler.annotate(i) if profiler
                      else contextlib.nullcontext()):
                    proof = self.prover.prove(self.program_inputs[k],
                                              self.pp, self.device, timer)
                    data = self.prover.to_bytes(proof)
                    del proof
            except Exception as exc:   # a failed prove is counted, not fatal
                self.failures.append(f"prove {i} (input {k}): {exc!r}")
                traceback.print_exc(file=sys.stderr)
            else:
                self.proofs.append((k, data))
                run.prove_s.append(time.perf_counter() - start)
                run.stages.append(dict(timer.phases))
            if profiler:
                profiler.mark(i, start, time.perf_counter(), spans)
            last = time.perf_counter() - start
            i += 1
        if cuda:
            torch.cuda.synchronize()
        run.window_s = time.perf_counter() - t0
        self.attempted = i
        if profiler:
            profiler.stop()
        if cuda:
            run.peak_bytes = torch.cuda.max_memory_allocated()
        run.launch_shapes = launch_shapes()
        self.routes = kzg.route_counts()
        self.hazards = kzg.hazard_count() - hazards_before
        if profiler:
            run.timeline = profiler.timeline()
            run.clock_hz = sm_clock_hz()

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        import torch

        self.program_inputs = []
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()


def _stage_recorder(spans: list):
    """A PhaseTimer listener that keeps each stage's (name, start, end) on
    the host clock."""
    def record(name: str, seconds: float) -> None:
        end = time.perf_counter()
        spans.append((name, end - seconds, end))
    return record


class _Profiler:
    """torch.profiler over the window, with each prove annotated, and the
    host clock's spans of each prove's stages kept beside it."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.marks = []
        self.path = os.path.join(OUT_DIR, "trace.json")

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()
        os.makedirs(OUT_DIR, exist_ok=True)
        self.prof.export_chrome_trace(self.path)

    @staticmethod
    def annotate(i: int):
        from torch.profiler import record_function

        return record_function(f"proofbench.prove.{i}")

    def mark(self, i: int, start: float, end: float, spans) -> None:
        self.marks.append((i, start, end, spans))

    def timeline(self):
        from . import trace

        try:
            return trace.Timeline.load(self.path, self.marks)
        finally:
            os.remove(self.path)


def judge(session: Session, window_s: float) -> tuple:
    """Judge the window's proofs with the reference: every distinct (input,
    bytes) pair, or ``judge_max`` of them drawn from the seed.  A proof
    whose bytes equal one already judged for the same input has the same
    verdict.  Returns (the compared numbers, each beside its limit, the
    proofs the reference rejected)."""
    from .reference import pst

    cell = session.cell
    judge_max = cell.workload.get("judge_max")
    distinct = sorted(set(session.proofs))
    if judge_max is not None and len(distinct) > judge_max:
        distinct = sorted(random.Random(session.seed).sample(distinct,
                                                             judge_max))
    taus = pst.srs_taus(cell.traffic["log_t"])
    eq_tau = pst.eq_table(taus)
    failed_checks, judged, rejected, notes = 0, 0, 0, []
    columns = {}   # the input judged last: its columns and their values at tau
    t0 = time.perf_counter()
    for k, data in distinct:
        if k not in columns:
            cols = session.prover.columns(session.inputs[k])
            columns = {k: (cols, cols.at_eq(eq_tau))}
        cols, at_tau = columns[k]
        bad = session.prover.judge(data, cols, taus, at_tau)
        judged += 1
        failed_checks += len(bad)
        if bad:
            rejected += 1
            notes.append(f"input {k}: {', '.join(bad[:8])}")
    checks = {
        "failed_checks": {"value": failed_checks, "limit": 0, "rule": "<="},
        "failed_proves": {"value": len(session.failures), "limit": 0,
                          "rule": "<="},
        "proofs_judged": {"value": judged, "limit": 1, "rule": ">="},
    }
    for note in notes + session.failures:
        print(f"check: {note}", file=sys.stderr)
    print(f"check: judged {judged} proofs in "
          f"{time.perf_counter() - t0:.3f} s (window {window_s:.3f} s)",
          file=sys.stderr)
    return checks, rejected


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if c["rule"] == "<="
               else c["value"] >= c["limit"] for c in checks.values())


def metric_specs(trace: bool, cell: str) -> List[dict]:
    """The metrics of BENCHMARK.json that this run reports."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    specs = bench["per_layer" if trace else "end_to_end"]
    return [m for m in specs if cell in m.get("workloads", [cell])]


def read_metrics(run: Run, specs: List[dict]) -> dict:
    out = {}
    for spec in specs:
        value = metric_reader(spec["name"]).read(run)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, started: float) -> dict:
    """One run; returns the result line's object.  ``started``: the host
    clock when the process started (set-up counts from it)."""
    apply_env(cell.config)
    specs = metric_specs(trace, cell.name)
    session = Session(cell, seed, device)
    session.setup()
    run = Run(cell, trace)
    run.setup_s = time.perf_counter() - started
    session.window(seconds, run)
    print(json.dumps({"counters": {
        "msm_routes": session.routes, "hazards": session.hazards,
        "launches_by_shape": {k: {"x".join(map(str, s)): n
                                  for s, n in v.items()}
                              for k, v in run.launch_shapes.items() if v}}}),
        flush=True)
    print("prove seconds: " + json.dumps(run.prove_s), file=sys.stderr)
    print("stages: " + json.dumps([{k: round(v, 4) for k, v in st.items()
                                    if "/" not in k} for st in run.stages]),
          file=sys.stderr)
    session.release()
    checks, rejected = judge(session, run.window_s)
    result = {
        "correct": passes(checks),
        "attempted": session.attempted,
        "failed": len(session.failures) + rejected,
        "metrics": read_metrics(run, specs),
        "device": device_info(device, cell, run),
    }
    if trace and run.timeline is not None:
        result["breakdown"] = run.timeline.breakdown()
    result["checks"] = checks
    return result


def device_info(device: str, cell: Cell, run: Run) -> dict:
    import torch

    if device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell.workload.get("chips", 1),
                "memory_peak_bytes": run.peak_bytes}
    if run.timeline is not None:
        info["busy_s"] = run.timeline.busy_s
        info["window_s"] = run.timeline.window_s
    return info


def print_checks(checks: dict) -> None:
    """Each compared number beside its limit, as the last lines of
    standard error."""
    for key, c in checks.items():
        print(f"{key} {c['value']} limit {c['rule']} {c['limit']}",
              file=sys.stderr, flush=True)

