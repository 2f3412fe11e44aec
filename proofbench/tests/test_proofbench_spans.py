"""``spans.Timeline`` on a small Chrome trace worked out by hand, the
metric readers of the program's child spans and counter, and
``span_report`` on a tiny cell on the CPU."""

import json

import pytest

from proofbench import harness, span_report, spans, trace

from . import test_proofbench_readers as recorded
from . import tiny

#: one prove over 0..1000 us: commit 100..400 (its plan 120..200), open
#: 500..900 (its wait 700..800).  The insertion kernel was launched in
#: commit/plan and runs in commit; the copy was launched in open and runs
#: in open/wait; one kernel has no launch in the trace.
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "proofbench.prove.0",
     "ts": 0.0, "dur": 1000.0, "tid": 1},
    {"ph": "X", "cat": "user_annotation", "name": "commit",
     "ts": 100.0, "dur": 300.0, "tid": 1},
    {"ph": "X", "cat": "user_annotation", "name": "commit/plan",
     "ts": 120.0, "dur": 80.0, "tid": 1},
    {"ph": "X", "cat": "user_annotation", "name": "open",
     "ts": 500.0, "dur": 400.0, "tid": 1},
    {"ph": "X", "cat": "user_annotation", "name": "open/wait",
     "ts": 700.0, "dur": 100.0, "tid": 1},
    {"ph": "X", "cat": "user_annotation", "name": "elsewhere",
     "ts": 600.0, "dur": 10.0, "tid": 2},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "ts": 150.0, "dur": 5.0, "args": {"correlation": 7}},
    {"ph": "X", "cat": "kernel", "name": "msm_insert_kernel",
     "ts": 300.0, "dur": 50.0, "args": {"correlation": 7}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
     "ts": 550.0, "dur": 5.0, "args": {"correlation": 8}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
     "ts": 720.0, "dur": 20.0, "args": {"correlation": 8}},
    {"ph": "X", "cat": "kernel", "name": "orphan_kernel",
     "ts": 950.0, "dur": 10.0, "args": {"correlation": 99}},
]


def _load(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return spans.Timeline.load(str(path))


def test_stage_spans_come_from_the_trace(tmp_path):
    tl = _load(tmp_path, EVENTS)
    assert (tl.start, tl.end, tl.proves) == (0.0, 1000.0, 1)
    assert tl.stages == [("commit", 100.0, 400.0),
                         ("commit/plan", 120.0, 200.0),
                         ("open", 500.0, 900.0),
                         ("open/wait", 700.0, 800.0)]


def test_gaps_split_at_span_boundaries(tmp_path):
    """The gap 0..300 crosses the prove's own time, commit and its plan;
    350..720 crosses commit, the prove, open and its wait: each piece is
    named by the span open over it and is no longer than that span."""
    tl = _load(tmp_path, EVENTS)
    assert [(n, a, b) for n, a, b in tl.idle_pieces()] == [
        ("prove", 0.0, 100.0), ("commit", 100.0, 120.0),
        ("commit/plan", 120.0, 200.0), ("commit", 200.0, 300.0),
        ("commit", 350.0, 400.0), ("prove", 400.0, 500.0),
        ("open", 500.0, 700.0), ("open/wait", 700.0, 720.0),
        ("open/wait", 740.0, 800.0), ("open", 800.0, 900.0),
        ("prove", 900.0, 950.0), ("prove", 960.0, 1000.0)]
    length = {n: b - a for n, a, b in tl.stages}
    length["prove"] = 1000.0
    for n, a, b in tl.idle_pieces():
        assert b - a <= length[n]
    idle = dict(tl.breakdown()["idle_by_span"])
    assert idle["commit"] == pytest.approx(170e-6)
    assert idle["open"] == pytest.approx(300e-6)


def test_device_ops_go_to_the_span_of_their_launch(tmp_path):
    tl = _load(tmp_path, EVENTS)
    by_span, rest = tl.device_by_span()
    assert by_span == {"commit/plan": pytest.approx(50e-6),
                       "open": pytest.approx(20e-6)}
    assert rest == pytest.approx(10e-6)
    out = tl.breakdown()
    assert out["device_unattributed_s"] == pytest.approx(10e-6)
    assert (sum(s for _, s in out["device_by_span"])
            + out["device_unattributed_s"]) == pytest.approx(
                out["device_op_s"])


def test_a_trace_without_a_prove_is_refused(tmp_path):
    with pytest.raises(RuntimeError, match="no prove annotation"):
        _load(tmp_path, EVENTS[1:])


def test_accepted_metrics_read_as_before(tmp_path):
    """On the recorded trace, with its stages as annotations in place of
    host-clock marks, every accepted metric reads what it read."""
    shift = 1000.0   # the recorded marks' host clock is the trace's less 1 ms
    notes = [{"ph": "X", "cat": "user_annotation", "name": n,
              "ts": a * 1e6 + shift, "dur": (b - a) * 1e6}
             for _, _, _, stages in recorded.MARKS for n, a, b in stages]
    path = tmp_path / "old.json"
    path.write_text(json.dumps({"traceEvents": recorded.EVENTS}))
    old = trace.Timeline.load(str(path), recorded.MARKS)
    new = _load(tmp_path, recorded.EVENTS + notes)
    assert new.stages == old.stages
    with open(harness.ROOT + "/BENCHMARK.json") as f:
        bench = json.load(f)
    cell = tiny.cell()
    cell.config = dict(cell.config, log_k=10)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    reads = []
    for tl in (old, new):
        run = harness.Run(cell, True, setup_s=12.5, window_s=9.0,
                          prove_s=[4.0, 3.0, 2.0], stages=recorded.STAGES,
                          peak_bytes=3 * 2 ** 30,
                          launch_shapes=recorded.SHAPES, timeline=tl,
                          clock_hz=1.98e9)
        reads.append({n: harness.metric_reader(n).read(run) for n in names
                      if n != "msm_digits"})
    assert reads[0] == reads[1]
    assert sum(v is not None for v in reads[0].values()) >= 13


#: two proves' PhaseTimer phases with the program's child spans
CHILD_STAGES = [
    {"commit": 3.0, "commit/marshal": 0.25, "commit/plan": 0.5,
     "commit/upload": 0.125, "commit/launch": 0.25, "commit/wait": 1.0,
     "commit/combine": 0.5, "open": 6.0, "open/evals": 1.0,
     "open/rlc": 2.0, "open/quotients": 0.5, "open/plan": 0.25,
     "open/upload": 0.125, "open/launch": 0.125, "open/wait": 0.5,
     "open/combine": 0.25, "open/host_msm": 0.5, "j_build": 4.0,
     "j_build/upload": 1.0, "oracle_a_build": 2.0,
     "oracle_a_build/marshal": 0.75},
    {"commit": 3.0, "commit/marshal": 0.75, "commit/plan": 0.5,
     "commit/upload": 0.125, "commit/launch": 0.75, "commit/wait": 1.0,
     "commit/combine": 0.5, "open": 4.0, "open/evals": 1.0,
     "open/rlc": 1.0, "open/quotients": 0.5, "open/plan": 0.25,
     "open/upload": 0.125, "open/launch": 0.125, "open/wait": 0.5,
     "open/combine": 0.25, "open/host_msm": 0.5, "j_build": 4.0,
     "j_build/upload": 2.0, "oracle_a_build": 2.0,
     "oracle_a_build/marshal": 0.25},
]


def test_child_span_readers():
    run = harness.Run(tiny.cell(), True, prove_s=[2.0, 2.0],
                      stages=CHILD_STAGES)
    want = {"stage_s.commit.marshal": 0.5, "stage_s.open.evals": 1.0,
            "stage_s.open.rlc": 1.5, "stage_s.open.quotients": 0.5,
            "stage_s.msm.plan": 0.75, "stage_s.msm.queue": 0.875,
            "stage_s.msm.wait": 1.5, "stage_s.msm.finish": 1.25,
            "stage_s.j_build.upload": 1.5, "stage_s.k_phase.marshal": 0.5}
    assert {n: harness.metric_reader(n).read(run) for n in want} == want


def test_child_span_readers_find_nothing_in_the_older_split():
    """The program before these spans timed ``commit/plan`` ... and
    ``commit/device``: the MSM readers read nothing there, nor any reader
    a span it lacks."""
    older = [{"commit": 3.0, "commit/plan": 0.5, "commit/upload": 0.1,
              "commit/device": 1.0, "commit/combine": 0.5, "open": 4.0,
              "open/plan": 0.2, "open/device": 0.5, "j_build": 4.0,
              "oracle_a_build": 2.0}]
    run = harness.Run(tiny.cell(), True, prove_s=[2.0], stages=older)
    for name in ("stage_s.commit.marshal", "stage_s.open.quotients",
                 "stage_s.msm.plan", "stage_s.msm.queue", "stage_s.msm.wait",
                 "stage_s.msm.finish", "stage_s.j_build.upload",
                 "stage_s.k_phase.marshal"):
        assert harness.metric_reader(name).read(run) is None, name


def test_msm_digits_reads_the_window_counter(monkeypatch):
    from tnsh_torch.utils import profiling

    reader = harness.metric_reader("msm_digits")
    run = harness.Run(tiny.cell(), True, prove_s=[2.0, 2.0, 2.0, 2.0])
    monkeypatch.setattr(profiling, "counter_totals",
                        lambda: {"msm_digits": 6_000_000})
    assert reader.read(run) == 1.5
    monkeypatch.setattr(profiling, "counter_totals", lambda: {})
    assert reader.read(run) is None
    monkeypatch.delattr(profiling, "counter_totals")
    assert reader.read(run) is None


@pytest.mark.parametrize("prover", ["twist_bits", "shout_bits"])
def test_span_report_on_a_tiny_cell(prover):
    """One prove of a tiny cell on the CPU: its spans, their self times
    and the trace's pieces, named by the same spans."""
    out, timers = span_report.report(tiny.cell(prover), 3, 0.0, "cpu")
    assert len(timers) == len(out["prove_s"]) == 1
    names = {sp.name for sp in timers[0].spans}
    assert {"commit", "open", "open/evals", "open/rlc", "commit/host_msm",
            "open/host_msm", "oracle_a_build/marshal"} <= names
    assert out["spans"].keys() == names
    for rec in out["spans"].values():
        assert 0 <= rec["self_s"] <= rec["wall_s"]
    assert out["peak_bytes"] == 0 and out["device"] == "cpu"
    pieces = {n for n, _ in out["breakdown"]["idle_by_span"]}
    assert pieces <= names | {"prove"}
    assert out["breakdown"]["device_op_s"] == 0
