"""Each metric reader on a small recorded profiler trace and PhaseTimer
stages, against values worked out by hand."""

import json

import pytest

from proofbench import harness, roofline, trace

from . import tiny

#: two proves on the trace's clock (microseconds): prove 0 over 1000..5000,
#: prove 1 over 6000..9000; the host clock is the trace's less 1000 us
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "proofbench.prove.0",
     "ts": 1000.0, "dur": 4000.0},
    {"ph": "X", "cat": "user_annotation", "name": "proofbench.prove.1",
     "ts": 6000.0, "dur": 3000.0},
    {"ph": "X", "cat": "kernel", "name": "fr_fold_kernel(int const*)",
     "ts": 1500.0, "dur": 100.0},
    {"ph": "X", "cat": "kernel",
     "name": "(anonymous namespace)::fr_fold_kernel(int const*)",
     "ts": 6500.0, "dur": 100.0},
    {"ph": "X", "cat": "kernel", "name": "fr_round_evals_kernel",
     "ts": 2000.0, "dur": 300.0},
    {"ph": "X", "cat": "kernel", "name": "fr_sum_partials_kernel",
     "ts": 2250.0, "dur": 100.0},
    {"ph": "X", "cat": "kernel", "name": "void msm_insert_kernel<32>()",
     "ts": 3000.0, "dur": 400.0},
    {"ph": "X", "cat": "kernel", "name": "msm_window_sums_kernel",
     "ts": 7000.0, "dur": 200.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
     "ts": 8000.0, "dur": 100.0},
    {"ph": "X", "cat": "kernel", "name": "outside_the_window",
     "ts": 9500.0, "dur": 100.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
     "ts": 1200.0, "dur": 50.0},
]
#: (prove, host start, host end, [(stage, host start, host end)]), seconds
MARKS = [
    (0, 0.0, 0.004, [("commit", 0.0, 0.0025), ("open", 0.0025, 0.004)]),
    (1, 0.005, 0.008, [("commit", 0.005, 0.0065), ("open", 0.0065, 0.008)]),
]
STAGES = [
    {"simulate": 1.0, "oracle_a_build": 2.0, "k_rounds": 1.5,
     "j_build": 4.0, "j_rounds": 0.25, "phase_b": 1.0, "commit": 3.0,
     "open": 6.0},
    {"simulate": 2.0, "oracle_a_build": 2.0, "k_rounds": 0.5,
     "j_build": 5.0, "j_rounds": 0.75, "commit": 4.0, "open": 5.0},
]
SHAPES = {"fold": {(49, 8, 1 << 20): 1, (13, 8, 1 << 20): 1},
          "sum_of_products_round_evals": {(49, 8, 1 << 20): 1}}


@pytest.fixture
def run(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    cell = tiny.cell()
    cell.config = dict(cell.config, log_k=10)
    r = harness.Run(cell, True, setup_s=12.5, window_s=9.0,
                    prove_s=[4.0, 3.0, 2.0], stages=STAGES,
                    peak_bytes=3 * 2 ** 30, launch_shapes=SHAPES,
                    timeline=trace.Timeline.load(str(path), MARKS),
                    clock_hz=1.98e9)
    return r


def read(name, run):
    return harness.metric_reader(name).read(run)


def test_end_to_end(run):
    assert read("setup_s", run) == 12.5
    assert read("prove_s", run) == 3.0
    assert read("peak_device_gib", run) == 3.0


def test_stages(run):
    assert read("stage_s.simulate", run) == 1.5
    assert read("stage_s.j_build", run) == 4.5
    assert read("stage_s.k_phase", run) == 3.0
    assert read("stage_s.rounds", run) == 1.0
    assert read("stage_s.commit", run) == 3.5
    assert read("stage_s.open", run) == 5.5


def test_timeline(run):
    tl = run.timeline
    assert tl.proves == 2
    assert tl.window_s == pytest.approx(8000e-6)
    # 100 + 100 + 350 (overlapping round kernels) + 400 + 200 + 100 us
    assert tl.busy_s == pytest.approx(1250e-6)
    assert read("device_idle_pct", run) == pytest.approx(
        100 * (1 - 1250 / 8000))
    assert read("device_ms.msm", run) == pytest.approx(0.3)
    # the longest gap, 3400..6500, has its middle in prove 0's open
    gaps = tl.breakdown()["idle_gaps"]
    assert gaps[0] == ["open", pytest.approx(3100e-6)]
    assert [g[0] for g in gaps[:4]] == ["open", "open", "open", "commit"]
    assert tl.stage_at(5500.0) == "between stages"
    ops = dict(tl.breakdown()["device_ops"])
    assert ops["void msm_insert_kernel<32>"] == pytest.approx(400e-6)
    assert ops["fr_fold_kernel"] == pytest.approx(200e-6)


def test_rooflines(run):
    fold = sum(roofline.least_s(*roofline.fold_work(f, 1 << 20), 1.98e9)
               for f in (49, 13))
    assert read("fold_roofline", run) == pytest.approx(100 * fold / 200e-6)
    rounds = roofline.least_s(*roofline.round_evals_work(49, 1 << 20, 14,
                                                         72), 1.98e9)
    assert read("round_evals_roofline", run) == pytest.approx(
        100 * rounds / 400e-6)


def test_nothing_to_read(run):
    run.timeline = None
    run.stages = [{"commit": 1.0}]
    for name in ("device_ms.msm", "fold_roofline", "round_evals_roofline",
                 "device_idle_pct", "stage_s.j_build", "stage_s.k_phase"):
        assert read(name, run) is None, name
