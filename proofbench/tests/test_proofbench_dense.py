"""The dense TwistBits cell (``twist_bits_dense.t14``) at a tiny size on the
CPU: the prover's dense stack against the plain cube of
``reference/cube.py``, a tiny dense cell run ``correct``, a fault in the
dense path read as not correct, and the cell's per-layer readers on a
traced window and on hand-made traces."""

import json
import random
import time

import pytest

from proofbench import generate, harness, roofline, trace
from proofbench.reference import cube

from . import tiny

SEED = 2 ** 31 + 23
LOG_K, LOG_T = 3, 6


def dense_cell(monkeypatch):
    """``tiny.cell()`` under TNSH_BITS_DENSE; the variable is restored when
    the test ends (``apply_env`` sets it for the run)."""
    monkeypatch.setenv("TNSH_BITS_DENSE", "1")
    cell = tiny.cell()
    cell.config = dict(cell.config, env=dict(tiny.ENV, TNSH_BITS_DENSE="1"))
    return cell


def run(cell):
    return harness.run_cell(cell, SEED, 1.0, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("seed,short", [
    (2 ** 31 + 101, 0), (2 ** 32 + 7, 0), (4100000005, 0),
    (2 ** 31 + 211, 5)], ids=["seed_a", "seed_b", "seed_c", "padded"])
def test_dense_stack_equals_plain_cube(seed, short, monkeypatch):
    """The stack a dense TwistBits prove builds, lane for lane, against
    the reference's tables from the trace and the prove's challenges
    (``short``: cycles left out, so the last ones are padding)."""
    from tnsh_torch.core.params import setup_params
    from tnsh_torch.field import limbs
    from tnsh_torch.protocols import twist_bits as tb

    from proofbench.provers import twist_bits

    monkeypatch.setenv("TNSH_BITS_DENSE", "1")
    inp = generate.memory(random.Random(seed), LOG_K, LOG_T, 3, 42)
    n = len(inp.addr) - short
    inp = generate.MemoryInput(LOG_K, inp.is_write[:n], inp.addr[:n],
                               inp.value[:n])
    seen = {}
    challenges, build = tb._challenges, tb._twist_cube

    def keep_challenges(*args):
        seen["challenges"] = challenges(*args)
        return seen["challenges"]

    def keep_stack(*args):
        stack, wbits = build(*args)
        seen["stack"] = [limbs.unpack(t) for t in stack]
        return stack, wbits

    monkeypatch.setattr(tb, "_challenges", keep_challenges)
    monkeypatch.setattr(tb, "_twist_cube", keep_stack)
    pp = setup_params(harness.TRANSCRIPT_PARAMS_LOG)[0]
    twist_bits.prove(twist_bits.program_input(inp), pp, "cpu", None)
    rho1, sigma, rhob, _ = seen["challenges"]
    want = cube.twist_tables(LOG_K, LOG_T, inp.is_write, inp.addr,
                             inp.value, [int(x) for x in rho1],
                             [int(x) for x in rhob], [int(x) for x in sigma])
    assert len(want) == 9 + 4 * LOG_K == len(seen["stack"])
    for f, (got, table) in enumerate(zip(seen["stack"], want)):
        assert [int(v) for v in got] == table, f


def test_reference_imports_nothing_of_the_program():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(cube))
    names = {a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0}
    assert not {m.split(".")[0] for m in names} & {"tnsh_torch", "tnsh",
                                                   "jax", "jaxlib", "torch"}


def test_tiny_dense_cell_is_correct(monkeypatch):
    from tnsh_torch.utils import profiling

    out = run(dense_cell(monkeypatch))
    assert out["correct"], out
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["proofs_judged"]["value"] >= 1
    # the window's proves took the dense path
    assert profiling.counter_totals()["cube_lanes"] == (
        out["attempted"] * (9 + 4 * LOG_K) << (LOG_K + LOG_T))


def test_val_cube_a_cycle_late_is_not_correct(monkeypatch):
    """V(k, j) shifted one cycle late (the value written at j, held from
    j + 1, is held from j + 2): phase A's sum is no longer 0, so the
    proves fail (the prover's own round check raises; the judge would
    reject the bytes)."""
    from tnsh_torch.protocols import twist_bits as tb

    val_cube = tb.val_cube

    def late(slot, waddr, wflag, wv):
        val_cube(slot, waddr, wflag, wv)
        planes = slot.view(slot.shape[0], waddr.shape[0], -1)
        planes[:, 1:] = planes[:, :-1].clone()
        planes[:, 0] = 0

    monkeypatch.setattr(tb, "val_cube", late)
    out = run(dense_cell(monkeypatch))
    assert not out["correct"]
    assert out["failed"] >= 1


def test_dense_readers_on_a_traced_window(monkeypatch):
    cell = dense_cell(monkeypatch)
    harness.apply_env(cell.config)
    session = harness.Session(cell, SEED, "cpu")
    session.setup()
    traced = harness.Run(cell, True)
    session.window(1.0, traced)
    values = {name: harness.metric_reader(name).read(traced)
              for name in ("stage_s.cube_build", "stage_s.cube_rounds",
                           "cube_build_roofline",
                           "cube_round_evals_roofline",
                           "cube_fold_roofline")}
    assert values["stage_s.cube_build"] > 0
    assert values["stage_s.cube_rounds"] > 0
    # no card clock and no device work on the CPU
    assert values["cube_build_roofline"] is None
    assert values["cube_round_evals_roofline"] is None
    assert values["cube_fold_roofline"] is None
    assert traced.timeline is not None and traced.timeline.stages
    assert sum(n == "cube_build" for n, _, _ in traced.timeline.stages) == (
        len(traced.stages))
    for stages in traced.stages:
        assert {f"cube_build/{s}" for s in ("columns", "lift", "chi", "val",
                                            "eq", "oracle")} <= set(stages)


def test_dense_readers_read_nothing_on_the_structured_path():
    from proofbench.tests.test_proofbench_readers import STAGES

    r = harness.Run(tiny.cell(), True, stages=STAGES, prove_s=[1.0, 1.0])
    for name in ("stage_s.cube_build", "stage_s.cube_rounds",
                 "cube_build_roofline", "cube_round_evals_roofline",
                 "cube_fold_roofline"):
        assert harness.metric_reader(name).read(r) is None, name


#: two dense proves on the trace's clock (microseconds): prove 0 over
#: 1000..5000 with its cube built over 1000..2000, prove 1 over 6000..9000
#: with its cube built over 6000..6500; the host clock is the trace's less
#: 1000 us
BUILD_EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "proofbench.prove.0",
     "ts": 1000.0, "dur": 4000.0},
    {"ph": "X", "cat": "user_annotation", "name": "proofbench.prove.1",
     "ts": 6000.0, "dur": 3000.0},
    # 1100..1300 busy (two kernels overlap), and 50 us of a copy that runs
    # past the build's end
    {"ph": "X", "cat": "kernel", "name": "lift_kernel", "ts": 1100.0,
     "dur": 150.0},
    {"ph": "X", "cat": "kernel", "name": "chi_kernel", "ts": 1200.0,
     "dur": 100.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1950.0,
     "dur": 100.0},
    # the rounds, outside any build
    {"ph": "X", "cat": "kernel", "name": "fr_round_evals_kernel",
     "ts": 2500.0, "dur": 1000.0},
    {"ph": "X", "cat": "kernel", "name": "eq_kernel", "ts": 6100.0,
     "dur": 250.0},
]
BUILD_MARKS = [
    (0, 0.0, 0.004, [("cube_build", 0.0, 0.001),
                     ("k_rounds", 0.001, 0.004)]),
    (1, 0.005, 0.008, [("cube_build", 0.005, 0.0055),
                       ("k_rounds", 0.0055, 0.008)]),
]


def traced_run(tmp_path, events, marks, **kw):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    cell = tiny.cell()
    cell.config = dict(cell.config, log_k=10)
    return harness.Run(cell, True, timeline=trace.Timeline.load(str(path),
                                                                marks),
                       clock_hz=1.98e9, **kw)


def test_cube_build_roofline_reads_the_device_inside_the_builds(
        tmp_path, monkeypatch):
    """The writes' least time over the device's busy time inside the
    ``cube_build`` stages: 200 + 50 + 250 us, overlaps counted once and the
    rounds' kernel outside the builds left out."""
    from tnsh_torch.utils import profiling

    r = traced_run(tmp_path, BUILD_EVENTS, BUILD_MARKS)
    lanes = 2 * 49 << 14
    monkeypatch.setattr(profiling, "counter_totals",
                        lambda: {"cube_lanes": lanes})
    reader = harness.metric_reader("cube_build_roofline")
    assert reader.read(r) == pytest.approx(
        100 * lanes * 32 / roofline.HBM_BYTES_PER_S / 500e-6)
    # a program without the counter, or a window with no device work
    monkeypatch.setattr(profiling, "counter_totals", lambda: {})
    assert reader.read(r) is None
    monkeypatch.setattr(profiling, "counter_totals",
                        lambda: {"cube_lanes": lanes})
    r.timeline.device = []
    assert reader.read(r) is None


def test_cube_kernel_rooflines_read_as_the_accepted_ones(tmp_path):
    from proofbench.tests import test_proofbench_readers as readers

    r = traced_run(tmp_path, readers.EVENTS, readers.MARKS,
                   launch_shapes=readers.SHAPES)
    for new, old in (("cube_fold_roofline", "fold_roofline"),
                     ("cube_round_evals_roofline", "round_evals_roofline")):
        got = harness.metric_reader(new).read(r)
        assert got is not None
        assert got == harness.metric_reader(old).read(r), new
