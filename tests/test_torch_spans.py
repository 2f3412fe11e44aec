"""``PhaseTimer``'s spans on the CPU: a prove's phases and child spans form
one tree under the timer, name the host parts of ``commit``, ``open``,
``j_build`` and the k phase, add up to ``phases``, fence exactly as the
phases alone did, and appear under ``torch.profiler`` as annotations of
the same names and nesting; ``msm_digits`` counts the plans' digits and
``j_scan_lanes`` TwistBits' j-phase Val scan; the proof bytes stay
tnsh's.

T = 2^11, so the column commitments and each opening's largest quotient
MSM take the device route (1024 points or more, their plain versions on
CPU tensors) and the rest the host MSM; under the profiler, which records
every plain operation, T = 2^6."""

import json
import random
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tnsh.core.params import setup_params as ref_setup_params
from tnsh.core.proof_io import shout_bits_proof_to_bytes as ref_shout_bytes
from tnsh.core.proof_io import twist_bits_proof_to_bytes as ref_twist_bytes
from tnsh.field.fr import Fr as RefFr
from tnsh.protocols.shout import LookupTable as RefLookupTable
from tnsh.protocols.twist import MemoryTrace as RefMemoryTrace
from tnsh.protocols.twist_bits import ShoutBits as RefShoutBits
from tnsh.protocols.twist_bits import TwistBits as RefTwistBits
from tnsh_torch.commit import msm_sched
from tnsh_torch.core.params import setup_params
from tnsh_torch.field.fr import Fr
from tnsh_torch.protocols.shout import LookupTable
from tnsh_torch.protocols.twist import MemoryTrace
from tnsh_torch.protocols.twist_bits import ShoutBits, TwistBits
from tnsh_torch.utils import profiling
from tnsh_torch.utils.profiling import PhaseTimer

torch.set_num_threads(1)

LOG_T = 11

#: the child spans every bit-column prove at T = 2^11 opens on the CPU
#: (no ``wait``: a CPU MSM is computed where it is launched)
CHILD_SPANS = {"commit/marshal", "commit/plan", "commit/upload",
               "commit/launch", "commit/combine", "open/quotients",
               "open/plan", "open/upload", "open/launch", "open/combine",
               "open/host_msm", "oracle_a_build/marshal", "j_build/upload"}


def _twist(trace_cls, fr, log_t):
    rng = random.Random(5)
    tr = trace_cls(8)
    for i in range(1 << log_t):
        if i % 3 == 0:
            tr.write(rng.randrange(8), fr(42 * i + 1))
        else:
            tr.read(rng.randrange(8))
    return tr


def _shout(table_cls, fr, log_t):
    rng = random.Random(11)
    tbl = table_cls([fr(3 * i + 1) for i in range(8)])
    for _ in range((1 << log_t) - 1):
        tbl.lookup(rng.randrange(8))
    return tbl


#: (the port's proof bytes, tnsh's), each of (params, log T[, timer])
PROVERS = {
    "twist_bits": (lambda pp, log_t, timer: TwistBits.to_bytes(
        TwistBits.prove(_twist(MemoryTrace, Fr, log_t), pp, "cpu", timer)),
        lambda pp, log_t: ref_twist_bytes(RefTwistBits.prove(
            _twist(RefMemoryTrace, RefFr, log_t), pp))),
    "shout_bits": (lambda pp, log_t, timer: ShoutBits.to_bytes(
        ShoutBits.prove(_shout(LookupTable, Fr, log_t), pp, "cpu", timer)),
        lambda pp, log_t: ref_shout_bytes(RefShoutBits.prove(
            _shout(RefLookupTable, RefFr, log_t), pp))),
}


@pytest.fixture(scope="module", params=sorted(PROVERS))
def proved(request):
    """One prove, its fences counted and each MSM plan's non-zero digits
    recounted from the digits it was given."""
    prove, ref_prove = PROVERS[request.param]
    fences, digits = [], []
    real_fence, real_plan = PhaseTimer.fence, msm_sched.MsmPlan.__init__

    def fence(*values):
        fences.append(1)
        real_fence(*values)

    def plan(self, d, m, lanes):
        digits.append(int(np.count_nonzero(d)))
        real_plan(self, d, m, lanes)

    timer = PhaseTimer()
    with mock.patch.object(PhaseTimer, "fence", staticmethod(fence)), \
            mock.patch.object(msm_sched.MsmPlan, "__init__", plan):
        data = prove(setup_params(4)[0], LOG_T, timer)
    return SimpleNamespace(
        name=request.param, timer=timer, fences=len(fences), digits=digits,
        data=data,
        ref=lambda: ref_prove(ref_setup_params(4)[0], LOG_T))


def _annotations(prof, path):
    """(name, start, end) of each ``user_annotation`` event of a profile,
    in order of start, an enclosing event before those it encloses."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    notes = sorted((e["ts"], -e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
    return [(name, ts, ts - neg) for ts, neg, name in notes]


def test_spans_form_one_tree(proved):
    """Each span lies inside its parent, which opened before it; the
    top-level spans (parent None: the timer is the root) follow one
    another; every span is closed."""
    spans = proved.timer.spans
    assert spans and not proved.timer._open
    last_end = 0.0
    for i, sp in enumerate(spans):
        assert 0 < sp.start <= sp.end
        if sp.parent is None:
            assert sp.fenced and sp.start >= last_end
            last_end = sp.end
        else:
            up = spans[sp.parent]
            assert sp.parent < i
            assert up.start <= sp.start and sp.end <= up.end
            # a child span's name is its innermost phase's, then its own
            if not sp.fenced:
                while not up.fenced:
                    up = spans[up.parent]
                assert sp.name.startswith(up.name + "/")
        # the process CPU clock is read for phases only
        assert (sp.cpu_s >= 0) if sp.fenced else (sp.cpu_s is None)
        assert (sp.allocated is None) and (sp.max_allocated is None)


def test_spans_name_the_host_parts(proved):
    names = {sp.name for sp in proved.timer.spans}
    assert CHILD_SPANS <= names
    assert not any(n.endswith("/device") or n.endswith("/wait")
                   for n in names)


def test_spans_sum_to_phases(proved):
    """``phases``, ``counts`` and ``launches`` are the spans' sums, child
    spans included under their keys."""
    timer = proved.timer
    seconds, entries = {}, {}
    for sp in timer.spans:
        seconds[sp.name] = seconds.get(sp.name, 0.0) + sp.seconds
        entries[sp.name] = entries.get(sp.name, 0) + 1
    assert seconds.keys() == timer.phases.keys() == timer.counts.keys()
    for name, s in seconds.items():
        assert timer.phases[name] == pytest.approx(s, rel=1e-12, abs=1e-15)
        assert timer.counts[name] == entries[name]
        assert timer.launches[name] == {
            k: sum(sp.launches[k] for sp in timer.spans if sp.name == name)
            for k in timer.launches[name]}
    # the children of ``commit`` and ``open`` lie inside them
    for stage in ("commit", "open"):
        kids = sum(s for n, s in seconds.items()
                   if n.startswith(stage + "/"))
        assert 0 < kids <= seconds[stage]


def test_fences_two_per_phase_entry(proved):
    """Child spans add no fence: a prove fences twice a phase entry."""
    timer = proved.timer
    phases = [sp for sp in timer.spans if sp.fenced]
    assert len(phases) < len(timer.spans)
    assert proved.fences == 2 * len(phases)


@pytest.mark.parametrize("prover", sorted(PROVERS))
def test_spans_are_profiler_annotations(prover, tmp_path):
    """Under ``torch.profiler`` each span is a ``user_annotation`` event of
    its name, in the same order and nested as the spans are; the proof's
    bytes are tnsh's."""
    prove, ref_prove = PROVERS[prover]
    timer = PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        data = prove(setup_params(4)[0], 6, timer)
    assert data == ref_prove(ref_setup_params(4)[0], 6)
    spans, notes = timer.spans, _annotations(prof, tmp_path / "t.json")
    assert {"commit/host_msm", "open/host_msm"} <= {sp.name for sp in spans}
    assert [n for n, _, _ in notes] == [sp.name for sp in spans]
    for sp, (_, a, b) in zip(spans, notes):
        if sp.parent is not None:
            _, pa, pb = notes[sp.parent]
            assert pa <= a and b <= pb


def test_msm_digits_counts_the_plans(proved):
    """``msm_digits`` counts the plans' digits; the only other counter is
    TwistBits' ``j_scan_lanes``, T once a prove."""
    counters = proved.timer.counters
    if proved.name == "twist_bits":
        assert set(counters) == {"msm_digits", "j_scan_lanes"}
        assert counters["j_scan_lanes"] == 1 << LOG_T
    else:
        assert set(counters) == {"msm_digits"}
    assert counters["msm_digits"] == sum(proved.digits) > 0


def test_proof_bytes_unchanged(proved):
    assert proved.data == proved.ref()


def test_child_span_keys_and_counters():
    """A child span is timed under its innermost phase's name; one with no
    phase open under its own; listeners hear phases only; ``count`` adds
    to the innermost timer and to the totals, which a reset clears."""
    profiling.reset_launch_counts()
    timer, other = PhaseTimer(), PhaseTimer()
    heard = []
    timer.listeners.append(lambda name, s: heard.append(name))
    with timer.span("loose"):
        profiling.count("work", 1)
    with timer.phase("a"):
        with profiling.span("b"):
            with timer.span("c"):
                profiling.count("work", 2)
            with timer.phase("inner"):
                with profiling.span("d"):
                    pass
        with other.phase("x"):
            with profiling.span("y"):
                profiling.count("work", 4)
    profiling.count("work", 8)
    assert [(sp.name, sp.parent, sp.fenced) for sp in timer.spans] == [
        ("loose", None, False), ("a", None, True), ("a/b", 1, False),
        ("a/c", 2, False), ("inner", 2, True), ("inner/d", 4, False)]
    assert [sp.name for sp in other.spans] == ["x", "x/y"]
    assert heard == ["inner", "a"]
    assert timer.counters == {"work": 3} and other.counters == {"work": 4}
    assert profiling.counter_totals() == {"work": 15}
    profiling.reset_launch_counts()
    assert profiling.counter_totals() == {}


def test_span_without_a_timer_only_annotates(tmp_path):
    """With no timer open, ``profiling.span`` records nothing but its
    annotation."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("alone"):
            torch.zeros(4).sum()
    assert [n for n, _, _ in _annotations(prof, tmp_path / "t.json")] \
        == ["alone"]


def test_a_raising_span_closes():
    """A span that raises is closed and timed, and the next module-level
    span finds no timer open."""
    timer = PhaseTimer()
    with pytest.raises(ValueError):
        with timer.phase("p"):
            with profiling.span("s"):
                raise ValueError
    assert not timer._open
    assert timer.counts == {"p": 1, "p/s": 1}
    with profiling.span("after"):
        pass
    assert [sp.name for sp in timer.spans] == ["p", "p/s"]
