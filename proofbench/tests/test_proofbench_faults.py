"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell of this benchmark can have, and the control (the
program proving another input than the one judged) too.  The harness's
look for a card is skipped: the runs are on the CPU at a tiny size.  The
cells run on one card, so there is no exchange between chips to leave
out."""

import time

import pytest

from proofbench import harness
from proofbench.provers import shout_bits, twist_bits

from . import tiny

SEED = 2 ** 31 + 11


def run(cell):
    return harness.run_cell(cell, SEED, 1.0, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("prover", ["twist_bits", "shout_bits"])
def test_sound_run_is_correct(prover):
    out = run(tiny.cell(prover))
    assert out["correct"], out
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["proofs_judged"]["value"] >= 1
    assert list(out)[-1] == "checks"


def test_fold_that_leaves_the_state_unchanged(monkeypatch):
    from tnsh_torch.field import fr_kernels

    monkeypatch.setattr(fr_kernels, "fold", lambda tables, r: tables[
        ..., : tables.shape[-1] // 2].contiguous())
    out = run(tiny.cell())
    assert not out["correct"]
    assert out["checks"]["failed_proves"]["value"] >= 1


def test_half_of_the_trace_left_out(monkeypatch):
    from tnsh_torch.protocols.twist_bits import MemoryTrace

    prove = twist_bits.prove

    def half(trace, pp, device, timer):
        cut = MemoryTrace(trace.memory_size)
        cut.operations = trace.operations[: len(trace.operations) // 2]
        return prove(cut, pp, device, timer)

    monkeypatch.setattr(twist_bits, "prove", half)
    out = run(tiny.cell())
    assert not out["correct"]
    assert out["checks"]["failed_checks"]["value"] >= 1


@pytest.mark.parametrize("prover", [twist_bits, shout_bits])
def test_answer_altered_where_produced(monkeypatch, prover):
    to_bytes = prover.to_bytes

    def altered(proof):
        data = bytearray(to_bytes(proof))
        data[len(data) // 2] ^= 0x01
        return bytes(data)

    monkeypatch.setattr(prover, "to_bytes", altered)
    out = run(tiny.cell(prover.__name__.rsplit(".", 1)[1]))
    assert not out["correct"]


@pytest.mark.parametrize("prover", [twist_bits, shout_bits])
def test_control_proves_another_input(monkeypatch, prover):
    from proofbench.control import perturb

    program_input = prover.program_input
    monkeypatch.setattr(prover, "program_input",
                        lambda inp: program_input(perturb(inp)))
    out = run(tiny.cell(prover.__name__.rsplit(".", 1)[1]))
    assert not out["correct"]
    assert out["checks"]["failed_checks"]["value"] >= 2


def test_traced_run_reads_its_trace():
    out = harness.run_cell(tiny.cell(), SEED, 1.0, True, "cpu",
                           time.perf_counter())
    assert out["correct"], out
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"
