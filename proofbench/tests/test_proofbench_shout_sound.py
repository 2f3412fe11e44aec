"""ShoutSound's cell on the CPU: the plain reference judges the program's
proofs correct on the sparse path (K = 2^4, T = 2^10, the prover's own
choice there) and on the dense one (K = 2^3, T = 2^6), whose bytes are
the sparse path's; a run comes out not correct for the control, an
altered byte, a fold that leaves the state unchanged and a read value off
by one; and the reference's factorized values of ra are the multilinear
extension of the cube table made in full."""

import random
import time

import pytest

from proofbench import generate, harness
from proofbench.control import perturb
from proofbench.harness import Cell
from proofbench.provers import shout_sound
from proofbench.reference import pst
from proofbench.reference.curve import P

from . import tiny

SEED = 2 ** 31 + 29
#: path -> (log K, log T) at which the prover picks it by itself
SIZES = {"sparse": (4, 10), "dense": (3, 6)}


def _inputs(log_k, log_t):
    traffic = dict(tiny.LOOKUP, log_t=log_t, inputs=1)
    return generate.make_inputs(traffic, {"log_k": log_k}, SEED)[0]


def _cell() -> Cell:
    config = {"name": "shout_sound.k3", "prover": "shout_sound",
              "log_k": 3, "env": tiny.ENV}
    return Cell("shout_sound.tiny", {"chips": 1}, config, tiny.LOOKUP)


def _run():
    return harness.run_cell(_cell(), SEED, 1.0, False, "cpu",
                            time.perf_counter())


@pytest.fixture(scope="module")
def pp():
    from tnsh_torch.core.params import setup_params

    return setup_params(4)[0]


@pytest.fixture(scope="module")
def proofs(pp):
    """path -> (input, the program's proof bytes on the path it picks,
    the stages its prove timed)."""
    from tnsh_torch.utils.profiling import PhaseTimer

    out = {}
    for path, (log_k, log_t) in SIZES.items():
        inp = _inputs(log_k, log_t)
        timer = PhaseTimer()
        out[path] = (inp, shout_sound.to_bytes(shout_sound.prove(
            shout_sound.program_input(inp), pp, "cpu", timer)),
            set(timer.phases))
    return out


def _judge(inp, data):
    log_t = (len(inp.index) - 1).bit_length()
    return shout_sound.judge(data, shout_sound.columns(inp),
                             pst.srs_taus(log_t))


@pytest.mark.parametrize("path", sorted(SIZES))
def test_program_proof_is_correct(proofs, path):
    inp, data, stages = proofs[path]
    # the path is the prover's own choice at this size
    assert ("k_rounds" in stages) == (path == "sparse")
    assert ("cube_build" in stages) == (path == "dense")
    assert _judge(inp, data) == []


def test_both_paths_give_the_same_bytes(proofs, pp):
    from tnsh_torch.protocols.sound import ShoutSound

    inp, data, _ = proofs["dense"]
    sparse = ShoutSound.prove(shout_sound.program_input(inp), pp, "cpu",
                              None, sparse=True)
    assert ShoutSound.to_bytes(sparse) == data


def _read_value_off(monkeypatch):
    from tnsh_torch.protocols import sound

    columns = sound._lookup_columns

    def off(ops, entries, t_size):
        for j, (idx, val) in enumerate(columns(ops, entries, t_size)):
            yield idx, (val + (j == 0)) % P

    monkeypatch.setattr(sound, "_lookup_columns", off)


def _unchanged_fold(monkeypatch):
    from tnsh_torch.field import fr_kernels

    monkeypatch.setattr(fr_kernels, "fold", lambda tables, r: tables[
        ..., : tables.shape[-1] // 2].contiguous())


def _altered_byte(monkeypatch):
    to_bytes = shout_sound.to_bytes

    def altered(proof):
        data = bytearray(to_bytes(proof))
        data[len(data) // 2] ^= 0x01
        return bytes(data)

    monkeypatch.setattr(shout_sound, "to_bytes", altered)


def _control(monkeypatch):
    program_input = shout_sound.program_input
    monkeypatch.setattr(shout_sound, "program_input",
                        lambda inp: program_input(perturb(inp)))


FAULTS = {"control": _control, "altered_byte": _altered_byte,
          "read_value_off": _read_value_off,
          "fold_unchanged": _unchanged_fold}


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out
    assert out["failed"] == 0
    assert out["checks"]["proofs_judged"]["value"] >= 1


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_are_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = _run()
    assert not out["correct"], out
    checks = out["checks"]
    assert (checks["failed_checks"]["value"]
            + checks["failed_proves"]["value"]) >= 1


def test_factorized_values_equal_dense_mle():
    """ra made in full over the 2^(3 + 6) cube (index j K + k) and rv over
    the cycles, from the input, against the reference's slot sums."""
    log_k, log_t = SIZES["dense"]
    inp = _inputs(log_k, log_t)
    k_size, t_size = 1 << log_k, 1 << log_t
    slots = list(inp.index) + [0] * (t_size - len(inp.index))
    ra = [0] * (k_size * t_size)
    for j, a in enumerate(slots):
        ra[j * k_size + a] = 1
    rv = [inp.entries[a] for a in slots]
    cols = shout_sound.columns(inp)
    rng = random.Random(5)
    for point in (pst.srs_taus(log_k + log_t),
                  [rng.randrange(P) for _ in range(log_k + log_t)]):
        assert cols.cube_at(point) == [pst.mle(ra, point)]
    assert cols.at_cube_tau() == [pst.mle(ra, pst.srs_taus(log_k + log_t))]
    for point in (pst.srs_taus(log_t),
                  [rng.randrange(P) for _ in range(log_t)]):
        assert cols.at_eq(pst.eq_table(point)) == [pst.mle(rv, point)]
