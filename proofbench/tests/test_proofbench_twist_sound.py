"""TwistSound's cell on the CPU: the plain reference judges the program's
proofs correct on the sparse path (K = 2^4, T = 2^10, the prover's own
choice there) and on the dense one (K = 2^3, T = 2^6), whose bytes are
the sparse path's; a run comes out not correct for the control, an
altered byte, a witness with one increment off and a fold that leaves
the state unchanged; and the reference's factorized cube values are the
multilinear extensions of the cube tables made in full."""

import random
import time

import pytest

from proofbench import generate, harness
from proofbench.control import perturb
from proofbench.harness import Cell
from proofbench.provers import twist_sound
from proofbench.reference import pst
from proofbench.reference.curve import P

from . import tiny

SEED = 2 ** 31 + 17
#: path -> (log K, log T) at which the prover picks it by itself
SIZES = {"sparse": (4, 10), "dense": (3, 6)}


def _inputs(log_k, log_t):
    traffic = dict(tiny.MEMORY, log_t=log_t, inputs=1)
    return generate.make_inputs(traffic, {"log_k": log_k}, SEED)[0]


def _cell() -> Cell:
    config = {"name": "twist_sound.k3", "prover": "twist_sound",
              "log_k": 3, "env": tiny.ENV}
    return Cell("twist_sound.tiny", {"chips": 1}, config, tiny.MEMORY)


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
        out[path] = (inp, twist_sound.to_bytes(twist_sound.prove(
            twist_sound.program_input(inp), pp, "cpu", timer)),
            set(timer.phases))
    return out


def _judge(inp, data):
    log_t = (len(inp.addr) - 1).bit_length()
    return twist_sound.judge(data, twist_sound.columns(inp),
                             pst.srs_taus(log_t))


@pytest.mark.parametrize("path", sorted(SIZES))
def test_program_proof_is_correct(proofs, path):
    inp, data, stages = proofs[path]
    # the path is the prover's own choice at this size
    assert ("k_rounds" in stages) == (path == "sparse")
    assert ("cube_build" in stages) == (path == "dense")
    assert _judge(inp, data) == []


def test_both_paths_give_the_same_bytes(proofs, pp):
    from tnsh_torch.protocols.sound import TwistSound

    inp, data, _ = proofs["dense"]
    sparse = TwistSound.prove(twist_sound.program_input(inp), pp, "cpu",
                              None, sparse=True)
    assert TwistSound.to_bytes(sparse) == data


def _off_by_one_increment(monkeypatch):
    from tnsh_torch.protocols import sound

    witness = sound._twist_witness

    def off(ops, log_k, log_t):
        tables = witness(ops, log_k, log_t)
        inc = tables[2]
        j = next(j for j, col in enumerate(inc.cols) if col)
        k, v = inc.cols[j][0]
        inc.cols[j][0] = (k, (v + 1) % P)
        inc._csr = None
        return tables

    monkeypatch.setattr(sound, "_twist_witness", off)


def _unchanged_fold(monkeypatch):
    from tnsh_torch.field import fr_kernels

    monkeypatch.setattr(fr_kernels, "fold", lambda tables, r: tables[
        ..., : tables.shape[-1] // 2].contiguous())


def _altered_byte(monkeypatch):
    to_bytes = twist_sound.to_bytes

    def altered(proof):
        data = bytearray(to_bytes(proof))
        data[len(data) // 2] ^= 0x01
        return bytes(data)

    monkeypatch.setattr(twist_sound, "to_bytes", altered)


def _control(monkeypatch):
    program_input = twist_sound.program_input
    monkeypatch.setattr(twist_sound, "program_input",
                        lambda inp: program_input(perturb(inp)))


FAULTS = {"control": _control, "altered_byte": _altered_byte,
          "increment_off": _off_by_one_increment,
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


def test_factorized_cube_values_equal_dense_mle():
    """ra, wa, Inc and Val made in full over the 2^(3 + 6) cube (index j K
    + k) from the input, against the reference's sums over the cycles."""
    log_k, log_t = SIZES["dense"]
    inp = _inputs(log_k, log_t)
    k_size = 1 << log_k
    cube = {name: [0] * (k_size << log_t) for name in ("ra", "wa", "inc",
                                                       "val")}
    mem = [0] * k_size
    for j, (w, a, v) in enumerate(zip(inp.is_write, inp.addr, inp.value)):
        for k in range(k_size):
            cube["val"][j * k_size + k] = mem[k]
        if w:
            cube["wa"][j * k_size + a] = 1
            cube["inc"][j * k_size + a] = (v - mem[a]) % P
            mem[a] = v % P
        else:
            cube["ra"][j * k_size + a] = 1
    cols = twist_sound.columns(inp)
    rng = random.Random(5)
    for point in (pst.srs_taus(log_k + log_t),
                  [rng.randrange(P) for _ in range(log_k + log_t)]):
        want = [pst.mle(cube[name], point)
                for name in ("ra", "wa", "inc", "val")]
        assert cols.cube_at(point) == want
