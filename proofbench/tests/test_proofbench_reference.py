"""The plain reference accepts the program's proofs and rejects a flipped
byte in a commitment, a round polynomial or an opening, and a proof of
another input (the control)."""

import pytest

from proofbench import generate
from proofbench.provers import shout_bits, twist_bits
from proofbench.reference import pst

from . import tiny

PROVERS = {"twist_bits": (twist_bits, tiny.MEMORY),
           "shout_bits": (shout_bits, tiny.LOOKUP)}


@pytest.fixture(scope="module")
def proofs():
    from tnsh_torch.core.params import setup_params

    pp = setup_params(4)[0]
    out = {}
    for name, (mod, traffic) in PROVERS.items():
        inp = generate.make_inputs(traffic, {"log_k": 3}, 2 ** 31 + 3)[0]
        data = mod.to_bytes(mod.prove(mod.program_input(inp), pp, "cpu",
                                      None))
        out[name] = (mod, inp, data)
    return out


def _offsets(name: str, data: bytes) -> dict:
    """Byte offsets of the first commitment, the first round polynomial's
    first coefficient and the last opening quotient."""
    n_cols = 2 * 3 + 4 if name == "twist_bits" else 3 + 1
    first_round = 32 + 32 * n_cols + 16 + 8
    return {"commitment": 32 + 5, "round_polynomial": first_round + 3,
            "opening": len(data) - 20}


def _judge(mod, inp, data):
    return mod.judge(data, mod.columns(inp), pst.srs_taus(6))


@pytest.mark.parametrize("name", sorted(PROVERS))
def test_accepts_the_program_proof(proofs, name):
    assert _judge(*proofs[name]) == []


@pytest.mark.parametrize("where", ["commitment", "round_polynomial",
                                   "opening"])
@pytest.mark.parametrize("name", sorted(PROVERS))
def test_rejects_a_flipped_byte(proofs, name, where):
    mod, inp, data = proofs[name]
    bad = bytearray(data)
    bad[_offsets(name, data)[where]] ^= 0x04
    failed = _judge(mod, inp, bytes(bad))
    assert failed
    want = {"commitment": "commitment_0", "round_polynomial": "phase_a",
            "opening": "opening_"}[where]
    assert any(f.startswith(want) or f.startswith("wire") for f in failed)


@pytest.mark.parametrize("name", sorted(PROVERS))
def test_rejects_a_proof_of_another_input(proofs, name):
    """The control: the program proves an input that differs from the
    judged one in one operation."""
    from tnsh_torch.core.params import setup_params

    mod, inp, _ = proofs[name]
    other = generate.make_inputs(PROVERS[name][1], {"log_k": 3},
                                 2 ** 31 + 3)[0]
    if name == "twist_bits":
        other.value[0] += 1
    else:
        other.index[0] = (other.index[0] + 1) % 8
    data = mod.to_bytes(mod.prove(mod.program_input(other),
                                  setup_params(4)[0], "cpu", None))
    failed = _judge(mod, inp, data)
    assert any(f.startswith("commitment") for f in failed)
    assert any(f.startswith("value_rj") for f in failed)


def test_reference_needs_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); "
            "import proofbench.reference.twist_bits, "
            "proofbench.reference.shout_bits; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'tnsh_torch', 'tnsh', 'jax', 'jaxlib', 'torch', 'numpy'}); "
            "print(bad); sys.exit(1 if bad else 0)" % tiny.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
