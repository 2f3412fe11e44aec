"""The port's device sum-check oracles against tnsh's host and JAX oracles.

Mirrors ``tests/test_jax_backend.py`` (degree-3 oracles) and the
generic-degree cases of ``tests/test_twist_bits.py``.  Proofs must be
identical: round polynomials, final evaluations and challenges, exact
(tolerance 0).  The JAX oracles run with their XLA twins swapped for the
same functions un-jitted, which keeps whole-function XLA compiles (tens
of seconds each on the CPU) out of this file.

Each package's oracles are driven by its own sum-check engine and
transcript (the port imports nothing of tnsh); the proofs are compared as
integers.
"""

import random

import pytest
import torch

from tnsh.core.transcript import Transcript
from tnsh.field.fr import MODULUS, Fr
from tnsh.iop.sumcheck import (
    JaxProductMLEOracle,
    JaxSumOfProductsOracle,
    ProductMLEOracle,
    SumCheck,
    SumOfProductsOracle,
)
from tnsh.iop.sumcheck_d import DenseSopOracleD, JaxSopOracleD, SumCheckD
from tnsh.poly import mle_jax
from tnsh.poly.mle import MultilinearExtension
from tnsh_torch.core.transcript import Transcript as PortTranscript
from tnsh_torch.errors import SumCheckError as PortSumCheckError
from tnsh_torch.iop.sumcheck import SumCheck as PortSumCheck
from tnsh_torch.iop.sumcheck import (
    TorchProductMLEOracle,
    TorchSumOfProductsOracle,
)
from tnsh_torch.iop.sumcheck_d import SumCheckD as PortSumCheckD
from tnsh_torch.iop.sumcheck_d import TorchSopOracleD

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

P = MODULUS


@pytest.fixture
def eager_jax(monkeypatch):
    """Route mle_jax's jitted XLA twins to their un-jitted bodies."""
    monkeypatch.setattr(mle_jax, "_fold_jit_xla", mle_jax.fold)
    monkeypatch.setattr(mle_jax, "_product_round_evals_jit_xla",
                        mle_jax.product_round_evals)
    monkeypatch.setattr(mle_jax, "_sop_round_evals_jit_xla",
                        mle_jax.sum_of_products_round_evals)
    monkeypatch.setattr(mle_jax, "_sop_round_evals_d_jit_xla",
                        mle_jax.sum_of_products_round_evals_d)


def _ints(proof):
    return ([[int(c) for c in rp] for rp in proof.round_polynomials],
            int(proof.final_evaluation))


@pytest.mark.parametrize("scale", [1, 0xC0FFEE])
def test_product_oracle_identical_proofs(scale, eager_jax):
    random.seed(31)
    n = 4
    evals_a = [Fr(random.randrange(P)) for _ in range(1 << n)]
    evals_b = [Fr(random.randrange(P)) for _ in range(1 << n)]
    mles = [MultilinearExtension.from_evaluations(e)
            for e in (evals_a, evals_b)]
    total = Fr(scale * sum(int(a) * int(b)
                           for a, b in zip(evals_a, evals_b)))
    sc = SumCheck(n, total)
    seed = bytes([42]) * 32
    host = sc.prove(ProductMLEOracle(mles, Fr(scale)), Transcript(seed))
    psc = PortSumCheck(n, total)
    port = psc.prove(TorchProductMLEOracle(mles, Fr(scale), device="cpu"),
                     PortTranscript(seed))
    assert _ints(port) == _ints(host)
    ok, _ = psc.verify(port, PortTranscript(seed))
    assert ok
    if scale == 1:
        # the JAX oracle leaves the scale out of its final evaluation, so
        # it matches the host oracle only at scale 1
        jax_proof = sc.prove(JaxProductMLEOracle(mles), Transcript(seed))
        assert _ints(port) == _ints(jax_proof)


def _sop_terms(case, size):
    """``mixed``: three tables, one of them boolean; ``shout_sound_j``: the
    ShoutSound j phase's six terms over five tables (eq_r, the folded
    one-hot ra_f, rv, eq_b, eq_o), ra_f twice in the booleanity term."""
    rnd = lambda: [random.randrange(P) for _ in range(size)]  # noqa: E731
    if case == "mixed":
        t1, t2 = rnd(), rnd()
        t3 = [random.randrange(2) for _ in range(size)]
        return [(1, [t1, t2, t3]), (P - 1, [t1, t3]), (7, [t2])]
    eq_r, ra_f, rv, eq_b, eq_o = rnd(), rnd(), rnd(), rnd(), rnd()
    c = [random.randrange(P) for _ in range(6)]
    return [(c[0], [eq_r, ra_f]), (c[1], [eq_r, rv]),
            (c[2], [eq_b, ra_f, ra_f]), (c[3], [eq_b, ra_f]),
            (c[4], [eq_o, ra_f]), (c[5], [eq_o])]


@pytest.mark.parametrize("case", ["mixed", "shout_sound_j"])
def test_sum_of_products_oracle_identical_proofs(case, eager_jax):
    random.seed(47)
    n = 4
    size = 1 << n
    terms = _sop_terms(case, size)
    total = Fr(sum(c * _prod(t[i] for t in tabs) for c, tabs in terms
                   for i in range(size)) % P)
    sc = SumCheck(n, total)
    seed = bytes([42]) * 32
    host = sc.prove(SumOfProductsOracle(n, terms), Transcript(seed))
    jax_proof = sc.prove(JaxSumOfProductsOracle(n, terms), Transcript(seed))
    psc = PortSumCheck(n, total)
    port = psc.prove(TorchSumOfProductsOracle(n, terms, device="cpu"),
                     PortTranscript(seed))
    assert _ints(port) == _ints(host) == _ints(jax_proof)
    ok, _ = psc.verify(port, PortTranscript(seed))
    assert ok


def _prod(values) -> int:
    out = 1
    for v in values:
        out = out * v % P
    return out


def test_sopd_oracle_identical_proofs(eager_jax):
    random.seed(55)
    n = 7
    size = 1 << n
    t1 = [random.randrange(P) for _ in range(size)]
    t2 = [random.randrange(2) for _ in range(size)]
    t3 = [random.randrange(P) for _ in range(size)]
    terms = [(3, [t1, t2, t3, t1, t2]), (P - 5, [t2, t3]), (7, [t1])]
    claim = DenseSopOracleD(n, terms).hypercube_sum()
    seed = bytes([13]) * 32
    degree = 5
    proofs = {}
    for name, oracle in (
        ("host", DenseSopOracleD(n, terms, degree=degree)),
        ("jax", JaxSopOracleD(n, terms, degree=degree)),
    ):
        proofs[name], _ = SumCheckD(n, claim, degree).prove_with_challenges(
            oracle, Transcript(seed))
    proofs["port"], _ = PortSumCheckD(
        n, claim, degree).prove_with_challenges(
            TorchSopOracleD(n, terms, degree=degree, device="cpu"),
            PortTranscript(seed))
    assert _ints(proofs["port"]) == _ints(proofs["host"]) == _ints(
        proofs["jax"])
    ok, _ = PortSumCheckD(n, claim, degree).verify(proofs["port"],
                                                   PortTranscript(seed))
    assert ok


def _twist_shaped_terms(seed, n):
    """A TwistBits-SHAPED term structure: many shared tables, a degree-6
    product, boolean columns, booleanity pairs."""
    random.seed(seed)
    size = 1 << n
    rnd = lambda: [random.randrange(P) for _ in range(size)]  # noqa: E731
    bit = lambda: [random.randrange(2) for _ in range(size)]  # noqa: E731
    eq1, eqs, eqb, v, rv = rnd(), rnd(), rnd(), rnd(), rnd()
    b1, b2, b3, ot = bit(), bit(), bit(), bit()
    return [
        (1, [eq1, ot, b1, b2, b3, v]),
        (P - 7, [eq1, rv]),
        (11, [eqs, ot, b1, b2, b3, rv]),
        (13, [eqb, b1, b1]), (P - 13, [eqb, b1]),
        (17, [eqb, ot, ot]), (P - 17, [eqb, ot]),
    ]


def test_sopd_oracle_twist_shaped_rounds_match(eager_jax):
    """Round by round against the dense and JAX oracles: evaluations
    after every bind, down to the final evaluation."""
    n, degree = 6, 7
    terms = _twist_shaped_terms(321, n)
    o_py = DenseSopOracleD(n, terms, degree=degree)
    o_jx = JaxSopOracleD(n, terms, degree=degree)
    o_t = TorchSopOracleD(n, terms, degree=degree, device="cpu")
    assert o_t.tables.shape == (len(o_py._tables), 8, 1 << n)
    for rd in range(n):
        e_t = [int(x) for x in o_t.round_evaluations(rd)]
        assert e_t == [int(x) for x in o_py.round_evaluations(rd)]
        if rd < 2:
            assert e_t == [int(x) for x in o_jx.round_evaluations(rd)]
        c = Fr(0xABCDEF0 + rd)
        o_py.bind(c)
        o_t.bind(c)
        if rd < 2:
            o_jx.bind(c)
    assert int(o_t.final_evaluation([])) == int(o_py.final_evaluation([]))


def test_sopd_oracle_takes_device_tables_and_dedups():
    """Tables may arrive already packed (the bits oracle's chi columns);
    a table passed twice by identity is stored once."""
    from tnsh_torch.field import limbs

    n = 5
    terms = _twist_shaped_terms(99, n)
    eq1 = terms[0][1][0]
    packed = limbs.pack(eq1, "cpu")
    swapped = [(c, [packed if t is eq1 else t for t in tabs])
               for c, tabs in terms]
    o_a = TorchSopOracleD(n, terms, degree=7, device="cpu")
    o_b = TorchSopOracleD(n, swapped, degree=7, device="cpu")
    assert o_b.tables.shape[0] == o_a.tables.shape[0] == 9
    for rd in range(n):
        assert o_a.round_evaluations(rd) == o_b.round_evaluations(rd)
        o_a.bind(Fr(rd + 5))
        o_b.bind(Fr(rd + 5))
    assert o_a.final_evaluation([]) == o_b.final_evaluation([])


def test_sopd_oracle_rejects_bad_terms():
    with pytest.raises(PortSumCheckError):
        TorchSopOracleD(3, [], device="cpu")
    with pytest.raises(PortSumCheckError):
        TorchSopOracleD(3, [(1, [[0] * 4])], device="cpu")
    with pytest.raises(PortSumCheckError):
        TorchSopOracleD(3, [(1, [[0] * 8, [1] * 8])], degree=1,
                        device="cpu")
