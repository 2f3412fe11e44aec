"""The port's parity Twist and Shout, with their univariate KZG, against
tnsh's: the frozen TWST / SHOT digests, byte-identical proofs in default
and sound mode, each package's verifier accepting the other's bytes, and
tampered proofs rejected, on the CPU (the plain PyTorch versions of the
kernels) and, marked ``cuda``, on the card at K=2^10.  Mirrors
``tests/test_twist.py``, ``tests/test_shout.py``, the KZG cases of
``tests/test_commitments.py`` and the frozen vectors of
``tests/test_golden_vectors.py``; also the benchmark command line and
the profiler trace.

The two packages share no objects: each gets its own trace, table,
parameters and native engine, and proofs cross over only as bytes.  The
small cases' MSMs are under ``kzg.DEVICE_MSM_MIN`` and run on the native
host MSM; one case at a 1024-entry table takes the device route (its plain
versions on the CPU)."""

import copy
import dataclasses
import hashlib
import os
import random
import subprocess
import sys
import time

import pytest
import torch

import tnsh
import tnsh_torch
from tnsh.commit import kzg as ref_kzg
from tnsh.core.params import setup_params as ref_setup_params
from tnsh.core.proof_io import (
    shout_proof_from_bytes as ref_shout_from_bytes,
    shout_proof_to_bytes as ref_shout_to_bytes,
    twist_proof_from_bytes as ref_twist_from_bytes,
    twist_proof_to_bytes as ref_twist_to_bytes,
)
from tnsh.core.serialize import g1_to_bytes as ref_g1_to_bytes
from tnsh.field.fr import Fr as RefFr
from tnsh.protocols.shout import LookupTable as RefLookupTable
from tnsh.protocols.shout import Shout as RefShout
from tnsh.protocols.twist import MemoryTrace as RefMemoryTrace
from tnsh.protocols.twist import Twist as RefTwist
from tnsh_torch.bench import cli
from tnsh_torch.bench.harness import ProtocolBenchmarks, benchmark_setup
from tnsh_torch.commit import kzg
from tnsh_torch.commit.kzg import (
    KZGCommitment,
    KZGVectorCommitment,
    barycentric_eval,
    compute_quotient_polynomial,
    evaluate_polynomial,
    lagrange_srs,
    polynomial_division,
    verify_openings_batched,
)
from tnsh_torch.core.params import NativeSRS, setup_params
from tnsh_torch.core.proof_io import (
    shout_proof_from_bytes,
    shout_proof_to_bytes,
    twist_proof_from_bytes,
    twist_proof_to_bytes,
)
from tnsh_torch.core.serialize import g1_to_bytes
from tnsh_torch.errors import (
    CommitmentError,
    InvalidParametersError,
    PolynomialError,
    SumCheckError,
)
from tnsh_torch.field.fr import MODULUS as P
from tnsh_torch.field.fr import Fr
from tnsh_torch.iop.sumcheck import TorchProductMLEOracle
from tnsh_torch.poly.interp import interpolate_on_range
from tnsh_torch.protocols.shout import LookupTable, Shout
from tnsh_torch.protocols.twist import MemoryTrace, Twist
from tnsh_torch.utils import profiling

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

#: size -> ((Twist length, sha256), (Shout length, sha256)) of the golden
#: trace and lookups (tests/test_golden_vectors.py, ``_PROOF_VECTORS``)
FROZEN = {
    4: ((528, "c5716ad1c6ddd41fa89494cd8fd49cc481a673ed3007e3da44d37ffbdc8d3ee0"),
        (528, "b3ac5d90d5356c8910fdb231ba3d3ea7e358e20c9e0426bd687d9685648c84e9")),
    8: ((664, "f005ef68d9e9840e1b190c0d1a3911d025e07b43f0d9134a74324a20c6f193f5"),
        (664, "95685f9ab9b298f31ee2e71cee018d3f8752f4914815ed7838bfbab974cd271f")),
    16: ((800, "f871ea9056e5f50103dd0da89a0df33411a8eea99b6a079575633b7265b2708e"),
         (800, "7ad98c9cee79c36bbde02c112ecced6406eb309905101d2b588370778eac141e")),
}


@pytest.fixture(scope="module")
def params():
    """((port pp, vp), (tnsh pp, vp)) from the same deterministic setup."""
    return setup_params(4), ref_setup_params(4)


def _traces(size, ops):
    """(port trace, tnsh trace) of the same operations: ``("w", cell,
    value)``, ``("r", cell)``, or ``("forged", cell, value)``, a read whose
    recorded value is ``value`` whatever the cell holds."""
    out = []
    for cls, fr in ((MemoryTrace, Fr), (RefMemoryTrace, RefFr)):
        tr = cls(size)
        for op in ops:
            if op[0] == "w":
                tr.write(op[1], fr(op[2]))
            elif op[0] == "r":
                tr.read(op[1])
            else:
                tr.operations.append(
                    type(tr.operations[0]).read(op[1], fr(op[2])))
        out.append(tr)
    return tuple(out)


def _tables(entries, lookups):
    """(port table, tnsh table) with the same entries and lookups."""
    out = []
    for cls, fr in ((LookupTable, Fr), (RefLookupTable, RefFr)):
        tbl = cls([fr(e) for e in entries])
        for i in lookups:
            tbl.lookup(i)
        out.append(tbl)
    return tuple(out)


def _golden_ops(size):
    ops = []
    for i in range(size // 2):
        ops += [("w", i % size, 42 * (i + 1)), ("r", i % size)]
    return ops


def _mixed_ops(size, n_ops, seed):
    rng = random.Random(seed)
    return [("w", rng.randrange(size), rng.randrange(P)) if i % 3 == 0
            else ("r", rng.randrange(size)) for i in range(n_ops)]


#: Twist traces over 16 cells: the reference's own, a trace whose padding
#: rows follow a write to cell 0 and whose reads hit unwritten cells, an
#: overwrite sequence, reads only, one operation, none, a random one
TWIST_CASES = {
    "reference": [("w", 0, 42), ("w", 1, 73), ("r", 0)],
    "padding_unwritten": [("r", 3), ("w", 0, 345), ("r", 5)],
    "overwrite": [("w", 0, 1), ("w", 0, 2), ("r", 0), ("w", 0, 3), ("r", 0)],
    "read_only": [("r", 0), ("r", 1), ("r", 2), ("r", 3)],
    "single": [("w", 9, 5)],
    "empty": [],
    "random": _mixed_ops(16, 11, seed=5),
}

#: Shout tables and lookups: the reference's, a five-entry table (pads to
#: 8), no lookups, one, repeated, a random log over 16 entries
SHOUT_CASES = {
    "reference": ([100, 200, 300, 400], [0, 2, 1]),
    "non_power_of_two": ([1, 2, 3, 4, 5], [4, 0]),
    "no_lookups": ([1, 2, 3, 4], []),
    "single": ([5, 6], [1]),
    "repeated": ([7, 8], [0] * 5),
    "random": ([i * i + 7 for i in range(16)],
               [random.Random(3).randrange(16) for _ in range(11)]),
}


def _twist_pair(case, sound, params):
    """(port bytes, tnsh bytes) of one Twist case."""
    (pp, _), (ref_pp, _) = params
    tr, ref_tr = _traces(16, TWIST_CASES[case])
    port = Twist(pp, "cpu").prove(tr, sound_mode=sound)
    ref = RefTwist(ref_pp).prove(ref_tr, sound_mode=sound)
    return port, twist_proof_to_bytes(port), ref_twist_to_bytes(ref)


def _shout_pair(case, sound, params):
    (pp, _), (ref_pp, _) = params
    tbl, ref_tbl = _tables(*SHOUT_CASES[case])
    port = Shout(pp, "cpu").prove(tbl, sound_mode=sound)
    ref = RefShout(ref_pp).prove(ref_tbl, sound_mode=sound)
    return port, shout_proof_to_bytes(port), ref_shout_to_bytes(ref)


def _cross_verify(who, port_b, ref_b, params):
    """Each package's verifier on the other's bytes, lenient, strict and
    fast."""
    (pp, vp), (ref_pp, ref_vp) = params
    if who == "twist":
        port, ref = Twist(pp, "cpu"), RefTwist(ref_pp)
        ours, theirs = twist_proof_from_bytes(ref_b), ref_twist_from_bytes(
            port_b)
    else:
        port, ref = Shout(pp, "cpu"), RefShout(ref_pp)
        ours, theirs = shout_proof_from_bytes(ref_b), ref_shout_from_bytes(
            port_b)
    for kw in ({}, {"strict": True}, {"fast": True}):
        assert port.verify(ours, vp, **kw)
        assert ref.verify(theirs, ref_vp, **kw)


# ---------------------------------------------------------------------------
# Proof bytes against tnsh's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [4, 8, 16])
def test_frozen_digests_and_bytes_equal_tnsh(size):
    log = size.bit_length() - 1
    pp, vp = setup_params(log)
    ref_pp, ref_vp = ref_setup_params(log)
    both = ((pp, vp), (ref_pp, ref_vp))
    tr, ref_tr = _traces(size, _golden_ops(size))
    b = twist_proof_to_bytes(tnsh_torch.Twist(pp, "cpu").prove(tr))
    assert (len(b), hashlib.sha256(b).hexdigest()) == FROZEN[size][0]
    assert b == ref_twist_to_bytes(RefTwist(ref_pp).prove(ref_tr))
    _cross_verify("twist", b, b, both)

    tbl, ref_tbl = _tables([i * i for i in range(size)],
                           [(i * 3) % size for i in range(size)])
    sb = shout_proof_to_bytes(tnsh_torch.Shout(pp, "cpu").prove(tbl))
    assert (len(sb), hashlib.sha256(sb).hexdigest()) == FROZEN[size][1]
    assert sb == ref_shout_to_bytes(RefShout(ref_pp).prove(ref_tbl))
    _cross_verify("shout", sb, sb, both)


@pytest.mark.parametrize("sound", [False, True], ids=["default", "sound"])
@pytest.mark.parametrize("case", sorted(TWIST_CASES))
def test_twist_bytes_equal_tnsh(case, sound, params):
    port, b, ref_b = _twist_pair(case, sound, params)
    assert b == ref_b
    assert Twist(params[0][0], "cpu").verify(port, params[0][1])
    _cross_verify("twist", b, ref_b, params)


@pytest.mark.parametrize("sound", [False, True], ids=["default", "sound"])
@pytest.mark.parametrize("case", sorted(SHOUT_CASES))
def test_shout_bytes_equal_tnsh(case, sound, params):
    port, b, ref_b = _shout_pair(case, sound, params)
    assert b == ref_b
    assert Shout(params[0][0], "cpu").verify(port, params[0][1])
    _cross_verify("shout", b, ref_b, params)


def test_sound_mode_runs_on_the_device_oracle(params, monkeypatch):
    """Sound mode's sum-check is ``TorchProductMLEOracle`` on the prover's
    device, and a prove reports its stages to the timer it is given."""
    (pp, _), _ = params
    made = []
    real = TorchProductMLEOracle.__init__

    def spy(self, factors, scale=Fr(1), *, device):
        made.append((len(factors), device))
        real(self, factors, scale, device=device)

    monkeypatch.setattr(TorchProductMLEOracle, "__init__", spy)
    tr, _ = _traces(16, TWIST_CASES["random"])
    timer = profiling.PhaseTimer()
    Twist(pp, "cpu").prove(tr, sound_mode=True, timer=timer)
    assert {"columns", "commit", "oracle", "rounds", "open",
            "commit/host_msm", "open/host_msm"} <= set(timer.phases)
    # on the CPU every kernel wrapper takes its plain version
    assert all(n == 0 for per in timer.launches.values()
               for n in per.values())
    tbl, _ = _tables(*SHOUT_CASES["random"])
    Shout(pp, "cpu").prove(tbl, sound_mode=True, timer=timer)
    assert made == [(1, "cpu"), (1, "cpu")]


@pytest.mark.parametrize("who", ["twist", "shout"])
def test_forged_values_refused_in_sound_mode(who, params):
    """A read or a lookup that records a value its cell does not hold
    makes the sound-mode sum differ from 0: both packages' provers
    refuse it, and both prove it in default mode (the reference's stub)."""
    (pp, _), (ref_pp, _) = params
    if who == "twist":
        tr, ref_tr = _traces(8, [("w", 2, 5), ("forged", 2, 6)])
        port, ref = Twist(pp, "cpu"), RefTwist(ref_pp)
    else:
        tr, ref_tr = _tables([1, 2, 3, 4], [2, 1, 0])
        tr.lookups[0] = type(tr.lookups[0])(2, Fr(9))
        ref_tr.lookups[0] = type(ref_tr.lookups[0])(2, RefFr(9))
        port, ref = Shout(pp, "cpu"), RefShout(ref_pp)
    with pytest.raises(SumCheckError):
        port.prove(tr, sound_mode=True)
    with pytest.raises(Exception, match="consistency check failed"):
        ref.prove(ref_tr, sound_mode=True)
    assert port.prove(tr) is not None


@pytest.mark.parametrize("who", ["twist", "shout"])
def test_over_operation_limit(who):
    pp, _ = setup_params(2)
    if who == "twist":
        tr = MemoryTrace(4)
        for i in range(pp.max_operations + 1):
            tr.write(i % 4, Fr(i))
        prover = Twist(pp, "cpu")
    else:
        tr = LookupTable([Fr(1)] * 4)
        for _ in range(pp.max_operations + 1):
            tr.lookup(0)
        prover = Shout(pp, "cpu")
    with pytest.raises(InvalidParametersError):
        prover.prove(tr)


# ---------------------------------------------------------------------------
# Tampered proofs
# ---------------------------------------------------------------------------

def _bump(x):
    return Fr(int(x) + 1)


#: tamper -> (what it does to a proof, whether lenient verify accepts it)
TAMPERS = {
    "eval_0": (lambda p, sc, c: p.final_evaluations.__setitem__(
        0, _bump(p.final_evaluations[0])), False),
    "eval_1": (lambda p, sc, c: p.final_evaluations.__setitem__(
        1, _bump(p.final_evaluations[1])), False),
    "openings_swapped": (lambda p, sc, c: p.opening_proofs.reverse(), False),
    "evals_swapped": (lambda p, sc, c: p.final_evaluations.reverse(), False),
    "round_poly": (lambda p, sc, c: sc.round_polynomials[0].__setitem__(
        1, _bump(sc.round_polynomials[0][1])), False),
    "final_evaluation": (lambda p, sc, c: setattr(
        sc, "final_evaluation", _bump(sc.final_evaluation)), False),
    "commitment": (lambda p, sc, c: setattr(p, c[0], getattr(p, c[1])),
                   False),
    # the reference checks openings only when present: lenient verify
    # accepts, strict verify refuses
    "no_openings": (lambda p, sc, c: (p.opening_proofs.clear(),
                                      p.final_evaluations.clear()), True),
}


@pytest.mark.parametrize("tamper", sorted(TAMPERS))
@pytest.mark.parametrize("who", ["twist", "shout"])
def test_tampered_proofs_rejected(who, tamper, params):
    """``tests/test_twist.py`` / ``test_shout.py``'s rejections on the
    port's verifier, lenient, strict and fast, and tnsh's on the same
    bytes."""
    (pp, vp), (ref_pp, ref_vp) = params
    if who == "twist":
        proof, _, _ = _twist_pair("random", False, params)
        sc_field = "consistency_proof"
        comms = ("address_commitment", "value_commitment")
        verifier, ref_verifier = Twist(pp, "cpu"), RefTwist(ref_pp)
        to_b, ref_from_b = twist_proof_to_bytes, ref_twist_from_bytes
    else:
        proof, _, _ = _shout_pair("random", False, params)
        sc_field = "lookup_proof"
        comms = ("table_commitment", "index_commitment")
        verifier, ref_verifier = Shout(pp, "cpu"), RefShout(ref_pp)
        to_b, ref_from_b = shout_proof_to_bytes, ref_shout_from_bytes
    assert verifier.verify(proof, vp, strict=True)
    forged = copy.deepcopy(proof)
    fn, lenient = TAMPERS[tamper]
    fn(forged, getattr(forged, sc_field), comms)
    assert verifier.verify(forged, vp) is lenient
    assert ref_verifier.verify(ref_from_b(to_b(forged)), ref_vp) is lenient
    assert not verifier.verify(forged, vp, strict=True)
    if tamper != "no_openings":
        assert not verifier.verify(forged, vp, fast=True)


def test_malformed_bytes_refused(params):
    _, b, _ = _twist_pair("reference", False, params)
    with pytest.raises(InvalidParametersError, match="magic"):
        shout_proof_from_bytes(b)
    with pytest.raises(InvalidParametersError, match="version"):
        twist_proof_from_bytes(b[:4] + bytes([9, 0, 0, 0]) + b[8:])
    assert twist_proof_to_bytes(twist_proof_from_bytes(b)) == b


# ---------------------------------------------------------------------------
# The univariate KZG against tnsh's
# ---------------------------------------------------------------------------

def _ints(seed, n):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def _same_point(port_g1, ref_g1):
    return g1_to_bytes(port_g1, compress=True) == ref_g1_to_bytes(
        ref_g1, compress=True)


@pytest.mark.parametrize("n", [1, 5, 16])
def test_commit_evals_equals_commit_of_the_interpolant(n, params):
    (pp, _), (ref_pp, _) = params
    vals = _ints(n, n)
    cp, ref_cp = pp.commitment_params, ref_pp.commitment_params
    got = KZGCommitment.commit_evals(cp, [Fr(v) for v in vals], "cpu")
    want = KZGCommitment.commit(
        cp, interpolate_on_range([Fr(v) for v in vals]), "cpu")
    assert got == want
    assert _same_point(got.commitment, ref_kzg.KZGCommitment.commit_evals(
        ref_cp, [RefFr(v) for v in vals]).commitment)
    no_tau = dataclasses.replace(cp, tau=None)
    assert KZGCommitment.commit_evals(no_tau, [Fr(v) for v in vals],
                                      "cpu") == got
    assert KZGCommitment.commit_evals(cp, [], "cpu").commitment.is_zero()


@pytest.mark.parametrize("where", ["off_domain", "in_domain", "no_tau",
                                   "one_value"])
def test_open_evals_equals_open_and_tnsh(where, params):
    """The evaluation-basis opening against the coefficient path, on its
    fast path and on both fallbacks (a point in the domain; params without
    tau), and against tnsh's."""
    (pp, vp), (ref_pp, _) = params
    n = 1 if where == "one_value" else 8
    vals = _ints(7, n)
    z = 3 if where == "in_domain" else _ints(8, 1)[0]
    cp, ref_cp = pp.commitment_params, ref_pp.commitment_params
    if where == "no_tau":
        cp = dataclasses.replace(cp, tau=None)
        ref_cp = dataclasses.replace(ref_cp, tau=None)
    value, proof = KZGCommitment.open_evals(cp, [Fr(v) for v in vals],
                                            Fr(z), "cpu")
    poly = interpolate_on_range([Fr(v) for v in vals])
    assert (value, proof) == KZGCommitment.open(cp, poly, Fr(z), "cpu")
    ref_value, ref_proof = ref_kzg.KZGCommitment.open_evals(
        ref_cp, [RefFr(v) for v in vals], RefFr(z))
    assert int(value) == int(ref_value)
    assert _same_point(proof.proof, ref_proof.proof)
    comm = KZGCommitment.commit_evals(cp, [Fr(v) for v in vals], "cpu")
    vk = vp.commitment_vk
    assert KZGCommitment.verify(vk, comm, Fr(z), value, proof)
    assert not KZGCommitment.verify(vk, comm, Fr(z), _bump(value), proof)


def test_pure_python_lagrange_and_opening_equal_native(params, monkeypatch):
    """Without the native engine the Lagrange SRS, the barycentric value
    and the quotient come from Python: the same points and proof."""
    (pp, _), _ = params
    vals = [Fr(v) for v in _ints(11, 8)]
    z = Fr(_ints(12, 1)[0])
    native_srs = lagrange_srs(pp.commitment_params, 8)
    native = KZGCommitment.open_evals(pp.commitment_params, vals, z, "cpu")
    monkeypatch.setenv("TNSH_NO_NATIVE", "1")
    fresh = dataclasses.replace(pp.commitment_params)
    assert lagrange_srs(fresh, 8) == native_srs[:8]
    assert KZGCommitment.open_evals(fresh, vals, z, "cpu") == native
    assert barycentric_eval(vals, z) == native[0]
    assert evaluate_polynomial(interpolate_on_range(vals), z) == native[0]


def test_lagrange_srs_points_equal_tnsh():
    """At n = 8 and 1024 the port keeps the Lagrange SRS in native memory
    (tnsh: explicit points below 2^14).  The same serialized elements, and
    the port's is built once per params."""
    pp, _ = setup_params(8)
    ref_pp, _ = ref_setup_params(8)
    for n in (8, 1024):
        srs = lagrange_srs(pp.commitment_params, n)
        assert isinstance(srs, NativeSRS)
        assert lagrange_srs(pp.commitment_params, n) is srs
        ref = ref_kzg.lagrange_srs(ref_pp.commitment_params, n)
        assert len(srs) == len(ref) == n
        assert [g1_to_bytes(p) for p in srs[:n]] == [
            ref_g1_to_bytes(p) for p in ref]
    with pytest.raises(CommitmentError):
        lagrange_srs(dataclasses.replace(pp.commitment_params, tau=None), 4)


def test_commit_open_verify_and_degree_limit(params):
    """``tests/test_commitments.py``'s KZG case: 3x^2 + 2x + 1 at 5."""
    (pp, vp), _ = params
    cp, vk = pp.commitment_params, vp.commitment_vk
    poly = [Fr(1), Fr(2), Fr(3)]
    comm = KZGCommitment.commit(cp, poly, "cpu")
    value, proof = KZGCommitment.open(cp, poly, Fr(5), "cpu")
    assert value == Fr(86)
    assert KZGCommitment.verify(vk, comm, Fr(5), value, proof)
    assert not KZGCommitment.verify(vk, comm, Fr(5), Fr(87), proof)
    with pytest.raises(CommitmentError):
        KZGCommitment.commit(cp, [Fr(1)] * (len(cp.g1_powers) + 1), "cpu")
    with pytest.raises(CommitmentError):
        KZGCommitment.commit_evals(cp, [Fr(1)] * (len(cp.g1_powers) + 1),
                                   "cpu")


def _batch(params):
    (pp, vp), _ = params
    cp = pp.commitment_params
    polys = [[Fr(1), Fr(2), Fr(3)], [Fr(5), Fr(0), Fr(7), Fr(1)]]
    points = [Fr(5), Fr(9)]
    comms, values, proofs = [], [], []
    for poly, pt in zip(polys, points):
        comms.append(KZGCommitment.commit(cp, poly, "cpu"))
        v, pi = KZGCommitment.open(cp, poly, pt, "cpu")
        values.append(v)
        proofs.append(pi)
    return vp.commitment_vk, comms, points, values, proofs


def test_batch_verify_rejects_an_honest_batch(params):
    """The reference's unbalanced RLC equation, kept as it is."""
    vk, comms, points, values, proofs = _batch(params)
    assert not KZGCommitment.batch_verify(vk, comms, points, values, proofs)
    with pytest.raises(CommitmentError):
        KZGCommitment.batch_verify(vk, comms, points[:1], values, proofs)
    assert KZGCommitment.batch_verify(vk, [], [], [], [])


def test_batch_verify_sound(params):
    vk, comms, points, values, proofs = _batch(params)
    assert KZGCommitment.batch_verify_sound(vk, comms, points, values, proofs)
    bad = [_bump(values[0]), values[1]]
    assert not KZGCommitment.batch_verify_sound(vk, comms, points, bad,
                                                proofs)
    with pytest.raises(CommitmentError):
        KZGCommitment.batch_verify_sound(vk, comms, points, values[:1],
                                         proofs)
    assert KZGCommitment.batch_verify_sound(vk, [], [], [], [])


def test_verify_openings_batched(params):
    """Two openings at one point in one pairing product; a forged value
    or proof fails it."""
    (pp, vp), _ = params
    cp, vk = pp.commitment_params, vp.commitment_vk
    cols = [[Fr(v) for v in _ints(s, 8)] for s in (21, 22)]
    z = Fr(_ints(23, 1)[0])
    comms = [KZGCommitment.commit_evals(cp, c, "cpu") for c in cols]
    opened = [KZGCommitment.open_evals(cp, c, z, "cpu") for c in cols]
    values = [v for v, _ in opened]
    proofs = [pi for _, pi in opened]
    assert verify_openings_batched(vk, comms, z, values, proofs)
    assert not verify_openings_batched(vk, comms, z,
                                       [values[0], _bump(values[1])], proofs)
    assert not verify_openings_batched(vk, comms, z, values, proofs[::-1])
    with pytest.raises(CommitmentError):
        verify_openings_batched(vk, comms, z, values[:1], proofs)
    assert verify_openings_batched(vk, [], z, [], [])


def test_vector_commitment_equals_tnsh(params):
    (pp, vp), (ref_pp, _) = params
    cp = pp.commitment_params
    vector = [Fr(10), Fr(20), Fr(30), Fr(40)]
    comm = KZGVectorCommitment.commit(cp, vector, "cpu")
    value, proof = KZGVectorCommitment.open(cp, vector, 2, "cpu")
    assert value == Fr(30)
    assert KZGVectorCommitment.verify(vp.commitment_vk, comm, 2, value, proof)
    assert not KZGVectorCommitment.verify(vp.commitment_vk, comm, 1, value,
                                          proof)
    ref_vec = [RefFr(int(v)) for v in vector]
    ref_cp = ref_pp.commitment_params
    assert _same_point(comm.commitment, ref_kzg.KZGVectorCommitment.commit(
        ref_cp, ref_vec).commitment)
    assert _same_point(proof.proof, ref_kzg.KZGVectorCommitment.open(
        ref_cp, ref_vec, 2)[1].proof)
    with pytest.raises(CommitmentError):
        KZGVectorCommitment.open(cp, [Fr(1), Fr(2)], 2, "cpu")


def test_quotient_and_division_helpers_equal_tnsh():
    """``tests/test_commitments.py``'s polynomial helpers, value for value
    against tnsh's."""
    assert polynomial_division([-Fr(1), Fr(0), Fr(1)],
                               [-Fr(1), Fr(1)]) == [Fr(1), Fr(1)]
    with pytest.raises(PolynomialError):
        polynomial_division([Fr(1)], [Fr(0), Fr(0)])
    with pytest.raises(PolynomialError):
        polynomial_division([Fr(1), Fr(2)], [Fr(1), Fr(0)])
    assert polynomial_division([Fr(1)], [Fr(1), Fr(1)]) == []
    assert compute_quotient_polynomial([Fr(5)], Fr(2), Fr(5)) == []
    rng = random.Random(31)
    for deg in (1, 4, 9):
        poly = [Fr(rng.randrange(P)) for _ in range(deg + 1)]
        z = Fr(rng.randrange(P))
        v = evaluate_polynomial(poly, z)
        q = compute_quotient_polynomial(poly, z, v)
        long = polynomial_division([poly[0] - v] + poly[1:], [-z, Fr(1)])
        assert q == long
        for x in (Fr(0), Fr(11), Fr(rng.randrange(P))):
            assert (evaluate_polynomial(q, x) * (x - z) + v
                    == evaluate_polynomial(poly, x))
        ref_poly = [RefFr(int(c)) for c in poly]
        assert [int(c) for c in q] == [
            int(c) for c in ref_kzg.compute_quotient_polynomial(
                ref_poly, RefFr(int(z)), RefFr(int(v)))]
        assert int(v) == int(ref_kzg.evaluate_polynomial(ref_poly,
                                                         RefFr(int(z))))
        assert [int(c) for c in polynomial_division(poly, [Fr(3), Fr(1)])] \
            == [int(c) for c in ref_kzg.polynomial_division(
                ref_poly, [RefFr(3), RefFr(1)])]


def test_the_device_route_at_a_1024_entry_table():
    """A Shout table of 1024 entries: its Lagrange SRS is native, so the
    table's commitment and opening take the device route (the scheduled
    Pippenger's plain versions on the CPU), the indices' stay on the host;
    the bytes are tnsh's."""
    pp, vp = setup_params(8)
    ref_pp, ref_vp = ref_setup_params(8)
    tbl, ref_tbl = _tables([3 * i + 1 for i in range(1024)],
                           [(37 * i) % 1024 for i in range(8)])
    kzg.reset_route_counts()
    proof = Shout(pp, "cpu").prove(tbl)
    assert kzg.route_counts() == {"device": 2, "host": 2}
    b = shout_proof_to_bytes(proof)
    assert b == ref_shout_to_bytes(RefShout(ref_pp).prove(ref_tbl))
    _cross_verify("shout", b, b, ((pp, vp), (ref_pp, ref_vp)))


def test_every_entry_point_needs_its_device(params):
    """No default chooses the host."""
    (pp, _), _ = params
    cp = pp.commitment_params
    with pytest.raises(TypeError):
        Twist(pp)
    with pytest.raises(TypeError):
        Shout(pp)
    with pytest.raises(TypeError):
        KZGCommitment.commit_evals(cp, [Fr(1)])
    with pytest.raises(TypeError):
        KZGCommitment.open_evals(cp, [Fr(1), Fr(2)], Fr(7))
    with pytest.raises(TypeError):
        KZGVectorCommitment.commit(cp, [Fr(1)])
    with pytest.raises(TypeError):
        ProtocolBenchmarks()


# ---------------------------------------------------------------------------
# The edges: public surface, bench CLI, trace
# ---------------------------------------------------------------------------

def test_public_surface_equals_tnsh_and_loads_no_prover():
    assert tnsh_torch.__all__ == sorted(tnsh.__all__)
    for name in tnsh_torch.__all__:
        assert getattr(tnsh_torch, name).__name__ == getattr(
            tnsh, name).__name__
    out = subprocess.run(
        [sys.executable, "-c", "import sys, tnsh_torch; print(sorted("
         "m for m in sys.modules if m.startswith('tnsh_torch.')))"],
        capture_output=True, text=True, timeout=120, check=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("mode", ["twist-only", "shout-only", "custom"])
def test_cli_modes_on_the_cpu(mode, capsys):
    rc = cli.main([mode, "--min-log-size", "2", "--max-log-size", "3",
                   "--operations", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Size\t| Setup(ms)" in out
    assert ("Comparative" in out) == (mode == "custom")


@pytest.mark.parametrize("mode", ["sound", "bits"])
def test_cli_sound_modes_verify_every_proof(mode, capsys):
    """The extension tiers' modes print one verified row a prover and
    size, each from a warm prove."""
    rc = cli.main([mode, "--min-log-size", "2", "--max-log-size", "3",
                   "--operations", "8", "--device", "cpu"])
    rows = [line.split("|") for line in capsys.readouterr().out.splitlines()
            if line.startswith(("Twist ", "Shout "))]
    assert rc == 0
    assert [(r[0].strip(), int(r[1])) for r in rows] == [
        ("Twist", 2), ("Shout", 2), ("Twist", 3), ("Shout", 3)]
    assert all(r[4].strip() == "True" for r in rows)


def test_cli_sound_mode_fails_on_a_rejected_proof(monkeypatch, capsys):
    """A proof that does not verify ends the sound mode with an error,
    so the command cannot exit 0 on it."""
    from tnsh_torch.protocols import sound

    monkeypatch.setattr(sound.ShoutSound, "verify",
                        staticmethod(lambda *args: False))
    with pytest.raises(AssertionError, match="Shout proof verification"):
        cli.main(["sound", "--min-log-size", "2", "--max-log-size", "2",
                  "--operations", "8", "--device", "cpu"])
    assert "| False" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["bogus"],
    ["custom", "--min-log-size", "5", "--max-log-size", "3"],
    ["quick", "--min-log-size", "1"],
    ["quick", "--operations", "many"],
    ["quick", "--max-log-size"],
    ["quick", "--device", "nowhere"],
])
def test_cli_bad_arguments_exit_1(argv, capsys):
    assert cli.main(argv) == 1
    assert "error" in capsys.readouterr().out


def test_cli_needs_cuda_unless_asked_for_the_cpu(monkeypatch, capsys):
    """Without a card the default device refuses to run (exit 2), and help
    still prints."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TNSH_DEVICE", raising=False)
    assert cli.main(["twist-only", "--min-log-size", "2",
                     "--max-log-size", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["help"]) == 0
    assert "tnsh_torch.bench.cli" in capsys.readouterr().out


def test_cli_takes_device_and_trace_dir_from_the_config(monkeypatch,
                                                       tmp_path, capsys):
    """``TNSH_DEVICE`` is ``--device``'s default and ``TNSH_PROFILE_DIR``
    receives the run's trace (``tnsh_torch.core.config.from_env``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TNSH_DEVICE", "cpu")
    monkeypatch.setenv("TNSH_PROFILE_DIR", str(tmp_path / "traces"))
    argv = ["twist-only", "--min-log-size", "2", "--max-log-size", "2",
            "--operations", "4"]
    assert cli.main(argv) == 0
    assert "Size\t| Setup(ms)" in capsys.readouterr().out
    assert (tmp_path / "traces" / "trace.json").is_file()
    monkeypatch.setenv("TNSH_DEVICE", "cuda")
    assert cli.main(argv) == 2
    assert cli.main(argv + ["--device", "cpu"]) == 0
    monkeypatch.setenv("TNSH_LOG_SIZE", "40")
    assert cli.main(argv) == 1


def test_harness_results_and_setup():
    res = ProtocolBenchmarks("cpu").benchmark_twist_single(3, 4)
    assert res.num_operations == 4 and res.prove_time > 0
    assert res.proof_size == 2 * 64 + 2 * 128 + 2 * 64
    assert res.memory_usage == 8 * 32 + 4 * 32 * 3
    assert benchmark_setup(4) == (64, 64)


def test_trace_writes_a_chrome_trace_and_keeps_failures(tmp_path,
                                                        monkeypatch):
    pp, _ = setup_params(2)
    tr = MemoryTrace(4)
    tr.write(1, Fr(3))
    tr.read(1)
    with profiling.trace(str(tmp_path / "t")):
        Twist(pp, "cpu").prove(tr, sound_mode=True)
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    with profiling.trace(None) as nothing:
        assert nothing is None

    def broken(*args, **kwargs):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with profiling.trace(str(tmp_path / "u")):
            pass


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _bench_trace(log_k, log_t, trace_cls, fr):
    """``bench.py``'s trace: ``random.seed(5)``, a write of 42 i every
    third cycle, reads of random cells otherwise."""
    random.seed(5)
    tr = trace_cls(1 << log_k)
    for i in range(1 << log_t):
        if i % 3 == 0:
            tr.write(random.randrange(1 << log_k), fr(42 * i))
        else:
            tr.read(random.randrange(1 << log_k))
    return tr


def _bench_lookups(log_k, log_t, table_cls, fr):
    """``benches/bits_bench.py``'s lookups: entries 3i + 1, T - 1 lookups
    drawn from ``random.Random(11)``."""
    rng = random.Random(11)
    tbl = table_cls([fr(3 * i + 1) for i in range(1 << log_k)])
    for _ in range((1 << log_t) - 1):
        tbl.lookup(rng.randrange(1 << log_k))
    return tbl


@pytest.mark.cuda
@pytest.mark.parametrize("sound", [False, True], ids=["default", "sound"])
@pytest.mark.parametrize("log_t", [16, 18])
def test_card_proofs_equal_tnsh_host_proofs(log_t, sound, monkeypatch,
                                            request):
    """Twist and Shout at K=2^10 on the card against tnsh's host-native
    provers, over ``bench.py``'s trace and ``benches/bits_bench.py``'s
    lookups.  Run with ``-s`` to see the prove times, taken in turns port,
    tnsh, port, tnsh in one process; the Lagrange SRSs are built and the
    port's uploaded before the timing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # keep tnsh's MSMs on the host
    monkeypatch.setenv("TNSH_TPU_MSM", "0")
    monkeypatch.setattr(ref_kzg, "_TPU_MSM_FRACTION", "0")
    dev = torch.device("cuda", 0)
    torch.set_num_threads(os.cpu_count() or 1)
    request.addfinalizer(lambda: torch.set_num_threads(1))
    log_k = 10
    pp, vp = setup_params(log_t - 2)
    ref_pp, ref_vp = ref_setup_params(log_t - 2)
    both = ((pp, vp), (ref_pp, ref_vp))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    inputs = {
        "twist": (_bench_trace(log_k, log_t, MemoryTrace, Fr),
                  _bench_trace(log_k, log_t, RefMemoryTrace, RefFr),
                  Twist(pp, dev), RefTwist(ref_pp), twist_proof_to_bytes,
                  ref_twist_to_bytes),
        "shout": (_bench_lookups(log_k, log_t, LookupTable, Fr),
                  _bench_lookups(log_k, log_t, RefLookupTable, RefFr),
                  Shout(pp, dev), RefShout(ref_pp), shout_proof_to_bytes,
                  ref_shout_to_bytes),
    }
    for n in (1 << log_k, 1 << log_t):
        srs = lagrange_srs(pp.commitment_params, n)
        kzg.device_srs_context(srs.srs_id, dev)
        ref_kzg.lagrange_srs(ref_pp.commitment_params, n)
    for who, (x, ref_x, port, ref, to_b, ref_to_b) in inputs.items():
        times = {"port": [], "tnsh": []}
        out = {}
        for side in ("port", "tnsh", "port", "tnsh"):
            t0 = time.perf_counter()
            if side == "port":
                b = to_b(port.prove(x, sound_mode=sound))
                torch.cuda.synchronize()
            else:
                b = ref_to_b(ref.prove(ref_x, sound_mode=sound))
            times[side].append(time.perf_counter() - t0)
            assert out.setdefault(side, b) == b
        assert out["port"] == out["tnsh"]
        print(f"\n{who} sound_mode={sound} K=2^{log_k} T=2^{log_t} on "
              f"{card}: port prove s {times['port']}, tnsh host prove s "
              f"{times['tnsh']}")
        _cross_verify(who, out["port"], out["tnsh"], both)
    assert sum(c.hazard_count for c in kzg.device_contexts()) == 0


@pytest.mark.cuda
def test_trace_on_the_card_holds_the_kernels(tmp_path):
    """``trace()`` around a sound-mode Shout prove on the card: the Chrome
    trace names the MSM insertion and the round-evaluation kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pp, vp = setup_params(10)
    tbl = LookupTable([Fr(3 * i + 1) for i in range(1024)])
    for i in range(2047):
        tbl.lookup((7 * i) % 1024)
    shout = Shout(pp, torch.device("cuda", 0))
    with profiling.trace(str(tmp_path)):
        proof = shout.prove(tbl, sound_mode=True)
    text = (tmp_path / "trace.json").read_text()
    assert "msm_insert_kernel" in text and "fr_round_evals_kernel" in text
    assert shout.verify(proof, vp)
