"""The port's three phase-A paths of the bit-column provers against tnsh:
the dense (k, j) cube (TNSH_BITS_DENSE), the structured oracles' Python k
phase (TNSH_NO_NATIVE) and the structured oracles' native k phase.

On the CPU (the kernels' plain versions), at log K = 3, log T = 6 and on
tnsh's edge shapes: port dense == port structured-Python == port
structured-native == tnsh's default proof bytes, each package's verifier
accepts the other's, and the frozen wire-v3 digests hold on the dense path.
The cube-table functions are held value for value against tnsh's ``_lift_j``,
``_lift_k``, ``_chi_cube``, ``eq_table`` and its dense Val loop.  Marked
``cuda``: the dense path on the card at K=2^10, T=2^14 against tnsh's host
structured prover.  Also here: the cube build's child spans of
``cube_build`` and their counter ``cube_lanes``, proof bytes unchanged by a
timer and a profiler, and the port's ``core/config.py`` and the two alias
modules against tnsh's.

Both packages read TNSH_BITS_DENSE and TNSH_NO_NATIVE at prove time, so
each variable is set around one package's own call only."""

import hashlib
import os
import random
import subprocess
import time

import numpy as np
import pytest
import torch

from tnsh.commit import kzg as ref_kzg
from tnsh.commit.mkzg import setup_multilinear_params as ref_ml_params
from tnsh.core.params import setup_params as ref_setup_params
from tnsh.core.proof_io import (
    shout_bits_comm_proof_from_bytes as ref_comm_from_bytes,
    shout_bits_comm_proof_to_bytes as ref_comm_to_bytes,
    shout_bits_proof_from_bytes as ref_shout_from_bytes,
    shout_bits_proof_to_bytes as ref_shout_to_bytes,
    twist_bits_proof_from_bytes as ref_twist_from_bytes,
    twist_bits_proof_to_bytes as ref_twist_to_bytes,
)
from tnsh.field.fr import Fr as RefFr
from tnsh.poly.eq import eq_table as ref_eq_table
from tnsh.protocols.shout import LookupTable as RefLookupTable
from tnsh.protocols.sound import _lift_j as ref_lift_j
from tnsh.protocols.sound import _lift_k as ref_lift_k
from tnsh.protocols.twist import MemoryTrace as RefMemoryTrace
from tnsh.protocols.twist_bits import ShoutBits as RefShoutBits
from tnsh.protocols.twist_bits import ShoutBitsCommitted as RefCommitted
from tnsh.protocols.twist_bits import TwistBits as RefTwistBits
from tnsh.protocols.twist_bits import _chi_cube as ref_chi_cube
from tnsh_torch.commit import kzg
from tnsh_torch.commit.kzg import KZGCommitmentValue
from tnsh_torch.core.proof_io import (
    shout_bits_comm_proof_from_bytes,
    shout_bits_proof_from_bytes,
    twist_bits_proof_from_bytes,
)
from tnsh_torch.field import limbs
from tnsh_torch.field.fr import MODULUS as P
from tnsh_torch.protocols import twist_bits as tb
from tnsh_torch.protocols.bit_columns import BitColumns
from tnsh_torch.protocols.twist_bits import (
    Fr,
    LookupTable,
    MemoryTrace,
    ShoutBits,
    ShoutBitsCommitted,
    TwistBits,
    setup_multilinear_params,
    setup_params,
)
from tnsh_torch.utils import profiling
from tnsh_torch.utils.profiling import PhaseTimer

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

LOG_K, LOG_T = 3, 6

#: the port's three phase-A paths, by the environment that selects each
PATHS = {
    "dense": {"TNSH_BITS_DENSE": "1"},
    "structured_py": {"TNSH_NO_NATIVE": "1"},
    "structured_native": {},
}


@pytest.fixture(scope="module")
def params():
    """((port pp, vp), (tnsh pp, vp)) from the same deterministic setup."""
    return setup_params(8), ref_setup_params(8)


def _on_path(monkeypatch, path, prove):
    """``prove()`` with ``path``'s variables set, and only around it."""
    for var, val in PATHS[path].items():
        monkeypatch.setenv(var, val)
    try:
        return prove()
    finally:
        for var in PATHS[path]:
            monkeypatch.delenv(var)


def _trace(cls, fr, k, ops):
    tr = cls(k)
    for kind, addr, val in ops:
        if kind == "w":
            tr.write(addr, fr(val))
        else:
            tr.read(addr)
    return tr


def _adversarial_traces():
    """tnsh's shape matrix (``tests/test_twist_bits.py``
    ``_adversarial_traces``, copied): write-only, read-only,
    overwrite-heavy, K=2, T=1 (log T = 0), an empty trace, duplicate-heavy
    addresses, and a seeded mix of 64 operations."""
    random.seed(4242)
    shapes = []
    k = 1 << LOG_K
    shapes.append(("write_only", k, [("w", i % k, 7 + i) for i in range(16)]))
    shapes.append(("read_only", k, [("r", i % k, 0) for i in range(16)]))
    shapes.append((
        "overwrite_heavy", k,
        [("w", 3, 100 + i) for i in range(12)] + [("r", 3, 0)] * 4,
    ))
    shapes.append(("k2_mixed", 2, [
        ("w", 0, 5), ("r", 0, 0), ("w", 1, 9), ("r", 1, 0),
        ("w", 0, 11), ("r", 0, 0), ("r", 1, 0), ("w", 1, 13),
    ]))
    shapes.append(("single_write", k, [("w", 2, 77)]))
    shapes.append(("single_read", k, [("r", 0, 0)]))
    shapes.append(("empty", k, []))
    shapes.append((
        "dup_heavy", k,
        [("w" if i % 2 else "r", (i * i) % 2, 50 + i) for i in range(32)],
    ))
    mixed = []
    for i in range(64):
        if random.random() < 0.4:
            mixed.append(("w", random.randrange(k),
                          random.randrange(1 << 40)))
        else:
            mixed.append(("r", random.randrange(k), 0))
    shapes.append(("mixed_64", k, mixed))
    return shapes


_SHAPES = _adversarial_traces()


@pytest.mark.parametrize("name,k,ops", _SHAPES, ids=[s[0] for s in _SHAPES])
def test_twist_bits_paths_equal_tnsh(name, k, ops, params, monkeypatch):
    (pp, vp), (ref_pp, ref_vp) = params
    got = {}
    for path in PATHS:
        proof = _on_path(monkeypatch, path, lambda: TwistBits.prove(
            _trace(MemoryTrace, Fr, k, ops), pp, "cpu"))
        assert TwistBits.verify(proof, vp), (name, path)
        got[path] = TwistBits.to_bytes(proof)
    ref_b = ref_twist_to_bytes(RefTwistBits.prove(
        _trace(RefMemoryTrace, RefFr, k, ops), ref_pp))
    assert got == {path: ref_b for path in PATHS}, name
    assert RefTwistBits.verify(ref_twist_from_bytes(got["dense"]), ref_vp)
    assert TwistBits.verify(twist_bits_proof_from_bytes(ref_b), vp)


def _lookups(nk, nt):
    """tnsh's ShoutBits edge-shape lookup log: entries 3i + 1, T - 1
    lookups from ``random.seed(9000 + 10 nk + nt)``."""
    random.seed(9000 + nk * 10 + nt)
    k = 1 << nk
    looks = [random.randrange(k) for _ in range(max((1 << nt) - 1, 0))]
    return [3 * i + 1 for i in range(k)], looks


def _table(cls, fr, entries, looks):
    t = cls([fr(e) for e in entries])
    for ix in looks:
        t.lookup(ix)
    return t


@pytest.mark.parametrize("committed", [False, True],
                         ids=["shout_bits", "shout_bits_committed"])
@pytest.mark.parametrize("nk,nt", [(1, 0), (1, 3), (3, 0), (4, 2)])
def test_shout_paths_equal_tnsh(nk, nt, committed, params, monkeypatch):
    """K = 2, single and empty lookup logs, on both Shout provers."""
    (pp, vp), (ref_pp, ref_vp) = params
    entries, looks = _lookups(nk, nt)
    port_entries = [Fr(e) for e in entries]
    ref_entries = [RefFr(e) for e in entries]
    if committed:
        prover, to_bytes, from_bytes = (ShoutBitsCommitted,
                                        ShoutBitsCommitted.to_bytes,
                                        shout_bits_comm_proof_from_bytes)
        ref_prover, ref_to_bytes, ref_from_bytes = (
            RefCommitted, ref_comm_to_bytes, ref_comm_from_bytes)
        port_stmt = ShoutBitsCommitted.preprocess(port_entries, "cpu")
        ref_stmt = RefCommitted.preprocess(ref_entries)
        assert (port_stmt.serialize_compressed()
                == ref_stmt.serialize_compressed())
    else:
        prover, to_bytes, from_bytes = (ShoutBits, ShoutBits.to_bytes,
                                        shout_bits_proof_from_bytes)
        ref_prover, ref_to_bytes, ref_from_bytes = (
            RefShoutBits, ref_shout_to_bytes, ref_shout_from_bytes)
        port_stmt, ref_stmt = port_entries, ref_entries
    got = {}
    for path in PATHS:
        proof = _on_path(monkeypatch, path, lambda: prover.prove(
            _table(LookupTable, Fr, entries, looks), pp, "cpu"))
        assert (proof.log_table, proof.log_lookups) == (nk, nt)
        assert prover.verify(proof, port_stmt, vp), path
        got[path] = to_bytes(proof)
    ref_b = ref_to_bytes(ref_prover.prove(
        _table(RefLookupTable, RefFr, entries, looks), ref_pp))
    assert got == {path: ref_b for path in PATHS}
    assert ref_prover.verify(ref_from_bytes(got["dense"]), ref_stmt, ref_vp)
    if committed:
        port_stmt = KZGCommitmentValue.deserialize_compressed(
            ref_stmt.serialize_compressed())
    assert prover.verify(from_bytes(ref_b), port_stmt, vp)


def _frozen_twist():
    """The trace of tnsh's frozen TwistBits digest (``random.seed(1234)``,
    a write of a 61-bit value every third cycle)."""
    random.seed(1234)
    k = 1 << LOG_K
    ops = []
    for i in range(1 << LOG_T):
        if i % 3 == 0:
            ops.append(("w", random.randrange(k), random.randrange(1 << 61)))
        else:
            ops.append(("r", random.randrange(k), 0))
    return _trace(MemoryTrace, Fr, k, ops)


def _frozen_shout():
    """The lookup log of tnsh's frozen ShoutBits digest
    (``random.seed(99)``, entries i^2 + 3, 64 lookups)."""
    random.seed(99)
    entries = [i * i + 3 for i in range(1 << LOG_K)]
    looks = [random.randrange(1 << LOG_K) for _ in range(1 << LOG_T)]
    return _table(LookupTable, Fr, entries, looks)


@pytest.mark.parametrize("which,want", [
    ("twist_bits", (
        4856,
        "948e0609dd4a33266972f0cce3e6dc2d8ae8a10b38d448f70ab2cbc1322cffed")),
    ("shout_bits", (
        2344,
        "689c1c848809eb688a42f4301a0b269b48d77dbfa0900123cf1679017b1a9dca")),
])
def test_dense_path_frozen_digests(which, want, params, monkeypatch):
    """The wire-v3 digests ``tests/test_twist_bits.py`` freezes, on the
    dense path, with its stages."""
    pp, _ = params[0]
    timer = PhaseTimer()
    if which == "twist_bits":
        b = TwistBits.to_bytes(_on_path(monkeypatch, "dense", lambda: (
            TwistBits.prove(_frozen_twist(), pp, "cpu", timer))))
    else:
        b = ShoutBits.to_bytes(_on_path(monkeypatch, "dense", lambda: (
            ShoutBits.prove(_frozen_shout(), pp, "cpu", timer))))
    assert (len(b), hashlib.sha256(b).hexdigest()) == want
    assert {"cube_build", "phase_a", "k_rounds", "j_rounds"} <= set(
        timer.phases)
    assert not {"oracle_a_build", "j_build"} & set(timer.phases)
    assert ("phase_b" in timer.phases) == (which == "twist_bits")


#: the cube build's child spans of ``cube_build``, by prover
CUBE_SPANS = {
    "twist_bits": {"columns", "lift", "chi", "val", "eq", "oracle"},
    "shout_bits": {"columns", "lift", "chi", "oracle"},
}


def _dense_prove(which, pp, monkeypatch, timer=None):
    prover, make = ((TwistBits, _frozen_twist) if which == "twist_bits"
                    else (ShoutBits, _frozen_shout))
    return prover.to_bytes(_on_path(monkeypatch, "dense", lambda: (
        prover.prove(make(), pp, "cpu", timer))))


@pytest.mark.parametrize("which", ["twist_bits", "shout_bits"])
def test_dense_prove_records_cube_spans_and_lanes(which, params,
                                                  monkeypatch):
    """A dense prove writes its cube under unfenced child spans of
    ``cube_build``, and ``cube_lanes`` counts the stack's F K T lanes
    once a prove (49 x K T for TwistBits at K = 2^10)."""
    pp, _ = params[0]
    timer = PhaseTimer()
    profiling.reset_launch_counts()
    _dense_prove(which, pp, monkeypatch, timer)
    build = [i for i, sp in enumerate(timer.spans)
             if sp.name == "cube_build"]
    kids = [sp for sp in timer.spans if sp.name.startswith("cube_build/")]
    assert {sp.name for sp in kids} == {
        f"cube_build/{name}" for name in CUBE_SPANS[which]}
    assert all(not sp.fenced and sp.parent in build for sp in kids)
    slots = (tb.twist_cube_slots if which == "twist_bits"
             else tb.shout_cube_slots)
    lanes = slots(LOG_K).count << (LOG_K + LOG_T)
    assert timer.counters["cube_lanes"] == lanes
    assert profiling.counter_totals()["cube_lanes"] == lanes
    assert tb.twist_cube_slots(10).count == 49


@pytest.mark.parametrize("which", ["twist_bits", "shout_bits"])
def test_dense_bytes_unchanged_by_timer_and_profiler(which, params,
                                                     monkeypatch):
    """The spans and the counter change no byte: a dense prove with no
    timer, and one with a timer under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    pp, _ = params[0]
    plain = _dense_prove(which, pp, monkeypatch)
    timer = PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _dense_prove(which, pp, monkeypatch, timer)
    assert traced == plain
    assert "cube_build/oracle" in timer.phases
    assert "cube_build/columns" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# the cube tables, value for value against tnsh's
# ---------------------------------------------------------------------------

B_LOG_K, B_LOG_T = 3, 4


def _rand_col(rng, n):
    return [rng.randrange(P) for _ in range(n)]


def _cube(slot):
    return limbs.unpack(slot)


def _ref_val_cube(ops, k_size, t_size):
    """tnsh's dense V (``twist_bits.py:259-279``, copied): cur[a] before
    each cycle."""
    V = [0] * (k_size * t_size)
    cur = [0] * k_size
    mem = [0] * k_size
    for j in range(t_size):
        for k in range(k_size):
            V[j * k_size + k] = cur[k]
        if j < len(ops) and ops[j][0] == "w":
            a, v = ops[j][1], ops[j][2] % P
            ic = (v - mem[a]) % P
            cur[a] = (cur[a] + ic) % P
            mem[a] = v
    return V


def _cube_case(case):
    """(port values, tnsh values) of one cube-table function on seeded inputs at
    log K = 3, log T = 4."""
    rng = random.Random(sum(map(ord, case)))
    k_size, t_size = 1 << B_LOG_K, 1 << B_LOG_T
    slot = torch.empty((8, k_size * t_size), dtype=torch.int32)
    if case == "lift_j":
        col = _rand_col(rng, t_size)
        tb.lift_j(slot, limbs.pack(col, "cpu"))
        return _cube(slot), ref_lift_j(col, k_size)
    if case == "lift_k":
        col = _rand_col(rng, k_size)
        tb.lift_k(slot, limbs.pack(col, "cpu"))
        return _cube(slot), ref_lift_k(col, t_size)
    if case == "chi_cube":
        bits = [rng.randrange(2) for _ in range(t_size)]
        kbit = tb.k_bits(B_LOG_K, "cpu")
        got, want = [], []
        for i in range(B_LOG_K):
            tb.chi_cube(slot, torch.tensor(bits, dtype=torch.bool), kbit[i])
            got += _cube(slot)
            want += ref_chi_cube(bits, k_size, i)
        return got, want
    if case == "eq_cube":
        sigma = [rng.randrange(P) for _ in range(B_LOG_K + B_LOG_T)]
        tb.eq_cube(slot, limbs.pack(ref_eq_table(sigma[:B_LOG_K]), "cpu"),
                   limbs.pack(ref_eq_table(sigma[B_LOG_K:]), "cpu"))
        return _cube(slot), [int(v) for v in ref_eq_table(sigma)]
    # val_cube: writes and reads of a few cells, a trailing padding cycle
    ops = [("w" if rng.random() < 0.5 else "r", rng.randrange(3),
            rng.randrange(P)) for _ in range(t_size - 1)]
    waddr = torch.tensor([op[1] if op[0] == "w" else 0 for op in ops] + [0])
    wflag = torch.tensor([op[0] == "w" for op in ops] + [False])
    wv = limbs.pack([op[2] if op[0] == "w" else 0 for op in ops] + [0],
                    "cpu")
    tb.val_cube(slot, waddr, wflag, wv)
    return _cube(slot), _ref_val_cube(ops, k_size, t_size)


@pytest.mark.parametrize("case", ["lift_j", "lift_k", "chi_cube", "eq_cube",
                                  "val_cube"])
def test_cube_table_equals_tnsh(case):
    got, want = _cube_case(case)
    assert got == [int(v) % P for v in want]


def _ref_twist_tables(rb, wb, ot, rv, wv, ic, eq1, eqb, sigma, ops):
    """tnsh's dense TwistBits cube tables (``twist_bits.py:308-318``) in
    ``twist_cube_terms``' slot order."""
    k_size = 1 << len(rb)
    lift = lambda c: ref_lift_j(c, k_size)  # noqa: E731
    return ([lift(eq1), lift([(1 - o) % P for o in ot])]
            + [ref_chi_cube(rb[i], k_size, i) for i in range(len(rb))]
            + [_ref_val_cube(ops, k_size, len(ot)), lift(rv),
               ref_eq_table(sigma), lift(ot)]
            + [ref_chi_cube(wb[i], k_size, i) for i in range(len(wb))]
            + [lift(ic), lift(wv), lift(eqb)]
            + [lift(c) for c in rb + wb])


def _addresses(bits):
    """Each cycle's address from its bit columns."""
    return sum(np.asarray(b, dtype=np.int64) << i for i, b in enumerate(bits))


@pytest.mark.parametrize("which", ["twist_bits", "shout_bits"])
def test_cube_stack_equals_tnsh_tables(which):
    """Every slot of the prover's dense stack against the table tnsh's
    dense path builds for it, and the term lists' slot structure."""
    rng = random.Random(31)
    log_k, log_t = B_LOG_K, B_LOG_T
    k_size, t_size = 1 << log_k, 1 << log_t
    eq1 = ref_eq_table([rng.randrange(P) for _ in range(log_t)])
    eqb = ref_eq_table([rng.randrange(P) for _ in range(log_t)])
    a_pow = [rng.randrange(P) for _ in range(3 + 2 * log_k)]
    if which == "twist_bits":
        ops = [("w" if rng.random() < 0.4 else "r", rng.randrange(k_size),
                rng.randrange(P)) for _ in range(t_size)]
        w = [op[0] == "w" for op in ops]
        rb = [[0 if w[j] else (ops[j][1] >> i) & 1 for j in range(t_size)]
              for i in range(log_k)]
        wb = [[(ops[j][1] >> i) & 1 if w[j] else 0 for j in range(t_size)]
              for i in range(log_k)]
        ot = [int(x) for x in w]
        wv = [op[2] if op[0] == "w" else 0 for op in ops]
        rv, ic = _rand_col(rng, t_size), _rand_col(rng, t_size)
        sigma = [rng.randrange(P) for _ in range(log_k + log_t)]
        columns = BitColumns(log_k, log_t, _addresses(rb),
                             _addresses(wb), np.asarray(w), [rv, wv, ic])
        columns.marshal()
        stack, wbits = tb._twist_cube(columns, eq1, eqb, sigma, "cpu")
        want = _ref_twist_tables(rb, wb, ot, rv, wv, ic, eq1, eqb, sigma,
                                 ops)
        terms = tb.twist_cube_terms(log_k, a_pow, 5)
        assert wbits.tolist() == [[bool(b) for b in c] for c in wb]
        assert (len(terms), max(len(t) for _, t in terms)) == (
            5 + 2 * (2 * log_k + 1), log_k + 3)
    else:
        entries = _rand_col(rng, k_size)
        rb = [[rng.randrange(2) for _ in range(t_size)]
              for _ in range(log_k)]
        rv = _rand_col(rng, t_size)
        columns = BitColumns(log_k, log_t, _addresses(rb), None, None, [rv])
        columns.marshal()
        stack = tb._shout_cube(columns, entries, eq1, eqb, "cpu")
        lift = lambda c: ref_lift_j(c, k_size)  # noqa: E731
        want = ([lift(eq1)]
                + [ref_chi_cube(rb[i], k_size, i) for i in range(log_k)]
                + [ref_lift_k(entries, t_size), lift(rv), lift(eqb)]
                + [lift(c) for c in rb])
        terms = tb.shout_cube_terms(log_k, a_pow, 5)
        assert (len(terms), max(len(t) for _, t in terms)) == (
            2 + 2 * log_k, log_k + 2)
    assert stack.shape == (len(want), 8, k_size * t_size)
    assert 1 + max(f for _, t in terms for f in t) == len(want)
    for f, table in enumerate(want):
        assert _cube(stack[f]) == [int(v) % P for v in table], f


# ---------------------------------------------------------------------------
# the host modules: config and the alias modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["config", "field_utils", "poly_utils"])
def test_host_module_equals_tnsh(module, monkeypatch):
    import dataclasses
    import importlib

    where = {"config": "core", "field_utils": "field",
             "poly_utils": "poly"}[module]
    ref = importlib.import_module(f"tnsh.{where}.{module}")
    port = importlib.import_module(f"tnsh_torch.{where}.{module}")
    if module == "config":
        # use_jax (TNSH_NO_JAX) became device (TNSH_DEVICE)
        ref_fields = {f.name: f.default
                      for f in dataclasses.fields(ref.TnshConfig)}
        port_fields = {f.name: f.default
                       for f in dataclasses.fields(port.TnshConfig)}
        assert ref_fields.pop("use_jax") is True
        assert port_fields.pop("device") == "cuda"
        assert port_fields == ref_fields
        assert set(port.__all__) <= set(dir(ref))
        for env in ({}, {"TNSH_LOG_SIZE": "9", "TNSH_MESH": "2,4",
                         "TNSH_PROFILE_DIR": "traces", "TNSH_NO_NATIVE": "1",
                         "TNSH_DEVICE": "cpu"}):
            for var in ("TNSH_LOG_SIZE", "TNSH_MESH", "TNSH_PROFILE_DIR",
                        "TNSH_NO_NATIVE", "TNSH_DEVICE"):
                monkeypatch.delenv(var, raising=False)
            for var, val in env.items():
                monkeypatch.setenv(var, val)
            a, b = port.from_env(), ref.from_env()
            assert (a.log_size, a.mesh_shape, a.profile_dir, a.use_native,
                    a.derived_max_operations) == (
                b.log_size, b.mesh_shape, b.profile_dir, b.use_native,
                b.derived_max_operations)
            assert a.device == env.get("TNSH_DEVICE", "cuda")
        assert port.TnshConfig(5, max_operations=7).derived_max_operations \
            == ref.TnshConfig(5, max_operations=7).derived_max_operations
        for bad in (1, 31):
            with pytest.raises(ValueError):
                port.TnshConfig(log_size=bad)
        return
    assert port.__all__ == ref.__all__
    rng = random.Random(5)
    xs = [rng.randrange(P) for _ in range(6)]
    as_ints = lambda v: (  # noqa: E731
        [int(x) for x in v] if isinstance(v, list) else int(v))
    if module == "field_utils":
        calls = {
            "batch_inverse": lambda m, fr: m.batch_inverse(
                [fr(x) for x in xs]),
            "horner_eval": lambda m, fr: m.horner_eval(
                [fr(x) for x in xs], fr(xs[0])),
            "inner_product": lambda m, fr: m.inner_product(
                [fr(x) for x in xs[:3]], [fr(x) for x in xs[3:]]),
            "powers": lambda m, fr: m.powers(fr(xs[1]), 5),
            "vanishing_poly_eval": lambda m, fr: m.vanishing_poly_eval(
                [fr(x) for x in xs[:3]], fr(xs[4])),
        }
    else:
        pts = lambda fr: [(fr(i), fr(x)) for i, x in enumerate(xs)]  # noqa
        calls = {
            "derivative": lambda m, fr: m.derivative([fr(x) for x in xs]),
            "evaluate_polynomial": lambda m, fr: m.evaluate_polynomial(
                [fr(x) for x in xs], fr(xs[2])),
            "interpolate_on_range": lambda m, fr: m.interpolate_on_range(
                [fr(x) for x in xs]),
            "lagrange_interpolate": lambda m, fr: m.lagrange_interpolate(
                pts(fr)),
        }
    assert sorted(calls) == sorted(port.__all__)
    for name, call in calls.items():
        assert as_ints(call(port, Fr)) == as_ints(call(ref, RefFr)), name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("which", ["twist_bits", "shout_bits",
                                   "shout_bits_committed"])
def test_card_dense_equals_tnsh_host_proof(which, params, monkeypatch,
                                           request):
    """K=2^10, T=2^14 (the largest dense TwistBits cube one 80 GB card
    holds): the dense path on the card against tnsh's host structured
    prover, with ``bench.py``'s trace and ``benches/bits_bench.py``'s
    lookups.  Run with ``-s`` to see the times and the peak device
    memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # keep tnsh's MSMs on the host: its commit_many otherwise builds a
    # device MSM context under jax before it falls back to the host
    monkeypatch.setenv("TNSH_TPU_MSM", "0")
    monkeypatch.setattr(ref_kzg, "_TPU_MSM_FRACTION", "0")
    (pp, vp), (ref_pp, ref_vp) = params
    log_k, log_t = 10, 14
    dev = torch.device("cuda", 0)
    torch.set_num_threads(os.cpu_count() or 1)
    request.addfinalizer(lambda: torch.set_num_threads(1))
    params_t, _ = setup_multilinear_params(log_t)
    from tnsh_torch.commit.mkzg import MultilinearKZG

    MultilinearKZG.prepare_device(params_t, dev)
    ref_ml_params(log_t)
    rng = random.Random(5)
    if which == "twist_bits":
        ops = [("w" if i % 3 == 0 else "r", rng.randrange(1 << log_k), 42 * i)
               for i in range(1 << log_t)]
        port_in = lambda: _trace(MemoryTrace, Fr, 1 << log_k, ops)  # noqa
        ref_in = _trace(RefMemoryTrace, RefFr, 1 << log_k, ops)
        prover, ref_prover = TwistBits, RefTwistBits
        to_bytes, ref_to_bytes = TwistBits.to_bytes, ref_twist_to_bytes
        check = lambda b: TwistBits.verify(  # noqa: E731
            twist_bits_proof_from_bytes(b), vp)
    else:
        rng = random.Random(11)
        entries = [3 * i + 1 for i in range(1 << log_k)]
        looks = [rng.randrange(1 << log_k) for _ in range((1 << log_t) - 1)]
        port_in = lambda: _table(LookupTable, Fr, entries, looks)  # noqa
        ref_in = _table(RefLookupTable, RefFr, entries, looks)
        if which == "shout_bits":
            prover, ref_prover = ShoutBits, RefShoutBits
            to_bytes, ref_to_bytes = ShoutBits.to_bytes, ref_shout_to_bytes
            check = lambda b: ShoutBits.verify(  # noqa: E731
                shout_bits_proof_from_bytes(b), [Fr(e) for e in entries], vp)
        else:
            prover, ref_prover = ShoutBitsCommitted, RefCommitted
            to_bytes, ref_to_bytes = (ShoutBitsCommitted.to_bytes,
                                      ref_comm_to_bytes)
            comm = ShoutBitsCommitted.preprocess([Fr(e) for e in entries],
                                                 dev)
            check = lambda b: ShoutBitsCommitted.verify(  # noqa: E731
                shout_bits_comm_proof_from_bytes(b), comm, vp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timer = PhaseTimer()
    t0 = time.perf_counter()
    b = to_bytes(_on_path(monkeypatch, "dense",
                          lambda: prover.prove(port_in(), pp, dev, timer)))
    torch.cuda.synchronize()
    port_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    ref_b = ref_to_bytes(ref_prover.prove(ref_in, ref_pp))
    ref_s = time.perf_counter() - t0
    assert b == ref_b
    assert check(ref_b)
    assert sum(c.hazard_count for c in kzg.device_contexts()) == 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"\n{which} dense K=2^{log_k} T=2^{log_t} on {card}: port "
          f"{port_s:.3f} s (stages {timer.phases}), peak {peak_gb:.2f} GB; "
          f"tnsh host structured {ref_s:.3f} s")
