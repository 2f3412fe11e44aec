"""The bit-column provers' one record of committed columns
(``tnsh_torch.protocols.bit_columns.BitColumns``).

On the CPU: the record's columns against the columns tnsh's provers
simulate, word for word, on tnsh's trace shapes and lookup logs and on
the edges (log K = 1, T not a power of two, all reads, all writes,
K = 2^10); one record a prove, whose own ``FrTable`` objects reach the
commitments, the k-phase oracle, phase B and the openings; and the spans
that time the record's words and their uploads, on every phase-A path."""

import random
from unittest import mock

import pytest
import torch

import tnsh.protocols.twist_bits as ref_twist_bits
import tnsh_torch._native as _native
from tnsh.field.fr import Fr as RefFr
from tnsh.protocols.shout import LookupTable as RefLookupTable
from tnsh.protocols.twist import MemoryTrace as RefMemoryTrace
from tnsh_torch.commit.mkzg import MultilinearKZG
from tnsh_torch.field import limbs
from tnsh_torch.protocols import twist_bits
from tnsh_torch.protocols.bit_columns import BitColumns
from tnsh_torch.protocols.twist_bits import (
    Fr,
    LookupTable,
    MemoryTrace,
    ShoutBits,
    TwistBits,
    setup_params,
)
from tnsh_torch.utils.profiling import PhaseTimer

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)


def _mixed(k, n, seed, p_write=0.4):
    rng = random.Random(seed)
    return [("w" if rng.random() < p_write else "r", rng.randrange(k),
             rng.randrange(1 << 62)) for _ in range(n)]


def _trace_shapes():
    """(name, K, ops): tnsh's shape matrix (``tests/test_twist_bits.py``
    ``_adversarial_traces``) and the edges."""
    k = 8
    shapes = [
        ("write_only", k, [("w", i % k, 7 + i) for i in range(16)]),
        ("read_only", k, [("r", i % k, 0) for i in range(16)]),
        ("overwrite_heavy", k,
         [("w", 3, 100 + i) for i in range(12)] + [("r", 3, 0)] * 4),
        ("k2_mixed", 2, [("w", 0, 5), ("r", 0, 0), ("w", 1, 9), ("r", 1, 0),
                         ("w", 0, 11), ("r", 0, 0), ("r", 1, 0),
                         ("w", 1, 13)]),
        ("single_write", k, [("w", 2, 77)]),
        ("single_read", k, [("r", 0, 0)]),
        ("empty", k, []),
        ("dup_heavy", k, [("w" if i % 2 else "r", (i * i) % 2, 50 + i)
                          for i in range(32)]),
        ("mixed_64", k, _mixed(k, 64, 4242)),
        ("log_k_1_padded", 2, _mixed(2, 13, 1)),
        ("padded_37", k, _mixed(k, 37, 2)),
        ("all_reads_padded", k, [("r", i % k, 0) for i in range(21)]),
        ("all_writes_padded", k, [("w", (3 * i) % k, i) for i in range(21)]),
        ("k_2_10", 1 << 10, _mixed(1 << 10, 300, 3)),
    ]
    return shapes


_TRACES = _trace_shapes()


def _trace(cls, fr, k, ops):
    tr = cls(k)
    for kind, addr, val in ops:
        if kind == "w":
            tr.write(addr, fr(val))
        else:
            tr.read(addr)
    return tr


class _Stop(Exception):
    pass


def _ref_twist_columns(k, ops):
    """The columns tnsh's ``TwistBits.prove`` simulates and commits,
    taken where it marshals them."""
    got = []

    def grab(columns):
        got.append(columns)
        raise _Stop

    with mock.patch.object(ref_twist_bits, "_marshal_columns", grab), \
            mock.patch.object(ref_twist_bits, "setup_multilinear_params",
                              lambda n: (None, None)):
        with pytest.raises(_Stop):
            ref_twist_bits.TwistBits.prove(
                _trace(RefMemoryTrace, RefFr, k, ops), None)
    return got[0]


def _words(columns):
    return [limbs.le_bytes(c) for c in columns]


@pytest.mark.parametrize("name,k,ops", _TRACES, ids=[s[0] for s in _TRACES])
def test_twist_columns_equal_tnsh(name, k, ops):
    record = BitColumns.from_trace(_trace(MemoryTrace, Fr, k, ops))
    want = _ref_twist_columns(k, ops)
    log_k = k.bit_length() - 1
    assert (record.log_k, 1 << record.log_t) == (log_k, len(want[0]))
    assert [c.raw for c in record.marshal()] == _words(want), name
    assert [c.raw for c in (record.ot, record.rv, record.wv, record.ic)] \
        == _words(want[2 * log_k:])


def _lookup_logs():
    """(nk, nt, K entries, lookups): tnsh's ShoutBits edge-shape logs
    (entries 3i + 1, T - 1 lookups from ``random.seed(9000 + 10 nk +
    nt)``) and the edges."""
    logs = []
    for nk, nt in [(1, 0), (1, 3), (3, 0), (4, 2)]:
        random.seed(9000 + nk * 10 + nt)
        k = 1 << nk
        looks = [random.randrange(k) for _ in range(max((1 << nt) - 1, 0))]
        logs.append((f"tnsh_{nk}_{nt}", [3 * i + 1 for i in range(k)],
                     looks))
    rng = random.Random(7)
    logs.append(("entries_5_padded", [11, 12, 13, 14, 15],
                 [rng.randrange(5) for _ in range(19)]))
    logs.append(("one_entry", [9], [0, 0, 0]))
    logs.append(("k_2_10", list(range(1, 1025)),
                 [rng.randrange(1024) for _ in range(333)]))
    return logs


_LOOKUPS = _lookup_logs()


def _table(cls, fr, entries, looks):
    t = cls([fr(e) for e in entries])
    for ix in looks:
        t.lookup(ix)
    return t


@pytest.mark.parametrize("name,entries,looks", _LOOKUPS,
                         ids=[s[0] for s in _LOOKUPS])
def test_shout_columns_equal_tnsh(name, entries, looks):
    got_entries, record = BitColumns.from_lookups(
        _table(LookupTable, Fr, entries, looks))
    (ref_entries, log_k, _, log_t, _, rb, rv
     ) = ref_twist_bits._shout_comm_columns(
        _table(RefLookupTable, RefFr, entries, looks))
    assert (got_entries, record.log_k, record.log_t) == (
        ref_entries, log_k, log_t)
    assert [c.raw for c in record.marshal()] == _words(rb + [rv]), name
    assert record.rv.raw == limbs.le_bytes(rv)
    assert [row.tolist() for row in record.read_bits] == [
        [bool(b) for b in col] for col in rb]


def _twist_prove(pp, timer, log_t):
    tr = _trace(MemoryTrace, Fr, 8, _mixed(8, 1 << log_t, 5, p_write=1 / 3))
    return TwistBits.prove(tr, pp, "cpu", timer)


def _shout_prove(pp, timer, log_t):
    rng = random.Random(11)
    tbl = _table(LookupTable, Fr, [3 * i + 1 for i in range(8)],
                 [rng.randrange(8) for _ in range((1 << log_t) - 1)])
    return ShoutBits.prove(tbl, pp, "cpu", timer)


PROVES = {"twist_bits": _twist_prove, "shout_bits": _shout_prove}


@pytest.mark.parametrize("prover", sorted(PROVES))
def test_one_record_a_prove(prover):
    """At T = 2^10 (the engine's paths of the commitments and the
    openings) the commitments, the k-phase oracle (the engine's inputs),
    phase B and the openings each receive the record's own ``FrTable``
    objects: nothing rebuilds a column."""
    records, commits, engine, phase_b, openings = [], [], [], [], []
    real_marshal = BitColumns.marshal
    real_commit = MultilinearKZG.commit_many
    real_tbk, real_sbk = _native.tbk_create, _native.sbk_create
    real_sop, real_open = twist_bits.TorchSopOracleD, twist_bits._Openings

    def marshal(self):
        records.append(self)
        return real_marshal(self)

    def commit_many(params, tables, device):
        commits.append(tables)
        return real_commit(params, tables, device)

    def tbk_create(*args):
        engine.extend(args[5:8])             # rv, wv, ic
        return real_tbk(*args)

    def sbk_create(log_k, log_t, j_tables, *args):
        engine.extend(j_tables)
        return real_sbk(log_k, log_t, j_tables, *args)

    def sop(num_vars, terms, *args, **kwargs):
        phase_b.extend(terms[0][1][1:3])     # ot, ic
        return real_sop(num_vars, terms, *args, **kwargs)

    def open_(columns, groups, device):
        openings.append(columns)
        return real_open(columns, groups, device)

    with mock.patch.object(BitColumns, "marshal", marshal), \
            mock.patch.object(MultilinearKZG, "commit_many",
                              staticmethod(commit_many)), \
            mock.patch.object(_native, "tbk_create", tbk_create), \
            mock.patch.object(_native, "sbk_create", sbk_create), \
            mock.patch.object(twist_bits, "TorchSopOracleD", sop), \
            mock.patch.object(twist_bits, "_Openings", open_):
        PROVES[prover](setup_params(4)[0], PhaseTimer(), 10)
    (record,) = records
    columns = record.columns
    assert len(columns) == (10 if prover == "twist_bits" else 4)  # K = 8
    (committed,) = commits
    (opened,) = openings
    assert all(a is b for a, b in zip(committed, columns))
    assert all(a is b for a, b in zip(opened, columns))
    assert len(committed) == len(opened) == len(columns)
    if prover == "twist_bits":
        assert [id(t) for t in engine] == [
            id(record.rv), id(record.wv), id(record.ic)]
        assert phase_b[0] is record.ot and phase_b[1] is record.ic
    else:
        assert any(t is record.rv for t in engine)
        assert not phase_b


#: the phase-A paths, by the environment that selects each
PATHS = {"structured_native": {}, "structured_py": {"TNSH_NO_NATIVE": "1"},
         "dense": {"TNSH_BITS_DENSE": "1"}}

#: the spans each path's prove opens for the record and its uploads
SPANS = {
    "structured_native": {"commit/marshal", "oracle_a_build/marshal",
                          "j_build/upload"},
    "structured_py": {"commit/marshal", "oracle_a_build/marshal",
                      "j_build/upload"},
    "dense": {"commit/marshal", "cube_build/columns", "cube_build/lift",
              "cube_build/chi", "cube_build/oracle"},
}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("prover", sorted(PROVES))
def test_record_spans_open_on_every_path(prover, path, monkeypatch):
    for var, val in PATHS[path].items():
        monkeypatch.setenv(var, val)
    timer = PhaseTimer()
    PROVES[prover](setup_params(4)[0], timer, 6)
    want = set(SPANS[path])
    if path == "dense" and prover == "twist_bits":
        want |= {"cube_build/val", "cube_build/eq"}
    assert want <= set(timer.phases), want - set(timer.phases)
