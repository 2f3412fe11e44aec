"""The port's TwistSound against tnsh's: byte-identical proofs on the dense
and the sparse path, and each package's verifier accepts the other's
bytes, on the CPU (the plain PyTorch versions of the kernels) and, marked
``cuda``, on the card at K=2^10.  Mirrors the TwistSound cases of
``tests/test_sound.py`` and ``tests/test_sound_sparse.py`` and the frozen
TWSS digests of ``tests/test_golden_vectors.py``, and holds the port's
``SparseCubeOracle`` against tnsh's round for round on the prover's own
18-term system.

The two packages share no objects: each gets its own trace, cube tables,
parameters and native engine, and proofs cross over only as bytes.
Outside the one case at n = 14, ``kzg.DEVICE_MSM_MIN`` is lifted out of
reach, so the port's MSMs run on the native host MSM (its scheduled
Pippenger's plain version takes seconds an MSM on the CPU)."""

import copy
import hashlib
import os
import random
import subprocess
import time

import pytest
import torch

import tnsh_torch
import tnsh_torch._native as _native
from tnsh.commit import kzg as ref_kzg
from tnsh.commit.mkzg import (
    clear_external_multilinear_srs as ref_clear_external,
    generate_multilinear_srs as ref_generate_srs,
    install_external_multilinear_srs as ref_install_external,
)
from tnsh.commit.mkzg_sparse import IncrementalCubeTable as RefIncTable
from tnsh.commit.mkzg_sparse import SparseCubeTable as RefSparseTable
from tnsh.commit.mkzg_sparse import commit_incremental as ref_commit_inc
from tnsh.commit.mkzg_sparse import commit_sparse as ref_commit_sparse
from tnsh.commit.mkzg_sparse import cube_params as ref_cube_params
from tnsh.commit.mkzg_sparse import (
    incremental_mle_eval as ref_incremental_mle_eval,
)
from tnsh.commit.mkzg_sparse import open_incremental as ref_open_incremental
from tnsh.core.params import setup_params as ref_setup_params
from tnsh.core.proof_io import (
    twist_sound_proof_from_bytes as ref_from_bytes,
    twist_sound_proof_to_bytes as ref_to_bytes,
)
from tnsh.field.fr import Fr as RefFr
from tnsh.iop.sparse_oracle import SparseCubeOracle as RefOracle
from tnsh.protocols.sound import TwistSound as RefTwistSound
from tnsh.protocols.twist import MemoryTrace as RefMemoryTrace
from tnsh_torch.commit import kzg
from tnsh_torch.commit.mkzg import (
    MultilinearKZG,
    clear_external_multilinear_srs,
    generate_multilinear_srs,
    install_external_multilinear_srs,
    setup_multilinear_params,
)
from tnsh_torch.commit.mkzg_sparse import (
    IncrementalCubeTable,
    commit_cube_batch,
    commit_incremental,
    commit_sparse,
    cube_params,
    incremental_mle_eval,
    open_incremental,
)
from tnsh_torch.core.params import setup_params
from tnsh_torch.core.proof_io import twist_sound_proof_from_bytes
from tnsh_torch.core.transcript import Transcript
from tnsh_torch.errors import InvalidParametersError
from tnsh_torch.field import fr_kernels
from tnsh_torch.field.fr import MODULUS as P
from tnsh_torch.field.fr import Fr
from tnsh_torch.iop.sparse_oracle import SparseCubeOracle
from tnsh_torch.poly.eq import mle_eval
from tnsh_torch.protocols.sound import (
    TwistSound,
    _twist_challenges,
    _twist_sparse_terms,
    _twist_witness,
)
from tnsh_torch.protocols.twist import MemoryTrace
from tnsh_torch.utils.profiling import GcCollections, PhaseTimer

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

#: size -> (length, sha256) of the TwistSound proof of ``_golden_ops``
#: (tests/test_golden_vectors.py, ``_SOUND_PROOF_VECTORS``)
FROZEN = {
    4: (1280, "fe15a0d7c7eea336b6bf36d12903ba038c5186b5da570883d4aae2a200abd34f"),
    8: (1648, "cde2f0f9c146d92d2ad7d6d1f8ea03074ff5ca2387ab0ff6dbbef486da87e91f"),
    16: (2016,
         "9139c9a87ad807fd3de1e67d52c15612ac6a96d313af4fafe22861b787eef58d"),
}


@pytest.fixture(scope="module")
def params():
    """((port pp, vp), (tnsh pp, vp)) from the same deterministic setup."""
    return setup_params(4), ref_setup_params(4)


@pytest.fixture
def host_msm(monkeypatch):
    """Every MSM of the port on the native host MSM."""
    monkeypatch.setattr(kzg, "DEVICE_MSM_MIN", 1 << 62)


def _traces(size, ops):
    """(port trace, tnsh trace) of the same operations: ``("w", cell,
    value)`` or ``("r", cell)``."""
    out = []
    for cls, fr in ((MemoryTrace, Fr), (RefMemoryTrace, RefFr)):
        tr = cls(size)
        for op in ops:
            if op[0] == "w":
                tr.write(op[1], fr(op[2]))
            else:
                tr.read(op[1])
        out.append(tr)
    return tuple(out)


def _golden_ops(size):
    """The trace of the frozen TWSS digests: write 42 (i + 1) to cell i,
    then read it, for i < size / 2."""
    ops = []
    for i in range(size // 2):
        ops += [("w", i % size, 42 * (i + 1)), ("r", i % size)]
    return ops


def _mixed_ops(size, n_ops, seed=3):
    """``tests/test_sound_sparse.py``'s ``_mixed_trace``: every third
    operation a write of a random 31-bit value, reads otherwise."""
    rng = random.Random(seed)
    ops = []
    for i in range(n_ops):
        if i % 3 == 0:
            ops.append(("w", rng.randrange(size), rng.randrange(1 << 31)))
        else:
            ops.append(("r", rng.randrange(size)))
    return ops


def _sample_ops():
    """``tests/test_sound.py``'s sample trace."""
    return [("w", 1, 42), ("w", 3, 7), ("r", 1), ("w", 1, 100), ("r", 1),
            ("r", 5)]


def _bench_ops(log_k, log_t):
    """The trace of ``benches/sound_sparse_bench.py``: ``random.seed(1)``,
    a write of 42 i to a random cell when i % 3 == 0, else a read."""
    rng = random.Random(1)
    k = 1 << log_k
    return [("w", rng.randrange(k), 42 * i) if i % 3 == 0
            else ("r", rng.randrange(k)) for i in range(1 << log_t)]


def _cross_verify(port_bytes, ref_bytes, vp, ref_vp):
    """tnsh's verifier on the port's bytes, the port's on tnsh's."""
    assert RefTwistSound.verify(ref_from_bytes(port_bytes), ref_vp)
    assert TwistSound.verify(twist_sound_proof_from_bytes(ref_bytes), vp)


# ---------------------------------------------------------------------------
# Proof bytes against tnsh's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [4, 8, 16])
def test_frozen_digests_and_bytes_equal_tnsh(size, host_msm):
    """The dense path at the golden sizes (n = 4, 6, 8)."""
    pp, vp = setup_params(size.bit_length() - 1)
    ref_pp, ref_vp = ref_setup_params(size.bit_length() - 1)
    tr, ref_tr = _traces(size, _golden_ops(size))
    proof = tnsh_torch.TwistSound.prove(tr, pp, "cpu")
    b = TwistSound.to_bytes(proof)
    assert (len(b), hashlib.sha256(b).hexdigest()) == FROZEN[size]
    ref_b = ref_to_bytes(RefTwistSound.prove(ref_tr, ref_pp))
    assert b == ref_b
    assert TwistSound.verify(proof, vp)
    _cross_verify(b, ref_b, vp, ref_vp)


def _write_heavy():
    return [("w", 3, 1000 + i) for i in range(12)]


def _skewed():
    """Nine in ten operations on cell 6, the rest spread over the memory."""
    rng = random.Random(17)
    ops = []
    for i in range(15):
        cell = 6 if rng.random() < 0.9 else rng.randrange(8)
        ops.append(("w", cell, rng.randrange(P)) if i % 2 == 0
                   else ("r", cell))
    return ops


@pytest.mark.parametrize("case", ["mixed", "write_heavy", "skewed"])
def test_dense_equals_sparse_and_tnsh(case, params, host_msm):
    """``tests/test_sound_sparse.py``'s traces at K=8 on both paths of both
    packages: one proof."""
    (pp, vp), (ref_pp, ref_vp) = params
    ops = {"mixed": lambda: _mixed_ops(8, 11), "write_heavy": _write_heavy,
           "skewed": _skewed}[case]()
    tr, ref_tr = _traces(8, ops)
    timer = PhaseTimer()
    dense = TwistSound.to_bytes(TwistSound.prove(tr, pp, "cpu",
                                                 sparse=False))
    sparse = TwistSound.prove(tr, pp, "cpu", timer, sparse=True)
    b = TwistSound.to_bytes(sparse)
    assert dense == b
    assert b == ref_to_bytes(RefTwistSound.prove(ref_tr, ref_pp,
                                                 sparse=True))
    assert b == ref_to_bytes(RefTwistSound.prove(ref_tr, ref_pp,
                                                 sparse=False))
    assert TwistSound.verify(sparse, vp)
    _cross_verify(b, b, vp, ref_vp)
    assert {"simulate", "srs", "commit", "k_rounds", "j_build", "j_rounds",
            "open", "commit/host_msm", "open/host_msm"} <= set(timer.phases)
    # on the CPU every kernel wrapper takes its plain version
    assert all(n == 0 for per in timer.launches.values()
               for n in per.values())


def test_sparse_at_14_vars_on_the_default_route(params):
    """K=2^5, T=2^9 picks the sparse path by itself with the router as it
    ships: the seven commitments (512 points each), the cube opening's 9
    j and 5 k levels and the column opening's 9 all stay under 1024
    points, so all 30 MSMs run on the native host MSM."""
    (pp, vp), (ref_pp, ref_vp) = params
    tr, ref_tr = _traces(32, _mixed_ops(32, 500, seed=7))
    kzg.reset_route_counts()
    timer = PhaseTimer()
    proof = TwistSound.prove(tr, pp, "cpu", timer)
    assert kzg.route_counts() == {"device": 0, "host": 30}
    assert "k_rounds" in timer.phases          # the sparse path ran
    b = TwistSound.to_bytes(proof)
    ref_b = ref_to_bytes(RefTwistSound.prove(ref_tr, ref_pp))
    assert b == ref_b
    _cross_verify(b, ref_b, vp, ref_vp)


@pytest.mark.parametrize("case", ["empty", "write_only", "read_only",
                                  "overwrite", "padding", "k1_sparse"])
def test_edge_shapes_equal_tnsh(case, params, host_msm):
    """``tests/test_sound.py``'s edge traces, each on both paths: an empty
    trace (T = 1), writes only, reads only, an overwrite sequence, a trace
    whose padding reads cell 0, and a one-cell memory (log K = 0: no k
    rounds, the j phase built at construction)."""
    (pp, vp), (ref_pp, ref_vp) = params
    size, ops = {
        "empty": (4, []),
        "write_only": (4, [("w", i, i * 10) for i in range(4)]),
        "read_only": (4, [("r", i) for i in range(4)]),
        "overwrite": (2, [("w", 0, 1), ("w", 0, 2), ("w", 0, 3), ("r", 0)]),
        "padding": (8, [("w", 7, 5), ("r", 7), ("r", 0)]),
        "k1_sparse": (1, [("w", 0, 12345678), ("r", 0), ("w", 0, 9),
                          ("r", 0), ("r", 0)]),
    }[case]
    tr, ref_tr = _traces(size, ops)
    out = set()
    for sparse in (False, True):
        proof = TwistSound.prove(tr, pp, "cpu", sparse=sparse)
        assert TwistSound.verify(proof, vp)
        out.add(TwistSound.to_bytes(proof))
        if case == "k1_sparse" and sparse:
            # tnsh's sparse prover reads the k residue's first BYTE as its
            # value when log K = 0 (tnsh/commit/mkzg_sparse.py, the last
            # line of _open_j_then_k), and its own opened-value check
            # refuses the proof; the port's equals both dense proofs
            with pytest.raises(AssertionError):
                RefTwistSound.prove(ref_tr, ref_pp, sparse=True)
            continue
        out.add(ref_to_bytes(RefTwistSound.prove(ref_tr, ref_pp,
                                                 sparse=sparse)))
    assert len(out) == 1
    (b,) = out
    _cross_verify(b, b, vp, ref_vp)


# ---------------------------------------------------------------------------
# Forged proofs (tests/test_sound.py:327-382)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sample_proof(params):
    """The sample trace's proof, made once (host MSMs)."""
    (pp, _), _ = params
    saved, kzg.DEVICE_MSM_MIN = kzg.DEVICE_MSM_MIN, 1 << 62
    try:
        tr, _ = _traces(8, _sample_ops())
        return TwistSound.prove(tr, pp, "cpu")
    finally:
        kzg.DEVICE_MSM_MIN = saved


@pytest.mark.parametrize("tamper", [f"cube_value_{i}" for i in range(4)]
                         + [f"col_value_{i}" for i in range(3)]
                         + ["final_evaluation", "cube_quotient",
                            "col_quotient", "swapped_commitments"])
def test_tampered_proofs_rejected(tamper, sample_proof, params):
    """Every claimed value, the final evaluation, a quotient of each
    opening and the order of the commitments are bound."""
    (_, vp), _ = params
    assert TwistSound.verify(sample_proof, vp)
    bad = copy.deepcopy(sample_proof)
    kind, _, idx = tamper.rpartition("_")
    if kind == "cube_value":
        bad.cube_values[int(idx)] = bad.cube_values[int(idx)] + Fr(1)
    elif kind == "col_value":
        bad.col_values[int(idx)] = bad.col_values[int(idx)] + Fr(1)
    elif tamper == "final_evaluation":
        bad.check.final_evaluation = bad.check.final_evaluation + Fr(1)
    elif tamper in ("cube_quotient", "col_quotient"):
        qs = (bad.cube_proof if tamper == "cube_quotient"
              else bad.col_proof).quotients
        qs[0] = qs[0].add(qs[0])
    else:
        bad.ra_commitment, bad.wa_commitment = (bad.wa_commitment,
                                                bad.ra_commitment)
    assert not TwistSound.verify(bad, vp)


def test_stale_read_forgery_rejected(params, host_msm):
    """Honest tables for [write 1 = 42, write 1 = 100, read 1] but a claim
    that the read saw the stale 42: the READ group's final binding or the
    pairing check against the honest commitment refuses it."""
    (pp, vp), _ = params
    tr, _ = _traces(8, [("w", 1, 42), ("w", 1, 100), ("r", 1)])
    honest = TwistSound.prove(tr, pp, "cpu")
    bad = copy.deepcopy(honest)
    bad.col_values[1] = Fr(42)
    assert not TwistSound.verify(bad, vp)
    assert TwistSound.verify(honest, vp)


def test_external_srs_dense_path_equals_tnsh(params, host_msm):
    """Under an installed ceremony SRS the prover takes the dense path and
    opens the cube RLC in suffix order; forcing the sparse path is
    refused."""
    (pp, vp), (ref_pp, ref_vp) = params
    for n_vars in (2, 3, 4):
        taus = [1000 + 7 * i for i in range(n_vars)]
        p_ext, vk_ext = generate_multilinear_srs(
            n_vars, [Fr(t) for t in taus], keep_taus=False)
        install_external_multilinear_srs(p_ext, vk_ext)
        ref_install_external(*ref_generate_srs(
            n_vars, [RefFr(t) for t in taus], keep_taus=False))
    try:
        tr, ref_tr = _traces(4, [("w", 2, 9), ("r", 2), ("w", 0, 4),
                                 ("r", 1)])
        proof = TwistSound.prove(tr, pp, "cpu")
        assert TwistSound.verify(proof, vp)
        b = TwistSound.to_bytes(proof)
        ref_b = ref_to_bytes(RefTwistSound.prove(ref_tr, ref_pp))
        assert b == ref_b
        _cross_verify(b, ref_b, vp, ref_vp)
        bad = copy.deepcopy(proof)
        bad.col_values[1] = bad.col_values[1] + Fr(1)
        assert not TwistSound.verify(bad, vp)
        with pytest.raises(InvalidParametersError, match="ceremony"):
            TwistSound.prove(tr, pp, "cpu", sparse=True)
    finally:
        clear_external_multilinear_srs()
        ref_clear_external()


def test_serde_roundtrip(sample_proof, params):
    (_, vp), _ = params
    data = TwistSound.to_bytes(sample_proof)
    back = twist_sound_proof_from_bytes(data)
    assert TwistSound.to_bytes(back) == data
    assert TwistSound.verify(back, vp)


@pytest.mark.parametrize("fault", ["magic", "version"])
def test_bad_header_refused(fault, sample_proof):
    data = bytearray(TwistSound.to_bytes(sample_proof))
    if fault == "magic":
        data[:4] = b"SHSS"
    else:
        data[4:8] = (1).to_bytes(4, "little")
    with pytest.raises(InvalidParametersError, match=fault):
        twist_sound_proof_from_bytes(bytes(data))


# ---------------------------------------------------------------------------
# The oracle on the prover's term system, against tnsh's
# ---------------------------------------------------------------------------

def _to_ref(table):
    """tnsh's copy of one of the port's cube tables."""
    if isinstance(table, IncrementalCubeTable):
        out = RefIncTable(table.log_k, table.log_t)
        for j, ups in enumerate(table.updates):
            for k, d in ups:
                out.add_update(j, k, d)
        return out
    out = RefSparseTable(table.log_k, table.log_t)
    for j, col in enumerate(table.cols):
        for k, v in col:
            out.set(j, k, v)
    return out


def _prover_terms(log_k, log_t, seed):
    """The sparse prover's 18 terms on a random trace and random
    challenges, once over the port's tables and once over tnsh's copies
    of them (the same sharing, so identity deduplication sees the same
    tables in both)."""
    ops = _mixed_ops(1 << log_k, (1 << log_t) - 3, seed=seed)
    witness = _twist_witness(
        [op for op in _traces(1 << log_k, ops)[0].operations], log_k, log_t)
    ref_witness = tuple(_to_ref(t) for t in witness[:4]) + witness[4:]
    transcript = Transcript(bytes(range(32)))
    ch = _twist_challenges(transcript, log_k, log_t)
    return (_twist_sparse_terms(log_k, log_t, witness, ch),
            _twist_sparse_terms(log_k, log_t, ref_witness, ch))


def test_oracle_rounds_equal_tnsh():
    """Every round's four evaluations and the final evaluation on the
    prover's 18 terms at log K = 3, log T = 5."""
    log_k, log_t = 3, 5
    terms, ref_terms = _prover_terms(log_k, log_t, seed=29)
    port = SparseCubeOracle(log_k, log_t, terms, device="cpu")
    ref = RefOracle(log_k, log_t, ref_terms)
    rng = random.Random(5)
    challenges = [rng.randrange(P) for _ in range(log_k + log_t)]
    try:
        for rd, c in enumerate(challenges):
            got = port.round_evaluations(rd)
            assert len(got) == 4, rd
            assert [int(v) for v in got] == [
                int(v) for v in ref.round_evaluations(rd)], rd
            port.bind(Fr(c))
            ref.bind(RefFr(c))
        assert int(port.final_evaluation([Fr(c) for c in challenges])) \
            == int(ref.final_evaluation([RefFr(c) for c in challenges]))
        # 16 stacked tables, 18 terms; the all-ones table of a term left
        # with no table is not needed (every term keeps an eqj table)
        d = port._delegate
        assert d.tables.shape[0] == 16 and len(d._idxs) == 18
    finally:
        port.release()


def test_j_phase_program_at_k_1024(params, host_msm, monkeypatch):
    """The j phase a K=2^10 prove hands the card, which ``chip_smoke.py``
    phase 13 holds against its plain version and times: 18 terms over 16
    stacked tables, 29 products a pair and point against 41 term by
    term, two stack slots."""
    from chip_smoke import twist_sound_j_terms

    (pp, _), _ = params
    built = []
    real = SparseCubeOracle._build_delegate

    def build(self):
        real(self)
        built.append((self._delegate._idxs, self._delegate.tables.shape[0],
                      self._delegate._desc))

    monkeypatch.setattr(SparseCubeOracle, "_build_delegate", build)
    tr, _ = _traces(1 << 10, _bench_ops(10, 4))
    TwistSound.prove(tr, pp, "cpu")
    ((idxs, n_tables, desc),) = built
    assert (idxs, n_tables) == twist_sound_j_terms()
    assert (n_tables, len(idxs), desc.products, desc.products_unfactored,
            desc.depth) == (16, 18, 29, 41, 2)


def _cube_system(log_k, log_t, seed):
    """tnsh's four-term cube system (``tests/test_jax_backend.py``'s
    sharded cube case): a one-hot colsparse table, a colinc table, and
    terms of classes S, S (the one-hot squared), I and E.  Returns (port
    terms, tnsh terms) over the same values."""
    from tnsh_torch.commit.mkzg_sparse import SparseCubeTable

    rng = random.Random(seed)
    sp = SparseCubeTable(log_k, log_t)
    inc = IncrementalCubeTable(log_k, log_t)
    for j in range(1 << log_t):
        sp.set(j, rng.randrange(1 << log_k), 1)
        if j % 3:
            inc.add_update(j, rng.randrange(1 << log_k), rng.randrange(P))
    eqj = [rng.randrange(P) for _ in range(1 << log_t)]
    eqk = [rng.randrange(P) for _ in range(1 << log_k)]

    def terms(sp, inc):
        return [
            (1, [("eqj", eqj), ("colsparse", sp), ("colinc", inc)]),
            (P - 2, [("eqk", eqk), ("colsparse", sp), ("colsparse", sp)]),
            (3, [("eqk", eqk), ("colinc", inc)]),
            (5, [("eqj", eqj), ("eqk", eqk)]),
        ]

    return terms(sp, inc), terms(_to_ref(sp), _to_ref(inc))


@pytest.mark.parametrize("case", ["prover_terms", "s_i_e"])
def test_python_k_phase_equals_native_and_tnsh(case):
    """``use_native=False``: every round's four evaluations and the final
    evaluation equal the native k phase's and tnsh's Python k phase's
    (``SparseCubeOracle(use_native=False)``) on the same terms."""
    if case == "prover_terms":
        log_k, log_t = 3, 5
        terms, ref_terms = _prover_terms(log_k, log_t, seed=31)
    else:
        log_k, log_t = 3, 6
        terms, ref_terms = _cube_system(log_k, log_t, seed=97)
    py = SparseCubeOracle(log_k, log_t, terms, device="cpu",
                          use_native=False)
    nat = SparseCubeOracle(log_k, log_t, terms, device="cpu")
    ref = RefOracle(log_k, log_t, ref_terms, use_native=False)
    rng = random.Random(11)
    challenges = [rng.randrange(P) for _ in range(log_k + log_t)]
    try:
        for rd, c in enumerate(challenges):
            got = [int(v) for v in py.round_evaluations(rd)]
            assert got == [int(v) for v in nat.round_evaluations(rd)], rd
            assert got == [int(v) for v in ref.round_evaluations(rd)], rd
            py.bind(Fr(c))
            nat.bind(Fr(c))
            ref.bind(RefFr(c))
        final = int(py.final_evaluation([Fr(c) for c in challenges]))
        assert final == int(nat.final_evaluation([Fr(c) for c in challenges]))
        assert final == int(ref.final_evaluation(
            [RefFr(c) for c in challenges]))
    finally:
        py.release()
        nat.release()


def test_python_k_phase_needs_no_native_engine(monkeypatch):
    """The Python k phase and its card j phase run with the engine
    switched off, and prove the bytes the native k phase proves."""
    from tnsh_torch.core.proof_io import sumcheck_proof_to_bytes
    from tnsh_torch.iop.sumcheck import SumCheck

    log_k, log_t = 2, 4
    terms, _ = _cube_system(log_k, log_t, seed=7)
    probe = SparseCubeOracle(log_k, log_t, terms, device="cpu")
    ev = probe.round_evaluations(0)
    probe.release()
    sc = SumCheck(log_k + log_t, ev[0] + ev[1])
    want = sumcheck_proof_to_bytes(sc.prove(
        SparseCubeOracle(log_k, log_t, terms, device="cpu"),
        Transcript(bytes([43]) * 32)))
    monkeypatch.setenv("TNSH_NO_NATIVE", "1")
    assert _native.available is False
    got = sumcheck_proof_to_bytes(sc.prove(
        SparseCubeOracle(log_k, log_t, terms, device="cpu",
                         use_native=False),
        Transcript(bytes([43]) * 32)))
    assert got == want


def test_colinc_start_seeds_both_k_phases():
    """A seeded colinc scan (the column-sharded mesh's, a random start
    each k round) gives the same round evaluations on the native and the
    Python k phase, and tnsh's Python k phase agrees; so do the two
    paths' delta totals at every fold level.  A start of the wrong shape
    is refused."""
    from tnsh_torch.errors import SumCheckError

    log_k, log_t = 3, 6
    terms, ref_terms = _cube_system(log_k, log_t, seed=5)
    nat = SparseCubeOracle(log_k, log_t, terms, device="cpu")
    py = SparseCubeOracle(log_k, log_t, terms, device="cpu",
                          use_native=False)
    ref = RefOracle(log_k, log_t, ref_terms, use_native=False)
    rng = random.Random(17)
    try:
        with pytest.raises(SumCheckError, match="colinc start"):
            nat.set_colinc_start([[0] * 4])
        for rd in range(log_k):
            k_rem = 1 << (log_k - rd)
            assert nat.inc_totals() == py.inc_totals(), rd
            start = [[rng.randrange(P) for _ in range(k_rem)]]
            for o in (nat, py, ref):
                o.set_colinc_start(start)
            got = [int(v) for v in nat.round_evaluations(rd)]
            assert got == [int(v) for v in py.round_evaluations(rd)], rd
            assert got == [int(v) for v in ref.round_evaluations(rd)], rd
            c = rng.randrange(P)
            nat.bind(Fr(c))
            py.bind(Fr(c))
            ref.bind(RefFr(c))
    finally:
        nat.release()
        py.release()


def _engine_refused():
    raise RuntimeError("the native engine was reached under TNSH_NO_NATIVE")


def test_explicit_native_refused_without_engine(monkeypatch):
    """``use_native=True`` on the prover's terms without the engine
    raises: there is no silent fallback to the Python k phase."""
    terms, _ = _prover_terms(2, 3, seed=3)
    monkeypatch.setenv("TNSH_NO_NATIVE", "1")
    assert _native.available is False
    with pytest.raises(RuntimeError, match="native"):
        SparseCubeOracle(2, 3, terms, device="cpu", use_native=True)


def test_default_oracle_takes_python_k_phase_without_engine(monkeypatch):
    """Under TNSH_NO_NATIVE the default oracle on the prover's 18 terms
    runs the Python k phase, reaches nothing of the engine, and its rounds
    are tnsh's."""
    log_k, log_t = 3, 5
    terms, ref_terms = _prover_terms(log_k, log_t, seed=29)
    monkeypatch.setenv("TNSH_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_load", _engine_refused)
    port = SparseCubeOracle(log_k, log_t, terms, device="cpu")
    assert port.use_native is False
    ref = RefOracle(log_k, log_t, ref_terms, use_native=False)
    rng = random.Random(5)
    challenges = [rng.randrange(P) for _ in range(log_k + log_t)]
    try:
        for rd, c in enumerate(challenges):
            assert [int(v) for v in port.round_evaluations(rd)] == [
                int(v) for v in ref.round_evaluations(rd)], rd
            port.bind(Fr(c))
            ref.bind(RefFr(c))
        assert int(port.final_evaluation([Fr(c) for c in challenges])) \
            == int(ref.final_evaluation([RefFr(c) for c in challenges]))
    finally:
        port.release()


@pytest.mark.parametrize("log_k,log_t", [(2, 3), (4, 6), (6, 8), (0, 3)])
def test_sparse_prove_without_native_engine(log_k, log_t, params,
                                            monkeypatch, host_msm):
    """Under TNSH_NO_NATIVE the sparse prover reaches nothing of the
    engine, though the engine's set-ups of the same sizes were cached
    first, and its bytes are tnsh's sparse prove in the same mode (at
    log K = 0 too: tnsh's engine-free opening reads the k residue right);
    each verifier accepts the other's bytes."""
    (_, vp), (_, ref_vp) = params
    tr, ref_tr = _traces(1 << log_k, _bench_ops(log_k, log_t))
    cube_params(log_k, log_t)
    setup_multilinear_params(log_t)
    timer = PhaseTimer()
    with monkeypatch.context() as m:
        m.setenv("TNSH_NO_NATIVE", "1")
        m.setattr(_native, "_load", _engine_refused)
        b = TwistSound.to_bytes(TwistSound.prove(
            tr, setup_params(4)[0], "cpu", timer, sparse=True))
        ref_b = ref_to_bytes(RefTwistSound.prove(
            ref_tr, ref_setup_params(4)[0], sparse=True))
    assert {"k_rounds" if log_k else "j_build", "j_rounds"} <= set(
        timer.phases)
    assert b == ref_b
    _cross_verify(b, ref_b, vp, ref_vp)


@pytest.mark.parametrize("where", ["k_round", "j_round"])
def test_sco_freed_once_when_a_round_raises(where, params, monkeypatch,
                                            host_msm):
    (pp, _), _ = params
    created, freed = [], []
    real_create, real_free = _native.sco_create, _native.sco_free

    def create(*args, **kw):
        created.append(real_create(*args, **kw))
        return created[-1]

    def free(h):
        freed.append(h)
        real_free(h)

    def boom(*_args):
        raise RuntimeError(f"{where} failed")

    monkeypatch.setattr(_native, "sco_create", create)
    monkeypatch.setattr(_native, "sco_free", free)
    if where == "k_round":
        monkeypatch.setattr(_native, "sco_round_evals", boom)
    else:
        monkeypatch.setattr(fr_kernels, "sum_of_products_round_evals", boom)
    tr, _ = _traces(8, _sample_ops())
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        TwistSound.prove(tr, pp, "cpu", sparse=True)
    assert len(created) == 1 and freed == created


# ---------------------------------------------------------------------------
# The factorized commitments of an incremental table
# ---------------------------------------------------------------------------

def _cube_tables(log_k, log_t, seed):
    """(port tables, tnsh tables): ra, wa, inc, val of a random trace."""
    ops = _mixed_ops(1 << log_k, 1 << log_t, seed=seed)
    tr = _traces(1 << log_k, ops)[0]
    tables = _twist_witness(list(tr.operations), log_k, log_t)[:4]
    return tables, [_to_ref(t) for t in tables]


def test_commit_cube_batch_equals_single_commitments(host_msm):
    """One burst of four gives each table's own commitment, and tnsh's."""
    log_k, log_t = 3, 6
    tables, ref_tables = _cube_tables(log_k, log_t, seed=11)
    cp, ref_cp = cube_params(log_k, log_t), ref_cube_params(log_k, log_t)
    batch = commit_cube_batch(cp, tables, "cpu")
    single = [commit_sparse(cp, t, "cpu") for t in tables[:3]] + [
        commit_incremental(cp, tables[3], "cpu")]
    assert batch == single
    ref = [ref_commit_sparse(ref_cp, t) for t in ref_tables[:3]] + [
        ref_commit_inc(ref_cp, ref_tables[3])]
    assert [c.serialize_compressed() for c in batch] == [
        c.serialize_compressed() for c in ref]


@pytest.mark.parametrize("shape", [(3, 6), (1, 5), (4, 0), (0, 4)])
def test_incremental_eval_and_opening_equal_tnsh(shape, host_msm):
    """``incremental_mle_eval`` and ``open_incremental`` on val, at a
    random point: the value against the dense table's MLE, the opening
    against the PST check, and both against tnsh's.  At log K = 0 tnsh's
    opening value is the native k residue's first byte (see
    ``test_edge_shapes_equal_tnsh[k1_sparse]``), so there only its
    quotients are compared."""
    log_k, log_t = shape
    tables, ref_tables = _cube_tables(log_k, log_t, seed=19)
    val, ref_val = tables[3], ref_tables[3]
    rng = random.Random(41)
    point = [Fr(rng.randrange(P)) for _ in range(log_k + log_t)]
    ref_point = [RefFr(int(x)) for x in point]
    cp, ref_cp = cube_params(log_k, log_t), ref_cube_params(log_k, log_t)
    v = incremental_mle_eval(val, point)
    assert int(v) == int(mle_eval(val.to_dense(), point))
    assert int(v) == int(ref_incremental_mle_eval(ref_val, ref_point))
    got_v, proof = open_incremental(cp, val, point, "cpu")
    assert int(got_v) == int(v)
    comm = commit_incremental(cp, val, "cpu")
    assert MultilinearKZG.verify(cp.vk, comm, point, v, proof)
    ref_v, ref_proof = ref_open_incremental(ref_cp, ref_val, ref_point)
    assert proof.serialize_compressed() == ref_proof.serialize_compressed()
    if log_k > 0:
        assert int(ref_v) == int(v)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("log_t", [16, 18, 20])
def test_card_proof_equals_tnsh_host_proof(log_t, params, monkeypatch,
                                           request):
    """K=2^10 on the card (seven commitments, two openings and the j
    rounds) against tnsh's host-native prover, over the trace
    ``benches/sound_sparse_bench.py`` makes.  Run with ``-s`` to see the
    prove times, taken in turns port, tnsh, port with TNSH_GC_PAUSE=0,
    twice, in one process, and each prove's generation-2 collections and
    their seconds (both packages pause the cyclic GC during a prove: none
    is expected but in the unpaused proves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # keep tnsh's MSMs on the host
    monkeypatch.setenv("TNSH_TPU_MSM", "0")
    monkeypatch.setattr(ref_kzg, "_TPU_MSM_FRACTION", "0")
    (pp, vp), (ref_pp, ref_vp) = params
    log_k = 10
    tr, ref_tr = _traces(1 << log_k, _bench_ops(log_k, log_t))
    dev = torch.device("cuda", 0)
    torch.set_num_threads(os.cpu_count() or 1)
    request.addfinalizer(lambda: torch.set_num_threads(1))
    TwistSound.prove(_traces(8, _sample_ops())[0], pp, dev)  # CUDA start-up
    # the SRSs and the port's device copies, kept out of the timing
    from tnsh.commit.mkzg import setup_multilinear_params as ref_ml_params
    from tnsh_torch.commit.mkzg_sparse import prepare_device

    prepare_device(cube_params(log_k, log_t), dev)
    MultilinearKZG.prepare_device(setup_multilinear_params(log_t)[0], dev)
    ref_cube_params(log_k, log_t)
    ref_ml_params(log_t)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    turns = ("port", "tnsh", "port_unpaused")
    times = {who: [] for who in turns}
    gen2 = {who: [] for who in turns}
    out = {}
    for who in turns * 2:
        with GcCollections() as gcs, monkeypatch.context() as m:
            t0 = time.perf_counter()
            if who == "tnsh":
                proof = RefTwistSound.prove(ref_tr, ref_pp)
            else:
                if who == "port_unpaused":
                    m.setenv("TNSH_GC_PAUSE", "0")
                proof = TwistSound.prove(tr, pp, dev)
                torch.cuda.synchronize()
            times[who].append(time.perf_counter() - t0)
        gen2[who].append((gcs.count, gcs.seconds, gcs.young_count,
                          gcs.young_seconds))
        b = (ref_to_bytes if who == "tnsh" else TwistSound.to_bytes)(proof)
        assert out.setdefault(who, b) == b
    assert out["port"] == out["tnsh"] == out["port_unpaused"]
    print(f"\ntwist_sound K=2^{log_k} T=2^{log_t} on {card}: prove s "
          f"{times}; collections (gen-2 count, s, gen-0/1 count, s) "
          f"{gen2}")
    assert [c[0] for c in gen2["port"] + gen2["tnsh"]] == [0] * 4
    _cross_verify(out["port"], out["tnsh"], vp, ref_vp)
    assert sum(c.hazard_count for c in kzg.device_contexts()) == 0
