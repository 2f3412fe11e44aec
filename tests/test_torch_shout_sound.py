"""The port's ShoutSound against tnsh's: byte-identical proofs on the dense
and the sparse path, and each package's verifier accepts the other's
bytes, on the CPU (the plain PyTorch versions of the kernels) and, marked
``cuda``, on the card at K=2^10.  Mirrors the ShoutSound cases of
``tests/test_sound.py`` and ``tests/test_sound_sparse.py`` and the frozen
SHSS digests of ``tests/test_golden_vectors.py``, and holds the port's
``SparseCubeOracle`` against tnsh's round for round.

The two packages share no objects: each gets its own lookup table, cube
tables, parameters and native engine, and proofs cross over only as
bytes.  Outside the one case at n = 14, ``kzg.DEVICE_MSM_MIN`` is lifted out
of reach, so the port's MSMs run on the native host MSM (its scheduled
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
from tnsh.core.params import setup_params as ref_setup_params
from tnsh.core.proof_io import (
    shout_sound_proof_from_bytes as ref_from_bytes,
    shout_sound_proof_to_bytes as ref_to_bytes,
)
from tnsh.field.fr import Fr as RefFr
from tnsh.iop.sparse_oracle import SparseCubeOracle as RefOracle
from tnsh.protocols.shout import LookupTable as RefLookupTable
from tnsh.protocols.sound import ShoutSound as RefShoutSound
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
    SparseCubeTable,
    cube_params,
)
from tnsh_torch.core.params import setup_params
from tnsh_torch.core.proof_io import shout_sound_proof_from_bytes
from tnsh_torch.core.transcript import Transcript
from tnsh_torch.errors import InvalidParametersError, SumCheckError
from tnsh_torch.field import fr_kernels
from tnsh_torch.field.fr import MODULUS as P
from tnsh_torch.field.fr import Fr
from tnsh_torch.iop.sparse_oracle import SparseCubeOracle
from tnsh_torch.iop.sumcheck import SumCheckProof
from tnsh_torch.protocols.shout import LookupTable
from tnsh_torch.protocols.sound import (
    MLOpening,
    ShoutSound,
    ShoutSoundProof,
    _shout_bind_statement,
    _shout_challenges,
)
from tnsh_torch.utils.profiling import PhaseTimer

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

#: size -> (length, sha256) of the ShoutSound proof of ``_golden_lookups``
#: (tests/test_golden_vectors.py, ``_SOUND_PROOF_VECTORS``)
FROZEN = {
    4: (944, "44a59504317d1ee44029c01056ccbb2a64d7c8f6e6e07156d1c50cd6430c91a1"),
    8: (1312, "7bab951a9092bae5bb218ae69bd67be91dd89f114c3fcd2c62db97f5f1d1c04c"),
    16: (1680,
         "2984f618d43d2266dc57a30618ff4043501b6972c0e2a9d6d2dd81bd05960794"),
}


@pytest.fixture(scope="module")
def params():
    """((port pp, vp), (tnsh pp, vp)) from the same deterministic setup."""
    return setup_params(4), ref_setup_params(4)


@pytest.fixture
def host_msm(monkeypatch):
    """Every MSM of the port on the native host MSM."""
    monkeypatch.setattr(kzg, "DEVICE_MSM_MIN", 1 << 62)


def _table(cls, fr, entries, looks):
    t = cls([fr(e) for e in entries])
    for ix in looks:
        t.lookup(ix)
    return t


def _tables(entries, looks):
    """(port table, tnsh table) of the same lookup log."""
    return (_table(LookupTable, Fr, entries, looks),
            _table(RefLookupTable, RefFr, entries, looks))


def _golden_lookups(size):
    return [i * i for i in range(size)], [(i * 3) % size for i in range(size)]


def _sample_lookups():
    """``tests/test_sound.py``'s sample: entries i^2, six lookups."""
    return [i * i for i in range(8)], [3, 1, 7, 1, 0, 5]


def _bench_lookups(log_k, log_t):
    """The lookups of ``benches/sound_sparse_bench.py``: entries i^2 + 1,
    T lookups drawn by ``random.seed(1)``."""
    rng = random.Random(1)
    k = 1 << log_k
    return [i * i + 1 for i in range(k)], [rng.randrange(k)
                                           for _ in range(1 << log_t)]


def _cross_verify(port_bytes, ref_bytes, entries, vp, ref_vp):
    """tnsh's verifier on the port's bytes, the port's on tnsh's."""
    assert RefShoutSound.verify(ref_from_bytes(port_bytes),
                                [RefFr(e) for e in entries], ref_vp)
    assert ShoutSound.verify(shout_sound_proof_from_bytes(ref_bytes),
                             [Fr(e) for e in entries], vp)


# ---------------------------------------------------------------------------
# Proof bytes against tnsh's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [4, 8, 16])
def test_frozen_digests_and_bytes_equal_tnsh(size, host_msm):
    """The dense path at the golden sizes (n = 4, 6, 8)."""
    pp, vp = setup_params(size.bit_length() - 1)
    ref_pp, ref_vp = ref_setup_params(size.bit_length() - 1)
    entries, looks = _golden_lookups(size)
    tbl, ref_tbl = _tables(entries, looks)
    proof = tnsh_torch.ShoutSound.prove(tbl, pp, "cpu")
    b = ShoutSound.to_bytes(proof)
    assert (len(b), hashlib.sha256(b).hexdigest()) == FROZEN[size]
    ref_b = ref_to_bytes(RefShoutSound.prove(ref_tbl, ref_pp))
    assert b == ref_b
    assert ShoutSound.verify(proof, tbl.entries, vp)
    _cross_verify(b, ref_b, entries, vp, ref_vp)


def test_dense_equals_sparse_and_tnsh(params, host_msm):
    """``tests/test_sound_sparse.py``'s case: K=8, 16 lookups."""
    (pp, vp), (ref_pp, ref_vp) = params
    random.seed(13)
    entries = [i * i for i in range(8)]
    looks = [random.randrange(8) for _ in range(16)]
    tbl, ref_tbl = _tables(entries, looks)
    timer = PhaseTimer()
    dense = ShoutSound.to_bytes(ShoutSound.prove(tbl, pp, "cpu",
                                                 sparse=False))
    sparse = ShoutSound.prove(tbl, pp, "cpu", timer, sparse=True)
    b = ShoutSound.to_bytes(sparse)
    assert dense == b
    assert b == ref_to_bytes(RefShoutSound.prove(ref_tbl, ref_pp,
                                                 sparse=True))
    assert b == ref_to_bytes(RefShoutSound.prove(ref_tbl, ref_pp,
                                                 sparse=False))
    assert ShoutSound.verify(sparse, tbl.entries, vp)
    _cross_verify(b, b, entries, vp, ref_vp)
    assert {"simulate", "srs", "commit", "k_rounds", "j_build", "j_rounds",
            "open", "commit/host_msm", "open/host_msm"} <= set(timer.phases)
    # on the CPU every kernel wrapper takes its plain version
    assert all(n == 0 for per in timer.launches.values()
               for n in per.values())


def test_sparse_at_14_vars_on_the_default_route(params):
    """K=2^4, T=2^10 picks the sparse path by itself; both commitments
    (1024 points) run through the scheduled Pippenger (plain versions), the
    24 (20 + log K) opening MSMs under 1024 points on the host."""
    (pp, vp), (ref_pp, ref_vp) = params
    entries, looks = _bench_lookups(4, 10)
    tbl, ref_tbl = _tables(entries, looks)
    kzg.reset_route_counts()
    timer = PhaseTimer()
    proof = ShoutSound.prove(tbl, pp, "cpu", timer)
    assert kzg.route_counts() == {"device": 2, "host": 24}
    assert "k_rounds" in timer.phases          # the sparse path ran
    assert sum(c.hazard_count for c in kzg.device_contexts()) == 0
    b = ShoutSound.to_bytes(proof)
    ref_b = ref_to_bytes(RefShoutSound.prove(ref_tbl, ref_pp))
    assert b == ref_b
    _cross_verify(b, ref_b, entries, vp, ref_vp)


@pytest.mark.parametrize("case", ["empty_lookups", "single_lookup",
                                  "k2_t1", "k1_sparse"])
def test_edge_shapes_equal_tnsh(case, params, host_msm):
    """An empty lookup log (T = 1), one lookup into K = 2, K = 2 with T = 1
    and a one-entry table (log K = 0: no k rounds, the j phase built at
    construction), each on both paths."""
    (pp, vp), (ref_pp, ref_vp) = params
    entries, looks = {
        "empty_lookups": ([0, 1, 2, 3], []),
        "single_lookup": ([10, 20], [1]),
        "k2_t1": ([3, 5], [0]),
        "k1_sparse": ([12345678], [0] * 8),
    }[case]
    tbl, ref_tbl = _tables(entries, looks)
    out = set()
    for sparse in (False, True):
        proof = ShoutSound.prove(tbl, pp, "cpu", sparse=sparse)
        assert ShoutSound.verify(proof, tbl.entries, vp)
        out.add(ShoutSound.to_bytes(proof))
        out.add(ref_to_bytes(RefShoutSound.prove(ref_tbl, ref_pp,
                                                 sparse=sparse)))
    assert len(out) == 1
    (b,) = out
    _cross_verify(b, b, entries, vp, ref_vp)


# ---------------------------------------------------------------------------
# Forged proofs (tests/test_sound.py:160-276)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sample_proof(params):
    """The sample lookup log's proof, made once (host MSMs)."""
    (pp, _), _ = params
    saved, kzg.DEVICE_MSM_MIN = kzg.DEVICE_MSM_MIN, 1 << 62
    try:
        entries, looks = _sample_lookups()
        tbl, _ = _tables(entries, looks)
        return tbl, ShoutSound.prove(tbl, pp, "cpu")
    finally:
        kzg.DEVICE_MSM_MIN = saved


@pytest.mark.parametrize("tamper", ["rv_value", "ra_value",
                                    "final_evaluation", "swapped_commitments",
                                    "wrong_table"])
def test_tampered_proofs_rejected(tamper, sample_proof, params):
    (_, vp), _ = params
    tbl, proof = sample_proof
    table = tbl.entries
    assert ShoutSound.verify(proof, table, vp)
    bad = copy.deepcopy(proof)
    if tamper == "rv_value":
        bad.rv_at_r = MLOpening(bad.rv_at_r.value + Fr(1), bad.rv_at_r.proof)
    elif tamper == "ra_value":
        bad.ra_at_r = MLOpening(bad.ra_at_r.value + Fr(1), bad.ra_at_r.proof)
    elif tamper == "final_evaluation":
        bad.check.final_evaluation = bad.check.final_evaluation + Fr(1)
    elif tamper == "swapped_commitments":
        bad.ra_commitment, bad.rv_commitment = (bad.rv_commitment,
                                                bad.ra_commitment)
    else:
        table = [Fr(i * i + 1) for i in range(8)]
    assert not ShoutSound.verify(bad, table, vp)


def test_fabricated_rounds_rejected(sample_proof, params, host_msm):
    """A prover that commits to a wrong lookup output and pushes all-zero
    round polynomials with honest openings of its forged tables: only the
    final-evaluation binding catches it."""
    (pp, vp), _ = params
    tbl, honest = sample_proof
    entries = [int(e) for e in tbl.entries]
    log_k = log_t = 3
    n = log_k + log_t
    ra = [0] * (1 << n)
    rv = [0] * (1 << log_t)
    for j in range(1 << log_t):
        idx = tbl.lookups[j].index if j < len(tbl.lookups) else 0
        ra[j * 8 + idx] = 1
        rv[j] = entries[idx]
    rv[2] = 999  # the lie
    params_n, _ = setup_multilinear_params(n)
    params_t, _ = setup_multilinear_params(log_t)
    c_ra = MultilinearKZG.commit(params_n, ra, "cpu")
    c_rv = MultilinearKZG.commit(params_t, rv, "cpu")
    transcript = Transcript(pp.fiat_shamir_seed)
    _shout_bind_statement(transcript, log_k, log_t, entries, c_ra, c_rv)
    _shout_challenges(transcript, log_k, log_t)
    rounds, r = [], []
    for rnd in range(n):
        rounds.append([Fr(0)] * 4)
        transcript.append_field_elements(f"sumcheck_round_{rnd}".encode(),
                                         rounds[-1])
        r.append(transcript.challenge_field_element(
            f"sumcheck_challenge_{rnd}".encode()))
    ra_val, ra_open = MultilinearKZG.open(params_n, ra, r, "cpu")
    rv_val, rv_open = MultilinearKZG.open(params_t, rv, r[log_k:], "cpu")
    forged = ShoutSoundProof(
        log_table=log_k, log_lookups=log_t, ra_commitment=c_ra,
        rv_commitment=c_rv, check=SumCheckProof(rounds, Fr(0)),
        ra_at_r=MLOpening(ra_val, ra_open), rv_at_r=MLOpening(rv_val, rv_open))
    assert not ShoutSound.verify(forged, tbl.entries, vp)
    assert ShoutSound.verify(honest, tbl.entries, vp)


def test_external_srs_dense_path_equals_tnsh(params, host_msm):
    """Under an installed ceremony SRS the prover takes the dense path and
    opens ra in suffix order; forcing the sparse path is refused."""
    (pp, vp), (ref_pp, ref_vp) = params
    for n_vars in (1, 2, 3, 4):
        taus = [1000 + 7 * i for i in range(n_vars)]
        p_ext, vk_ext = generate_multilinear_srs(
            n_vars, [Fr(t) for t in taus], keep_taus=False)
        assert p_ext.taus is None
        install_external_multilinear_srs(p_ext, vk_ext)
        ref_install_external(*ref_generate_srs(
            n_vars, [RefFr(t) for t in taus], keep_taus=False))
    try:
        entries, looks = [i * i for i in range(4)], [0, 1, 2, 3]
        tbl, ref_tbl = _tables(entries, looks)
        proof = ShoutSound.prove(tbl, pp, "cpu")
        assert ShoutSound.verify(proof, tbl.entries, vp)
        b = ShoutSound.to_bytes(proof)
        ref_b = ref_to_bytes(RefShoutSound.prove(ref_tbl, ref_pp))
        assert b == ref_b
        _cross_verify(b, ref_b, entries, vp, ref_vp)
        bad = copy.deepcopy(proof)
        bad.rv_at_r = MLOpening(Fr(int(bad.rv_at_r.value) + 1),
                                bad.rv_at_r.proof)
        assert not ShoutSound.verify(bad, tbl.entries, vp)
        with pytest.raises(InvalidParametersError, match="ceremony"):
            ShoutSound.prove(tbl, pp, "cpu", sparse=True)
    finally:
        clear_external_multilinear_srs()
        ref_clear_external()


def test_serde_roundtrip(sample_proof, params):
    (_, vp), _ = params
    tbl, proof = sample_proof
    data = ShoutSound.to_bytes(proof)
    back = shout_sound_proof_from_bytes(data)
    assert ShoutSound.to_bytes(back) == data
    assert ShoutSound.verify(back, tbl.entries, vp)


@pytest.mark.parametrize("fault", ["magic", "version"])
def test_bad_header_refused(fault, sample_proof):
    _, proof = sample_proof
    data = bytearray(ShoutSound.to_bytes(proof))
    if fault == "magic":
        data[:4] = b"SHBT"
    else:
        data[4:8] = (1).to_bytes(4, "little")
    with pytest.raises(InvalidParametersError, match=fault):
        shout_sound_proof_from_bytes(bytes(data))


# ---------------------------------------------------------------------------
# The oracle against tnsh's, round for round
# ---------------------------------------------------------------------------

def _oracle_terms(case, table_cls, inc_cls, log_k, log_t):
    """A term system built afresh for one package from one seed, so that
    identity deduplication sees the same sharing in both.  ``shout``: the
    prover's six terms with a one-hot ra; ``twist``: colsparse columns of
    two or three entries (same-pair ones among them), a colinc table, and
    class S, squared S, I and E terms (``tests/test_sound_sparse.py``)."""
    rng = random.Random(31 if case == "shout" else 23)
    k_size, t_size = 1 << log_k, 1 << log_t
    rnd = lambda n: [rng.randrange(P) for _ in range(n)]  # noqa: E731
    sp = table_cls(log_k, log_t)
    if case == "shout":
        for j in range(t_size):
            sp.set(j, rng.randrange(k_size), 1)
        eq_r, rv, ejb, eq_o = rnd(t_size), rnd(t_size), rnd(t_size), rnd(t_size)
        entries, ekb = rnd(k_size), rnd(k_size)
        a, a2, kinv = rng.randrange(P), rng.randrange(P), rng.randrange(P)
        return [
            (1, [("eqj", eq_r), ("colsparse", sp), ("eqk", entries)]),
            (P - kinv, [("eqj", eq_r), ("eqj", rv)]),
            (a, [("eqk", ekb), ("eqj", ejb), ("colsparse", sp),
                 ("colsparse", sp)]),
            (P - a, [("eqk", ekb), ("eqj", ejb), ("colsparse", sp)]),
            (a2, [("eqj", eq_o), ("colsparse", sp)]),
            (a2 * (P - kinv) % P, [("eqj", eq_o)]),
        ]
    inc = inc_cls(log_k, log_t)
    for j in range(t_size):
        k0 = rng.randrange(k_size)
        sp.set(j, k0, rng.randrange(P))
        sp.set(j, k0 ^ 1, rng.randrange(P))
        if j % 2:
            sp.set(j, rng.randrange(k_size), rng.randrange(P))
        inc.add_update(j, rng.randrange(k_size), rng.randrange(P))
    eqj, eqk = rnd(t_size), rnd(k_size)
    return [
        (3, [("eqj", eqj), ("colsparse", sp), ("colinc", inc)]),   # class S
        (P - 2, [("eqk", eqk), ("colsparse", sp), ("colsparse", sp)]),
        (5, [("eqk", eqk), ("colinc", inc)]),                      # class I
        (7, [("eqj", eqj), ("eqk", eqk)]),                         # class E
        (11, [("eqk", eqk)]),                                      # class E
    ]


@pytest.mark.parametrize("case", ["shout", "twist"])
def test_oracle_rounds_equal_tnsh(case):
    log_k, log_t = 3, 5
    port = SparseCubeOracle(
        log_k, log_t,
        _oracle_terms(case, SparseCubeTable, IncrementalCubeTable, log_k,
                      log_t), device="cpu")
    ref = RefOracle(log_k, log_t,
                    _oracle_terms(case, RefSparseTable, RefIncTable, log_k,
                                  log_t))
    rng = random.Random(5)
    challenges = [rng.randrange(P) for _ in range(log_k + log_t)]
    try:
        for rd, c in enumerate(challenges):
            got = port.round_evaluations(rd)
            # degree 3 in every round: a folded one-hot is ONE table, not a
            # product of log K chi columns
            assert len(got) == 4, rd
            assert [int(v) for v in got] == [
                int(v) for v in ref.round_evaluations(rd)], rd
            port.bind(Fr(c))
            ref.bind(RefFr(c))
        assert int(port.final_evaluation([Fr(c) for c in challenges])) \
            == int(ref.final_evaluation([RefFr(c) for c in challenges]))
        d = port._delegate
        if case == "shout":
            # eq_r, ra_f, rv, ejb, eq_o; the BOOL term holds ra_f twice
            assert d.tables.shape[0] == 5 and len(d._idxs) == 6
            assert d._idxs[2][1] == d._idxs[2][2] == d._idxs[0][1]
        else:
            # eqj, the folded columns and the all-ones table of the term
            # left with no table
            assert d.tables.shape[0] == 4 and d._idxs[4] == (3,)
    finally:
        port.release()
    port.release()              # idempotent
    assert port._k is None and port._delegate.tables is None


def test_j_phase_program_at_k_1024(params, host_msm, monkeypatch):
    """The j phase a K=2^10 prove hands the card, which ``chip_smoke.py``
    phase 12 holds against its plain version and times: 6 terms over 5
    stacked tables, 8 products a pair and point against 12 term by term,
    two stack slots."""
    from chip_smoke import sound_j_terms

    (pp, _), _ = params
    built = []
    real = SparseCubeOracle._build_delegate

    def build(self):
        real(self)
        built.append((self._delegate._idxs, self._delegate.tables.shape[0],
                      self._delegate._desc))

    monkeypatch.setattr(SparseCubeOracle, "_build_delegate", build)
    entries, looks = _bench_lookups(10, 4)
    ShoutSound.prove(_tables(entries, looks)[0], pp, "cpu")
    ((idxs, n_tables, desc),) = built
    assert (idxs, n_tables) == sound_j_terms()
    assert (desc.products, desc.products_unfactored, desc.depth) == (8, 12, 2)


@pytest.mark.parametrize("fault", ["kind", "two_colsparse", "two_colinc",
                                   "eqj_size", "no_terms"])
def test_oracle_refuses_bad_terms(fault):
    log_k, log_t = 2, 3
    a, b = SparseCubeTable(log_k, log_t), SparseCubeTable(log_k, log_t)
    i1, i2 = IncrementalCubeTable(log_k, log_t), IncrementalCubeTable(
        log_k, log_t)
    tab = list(range(1 << log_t))
    terms = {
        "kind": [(1, [("eqx", tab)])],
        "two_colsparse": [(1, [("colsparse", a), ("colsparse", b)])],
        "two_colinc": [(1, [("colinc", i1), ("colinc", i2)])],
        "eqj_size": [(1, [("eqj", tab[:-1]), ("colsparse", a)])],
        "no_terms": [],
    }[fault]
    with pytest.raises(SumCheckError):
        SparseCubeOracle(log_k, log_t, terms, device="cpu")


def _engine_refused():
    raise RuntimeError("the native engine was reached under TNSH_NO_NATIVE")


def test_oracle_refuses_explicit_native_without_engine(monkeypatch):
    """``use_native=True`` without the engine raises: there is no silent
    fallback to the Python k phase."""
    terms = _oracle_terms("shout", SparseCubeTable, IncrementalCubeTable,
                          2, 3)
    monkeypatch.setenv("TNSH_NO_NATIVE", "1")
    assert _native.available is False
    with pytest.raises(RuntimeError, match="native"):
        SparseCubeOracle(2, 3, terms, device="cpu", use_native=True)


def test_default_oracle_takes_python_k_phase_without_engine(monkeypatch):
    """Under TNSH_NO_NATIVE the default oracle runs the Python k phase,
    reaches nothing of the engine, and its rounds are tnsh's."""
    log_k, log_t = 3, 5
    monkeypatch.setenv("TNSH_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_load", _engine_refused)
    port = SparseCubeOracle(
        log_k, log_t,
        _oracle_terms("shout", SparseCubeTable, IncrementalCubeTable, log_k,
                      log_t), device="cpu")
    assert port.use_native is False
    ref = RefOracle(log_k, log_t,
                    _oracle_terms("shout", RefSparseTable, RefIncTable, log_k,
                                  log_t), use_native=False)
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


@pytest.mark.parametrize("log_k,log_t", [(2, 3), (4, 6), (6, 8)])
def test_sparse_prove_without_native_engine(log_k, log_t, params,
                                            monkeypatch, host_msm):
    """Under TNSH_NO_NATIVE the sparse prover reaches nothing of the
    engine (its cube SRS, its scalars and openings and its k rounds in
    Python ints), though the engine's set-ups of the same sizes were
    cached first, and its bytes are tnsh's sparse prove in the same mode;
    each verifier accepts the other's bytes."""
    (_, vp), (_, ref_vp) = params
    entries, looks = _bench_lookups(log_k, log_t)
    tbl, ref_tbl = _tables(entries, looks)
    cube_params(log_k, log_t)
    setup_multilinear_params(log_t)
    timer = PhaseTimer()
    with monkeypatch.context() as m:
        m.setenv("TNSH_NO_NATIVE", "1")
        m.setattr(_native, "_load", _engine_refused)
        b = ShoutSound.to_bytes(ShoutSound.prove(
            tbl, setup_params(4)[0], "cpu", timer, sparse=True))
        ref_b = ref_to_bytes(RefShoutSound.prove(
            ref_tbl, ref_setup_params(4)[0], sparse=True))
    assert {"k_rounds", "j_build", "j_rounds"} <= set(timer.phases)
    assert b == ref_b
    _cross_verify(b, ref_b, entries, vp, ref_vp)


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
    tbl, _ = _tables(*_sample_lookups())
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        ShoutSound.prove(tbl, pp, "cpu", sparse=True)
    assert len(created) == 1 and freed == created


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("log_t", [16, 18, 20])
def test_card_proof_equals_tnsh_host_proof(log_t, params, monkeypatch,
                                           request):
    """K=2^10 on the card (commitments, openings and j rounds) against
    tnsh's host-native prover, with the lookups
    ``benches/sound_sparse_bench.py`` makes.  Run with ``-s`` to see the
    prove times, taken in turns port, tnsh, port, tnsh in one process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # keep tnsh's MSMs on the host
    monkeypatch.setenv("TNSH_TPU_MSM", "0")
    monkeypatch.setattr(ref_kzg, "_TPU_MSM_FRACTION", "0")
    (pp, vp), (ref_pp, ref_vp) = params
    log_k = 10
    entries, looks = _bench_lookups(log_k, log_t)
    tbl, ref_tbl = _tables(entries, looks)
    dev = torch.device("cuda", 0)
    torch.set_num_threads(os.cpu_count() or 1)
    request.addfinalizer(lambda: torch.set_num_threads(1))
    ShoutSound.prove(_tables(*_sample_lookups())[0], pp, dev)  # CUDA start-up
    # the SRSs and the port's device copies, kept out of the timing
    from tnsh.commit.mkzg import setup_multilinear_params as ref_ml_params
    from tnsh.commit.mkzg_sparse import cube_params as ref_cube_params
    from tnsh_torch.commit.mkzg_sparse import cube_params, prepare_device

    prepare_device(cube_params(log_k, log_t), dev)
    MultilinearKZG.prepare_device(setup_multilinear_params(log_t)[0], dev)
    ref_cube_params(log_k, log_t)
    ref_ml_params(log_t)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    times = {"port": [], "tnsh": []}
    out = {}
    for who in ("port", "tnsh", "port", "tnsh"):
        t0 = time.perf_counter()
        if who == "port":
            b = ShoutSound.to_bytes(ShoutSound.prove(tbl, pp, dev))
            torch.cuda.synchronize()
        else:
            b = ref_to_bytes(RefShoutSound.prove(ref_tbl, ref_pp))
        times[who].append(time.perf_counter() - t0)
        assert out.setdefault(who, b) == b
    assert out["port"] == out["tnsh"]
    print(f"\nshout_sound K=2^{log_k} T=2^{log_t} on {card}: port prove s "
          f"{times['port']}, tnsh host prove s {times['tnsh']}")
    _cross_verify(out["port"], out["tnsh"], entries, vp, ref_vp)
    assert sum(c.hazard_count for c in kzg.device_contexts()) == 0
