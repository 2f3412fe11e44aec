"""The port's ShoutBits and ShoutBitsCommitted against tnsh's:
byte-identical proofs, and each package's verifier accepts the other's
bytes, on the CPU (the plain PyTorch versions of the kernels) and, marked
``cuda``, on the card at K=2^10.  Mirrors the ShoutBits tests of
``tests/test_twist_bits.py``, including its frozen wire-v3 digest.

The two packages share no objects: each gets its own lookup table,
parameters and native engine, and proofs and commitments cross over only as
bytes.  At T = 2^11 the port's column commitments and the 1024-point
quotient MSM of its opening run through its scheduled Pippenger (plain
versions)."""

import copy
import hashlib
import os
import random
import subprocess
import time

import pytest
import torch

import tnsh_torch._native as _native
from tnsh.commit import kzg as ref_kzg
from tnsh.commit.kzg import KZGCommitmentValue as RefCommitment
from tnsh.commit.mkzg import setup_multilinear_params as ref_ml_params
from tnsh.core.params import setup_params as ref_setup_params
from tnsh.core.proof_io import (
    shout_bits_comm_proof_from_bytes as ref_comm_from_bytes,
    shout_bits_comm_proof_to_bytes as ref_comm_to_bytes,
    shout_bits_proof_from_bytes as ref_from_bytes,
    shout_bits_proof_to_bytes as ref_to_bytes,
)
from tnsh.field.fr import Fr as RefFr
from tnsh.iop.bits_oracle import ShoutBitsSparseOracle as RefOracle
from tnsh.protocols.shout import LookupTable as RefLookupTable
from tnsh.protocols.twist_bits import ShoutBits as RefShoutBits
from tnsh.protocols.twist_bits import ShoutBitsCommitted as RefCommitted
from tnsh_torch.commit import kzg
from tnsh_torch.commit.kzg import KZGCommitmentValue
from tnsh_torch.core.proof_io import (
    shout_bits_comm_proof_from_bytes,
    shout_bits_proof_from_bytes,
)
from tnsh_torch.errors import InvalidParametersError, SumCheckError
from tnsh_torch.field import fr_kernels
from tnsh_torch.field.fr import MODULUS as P
from tnsh_torch.iop.bits_oracle import ShoutBitsSparseOracle
from tnsh_torch.protocols.twist_bits import (
    Fr,
    LookupTable,
    ShoutBits,
    ShoutBitsCommitted,
    ShoutBitsProof,
    setup_multilinear_params,
    setup_params,
)
from tnsh_torch.utils.profiling import GcCollections, PhaseTimer

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

LOG_K, LOG_T = 3, 6


@pytest.fixture(scope="module")
def params():
    """((port pp, vp), (tnsh pp, vp)) from the same deterministic setup."""
    return setup_params(8), ref_setup_params(8)


def _frozen_lookups():
    """The lookup log of tnsh's frozen ShoutBits digest: ``random.seed(99)``,
    entries i^2 + 3, 64 lookups."""
    random.seed(99)
    return ([i * i + 3 for i in range(1 << LOG_K)],
            [random.randrange(1 << LOG_K) for _ in range(1 << LOG_T)])


def _bench_lookups(log_k, log_t, seed=11):
    """Entries 3i + 1 and T - 1 seeded lookups (``benches/bits_bench.py``);
    the padding cycle looks up slot 0."""
    rng = random.Random(seed)
    k = 1 << log_k
    return ([3 * i + 1 for i in range(k)],
            [rng.randrange(k) for _ in range(max((1 << log_t) - 1, 0))])


def _table(cls, fr, entries, looks):
    t = cls([fr(e) for e in entries])
    for ix in looks:
        t.lookup(ix)
    return t


def _port_table(entries, looks):
    return _table(LookupTable, Fr, entries, looks)


def _ref_table(entries, looks):
    return _table(RefLookupTable, RefFr, entries, looks)


def _cross_verify(port_bytes, ref_bytes, entries, vp, ref_vp):
    """tnsh's verifier on the port's bytes, the port's on tnsh's."""
    assert RefShoutBits.verify(ref_from_bytes(port_bytes),
                               [RefFr(e) for e in entries], ref_vp)
    assert ShoutBits.verify(shout_bits_proof_from_bytes(ref_bytes),
                            [Fr(e) for e in entries], vp)


def test_proof_bytes_equal_tnsh_and_frozen_digest(params):
    (pp, vp), (ref_pp, ref_vp) = params
    entries, looks = _frozen_lookups()
    timer = PhaseTimer()
    proof = ShoutBits.prove(_port_table(entries, looks), pp, "cpu", timer)
    b = ShoutBits.to_bytes(proof)
    assert (len(b), hashlib.sha256(b).hexdigest()) == (
        2344,
        "689c1c848809eb688a42f4301a0b269b48d77dbfa0900123cf1679017b1a9dca",
    )
    ref_b = ref_to_bytes(RefShoutBits.prove(_ref_table(entries, looks),
                                            ref_pp))
    assert b == ref_b
    assert ShoutBits.verify(proof, [Fr(e) for e in entries], vp)
    _cross_verify(b, ref_b, entries, vp, ref_vp)
    assert {"simulate", "srs", "commit", "oracle_a_build", "phase_a",
            "k_rounds", "j_build", "j_rounds", "open"} <= set(timer.phases)
    assert "phase_b" not in timer.phases
    # on the CPU every kernel wrapper takes its plain version
    assert all(n == 0 for per in timer.launches.values()
               for n in per.values())


def test_tampered_proofs_and_wrong_table_rejected(params):
    (pp, vp), _ = params
    entries, looks = _frozen_lookups()
    proof = ShoutBits.prove(_port_table(entries, looks), pp, "cpu")
    table = [Fr(e) for e in entries]
    bad = copy.deepcopy(proof)
    bad.values_rj[LOG_K] = Fr(int(bad.values_rj[LOG_K]) + 1)
    assert not ShoutBits.verify(bad, table, vp)
    bad = copy.deepcopy(proof)
    bad.check.final_evaluation = Fr(int(bad.check.final_evaluation) + 1)
    assert not ShoutBits.verify(bad, table, vp)
    assert not ShoutBits.verify(proof, [Fr(e + 1) for e in entries], vp)


def test_jax_path_bytes_equal(params, monkeypatch):
    """tnsh with its j phase on ``JaxSopOracleD`` (TNSH_BITS_FORCE_JAX,
    XLA on the CPU, as ``tests/test_twist_bits.py`` runs that oracle)
    gives the port's bytes.  K = 2, T = 4: every round shape is an XLA
    compile, so the shape is the smallest with j rounds."""
    (pp, vp), (ref_pp, ref_vp) = params
    entries, looks = _bench_lookups(1, 2, seed=3)
    b = ShoutBits.to_bytes(ShoutBits.prove(_port_table(entries, looks), pp,
                                           "cpu"))
    monkeypatch.setenv("TNSH_BITS_FORCE_JAX", "1")
    ref_b = ref_to_bytes(RefShoutBits.prove(_ref_table(entries, looks),
                                            ref_pp))
    monkeypatch.delenv("TNSH_BITS_FORCE_JAX")
    assert b == ref_b
    _cross_verify(b, ref_b, entries, vp, ref_vp)


@pytest.mark.parametrize("nk,nt", [(1, 0), (1, 3), (3, 0), (4, 2)])
def test_edge_shapes_equal_tnsh(nk, nt, params):
    """K = 2, single and empty lookup logs: T = 1 has no j round, and the
    j phase is one table entry a column."""
    (pp, vp), (ref_pp, ref_vp) = params
    random.seed(9000 + nk * 10 + nt)
    k = 1 << nk
    looks = [random.randrange(k) for _ in range(max((1 << nt) - 1, 0))]
    entries = [3 * i + 1 for i in range(k)]
    proof = ShoutBits.prove(_port_table(entries, looks), pp, "cpu")
    assert (proof.log_table, proof.log_lookups) == (nk, nt)
    b = ShoutBits.to_bytes(proof)
    ref_b = ref_to_bytes(RefShoutBits.prove(_ref_table(entries, looks),
                                            ref_pp))
    assert b == ref_b
    _cross_verify(b, ref_b, entries, vp, ref_vp)


def test_native_column_path_equals_tnsh(params):
    """T = 2^11 at K = 8: the four columns are bytes-backed ``FrTable``s;
    their commitments and the 1024-point quotient MSM of the opening go
    through the port's scheduled Pippenger, the ten smaller ones to the
    host MSM."""
    (pp, vp), (ref_pp, ref_vp) = params
    entries, looks = _bench_lookups(3, 11)
    kzg.reset_route_counts()
    timer = PhaseTimer()
    proof = ShoutBits.prove(_port_table(entries, looks), pp, "cpu", timer)
    assert kzg.route_counts() == {"device": 5, "host": 10}
    assert sum(c.hazard_count for c in kzg.device_contexts()) == 0
    assert {"commit/marshal", "commit/plan", "commit/upload", "commit/launch",
            "commit/combine", "open/quotients", "open/plan", "open/launch",
            "open/combine", "open/host_msm"} <= set(timer.phases)
    b = ShoutBits.to_bytes(proof)
    ref_b = ref_to_bytes(RefShoutBits.prove(_ref_table(entries, looks),
                                            ref_pp))
    assert b == ref_b
    _cross_verify(b, ref_b, entries, vp, ref_vp)


# ---------------------------------------------------------------------------
# The oracle against tnsh's, round for round
# ---------------------------------------------------------------------------

def _oracle_terms(case, rng, log_k, log_t):
    """A term system over plain int lists, built afresh for each package so
    that identity-based deduplication sees the same sharing in both."""
    t_size, k_size = 1 << log_t, 1 << log_k
    rnd = lambda n: [rng.randrange(P) for _ in range(n)]
    eq1, eqb, rv, entries = rnd(t_size), rnd(t_size), rnd(t_size), rnd(k_size)
    rb = [[rng.randrange(2) for _ in range(t_size)] for _ in range(log_k)]
    kinv = pow(k_size, P - 2, P)
    terms = [(1, [eq1], rb, entries), (P - kinv, [eq1, rv], None, None)]
    for i in range(log_k):
        w = rng.randrange(P)
        terms.append((w, [eqb, rb[i], rb[i]], None, None))
        terms.append((P - w, [eqb, rb[i]], None, None))
    if case == "one_hot_without_k_table":
        # a second one-hot term over the same bits, with no k table: it
        # keeps its coefficient in the j phase
        terms.append((rng.randrange(P), [eqb, rv], rb, None))
    return terms


def _copy_terms(terms):
    """The same system with fresh list objects and the same sharing."""
    memo = {}

    def cp(x):
        if x is None:
            return None
        if id(x) not in memo:
            memo[id(x)] = list(x)
        return memo[id(x)]

    return [(c, [cp(t) for t in jt],
             None if bits is None else [cp(b) for b in bits], cp(kt))
            for c, jt, bits, kt in terms]


@pytest.mark.parametrize("case", ["shout_system", "one_hot_without_k_table"])
def test_oracle_rounds_equal_tnsh(case):
    log_k, log_t = 4, 5
    degree = log_k + 2
    terms = _oracle_terms(case, random.Random(777), log_k, log_t)
    port = ShoutBitsSparseOracle(log_k, log_t, terms, degree, device="cpu")
    ref = RefOracle(log_k, log_t, _copy_terms(terms), degree)
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
        # bit columns stack once each: a bit column that is also a j table
        # is one device table, not two
        n_tables = port._delegate.tables.shape[0]
        assert n_tables == 3 + 2 * log_k
    finally:
        port.release()
        ref.release()
    port.release()              # idempotent
    assert port._delegate.tables is None


def test_j_phase_program_at_k_1024():
    """The j phase a K=2^10 prove hands the card, which ``chip_smoke.py``
    phase 11 holds against its plain version and times: 22 terms over 23
    stacked tables, 33 products a pair and point against 63 term by
    term, two stack slots."""
    from chip_smoke import shout_j_terms

    log_k, log_t = 10, 2
    rng = random.Random(4)
    terms = _oracle_terms("shout_system", rng, log_k, log_t)
    oracle = ShoutBitsSparseOracle(log_k, log_t, terms, log_k + 2,
                                   device="cpu")
    try:
        for rd in range(log_k):
            oracle.round_evaluations(rd)
            oracle.bind(Fr(rng.randrange(P)))
        d = oracle._delegate
        idxs, n_tables, _ = shout_j_terms(log_k)
        assert d._idxs == idxs and d.tables.shape[0] == n_tables == 23
        assert (len(idxs), d._desc.products, d._desc.products_unfactored,
                d._desc.depth) == (22, 33, 63, 2)
    finally:
        oracle.release()


@pytest.mark.parametrize("fault", ["k_table_without_bits", "bits_not_boolean",
                                   "j_table_size", "k_table_size",
                                   "bit_count", "no_terms"])
def test_oracle_refuses_bad_terms(fault):
    log_k, log_t = 2, 3
    t_size = 1 << log_t
    col = [1, 0] * (t_size // 2)
    tab = list(range(t_size))
    entries = [7] * (1 << log_k)
    bits = [col, list(col)]
    terms = {
        "k_table_without_bits": [(1, [tab], None, entries)],
        "bits_not_boolean": [(1, [tab], [col, [2] * t_size], entries)],
        "j_table_size": [(1, [tab[:-1]], bits, entries)],
        "k_table_size": [(1, [tab], bits, entries[:-1])],
        "bit_count": [(1, [tab], bits[:1], entries)],
        "no_terms": [],
    }[fault]
    with pytest.raises(SumCheckError):
        ShoutBitsSparseOracle(log_k, log_t, terms, log_k + 2, device="cpu")


# ---------------------------------------------------------------------------
# The native k-phase state is freed whatever happens
# ---------------------------------------------------------------------------

def _record_frees(monkeypatch):
    created, freed = [], []
    real_create, real_free = _native.sbk_create, _native.sbk_free

    def create(*args):
        h = real_create(*args)
        created.append(h)
        return h

    def free(h):
        freed.append(h)
        real_free(h)

    monkeypatch.setattr(_native, "sbk_create", create)
    monkeypatch.setattr(_native, "sbk_free", free)
    return created, freed


@pytest.mark.parametrize("where", ["k_round", "j_round"])
def test_sbk_freed_once_when_a_round_raises(where, params, monkeypatch):
    pp, _ = params[0]
    created, freed = _record_frees(monkeypatch)

    def boom(*_args):
        raise RuntimeError(f"{where} failed")

    if where == "k_round":
        monkeypatch.setattr(_native, "sbk_round_evals", boom)
    else:
        monkeypatch.setattr(fr_kernels, "sum_of_products_round_evals", boom)
    entries, looks = _frozen_lookups()
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        ShoutBits.prove(_port_table(entries, looks), pp, "cpu")
    assert len(created) == 1 and freed == created


@pytest.mark.parametrize("prover,ref_prover,ref_to", [
    (ShoutBits, RefShoutBits, ref_to_bytes),
    (ShoutBitsCommitted, RefCommitted, ref_comm_to_bytes)])
def test_python_k_phase_without_native_engine(prover, ref_prover, ref_to,
                                              params, monkeypatch):
    """Under TNSH_NO_NATIVE the k rounds run in Python and the proof is
    tnsh's, byte for byte."""
    (pp, _), (ref_pp, _) = params
    monkeypatch.setenv("TNSH_NO_NATIVE", "1")
    assert _native.available is False
    entries, looks = _frozen_lookups()
    timer = PhaseTimer()
    b = prover.to_bytes(prover.prove(_port_table(entries, looks), pp, "cpu",
                                     timer))
    monkeypatch.delenv("TNSH_NO_NATIVE")
    assert {"k_rounds", "j_build", "j_rounds"} <= set(timer.phases)
    assert b == ref_to(ref_prover.prove(_ref_table(entries, looks), ref_pp))


def test_empty_table_refused(params):
    pp, _ = params[0]
    with pytest.raises(InvalidParametersError):
        ShoutBits.prove(LookupTable([]), pp, "cpu")
    with pytest.raises(InvalidParametersError):
        ShoutBitsCommitted.preprocess([], "cpu")


# ---------------------------------------------------------------------------
# ShoutBitsCommitted: the verifier holds only the table's commitment
# ---------------------------------------------------------------------------

class TestShoutBitsCommitted:
    @pytest.fixture(scope="class")
    def setup(self, params):
        (pp, _), (ref_pp, _) = params
        entries, looks = _frozen_lookups()
        comm = ShoutBitsCommitted.preprocess([Fr(e) for e in entries], "cpu")
        proof = ShoutBitsCommitted.prove(_port_table(entries, looks), pp,
                                         "cpu")
        ref_comm = RefCommitted.preprocess([RefFr(e) for e in entries])
        ref_proof = RefCommitted.prove(_ref_table(entries, looks), ref_pp)
        return entries, comm, proof, ref_comm, ref_proof

    def test_roundtrip_and_bytes_equal_tnsh(self, setup, params):
        (_, vp), (_, ref_vp) = params
        _, comm, proof, ref_comm, ref_proof = setup
        assert ShoutBitsCommitted.verify(proof, comm, vp)
        b = ShoutBitsCommitted.to_bytes(proof)
        ref_b = ref_comm_to_bytes(ref_proof)
        assert b == ref_b
        assert RefCommitted.verify(ref_comm_from_bytes(b), ref_comm, ref_vp)
        port_comm = KZGCommitmentValue.deserialize_compressed(
            ref_comm.serialize_compressed())
        assert ShoutBitsCommitted.verify(
            shout_bits_comm_proof_from_bytes(ref_b), port_comm, vp)

    def test_preprocess_equals_tnsh(self, setup):
        _, comm, _, ref_comm, _ = setup
        assert comm.serialize_compressed() == ref_comm.serialize_compressed()
        assert RefCommitment.deserialize_compressed(
            comm.serialize_compressed()) == ref_comm

    def test_serde_roundtrip(self, setup, params):
        (_, vp), _ = params
        _, comm, proof, _, _ = setup
        data = ShoutBitsCommitted.to_bytes(proof)
        back = shout_bits_comm_proof_from_bytes(data)
        assert ShoutBitsCommitted.to_bytes(back) == data
        assert ShoutBitsCommitted.verify(back, comm, vp)

    def test_forged_table_value_rejected(self, setup, params):
        (_, vp), _ = params
        _, comm, proof, _, _ = setup
        bad = copy.deepcopy(proof)
        bad.t_value = Fr(int(bad.t_value) + 1)
        assert not ShoutBitsCommitted.verify(bad, comm, vp)

    def test_wrong_table_commitment_rejected(self, setup, params):
        (_, vp), _ = params
        entries, _, proof, _, _ = setup
        wrong = ShoutBitsCommitted.preprocess([Fr(e + 1) for e in entries],
                                              "cpu")
        assert not ShoutBitsCommitted.verify(proof, wrong, vp)

    def test_forged_column_value_rejected(self, setup, params):
        (_, vp), _ = params
        _, comm, proof, _, _ = setup
        bad = copy.deepcopy(proof)
        bad.values_rj[LOG_K] = Fr(int(bad.values_rj[LOG_K]) + 1)
        assert not ShoutBitsCommitted.verify(bad, comm, vp)

    def test_not_replayable_as_plain_shout(self, setup, params):
        """Distinct Fiat-Shamir labels: a committed-table proof's fields
        cannot satisfy the plain ShoutBits verifier."""
        (_, vp), _ = params
        entries, _, proof, _, _ = setup
        cast = ShoutBitsProof(
            log_table=proof.log_table, log_lookups=proof.log_lookups,
            column_commitments=proof.column_commitments, check=proof.check,
            values_rj=proof.values_rj, proof_rj=proof.proof_rj)
        assert not ShoutBits.verify(cast, [Fr(e) for e in entries], vp)


def test_committed_native_column_path_routes(params):
    """T = 2^11 at K = 8: the table's commitment and its opening are
    under 1024 points and go to the host; the bytes equal tnsh's."""
    (pp, vp), (ref_pp, ref_vp) = params
    entries, looks = _bench_lookups(3, 11)
    kzg.reset_route_counts()
    proof = ShoutBitsCommitted.prove(_port_table(entries, looks), pp, "cpu")
    assert kzg.route_counts() == {"device": 5, "host": 14}
    b = ShoutBitsCommitted.to_bytes(proof)
    ref_proof = RefCommitted.prove(_ref_table(entries, looks), ref_pp)
    assert b == ref_comm_to_bytes(ref_proof)
    comm = ShoutBitsCommitted.preprocess([Fr(e) for e in entries], "cpu")
    assert ShoutBitsCommitted.verify(proof, comm, vp)


@pytest.mark.cuda
@pytest.mark.parametrize("log_t", [16, 18, 20])
def test_card_proof_equals_tnsh_host_proof(log_t, params, monkeypatch,
                                           request):
    """K=2^10 on the card (commitments, openings and j rounds) against
    tnsh's host-native prover, with the lookups ``benches/bits_bench.py``
    makes.  Run with ``-s`` to see the prove times, taken in turns port,
    tnsh, port, tnsh in one process, for both provers, and each prove's
    generation-2 collections and their seconds (both packages pause the
    cyclic GC during a prove: none is expected)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # keep tnsh's MSMs on the host: its commit_many otherwise builds a
    # device MSM context under jax before it falls back to the host
    monkeypatch.setenv("TNSH_TPU_MSM", "0")
    monkeypatch.setattr(ref_kzg, "_TPU_MSM_FRACTION", "0")
    (pp, vp), (ref_pp, ref_vp) = params
    log_k = 10
    entries, looks = _bench_lookups(log_k, log_t)
    tbl, ref_tbl = _port_table(entries, looks), _ref_table(entries, looks)
    dev = torch.device("cuda", 0)
    # a prover's process keeps torch's own thread count; the CPU tests'
    # single thread is put back at the end
    torch.set_num_threads(os.cpu_count() or 1)
    request.addfinalizer(lambda: torch.set_num_threads(1))
    small = _frozen_lookups()
    ShoutBits.prove(_port_table(*small), pp, dev)          # CUDA start-up
    # the PST SRSs and the port's device copies, kept out of the timing
    from tnsh_torch.commit.mkzg import MultilinearKZG

    for lg in (log_t, log_k):
        MultilinearKZG.prepare_device(setup_multilinear_params(lg)[0], dev)
        ref_ml_params(lg)
    comm = ShoutBitsCommitted.preprocess([Fr(e) for e in entries], dev)
    ref_comm = RefCommitted.preprocess([RefFr(e) for e in entries])
    assert comm.serialize_compressed() == ref_comm.serialize_compressed()
    # prover -> ((prove, to_bytes) of the port, of tnsh)
    provers = {
        "shout_bits": (
            (lambda: ShoutBits.prove(tbl, pp, dev), ShoutBits.to_bytes),
            (lambda: RefShoutBits.prove(ref_tbl, ref_pp), ref_to_bytes)),
        "shout_bits_committed": (
            (lambda: ShoutBitsCommitted.prove(tbl, pp, dev),
             ShoutBitsCommitted.to_bytes),
            (lambda: RefCommitted.prove(ref_tbl, ref_pp), ref_comm_to_bytes)),
    }
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    proofs = {}
    for name, (port_fns, ref_fns) in provers.items():
        times = {"port": [], "tnsh": []}
        gen2 = {"port": [], "tnsh": []}
        out = {}
        for who in ("port", "tnsh", "port", "tnsh"):
            prove, to_bytes = port_fns if who == "port" else ref_fns
            with GcCollections() as gcs:
                t0 = time.perf_counter()
                proof = prove()
                if who == "port":
                    torch.cuda.synchronize()
                times[who].append(time.perf_counter() - t0)
            gen2[who].append((gcs.count, gcs.seconds, gcs.young_count,
                              gcs.young_seconds))
            b = to_bytes(proof)
            assert out.setdefault(who, b) == b
        assert out["port"] == out["tnsh"]
        proofs[name] = out["port"]
        print(f"\n{name} K=2^{log_k} T=2^{log_t} on {card}: port prove s "
              f"{times['port']}, tnsh host prove s {times['tnsh']}; "
              f"collections (gen-2 count, s, gen-0/1 count, s) {gen2}")
        assert [c[0] for c in gen2["port"] + gen2["tnsh"]] == [0] * 4
    b = proofs["shout_bits_committed"]
    assert RefCommitted.verify(ref_comm_from_bytes(b), ref_comm, ref_vp)
    assert ShoutBitsCommitted.verify(shout_bits_comm_proof_from_bytes(b),
                                     comm, vp)
    b = proofs["shout_bits"]
    _cross_verify(b, b, entries, vp, ref_vp)
    assert sum(c.hazard_count for c in kzg.device_contexts()) == 0
