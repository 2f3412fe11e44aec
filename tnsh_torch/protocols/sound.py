"""The verifier-enforced (sound) tier on a torch device: ``ShoutSound``
and ``TwistSound``, and the helpers the bit-column provers share.

Counterpart of ``tnsh/protocols/sound.py``.  The helpers: power-of-two
padding, batched MLE evaluation, the gamma random linear combinations of
tables, values and commitments, and 1/K.

``ShoutSound`` proves a lookup log against a public table with ONE
claim-0 degree-3 sum-check over the (k, j) cube (batching challenge a):

  0 = sum_{k,j}  eq(rho_r,j) ra T~(k) - (1/K) eq(rho_r,j) rv(j)   READ
     + a   [ eq(rho_b,(k,j)) ra (ra-1) ]                           BOOL
     + a^2 [ eq(rho_o,j) ra - (1/K) eq(rho_o,j) ]                  ONE-HOT

and pins ra~(r) and rv~(r_j) with two PST openings.  ``TwistSound``
proves a read-write memory trace the same way: seven committed tables
(ra, wa, inc and val over the cube, the write flag ot and the values rv
and wv over the cycles), eight constraint groups batched by powers of a
challenge alpha into one claim-0 sum-check (READ, VAL, INC, the
booleanity of ra, wa and ot, and the row sums of ra and wa), and the
seven evaluations pinned by two gamma-RLC PST openings, one over the cube
and one over the cycles.

Both provers follow the JAX package's line for line and pick one of two
paths with identical bytes:

  * sparse (log K + log T >= ``_SPARSE_MIN_VARS``): the cube tables are
    ``SparseCubeTable`` (one-hots, inc) or ``IncrementalCubeTable``
    (val), each committed as one T-point MSM over the factorized cube SRS
    and opened j first (``tnsh_torch.commit.mkzg_sparse``); the sum-check
    runs on ``SparseCubeOracle`` (k rounds on the native engine, or in
    Python under ``TNSH_NO_NATIVE``; j rounds on the card), staged as the
    bit-column provers' phase A is: ``oracle_a_build`` (the k phase's
    tables and the engine's state), ``k_rounds``, ``j_build``,
    ``j_rounds``;
  * dense (fewer variables, or an external SRS): the 2^n cube tables on a
    ``TorchSumOfProductsOracle``, committed over the 2^n-point PST SRS and
    opened in the same j-first order.

Every MSM runs through the router on ``device``.  ``verify`` and
``to_bytes`` are the port's own code; each package's verifier accepts the
other's bytes.  As in the JAX package, both provers run with the cyclic
garbage collector paused (``twist_bits._gc_paused``, counted across
threads; TNSH_GC_PAUSE=0 opts out) and release their oracles in a
``finally``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from .. import _native
from ..commit.kzg import KZGCommitmentValue
from ..commit.mkzg import (
    MLOpeningProof,
    MultilinearKZG,
    batch_verify_openings,
    has_external_multilinear_srs,
    multilinear_verification_key,
    setup_multilinear_params,
)
from ..commit.mkzg_sparse import (
    IncrementalCubeTable,
    SparseCubeTable,
    commit_cube_async,
    commit_sparse,
    cube_params,
    incremental_mle_eval,
    open_combined,
    open_dense_cube,
    open_sparse,
    prepare_device,
    sparse_mle_eval,
)
from ..core.params import ProverParams, VerifierParams
from ..core.proof_io import (
    MAX_LOG_SIZE,
    shout_sound_proof_to_bytes,
    twist_sound_proof_to_bytes,
)
from ..core.transcript import Transcript
from ..errors import InvalidParametersError
from ..field import limbs
from ..field.fr import MODULUS, Fr, FrTable
from ..field.g1 import G1
from ..iop.sparse_oracle import SparseCubeOracle
from ..iop.sumcheck import SumCheck, SumCheckProof, TorchSumOfProductsOracle
from ..poly.eq import eq_eval, eq_table, lt_eval, lt_partial_table, mle_eval
from ..utils.profiling import PhaseTimer, count, span
from .shout import LookupTable
from .twist import MemoryTrace

_P = MODULUS


def _next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _rlc_tables(tables: Sequence[Sequence[int]], gamma: int):
    """Pointwise sum_i gamma^i * tables[i] mod p (bytes-backed FrTable on
    the native path; a plain int list otherwise)."""
    if len(tables[0]) >= 1024 and _native.available:
        return FrTable(_native.fr_rlc(tables, gamma))
    out = [int(v) % _P for v in tables[0]]
    w = 1
    for tab in tables[1:]:
        w = w * gamma % _P
        for i, v in enumerate(tab):
            out[i] = (out[i] + w * int(v)) % _P
    return out


def _mle_eval_many(tables: Sequence[Sequence], point: Sequence[Fr]
                   ) -> List[Fr]:
    """[~table(point) for each table] — one native batch call when
    available (the bit-column provers evaluate 2logK+4 columns at once)."""
    if tables and len(tables[0]) >= 1024 and point and _native.available:
        return _native.fr_mle_eval_many(tables, point)
    return [Fr(mle_eval(t, point)) for t in tables]


def _kinv(log_k: int) -> int:
    """1/K mod p — the lift coefficient for column constraints."""
    return pow((1 << log_k) % _P, _P - 2, _P)


def _rlc_values(values: Sequence[Fr], gamma: int) -> int:
    acc = 0
    w = 1
    for v in values:
        acc = (acc + w * int(v)) % _P
        w = w * gamma % _P
    return acc


def _rlc_commitments(
    comms: Sequence[KZGCommitmentValue], gamma: int
) -> KZGCommitmentValue:
    def smul(p: G1, s: int) -> G1:
        if s == 1:
            return p
        if _native.available:
            return _native.g1_scalar_mul(p, Fr(s))
        return p.scalar_mul(s)

    acc = comms[0].commitment
    w = 1
    for c in comms[1:]:
        w = w * gamma % _P
        acc = acc.add(smul(c.commitment, w))
    return KZGCommitmentValue(acc)


#: Cube sizes with at least this many variables route to the sparse prover
#: (factorized PST commits + SparseCubeOracle): identical proofs, O((K+T)
#: polylog) prover instead of O(K*T) — the dense path would also have to
#: materialize a 2^n-point SRS.
_SPARSE_MIN_VARS = 14


def _check_sparse_path(n: int) -> None:
    """Refuse the sparse path before it builds the cube SRS: its
    factorized commitments need the deterministic SRS's tau_k."""
    if has_external_multilinear_srs(n):
        raise InvalidParametersError(
            "sparse sound proving needs the deterministic factorized "
            "SRS (tau_k); an external ceremony SRS is installed for "
            "this variable count — use the dense prover (sparse=False)"
        )


@dataclass
class MLOpening:
    """A claimed PST evaluation with its proof; the opening point is
    recomputed by the verifier from the transcript."""

    value: Fr
    proof: MLOpeningProof


def _lift_j(col: Sequence[int], k_size: int) -> List[int]:
    """Lift a column over j to the (k,j) cube (k fastest)."""
    out: List[int] = []
    for v in col:
        out.extend([v] * k_size)
    return out


def _lift_k(col: Sequence[int], t_size: int) -> List[int]:
    """Lift a column over k to the (k,j) cube (k fastest)."""
    return list(col) * t_size


def _open_cube_dense(params_n, log_k: int, log_t: int, table, point,
                     device):
    """Open a dense (k, j) cube table: j-first factorized order under the
    deterministic SRS (byte-identical to the sparse prover), suffix-order
    ``MultilinearKZG.open`` under an external ceremony SRS (where tau_k is
    unknown)."""
    if has_external_multilinear_srs(log_k + log_t):
        return MultilinearKZG.open(params_n, table, point, device)
    return open_dense_cube(cube_params(log_k, log_t), table, point, device)


@dataclass
class ShoutSoundProof:
    log_table: int
    log_lookups: int
    ra_commitment: KZGCommitmentValue
    rv_commitment: KZGCommitmentValue
    #: the single batched sum-check (claim 0)
    check: SumCheckProof
    #: ra~(r) with its PST proof (r = the sum-check point)
    ra_at_r: MLOpening
    #: rv~(r_j) with its PST proof
    rv_at_r: MLOpening


def _lookup_columns(ops, entries, t_size: int):
    """(address, value) of every cycle; padding cycles look up slot 0."""
    for j in range(t_size):
        if j < len(ops):
            yield ops[j].index, int(ops[j].value)
        else:
            yield 0, entries[0]


def _check_opened(ra_val, v_ra, rv_val, v_rv) -> None:
    if int(ra_val) != int(v_ra) or int(rv_val) != int(v_rv):
        raise AssertionError("opened values disagree with the claimed "
                             "evaluations")


class ShoutSound:
    """Verifier-enforced Shout: a binding lookup argument against a public
    table (see the module docstring for the statement)."""

    @staticmethod
    def prove(table: LookupTable, prover_params: ProverParams, device,
              timer: Optional[PhaseTimer] = None,
              sparse: Optional[bool] = None) -> ShoutSoundProof:
        """Prove ``table``'s lookup log; commitments, openings and the
        sum-check's device rounds run on ``device`` (a CUDA device, or the
        CPU with the kernels' plain versions).  ``sparse`` picks the path
        (default: by size, and dense under an external SRS).  ``timer``
        (optional) receives the stages ``simulate``, ``srs``, ``commit``
        (with its MSM stages as ``commit/plan`` ...), the oracle's, and
        ``open`` (``open/plan`` ...): ``oracle_a_build``, ``k_rounds``,
        ``j_build`` and ``j_rounds`` on the sparse path, with ``open``'s
        ``open/evals`` and ``open/cube`` (the j-first opening of ra),
        ``cube_build`` and ``cube_rounds`` on the dense one."""
        # lazy: twist_bits imports this module
        from .twist_bits import _gc_paused

        return _gc_paused(ShoutSound._prove_impl)(
            table, prover_params, device, timer, sparse)

    @staticmethod
    def _prove_impl(table: LookupTable, prover_params: ProverParams, device,
                    timer: Optional[PhaseTimer],
                    sparse: Optional[bool]) -> ShoutSoundProof:
        timer = PhaseTimer() if timer is None else timer
        entries = [int(e) for e in table.entries]
        if not entries:
            raise InvalidParametersError("Sound Shout needs a non-empty table")
        k_size = _next_power_of_two(len(entries))
        entries = entries + [0] * (k_size - len(entries))
        ops = list(table.lookups)
        t_size = _next_power_of_two(max(len(ops), 1))
        log_k = k_size.bit_length() - 1
        log_t = t_size.bit_length() - 1
        n = log_k + log_t
        if sparse is None:
            sparse = (n >= _SPARSE_MIN_VARS
                      and not has_external_multilinear_srs(n))
        prove = ShoutSound._prove_sparse if sparse else ShoutSound._prove_dense
        return prove(entries, ops, log_k, log_t, prover_params, device,
                     timer)

    @staticmethod
    def _prove_dense(entries, ops, log_k: int, log_t: int,
                     prover_params: ProverParams, device,
                     timer: PhaseTimer) -> ShoutSoundProof:
        k_size, t_size = 1 << log_k, 1 << log_t
        n = log_k + log_t
        with timer.phase("simulate"):
            ra = [0] * (k_size * t_size)
            rv = [0] * t_size
            for j, (idx, val) in enumerate(
                    _lookup_columns(ops, entries, t_size)):
                ra[j * k_size + idx] = 1
                rv[j] = val
        with timer.phase("srs"):
            params_n, _ = setup_multilinear_params(n)
            params_t, _ = setup_multilinear_params(log_t)
            MultilinearKZG.prepare_device(params_n, device)
            MultilinearKZG.prepare_device(params_t, device)
            if not has_external_multilinear_srs(n):
                prepare_device(cube_params(log_k, log_t), device)
        with timer.phase("commit"):
            c_ra = MultilinearKZG.commit(params_n, ra, device)
            c_rv = MultilinearKZG.commit(params_t, rv, device)

        transcript = Transcript(prover_params.fiat_shamir_seed)
        _shout_bind_statement(transcript, log_k, log_t, entries, c_ra, c_rv)
        rho_r, rho_b, rho_o, alpha = _shout_challenges(transcript, log_k,
                                                       log_t)
        a, a2 = int(alpha), int(alpha) ** 2 % _P
        kinv = _kinv(log_k)
        oracle = None
        try:
            with timer.phase("cube_build"):
                eq_r = _lift_j(eq_table(rho_r), k_size)
                eq_b = eq_table(rho_b)
                eq_o = _lift_j(eq_table(rho_o), k_size)
                tab_k = _lift_k(entries, t_size)
                rv_l = _lift_j(rv, k_size)
                oracle = TorchSumOfProductsOracle(n, [
                    (1, [eq_r, ra, tab_k]),
                    (_P - kinv, [eq_r, rv_l]),
                    (a, [eq_b, ra, ra]),
                    (_P - a, [eq_b, ra]),
                    (a2, [eq_o, ra]),
                    (a2 * (_P - kinv) % _P, [eq_o]),
                ], device=device)
            with timer.phase("cube_rounds"):
                check, r = SumCheck(n, Fr(0)).prove_with_challenges(
                    oracle, transcript)
        finally:
            if oracle is not None:
                oracle.release()

        with timer.phase("open"):
            v_ra = mle_eval(ra, r)
            v_rv = mle_eval(rv, r[log_k:])
            ra_val, ra_proof = _open_cube_dense(params_n, log_k, log_t, ra,
                                                r, device)
            rv_val, rv_proof = MultilinearKZG.open(params_t, rv, r[log_k:],
                                                   device)
            _check_opened(ra_val, v_ra, rv_val, v_rv)
        return ShoutSoundProof(
            log_table=log_k,
            log_lookups=log_t,
            ra_commitment=c_ra,
            rv_commitment=c_rv,
            check=check,
            ra_at_r=MLOpening(v_ra, ra_proof),
            rv_at_r=MLOpening(v_rv, rv_proof),
        )

    @staticmethod
    def _prove_sparse(entries, ops, log_k: int, log_t: int,
                      prover_params: ProverParams, device,
                      timer: PhaseTimer) -> ShoutSoundProof:
        """The dense path's bytes in O(T + K) memory: commitments are
        T-point MSMs over the factorized cube SRS and the sum-check runs
        on ``SparseCubeOracle`` (its k rounds on the native engine, or in
        Python under ``TNSH_NO_NATIVE``)."""
        _check_sparse_path(log_k + log_t)
        t_size = 1 << log_t
        n = log_k + log_t
        with timer.phase("simulate"):
            ra = SparseCubeTable(log_k, log_t)
            rv = [0] * t_size
            for j, (idx, val) in enumerate(
                    _lookup_columns(ops, entries, t_size)):
                ra.set(j, idx, 1)
                rv[j] = val
        with timer.phase("srs"):
            cp = cube_params(log_k, log_t)
            params_t, _ = setup_multilinear_params(log_t)
            prepare_device(cp, device)
            MultilinearKZG.prepare_device(params_t, device)
        with timer.phase("commit"):
            c_ra = commit_sparse(cp, ra, device)
            c_rv = MultilinearKZG.commit(params_t, rv, device)

        transcript = Transcript(prover_params.fiat_shamir_seed)
        _shout_bind_statement(transcript, log_k, log_t, entries, c_ra, c_rv)
        rho_r, rho_b, rho_o, alpha = _shout_challenges(transcript, log_k,
                                                       log_t)
        a, a2 = int(alpha), int(alpha) ** 2 % _P
        kinv = _kinv(log_k)
        oracle = None
        try:
            with timer.phase("oracle_a_build"):
                eq_r = eq_table(rho_r)
                ekb = eq_table(rho_b[:log_k])
                ejb = eq_table(rho_b[log_k:])
                eq_o = eq_table(rho_o)
            oracle = SparseCubeOracle(log_k, log_t, [
                (1, [("eqj", eq_r), ("colsparse", ra), ("eqk", entries)]),
                (_P - kinv, [("eqj", eq_r), ("eqj", rv)]),
                (a, [("eqk", ekb), ("eqj", ejb), ("colsparse", ra),
                     ("colsparse", ra)]),
                (_P - a, [("eqk", ekb), ("eqj", ejb), ("colsparse", ra)]),
                (a2, [("eqj", eq_o), ("colsparse", ra)]),
                (a2 * (_P - kinv) % _P, [("eqj", eq_o)]),
            ], device=device, timer=timer)
            check, r = SumCheck(n, Fr(0)).prove_with_challenges(oracle,
                                                                transcript)
        finally:
            if oracle is not None:
                oracle.release()

        with timer.phase("open"):
            with timer.phase("open/evals"):
                v_ra = sparse_mle_eval(ra, r)
                v_rv = mle_eval(rv, r[log_k:])
            with timer.span("cube"):
                ra_val, ra_proof = open_sparse(cp, ra, r, device)
            rv_val, rv_proof = MultilinearKZG.open(params_t, rv, r[log_k:],
                                                   device)
            _check_opened(ra_val, v_ra, rv_val, v_rv)
        return ShoutSoundProof(
            log_table=log_k,
            log_lookups=log_t,
            ra_commitment=c_ra,
            rv_commitment=c_rv,
            check=check,
            ra_at_r=MLOpening(v_ra, ra_proof),
            rv_at_r=MLOpening(v_rv, rv_proof),
        )

    @staticmethod
    def verify(proof: ShoutSoundProof, table_entries: Sequence[Fr],
               verifier_params: VerifierParams) -> bool:
        log_k, log_t = proof.log_table, proof.log_lookups
        # bound untrusted u64 size fields before the 1 << log_k allocation
        # and the challenge-draw loops
        if log_k > MAX_LOG_SIZE or log_t > MAX_LOG_SIZE:
            return False
        n = log_k + log_t
        entries = [int(e) for e in table_entries]
        k_size = 1 << log_k
        if not entries or _next_power_of_two(len(entries)) != k_size:
            return False
        entries = entries + [0] * (k_size - len(entries))

        transcript = Transcript(verifier_params.fiat_shamir_seed)
        _shout_bind_statement(
            transcript, log_k, log_t, entries,
            proof.ra_commitment, proof.rv_commitment,
        )
        rho_r, rho_b, rho_o, alpha = _shout_challenges(transcript, log_k,
                                                       log_t)

        ok, r = SumCheck(n, Fr(0)).verify(proof.check, transcript)
        if not ok:
            return False
        r_k, r_j = r[:log_k], r[log_k:]

        # the final evaluation, from the claimed values at r
        a = int(alpha)
        a2 = a * a % _P
        kinv = _kinv(log_k)
        v_ra = int(proof.ra_at_r.value)
        v_rv = int(proof.rv_at_r.value)
        e_r = int(eq_eval(rho_r, r_j))
        e_o = int(eq_eval(rho_o, r_j))
        want = (
            e_r * v_ra % _P * int(mle_eval(entries, r_k))
            - kinv * e_r % _P * v_rv
            + a * int(eq_eval(rho_b, r)) % _P * v_ra % _P * ((v_ra - 1) % _P)
            + a2 * e_o % _P * v_ra
            - a2 * kinv % _P * e_o
        ) % _P
        if int(proof.check.final_evaluation) != want:
            return False

        vk_n = multilinear_verification_key(n)
        vk_t = multilinear_verification_key(log_t)
        return batch_verify_openings([
            (vk_n, proof.ra_commitment, r,
             proof.ra_at_r.value, proof.ra_at_r.proof),
            (vk_t, proof.rv_commitment, r_j,
             proof.rv_at_r.value, proof.rv_at_r.proof),
        ])

    @staticmethod
    def to_bytes(proof: ShoutSoundProof) -> bytes:
        """The format-v2 encoding of ``proof`` (magic SHSS)."""
        return shout_sound_proof_to_bytes(proof)


def _shout_bind_statement(
    transcript: Transcript,
    log_k: int,
    log_t: int,
    entries: Sequence[int],
    c_ra: KZGCommitmentValue,
    c_rv: KZGCommitmentValue,
) -> None:
    transcript.append_field_element(b"ssound_version", Fr(2))
    transcript.append_field_element(b"ssound_log_table", Fr(log_k))
    transcript.append_field_element(b"ssound_log_lookups", Fr(log_t))
    transcript.append_field_elements(
        b"ssound_table", [Fr(e) for e in entries]
    )
    transcript.append_field_element(b"ssound_ra_commitment", c_ra.hash())
    transcript.append_field_element(b"ssound_rv_commitment", c_rv.hash())


def _shout_challenges(transcript: Transcript, log_k: int, log_t: int):
    n = log_k + log_t
    rho_r = transcript.challenge_field_elements(b"ssound_rho_read", log_t)
    rho_b = transcript.challenge_field_elements(b"ssound_rho_bool", n)
    rho_o = transcript.challenge_field_elements(b"ssound_rho_onehot", log_t)
    alpha = transcript.challenge_field_element(b"ssound_alpha")
    return rho_r, rho_b, rho_o, alpha


# ===========================================================================
# Twist
# ===========================================================================

@dataclass
class TwistSoundProof:
    log_memory: int
    log_ops: int
    ra_commitment: KZGCommitmentValue
    wa_commitment: KZGCommitmentValue
    inc_commitment: KZGCommitmentValue
    val_commitment: KZGCommitmentValue
    ot_commitment: KZGCommitmentValue
    rv_commitment: KZGCommitmentValue
    wv_commitment: KZGCommitmentValue
    #: the single batched sum-check (claim 0)
    check: SumCheckProof
    #: [ra~(r), wa~(r), inc~(r), val~(r)], backed by cube_proof
    cube_values: List[Fr]
    #: [ot~(r_j), rv~(r_j), wv~(r_j)], backed by col_proof
    col_values: List[Fr]
    #: PST proof for the gamma-RLC of (ra, wa, inc, val) at r
    cube_proof: MLOpeningProof
    #: PST proof for the gamma-RLC of (ot, rv, wv) at r_j
    col_proof: MLOpeningProof


def _twist_witness(ops, log_k: int, log_t: int):
    """The seven witness tables of an honest run of ``ops``: ra, wa and
    inc as ``SparseCubeTable`` (inc holds the write's change of the cell),
    val as ``IncrementalCubeTable`` (the memory before each cycle), and
    the columns ot, rv and wv over the cycles.  Padding cycles read cell 0
    (ot = 0, no change of state).  Counts the cube tables' entries (one in
    ra a read, one in each of wa, inc and val a write) as ``cube_entries``."""
    t_size = 1 << log_t
    ra = SparseCubeTable(log_k, log_t)
    wa = SparseCubeTable(log_k, log_t)
    inc = SparseCubeTable(log_k, log_t)
    val = IncrementalCubeTable(log_k, log_t)
    ot = [0] * t_size
    rv = [0] * t_size
    wv = [0] * t_size
    mem = [0] * (1 << log_k)
    for j in range(t_size):
        if j < len(ops):
            op = ops[j]
            a = op.address
            if op.is_write:
                v = int(op.value) % _P
                ot[j] = 1
                wa.set(j, a, 1)
                wv[j] = v
                delta = (v - mem[a]) % _P
                inc.set(j, a, delta)
                val.add_update(j, a, delta)
                mem[a] = v
            else:
                ra.set(j, a, 1)
                rv[j] = mem[a]
        else:
            ra.set(j, 0, 1)
            rv[j] = mem[0]
    count("cube_entries", t_size + 2 * sum(ot))
    return ra, wa, inc, val, ot, rv, wv


def _marshal_witness(witness):
    """``_twist_witness``'s tables as the engine reads them, made once
    under the child span ``marshal``: each cube table's CSR view (cached
    on the table) and the cycle columns ot, rv and wv as 32-byte words
    (``FrTable``), which the commitments, the k phase's engine, the j
    phase and the openings take as they are.  Without the engine the
    witness is returned as it is."""
    if not _native.available:
        return witness
    with span("marshal"):
        for table in witness[:4]:
            table.csr()
        return (*witness[:4],
                *(FrTable(limbs.le_bytes(col)) for col in witness[4:]))


def _twist_sparse_terms(log_k: int, log_t: int, witness, challenges):
    """The sparse path's 18 terms over the cube (``SparseCubeOracle``'s
    factor kinds), from the witness of ``_twist_witness`` and the
    challenges of ``_twist_challenges``: the dense path's terms with every
    cube eq table split into its k and j halves."""
    ra, wa, inc, val, ot, rv, wv = witness
    (rho1, tau, sigma, rho4, rho5, rho6, rho7, rho8, alpha) = challenges
    ap = _alpha_powers(alpha)
    kinv = _kinv(log_k)
    eq1 = eq_table(rho1)
    eq_tauk = eq_table(tau[:log_k])
    eq_tauj = eq_table(tau[log_k:])
    lt_tj = lt_partial_table(log_t, tau[log_k:])
    ek_s = eq_table(sigma[:log_k])
    ej_s = eq_table(sigma[log_k:])
    ek4 = eq_table(rho4[:log_k])
    ej4 = eq_table(rho4[log_k:])
    ek5 = eq_table(rho5[:log_k])
    ej5 = eq_table(rho5[log_k:])
    eq6 = eq_table(rho6)
    eq7 = eq_table(rho7)
    eq8 = eq_table(rho8)
    return [
        # READ
        (1, [("eqj", eq1), ("colsparse", ra), ("colinc", val)]),
        (_P - kinv, [("eqj", eq1), ("eqj", rv)]),
        # VAL (first term: class I, a colinc with no colsparse)
        (ap[1], [("eqk", eq_tauk), ("eqj", eq_tauj), ("colinc", val)]),
        (_P - ap[1], [("eqk", eq_tauk), ("eqj", lt_tj),
                      ("colsparse", inc)]),
        # INC
        (ap[2], [("eqk", ek_s), ("eqj", ej_s), ("colsparse", inc)]),
        (_P - ap[2], [("eqk", ek_s), ("eqj", ej_s), ("eqj", wv),
                      ("colsparse", wa)]),
        (ap[2], [("eqk", ek_s), ("eqj", ej_s), ("colsparse", wa),
                 ("colinc", val)]),
        # BOOL ra / wa / ot (ot: class E, j-only factors)
        (ap[3], [("eqk", ek4), ("eqj", ej4), ("colsparse", ra),
                 ("colsparse", ra)]),
        (_P - ap[3], [("eqk", ek4), ("eqj", ej4), ("colsparse", ra)]),
        (ap[4], [("eqk", ek5), ("eqj", ej5), ("colsparse", wa),
                 ("colsparse", wa)]),
        (_P - ap[4], [("eqk", ek5), ("eqj", ej5), ("colsparse", wa)]),
        (ap[5], [("eqj", eq6), ("eqj", ot), ("eqj", ot)]),
        (_P - ap[5], [("eqj", eq6), ("eqj", ot)]),
        # ROW-SUM ra / wa
        (ap[6], [("eqj", eq7), ("colsparse", ra)]),
        (ap[6] * kinv % _P, [("eqj", eq7), ("eqj", ot)]),
        (ap[6] * (_P - kinv) % _P, [("eqj", eq7)]),
        (ap[7], [("eqj", eq8), ("colsparse", wa)]),
        (ap[7] * (_P - kinv) % _P, [("eqj", eq8), ("eqj", ot)]),
    ]


class TwistSound:
    """Verifier-enforced Twist: binding read-write memory checking (see
    the module docstring for the statement)."""

    @staticmethod
    def prove(trace: MemoryTrace, prover_params: ProverParams, device,
              timer: Optional[PhaseTimer] = None,
              sparse: Optional[bool] = None) -> TwistSoundProof:
        """Prove ``trace``; commitments, openings and the sum-check's
        device rounds run on ``device`` (a CUDA device, or the CPU with
        the kernels' plain versions).  ``sparse`` picks the path (default:
        by size, and dense under an external SRS).  ``timer`` (optional)
        receives the stages ``simulate``, ``srs``, ``commit`` (with its MSM
        stages as ``commit/plan`` ...), the sum-check's and ``open``
        (``open/plan`` ...): ``oracle_a_build``, ``k_rounds``, ``j_build``
        and ``j_rounds`` on the sparse path, ``cube_build`` and
        ``cube_rounds`` on the dense one.  The sparse path's ``commit``
        holds the child spans ``marshal`` (``_marshal_witness``) and
        ``scalars`` (the cube tables' factorized column scalars), its
        ``open`` the phases ``open/evals`` (the claimed values) and
        ``open/rlc`` (the cycle columns' combination) and the child span
        ``cube`` (the cube's j-first opening and its MSMs)."""
        from .twist_bits import _gc_paused

        return _gc_paused(TwistSound._prove_impl)(
            trace, prover_params, device, timer, sparse)

    @staticmethod
    def _prove_impl(trace: MemoryTrace, prover_params: ProverParams, device,
                    timer: Optional[PhaseTimer],
                    sparse: Optional[bool]) -> TwistSoundProof:
        timer = PhaseTimer() if timer is None else timer
        log_k = trace.memory_size.bit_length() - 1
        ops = list(trace.operations)
        t_size = _next_power_of_two(max(len(ops), 1))
        log_t = t_size.bit_length() - 1
        n = log_k + log_t
        if sparse is None:
            sparse = (n >= _SPARSE_MIN_VARS
                      and not has_external_multilinear_srs(n))
        prove = TwistSound._prove_sparse if sparse else TwistSound._prove_dense
        return prove(ops, log_k, log_t, prover_params, device, timer)

    @staticmethod
    def _prove_dense(ops, log_k: int, log_t: int,
                     prover_params: ProverParams, device,
                     timer: PhaseTimer) -> TwistSoundProof:
        k_size, t_size = 1 << log_k, 1 << log_t
        n = log_k + log_t
        with timer.phase("simulate"):
            s_ra, s_wa, s_inc, s_val, ot, rv, wv = _twist_witness(
                ops, log_k, log_t)
            ra, wa, inc, val = (t.to_dense()
                                for t in (s_ra, s_wa, s_inc, s_val))
        with timer.phase("srs"):
            params_n, _ = setup_multilinear_params(n)
            params_t, _ = setup_multilinear_params(log_t)
            MultilinearKZG.prepare_device(params_n, device)
            MultilinearKZG.prepare_device(params_t, device)
            if not has_external_multilinear_srs(n):
                prepare_device(cube_params(log_k, log_t), device)
        with timer.phase("commit"):
            fins = (MultilinearKZG.commit_many_async(
                params_n, [ra, wa, inc, val], device)
                + MultilinearKZG.commit_many_async(
                    params_t, [ot, rv, wv], device))
            comms = [fin() for fin in fins]

        transcript = Transcript(prover_params.fiat_shamir_seed)
        _twist_bind_statement(transcript, log_k, log_t, *comms)
        (rho1, tau, sigma, rho4, rho5, rho6, rho7, rho8,
         alpha) = _twist_challenges(transcript, log_k, log_t)
        ap = _alpha_powers(alpha)
        kinv = _kinv(log_k)
        oracle = None
        try:
            with timer.phase("cube_build"):
                eq1 = _lift_j(eq_table(rho1), k_size)
                rv_l = _lift_j(rv, k_size)
                eq_tau = eq_table(tau)
                eq_tk = _lift_k(eq_table(tau[:log_k]), t_size)
                lt_tj = _lift_j(lt_partial_table(log_t, tau[log_k:]), k_size)
                eq_s = eq_table(sigma)
                wv_l = _lift_j(wv, k_size)
                eq4 = eq_table(rho4)
                eq5 = eq_table(rho5)
                eq6 = _lift_j(eq_table(rho6), k_size)
                ot_l = _lift_j(ot, k_size)
                eq7 = _lift_j(eq_table(rho7), k_size)
                eq8 = _lift_j(eq_table(rho8), k_size)
                oracle = TorchSumOfProductsOracle(n, [
                    # READ
                    (1, [eq1, ra, val]),
                    (_P - kinv, [eq1, rv_l]),
                    # VAL
                    (ap[1], [eq_tau, val]),
                    (_P - ap[1], [eq_tk, lt_tj, inc]),
                    # INC
                    (ap[2], [eq_s, inc]),
                    (_P - ap[2], [eq_s, wa, wv_l]),
                    (ap[2], [eq_s, wa, val]),
                    # BOOL ra / wa / ot
                    (ap[3], [eq4, ra, ra]),
                    (_P - ap[3], [eq4, ra]),
                    (ap[4], [eq5, wa, wa]),
                    (_P - ap[4], [eq5, wa]),
                    (ap[5], [eq6, ot_l, ot_l]),
                    (_P - ap[5], [eq6, ot_l]),
                    # ROW-SUM ra / wa
                    (ap[6], [eq7, ra]),
                    (ap[6] * kinv % _P, [eq7, ot_l]),
                    (ap[6] * (_P - kinv) % _P, [eq7]),
                    (ap[7], [eq8, wa]),
                    (ap[7] * (_P - kinv) % _P, [eq8, ot_l]),
                ], device=device)
            with timer.phase("cube_rounds"):
                check, r = SumCheck(n, Fr(0)).prove_with_challenges(
                    oracle, transcript)
        finally:
            if oracle is not None:
                oracle.release()

        with timer.phase("open"):
            r_j = r[log_k:]
            cube_values = [mle_eval(t, r) for t in (ra, wa, inc, val)]
            col_values = _mle_eval_many([ot, rv, wv], r_j)
            g = int(_bind_values_draw_gamma(transcript, cube_values,
                                            col_values))
            cube_val, cube_proof = _open_cube_dense(
                params_n, log_k, log_t, _rlc_tables([ra, wa, inc, val], g),
                r, device)
            col_val, col_proof = MultilinearKZG.open(
                params_t, _rlc_tables([ot, rv, wv], g), r_j, device)
            _check_opened(cube_val, _rlc_values(cube_values, g), col_val,
                          _rlc_values(col_values, g))
        return TwistSoundProof(log_k, log_t, *comms, check, cube_values,
                               col_values, cube_proof, col_proof)

    @staticmethod
    def _prove_sparse(ops, log_k: int, log_t: int,
                      prover_params: ProverParams, device,
                      timer: PhaseTimer) -> TwistSoundProof:
        """The dense path's bytes in O(T + K) memory: ra, wa and inc are
        column-sparse, val column-incremental; the seven commitments are
        T-point MSMs dispatched in one burst, the cube's four over the
        factorized cube SRS; the sum-check runs on ``SparseCubeOracle``
        (its k rounds on the native engine, or in Python under
        ``TNSH_NO_NATIVE``)."""
        _check_sparse_path(log_k + log_t)
        n = log_k + log_t
        with timer.phase("simulate"):
            witness = _twist_witness(ops, log_k, log_t)
            ra, wa, inc, val, ot, rv, wv = witness
        with timer.phase("srs"):
            cp = cube_params(log_k, log_t)
            params_t, _ = setup_multilinear_params(log_t)
            prepare_device(cp, device)
            MultilinearKZG.prepare_device(params_t, device)
        with timer.phase("commit"):
            witness = _marshal_witness(witness)
            ra, wa, inc, val, ot, rv, wv = witness
            fins = (commit_cube_async(cp, [ra, wa, inc, val], device)
                    + MultilinearKZG.commit_many_async(
                        params_t, [ot, rv, wv], device))
            comms = [fin() for fin in fins]

        transcript = Transcript(prover_params.fiat_shamir_seed)
        _twist_bind_statement(transcript, log_k, log_t, *comms)
        ch = _twist_challenges(transcript, log_k, log_t)
        oracle = None
        try:
            with timer.phase("oracle_a_build"):
                terms = _twist_sparse_terms(log_k, log_t, witness, ch)
            oracle = SparseCubeOracle(log_k, log_t, terms, device=device,
                                      timer=timer)
            check, r = SumCheck(n, Fr(0)).prove_with_challenges(oracle,
                                                                transcript)
        finally:
            if oracle is not None:
                oracle.release()

        with timer.phase("open"):
            r_j = r[log_k:]
            with timer.phase("open/evals"):
                cube_values = [sparse_mle_eval(ra, r),
                               sparse_mle_eval(wa, r),
                               sparse_mle_eval(inc, r),
                               incremental_mle_eval(val, r)]
                col_values = _mle_eval_many([ot, rv, wv], r_j)
            g = int(_bind_values_draw_gamma(transcript, cube_values,
                                            col_values))
            with timer.span("cube"):
                cube_val, cube_proof = open_combined(
                    cp, [(1, ra), (g, wa), (g * g % _P, inc)],
                    [(pow(g, 3, _P), val)], r, device)
            with timer.phase("open/rlc"):
                col_rlc = _rlc_tables([ot, rv, wv], g)
            col_val, col_proof = MultilinearKZG.open(
                params_t, col_rlc, r_j, device)
            _check_opened(cube_val, _rlc_values(cube_values, g), col_val,
                          _rlc_values(col_values, g))
        return TwistSoundProof(log_k, log_t, *comms, check, cube_values,
                               col_values, cube_proof, col_proof)

    @staticmethod
    def verify(proof: TwistSoundProof,
               verifier_params: VerifierParams) -> bool:
        log_k, log_t = proof.log_memory, proof.log_ops
        # bound untrusted u64 size fields before the challenge-draw loops
        if log_k > MAX_LOG_SIZE or log_t > MAX_LOG_SIZE:
            return False
        n = log_k + log_t
        if len(proof.cube_values) != 4 or len(proof.col_values) != 3:
            return False

        transcript = Transcript(verifier_params.fiat_shamir_seed)
        _twist_bind_statement(
            transcript, log_k, log_t,
            proof.ra_commitment, proof.wa_commitment, proof.inc_commitment,
            proof.val_commitment, proof.ot_commitment, proof.rv_commitment,
            proof.wv_commitment,
        )
        (rho1, tau, sigma, rho4, rho5, rho6, rho7, rho8,
         alpha) = _twist_challenges(transcript, log_k, log_t)

        ok, r = SumCheck(n, Fr(0)).verify(proof.check, transcript)
        if not ok:
            return False
        r_k, r_j = r[:log_k], r[log_k:]
        g = int(_bind_values_draw_gamma(transcript, proof.cube_values,
                                        proof.col_values))

        # the final evaluation, from the claimed values and the eq / lt
        # closed forms at r
        ap = _alpha_powers(alpha)
        kinv = _kinv(log_k)
        v_ra, v_wa, v_inc, v_val = (int(v) % _P for v in proof.cube_values)
        v_ot, v_rv, v_wv = (int(v) % _P for v in proof.col_values)
        e1 = int(eq_eval(rho1, r_j))
        e_tau = int(eq_eval(tau, r))
        e_tk = int(eq_eval(tau[:log_k], r_k))
        lt_v = int(lt_eval(r_j, tau[log_k:]))
        e_s = int(eq_eval(sigma, r))
        e4 = int(eq_eval(rho4, r))
        e5 = int(eq_eval(rho5, r))
        e6 = int(eq_eval(rho6, r_j))
        e7 = int(eq_eval(rho7, r_j))
        e8 = int(eq_eval(rho8, r_j))
        want = (
            e1 * v_ra % _P * v_val
            - kinv * e1 % _P * v_rv
            + ap[1] * (e_tau * v_val - e_tk * lt_v % _P * v_inc) % _P
            + ap[2] * e_s % _P * (v_inc - v_wa * v_wv + v_wa * v_val) % _P
            + ap[3] * e4 % _P * v_ra % _P * ((v_ra - 1) % _P)
            + ap[4] * e5 % _P * v_wa % _P * ((v_wa - 1) % _P)
            + ap[5] * e6 % _P * v_ot % _P * ((v_ot - 1) % _P)
            + ap[6] * e7 % _P * ((v_ra + kinv * (v_ot - 1)) % _P)
            + ap[7] * e8 % _P * ((v_wa - kinv * v_ot) % _P)
        ) % _P
        if int(proof.check.final_evaluation) != want:
            return False

        # two batched PST pairing checks back all seven claimed values
        cube_comm = _rlc_commitments(
            [proof.ra_commitment, proof.wa_commitment,
             proof.inc_commitment, proof.val_commitment], g)
        col_comm = _rlc_commitments(
            [proof.ot_commitment, proof.rv_commitment,
             proof.wv_commitment], g)
        return batch_verify_openings([
            (multilinear_verification_key(n), cube_comm, r,
             Fr(_rlc_values(proof.cube_values, g)), proof.cube_proof),
            (multilinear_verification_key(log_t), col_comm, r_j,
             Fr(_rlc_values(proof.col_values, g)), proof.col_proof),
        ])

    @staticmethod
    def to_bytes(proof: TwistSoundProof) -> bytes:
        """The format-v2 encoding of ``proof`` (magic TWSS)."""
        return twist_sound_proof_to_bytes(proof)


def _twist_bind_statement(transcript: Transcript, log_k: int, log_t: int,
                          *commitments: KZGCommitmentValue) -> None:
    transcript.append_field_element(b"tsound_version", Fr(2))
    transcript.append_field_element(b"tsound_log_memory", Fr(log_k))
    transcript.append_field_element(b"tsound_log_ops", Fr(log_t))
    labels = (
        b"tsound_ra_commitment", b"tsound_wa_commitment",
        b"tsound_inc_commitment", b"tsound_val_commitment",
        b"tsound_ot_commitment", b"tsound_rv_commitment",
        b"tsound_wv_commitment",
    )
    for label, c in zip(labels, commitments):
        transcript.append_field_element(label, c.hash())


def _twist_challenges(transcript: Transcript, log_k: int, log_t: int):
    n = log_k + log_t
    rho1 = transcript.challenge_field_elements(b"tsound_rho_read", log_t)
    tau = transcript.challenge_field_elements(b"tsound_tau", n)
    sigma = transcript.challenge_field_elements(b"tsound_sigma", n)
    rho4 = transcript.challenge_field_elements(b"tsound_rho_bool_ra", n)
    rho5 = transcript.challenge_field_elements(b"tsound_rho_bool_wa", n)
    rho6 = transcript.challenge_field_elements(b"tsound_rho_bool_ot", log_t)
    rho7 = transcript.challenge_field_elements(b"tsound_rho_rowsum_ra", log_t)
    rho8 = transcript.challenge_field_elements(b"tsound_rho_rowsum_wa", log_t)
    alpha = transcript.challenge_field_element(b"tsound_alpha")
    return rho1, tau, sigma, rho4, rho5, rho6, rho7, rho8, alpha


def _alpha_powers(alpha: Fr) -> List[int]:
    """[1, alpha, ..., alpha^7]: the batching weights of the eight
    constraint groups."""
    a = int(alpha)
    out = [1]
    for _ in range(7):
        out.append(out[-1] * a % _P)
    return out


def _bind_values_draw_gamma(transcript: Transcript,
                            cube_values: Sequence[Fr],
                            col_values: Sequence[Fr]) -> Fr:
    """Bind the claimed values BEFORE drawing the RLC challenge: otherwise
    a prover could pick values after seeing gamma and satisfy the batched
    pairing check with a forged combination."""
    transcript.append_field_elements(b"tsound_cube_values", list(cube_values))
    transcript.append_field_elements(b"tsound_col_values", list(col_values))
    return transcript.challenge_field_element(b"tsound_gamma")
