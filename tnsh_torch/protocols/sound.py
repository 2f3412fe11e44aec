"""The verifier-enforced (sound) tier: ``ShoutSound`` on a torch device,
and the helpers the bit-column provers share.

Counterpart of ``tnsh/protocols/sound.py``.  The helpers: power-of-two
padding, batched MLE evaluation, the gamma random linear combinations of
tables, values and commitments, and 1/K.

``ShoutSound`` proves a lookup log against a public table with ONE
claim-0 degree-3 sum-check over the (k, j) cube (batching challenge a):

  0 = sum_{k,j}  eq(rho_r,j) ra T~(k) - (1/K) eq(rho_r,j) rv(j)   READ
     + a   [ eq(rho_b,(k,j)) ra (ra-1) ]                           BOOL
     + a^2 [ eq(rho_o,j) ra - (1/K) eq(rho_o,j) ]                  ONE-HOT

and pins ra~(r) and rv~(r_j) with two PST openings.  The prover follows
the JAX package's line for line and picks one of two paths with
identical bytes:

  * sparse (log K + log T >= ``_SPARSE_MIN_VARS``): ra is a
    ``SparseCubeTable``, committed as one T-point MSM over the factorized
    cube SRS and opened j first (``tnsh_torch.commit.mkzg_sparse``); the
    sum-check runs on ``SparseCubeOracle`` (k rounds on the native engine,
    j rounds on the card);
  * dense (fewer variables): the 2^n cube tables on a
    ``TorchSumOfProductsOracle``, ra committed over the 2^n-point PST SRS
    and opened in the same j-first order.

Every MSM runs through the router on ``device``.  ``verify`` and
``to_bytes`` are the port's own code; each package's verifier accepts the
other's bytes.  ``TwistSound`` is not ported yet.  Unlike the JAX
package's prover this one does not pause the process-wide garbage
collector.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from .. import _native
from ..commit import msm_sched
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
    SparseCubeTable,
    commit_sparse,
    cube_params,
    open_dense_cube,
    open_sparse,
    prepare_device,
    sparse_mle_eval,
)
from ..core.params import ProverParams, VerifierParams
from ..core.proof_io import MAX_LOG_SIZE, shout_sound_proof_to_bytes
from ..core.transcript import Transcript
from ..errors import InvalidParametersError
from ..field.fr import MODULUS, Fr, FrTable
from ..field.g1 import G1
from ..iop.sparse_oracle import SparseCubeOracle
from ..iop.sumcheck import SumCheck, SumCheckProof, TorchSumOfProductsOracle
from ..poly.eq import eq_eval, eq_table, mle_eval
from ..utils.profiling import PhaseTimer
from .shout import LookupTable

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
        ``open`` (``open/plan`` ...): ``k_rounds``, ``j_build`` and
        ``j_rounds`` on the sparse path, ``cube_build`` and
        ``cube_rounds`` on the dense one."""
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
        with timer.phase("commit"), msm_sched.stage_split(timer, "commit"):
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

        with timer.phase("open"), msm_sched.stage_split(timer, "open"):
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
        on ``SparseCubeOracle``, whose k rounds need the native engine:
        without it the prover refuses before it builds the cube SRS."""
        if not _native.available:
            raise RuntimeError(
                "the sparse sound prover's k phase runs on the native "
                "engine, which TNSH_NO_NATIVE switches off")
        if has_external_multilinear_srs(log_k + log_t):
            raise InvalidParametersError(
                "sparse sound proving needs the deterministic factorized "
                "SRS (tau_k); an external ceremony SRS is installed for "
                "this variable count — use the dense prover (sparse=False)"
            )
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
        with timer.phase("commit"), msm_sched.stage_split(timer, "commit"):
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
            with timer.phase("k_rounds"):
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

        with timer.phase("open"), msm_sched.stage_split(timer, "open"):
            v_ra = sparse_mle_eval(ra, r)
            v_rv = mle_eval(rv, r[log_k:])
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
