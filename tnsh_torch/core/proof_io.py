"""Proof and parameter serialization.

Counterpart of ``tnsh/core/proof_io.py``: the parity Twist and Shout
proofs (magic ``TWST`` and ``SHOT``, version 1: two commitments, the
sum-check, the opening proofs and the final evaluations), the TwistBits
proof (magic ``TWBT``, version 3), the
ShoutBits proofs against a public table (``SHBT``) and against a committed
one (``SHBC``), the generic-degree sum-check proof inside them, the
verifier-enforced ShoutSound and TwistSound proofs (``SHSS`` and ``TWSS``,
version 2) with their degree-3 sum-check proof and PST openings, and the
verifier parameters.  Built from ark-compatible primitives: Fr as 32-byte
LE, G1 compressed as 32 bytes with ark flag bits
(tnsh_torch.core.serialize); all lengths little-endian u64.
The bytes are the same as the JAX package writes for the same proof.
"""

from __future__ import annotations

import struct
from typing import List

from ..commit.kzg import KZGCommitmentValue, KZGProof
from ..errors import InvalidParametersError
from ..field.fr import Fr
from .params import CommitmentVerificationKey, VerifierParams
from .serialize import (
    fr_from_bytes,
    g1_from_bytes,
    g1_to_bytes,
    g2_from_bytes,
    g2_to_bytes,
    read_fr_vec,
    write_fr_vec,
)

_VERSION = 1
_BITS_VERSION = 3


def _ml_proof_to_bytes(proof) -> bytes:
    out = [struct.pack("<Q", len(proof.quotients))]
    for q in proof.quotients:
        out.append(g1_to_bytes(q, compress=True))
    return b"".join(out)


def _ml_proof_from_bytes(data: bytes, offset: int):
    from ..commit.mkzg import MLOpeningProof

    (n,) = struct.unpack_from("<Q", data, offset)
    offset += 8
    qs = []
    for _ in range(n):
        qs.append(g1_from_bytes(data[offset:offset + 32]))
        offset += 32
    return MLOpeningProof(qs), offset



MAX_LOG_SIZE = 48


def _check_log_fields(**fields) -> None:
    for name, v in fields.items():
        if v > MAX_LOG_SIZE:
            raise InvalidParametersError(
                f"{name}={v} exceeds the supported bound {MAX_LOG_SIZE}"
            )


def sumcheck_d_proof_to_bytes(proof) -> bytes:
    out = [struct.pack("<QQ", proof.degree, len(proof.round_polynomials))]
    for rp in proof.round_polynomials:
        out.append(write_fr_vec(rp))
    out.append(proof.final_evaluation.to_bytes_le())
    return b"".join(out)


def sumcheck_d_proof_from_bytes(data: bytes, offset: int = 0):
    from ..iop.sumcheck_d import SumCheckDProof

    degree, n = struct.unpack_from("<QQ", data, offset)
    offset += 16
    if degree > 4096 or n > 4096:
        raise InvalidParametersError("sum-check proof dimensions too large")
    rounds: List[List[Fr]] = []
    for _ in range(n):
        rp, offset = read_fr_vec(data, offset)
        rounds.append(rp)
    final = fr_from_bytes(data[offset:offset + 32])
    offset += 32
    return SumCheckDProof(degree, rounds, final), offset


def _check_bits_header(magic: bytes, data: bytes) -> None:
    if data[:4] != magic:
        raise InvalidParametersError(f"bad proof magic (want {magic!r})")
    (ver,) = struct.unpack_from("<I", data, 4)
    if ver != _BITS_VERSION:
        raise InvalidParametersError(f"unsupported proof version {ver}")


def _write_comms(comms) -> bytes:
    out = [struct.pack("<Q", len(comms))]
    for c in comms:
        out.append(g1_to_bytes(c.commitment, compress=True))
    return b"".join(out)


def _read_comms(data: bytes, offset: int):
    (n,) = struct.unpack_from("<Q", data, offset)
    offset += 8
    if offset + 32 * n > len(data):
        raise InvalidParametersError("commitment count exceeds payload")
    comms = []
    for _ in range(n):
        comms.append(KZGCommitmentValue(g1_from_bytes(data[offset:offset + 32])))
        offset += 32
    return comms, offset


def twist_bits_proof_to_bytes(proof) -> bytes:
    out = [b"TWBT", struct.pack("<I", _BITS_VERSION)]
    out.append(struct.pack("<QQ", proof.log_memory, proof.log_ops))
    out.append(_write_comms(proof.column_commitments))
    out.append(sumcheck_d_proof_to_bytes(proof.check_a))
    out.append(proof.v_val.to_bytes_le())
    out.append(sumcheck_d_proof_to_bytes(proof.check_b))
    out.append(write_fr_vec(proof.values_rj))
    out.append(write_fr_vec(proof.values_s))
    out.append(_ml_proof_to_bytes(proof.proof_rj))
    out.append(_ml_proof_to_bytes(proof.proof_s))
    return b"".join(out)


def twist_bits_proof_from_bytes(data: bytes):
    from ..protocols.twist_bits import TwistBitsProof

    _check_bits_header(b"TWBT", data)
    offset = 8
    log_memory, log_ops = struct.unpack_from("<QQ", data, offset)
    offset += 16
    _check_log_fields(log_memory=log_memory, log_ops=log_ops)
    comms, offset = _read_comms(data, offset)
    check_a, offset = sumcheck_d_proof_from_bytes(data, offset)
    v_val = fr_from_bytes(data[offset:offset + 32])
    offset += 32
    check_b, offset = sumcheck_d_proof_from_bytes(data, offset)
    values_rj, offset = read_fr_vec(data, offset)
    values_s, offset = read_fr_vec(data, offset)
    proof_rj, offset = _ml_proof_from_bytes(data, offset)
    proof_s, offset = _ml_proof_from_bytes(data, offset)
    return TwistBitsProof(
        log_memory=log_memory,
        log_ops=log_ops,
        column_commitments=comms,
        check_a=check_a,
        v_val=v_val,
        check_b=check_b,
        values_rj=values_rj,
        values_s=values_s,
        proof_rj=proof_rj,
        proof_s=proof_s,
    )


def shout_bits_proof_to_bytes(proof) -> bytes:
    out = [b"SHBT", struct.pack("<I", _BITS_VERSION)]
    out.append(struct.pack("<QQ", proof.log_table, proof.log_lookups))
    out.append(_write_comms(proof.column_commitments))
    out.append(sumcheck_d_proof_to_bytes(proof.check))
    out.append(write_fr_vec(proof.values_rj))
    out.append(_ml_proof_to_bytes(proof.proof_rj))
    return b"".join(out)


def shout_bits_proof_from_bytes(data: bytes):
    from ..protocols.twist_bits import ShoutBitsProof

    _check_bits_header(b"SHBT", data)
    offset = 8
    log_table, log_lookups = struct.unpack_from("<QQ", data, offset)
    offset += 16
    _check_log_fields(log_table=log_table, log_lookups=log_lookups)
    comms, offset = _read_comms(data, offset)
    check, offset = sumcheck_d_proof_from_bytes(data, offset)
    values_rj, offset = read_fr_vec(data, offset)
    proof_rj, offset = _ml_proof_from_bytes(data, offset)
    return ShoutBitsProof(
        log_table=log_table,
        log_lookups=log_lookups,
        column_commitments=comms,
        check=check,
        values_rj=values_rj,
        proof_rj=proof_rj,
    )


def shout_bits_comm_proof_to_bytes(proof) -> bytes:
    """Committed-table Shout (magic SHBC): like SHBT plus the opened
    table value and its PST opening; the table commitment itself is the
    verifier's input and is not part of the proof."""
    out = [b"SHBC", struct.pack("<I", _BITS_VERSION)]
    out.append(struct.pack("<QQ", proof.log_table, proof.log_lookups))
    out.append(_write_comms(proof.column_commitments))
    out.append(sumcheck_d_proof_to_bytes(proof.check))
    out.append(write_fr_vec(proof.values_rj))
    out.append(proof.t_value.to_bytes_le())
    out.append(_ml_proof_to_bytes(proof.proof_rj))
    out.append(_ml_proof_to_bytes(proof.proof_t))
    return b"".join(out)


def shout_bits_comm_proof_from_bytes(data: bytes):
    from ..protocols.twist_bits import ShoutBitsCommProof

    _check_bits_header(b"SHBC", data)
    offset = 8
    log_table, log_lookups = struct.unpack_from("<QQ", data, offset)
    offset += 16
    _check_log_fields(log_table=log_table, log_lookups=log_lookups)
    comms, offset = _read_comms(data, offset)
    check, offset = sumcheck_d_proof_from_bytes(data, offset)
    values_rj, offset = read_fr_vec(data, offset)
    t_value = fr_from_bytes(data[offset:offset + 32])
    offset += 32
    proof_rj, offset = _ml_proof_from_bytes(data, offset)
    proof_t, offset = _ml_proof_from_bytes(data, offset)
    return ShoutBitsCommProof(
        log_table=log_table,
        log_lookups=log_lookups,
        column_commitments=comms,
        check=check,
        values_rj=values_rj,
        t_value=t_value,
        proof_rj=proof_rj,
        proof_t=proof_t,
    )


# -- verifier-enforced sound proofs (format version 2) ------------------------
#
#   SumCheckProof:   n_rounds u64 | rounds (fr_vec each) | final_evaluation
#   MLOpening:       value 32B | n_quotients u64 | quotients (G1c each)
#   MLProof:         n_quotients u64 | quotients (G1c each)
#   TwistSoundProof: magic 'TWSS' ver=2 u32 | log_memory u64 | log_ops u64 |
#                    7 x G1c commitments | sumcheck | fr_vec cube_values |
#                    fr_vec col_values | MLProof cube | MLProof col
#   ShoutSoundProof: magic 'SHSS' ver=2 u32 | log_table u64 | log_lookups
#                    u64 | 2 x G1c | sumcheck | MLOpening ra | MLOpening rv

_SOUND_VERSION = 2


def sumcheck_proof_to_bytes(proof) -> bytes:
    out = [struct.pack("<Q", len(proof.round_polynomials))]
    for rp in proof.round_polynomials:
        out.append(write_fr_vec(rp))
    out.append(proof.final_evaluation.to_bytes_le())
    return b"".join(out)


def sumcheck_proof_from_bytes(data: bytes, offset: int = 0):
    from ..iop.sumcheck import SumCheckProof

    (n,) = struct.unpack_from("<Q", data, offset)
    offset += 8
    rounds: List[List[Fr]] = []
    for _ in range(n):
        rp, offset = read_fr_vec(data, offset)
        rounds.append(rp)
    final = fr_from_bytes(data[offset:offset + 32])
    offset += 32
    return SumCheckProof(rounds, final), offset


def _ml_opening_to_bytes(opening) -> bytes:
    return opening.value.to_bytes_le() + _ml_proof_to_bytes(opening.proof)


def _ml_opening_from_bytes(data: bytes, offset: int):
    from ..protocols.sound import MLOpening

    value = fr_from_bytes(data[offset:offset + 32])
    offset += 32
    proof, offset = _ml_proof_from_bytes(data, offset)
    return MLOpening(value, proof), offset


def _check_sound_header(magic: bytes, data: bytes) -> None:
    if data[:4] != magic:
        raise InvalidParametersError(f"bad proof magic (want {magic!r})")
    (ver,) = struct.unpack_from("<I", data, 4)
    if ver != _SOUND_VERSION:
        raise InvalidParametersError(f"unsupported proof version {ver}")


_TWIST_SOUND_COMMITMENTS = (
    "ra_commitment", "wa_commitment", "inc_commitment", "val_commitment",
    "ot_commitment", "rv_commitment", "wv_commitment",
)


def twist_sound_proof_to_bytes(proof) -> bytes:
    out = [b"TWSS", struct.pack("<I", _SOUND_VERSION)]
    out.append(struct.pack("<QQ", proof.log_memory, proof.log_ops))
    for name in _TWIST_SOUND_COMMITMENTS:
        out.append(g1_to_bytes(getattr(proof, name).commitment, compress=True))
    out.append(sumcheck_proof_to_bytes(proof.check))
    out.append(write_fr_vec(proof.cube_values))
    out.append(write_fr_vec(proof.col_values))
    out.append(_ml_proof_to_bytes(proof.cube_proof))
    out.append(_ml_proof_to_bytes(proof.col_proof))
    return b"".join(out)


def twist_sound_proof_from_bytes(data: bytes):
    from ..protocols.sound import TwistSoundProof

    _check_sound_header(b"TWSS", data)
    offset = 8
    log_memory, log_ops = struct.unpack_from("<QQ", data, offset)
    offset += 16
    _check_log_fields(log_memory=log_memory, log_ops=log_ops)
    kwargs = {"log_memory": log_memory, "log_ops": log_ops}
    for name in _TWIST_SOUND_COMMITMENTS:
        kwargs[name] = KZGCommitmentValue(
            g1_from_bytes(data[offset:offset + 32]))
        offset += 32
    kwargs["check"], offset = sumcheck_proof_from_bytes(data, offset)
    kwargs["cube_values"], offset = read_fr_vec(data, offset)
    kwargs["col_values"], offset = read_fr_vec(data, offset)
    kwargs["cube_proof"], offset = _ml_proof_from_bytes(data, offset)
    kwargs["col_proof"], offset = _ml_proof_from_bytes(data, offset)
    return TwistSoundProof(**kwargs)


def shout_sound_proof_to_bytes(proof) -> bytes:
    out = [b"SHSS", struct.pack("<I", _SOUND_VERSION)]
    out.append(struct.pack("<QQ", proof.log_table, proof.log_lookups))
    out.append(g1_to_bytes(proof.ra_commitment.commitment, compress=True))
    out.append(g1_to_bytes(proof.rv_commitment.commitment, compress=True))
    out.append(sumcheck_proof_to_bytes(proof.check))
    out.append(_ml_opening_to_bytes(proof.ra_at_r))
    out.append(_ml_opening_to_bytes(proof.rv_at_r))
    return b"".join(out)


def shout_sound_proof_from_bytes(data: bytes):
    from ..protocols.sound import ShoutSoundProof

    _check_sound_header(b"SHSS", data)
    offset = 8
    log_table, log_lookups = struct.unpack_from("<QQ", data, offset)
    offset += 16
    _check_log_fields(log_table=log_table, log_lookups=log_lookups)
    c_ra = KZGCommitmentValue(g1_from_bytes(data[offset:offset + 32]))
    offset += 32
    c_rv = KZGCommitmentValue(g1_from_bytes(data[offset:offset + 32]))
    offset += 32
    check, offset = sumcheck_proof_from_bytes(data, offset)
    ra_at_r, offset = _ml_opening_from_bytes(data, offset)
    rv_at_r, offset = _ml_opening_from_bytes(data, offset)
    return ShoutSoundProof(
        log_table=log_table,
        log_lookups=log_lookups,
        ra_commitment=c_ra,
        rv_commitment=c_rv,
        check=check,
        ra_at_r=ra_at_r,
        rv_at_r=rv_at_r,
    )


# -- parity Twist and Shout proofs (format version 1) ----------------------
#
#   TwistProof: magic 'TWST' ver u32 | 2 x G1c | sumcheck | proofs_vec |
#               evals_vec
#   ShoutProof: magic 'SHOT' ver u32 | the same shape

def _write_proof(magic: bytes, c1, c2, sc, openings, evals) -> bytes:
    out = [magic, struct.pack("<I", _VERSION)]
    out.append(g1_to_bytes(c1.commitment, compress=True))
    out.append(g1_to_bytes(c2.commitment, compress=True))
    out.append(sumcheck_proof_to_bytes(sc))
    out.append(struct.pack("<Q", len(openings)))
    for pi in openings:
        out.append(g1_to_bytes(pi.proof, compress=True))
    out.append(write_fr_vec(evals))
    return b"".join(out)


def _read_proof(magic: bytes, data: bytes):
    if data[:4] != magic:
        raise InvalidParametersError(f"bad proof magic (want {magic!r})")
    (ver,) = struct.unpack_from("<I", data, 4)
    if ver != _VERSION:
        raise InvalidParametersError(f"unsupported proof version {ver}")
    offset = 8
    c1 = KZGCommitmentValue(g1_from_bytes(data[offset:offset + 32]))
    offset += 32
    c2 = KZGCommitmentValue(g1_from_bytes(data[offset:offset + 32]))
    offset += 32
    sc, offset = sumcheck_proof_from_bytes(data, offset)
    (n_open,) = struct.unpack_from("<Q", data, offset)
    offset += 8
    openings = []
    for _ in range(n_open):
        openings.append(KZGProof(g1_from_bytes(data[offset:offset + 32])))
        offset += 32
    evals, offset = read_fr_vec(data, offset)
    return c1, c2, sc, openings, evals, offset


def twist_proof_to_bytes(proof) -> bytes:
    return _write_proof(b"TWST", proof.address_commitment,
                        proof.value_commitment, proof.consistency_proof,
                        proof.opening_proofs, proof.final_evaluations)


def twist_proof_from_bytes(data: bytes):
    from ..protocols.twist import TwistProof

    c1, c2, sc, openings, evals, _ = _read_proof(b"TWST", data)
    return TwistProof(c1, c2, sc, openings, evals)


def shout_proof_to_bytes(proof) -> bytes:
    return _write_proof(b"SHOT", proof.table_commitment,
                        proof.index_commitment, proof.lookup_proof,
                        proof.opening_proofs, proof.final_evaluations)


def shout_proof_from_bytes(data: bytes):
    from ..protocols.shout import ShoutProof

    c1, c2, sc, openings, evals, _ = _read_proof(b"SHOT", data)
    return ShoutProof(c1, c2, sc, openings, evals)


# -- verifier params --------------------------------------------------------

def verifier_params_to_bytes(vp: VerifierParams) -> bytes:
    out = [b"TNVK", struct.pack("<I", _VERSION)]
    out.append(struct.pack("<QQ", vp.log_size, vp.max_operations))
    out.append(vp.fiat_shamir_seed)
    out.append(g1_to_bytes(vp.commitment_vk.g1_generator, compress=True))
    out.append(g2_to_bytes(vp.commitment_vk.g2_generator, compress=True))
    out.append(g2_to_bytes(vp.commitment_vk.g2_tau, compress=True))
    return b"".join(out)


def verifier_params_from_bytes(data: bytes) -> VerifierParams:
    if data[:4] != b"TNVK":
        raise InvalidParametersError("bad verifier-params magic")
    (ver,) = struct.unpack_from("<I", data, 4)
    if ver != _VERSION:
        raise InvalidParametersError(f"unsupported params version {ver}")
    log_size, max_ops = struct.unpack_from("<QQ", data, 8)
    offset = 24
    seed = data[offset:offset + 32]
    offset += 32
    g1_gen = g1_from_bytes(data[offset:offset + 32])
    offset += 32
    g2_gen = g2_from_bytes(data[offset:offset + 64])
    offset += 64
    g2_tau = g2_from_bytes(data[offset:offset + 64])
    return VerifierParams(
        log_size=log_size,
        max_operations=max_ops,
        commitment_vk=CommitmentVerificationKey(
            g1_generator=g1_gen, g2_generator=g2_gen, g2_tau=g2_tau
        ),
        fiat_shamir_seed=seed,
    )
