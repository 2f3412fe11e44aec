"""Shout, the read-only lookup protocol, and its lookup log
(``LookupOp``, ``LookupTable``).

Counterpart of ``tnsh/protocols/shout.py``.  A ``LookupTable`` holds a
read-only table and records every lookup made against it; ``Shout`` here,
``ShoutBits`` and ``ShoutBitsCommitted``
(``tnsh_torch.protocols.twist_bits``) and ``ShoutSound``
(``tnsh_torch.protocols.sound``) prove that log.

``Shout`` runs Twist's pipeline (``prove_column_pair`` /
``verify_column_pair`` of ``tnsh_torch.protocols.twist``) with (table,
indices) in place of (addresses, values) and the transcript labels ``table_commitment`` /
``index_commitment``.  The table pads to the next power of two of its
length, the indices to that of the lookup count (at least 1), and the
sum-check runs over log2 of the padded lookups.  The reference's
lookup-correctness closure is identically zero, so the default oracle is
``ZeroOracle`` (the same round polynomials); ``sound_mode=True`` proves
the honest err vector instead (a tnsh extension that changes the proof),
on ``device``.  The commitments and openings run their MSMs on ``device``
from ``DEVICE_MSM_MIN`` points up, over the Lagrange SRS.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..commit.kzg import KZGCommitmentValue, KZGProof
from ..core.params import ProverParams, VerifierParams, _next_power_of_two
from ..errors import InvalidParametersError
from ..field.fr import Fr
from ..iop.sumcheck import SumCheckProof, TorchProductMLEOracle, ZeroOracle
from ..poly.interp import interpolate_on_range
from ..poly.mle_host import MultilinearExtension
from ..utils.profiling import PhaseTimer
from .twist import prove_column_pair, verify_column_pair


@dataclass(frozen=True)
class LookupOp:
    """A single lookup: index + value observed (reference shout.rs:16-22)."""

    index: int
    value: Fr


class LookupTable:
    """Read-only table with a lookup log (reference shout.rs:24-60)."""

    def __init__(self, entries: List[Fr]):
        self.entries = [Fr(e) for e in entries]
        self.lookups: List[LookupOp] = []

    def lookup(self, index: int) -> Fr:
        if index >= len(self.entries):
            raise InvalidParametersError("Lookup index out of bounds")
        value = self.entries[index]
        self.lookups.append(LookupOp(index, value))
        return value

    def size(self) -> int:
        return len(self.entries)


@dataclass
class ShoutProof:
    """Shout proof (reference shout.rs:62-79)."""

    table_commitment: KZGCommitmentValue
    index_commitment: KZGCommitmentValue
    lookup_proof: SumCheckProof
    opening_proofs: List[KZGProof]
    final_evaluations: List[Fr]


class Shout:
    """Shout prover and verifier; the prover's MSMs and sound-mode rounds
    run on ``device``."""

    LABELS = (b"table_commitment", b"index_commitment")

    def __init__(self, prover_params: ProverParams, device):
        self.prover_params = prover_params
        self.device = device

    def prove(self, table: LookupTable, sound_mode: bool = False,
              timer: Optional[PhaseTimer] = None) -> ShoutProof:
        """Prove ``table``'s lookup log.  ``timer`` (optional) receives the
        stages ``columns``, ``commit`` (with its MSM stages as
        ``commit/plan`` ...), ``oracle``, ``rounds`` and ``open``
        (``open/plan`` ...)."""
        timer = PhaseTimer() if timer is None else timer
        if len(table.lookups) > self.prover_params.max_operations:
            raise InvalidParametersError("Too many lookup operations")

        with timer.phase("columns"):
            table_size = _next_power_of_two(len(table.entries))
            padded_table = list(table.entries) + [Fr(0)] * (
                table_size - len(table.entries))

            indices = [Fr(lk.index) for lk in table.lookups]
            lookups_size = max(_next_power_of_two(len(indices)), 1)
            padded_indices = indices + [Fr(0)] * (lookups_size
                                                  - len(indices))

        log_lookups = lookups_size.bit_length() - 1

        def make_oracle():
            if not sound_mode:
                return ZeroOracle(log_lookups)
            return self._sound_lookup_oracle(
                log_lookups, padded_table, table.lookups, device=self.device)

        (table_commitment, index_commitment), lookup_proof, \
            opening_proofs, final_evaluations = prove_column_pair(
                self.prover_params, self.device, self.LABELS,
                (padded_table, padded_indices), log_lookups, make_oracle,
                timer)
        return ShoutProof(
            table_commitment=table_commitment,
            index_commitment=index_commitment,
            lookup_proof=lookup_proof,
            opening_proofs=opening_proofs,
            final_evaluations=final_evaluations,
        )

    def verify(self, proof: ShoutProof, verifier_params: VerifierParams,
               strict: bool = False, fast: bool = False) -> bool:
        """Verify a proof (``verify_column_pair``; ``strict=True``
        requires both openings whenever there are lookups)."""
        return verify_column_pair(
            verifier_params, self.LABELS,
            [proof.table_commitment, proof.index_commitment],
            proof.lookup_proof, proof.opening_proofs,
            proof.final_evaluations, strict, fast)

    def vector_to_polynomial(self, vector: List[Fr]) -> List[Fr]:
        """Interpolation over {0..n-1} (reference shout.rs:277-286)."""
        return interpolate_on_range([Fr(v) for v in vector])

    # -- sound mode (tnsh extension) --------------------------------------
    @staticmethod
    def _sound_lookup_oracle(log_lookups: int, padded_table: List[Fr],
                             lookups: List[LookupOp], *,
                             device) -> TorchProductMLEOracle:
        """Honest constraint err(i) = claimed_value(i) - table[index(i)],
        zero for correct lookups, so sum err = 0; its rounds run on the
        product-round and fold kernels on ``device``."""
        size = 1 << log_lookups
        err: List[Fr] = []
        for i in range(size):
            if i < len(lookups):
                lk = lookups[i]
                err.append(lk.value - padded_table[lk.index])
            else:
                err.append(Fr(0))
        mle = MultilinearExtension.from_evaluations_vec(log_lookups, err)
        return TorchProductMLEOracle([mle], device=device)
