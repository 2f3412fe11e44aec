"""Twist, the read-write memory-checking protocol, and the memory trace
that every Twist prover takes (``MemoryOp``, ``MemoryTrace``).

Counterpart of ``tnsh/protocols/twist.py``, with the same pipeline,
transcript labels, padding and proof shape, so the bytes are the same:

  prove:
    1. op-count guard against ``max_operations``
    2. address / value / op-type columns, padded to the next power of two
       (no operations pad to size 1)
    3. evaluation-basis KZG commitments to the address and value columns
       (``KZGCommitment.commit_evals``: one MSM each over the Lagrange SRS,
       on ``device`` from ``DEVICE_MSM_MIN`` points up)
    4. transcript <- "address_commitment" / "value_commitment" hashes
    5. sum-check over log2(padded) variables, claimed sum 0.  The
       reference's consistency closure is identically zero, so the default
       oracle is ``ZeroOracle`` (the same round polynomials); with
       ``sound_mode=True`` the oracle is an honest err-vector constraint
       (value consistency and the big-endian ``LessThanPolynomial``
       ordering), a tnsh extension that changes the proof, whose rounds run
       on ``device`` (``TorchProductMLEOracle``: a product-round and a fold
       launch a round)
    6. opening challenges (``opening_challenges``), and both columns opened
       at challenges[0] with ``KZGCommitment.open_evals`` (one MSM each over
       the Lagrange SRS)

Steps 3 to 6 are ``prove_column_pair``, which ``Shout`` runs too; the
verifier, ``verify_column_pair``, is host work, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional

from ..commit import msm_sched
from ..commit.kzg import (
    KZGCommitment,
    KZGCommitmentValue,
    KZGProof,
    verify_openings_batched,
)
from ..core.params import ProverParams, VerifierParams, _next_power_of_two
from ..core.transcript import Transcript
from ..errors import InvalidParametersError
from ..field.fr import Fr
from ..iop.sumcheck import (
    SumCheck,
    SumCheckProof,
    TorchProductMLEOracle,
    ZeroOracle,
)
from ..poly.interp import interpolate_on_range
from ..poly.lt import LessThanPolynomial
from ..poly.mle_host import MultilinearExtension
from ..utils.profiling import PhaseTimer


class MemoryOpKind(Enum):
    READ = 0
    WRITE = 1


@dataclass(frozen=True)
class MemoryOp:
    """A single read or write (reference twist.rs:16-20)."""

    kind: MemoryOpKind
    address: int
    value: Fr

    @staticmethod
    def read(address: int, value: Fr) -> "MemoryOp":
        return MemoryOp(MemoryOpKind.READ, address, value)

    @staticmethod
    def write(address: int, value: Fr) -> "MemoryOp":
        return MemoryOp(MemoryOpKind.WRITE, address, value)

    @property
    def is_write(self) -> bool:
        return self.kind is MemoryOpKind.WRITE

    @property
    def is_read(self) -> bool:
        return self.kind is MemoryOpKind.READ


class MemoryTrace:
    """Power-of-two-sized memory with an operation log
    (reference twist.rs:23-72)."""

    def __init__(self, memory_size: int):
        if memory_size <= 0 or memory_size & (memory_size - 1):
            raise AssertionError("Memory size must be power of 2")
        self.memory_size = memory_size
        self.operations: List[MemoryOp] = []
        self._memory: List[Fr] = [Fr(0)] * memory_size

    def write(self, address: int, value: Fr) -> None:
        if address >= self.memory_size:
            raise InvalidParametersError("Address out of bounds")
        value = Fr(value)
        self._memory[address] = value
        self.operations.append(MemoryOp.write(address, value))

    def read(self, address: int) -> Fr:
        if address >= self.memory_size:
            raise InvalidParametersError("Address out of bounds")
        value = self._memory[address]
        self.operations.append(MemoryOp.read(address, value))
        return value


@dataclass
class TwistProof:
    """Twist proof (reference twist.rs:74-89)."""

    address_commitment: KZGCommitmentValue
    value_commitment: KZGCommitmentValue
    consistency_proof: SumCheckProof
    opening_proofs: List[KZGProof]
    final_evaluations: List[Fr]


def prove_column_pair(prover_params: ProverParams, device, labels,
                      columns, log_n: int, make_oracle,
                      timer: PhaseTimer):
    """The pipeline ``Twist`` and ``Shout`` share: both columns committed
    in the evaluation basis, their hashes appended under ``labels``, the
    sum-check over ``log_n`` variables with claimed sum 0 on
    ``make_oracle()``, and both columns opened at the first opening
    challenge.  Returns (commitments, sum-check proof, opening proofs,
    final evaluations); no openings when ``log_n`` is 0."""
    cp = prover_params.commitment_params
    with timer.phase("commit"), msm_sched.stage_split(timer, "commit"):
        commitments = [KZGCommitment.commit_evals(cp, col, device)
                       for col in columns]

    transcript = Transcript(prover_params.fiat_shamir_seed)
    for label, comm in zip(labels, commitments):
        transcript.append_field_element(label, comm.hash())

    with timer.phase("oracle"):
        oracle = make_oracle()
    with timer.phase("rounds"):
        sumcheck_proof = SumCheck(log_n, Fr(0)).prove(oracle, transcript)

    challenges = transcript.challenge_field_elements(
        b"opening_challenges", log_n)

    opening_proofs: List[KZGProof] = []
    final_evaluations: List[Fr] = []
    if challenges:
        with timer.phase("open"), msm_sched.stage_split(timer, "open"):
            for col in columns:
                value, opening = KZGCommitment.open_evals(
                    cp, col, challenges[0], device)
                final_evaluations.append(value)
                opening_proofs.append(opening)
    return commitments, sumcheck_proof, opening_proofs, final_evaluations


def verify_column_pair(verifier_params: VerifierParams, labels,
                       commitments, sumcheck_proof: SumCheckProof,
                       opening_proofs: List[KZGProof],
                       final_evaluations: List[Fr], strict: bool,
                       fast: bool) -> bool:
    """The verifier of ``prove_column_pair``'s proof.  ``strict=False``
    keeps the reference's lenient shape handling (openings optional, round
    count taken from the proof); ``strict=True`` also requires both
    opening proofs and evaluations whenever there is a round.
    ``fast=True`` checks both openings with one batched pairing product
    (``verify_openings_batched``).  Both are tnsh extensions; the accepted
    proofs are the same set up to the RLC soundness error."""
    transcript = Transcript(verifier_params.fiat_shamir_seed)
    for label, comm in zip(labels, commitments):
        transcript.append_field_element(label, comm.hash())

    num_vars = len(sumcheck_proof.round_polynomials)
    if strict and num_vars > 0 and (
        len(opening_proofs) < 2 or len(final_evaluations) < 2
    ):
        return False
    sumcheck_valid, _ = SumCheck(num_vars, Fr(0)).verify(sumcheck_proof,
                                                         transcript)
    if not sumcheck_valid:
        return False

    opening_challenges = transcript.challenge_field_elements(
        b"opening_challenges", num_vars)

    if (opening_challenges and len(opening_proofs) >= 2
            and len(final_evaluations) >= 2):
        vk = verifier_params.commitment_vk
        if fast:
            return verify_openings_batched(
                vk, commitments, opening_challenges[0],
                final_evaluations[:2], opening_proofs[:2])
        for comm, value, opening in zip(commitments, final_evaluations,
                                        opening_proofs):
            if not KZGCommitment.verify(vk, comm, opening_challenges[0],
                                        value, opening):
                return False
    return True


class Twist:
    """Twist prover and verifier; the prover's MSMs and sound-mode rounds
    run on ``device``."""

    LABELS = (b"address_commitment", b"value_commitment")

    def __init__(self, prover_params: ProverParams, device):
        self.prover_params = prover_params
        self.device = device

    def prove(self, trace: MemoryTrace, sound_mode: bool = False,
              timer: Optional[PhaseTimer] = None) -> TwistProof:
        """Prove ``trace``.  ``timer`` (optional) receives the stages
        ``columns``, ``commit`` (with its MSM stages as ``commit/plan``
        ...), ``oracle``, ``rounds`` and ``open`` (``open/plan`` ...)."""
        timer = PhaseTimer() if timer is None else timer
        if len(trace.operations) > self.prover_params.max_operations:
            raise InvalidParametersError("Too many operations")

        with timer.phase("columns"):
            addresses = [Fr(op.address) for op in trace.operations]
            values = [Fr(op.value) for op in trace.operations]
            op_types = [Fr(1) if op.is_write else Fr(0)
                        for op in trace.operations]

            padded_size = max(_next_power_of_two(len(addresses)), 1)
            addresses = addresses + [Fr(0)] * (padded_size - len(addresses))
            values = values + [Fr(0)] * (padded_size - len(values))
            op_types = op_types + [Fr(0)] * (padded_size - len(op_types))

        log_ops = padded_size.bit_length() - 1

        def make_oracle():
            if not sound_mode:
                return ZeroOracle(log_ops)
            return self._sound_consistency_oracle(
                log_ops, addresses, values, op_types,
                num_real_ops=len(trace.operations), device=self.device)

        (address_commitment, value_commitment), consistency_proof, \
            opening_proofs, final_evaluations = prove_column_pair(
                self.prover_params, self.device, self.LABELS,
                (addresses, values), log_ops, make_oracle, timer)
        return TwistProof(
            address_commitment=address_commitment,
            value_commitment=value_commitment,
            consistency_proof=consistency_proof,
            opening_proofs=opening_proofs,
            final_evaluations=final_evaluations,
        )

    def verify(self, proof: TwistProof, verifier_params: VerifierParams,
               strict: bool = False, fast: bool = False) -> bool:
        """Verify a proof (``verify_column_pair``)."""
        return verify_column_pair(
            verifier_params, self.LABELS,
            [proof.address_commitment, proof.value_commitment],
            proof.consistency_proof, proof.opening_proofs,
            proof.final_evaluations, strict, fast)

    def vector_to_polynomial(self, vector: List[Fr]) -> List[Fr]:
        """Interpolation over {0..n-1} (reference twist.rs:307-316)."""
        return interpolate_on_range([Fr(v) for v in vector])

    # -- sound mode (tnsh extension) --------------------------------------
    @staticmethod
    def _sound_consistency_oracle(
        log_ops: int,
        addresses: List[Fr],
        values: List[Fr],
        op_types: List[Fr],
        num_real_ops: Optional[int] = None,
        *,
        device,
    ) -> TorchProductMLEOracle:
        """A consistency constraint with zero hypercube sum, on ``device``.

        Two per-op error terms, both zero on honest traces:

          * value consistency: for a read i of address a whose last write
            is j, err_val(i) = value(i) - value(j) (reads of unwritten cells
            expect 0);
          * write ordering: err_ord(i) = 1 - lt(j, i), with lt the
            ``LessThanPolynomial`` over big-endian bit strings, whose
            lexicographic order is then the numeric j < i.

        Padding rows are not memory operations and score 0.  The oracle is
        the MLE of err_val + err_ord; its rounds run on the product-round
        and fold kernels."""
        size = 1 << log_ops
        lt = LessThanPolynomial(max(log_ops, 1))

        def bits_be(x: int) -> List[bool]:
            le = [bool((x >> b) & 1) for b in range(max(log_ops, 1))]
            return le[::-1]

        if num_real_ops is None:
            num_real_ops = size
        mem: dict = {}  # addr -> (last value, last write index)
        err: List[Fr] = []
        for i in range(size):
            if i >= num_real_ops:
                err.append(Fr(0))
                continue
            addr = int(addresses[i])
            if int(op_types[i]) == 1:
                mem[addr] = (values[i], i)
                err.append(Fr(0))
            else:
                expected, j = mem.get(addr, (Fr(0), None))
                e = values[i] - expected
                if j is not None:
                    ordering = lt.evaluate_at_bits(bits_be(j), bits_be(i))
                    e = e + (Fr(1) - ordering)
                err.append(e)
        mle = MultilinearExtension.from_evaluations_vec(log_ops, err)
        return TorchProductMLEOracle([mle], device=device)
