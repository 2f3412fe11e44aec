"""Sum-check protocol engine and its oracles, host and device.

Counterpart of ``tnsh/iop/sumcheck.py``.  The host half is the port's own
copy of the degree-3 engine: ``SumCheck`` (prove / verify, round
polynomials interpolated from evaluations at X = 0..3, transcript labels
``sumcheck_round_{r}`` / ``sumcheck_challenge_{r}``), ``SumCheckProof``,
the ``SumcheckOracle`` interface and the host oracles (``CallableOracle``,
``ZeroOracle``, ``ProductMLEOracle``, ``SumOfProductsOracle``).

The device half takes the place of ``JaxSumOfProductsOracle`` and
``JaxProductMLEOracle``: ``TorchSumOfProductsOracle`` and
``TorchProductMLEOracle`` run every round through the port's kernels
(``tnsh_torch.field.fr_kernels``).  Outputs unpack to canonical host field
elements before they touch the transcript, so proofs are byte-identical to
the host oracles'.
"""


from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import torch

from ..core.transcript import Transcript
from ..errors import SumCheckError
from ..field import fr_kernels, limbs
from ..field.fr import MODULUS, Fr
from ..poly.interp import lagrange_interpolate
from ..poly.mle_host import MultilinearExtension
from .sumcheck_d import TorchSopOracleD

_P = MODULUS

#: Evaluation points for each round polynomial (degree <= 3).
_ROUND_XS = (Fr(0), Fr(1), Fr(2), Fr(3))


@dataclass
class SumCheckProof:
    """Round polynomials (4 coefficients each) + final evaluation
    (reference sumcheck.rs:25-31)."""

    round_polynomials: List[List[Fr]]
    final_evaluation: Fr


@dataclass
class SumCheckVerifier:
    """Verifier state struct — declared for API parity with the reference
    (sumcheck.rs:35-44), which also never uses it."""

    num_vars: int
    challenges: List[Fr] = field(default_factory=list)
    expected_sum: Fr = Fr(0)


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------

class SumcheckOracle:
    """Prover-side polynomial interface consumed by ``SumCheck.prove``."""

    def round_evaluations(self, round_index: int) -> List[Fr]:
        """[g(0), g(1), g(2), g(3)] for the current round."""
        raise NotImplementedError

    def bind(self, challenge: Fr) -> None:
        """Fix the current variable to ``challenge`` and advance a round."""
        raise NotImplementedError

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        """f(challenges) after all rounds."""
        raise NotImplementedError


class CallableOracle(SumcheckOracle):
    """Reference-exact oracle over an opaque callable
    (reference sumcheck.rs:156-207)."""

    def __init__(self, func: Callable[[List[Fr]], Fr], num_vars: int):
        self.func = func
        self.num_vars = num_vars
        self.fixed: List[Fr] = []

    def round_evaluations(self, round_index: int) -> List[Fr]:
        remaining = self.num_vars - len(self.fixed) - 1
        num_points = 1 << remaining
        evals: List[Fr] = []
        for x in _ROUND_XS:
            total = 0
            for suffix in range(num_points):
                point = list(self.fixed)
                point.append(x)
                for bit in range(remaining):
                    point.append(Fr(1) if (suffix >> bit) & 1 else Fr(0))
                total += int(self.func(point))
            evals.append(Fr(total))
        return evals

    def bind(self, challenge: Fr) -> None:
        self.fixed.append(challenge)

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        return self.func(list(challenges))


class ZeroOracle(SumcheckOracle):
    """The identically-zero polynomial — what the reference's stub
    consistency closures compute (twist.rs:186-214, shout.rs:160-184)."""

    def __init__(self, num_vars: int):
        self.num_vars = num_vars

    def round_evaluations(self, round_index: int) -> List[Fr]:
        return [Fr(0), Fr(0), Fr(0), Fr(0)]

    def bind(self, challenge: Fr) -> None:
        pass

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        return Fr(0)


class ProductMLEOracle(SumcheckOracle):
    """Product of MLE factors (optionally scaled), evaluated by folding.

    Folds the FIRST (fastest) variable each round, matching the reference's
    variable order.  Per-round cost is O(4 * k * 2^remaining) field mults
    where k = number of factors — the classic linear-time sum-check prover.
    """

    def __init__(self, factors: Sequence[MultilinearExtension], scale: Fr = Fr(1)):
        if not factors:
            raise SumCheckError("ProductMLEOracle needs at least one factor")
        self.num_vars = factors[0].num_vars
        for f in factors:
            if f.num_vars != self.num_vars:
                raise SumCheckError("factor num_vars mismatch")
        self.tables: List[List[int]] = [
            [int(e) for e in f.evaluations] for f in factors
        ]
        self.scale = int(scale)

    def round_evaluations(self, round_index: int) -> List[Fr]:
        half = len(self.tables[0]) // 2
        sums = [0, 0, 0, 0]
        for s in range(half):
            lo_hi = [(t[2 * s], t[2 * s + 1]) for t in self.tables]
            for xi in range(4):
                prod = self.scale
                for lo, hi in lo_hi:
                    prod = prod * ((lo + xi * (hi - lo)) % _P) % _P
                sums[xi] += prod
        return [Fr(v) for v in sums]

    def bind(self, challenge: Fr) -> None:
        r = int(challenge)
        self.tables = [
            [
                (t[2 * i] + r * (t[2 * i + 1] - t[2 * i])) % _P
                for i in range(len(t) // 2)
            ]
            for t in self.tables
        ]

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        prod = self.scale
        for t in self.tables:
            prod = prod * t[0] % _P
        return Fr(prod)


class SumOfProductsOracle(SumcheckOracle):
    """Linear combination of products of dense tables:

        f(x) = sum_t coeff_t * prod_m T_{t,m}(x)

    over {0,1}^num_vars, evaluated by table folding like
    ``ProductMLEOracle``.  Tables passed by identity are deduplicated so a
    table shared between terms is folded exactly once per round.  This is
    the oracle for the verifier-enforced sound-mode constraint systems
    (the sound protocols), whose checks are small sums of degree-<=3
    products (eq * witness * witness).
    """

    #: Table sizes at or above this route to the native C++ evaluator
    #: (per-round work is O(size * factors) big-int mults in Python).
    NATIVE_THRESHOLD = 1 << 10

    def __init__(self, num_vars: int, terms):
        """``terms``: sequence of ``(coeff, [table, ...])`` where each table
        is a list of ints/Fr of length ``2^num_vars``."""
        size = 1 << num_vars
        self.num_vars = num_vars
        self._tables: List[List[int]] = []
        self._terms: List[tuple] = []
        self._native_id = None
        seen = {}
        for coeff, tabs in terms:
            idxs = []
            for t in tabs:
                key = id(t)
                if key not in seen:
                    if len(t) != size:
                        raise SumCheckError("table size mismatch")
                    seen[key] = len(self._tables)
                    # bytes-backed FrTable payloads (native eq/lt tables)
                    # pass through to the native marshal untouched
                    self._tables.append(
                        t if hasattr(t, "raw")
                        else [int(v) % _P for v in t]
                    )
                idxs.append(seen[key])
            self._terms.append((int(coeff) % _P, idxs))
        if not self._terms:
            raise SumCheckError("SumOfProductsOracle needs at least one term")
        if size >= self.NATIVE_THRESHOLD:
            from .. import _native

            if _native.available:
                self._native_id = _native.sop_create(
                    self._tables, self._terms
                )
                self._tables = []  # tables live native-side

    @classmethod
    def _from_native_id(cls, num_vars: int, native_id: int
                        ) -> "SumOfProductsOracle":
        """Wrap an already-built native sop handle (e.g. from
        _native.sco_make_sop) without marshalling any tables."""
        o = cls.__new__(cls)
        o.num_vars = num_vars
        o._tables = []
        o._terms = []
        o._native_id = native_id
        return o

    def __del__(self):  # pragma: no cover - finalizer
        if getattr(self, "_native_id", None) is not None:
            try:
                from .. import _native

                _native.sop_free(self._native_id)
            except Exception:
                pass

    def round_evaluations(self, round_index: int) -> List[Fr]:
        if self._native_id is not None:
            from .. import _native

            return _native.sop_round_evals(self._native_id)
        half = len(self._tables[0]) // 2
        sums = [0, 0, 0, 0]
        for s in range(half):
            lo_hi = [(t[2 * s], t[2 * s + 1]) for t in self._tables]
            for xi in range(4):
                pt_vals = [
                    (lo + xi * (hi - lo)) % _P for lo, hi in lo_hi
                ]
                total = 0
                for coeff, idxs in self._terms:
                    prod = coeff
                    for m in idxs:
                        prod = prod * pt_vals[m] % _P
                    total += prod
                sums[xi] += total
        return [Fr(v) for v in sums]

    def bind(self, challenge: Fr) -> None:
        if self._native_id is not None:
            from .. import _native

            _native.sop_bind(self._native_id, challenge)
            return
        r = int(challenge)
        self._tables = [
            [
                (t[2 * i] + r * (t[2 * i + 1] - t[2 * i])) % _P
                for i in range(len(t) // 2)
            ]
            for t in self._tables
        ]

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        if self._native_id is not None:
            from .. import _native

            return _native.sop_final(self._native_id)
        total = 0
        for coeff, idxs in self._terms:
            prod = coeff
            for m in idxs:
                prod = prod * self._tables[m][0] % _P
            total += prod
        return Fr(total % _P)


def _evaluate_round_polynomial(coeffs: Sequence[Fr], point: Fr) -> Fr:
    acc = 0
    p = int(point)
    for c in reversed(coeffs):
        acc = (acc * p + int(c)) % _P
    return Fr(acc)


class SumCheck:
    """Sum-check instance: claim Σ_{x in {0,1}^n} f(x) = claimed_sum
    (reference sumcheck.rs:46-153)."""

    def __init__(self, num_vars: int, claimed_sum: Fr):
        self.num_vars = num_vars
        self.claimed_sum = Fr(claimed_sum)

    def prove(self, polynomial, transcript: Transcript) -> SumCheckProof:
        """``polynomial`` is a ``SumcheckOracle`` or a plain callable
        (wrapped in ``CallableOracle`` with reference-exact semantics)."""
        proof, _ = self.prove_with_challenges(polynomial, transcript)
        return proof

    def prove_with_challenges(self, polynomial, transcript: Transcript):
        """Like ``prove`` but also returns the verifier challenge vector —
        sound-mode callers open PCS commitments at exactly this point."""
        oracle = (
            polynomial
            if isinstance(polynomial, SumcheckOracle)
            else CallableOracle(polynomial, self.num_vars)
        )
        round_polynomials: List[List[Fr]] = []
        current_sum = self.claimed_sum
        challenges: List[Fr] = []

        for round_index in range(self.num_vars):
            evals = oracle.round_evaluations(round_index)
            round_poly = lagrange_interpolate(
                list(zip(_ROUND_XS, evals))
            )
            g_0 = _evaluate_round_polynomial(round_poly, Fr(0))
            g_1 = _evaluate_round_polynomial(round_poly, Fr(1))
            if g_0 + g_1 != current_sum:
                raise SumCheckError(
                    f"Round {round_index} consistency check failed"
                )
            round_polynomials.append(round_poly)

            transcript.append_field_elements(
                f"sumcheck_round_{round_index}".encode(), round_poly
            )
            challenge = transcript.challenge_field_element(
                f"sumcheck_challenge_{round_index}".encode()
            )
            challenges.append(challenge)
            oracle.bind(challenge)
            current_sum = _evaluate_round_polynomial(round_poly, challenge)

        final_evaluation = oracle.final_evaluation(challenges)
        return SumCheckProof(round_polynomials, final_evaluation), challenges

    def verify(self, proof: SumCheckProof, transcript: Transcript):
        """Returns ``(is_valid, challenges)`` (reference sumcheck.rs:113-153)."""
        if len(proof.round_polynomials) != self.num_vars:
            raise SumCheckError("Proof has wrong number of rounds")

        current_sum = self.claimed_sum
        challenges: List[Fr] = []
        for round_index, round_poly in enumerate(proof.round_polynomials):
            g_0 = _evaluate_round_polynomial(round_poly, Fr(0))
            g_1 = _evaluate_round_polynomial(round_poly, Fr(1))
            if g_0 + g_1 != current_sum:
                return False, challenges
            transcript.append_field_elements(
                f"sumcheck_round_{round_index}".encode(), round_poly
            )
            challenge = transcript.challenge_field_element(
                f"sumcheck_challenge_{round_index}".encode()
            )
            challenges.append(challenge)
            current_sum = _evaluate_round_polynomial(round_poly, challenge)

        return current_sum == proof.final_evaluation, challenges


# ---------------------------------------------------------------------------
# device oracles
# ---------------------------------------------------------------------------

class TorchSumOfProductsOracle(TorchSopOracleD, SumcheckOracle):
    """Σ_t coeff_t · Π_m T_{t,m}(x) with degree-3 rounds (evaluations at
    X = 0..3), for the verifier-enforced sound-mode constraint systems.
    The generic-degree oracle at degree 3; terms of more than three
    factors are refused."""

    def __init__(self, num_vars: int, terms, *, device):
        super().__init__(num_vars, list(terms), degree=3, device=device)


class TorchProductMLEOracle(SumcheckOracle):
    """Product of MLE factors, optionally scaled, evaluated by folding on
    ``device``: one product-round launch and one fold launch per round.

    The final evaluation includes the scale, as ``ProductMLEOracle``'s does
    (``JaxProductMLEOracle`` leaves it out; the two agree at scale 1)."""

    def __init__(self, factors: Sequence[MultilinearExtension],
                 scale: Fr = Fr(1), *, device):
        if not factors:
            raise SumCheckError(
                "TorchProductMLEOracle needs at least one factor")
        self.num_vars = factors[0].num_vars
        for f in factors:
            if f.num_vars != self.num_vars:
                raise SumCheckError("factor num_vars mismatch")
        device = torch.device(device)
        n = 1 << self.num_vars
        flat = limbs.pack(
            [int(e) for f in factors for e in f.evaluations], device)
        self.tables = flat.view(limbs.NUM_LIMBS, len(factors), n).transpose(
            0, 1).contiguous()
        self._scale_int = int(scale) % _P
        self._scale = (None if self._scale_int == 1
                       else limbs.scalar(self._scale_int, device))

    def round_evaluations(self, round_index: int) -> List[Fr]:
        evals = fr_kernels.product_round_evals(self.tables, self._scale)
        return [Fr(v) for v in limbs.unpack(evals)]

    def bind(self, challenge: Fr) -> None:
        self.tables = fr_kernels.fold(self.tables, challenge)

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        prod = self._scale_int
        for v in limbs.unpack(self.tables[:, :, 0].transpose(0, 1)):
            prod = prod * v % _P
        return Fr(prod)
