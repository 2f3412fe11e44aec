"""Generic-degree sum-check: the engine behind the bit-column protocols.

Counterpart of ``tnsh/iop/sumcheck_d.py``.  The host half is the port's own
copy: ``SumCheckD`` (round messages are coefficient vectors of
degree-``degree`` polynomials interpolated from evaluations at
X = 0..degree; transcript labels ``sumcheck_round_i`` /
``sumcheck_challenge_i``), ``SumCheckDProof`` and the pure-Python
``DenseSopOracleD``.

The device half, ``TorchSopOracleD``, takes the place of
``JaxSopOracleD``: tables live as ONE stacked ``(F, 8, N)`` tensor, so a
round is one round-evaluation launch and a bind is one fold launch for all
tables.  Outputs unpack to canonical host field elements before they touch
the transcript, so proofs are byte-identical to ``DenseSopOracleD``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

from ..core.transcript import Transcript
from ..errors import SumCheckError
from ..field import fr_kernels, limbs
from ..field.fr import MODULUS, Fr
from ..poly.interp import lagrange_interpolate

_P = MODULUS


@dataclass
class SumCheckDProof:
    """Round polynomials (degree+1 coefficients each) + final evaluation."""

    degree: int
    round_polynomials: List[List[Fr]]
    final_evaluation: Fr


def _eval_poly(coeffs: Sequence[Fr], point) -> int:
    acc = 0
    p = int(point)
    for c in reversed(coeffs):
        acc = (acc * p + int(c)) % _P
    return acc


class DenseSopOracleD:
    """Σ_t coeff_t · Π_m T_{t,m}(x) over {0,1}^num_vars, dense tables,
    arbitrary per-round degree (= max factors per term).

    Tables passed by identity are deduplicated (shared tables fold once
    per round).  All arithmetic is exact integer math mod p.
    """

    def __init__(self, num_vars: int, terms, degree: int = None):
        size = 1 << num_vars
        self.num_vars = num_vars
        self._tables: List[List[int]] = []
        self._terms: List[tuple] = []
        seen = {}
        max_deg = 1
        for coeff, tabs in terms:
            idxs = []
            for t in tabs:
                key = id(t)
                if key not in seen:
                    if len(t) != size:
                        raise SumCheckError("table size mismatch")
                    seen[key] = len(self._tables)
                    self._tables.append([int(v) % _P for v in t])
                idxs.append(seen[key])
            self._terms.append((int(coeff) % _P, tuple(idxs)))
            max_deg = max(max_deg, len(idxs))
        if not self._terms:
            raise SumCheckError("DenseSopOracleD needs at least one term")
        self.degree = max_deg if degree is None else degree
        if self.degree < max_deg:
            raise SumCheckError("declared degree below term degree")

    def hypercube_sum(self) -> Fr:
        total = 0
        size = len(self._tables[0])
        for i in range(size):
            for coeff, idxs in self._terms:
                prod = coeff
                for f in idxs:
                    prod = prod * self._tables[f][i] % _P
                total += prod
        return Fr(total % _P)

    def round_evaluations(self, round_index: int) -> List[Fr]:
        npts = self.degree + 1
        acc = [0] * npts
        half = len(self._tables[0]) // 2
        tabs = self._tables
        for i in range(half):
            # X-point values per table, extended incrementally
            vals = []
            for t in tabs:
                lo = t[2 * i]
                hi = t[2 * i + 1]
                d = (hi - lo) % _P
                row = [lo, hi]
                v = hi
                for _ in range(npts - 2):
                    v = (v + d) % _P
                    row.append(v)
                vals.append(row)
            for coeff, idxs in self._terms:
                for x in range(npts):
                    prod = coeff
                    for f in idxs:
                        prod = prod * vals[f][x] % _P
                    acc[x] += prod
        return [Fr(v % _P) for v in acc]

    def bind(self, challenge: Fr) -> None:
        r = int(challenge)
        for t in self._tables:
            half = len(t) // 2
            for i in range(half):
                lo = t[2 * i]
                t[i] = (lo + r * (t[2 * i + 1] - lo)) % _P
            del t[half:]

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        total = 0
        for coeff, idxs in self._terms:
            prod = coeff
            for f in idxs:
                prod = prod * self._tables[f][0] % _P
            total += prod
        return Fr(total % _P)


class SumCheckD:
    """Sum-check at an explicit round degree (evaluations at 0..degree)."""

    def __init__(self, num_vars: int, claimed_sum: Fr, degree: int):
        self.num_vars = num_vars
        self.claimed_sum = Fr(claimed_sum)
        self.degree = degree
        self._xs = [Fr(x) for x in range(degree + 1)]

    def prove_with_challenges(self, oracle, transcript: Transcript):
        round_polys: List[List[Fr]] = []
        current = int(self.claimed_sum)
        challenges: List[Fr] = []
        for rd in range(self.num_vars):
            evals = oracle.round_evaluations(rd)
            if len(evals) != self.degree + 1:
                raise SumCheckError("oracle degree mismatch")
            poly = lagrange_interpolate(list(zip(self._xs, evals)))
            if (int(evals[0]) + int(evals[1])) % _P != current:
                raise SumCheckError(f"round {rd} consistency check failed")
            round_polys.append(poly)
            transcript.append_field_elements(
                f"sumcheck_round_{rd}".encode(), poly
            )
            c = transcript.challenge_field_element(
                f"sumcheck_challenge_{rd}".encode()
            )
            challenges.append(c)
            oracle.bind(c)
            current = _eval_poly(poly, c)
        final = oracle.final_evaluation(challenges)
        return SumCheckDProof(self.degree, round_polys, final), challenges

    def verify(self, proof: SumCheckDProof, transcript: Transcript):
        if (proof.degree != self.degree
                or len(proof.round_polynomials) != self.num_vars):
            return False, []
        current = int(self.claimed_sum)
        challenges: List[Fr] = []
        for rd, poly in enumerate(proof.round_polynomials):
            if len(poly) != self.degree + 1:
                return False, challenges
            if (_eval_poly(poly, 0) + _eval_poly(poly, 1)) % _P != current:
                return False, challenges
            transcript.append_field_elements(
                f"sumcheck_round_{rd}".encode(), poly
            )
            c = transcript.challenge_field_element(
                f"sumcheck_challenge_{rd}".encode()
            )
            challenges.append(c)
            current = _eval_poly(poly, c)
        return current == int(proof.final_evaluation), challenges


def stack_tables(tables, device) -> torch.Tensor:
    """Equal-length tables as one (F, 8, N) tensor on ``device``: host
    tables (field values, an ``FrTable``) are packed in a single transfer
    and Montgomery conversion, ``(8, N)`` device tables copied in."""
    host = [i for i, t in enumerate(tables)
            if not isinstance(t, torch.Tensor)]
    packed = {}
    if host:
        words = b"".join(limbs.le_bytes(tables[i]) for i in host)
        flat = limbs.pack(words, device)          # (8, H*N)
        n = flat.shape[1] // len(host)
        for j, i in enumerate(host):
            packed[i] = flat[:, j * n:(j + 1) * n]
    return torch.stack([
        packed[i] if i in packed else t.to(device)
        for i, t in enumerate(tables)
    ])


class TorchSopOracleD:
    """Σ_t coeff_t · Π_m T_{t,m}(x) over {0,1}^num_vars on ``device``, at an
    explicit round degree (default: the largest term's factor count).

    ``terms``: ``(coeff, [table, ...])`` pairs.  A table is a host sequence
    of field values (ints, ``Fr``, an ``FrTable``) or an ``(8, N)`` tensor
    already in the port's Montgomery layout on ``device``.  Tables passed
    by identity are deduplicated, so a shared table folds once per round.
    ``device`` is required: nothing defaults to the host.

    ``stack`` takes tables that are already one ``(F, 8, 2^num_vars)``
    tensor on ``device``: the terms' factors are then indices into it, and
    the oracle folds it without a copy (the caller drops its reference, so
    a bind holds the stack and its half, not two stacks).
    """

    def __init__(self, num_vars: int, terms, degree: int = None, *,
                 device, stack: torch.Tensor = None):
        size = 1 << num_vars
        self.num_vars = num_vars
        self.device = torch.device(device)
        tables: List = []
        coeffs: List[int] = []
        idxs_list: List[tuple] = []
        seen = {}
        max_deg = 1
        for coeff, tabs in terms:
            idxs = []
            for t in tabs:
                if stack is not None:
                    idxs.append(int(t))
                    continue
                key = id(t)
                if key not in seen:
                    n = t.shape[-1] if isinstance(t, torch.Tensor) else len(t)
                    if n != size:
                        raise SumCheckError("table size mismatch")
                    seen[key] = len(tables)
                    tables.append(t)
                idxs.append(seen[key])
            coeffs.append(int(coeff) % _P)
            idxs_list.append(tuple(idxs))
            max_deg = max(max_deg, len(idxs))
        if not idxs_list:
            raise SumCheckError("TorchSopOracleD needs at least one term")
        self.degree = max_deg if degree is None else degree
        if self.degree < max_deg:
            raise SumCheckError("declared degree below term degree")
        self._coeff_ints = coeffs
        self._idxs = tuple(idxs_list)
        if stack is None:
            self.tables = stack_tables(tables, self.device)
        else:
            if stack.dim() != 3 or stack.shape[2] != size:
                raise SumCheckError(f"stack: expected (F, 8, {size}), got "
                                    f"{tuple(stack.shape)}")
            if any(not 0 <= f < stack.shape[0] for t in idxs_list for f in t):
                raise SumCheckError("a term indexes beyond the stack")
            self.tables = stack
        self._coeffs = torch.cat(
            [limbs.scalar(c, self.device) for c in coeffs], dim=1
        ).contiguous()
        self._desc = fr_kernels.terms(self._idxs, self.device)

    def round_evaluations(self, round_index: int) -> List[Fr]:
        evals = fr_kernels.sum_of_products_round_evals(
            self.tables, self._coeffs, self._desc, self.degree + 1)
        return [Fr(v) for v in limbs.unpack(evals)]

    def bind(self, challenge: Fr) -> None:
        self.tables = fr_kernels.fold(self.tables, challenge)

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        finals = limbs.unpack(self.tables[:, :, 0].transpose(0, 1))
        total = 0
        for coeff, idxs in zip(self._coeff_ints, self._idxs):
            prod = coeff
            for f in idxs:
                prod = prod * finals[f] % _P
            total += prod
        return Fr(total % _P)

    def release(self) -> None:
        """Drop the device tables (idempotent)."""
        self.tables = None
