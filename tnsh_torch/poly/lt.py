"""Less-than ordering indicator polynomial.

Port of ``LessThanPolynomial`` (reference polynomials.rs:198-293).  The
reference defines lt(a, b) by scanning bits from index 0 upward and deciding
at the first differing bit (polynomials.rs:222-239) — note this treats bit 0
(the least-significant bit under the little-endian convention) as the MOST
significant comparison position, i.e. comparison is lexicographic over the
little-endian bit string, NOT numeric comparison.  Tested behavior
(polynomial_tests.rs:155-188) depends on that quirk, so it is preserved.

Wired into the sound-mode Twist ordering constraints (tnsh.protocols.twist in the JAX package);
the reference ships it but never uses it in proving (SURVEY caveat 2).
"""

from __future__ import annotations

from typing import List

from ..field.fr import Fr
from .mle_host import MultilinearExtension


class LessThanPolynomial:
    """lt(a, b) indicator over n-bit inputs (reference polynomials.rs:201)."""

    __slots__ = ("num_vars",)

    def __init__(self, num_vars: int):
        self.num_vars = num_vars

    def evaluate_at_bits(self, a_bits: List[bool], b_bits: List[bool]) -> Fr:
        """First-differing-bit comparison, bit 0 most significant
        (reference polynomials.rs:222-239)."""
        if len(a_bits) != self.num_vars or len(b_bits) != self.num_vars:
            raise AssertionError("bit vectors must have num_vars entries")
        for a, b in zip(a_bits, b_bits):
            if a and not b:
                return Fr(0)
            if b and not a:
                return Fr(1)
        return Fr(0)

    def evaluate_at_field_elements(self, a: Fr, b: Fr) -> Fr:
        """Compare via the low ``num_vars`` bits of the standard-form values
        (reference polynomials.rs:213-219, 266-283)."""
        return self.evaluate_at_bits(self._field_to_bits(a), self._field_to_bits(b))

    def to_multilinear_extension(self) -> MultilinearExtension:
        """Materialize the 2n-variable MLE table; index packs a | (b << n)
        (reference polynomials.rs:243-263)."""
        n = self.num_vars
        size = 1 << (2 * n)
        mask = (1 << n) - 1
        evals = [Fr(0)] * size
        one = Fr(1)
        for index in range(size):
            a_index = index & mask
            b_index = index >> n
            # First differing little-endian bit decides.
            diff = a_index ^ b_index
            if diff:
                low = diff & (-diff)
                if b_index & low:
                    evals[index] = one
        return MultilinearExtension(2 * n, evals)

    def _field_to_bits(self, elem: Fr) -> List[bool]:
        v = int(elem)
        return [bool((v >> i) & 1) for i in range(self.num_vars)]
