"""BN254 G1 group (y^2 = x^3 + 3 over Fq), Jacobian coordinates.

Replaces arkworks ``G1Projective`` (reference utils.rs:17 ``G1Element``,
SURVEY §2 D2).  Host representation: ``G1`` wraps Jacobian (X, Y, Z) Python
ints; ``Z == 0`` is the identity.  The affine x-coordinate of the identity is
0, matching ark's ``G1Affine::zero()`` — the transcript commitment hash
(reference commitments.rs:73-84) depends on that convention.

Scalar multiplication uses a fixed 4-bit window; values are mathematically
determined so any algorithm is transcript-compatible with the reference's
naive arkworks scalar-muls (reference utils.rs:93-96, commitments.rs:173-177).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .fq import Q

#: Curve coefficient b = 3 for G1.
B1 = 3


class G1:
    """A BN254 G1 point in Jacobian coordinates (X, Y, Z); Z=0 is identity."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x: int, y: int, z: int = 1):
        self.x = x % Q
        self.y = y % Q
        self.z = z % Q

    # -- constructors -----------------------------------------------------
    @staticmethod
    def zero() -> "G1":
        return G1(1, 1, 0)

    @staticmethod
    def generator() -> "G1":
        """ark ``G1Projective::generator()`` = (1, 2) (utils.rs:85)."""
        return G1(1, 2, 1)

    @staticmethod
    def from_affine(x: int, y: int) -> "G1":
        return G1(x, y, 1)

    # -- predicates -------------------------------------------------------
    def is_zero(self) -> bool:
        return self.z == 0

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, G1):
            return NotImplemented
        if self.is_zero() or other.is_zero():
            return self.is_zero() and other.is_zero()
        z1s = self.z * self.z % Q
        z2s = other.z * other.z % Q
        if self.x * z2s % Q != other.x * z1s % Q:
            return False
        return self.y * z2s * other.z % Q == other.y * z1s * self.z % Q

    def __hash__(self) -> int:
        ax, ay = self.to_affine()
        return hash((ax, ay))

    # -- group law --------------------------------------------------------
    def double(self) -> "G1":
        if self.is_zero() or self.y == 0:
            return G1.zero() if self.is_zero() else self._double_nonzero()
        return self._double_nonzero()

    def _double_nonzero(self) -> "G1":
        X1, Y1, Z1 = self.x, self.y, self.z
        A = X1 * X1 % Q
        B = Y1 * Y1 % Q
        C = B * B % Q
        D = 2 * ((X1 + B) * (X1 + B) - A - C) % Q
        E = 3 * A % Q
        F = E * E % Q
        X3 = (F - 2 * D) % Q
        Y3 = (E * (D - X3) - 8 * C) % Q
        Z3 = 2 * Y1 * Z1 % Q
        return G1(X3, Y3, Z3)

    def add(self, other: "G1") -> "G1":
        if self.is_zero():
            return other
        if other.is_zero():
            return self
        X1, Y1, Z1 = self.x, self.y, self.z
        X2, Y2, Z2 = other.x, other.y, other.z
        Z1Z1 = Z1 * Z1 % Q
        Z2Z2 = Z2 * Z2 % Q
        U1 = X1 * Z2Z2 % Q
        U2 = X2 * Z1Z1 % Q
        S1 = Y1 * Z2 * Z2Z2 % Q
        S2 = Y2 * Z1 * Z1Z1 % Q
        if U1 == U2:
            if S1 != S2:
                return G1.zero()
            return self._double_nonzero()
        H = (U2 - U1) % Q
        I = 4 * H * H % Q
        J = H * I % Q
        r = 2 * (S2 - S1) % Q
        V = U1 * I % Q
        X3 = (r * r - J - 2 * V) % Q
        Y3 = (r * (V - X3) - 2 * S1 * J) % Q
        Z3 = 2 * H * Z1 * Z2 % Q
        return G1(X3, Y3, Z3)

    __add__ = add

    def neg(self) -> "G1":
        if self.is_zero():
            return self
        return G1(self.x, (-self.y) % Q, self.z)

    __neg__ = neg

    def __sub__(self, other: "G1") -> "G1":
        return self.add(other.neg())

    def scalar_mul(self, k: int) -> "G1":
        """Windowed (4-bit) left-to-right scalar multiplication."""
        k = int(k)
        if k == 0 or self.is_zero():
            return G1.zero()
        if k < 0:
            return self.neg().scalar_mul(-k)
        # Precompute 1P..15P
        table: List[G1] = [G1.zero(), self]
        for i in range(2, 16):
            table.append(table[i - 1].add(self))
        acc = G1.zero()
        nibbles = []
        while k:
            nibbles.append(k & 0xF)
            k >>= 4
        for nib in reversed(nibbles):
            if not acc.is_zero():
                acc = acc.double().double().double().double()
            if nib:
                acc = acc.add(table[nib])
        return acc

    def __mul__(self, k: int) -> "G1":
        return self.scalar_mul(k)

    __rmul__ = __mul__

    # -- conversions ------------------------------------------------------
    def to_affine(self) -> Tuple[int, int]:
        """Affine (x, y); identity maps to (0, 0) like ark ``G1Affine::zero``."""
        if self.is_zero():
            return (0, 0)
        zinv = pow(self.z, -1, Q)
        zinv2 = zinv * zinv % Q
        return (self.x * zinv2 % Q, self.y * zinv2 * zinv % Q)

    def is_on_curve(self) -> bool:
        if self.is_zero():
            return True
        x, y = self.to_affine()
        return (y * y - x * x * x - B1) % Q == 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        x, y = self.to_affine()
        return f"G1({x}, {y})"


def g1_sum(points: Sequence[G1]) -> G1:
    """Σ points (the reference's ``.sum::<G1Element>()``, commitments.rs:177)."""
    acc = G1.zero()
    for p in points:
        acc = acc.add(p)
    return acc
