"""BN254 G2 group (y^2 = x^3 + b' over Fq2, b' = 3/(9+i)), Jacobian coords.

Replaces arkworks ``G2Projective`` (reference utils.rs:18 ``G2Element``,
SURVEY §2 D2).  Only the operations the reference exercises are provided:
generator, scalar-mul (for [tau]_2 and [point]_2, reference utils.rs:98,
commitments.rs:214), add/sub/neg (commitments.rs:215, 285-289) and affine
conversion for the pairing.
"""

from __future__ import annotations

from typing import List, Tuple

from .fq import (
    FQ2_ONE,
    Fq2,
    Q,
    fq2_add,
    fq2_inv,
    fq2_is_zero,
    fq2_mul,
    fq2_neg,
    fq2_scalar_mul,
    fq2_square,
    fq2_sub,
)

#: Twist coefficient b' = 3 / (9 + i) in Fq2.
B2: Fq2 = fq2_mul((3, 0), fq2_inv((9, 1)))

#: Standard alt_bn128 G2 generator (c0 + c1*i component order).
G2_GEN_X: Fq2 = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y: Fq2 = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)


class G2:
    """A BN254 G2 point in Jacobian coordinates over Fq2; Z=0 is identity."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x: Fq2, y: Fq2, z: Fq2 = FQ2_ONE):
        self.x = (x[0] % Q, x[1] % Q)
        self.y = (y[0] % Q, y[1] % Q)
        self.z = (z[0] % Q, z[1] % Q)

    @staticmethod
    def zero() -> "G2":
        return G2(FQ2_ONE, FQ2_ONE, (0, 0))

    @staticmethod
    def generator() -> "G2":
        return G2(G2_GEN_X, G2_GEN_Y, FQ2_ONE)

    def is_zero(self) -> bool:
        return fq2_is_zero(self.z)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, G2):
            return NotImplemented
        if self.is_zero() or other.is_zero():
            return self.is_zero() and other.is_zero()
        z1s = fq2_square(self.z)
        z2s = fq2_square(other.z)
        if fq2_mul(self.x, z2s) != fq2_mul(other.x, z1s):
            return False
        return fq2_mul(fq2_mul(self.y, z2s), other.z) == fq2_mul(
            fq2_mul(other.y, z1s), self.z
        )

    def __hash__(self) -> int:
        return hash(self.to_affine())

    def _double_nonzero(self) -> "G2":
        X1, Y1, Z1 = self.x, self.y, self.z
        A = fq2_square(X1)
        B = fq2_square(Y1)
        C = fq2_square(B)
        t = fq2_square(fq2_add(X1, B))
        D = fq2_scalar_mul(fq2_sub(fq2_sub(t, A), C), 2)
        E = fq2_scalar_mul(A, 3)
        F = fq2_square(E)
        X3 = fq2_sub(F, fq2_scalar_mul(D, 2))
        Y3 = fq2_sub(fq2_mul(E, fq2_sub(D, X3)), fq2_scalar_mul(C, 8))
        Z3 = fq2_scalar_mul(fq2_mul(Y1, Z1), 2)
        return G2(X3, Y3, Z3)

    def double(self) -> "G2":
        if self.is_zero():
            return self
        return self._double_nonzero()

    def add(self, other: "G2") -> "G2":
        if self.is_zero():
            return other
        if other.is_zero():
            return self
        X1, Y1, Z1 = self.x, self.y, self.z
        X2, Y2, Z2 = other.x, other.y, other.z
        Z1Z1 = fq2_square(Z1)
        Z2Z2 = fq2_square(Z2)
        U1 = fq2_mul(X1, Z2Z2)
        U2 = fq2_mul(X2, Z1Z1)
        S1 = fq2_mul(fq2_mul(Y1, Z2), Z2Z2)
        S2 = fq2_mul(fq2_mul(Y2, Z1), Z1Z1)
        if U1 == U2:
            if S1 != S2:
                return G2.zero()
            return self._double_nonzero()
        H = fq2_sub(U2, U1)
        I = fq2_scalar_mul(fq2_square(H), 4)
        J = fq2_mul(H, I)
        r = fq2_scalar_mul(fq2_sub(S2, S1), 2)
        V = fq2_mul(U1, I)
        X3 = fq2_sub(fq2_sub(fq2_square(r), J), fq2_scalar_mul(V, 2))
        Y3 = fq2_sub(fq2_mul(r, fq2_sub(V, X3)), fq2_scalar_mul(fq2_mul(S1, J), 2))
        Z3 = fq2_scalar_mul(fq2_mul(fq2_mul(H, Z1), Z2), 2)
        return G2(X3, Y3, Z3)

    __add__ = add

    def neg(self) -> "G2":
        if self.is_zero():
            return self
        return G2(self.x, fq2_neg(self.y), self.z)

    __neg__ = neg

    def __sub__(self, other: "G2") -> "G2":
        return self.add(other.neg())

    def scalar_mul(self, k: int) -> "G2":
        k = int(k)
        if k == 0 or self.is_zero():
            return G2.zero()
        if k < 0:
            return self.neg().scalar_mul(-k)
        table: List[G2] = [G2.zero(), self]
        for i in range(2, 16):
            table.append(table[i - 1].add(self))
        acc = G2.zero()
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

    def __mul__(self, k: int) -> "G2":
        return self.scalar_mul(k)

    __rmul__ = __mul__

    def to_affine(self) -> Tuple[Fq2, Fq2]:
        """Affine (x, y) in Fq2; identity maps to ((0,0), (0,0))."""
        if self.is_zero():
            return ((0, 0), (0, 0))
        zinv = fq2_inv(self.z)
        zinv2 = fq2_square(zinv)
        return (fq2_mul(self.x, zinv2), fq2_mul(fq2_mul(self.y, zinv2), zinv))

    def is_on_curve(self) -> bool:
        if self.is_zero():
            return True
        x, y = self.to_affine()
        lhs = fq2_square(y)
        rhs = fq2_add(fq2_mul(fq2_square(x), x), B2)
        return lhs == rhs

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        x, y = self.to_affine()
        return f"G2({x}, {y})"
