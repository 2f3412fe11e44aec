"""BN254 base field Fq and quadratic extension Fq2.

Replaces the arkworks ark-bn254 base-field backend (SURVEY §2 D1/D2).  Host
representation is plain Python ints (Fq) and (c0, c1) int pairs (Fq2 = Fq[i],
i^2 = -1).  These are free functions over ints rather than classes: the curve
layer (g1.py / g2.py) is the only consumer and works on raw coordinates, which
keeps the host path fast and the limb mapping (field/limbs.py) trivial.
"""

from __future__ import annotations

from typing import Tuple

#: BN254 / alt_bn128 base field modulus q (254 bits).
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583

#: BN curve parameter u: q = 36u^4 + 36u^3 + 24u^2 + 6u + 1.
CURVE_U = 4965661367192848881

Fq2 = Tuple[int, int]

FQ2_ZERO: Fq2 = (0, 0)
FQ2_ONE: Fq2 = (1, 0)


def fq_inv(a: int) -> int:
    return pow(a, -1, Q)


def fq2_add(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a: Fq2) -> Fq2:
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a: Fq2, b: Fq2) -> Fq2:
    # (a0 + a1 i)(b0 + b1 i) with i^2 = -1 (Karatsuba).
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % Q, (t2 - t0 - t1) % Q)


def fq2_square(a: Fq2) -> Fq2:
    t0 = (a[0] + a[1]) * (a[0] - a[1])
    t1 = 2 * a[0] * a[1]
    return (t0 % Q, t1 % Q)


def fq2_scalar_mul(a: Fq2, k: int) -> Fq2:
    return (a[0] * k % Q, a[1] * k % Q)


def fq2_inv(a: Fq2) -> Fq2:
    # 1 / (a0 + a1 i) = (a0 - a1 i) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    ninv = pow(norm, -1, Q)
    return (a[0] * ninv % Q, (-a[1]) * ninv % Q)


def fq2_is_zero(a: Fq2) -> bool:
    return a[0] == 0 and a[1] == 0
