"""BN254: the scalar field Fr, the base field Fq and G1 (y^2 = x^3 + 3),
in Python ints; the ark-compatible 32-byte encodings of Fr and of a
compressed G1 point."""

from __future__ import annotations

from typing import Tuple

#: the scalar field's modulus r
P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
#: the base field's modulus q
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
#: 2^-256 mod r: ark's Fr::rand reads its sample as a Montgomery form
R256_INV = pow(1 << 256, -1, P)

#: Jacobian (X, Y, Z); Z = 0 is the identity
Point = Tuple[int, int, int]
ZERO: Point = (1, 1, 0)
GENERATOR: Point = (1, 2, 1)


class Malformed(ValueError):
    """Bytes that are no valid encoding."""


def double(p: Point) -> Point:
    x1, y1, z1 = p
    if z1 == 0 or y1 == 0:
        return ZERO
    a = x1 * x1 % Q
    b = y1 * y1 % Q
    c = b * b % Q
    d = 2 * ((x1 + b) * (x1 + b) - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    return x3, (e * (d - x3) - 8 * c) % Q, 2 * y1 * z1 % Q


def add(p: Point, q: Point) -> Point:
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 * z2z2 % Q
    s2 = y2 * z1 * z1z1 % Q
    if u1 == u2:
        return double(p) if s1 == s2 else ZERO
    h = (u2 - u1) % Q
    i = 4 * h * h % Q
    j = h * i % Q
    r = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (r * r - j - 2 * v) % Q
    return x3, (r * (v - x3) - 2 * s1 * j) % Q, 2 * h * z1 * z2 % Q


def mul(p: Point, k: int) -> Point:
    """k p, double and add from the top bit."""
    k %= P
    acc = ZERO
    for bit in bin(k)[2:] if k else "":
        acc = double(acc)
        if bit == "1":
            acc = add(acc, p)
    return acc


def affine(p: Point) -> Tuple[int, int]:
    """(x, y); the identity is (0, 0), as ark writes it."""
    if p[2] == 0:
        return 0, 0
    zinv = pow(p[2], -1, Q)
    zinv2 = zinv * zinv % Q
    return p[0] * zinv2 % Q, p[1] * zinv2 * zinv % Q


def compress(p: Point) -> bytes:
    """ark's compressed G1: x little-endian, 0x80 on the last byte where
    y > -y, 0x40 for the identity."""
    if p[2] == 0:
        return bytes(31) + b"\x40"
    x, y = affine(p)
    out = bytearray(x.to_bytes(32, "little"))
    if 2 * y > Q:
        out[31] |= 0x80
    return bytes(out)


def decompress(data: bytes) -> Point:
    if len(data) != 32:
        raise Malformed("a compressed G1 point is 32 bytes")
    flags = data[31] & 0xC0
    x = int.from_bytes(data[:31] + bytes([data[31] & 0x3F]), "little")
    if flags & 0x40:
        if x or flags & 0x80:
            raise Malformed("a non-canonical identity")
        return ZERO
    if x >= Q:
        raise Malformed("x not below q")
    y2 = (x * x * x + 3) % Q
    y = pow(y2, (Q + 1) // 4, Q)
    if y * y % Q != y2:
        raise Malformed("x of no point on the curve")
    if bool(flags & 0x80) != (2 * y > Q):
        y = Q - y
    return x, y, 1


def x_hash(data: bytes) -> int:
    """A commitment's transcript element: its affine x mod r, read from its
    compressed bytes (the identity's x is 0)."""
    if data[31] & 0x40:
        return 0
    return int.from_bytes(data[:31] + bytes([data[31] & 0x3F]), "little") % P


def fr_bytes(x: int) -> bytes:
    return (x % P).to_bytes(32, "little")


def fr_read(data: bytes, off: int) -> int:
    v = int.from_bytes(data[off:off + 32], "little")
    if len(data) < off + 32 or v >= P:
        raise Malformed("an Fr element is 32 canonical bytes")
    return v


def equal_points(a: Point, b: Point) -> bool:
    return affine(a) == affine(b)

