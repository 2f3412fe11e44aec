"""ark-serialize-compatible encodings for Fr, G1, G2 and proof containers.

Mirrors ark-serialize 0.4 conventions used by the reference
(commitments.rs:94-154 manual CanonicalSerialize impls; utils.rs:154-156
field-element serialization feeding the transcript):

  * Fr: 32-byte little-endian standard-form integer (no flags).
  * G1 compressed: 32-byte LE x-coordinate; flag bits in the top of the last
    byte — 0x40 point-at-infinity (x serialized as 0), 0x80 "y is negative"
    (y > -y, i.e. 2*y > q).  Decompression recovers y = sqrt(x^3 + 3) with
    q ≡ 3 (mod 4) so sqrt(a) = a^((q+1)/4).
  * G1 uncompressed: x bytes, then y bytes with the same flags on y's last
    byte.
  * G2: same layout with Fq2 coordinates serialized as c0 || c1; flags on the
    final byte.  "y negative" compares (c1, c0) lexicographically against the
    negation, matching ark's Fq2 ordering (c1 first, then c0).

Proof containers (SumCheckProof / TwistProof / ShoutProof) get a simple
length-prefixed framing built from these primitives; the reference derives no
serialization for them (SURVEY §5 checkpoint row), so this is a tnsh
extension for checkpoint/interop.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from ..errors import InvalidParametersError
from ..field.fq import Fq2, Q, fq2_is_zero, fq2_mul, fq2_neg, fq2_square
from ..field.fr import Fr
from ..field.g1 import G1
from ..field.g2 import G2

_INFINITY_FLAG = 0x40
_NEGATIVE_FLAG = 0x80
_SQRT_EXP = (Q + 1) // 4


# -- Fr ---------------------------------------------------------------------

def fr_to_bytes(x: Fr) -> bytes:
    return x.to_bytes_le()


def fr_from_bytes(data: bytes) -> Fr:
    if len(data) != 32:
        raise InvalidParametersError("Fr encoding must be 32 bytes")
    v = int.from_bytes(data, "little")
    from ..field.fr import MODULUS

    if v >= MODULUS:
        raise InvalidParametersError("Fr encoding not canonical")
    return Fr(v)


# -- Fq sqrt helpers --------------------------------------------------------

def _fq_sqrt(a: int):
    """Square root in Fq (q ≡ 3 mod 4); None if a is a non-residue."""
    r = pow(a, _SQRT_EXP, Q)
    if r * r % Q == a % Q:
        return r
    return None


def _fq2_sqrt(a: Fq2):
    """Square root in Fq2 via the complex method; None if non-residue."""
    if fq2_is_zero(a):
        return (0, 0)
    a0, a1 = a
    if a1 == 0:
        r = _fq_sqrt(a0)
        if r is not None:
            return (r, 0)
        # sqrt(a0) = i * sqrt(-a0) since i^2 = -1
        r = _fq_sqrt((-a0) % Q)
        if r is None:
            return None
        return (0, r)
    norm = (a0 * a0 + a1 * a1) % Q
    n = _fq_sqrt(norm)
    if n is None:
        return None
    inv2 = pow(2, -1, Q)
    for n_signed in (n, (-n) % Q):
        x0_sq = (a0 + n_signed) * inv2 % Q
        x0 = _fq_sqrt(x0_sq)
        if x0 is None or x0 == 0:
            continue
        x1 = a1 * pow(2 * x0 % Q, -1, Q) % Q
        cand = (x0, x1)
        if fq2_square(cand) == (a0 % Q, a1 % Q):
            return cand
    return None


def _fq2_is_negative(y: Fq2) -> bool:
    """ark Fq2 ordering: compare c1 first, then c0, against the negation."""
    ny = fq2_neg(y)
    if y[1] != ny[1]:
        return y[1] > ny[1]
    return y[0] > ny[0]


# -- G1 ---------------------------------------------------------------------

def g1_to_bytes(p: G1, compress: bool = True) -> bytes:
    if p.is_zero():
        if compress:
            out = bytearray(32)
            out[31] |= _INFINITY_FLAG
            return bytes(out)
        out = bytearray(64)
        out[63] |= _INFINITY_FLAG
        return bytes(out)
    x, y = p.to_affine()
    neg = (2 * y) > Q
    if compress:
        out = bytearray(x.to_bytes(32, "little"))
        if neg:
            out[31] |= _NEGATIVE_FLAG
        return bytes(out)
    out = bytearray(x.to_bytes(32, "little") + y.to_bytes(32, "little"))
    if neg:
        out[63] |= _NEGATIVE_FLAG
    return bytes(out)


def g1_from_bytes(data: bytes, compressed: bool = True) -> G1:
    if compressed:
        if len(data) != 32:
            raise InvalidParametersError("compressed G1 must be 32 bytes")
        raw = bytearray(data)
        flags = raw[31] & 0xC0
        raw[31] &= 0x3F
        x = int.from_bytes(raw, "little")
        if flags & _INFINITY_FLAG:
            return G1.zero()
        y2 = (x * x * x + 3) % Q
        y = _fq_sqrt(y2)
        if y is None:
            raise InvalidParametersError("G1 x-coordinate not on curve")
        if bool(flags & _NEGATIVE_FLAG) != ((2 * y) > Q):
            y = (-y) % Q
        return G1(x, y, 1)
    if len(data) != 64:
        raise InvalidParametersError("uncompressed G1 must be 64 bytes")
    raw = bytearray(data)
    flags = raw[63] & 0xC0
    raw[63] &= 0x3F
    if flags & _INFINITY_FLAG:
        return G1.zero()
    x = int.from_bytes(raw[:32], "little")
    y = int.from_bytes(raw[32:], "little")
    p = G1(x, y, 1)
    if not p.is_on_curve():
        raise InvalidParametersError("G1 point not on curve")
    return p


# -- G2 ---------------------------------------------------------------------

def _fq2_to_bytes(c: Fq2) -> bytes:
    return c[0].to_bytes(32, "little") + c[1].to_bytes(32, "little")


def g2_to_bytes(p: G2, compress: bool = True) -> bytes:
    if p.is_zero():
        size = 64 if compress else 128
        out = bytearray(size)
        out[size - 1] |= _INFINITY_FLAG
        return bytes(out)
    x, y = p.to_affine()
    neg = _fq2_is_negative(y)
    if compress:
        out = bytearray(_fq2_to_bytes(x))
        if neg:
            out[63] |= _NEGATIVE_FLAG
        return bytes(out)
    out = bytearray(_fq2_to_bytes(x) + _fq2_to_bytes(y))
    if neg:
        out[127] |= _NEGATIVE_FLAG
    return bytes(out)


def g2_from_bytes(data: bytes, compressed: bool = True) -> G2:
    from ..field.g2 import B2

    if compressed:
        if len(data) != 64:
            raise InvalidParametersError("compressed G2 must be 64 bytes")
        raw = bytearray(data)
        flags = raw[63] & 0xC0
        raw[63] &= 0x3F
        if flags & _INFINITY_FLAG:
            return G2.zero()
        x = (int.from_bytes(raw[:32], "little"), int.from_bytes(raw[32:], "little"))
        y2 = fq2_mul(fq2_square(x), x)
        y2 = ((y2[0] + B2[0]) % Q, (y2[1] + B2[1]) % Q)
        y = _fq2_sqrt(y2)
        if y is None:
            raise InvalidParametersError("G2 x-coordinate not on curve")
        if bool(flags & _NEGATIVE_FLAG) != _fq2_is_negative(y):
            y = fq2_neg(y)
        return G2(x, y)
    if len(data) != 128:
        raise InvalidParametersError("uncompressed G2 must be 128 bytes")
    raw = bytearray(data)
    flags = raw[127] & 0xC0
    raw[127] &= 0x3F
    if flags & _INFINITY_FLAG:
        return G2.zero()
    x = (int.from_bytes(raw[:32], "little"), int.from_bytes(raw[32:64], "little"))
    y = (int.from_bytes(raw[64:96], "little"), int.from_bytes(raw[96:], "little"))
    p = G2(x, y)
    if not p.is_on_curve():
        raise InvalidParametersError("G2 point not on curve")
    return p


# -- framed containers ------------------------------------------------------

def write_fr_vec(xs: List[Fr]) -> bytes:
    return struct.pack("<Q", len(xs)) + b"".join(x.to_bytes_le() for x in xs)


def read_fr_vec(data: bytes, offset: int) -> Tuple[List[Fr], int]:
    (n,) = struct.unpack_from("<Q", data, offset)
    offset += 8
    if offset + 32 * n > len(data):
        raise InvalidParametersError("fr vector length exceeds payload")
    out = []
    for _ in range(n):
        out.append(fr_from_bytes(data[offset:offset + 32]))
        offset += 32
    return out, offset
