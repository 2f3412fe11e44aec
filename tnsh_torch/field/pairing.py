"""BN254 optimal ate pairing.

Replaces ``Bn254::pairing`` (reference commitments.rs:224-225, 297-298,
SURVEY §2 D2).  The verifier performs only 2-4 pairings per proof (SURVEY
§7.3 item 4), so this is built for correctness and clarity, not throughput:

  * Fq12 is represented as a flat degree-12 polynomial over Fq modulo
    ``w^12 - 18*w^6 + 82`` (so ``i = w^6 - 9`` embeds Fq2).
  * The twisted G2 point is untwisted into Fq12 coordinates and the Miller
    loop runs with affine line functions, followed by the two Frobenius
    line steps of the optimal ate pairing for BN curves.
  * Final exponentiation is the direct power ``f^((q^12 - 1) / r)``.

The result type is a canonical Fq12 element (tuple of 12 ints); equality of
pairing outputs is tuple equality, matching ark's ``PairingOutput`` equality
check in KZG verification (reference commitments.rs:227).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..field.fr import MODULUS as R_MODULUS
from .fq import Q
from .g1 import G1
from .g2 import G2

Fq12 = Tuple[int, ...]

#: w^12 = 18 w^6 - 82  (monic modulus polynomial, low-degree coeffs first).
_MOD_COEFFS = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)

FQ12_ZERO: Fq12 = (0,) * 12
FQ12_ONE: Fq12 = (1,) + (0,) * 11

#: 6u + 2 for BN254 — the optimal ate Miller loop count.
ATE_LOOP_COUNT = 29793968203157093288
_LOG_ATE = ATE_LOOP_COUNT.bit_length() - 2  # iterate bits below the MSB

#: Final exponentiation power (q^12 - 1) / r.
FINAL_EXP = (Q**12 - 1) // R_MODULUS


def fq12_add(a: Fq12, b: Fq12) -> Fq12:
    return tuple((x + y) % Q for x, y in zip(a, b))


def fq12_sub(a: Fq12, b: Fq12) -> Fq12:
    return tuple((x - y) % Q for x, y in zip(a, b))


def fq12_neg(a: Fq12) -> Fq12:
    return tuple((-x) % Q for x in a)


def fq12_scalar(a: Fq12, k: int) -> Fq12:
    return tuple(x * k % Q for x in a)


def fq12_mul(a: Fq12, b: Fq12) -> Fq12:
    c = [0] * 23
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                c[i + j] += ai * bj
    for d in range(22, 11, -1):
        cd = c[d]
        if cd:
            c[d - 6] += 18 * cd
            c[d - 12] -= 82 * cd
            c[d] = 0
    return tuple(x % Q for x in c[:12])


def fq12_square(a: Fq12) -> Fq12:
    return fq12_mul(a, a)


def _deg(p: Sequence[int]) -> int:
    d = len(p) - 1
    while d and p[d] == 0:
        d -= 1
    return d


def _poly_rounded_div(a: Sequence[int], b: Sequence[int]) -> List[int]:
    dega, degb = _deg(a), _deg(b)
    temp = list(a)
    out = [0] * len(a)
    binv = pow(b[degb], -1, Q)
    for i in range(dega - degb, -1, -1):
        out[i] = (out[i] + temp[degb + i] * binv) % Q
        for c in range(degb + 1):
            temp[c + i] = (temp[c + i] - out[i] * b[c]) % Q
    return out[: _deg(out) + 1]


def fq12_inv(a: Fq12) -> Fq12:
    """Inverse by the extended Euclidean algorithm over Fq[w]."""
    lm, hm = [1] + [0] * 12, [0] * 13
    low = list(a) + [0]
    high = [c % Q for c in _MOD_COEFFS] + [1]
    while _deg(low):
        r = _poly_rounded_div(high, low)
        r += [0] * (13 - len(r))
        nm = hm[:]
        new = high[:]
        for i in range(13):
            for j in range(13 - i):
                nm[i + j] = (nm[i + j] - lm[i] * r[j]) % Q
                new[i + j] = (new[i + j] - low[i] * r[j]) % Q
        lm, low, hm, high = nm, new, lm, low
    inv0 = pow(low[0], -1, Q)
    return tuple(c * inv0 % Q for c in lm[:12])


def fq12_pow(a: Fq12, e: int) -> Fq12:
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_mul(base, base)
        e >>= 1
    return result


# ---------------------------------------------------------------------------
# Untwist: embed G1/G2 points into E(Fq12)
# ---------------------------------------------------------------------------

_Pt = Tuple[Fq12, Fq12]  # affine point over Fq12, or None for infinity


def _embed_fq(x: int) -> Fq12:
    return (x % Q,) + (0,) * 11


def _embed_fq2(c: Tuple[int, int]) -> Fq12:
    """Fq2 element c0 + c1*i with i = w^6 - 9 -> (c0 - 9 c1) + c1 w^6."""
    out = [0] * 12
    out[0] = (c[0] - 9 * c[1]) % Q
    out[6] = c[1] % Q
    return tuple(out)


_W2: Fq12 = tuple(1 if i == 2 else 0 for i in range(12))
_W3: Fq12 = tuple(1 if i == 3 else 0 for i in range(12))


def _twist(q_pt: G2) -> _Pt:
    """Map an affine G2 point to the curve y^2 = x^3 + 3 over Fq12."""
    (x, y) = q_pt.to_affine()
    nx = fq12_mul(_embed_fq2(x), fq12_mul(_W2, FQ12_ONE))
    ny = fq12_mul(_embed_fq2(y), fq12_mul(_W3, FQ12_ONE))
    return (nx, ny)


def _cast_g1(p: G1) -> _Pt:
    x, y = p.to_affine()
    return (_embed_fq(x), _embed_fq(y))


# ---------------------------------------------------------------------------
# Miller loop with affine line functions
# ---------------------------------------------------------------------------

def _pt_double(p: _Pt) -> _Pt:
    x, y = p
    m = fq12_mul(fq12_scalar(fq12_mul(x, x), 3), fq12_inv(fq12_scalar(y, 2)))
    nx = fq12_sub(fq12_mul(m, m), fq12_scalar(x, 2))
    ny = fq12_sub(fq12_mul(m, fq12_sub(x, nx)), y)
    return (nx, ny)


def _pt_add(p1: _Pt, p2: _Pt) -> _Pt:
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _pt_double(p1)
    m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
    nx = fq12_sub(fq12_sub(fq12_mul(m, m), x1), x2)
    ny = fq12_sub(fq12_mul(m, fq12_sub(x1, nx)), y1)
    return (nx, ny)


def _linefunc(p1: _Pt, p2: _Pt, t: _Pt) -> Fq12:
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    if y1 == y2:
        m = fq12_mul(fq12_scalar(fq12_mul(x1, x1), 3), fq12_inv(fq12_scalar(y1, 2)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    return fq12_sub(xt, x1)


def _frobenius_pt(p: _Pt) -> _Pt:
    return (fq12_pow(p[0], Q), fq12_pow(p[1], Q))


def miller_loop(q_pt: _Pt, p_pt: _Pt) -> Fq12:
    r_pt = q_pt
    f = FQ12_ONE
    for i in range(_LOG_ATE, -1, -1):
        f = fq12_mul(fq12_mul(f, f), _linefunc(r_pt, r_pt, p_pt))
        r_pt = _pt_double(r_pt)
        if ATE_LOOP_COUNT & (1 << i):
            f = fq12_mul(f, _linefunc(r_pt, q_pt, p_pt))
            r_pt = _pt_add(r_pt, q_pt)
    q1 = _frobenius_pt(q_pt)
    nq2 = _frobenius_pt(q1)
    nq2 = (nq2[0], fq12_neg(nq2[1]))
    f = fq12_mul(f, _linefunc(r_pt, q1, p_pt))
    r_pt = _pt_add(r_pt, q1)
    f = fq12_mul(f, _linefunc(r_pt, nq2, p_pt))
    return f


def final_exponentiate(f: Fq12) -> Fq12:
    return fq12_pow(f, FINAL_EXP)


def pairing(p: G1, q: G2) -> Fq12:
    """e(P, Q) in GT; identity inputs map to 1 (ark pairing convention)."""
    if p.is_zero() or q.is_zero():
        return FQ12_ONE
    return final_exponentiate(miller_loop(_twist(q), _cast_g1(p)))


def pairing_product_is_one(pairs: Sequence[Tuple[G1, G2]]) -> bool:
    """Π e(P_i, Q_i) == 1, with a single shared final exponentiation."""
    f = FQ12_ONE
    for p, q in pairs:
        if p.is_zero() or q.is_zero():
            continue
        f = fq12_mul(f, miller_loop(_twist(q), _cast_g1(p)))
    return final_exponentiate(f) == FQ12_ONE
