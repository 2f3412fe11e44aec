"""Equality and less-than multilinear helpers for verifier-enforced
constraints (tnsh extension; used by the sound protocols).

Conventions match the rest of the stack: hypercube index bits are
little-endian (variable 0 = bit 0 = fastest index bit, reference
polynomials.rs:108-122), so a sum-check challenge vector indexes variables
directly.

``lt_eval`` here is the NUMERIC strict less-than MLE (a < b as integers),
i.e. the most-significant differing bit decides.  This differs on purpose
from ``tnsh_torch.poly.lt.LessThanPolynomial``, which reproduces the reference's
little-endian-lexicographic quirk (polynomials.rs:222-239) for parity; the
sound-mode ordering argument needs the real numeric order.
"""

from __future__ import annotations

from typing import List, Sequence

from ..field.fr import MODULUS, Fr

_P = MODULUS


#: Table sizes at or above this build natively (bytes-backed FrTable):
#: the Python doubling loop costs 2*2^n bigint muls plus 32 B/elem
#: marshalling whenever the table feeds a native oracle.
_NATIVE_TABLE_MIN_VARS = 11


def _native_mod():
    from .. import _native

    return _native if _native.available else None


def eq_table(point: Sequence[Fr]):
    """[eq(b, point) for b in {0,1}^n], little-endian bit order.

    Returns a list of ints, or a bytes-backed ``FrTable`` (same values,
    list-like) for large n when the native builder is available."""
    if len(point) >= _NATIVE_TABLE_MIN_VARS:
        native = _native_mod()
        if native is not None:
            from ..field.fr import FrTable

            return FrTable(native.fr_eq_table([int(p) % _P for p in point]))
    table = [1]
    for t in point:  # variable m joins as the SLOWEST bit so far -> bit m
        ti = int(t)
        nt = (1 - ti) % _P
        table = [v * nt % _P for v in table] + [v * ti % _P for v in table]
    return table


def mle_eval(table: Sequence, point: Sequence[Fr]) -> Fr:
    """~table(point) by O(2^n) folding (little-endian variable order)."""
    if len(table) >= 1024 and point:
        native = _native_mod()
        if native is not None:
            value, _ = native.fr_ml_open(list(table), point)
            return value
    vals = [int(v) % _P for v in table]
    for r in point:
        ri = int(r)
        vals = [
            (vals[2 * i] + ri * (vals[2 * i + 1] - vals[2 * i])) % _P
            for i in range(len(vals) // 2)
        ]
    return Fr(vals[0])


def eq_eval(a: Sequence[Fr], b: Sequence[Fr]) -> Fr:
    """eq~(a, b) = prod_i (a_i b_i + (1-a_i)(1-b_i))."""
    if len(a) != len(b):
        raise ValueError("eq_eval arity mismatch")
    acc = 1
    for x, y in zip(a, b):
        xi, yi = int(x), int(y)
        acc = acc * ((xi * yi + (1 - xi) * (1 - yi)) % _P) % _P
    return Fr(acc)


def lt_eval(a: Sequence[Fr], b: Sequence[Fr]) -> Fr:
    """Numeric strict-less-than MLE: multilinear in both arguments,
    agrees with ``int(a) < int(b)`` on Boolean inputs.

    lt(a, b) = sum_i (1-a_i) b_i prod_{l>i} eq(a_l, b_l)   (bit i = 2^i).
    """
    if len(a) != len(b):
        raise ValueError("lt_eval arity mismatch")
    n = len(a)
    acc = 0
    suffix_eq = 1  # prod over l > i of eq(a_l, b_l), built from the top bit
    for i in range(n - 1, -1, -1):
        ai, bi = int(a[i]), int(b[i])
        acc = (acc + (1 - ai) * bi % _P * suffix_eq) % _P
        suffix_eq = suffix_eq * ((ai * bi + (1 - ai) * (1 - bi)) % _P) % _P
    return Fr(acc)


def lt_partial_table(num_vars: int, y: Sequence[Fr]) -> List[int]:
    """[lt~(bits(j), y) for j in 0..2^n-1] in O(2^n) via the recursion

        L_{i+1}(j || 0) = y_i * E_i(j)... built bottom-up over bits.

    Concretely, processing bits from most significant down, maintain for
    each prefix the pair (lt value, eq value); expanding one lower bit
    multiplies eq by eq(bit, y_bit) and adds (1-bit)*y_bit*eq to lt.
    """
    if len(y) != num_vars:
        raise ValueError("lt_partial_table arity mismatch")
    if num_vars >= _NATIVE_TABLE_MIN_VARS:
        native = _native_mod()
        if native is not None:
            from ..field.fr import FrTable

            return FrTable(native.fr_lt_table([int(p) % _P for p in y]))
    # tables indexed by the TOP bits processed so far; start with empty
    lt_tab = [0]
    eq_tab = [1]
    for i in range(num_vars - 1, -1, -1):
        yi = int(y[i])
        nyi = (1 - yi) % _P
        size = len(lt_tab)
        new_lt = [0] * (2 * size)
        new_eq = [0] * (2 * size)
        for j in range(size):
            # bit i = 0: lt += y_i * eq ; eq *= (1 - y_i)
            new_lt[j] = (lt_tab[j] + yi * eq_tab[j]) % _P
            new_eq[j] = eq_tab[j] * nyi % _P
            # bit i = 1: lt unchanged ; eq *= y_i
            new_lt[j + size] = lt_tab[j]
            new_eq[j + size] = eq_tab[j] * yi % _P
        lt_tab, eq_tab = new_lt, new_eq
    # tables are currently indexed with bit i as the SLOWEST-added dimension:
    # after the loop, index layout is (bit_{n-1} ... bit_0) with bit_{n-1}
    # fastest — reverse to little-endian (bit 0 fastest).
    n = num_vars
    out = [0] * (1 << n)
    for j in range(1 << n):
        # j in loop-layout: bit i of the ORIGINAL number sits at position
        # (n-1-i) of j's little-endian bits.
        orig = 0
        for pos in range(n):
            if (j >> pos) & 1:
                orig |= 1 << (n - 1 - pos)
        out[orig] = lt_tab[j]
    return out
