"""BN254 scalar field Fr — the ``FieldElement`` of the framework.

Replaces the reference's ``type FieldElement = ark_bn254::Fr`` (reference
src/utils.rs:13-14) and the arkworks ark-ff Montgomery backend (SURVEY §2 D1).

Host-side representation: plain Python integers in *standard* (non-Montgomery)
form, wrapped in an ``int`` subclass so arithmetic operators reduce mod r.
Exact integer arithmetic means every algorithmic re-design downstream
(Newton interpolation instead of O(n^3) Lagrange, fold-based MLE evaluation,
Pippenger MSM) yields bit-identical field values to the reference — algorithmic
freedom without transcript divergence.

The device-side representation (limb planes, Montgomery form) and the
conversion helpers are in ``tnsh_torch.field.limbs``.

arkworks-compat facts encoded here:
  * ``MODULUS`` is the BN254 (alt_bn128) scalar prime r.
  * ``R256 = 2^256 mod r`` is arkworks' Montgomery constant for 4x64-bit limbs;
    ark-ff 0.4's ``Fr::rand`` samples a Montgomery *representation* uniformly
    (see tnsh_torch.core.rng.fr_rand), so converting out requires ``R256_INV``.
  * ``serialize_compressed`` of an Fr is its 32-byte little-endian standard
    form (ark-serialize 0.4; used by the transcript, reference utils.rs:155).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

from ..errors import PolynomialError

#: BN254 / alt_bn128 scalar field modulus r (254 bits).
MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617
MODULUS_BITS = 254

#: arkworks Montgomery constant R = 2^256 mod r and its inverse mod r.
R256 = (1 << 256) % MODULUS
R256_INV = pow(R256, -1, MODULUS)

_P = MODULUS


class Fr(int):
    """A BN254 scalar field element. Immutable; behaves like an int mod r."""

    __slots__ = ()

    def __new__(cls, value: int = 0) -> "Fr":
        return super().__new__(cls, value % _P)

    # -- ring ops ---------------------------------------------------------
    def __add__(self, other: int) -> "Fr":
        return Fr(int.__add__(self, int(other)))

    __radd__ = __add__

    def __sub__(self, other: int) -> "Fr":
        return Fr(int.__sub__(self, int(other)))

    def __rsub__(self, other: int) -> "Fr":
        return Fr(int.__sub__(int(other), self))

    def __mul__(self, other: int) -> "Fr":
        return Fr(int.__mul__(self, int(other)))

    __rmul__ = __mul__

    def __neg__(self) -> "Fr":
        return Fr(int.__neg__(self))

    def __pow__(self, exp: int, mod=None) -> "Fr":  # noqa: ARG002 - mod ignored
        return Fr(pow(int(self), int(exp), _P))

    def __truediv__(self, other: int) -> "Fr":
        return self * Fr(int(other)).inverse()

    def __rtruediv__(self, other: int) -> "Fr":
        return Fr(int(other)) * self.inverse()

    # -- field ops --------------------------------------------------------
    def inverse(self) -> "Fr":
        """Multiplicative inverse; raises on zero (ark panics on unwrap)."""
        if int(self) == 0:
            raise PolynomialError("inverse of zero field element")
        return Fr(pow(int(self), -1, _P))

    def is_zero(self) -> bool:
        return int(self) == 0

    def is_one(self) -> bool:
        return int(self) == 1

    def double(self) -> "Fr":
        return Fr(int(self) << 1)

    def square(self) -> "Fr":
        return Fr(int.__mul__(self, self))

    # -- serialization (ark-serialize compressed == 32B little-endian) ----
    def to_bytes_le(self) -> bytes:
        """ark ``serialize_compressed`` of Fr (reference utils.rs:154-156)."""
        return int(self).to_bytes(32, "little")

    @classmethod
    def from_bytes_le(cls, data: bytes) -> "Fr":
        return cls(int.from_bytes(data, "little"))

    @classmethod
    def from_le_bytes_mod_order(cls, data: bytes) -> "Fr":
        """ark ``Fr::from_le_bytes_mod_order`` (reference commitments.rs:83)."""
        return cls(int.from_bytes(data, "little"))

    # -- Montgomery form (arkworks internal representation) ---------------
    def to_montgomery(self) -> int:
        """The 4x64-limb Montgomery representation arkworks stores internally."""
        return int(self) * R256 % _P

    @classmethod
    def from_montgomery(cls, value: int) -> "Fr":
        return cls(value * R256_INV % _P)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Fr({int(self)})"


ZERO = Fr(0)
ONE = Fr(1)


def zero() -> Fr:
    return ZERO


def one() -> Fr:
    return ONE


# ---------------------------------------------------------------------------
# field_utils — ports of reference utils.rs:207-269 (same API, same math)
# ---------------------------------------------------------------------------

def inner_product(a: Sequence[Fr], b: Sequence[Fr]) -> Fr:
    """Inner product of two equal-length vectors (reference utils.rs:211-214)."""
    if len(a) != len(b):
        raise ValueError("Vector lengths must match")
    return Fr(sum(int(x) * int(y) for x, y in zip(a, b)))


def horner_eval(coeffs: Sequence[Fr], point: Fr) -> Fr:
    """Evaluate Σ c_i x^i at ``point`` by Horner (reference utils.rs:217-221)."""
    acc = 0
    p = int(point)
    for c in reversed(coeffs):
        acc = (acc * p + int(c)) % _P
    return Fr(acc)


def powers(x: Fr, n: int) -> List[Fr]:
    """[1, x, x^2, ..., x^(n-1)] (reference utils.rs:224-234)."""
    out: List[Fr] = []
    cur = 1
    xi = int(x)
    for _ in range(n):
        out.append(Fr(cur))
        cur = cur * xi % _P
    return out


def vanishing_poly_eval(point_set: Iterable[Fr], point: Fr) -> Fr:
    """Z_S(x) = Π_{s in S} (x - s) (reference utils.rs:238-240)."""
    acc = 1
    p = int(point)
    for s in point_set:
        acc = acc * ((p - int(s)) % _P) % _P
    return Fr(acc)


def batch_inverse(elements: Sequence[Fr]) -> List[Fr]:
    """Montgomery's batch-inversion trick (reference utils.rs:243-268).

    Like the reference, assumes all elements are nonzero (the single shared
    inversion raises otherwise).
    """
    n = len(elements)
    if n == 0:
        return []
    acc: List[int] = [int(elements[0])]
    for i in range(1, n):
        acc.append(acc[i - 1] * int(elements[i]) % _P)
    inv = pow(acc[n - 1], -1, _P)
    result: List[Fr] = [ZERO] * n
    for i in range(n - 1, 0, -1):
        result[i] = Fr(inv * acc[i - 1])
        inv = inv * int(elements[i]) % _P
    result[0] = Fr(inv)
    return result


class FrTable:
    """A read-only vector of canonical Fr values backed by raw 32-byte LE
    words — the zero-copy bridge between native table builders
    (``_native.fr_eq_table`` / ``fr_lt_table``) and native table consumers
    (sum-check oracles, MSMs): producers hand over ``raw`` untouched and
    ``limbs.le_bytes`` passes it straight back down.  Quacks like a
    list of ints for the Python fallback paths (len / index / slice /
    iterate); materialize with ``list(table)`` before element-heavy Python
    loops."""

    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        if len(raw) & 31:
            raise ValueError("FrTable raw length must be a multiple of 32")
        self.raw = raw

    def __len__(self) -> int:
        return len(self.raw) >> 5

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step == 1:
                return FrTable(self.raw[32 * start:32 * stop])
            return [self[j] for j in range(start, stop, step)]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("FrTable index out of range")
        return int.from_bytes(self.raw[32 * i:32 * i + 32], "little")

    def __iter__(self):
        raw = self.raw
        for off in range(0, len(raw), 32):
            yield int.from_bytes(raw[off:off + 32], "little")

    def __eq__(self, other):
        if isinstance(other, FrTable):
            return self.raw == other.raw
        if isinstance(other, (list, tuple)):
            return len(other) == len(self) and all(
                int(a) == b for a, b in zip(other, self)
            )
        return NotImplemented

    def __hash__(self):
        return hash(self.raw)
