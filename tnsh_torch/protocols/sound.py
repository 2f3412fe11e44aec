"""Helpers shared by the verifier-enforced (sound) protocols.

Counterpart of ``tnsh/protocols/sound.py``, holding what the bit-column
prover and verifier call: power-of-two padding, batched MLE evaluation,
the gamma random linear combinations of tables, values and commitments,
and 1/K.  The ``TwistSound`` / ``ShoutSound`` protocols themselves are not
ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

from ..commit.kzg import KZGCommitmentValue
from ..field.fr import MODULUS, Fr
from ..field.g1 import G1

_P = MODULUS


def _next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _mle_eval(table: Sequence, point: Sequence[Fr]) -> Fr:
    """~table(point) by O(2^n) folding (little-endian variable order)."""
    import os

    if len(table) >= 1024 and point and not os.environ.get("TNSH_NO_NATIVE"):
        from .. import _native

        if _native.available:
            value, _ = _native.fr_ml_open(list(table), point)
            return value
    vals = [int(v) % _P for v in table]
    for r in point:
        ri = int(r)
        vals = [
            (vals[2 * i] + ri * (vals[2 * i + 1] - vals[2 * i])) % _P
            for i in range(len(vals) // 2)
        ]
    return Fr(vals[0])



def _rlc_tables(tables: Sequence[Sequence[int]], gamma: int):
    """Pointwise sum_i gamma^i * tables[i] mod p (bytes-backed FrTable on
    the native path; a plain int list otherwise)."""
    import os

    if (len(tables[0]) >= 1024
            and not os.environ.get("TNSH_NO_NATIVE")):
        from .. import _native

        if _native.available:
            from ..field.fr import FrTable

            return FrTable(_native.fr_rlc(tables, gamma))
    out = [int(v) % _P for v in tables[0]]
    w = 1
    for tab in tables[1:]:
        w = w * gamma % _P
        for i, v in enumerate(tab):
            out[i] = (out[i] + w * int(v)) % _P
    return out


def _mle_eval_many(tables: Sequence[Sequence], point: Sequence[Fr]
                   ) -> List[Fr]:
    """[~table(point) for each table] — one native batch call when
    available (the bit-column provers evaluate 2logK+4 columns at once)."""
    import os

    if (tables and len(tables[0]) >= 1024 and point
            and not os.environ.get("TNSH_NO_NATIVE")):
        from .. import _native

        if _native.available:
            return _native.fr_mle_eval_many(tables, point)
    return [Fr(_mle_eval(t, point)) for t in tables]


def _kinv(log_k: int) -> int:
    """1/K mod p — the lift coefficient for column constraints."""
    return pow((1 << log_k) % _P, _P - 2, _P)


def _rlc_values(values: Sequence[Fr], gamma: int) -> int:
    acc = 0
    w = 1
    for v in values:
        acc = (acc + w * int(v)) % _P
        w = w * gamma % _P
    return acc


def _rlc_commitments(
    comms: Sequence[KZGCommitmentValue], gamma: int
) -> KZGCommitmentValue:
    import os

    def smul(p: G1, s: int) -> G1:
        if s == 1:
            return p
        if not os.environ.get("TNSH_NO_NATIVE"):
            from .. import _native

            if _native.available:
                return _native.g1_scalar_mul(p, Fr(s))
        return p.scalar_mul(s)

    acc = comms[0].commitment
    w = 1
    for c in comms[1:]:
        w = w * gamma % _P
        acc = acc.add(smul(c.commitment, w))
    return KZGCommitmentValue(acc)
