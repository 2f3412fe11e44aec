"""Multilinear pieces: eq and lt, evaluation tables, the sum-check's
verification, the deterministic PST SRS's trapdoor and the opening
equation.  Variable 0 is the fastest bit of an index."""

from __future__ import annotations

from typing import List, Sequence, Tuple

from . import curve
from .curve import GENERATOR, P
from .transcript import ChaCha20, Transcript, fr_rand

#: the seed of the deterministic set-up: 32 bytes of 42
SETUP_SEED = bytes([42]) * 32


def srs_taus(num_vars: int) -> List[int]:
    """The trapdoor of the deterministic PST SRS of ``num_vars``
    variables: the first ``num_vars`` draws of Fr::rand from ChaCha20 on
    the set-up seed.  Its basis is [eq(b, tau)]_1, so a column's
    commitment is [col~(tau)]_1."""
    rng = ChaCha20(SETUP_SEED)
    return [fr_rand(rng) for _ in range(num_vars)]


def eq_table(point: Sequence[int]) -> List[int]:
    """[eq(b, point) for b in 0 .. 2^n - 1]."""
    table = [1]
    for r in point:
        hi = [v * r % P for v in table]
        table = [(v - h) % P for v, h in zip(table, hi)] + hi
    return table


def eq_eval(a: Sequence[int], b: Sequence[int]) -> int:
    acc = 1
    for x, y in zip(a, b):
        acc = acc * ((x * y + (1 - x) * (1 - y)) % P) % P
    return acc


def lt_eval(a: Sequence[int], b: Sequence[int]) -> int:
    """The multilinear extension of [int(a) < int(b)], bit i worth 2^i."""
    acc, suffix_eq = 0, 1
    for x, y in zip(reversed(a), reversed(b)):
        acc = (acc + (1 - x) * y % P * suffix_eq) % P
        suffix_eq = suffix_eq * ((x * y + (1 - x) * (1 - y)) % P) % P
    return acc


def chi(r: int, b: int) -> int:
    """The multilinear extension of [k_i = b] at k_i = r, b a field value."""
    return ((1 - r) * (1 - b) + r * b) % P


def mle(table: Sequence[int], point: Sequence[int]) -> int:
    vals = [v % P for v in table]
    for r in point:
        vals = [(vals[2 * i] + r * (vals[2 * i + 1] - vals[2 * i])) % P
                for i in range(len(vals) // 2)]
    return vals[0]


def horner(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def sumcheck(transcript: Transcript, claim: int, rounds: Sequence[Sequence[int]],
             final: int) -> Tuple[List[str], List[int]]:
    """Replay a sum-check whose round messages are coefficient vectors:
    (the names of the checks that failed, the challenges).  Every round is
    checked and every challenge drawn, whatever an earlier round gave."""
    failed, challenges = [], []
    for rd, poly in enumerate(rounds):
        if (horner(poly, 0) + horner(poly, 1)) % P != claim:
            failed.append(f"round_{rd}")
        transcript.append(f"sumcheck_round_{rd}".encode(), *poly)
        c = transcript.challenge(f"sumcheck_challenge_{rd}".encode())
        challenges.append(c)
        claim = horner(poly, c)
    if claim != final:
        failed.append("final_claim")
    return failed, challenges


def rlc(values: Sequence[int], gamma: int) -> int:
    acc, w = 0, 1
    for v in values:
        acc = (acc + w * v) % P
        w = w * gamma % P
    return acc


def opening_holds(taus: Sequence[int], commitment_scalar: int, value: int,
                  point: Sequence[int], quotients: Sequence[bytes]) -> bool:
    """The PST verifier's equation e(C - [v]_1, [1]_2) = prod_i e(Q_i,
    [tau_i - r_i]_2), checked as the G1 equation it is equivalent to:
    [c - v]_1 = sum_i (tau_i - r_i) Q_i, with C = [c]_1.  The opening of
    an n-variable table uses the last n of the SRS's taus."""
    if len(quotients) != len(point):
        return False
    offset = len(taus) - len(point)
    rhs = curve.ZERO
    try:
        for i, q in enumerate(quotients):
            rhs = curve.add(rhs, curve.mul(curve.decompress(q),
                                           taus[offset + i] - point[i]))
    except curve.Malformed:
        return False
    lhs = curve.mul(GENERATOR, commitment_scalar - value)
    return curve.equal_points(lhs, rhs)


def commitment(scalar: int) -> bytes:
    """The compressed bytes of [scalar]_1."""
    return curve.compress(curve.mul(GENERATOR, scalar))
