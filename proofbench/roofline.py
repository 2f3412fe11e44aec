"""The card's peaks and the work of the sum-check kernels, for their
roofline shares.

The byte peak is NVIDIA's published figure for the H100 SXM (3.35 TB/s of
HBM3).  The operation peak is derived, not published: a BN254 Montgomery
product of eight 32-bit limbs (CIOS) is 136 32x32-bit products, the low
and the high half of each an IMAD, and the card issues 132 SMs x 64 IMADs a
clock at the SM clock nvidia-smi reports.

A kernel's least time is the larger of its bytes over the byte peak and
its products over the product peak, each input byte read once and each
output written once.  Its work is counted from the launch's shape and, for
the round evaluations, from ``ROUND_PROGRAMS``: the Montgomery products a
lane pair and point of each prover's round program, frozen here so that
the count reads the same work whatever implements the kernel."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

#: the card's memory rate, bytes a second (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer multiply-adds a clock: 132 SMs x 64 lanes
IMAD_PER_CLOCK = 132 * 64
#: IMADs of one Montgomery product of eight 32-bit limbs (2 x 136)
IMAD_PER_MUL = 2 * 136
#: bytes of a field element in the kernels' limb planes
FR_BYTES = 32

#: (prover, log K) -> {stacked tables F: (points a round, products a lane
#: pair and point)}: TwistBits' j phase (F = 9 + 4 log K, the program of
#: 47 terms) and phase B (one term over 3 + log K tables); ShoutBits' j
#: phase (F = 3 + 2 log K, 22 terms at log K = 10)
ROUND_PROGRAMS: Dict[Tuple[str, int], Dict[int, Tuple[int, int]]] = {
    ("twist_bits", 10): {49: (14, 72), 13: (14, 13)},
    ("shout_bits", 10): {23: (13, 33)},
    ("twist_bits", 3): {21: (7, 30), 6: (7, 6)},
    ("shout_bits", 3): {9: (6, 12)},
}


def least_s(n_bytes: float, n_muls: float, clock_hz: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S,
               n_muls * IMAD_PER_MUL / (IMAD_PER_CLOCK * clock_hz))


def fold_work(f: int, n: int) -> Tuple[float, float]:
    """(bytes, products) of binding one variable of F stacked tables of n
    lanes: each table read once, its half written once, a product an
    output lane."""
    return FR_BYTES * f * (n + n // 2), f * (n // 2)


def round_evals_work(f: int, n: int, npts: int,
                     products: int) -> Tuple[float, float]:
    """(bytes, products) of one round's evaluations over F stacked tables
    of n lanes at npts points: the tables read once and npts values
    written; ``products`` a lane pair and point."""
    return FR_BYTES * (f * n + npts), (n // 2) * npts * products


def fold_least_s(shapes: Dict[tuple, int], clock_hz: float) -> float:
    """Least seconds of every fold launch, by their (F, 8, n) shapes."""
    return sum(c * least_s(*fold_work(s[0], s[2]), clock_hz)
               for s, c in shapes.items())


def round_evals_least_s(shapes: Dict[tuple, int], prover: str, log_k: int,
                        clock_hz: float) -> Optional[float]:
    """Least seconds of every round-evaluation launch, or None where a
    shape has no row in ``ROUND_PROGRAMS``."""
    table = ROUND_PROGRAMS.get((prover, log_k), {})
    total = 0.0
    for s, c in shapes.items():
        if s[0] not in table:
            return None
        npts, products = table[s[0]]
        total += c * least_s(*round_evals_work(s[0], s[2], npts, products),
                             clock_hz)
    return total
