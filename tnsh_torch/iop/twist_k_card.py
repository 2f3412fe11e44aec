"""TwistBits' k rounds on the card: the route ``TwistBitsSparseOracle``
takes when its prove runs on a CUDA device (``on_card``).

The host engine's ``tbk_round_evals`` walks all T cycles a round, keeping
the buckets B[a] = Σ ic · A^w over the earlier writes by remaining address.
Here that walk is ``fr_kernels.twist_k_round``: T is cut into chunks of
``CHUNK`` cycles, one block a chunk, and each block starts from its
chunk's row of a ``(chunks + 1, 8, nb)`` stack P whose rows hold the
buckets at each chunk's start and whose last row is E, eq(σ_k, ·) folded
over the bound bits.  P is built once, at round 0 (``twist_k_buckets``),
and never again: bucket s of round i + 1 joins buckets 2s and 2s + 1 of
round i, so each bind folds P (and E with it) by one ``fold`` launch,
beside the ``twist_k_bind`` launch that multiplies each cycle's running
χ product A by χ(r_i, its address bit).  A cycle's A is that of its own
address: its read address on a read, its write address on a write.

A round copies back one small tensor, its seven sums (eight at round 0,
the eighth Σ eq1 · rv of the rv lift), and the host finishes it in
Python ints: the write part times α_1, the lift times 2^free, and both
parts extended from their grids (X = 0..2 and 0..3) to the round's
points by forward differences.  The values equal ``tbk_round_evals``'
(exact arithmetic; the tests hold them round by round).

The state reads the j stack's slots of eq1, eq(σ_j), ic, wv and rv, and
the addresses and write flags the j phase reads after it; the oracle
uploads them once, before the first round.  ``free`` drops A, P and E;
the last bind needs neither, so it only frees them.  Each round adds one
to the counter ``k_device_rounds``.
"""

from __future__ import annotations

from typing import List

import torch

from ..field import fr_kernels, limbs
from ..field.fr import MODULUS, Fr
from ..poly.eq import eq_table
from ..utils.profiling import count

_P = MODULUS
L = limbs.NUM_LIMBS

#: cycles a walk block takes: P's rows are T / CHUNK, so P holds
#: (T / CHUNK + 1) K field elements at round 0 (32 MiB at T = 2^20,
#: K = 2^10)
CHUNK = 1024


def on_card(device, log_k: int) -> bool:
    """The k rounds' route: on the card when the prove's device is a CUDA
    device and a round-0 bucket table (K field elements) fits a walk
    block's shared memory; the host engine or the Python k phase
    otherwise."""
    return (torch.device(device).type == "cuda"
            and (1 << log_k) <= fr_kernels.K_MAX_BUCKETS)


def eq_planes(point, out: torch.Tensor) -> None:
    """eq(b, point) over b in {0,1}^n (little-endian: bit m of b meets
    point[m]) into the ``(8, 2^n)`` Montgomery tensor ``out``, on its
    device: the host builds the tables of the low and the high half of
    the point (2^{n/2} entries each), and the card forms every entry as
    one product of the two, eq_lo(b mod 2^h) eq_hi(b >> h), by the chain
    kernel."""
    n = len(point)
    h = n // 2
    dev = out.device
    lo = limbs.pack(eq_table(list(point[:h])), dev)
    hi = limbs.pack(eq_table(list(point[h:])), dev)
    n_lo, n_hi = lo.shape[1], hi.shape[1]
    x = hi.repeat_interleave(n_lo, dim=1)
    y = lo.repeat(1, n_hi)
    out.copy_(fr_kernels.mont_mul_chain(x, y, 1))


def _extend(values: List[int], npts: int) -> List[int]:
    """A polynomial's values at X = 0 .. len(values) - 1, its degree below
    that, extended to X = 0 .. npts - 1 by forward differences."""
    diffs = list(values)
    for lvl in range(1, len(diffs)):
        for m in range(len(diffs) - 1, lvl - 1, -1):
            diffs[m] = (diffs[m] - diffs[m - 1]) % _P
    out = [diffs[0]]
    while len(out) < npts:
        for m in range(len(diffs) - 1):
            diffs[m] = (diffs[m] + diffs[m + 1]) % _P
        out.append(diffs[0])
    return out


class TwistKCard:
    """The k-phase state of one TwistBits prove on its card.

    ``ra``, ``wa`` (int32) and ``flags`` (bool) are the cycles' addresses
    and write flags on the device; ``stack`` the j stack with its eq1,
    eqs, ic, wv and rv slots written (``slots``: ``twist_cube_slots``);
    ``sigma_k``, ``alpha1`` (α^1) and ``kinv`` (1 / K) the prove's."""

    def __init__(self, log_k: int, ra, wa, flags, stack, slots, sigma_k,
                 alpha1: int, kinv: int, npts: int):
        self.log_k = log_k
        self.npts = npts
        self.chunk = min(CHUNK, ra.shape[0])
        self._cols = (ra, wa, flags)
        self._tabs = {name: stack[getattr(slots, name)]
                      for name in ("eq1", "eqs", "ic", "wv", "rv")}
        self._a1 = int(alpha1) % _P
        self._kinv = int(kinv) % _P
        self._eqk = limbs.pack(eq_table(list(sigma_k)), ra.device)
        #: the running χ products, (8, T); None while they are all one
        self.amul = None
        #: the chunk-start buckets with E as the last row
        self.buckets = None
        #: Σ eq1 · rv, read at round 0
        self._rv_sum = None
        self.round = 0

    def round_evals(self) -> List[Fr]:
        ra, wa, flags = self._cols
        tab = self._tabs
        if self.buckets is None:
            self.buckets = fr_kernels.twist_k_buckets(
                ra, wa, flags, self.amul, tab["ic"], self._eqk, self.chunk,
                self.round)
            self._eqk = None
        first = self._rv_sum is None
        sums = limbs.unpack(fr_kernels.twist_k_round(
            ra, wa, flags, self.amul, tab["eq1"], tab["eqs"], tab["ic"],
            tab["wv"], tab["rv"] if first else None, self.buckets,
            self.chunk, self.round))
        if first:
            self._rv_sum = sums[7]
        count("k_device_rounds", 1)
        lift = (-self._kinv * self._rv_sum
                * pow(2, self.log_k - self.round - 1, _P)) % _P
        read = _extend(sums[:3], self.npts)
        write = _extend(sums[3:7], self.npts)
        return [Fr((lift + rd + self._a1 * wr) % _P)
                for rd, wr in zip(read, write)]

    def bind(self, challenge) -> None:
        r = int(challenge) % _P
        if self.round + 1 < self.log_k:
            ra, wa, flags = self._cols
            self.amul = fr_kernels.twist_k_bind(ra, wa, flags, self.amul, r,
                                                self.round)
            self.buckets = fr_kernels.fold(self.buckets, r)
        else:
            self.free()
        self.round += 1

    def free(self) -> None:
        """Drop the k state; the addresses, flags and the j stack stay the
        oracle's."""
        self.amul = self.buckets = self._eqk = None
        self._cols, self._tabs = (), {}
