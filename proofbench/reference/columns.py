"""The committed columns of the bit-column provers, simulated from the
input, and their multilinear extensions at a point.

A bit column of an address is an indicator: its extension at a point is a
sum of eq entries over the cycles whose address has that bit set.  So the
cycles are grouped by address once, and at each point the eq table is
summed per address (``_bucket``) and the sums combined by bit: one pass
over the cycles a point instead of one a column."""

from __future__ import annotations

from operator import mul
from typing import Dict, List, Sequence

from .curve import P
from .pst import eq_table


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _group(addrs: Sequence[int], cycles: Sequence[int]) -> Dict[int, List[int]]:
    out: Dict[int, List[int]] = {}
    for a, j in zip(addrs, cycles):
        out.setdefault(a, []).append(j)
    return out


def _bucket(eq: Sequence[int], groups: Dict[int, List[int]]) -> Dict[int, int]:
    return {a: sum([eq[j] for j in js]) % P for a, js in groups.items()}


def _bits(sums: Dict[int, int], log_k: int) -> List[int]:
    return [sum(s for a, s in sums.items() if a >> i & 1) % P
            for i in range(log_k)]


def _dot(eq: Sequence[int], cycles: Sequence[int], vals: Sequence[int]) -> int:
    return sum(map(mul, [eq[j] for j in cycles], vals)) % P


class TwistColumns:
    """rb_0..rb_{logK-1}, wb_0..wb_{logK-1}, ot, rv, wv, ic of a memory
    trace: read and write address bits, the write flag, the value read, the
    value written and the increment (written minus held).  Cycles past the
    trace up to the next power of two read cell 0."""

    def __init__(self, log_k: int, is_write: Sequence[int],
                 addr: Sequence[int], value: Sequence[int]):
        self.log_k = log_k
        self.log_t = _next_pow2(len(addr)).bit_length() - 1
        mem = [0] * (1 << log_k)
        reads, writes, rv, wv, ic = [], [], [], [], []
        raddr, waddr = [], []
        for j, (w, a, v) in enumerate(zip(is_write, addr, value)):
            if w:
                v %= P
                writes.append(j)
                waddr.append(a)
                wv.append(v)
                ic.append((v - mem[a]) % P)
                mem[a] = v
            else:
                reads.append(j)
                raddr.append(a)
                rv.append(mem[a])
        for j in range(len(addr), 1 << self.log_t):
            reads.append(j)
            raddr.append(0)
            rv.append(mem[0])
        self.reads, self.writes = reads, writes
        self.rv, self.wv, self.ic = rv, wv, ic
        self.rgroups = _group(raddr, reads)
        self.wgroups = _group(waddr, writes)

    def at(self, point: Sequence[int]) -> List[int]:
        """Every column's extension at ``point``, in the commitment order."""
        return self.at_eq(eq_table(point))

    def at_eq(self, eq: Sequence[int]) -> List[int]:
        """The same, from the point's eq table."""
        r_sums = _bucket(eq, self.rgroups)
        w_sums = _bucket(eq, self.wgroups)
        return (_bits(r_sums, self.log_k) + _bits(w_sums, self.log_k)
                + [sum(w_sums.values()) % P, _dot(eq, self.reads, self.rv),
                   _dot(eq, self.writes, self.wv),
                   _dot(eq, self.writes, self.ic)])


class ShoutColumns:
    """rb_0..rb_{logK-1}, rv of a lookup log: the looked-up index's bits and
    the entry read.  Cycles past the log up to the next power of two look
    up slot 0."""

    def __init__(self, log_k: int, entries: Sequence[int],
                 index: Sequence[int]):
        self.log_k = log_k
        self.entries = ([e % P for e in entries]
                        + [0] * ((1 << log_k) - len(entries)))
        n = len(index)
        self.log_t = _next_pow2(n).bit_length() - 1
        idx = list(index) + [0] * ((1 << self.log_t) - n)
        self.groups = _group(idx, range(len(idx)))

    def at(self, point: Sequence[int]) -> List[int]:
        return self.at_eq(eq_table(point))

    def at_eq(self, eq: Sequence[int]) -> List[int]:
        sums = _bucket(eq, self.groups)
        rv = sum(self.entries[a] * s for a, s in sums.items()) % P
        return _bits(sums, self.log_k) + [rv]
