"""The committed columns of the bit-column provers, made once a prove.

``BitColumns`` is the one record of a TwistBits or Shout prove's committed
columns.  Its builders run in the stage ``simulate``: ``from_trace`` walks
a ``MemoryTrace`` once, keeping one address a cycle, the write flags and
the value columns rv, wv and ic; ``from_lookups`` takes a ``LookupTable``'s
indices and looked-up values (the read side only).  Padding cycles read
cell 0 at address 0.

``marshal`` then makes every committed column's canonical 32-byte words
once, as ``FrTable``s in the provers' column order (rb_0 .. rb_{log K-1},
wb_0 .. wb_{log K-1}, ot, rv, wv, ic for TwistBits; rb_0 .. rb_{log K-1},
rv for the Shout provers): the bit columns are shifts of the address
arrays, ot is the flags, and all go through ``limbs.le_bytes``.  The
commitments, the k phase (native or Python), the j stack, phase B, the
dense cube and the openings read these arrays and words; none of them
converts a column again.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..errors import InvalidParametersError
from ..field import limbs
from ..field.fr import MODULUS, FrTable
from ..utils.profiling import span
from .sound import _next_power_of_two

_P = MODULUS


def padded_table(table_entries: Sequence) -> Tuple[List[int], int]:
    """(entries padded with zeros to K = 2^log_k, log_k >= 1)."""
    entries = [int(e) % _P for e in table_entries]
    if not entries:
        raise InvalidParametersError("ShoutBits needs a non-empty table")
    log_k = max(_next_power_of_two(len(entries)).bit_length() - 1, 1)
    return entries + [0] * ((1 << log_k) - len(entries)), log_k


def _address_rows(addr: np.ndarray, log_k: int) -> List[np.ndarray]:
    """Bit i of every address, one boolean row a bit."""
    return [((addr >> i) & 1).astype(np.bool_) for i in range(log_k)]


@dataclass
class BitColumns:
    """A bit-column prove's committed columns (see the module docstring).

    ``write_addr`` and ``write_flags`` are None for lookups.  ``columns``
    is empty until ``marshal`` runs; ``ot``, ``rv``, ``wv`` and ``ic`` are
    its value columns' words then."""

    log_k: int
    log_t: int
    #: ``(T,)`` int64: the cycle's read address, 0 on a write
    read_addr: np.ndarray
    #: ``(T,)`` int64: the cycle's write address, 0 on a read
    write_addr: Optional[np.ndarray]
    #: ``(T,)`` bool: the cycle writes
    write_flags: Optional[np.ndarray]
    #: the value columns as canonical ints: rv, wv, ic, or rv alone
    values: List[List[int]]
    #: every committed column's words, in column order
    columns: List[FrTable] = field(default_factory=list)

    @classmethod
    def from_trace(cls, trace) -> "BitColumns":
        """TwistBits' columns of ``trace`` by honest simulation."""
        k_size = trace.memory_size
        log_k = k_size.bit_length() - 1
        if (1 << log_k) != k_size or log_k < 1:
            raise InvalidParametersError("memory size must be a power of 2")
        ops = list(trace.operations)
        n = len(ops)
        t_size = _next_power_of_two(max(n, 1))
        addr = np.zeros(t_size, dtype=np.int64)
        flags = np.zeros(t_size, dtype=np.bool_)
        addr[:n] = [op.address for op in ops]
        flags[:n] = [op.is_write for op in ops]
        rv, wv, ic = [0] * t_size, [0] * t_size, [0] * t_size
        mem = [0] * k_size
        for j, op in enumerate(ops):
            a = op.address
            if op.is_write:
                v = int(op.value) % _P
                wv[j] = v
                ic[j] = (v - mem[a]) % _P
                mem[a] = v
            else:
                rv[j] = mem[a]
        rv[n:] = [mem[0]] * (t_size - n)  # padding: read cell 0
        return cls(log_k, t_size.bit_length() - 1, np.where(flags, 0, addr),
                   np.where(flags, addr, 0), flags, [rv, wv, ic])

    @classmethod
    def from_lookups(cls, table) -> Tuple[List[int], "BitColumns"]:
        """(the padded entries, the Shout provers' columns of ``table``'s
        lookup log)."""
        entries, log_k = padded_table(table.entries)
        ops = list(table.lookups)
        t_size = _next_power_of_two(max(len(ops), 1))
        idx = np.zeros(t_size, dtype=np.int64)
        idx[:len(ops)] = [op.index for op in ops]
        rv = ([int(op.value) % _P for op in ops]
              + [entries[0]] * (t_size - len(ops)))
        return entries, cls(log_k, t_size.bit_length() - 1, idx, None, None,
                            [rv])

    @functools.cached_property
    def read_bits(self) -> List[np.ndarray]:
        """The rb_i as boolean rows; the same objects on every read."""
        return _address_rows(self.read_addr, self.log_k)

    @functools.cached_property
    def write_bits(self) -> List[np.ndarray]:
        """The wb_i as boolean rows."""
        return _address_rows(self.write_addr, self.log_k)

    def marshal(self) -> List[FrTable]:
        """Every committed column's words, made once under the child span
        ``marshal``."""
        with span("marshal"):
            bits = self.read_bits
            if self.write_flags is not None:
                bits = bits + self.write_bits + [self.write_flags]
            self.columns = [FrTable(limbs.le_bytes(c))
                            for c in bits + self.values]
        return self.columns

    @property
    def ot(self) -> FrTable:
        return self.columns[2 * self.log_k]

    @property
    def rv(self) -> FrTable:
        return self.columns[-len(self.values)]

    @property
    def wv(self) -> FrTable:
        return self.columns[-2]

    @property
    def ic(self) -> FrTable:
        return self.columns[-1]
