"""Shout's lookup log: the port of ``LookupOp`` and ``LookupTable`` from
``tnsh/protocols/shout.py``.

A ``LookupTable`` holds a read-only table and records every lookup made
against it; ``ShoutBits`` and ``ShoutBitsCommitted``
(``tnsh_torch.protocols.twist_bits``) prove that log.  The parity
``Shout`` prover is not ported: it commits with the univariate KZG, which
the port does not have.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..errors import InvalidParametersError
from ..field.fr import Fr


@dataclass(frozen=True)
class LookupOp:
    """A single lookup: index + value observed (reference shout.rs:16-22)."""

    index: int
    value: Fr


class LookupTable:
    """Read-only table with a lookup log (reference shout.rs:24-60)."""

    def __init__(self, entries: List[Fr]):
        self.entries = [Fr(e) for e in entries]
        self.lookups: List[LookupOp] = []

    def lookup(self, index: int) -> Fr:
        if index >= len(self.entries):
            raise InvalidParametersError("Lookup index out of bounds")
        value = self.entries[index]
        self.lookups.append(LookupOp(index, value))
        return value

    def size(self) -> int:
        return len(self.entries)
