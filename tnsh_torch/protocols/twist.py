"""The memory trace that the Twist provers take: ``MemoryOp`` and
``MemoryTrace``.

Counterpart of ``tnsh/protocols/twist.py``, holding the trace types only;
the univariate-KZG ``Twist`` prover is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List

from ..errors import InvalidParametersError
from ..field.fr import Fr


class MemoryOpKind(Enum):
    READ = 0
    WRITE = 1


@dataclass(frozen=True)
class MemoryOp:
    """A single read or write (reference twist.rs:16-20)."""

    kind: MemoryOpKind
    address: int
    value: Fr

    @staticmethod
    def read(address: int, value: Fr) -> "MemoryOp":
        return MemoryOp(MemoryOpKind.READ, address, value)

    @staticmethod
    def write(address: int, value: Fr) -> "MemoryOp":
        return MemoryOp(MemoryOpKind.WRITE, address, value)

    @property
    def is_write(self) -> bool:
        return self.kind is MemoryOpKind.WRITE

    @property
    def is_read(self) -> bool:
        return self.kind is MemoryOpKind.READ


class MemoryTrace:
    """Power-of-two-sized memory with an operation log
    (reference twist.rs:23-72)."""

    def __init__(self, memory_size: int):
        if memory_size <= 0 or memory_size & (memory_size - 1):
            raise AssertionError("Memory size must be power of 2")
        self.memory_size = memory_size
        self.operations: List[MemoryOp] = []
        self._memory: List[Fr] = [Fr(0)] * memory_size

    def write(self, address: int, value: Fr) -> None:
        if address >= self.memory_size:
            raise InvalidParametersError("Address out of bounds")
        value = Fr(value)
        self._memory[address] = value
        self.operations.append(MemoryOp.write(address, value))

    def read(self, address: int) -> Fr:
        if address >= self.memory_size:
            raise InvalidParametersError("Address out of bounds")
        value = self._memory[address]
        self.operations.append(MemoryOp.read(address, value))
        return value
