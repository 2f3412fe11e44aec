"""A reader of the bit-column proofs' wire format (version 3): a 4-byte
magic, a u32 version, then u64 sizes, Fr elements as 32 little-endian
bytes and G1 points compressed to 32 bytes; every count a u64."""

from __future__ import annotations

import struct
from typing import List, Tuple

from .curve import Malformed, fr_read

#: no round count, degree or vector in these proofs comes near this
_MAX_COUNT = 4096


class Reader:
    def __init__(self, data: bytes, magic: bytes):
        if data[:4] != magic or len(data) < 8:
            raise Malformed(f"not a {magic!r} proof")
        if struct.unpack_from("<I", data, 4)[0] != 3:
            raise Malformed("not version 3")
        self.data, self.off = data, 8

    def u64(self) -> int:
        if self.off + 8 > len(self.data):
            raise Malformed("truncated")
        (v,) = struct.unpack_from("<Q", self.data, self.off)
        self.off += 8
        return v

    def count(self) -> int:
        n = self.u64()
        if n > _MAX_COUNT:
            raise Malformed("a count out of range")
        return n

    def fr(self) -> int:
        v = fr_read(self.data, self.off)
        self.off += 32
        return v

    def fr_vec(self) -> List[int]:
        return [self.fr() for _ in range(self.count())]

    def points(self) -> List[bytes]:
        """A u64 count of compressed G1 points, kept as their bytes."""
        n = self.count()
        if self.off + 32 * n > len(self.data):
            raise Malformed("truncated")
        out = [self.data[self.off + 32 * i: self.off + 32 * (i + 1)]
               for i in range(n)]
        self.off += 32 * n
        return out

    def sumcheck(self) -> Tuple[int, List[List[int]], int]:
        """(degree, round polynomials as coefficients, final evaluation)."""
        degree = self.count()
        rounds = [self.fr_vec() for _ in range(self.count())]
        return degree, rounds, self.fr()

    def end(self) -> None:
        if self.off != len(self.data):
            raise Malformed("bytes after the proof")
