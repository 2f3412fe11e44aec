"""The Fiat-Shamir transcript of the provers, from its definition: a byte
state of labels and 32-byte little-endian field elements; a challenge
appends its label, hashes the whole state with SipHash-1-3 (zero keys, the
length first, as Rust's DefaultHasher hashes a Vec<u8>), seeds a fresh
ChaCha20 stream with the 8-byte digest four times over, and draws one
element as ark's Fr::rand does."""

from __future__ import annotations

import struct
from typing import List

from .curve import P, R256_INV, fr_bytes

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def _chacha20_block(key: List[int], counter: int) -> bytes:
    state = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574, *key,
             counter & _M32, counter >> 32, 0, 0]
    x = state[:]

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _M32
        x[d] ^= x[a]
        x[d] = ((x[d] << 16) | (x[d] >> 16)) & _M32
        x[c] = (x[c] + x[d]) & _M32
        x[b] ^= x[c]
        x[b] = ((x[b] << 12) | (x[b] >> 20)) & _M32
        x[a] = (x[a] + x[b]) & _M32
        x[d] ^= x[a]
        x[d] = ((x[d] << 8) | (x[d] >> 24)) & _M32
        x[c] = (x[c] + x[d]) & _M32
        x[b] ^= x[c]
        x[b] = ((x[b] << 7) | (x[b] >> 25)) & _M32

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return struct.pack("<16I", *[(a + b) & _M32 for a, b in zip(x, state)])


class ChaCha20:
    """rand_chacha's ChaCha20Rng as a byte stream: key = seed, 64-bit block
    counter from 0, stream 0."""

    def __init__(self, seed: bytes):
        self._key = list(struct.unpack("<8I", seed))
        self._counter = 0
        self._buf = b""

    def read(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._buf += _chacha20_block(self._key, self._counter)
            self._counter += 1
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


def fr_rand(rng: ChaCha20) -> int:
    """ark-ff's Fr::rand: four u64 limbs, the top one masked to 62 bits,
    drawn again until below r, then read as a Montgomery form."""
    while True:
        l0, l1, l2, l3 = struct.unpack("<4Q", rng.read(32))
        u = l0 | l1 << 64 | l2 << 128 | (l3 & (_M64 >> 2)) << 192
        if u < P:
            return u * R256_INV % P


def _rotl(v: int, s: int) -> int:
    return ((v << s) | (v >> (64 - s))) & _M64


def siphash13(data: bytes) -> int:
    v0, v1 = 0x736F6D6570736575, 0x646F72616E646F6D
    v2, v3 = 0x6C7967656E657261, 0x7465646279746573

    def rounds(n, v0, v1, v2, v3):
        for _ in range(n):
            v0 = (v0 + v1) & _M64
            v1 = _rotl(v1, 13) ^ v0
            v0 = _rotl(v0, 32)
            v2 = (v2 + v3) & _M64
            v3 = _rotl(v3, 16) ^ v2
            v0 = (v0 + v3) & _M64
            v3 = _rotl(v3, 21) ^ v0
            v2 = (v2 + v1) & _M64
            v1 = _rotl(v1, 17) ^ v2
            v2 = _rotl(v2, 32)
        return v0, v1, v2, v3

    full = len(data) // 8
    for (m,) in struct.iter_unpack("<Q", data[:full * 8]):
        v3 ^= m
        v0, v1, v2, v3 = rounds(1, v0, v1, v2, v3)
        v0 ^= m
    b = (len(data) & 0xFF) << 56 | int.from_bytes(data[full * 8:], "little")
    v3 ^= b
    v0, v1, v2, v3 = rounds(1, v0, v1, v2, v3)
    v0 ^= b
    v2 ^= 0xFF
    v0, v1, v2, v3 = rounds(3, v0, v1, v2, v3)
    return v0 ^ v1 ^ v2 ^ v3


class Transcript:
    def __init__(self):
        self._state = bytearray()

    def append(self, label: bytes, *elements: int) -> None:
        self._state += label
        for e in elements:
            self._state += fr_bytes(e)

    def challenge(self, label: bytes) -> int:
        self._state += label
        state = bytes(self._state)
        digest = siphash13(struct.pack("<Q", len(state)) + state)
        return fr_rand(ChaCha20(struct.pack("<Q", digest) * 4))

    def challenges(self, label: str, count: int) -> List[int]:
        return [self.challenge(f"{label}_{i}".encode()) for i in range(count)]
