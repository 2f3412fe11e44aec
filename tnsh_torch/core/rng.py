"""Deterministic randomness replicas: ChaCha20Rng, SipHash-1-3, ark Fr::rand.

This is the bit-exactness-critical layer (SURVEY §7.3 item 1).  The reference
derives every Fiat-Shamir challenge and the whole trusted setup from:

  * ``rand_chacha::ChaCha20Rng`` (v0.3.1) seeded from 32 bytes
    (reference utils.rs:81, utils.rs:144, utils.rs:190, commitments.rs:251),
  * Rust's ``std::collections::hash_map::DefaultHasher`` — SipHash-1-3 with
    both keys zero (reference utils.rs:177-182),
  * ark-ff 0.4.2 ``Fr::rand`` — uniform rejection sampling of the Montgomery
    *representation* (reference utils.rs:84, utils.rs:191).

Semantics reproduced here:

ChaCha20Rng (rand_chacha 0.3.1)
    ``from_seed(seed)`` sets key = seed, 64-bit block counter = 0, 64-bit
    stream (nonce) = 0.  The word stream is the djb-variant ChaCha20 keystream:
    sequential 64-byte blocks, each 16 little-endian u32 words.  rand_core's
    BlockRng consumes that word stream strictly sequentially for ``next_u32``,
    ``next_u64`` (lo word then hi word, straddling block boundaries exactly
    like sequential byte reads) and ``fill_bytes``, so modelling the generator
    as an infinite little-endian byte stream is exact for all access patterns
    used by the reference (which are all word-aligned anyway).

DefaultHasher (Rust std)
    ``SipHasher13::new_with_keys(0, 0)``.  Hashing a ``Vec<u8>`` first writes
    the length as a usize (8 little-endian bytes on 64-bit targets) and then
    the raw bytes, so the digest is ``siphash13(le64(len) || bytes)``.

Fr::rand (ark-ff 0.4.2)
    Samples 4 u64 limbs (least-significant first) via ``next_u64``, masks the
    top limb with ``u64::MAX >> 2`` (shaving 256-254 bits), retries until the
    value is below the modulus, and *interprets the result directly as the
    Montgomery representation*.  The standard-form value is therefore
    ``u * R^{-1} mod r`` with ``R = 2^256 mod r``.
"""

from __future__ import annotations

import struct
from typing import List

from ..field.fr import MODULUS, R256_INV, Fr

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# ChaCha20 block function (djb variant, 64-bit counter + 64-bit nonce)
# ---------------------------------------------------------------------------

def _chacha20_block(key_words: List[int], counter: int, nonce_words=(0, 0)) -> bytes:
    """One 64-byte ChaCha20 block. ``counter`` is the 64-bit block counter."""
    state = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *key_words,
        counter & _MASK32, (counter >> 32) & _MASK32,
        nonce_words[0], nonce_words[1],
    ]
    x = state[:]

    def qr(a: int, b: int, c: int, d: int) -> None:
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] ^= x[a]
        x[d] = ((x[d] << 16) | (x[d] >> 16)) & _MASK32
        x[c] = (x[c] + x[d]) & _MASK32
        x[b] ^= x[c]
        x[b] = ((x[b] << 12) | (x[b] >> 20)) & _MASK32
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] ^= x[a]
        x[d] = ((x[d] << 8) | (x[d] >> 24)) & _MASK32
        x[c] = (x[c] + x[d]) & _MASK32
        x[b] ^= x[c]
        x[b] = ((x[b] << 7) | (x[b] >> 25)) & _MASK32

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    out = [(x[i] + state[i]) & _MASK32 for i in range(16)]
    return struct.pack("<16I", *out)


class ChaCha20Rng:
    """Replica of ``rand_chacha::ChaCha20Rng`` (v0.3.1) for seeded streams."""

    __slots__ = ("_key_words", "_counter", "_buf", "_pos")

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("ChaCha20Rng seed must be 32 bytes")
        self._key_words = list(struct.unpack("<8I", seed))
        self._counter = 0
        self._buf = b""
        self._pos = 0

    @classmethod
    def from_seed(cls, seed: bytes) -> "ChaCha20Rng":
        return cls(seed)

    def _refill(self) -> None:
        self._buf = _chacha20_block(self._key_words, self._counter)
        self._counter += 1
        self._pos = 0

    def next_bytes(self, n: int) -> bytes:
        chunks = []
        while n > 0:
            if self._pos >= len(self._buf):
                self._refill()
            take = min(n, len(self._buf) - self._pos)
            chunks.append(self._buf[self._pos:self._pos + take])
            self._pos += take
            n -= take
        return b"".join(chunks)

    def next_u32(self) -> int:
        return struct.unpack("<I", self.next_bytes(4))[0]

    def next_u64(self) -> int:
        return struct.unpack("<Q", self.next_bytes(8))[0]

    def fill_bytes(self, n: int) -> bytes:
        return self.next_bytes(n)


# ---------------------------------------------------------------------------
# SipHash (Rust DefaultHasher = SipHash-1-3, keys 0)
# ---------------------------------------------------------------------------

def _rotl64(v: int, s: int) -> int:
    return ((v << s) | (v >> (64 - s))) & _MASK64


def siphash(data: bytes, k0: int = 0, k1: int = 0, c_rounds: int = 1,
            d_rounds: int = 3) -> int:
    """SipHash-c-d of ``data``; defaults to SipHash-1-3 (Rust DefaultHasher)."""
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573

    def rounds(n: int) -> None:
        nonlocal v0, v1, v2, v3
        for _ in range(n):
            v0 = (v0 + v1) & _MASK64
            v1 = _rotl64(v1, 13)
            v1 ^= v0
            v0 = _rotl64(v0, 32)
            v2 = (v2 + v3) & _MASK64
            v3 = _rotl64(v3, 16)
            v3 ^= v2
            v0 = (v0 + v3) & _MASK64
            v3 = _rotl64(v3, 21)
            v3 ^= v0
            v2 = (v2 + v1) & _MASK64
            v1 = _rotl64(v1, 17)
            v1 ^= v2
            v2 = _rotl64(v2, 32)

    n_full = len(data) // 8
    for i in range(n_full):
        m = struct.unpack_from("<Q", data, i * 8)[0]
        v3 ^= m
        rounds(c_rounds)
        v0 ^= m

    tail = data[n_full * 8:]
    b = (len(data) & 0xFF) << 56
    b |= int.from_bytes(tail, "little")
    v3 ^= b
    rounds(c_rounds)
    v0 ^= b

    v2 ^= 0xFF
    rounds(d_rounds)
    return (v0 ^ v1 ^ v2 ^ v3) & _MASK64


def default_hasher_hash_bytes(state: bytes) -> int:
    """Digest of ``Vec<u8>::hash(&mut DefaultHasher::new())`` then ``finish()``.

    Rust's ``Hash for [u8]`` writes an 8-byte little-endian length prefix
    (``write_usize`` on 64-bit) followed by the raw bytes
    (reference utils.rs:180-182).
    """
    return siphash(struct.pack("<Q", len(state)) + state)


# ---------------------------------------------------------------------------
# ark-ff 0.4.2 Fr::rand
# ---------------------------------------------------------------------------

_TOP_LIMB_MASK = _MASK64 >> 2  # shave 256 - 254 = 2 bits


def fr_rand(rng: ChaCha20Rng) -> Fr:
    """ark-ff 0.4.2 ``Fr::rand``: rejection-sample a Montgomery representation."""
    while True:
        l0 = rng.next_u64()
        l1 = rng.next_u64()
        l2 = rng.next_u64()
        l3 = rng.next_u64() & _TOP_LIMB_MASK
        u = l0 | (l1 << 64) | (l2 << 128) | (l3 << 192)
        if u < MODULUS:
            return Fr(u * R256_INV % MODULUS)
