"""Fiat-Shamir transcript — byte-exact replica of the reference.

Port of ``Transcript`` (reference utils.rs:134-204).  Behavioral contract
(SURVEY caveats 3/3a):

  * ``append_field_element(label, x)`` appends ``label || ser(x)`` to the
    byte state, where ``ser`` is ark compressed Fr serialization (32 bytes
    little-endian standard form) — utils.rs:150-158.
  * ``append_field_elements(label, xs)`` appends the label once, then each
    element's serialization — utils.rs:161-169.
  * ``challenge_field_element(label)`` appends the label, hashes the FULL
    accumulated state with Rust's DefaultHasher (SipHash-1-3, zero keys,
    length-prefixed), tiles the 8-byte digest to a 32-byte seed, reseeds a
    fresh ChaCha20 stream and draws one ark ``Fr::rand`` sample —
    utils.rs:172-192.  The RNG is *reset from scratch on every challenge*.
  * ``challenge_field_elements(label, n)`` derives per-index labels
    ``f"{label}_{i}"`` (utils.rs:195-203).
"""

from __future__ import annotations

import struct
from typing import List, Sequence

from ..field.fr import Fr
from .rng import ChaCha20Rng, default_hasher_hash_bytes, fr_rand

try:  # native digest->seed->Fr::rand kernel (bit-exact twin of the above)
    from .. import _native as _nat
except Exception:  # pragma: no cover - import-time degradation
    _nat = None


class Transcript:
    """Deterministic Fiat-Shamir transcript (reference utils.rs:134-204)."""

    __slots__ = ("_state",)

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("transcript seed must be 32 bytes")
        # The reference stores a ChaCha20Rng(seed) member but never uses it:
        # every challenge reseeds from the hashed state (utils.rs:190), so the
        # seed member is dead state and only the byte state matters.
        self._state = bytearray()

    def append_field_element(self, label: bytes, element: Fr) -> None:
        self._state.extend(label)
        self._state.extend(element.to_bytes_le())

    def append_field_elements(self, label: bytes, elements: Sequence[Fr]) -> None:
        self._state.extend(label)
        for element in elements:
            self._state.extend(element.to_bytes_le())

    def challenge_field_element(self, label: bytes) -> Fr:
        self._state.extend(label)
        if _nat is not None and _nat.available:
            return Fr(_nat.fs_challenge(bytes(self._state)))
        digest = default_hasher_hash_bytes(bytes(self._state))
        seed = struct.pack("<Q", digest) * 4
        rng = ChaCha20Rng.from_seed(seed)
        return fr_rand(rng)

    def challenge_field_elements(self, label: bytes, count: int) -> List[Fr]:
        out: List[Fr] = []
        try:
            base = label.decode("utf-8")
        except UnicodeDecodeError:
            base = "challenge"  # reference: from_utf8(...).unwrap_or("challenge")
        for i in range(count):
            out.append(self.challenge_field_element(f"{base}_{i}".encode()))
        return out

    # -- introspection helpers (not in the reference API) ------------------
    @property
    def state_bytes(self) -> bytes:
        """Current accumulated state — used by golden-transcript tests."""
        return bytes(self._state)
