"""The port's one field layout: limb-major ``(8, N)`` int32 tensors.

Each lane holds an element of BN254's scalar field Fr or base field Fq as
eight 32-bit little-endian limbs (CUDA reads them as ``uint32``), in
Montgomery form with R = 2^256, lazily reduced into [0, 2p).  4p < 2^256
holds for both primes, so CIOS keeps [0, 2p) closed and add/sub reduce
once against 2p; zero has the two representations 0 and p.  A
``FieldSpec`` carries one field's constants; every function here takes
one and defaults to Fr.

The JAX package uses 22 x 12-bit limbs with R = 2^264 (``tnsh.field.
limbs``), a layout shaped by the TPU's int32 vector unit.  The port keeps
a single layout so a kernel and its plain PyTorch version take the same
tensors; ``from_jax_planes`` / ``to_jax_planes`` convert between the two
so tests can feed both packages the same state: field tables, curve
points (``points_from_jax_planes`` / ``points_to_jax_planes``) and MSM
accumulators.

Packing never loops over limbs in Python: canonical 32-byte LE words come
straight from an ``FrTable``, from bytes, or from a vectorized encoding of
small ints, are read with ``np.frombuffer('<u4')`` and converted to
Montgomery form on the tensor's device (``fr_kernels.mont_mul_chain``
with y = R^2 mod p).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .fq import Q
from .fr import MODULUS

#: Limb width in bits and limb count (8 * 32 = 256 bits).
LIMB_BITS = 32
NUM_LIMBS = 8

#: Montgomery radix of the port's layout.
R = 1 << (LIMB_BITS * NUM_LIMBS)


@dataclass(frozen=True)
class FieldSpec:
    """Constants of one prime field in the port's limb layout."""

    name: str
    modulus: int
    #: -modulus^{-1} mod 2^32 (Montgomery n' of the 32-bit limb base).
    n0: int = field(init=False)
    #: R mod p, R^2 mod p and R^-1 mod p for Montgomery conversion.
    r_mod_p: int = field(init=False)
    r2_mod_p: int = field(init=False)
    r_inv: int = field(init=False)

    def __post_init__(self):
        p = self.modulus
        if 4 * p >= R:
            raise ValueError("the lazy [0, 2p) domain needs 4p < 2^256")
        object.__setattr__(self, "n0", (-pow(p, -1, 1 << LIMB_BITS))
                           % (1 << LIMB_BITS))
        object.__setattr__(self, "r_mod_p", R % p)
        object.__setattr__(self, "r2_mod_p", R * R % p)
        object.__setattr__(self, "r_inv", pow(R, -1, p))


FR_SPEC = FieldSpec("fr", MODULUS)
FQ_SPEC = FieldSpec("fq", Q)

#: Fr's constants under their first names (the sum-check path is Fr only).
R_MOD_P = FR_SPEC.r_mod_p
R2_MOD_P = FR_SPEC.r2_mod_p
R_INV = FR_SPEC.r_inv

#: The JAX package's radix (22 x 12-bit limbs).
_JAX_LIMB_BITS = 12
_JAX_NUM_LIMBS = 22
_JAX_R = 1 << (_JAX_LIMB_BITS * _JAX_NUM_LIMBS)


def int_to_words(value: int) -> List[int]:
    """Little-endian 32-bit limbs of a raw (already encoded) value."""
    return [(value >> (LIMB_BITS * i)) & 0xFFFFFFFF for i in range(NUM_LIMBS)]


def le_bytes(values, spec: FieldSpec = FR_SPEC) -> bytes:
    """Canonical 32-byte little-endian words of a sequence of field values.

    ``FrTable`` and bytes pass through untouched; boolean and unsigned
    numpy arrays and machine-word ints take a vectorized numpy path;
    anything else is reduced mod p element by element (exact)."""
    if isinstance(values, (bytes, bytearray, memoryview)):
        return bytes(values)
    raw = getattr(values, "raw", None)  # tnsh.field.fr.FrTable
    if raw is not None:
        return raw
    if isinstance(values, np.ndarray) and values.dtype.kind in "bu":
        arr = values
    else:
        if isinstance(values, np.ndarray):
            values = values.tolist()  # numpy would wrap a negative value
        try:
            arr = np.fromiter(values, dtype=np.uint64, count=len(values))
        except (OverflowError, ValueError, TypeError):
            return b"".join((int(v) % spec.modulus).to_bytes(32, "little")
                            for v in values)
    out = np.zeros((len(arr), 4), dtype="<u8")
    out[:, 0] = arr  # < 2^64 < p: already canonical
    return out.tobytes()


def canonical_words(values, spec: FieldSpec = FR_SPEC) -> np.ndarray:
    """``(8, N)`` int32 limb planes of canonical values (NOT Montgomery)."""
    raw = le_bytes(values, spec)
    words = np.frombuffer(raw, dtype="<u4").reshape(-1, NUM_LIMBS)
    return words.T.copy().view(np.int32)


def pack(values, device, spec: FieldSpec = FR_SPEC) -> torch.Tensor:
    """Field values -> ``(8, N)`` Montgomery tensor on ``device``.

    The canonical words travel to the device once; the Montgomery
    conversion (x * R^2 * R^-1) runs there, through the field's kernel on
    a CUDA device and the plain version on the CPU."""
    words = torch.from_numpy(canonical_words(values, spec)).to(device)
    return to_mont(words, spec)


def to_mont(words: torch.Tensor, spec: FieldSpec = FR_SPEC) -> torch.Tensor:
    """Canonical limb planes -> Montgomery form, on the tensor's device."""
    if spec is FR_SPEC:
        from . import fr_kernels

        return fr_kernels.to_mont(words)
    if spec is FQ_SPEC:
        from . import fq_kernels

        return fq_kernels.to_mont(words)
    raise ValueError(f"no kernels for field {spec.name!r}")


def mont_words(value, spec: FieldSpec = FR_SPEC) -> List[int]:
    """Montgomery-form limbs of one field element, as host ints."""
    return int_to_words(int(value) % spec.modulus * spec.r_mod_p
                        % spec.modulus)


def raw_planes(value: int, device) -> torch.Tensor:
    """A raw 256-bit value (no encoding) as ``(8, 1)`` int32 planes."""
    words = np.asarray(int_to_words(value), dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words.reshape(NUM_LIMBS, 1).copy()).to(device)


def scalar(value, device, spec: FieldSpec = FR_SPEC) -> torch.Tensor:
    """One field element as an ``(8, 1)`` Montgomery tensor (host encode)."""
    return raw_planes(int(value) % spec.modulus * spec.r_mod_p
                      % spec.modulus, device)


def raw_ints(t: torch.Tensor) -> List[int]:
    """Raw limb integers of an ``(8, N)`` tensor, one per lane (no
    Montgomery conversion, no reduction)."""
    if t.dim() != 2 or t.shape[0] != NUM_LIMBS:
        raise ValueError(f"expected (8, N) limb planes, got {tuple(t.shape)}")
    words = np.ascontiguousarray(
        t.detach().to("cpu").numpy().view(np.uint32).T)
    raw = words.astype("<u4").tobytes()
    return [int.from_bytes(raw[32 * j:32 * j + 32], "little")
            for j in range(words.shape[0])]


def unpack(t: torch.Tensor, spec: FieldSpec = FR_SPEC) -> List[int]:
    """``(8, N)`` Montgomery tensor -> canonical ints in [0, p)."""
    return [v * spec.r_inv % spec.modulus for v in raw_ints(t)]


def from_jax_planes(planes, spec: FieldSpec = FR_SPEC) -> np.ndarray:
    """JAX ``(22, N)`` R=2^264 planes (lazy [0, 2p) allowed) -> the port's
    ``(8, N)`` int32 Montgomery words (R=2^256, canonical), value for
    value."""
    planes = np.asarray(planes)
    p = spec.modulus
    shift = pow(1 << (_JAX_LIMB_BITS * _JAX_NUM_LIMBS - LIMB_BITS
                      * NUM_LIMBS), -1, p)  # 2^-8: R264 -> R256
    vals = []
    for j in range(planes.shape[1]):
        v = 0
        for i in range(_JAX_NUM_LIMBS):
            v += int(planes[i, j]) << (_JAX_LIMB_BITS * i)
        vals.append(v * shift % p)
    if not vals:
        return np.zeros((NUM_LIMBS, 0), dtype=np.int32)
    return canonical_words(
        b"".join(v.to_bytes(32, "little") for v in vals))


def to_jax_planes(words, spec: FieldSpec = FR_SPEC) -> np.ndarray:
    """The port's ``(8, N)`` Montgomery words -> JAX ``(22, N)`` int32
    planes (R=2^264, canonical), as ``tnsh.field.limbs.pack_ints`` would
    pack the same values."""
    if isinstance(words, torch.Tensor):
        t = words
    else:
        t = torch.from_numpy(np.asarray(words, dtype=np.int32))
    out = np.zeros((_JAX_NUM_LIMBS, t.shape[1]), dtype=np.int32)
    mask = (1 << _JAX_LIMB_BITS) - 1
    for j, v in enumerate(unpack(t, spec)):
        v = v * _JAX_R % spec.modulus
        for i in range(_JAX_NUM_LIMBS):
            out[i, j] = (v >> (_JAX_LIMB_BITS * i)) & mask
    return out


def points_from_jax_planes(coords: Sequence) -> Tuple[np.ndarray, ...]:
    """Curve points in the JAX layout -- affine ``(x, y)`` or Jacobian
    ``(X, Y, Z)``, each ``(22, N)`` Fq planes -- to the port's ``(8, N)``
    Fq words, coordinate by coordinate through canonical values.  Bases,
    bucket accumulators and window sums all travel this way."""
    return tuple(from_jax_planes(c, FQ_SPEC) for c in coords)


def points_to_jax_planes(coords: Sequence) -> Tuple[np.ndarray, ...]:
    """The inverse of ``points_from_jax_planes``."""
    return tuple(to_jax_planes(c, FQ_SPEC) for c in coords)
