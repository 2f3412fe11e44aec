"""Plain PyTorch field ops on the port's ``(8, *batch)`` limb planes, for
BN254's scalar field Fr and base field Fq.

The counterpart of ``tnsh.field.fr_jax.make_field_ops(spec)``:
``make_field_ops`` returns one ``FieldOps`` per ``FieldSpec`` with ``add``,
``sub``, ``neg``, ``mont_mul``, ``to_mont``, ``from_mont``, ``canon``,
``is_zero``, ``select``, ``one`` and ``scalar_const``; ``fr`` and ``fq`` are
the two instances, and the module-level names (``add``, ``mont_mul`` ...)
are Fr's, as the sum-check path uses them.  Values are Montgomery form
with R = 2^256, lazily in [0, 2p) (see ``tnsh_torch.field.limbs``).

These are the plain versions beside the CUDA kernels
(``tnsh_torch.field.fr_kernels``, ``fq_kernels``, ``commit.msm_group``,
``commit.msm_sched``): the CPU path runs them, and the GPU smoke run
holds every kernel against them.  They favour obviousness over speed.

Arithmetic runs on 16-bit sub-limbs held in int64: a 32x32-bit limb
product does not fit signed int64 once accumulated, and torch wraps
integer overflow silently.  CIOS over sixteen 16-bit digits computes the
same integer (a*b + M*p) / 2^256 as CIOS over eight 32-bit limbs (M is
the unique value in [0, 2^256) that makes the sum divisible), so the
plain ops and the kernels agree limb for limb, not only canonically.
"""

from __future__ import annotations

import functools

import torch

from .limbs import FQ_SPEC, FR_SPEC, NUM_LIMBS, FieldSpec, raw_planes

_D = 16                      # sub-limb width
_ND = 2 * NUM_LIMBS          # sub-limbs per element
_DMASK = (1 << _D) - 1


def _digits(value: int):
    return [(value >> (_D * i)) & _DMASK for i in range(_ND)]


def _const(digits, like: torch.Tensor) -> torch.Tensor:
    """A constant as digit planes broadcastable against ``like``."""
    shape = (len(digits),) + (1,) * (like.dim() - 1)
    return torch.tensor(digits, dtype=torch.int64,
                        device=like.device).view(shape)


def _word_const(value: int, like: torch.Tensor) -> torch.Tensor:
    """A raw 256-bit value as int32 limb planes broadcastable against
    ``like``."""
    return raw_planes(value, like.device).view(
        (NUM_LIMBS,) + (1,) * (like.dim() - 1))


def _split(a: torch.Tensor) -> torch.Tensor:
    """(8, *b) int32 limbs -> (16, *b) int64 digits in [0, 2^16)."""
    w = a.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & _DMASK, w >> _D], dim=1).reshape(
        (_ND,) + tuple(a.shape[1:]))


def _join(d: torch.Tensor) -> torch.Tensor:
    """(16, *b) normalized digits -> (8, *b) int32 limbs."""
    w = d[0::2] | (d[1::2] << _D)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _carry(t: torch.Tensor):
    """Propagate carries through digit planes (arithmetic shift, so
    negative digits borrow).  Returns (digits in [0, 2^16), final carry)."""
    out = []
    carry = None
    for k in range(t.shape[0]):
        v = t[k] if carry is None else t[k] + carry
        carry = v >> _D
        out.append(v & _DMASK)
    return torch.stack(out), carry


def _cond_sub(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a - m if a >= m else a, on normalized digit planes."""
    diff, carry = _carry(a - m)
    return torch.where((carry >= 0).unsqueeze(0), diff, a)


class FieldOps:
    """The plain ops of one prime field (``spec``)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        #: -p^{-1} mod 2^16 (Montgomery n' for the 16-bit digit base).
        self._n0 = (-pow(spec.modulus, -1, 1 << _D)) % (1 << _D)
        self._p_d = _digits(spec.modulus)
        self._p2_d = _digits(2 * spec.modulus)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s, _ = _carry(_split(a) + _split(b))  # < 4p < 2^256: no carry out
        return _join(_cond_sub(s, _const(self._p2_d, s)))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        da = _split(a)
        s, _ = _carry(da - _split(b) + _const(self._p2_d, da))
        return _join(_cond_sub(s, _const(self._p2_d, s)))

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        da = _split(a)
        s, _ = _carry(_const(self._p2_d, da) - da)
        return _join(_cond_sub(s, _const(self._p2_d, s)))

    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """CIOS Montgomery multiply: a * b * 2^-256 mod p, inputs and
        output in [0, 2p).  Digit planes are indexed absolutely (step i
        adds a_i * b at digit i), so no shift is materialized; every digit
        stays below 2^38."""
        a, b = torch.broadcast_tensors(a, b)
        da = _split(a)
        db = _split(b)
        p = _const(self._p_d, db)
        t = torch.zeros((2 * _ND + 1,) + tuple(db.shape[1:]),
                        dtype=torch.int64, device=db.device)
        for i in range(_ND):
            t[i:i + _ND] += da[i] * db
            m = (t[i] * self._n0) & _DMASK
            t[i:i + _ND] += m * p
            t[i + 1] += t[i] >> _D
        out, _ = _carry(t[_ND:])  # value < 2p < 2^256: top digit is zero
        return _join(out[:_ND])

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Canonical limbs -> Montgomery form (multiply by R^2)."""
        return self.mont_mul(a, _word_const(self.spec.r2_mod_p, a))

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery form -> limbs of the value, in [0, p]."""
        one = torch.zeros_like(a)
        one[0] = 1
        return self.mont_mul(a, one)

    def canon(self, a: torch.Tensor) -> torch.Tensor:
        """Reduce a [0, 2p) value to canonical [0, p)."""
        d = _split(a)
        return _join(_cond_sub(d, _const(self._p_d, d)))

    def sum_lanes(self, a: torch.Tensor) -> torch.Tensor:
        """Exact field sum over the last axis (a power-of-two length) by a
        halving tree; the axis is kept with length 1."""
        n = a.shape[-1]
        while n > 1:
            n //= 2
            a = self.add(a[..., :n], a[..., n:2 * n])
        return a

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        """Lane mask of zero values; both representations (0 and p)
        count."""
        p = _word_const(self.spec.modulus, a)
        return (a == 0).all(dim=0) | (a == p).all(dim=0)

    @staticmethod
    def select(cond: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        """Per lane: ``a`` where ``cond`` holds, else ``b``."""
        return torch.where(cond.unsqueeze(0), a, b)

    def scalar_const(self, value: int, batch_shape, device) -> torch.Tensor:
        """A field constant in Montgomery form, broadcast over
        ``batch_shape``."""
        v = int(value) % self.spec.modulus * self.spec.r_mod_p \
            % self.spec.modulus
        shape = (NUM_LIMBS,) + tuple(batch_shape)
        planes = raw_planes(v, device).view(
            (NUM_LIMBS,) + (1,) * len(tuple(batch_shape)))
        return planes.expand(shape).contiguous()

    def one(self, batch_shape, device) -> torch.Tensor:
        """The field's one in Montgomery form over ``batch_shape``."""
        return self.scalar_const(1, batch_shape, device)


@functools.lru_cache(maxsize=None)
def make_field_ops(spec: FieldSpec) -> FieldOps:
    return FieldOps(spec)


fr = make_field_ops(FR_SPEC)
fq = make_field_ops(FQ_SPEC)

add = fr.add
sub = fr.sub
neg = fr.neg
mont_mul = fr.mont_mul
to_mont = fr.to_mont
from_mont = fr.from_mont
canon = fr.canon
sum_lanes = fr.sum_lanes
is_zero = fr.is_zero
