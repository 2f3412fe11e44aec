"""Batched G1 arithmetic on limb planes: the port of
``tnsh/commit/msm_jax.py``.

G1 points live in Jacobian coordinates, each coordinate an ``(8, N)``
int32 Fq table in the port's Montgomery layout (``tnsh_torch.field.
limbs``); infinity is Z = 0.  The plain group law is written on the plain
Fq ops (``fr_ops.fq``) formula for formula as the JAX package writes it:
``_pdouble``, ``_padd`` (general add with infinity, inverse and equal
points per lane), ``_padd_mixed`` (affine second operand, no equal-point
branch), ``_padd_mixed_flag`` (which also reports the lanes where the
accumulator equals the incoming point, where the formula is wrong) and
``_padd_mixed_safe`` (which doubles in those lanes: the mixed add of the
scheduled insertion).

``padd`` is the general add as a tensor op, with a hand-written kernel,
``g1_padd_kernel`` in ``tnsh_torch/csrc/msm_kernels.cu``: a CUDA tensor
goes to the kernel or the wrapper raises, a CPU tensor goes to
``padd_plain``.  In the JAX package this stage is XLA code, not a Pallas
kernel; it is a kernel here because one plain Fq product is some hundred
small tensor ops.  It is the route of ``tree_reduce_points`` and of the
level-wise tail (``msm_sched.msm_tail_levelwise``).  The scheduled MSM
itself folds and sums in its tail kernels (``msm_sched.msm_tail``), which
share this kernel's add as a device function, and launches no ``padd``.

The 254-step double-and-add MSM of ``msm_jax._msm_kernel`` and its
``MSMContext`` / ``msm_jax`` API are not written again: an MSM over
explicit points is ``tnsh_torch.commit.kzg.msm(points, scalars, device)``
or a ``tnsh_torch.commit.msm_sched.ScheduledMsmContext``, both served by
the scheduled Pippenger.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import fr_ops, limbs
from ..field.fr_kernels import _on_cuda, _ptr, _raise_on, _stream
from ..field.g1 import G1
from ..field.limbs import FQ_SPEC, NUM_LIMBS

fq = fr_ops.fq

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# The plain group law (branch-free, lane-selected)
# ---------------------------------------------------------------------------

def _pdouble(X, Y, Z) -> Point:
    """2P in Jacobian coords; infinity (Z=0) maps to infinity (Z3=0)."""
    A = fq.mont_mul(X, X)
    Bv = fq.mont_mul(Y, Y)
    XB = fq.add(X, Bv)
    C = fq.mont_mul(Bv, Bv)
    T = fq.mont_mul(XB, XB)
    YZ = fq.mont_mul(Y, Z)
    TAC = fq.sub(fq.sub(T, A), C)
    D = fq.add(TAC, TAC)
    E = fq.add(fq.add(A, A), A)
    F = fq.mont_mul(E, E)
    X3 = fq.sub(F, fq.add(D, D))
    EDX = fq.mont_mul(E, fq.sub(D, X3))
    C2 = fq.add(C, C)
    C4 = fq.add(C2, C2)
    Y3 = fq.sub(EDX, fq.add(C4, C4))
    Z3 = fq.add(YZ, YZ)
    return X3, Y3, Z3


def _padd(X1, Y1, Z1, X2, Y2, Z2) -> Point:
    """P + Q, general Jacobian add; handles infinity, inverse and EQUAL
    points per lane (the tree reductions meet duplicates)."""
    Z1Z1 = fq.mont_mul(Z1, Z1)
    Z2Z2 = fq.mont_mul(Z2, Z2)
    U1 = fq.mont_mul(X1, Z2Z2)
    U2 = fq.mont_mul(X2, Z1Z1)
    S1 = fq.mont_mul(fq.mont_mul(Y1, Z2), Z2Z2)
    S2 = fq.mont_mul(fq.mont_mul(Y2, Z1), Z1Z1)
    H = fq.sub(U2, U1)
    r0 = fq.sub(S2, S1)
    r = fq.add(r0, r0)
    H2 = fq.add(H, H)
    I = fq.mont_mul(H2, H2)
    RR = fq.mont_mul(r, r)
    J = fq.mont_mul(H, I)
    V = fq.mont_mul(U1, I)
    ZZ = fq.mont_mul(Z1, Z2)
    X3 = fq.sub(fq.sub(RR, J), fq.add(V, V))
    RVX = fq.mont_mul(r, fq.sub(V, X3))
    SJ = fq.mont_mul(S1, J)
    ZZH = fq.mont_mul(ZZ, H)
    Y3 = fq.sub(RVX, fq.add(SJ, SJ))
    Z3 = fq.add(ZZH, ZZH)

    p_inf = fq.is_zero(Z1)
    q_inf = fq.is_zero(Z2)
    same_point = fq.is_zero(H) & fq.is_zero(r0) & ~p_inf & ~q_inf

    dX, dY, dZ = _pdouble(X1, Y1, Z1)
    X3 = fq.select(same_point, dX, X3)
    Y3 = fq.select(same_point, dY, Y3)
    Z3 = fq.select(same_point, dZ, Z3)
    X3 = fq.select(p_inf, X2, X3)
    Y3 = fq.select(p_inf, Y2, Y3)
    Z3 = fq.select(p_inf, Z2, Z3)
    q_only = q_inf & ~p_inf
    X3 = fq.select(q_only, X1, X3)
    Y3 = fq.select(q_only, Y1, Y3)
    Z3 = fq.select(q_only, Z1, Z3)
    return X3, Y3, Z3


def _padd_mixed_flag(X1, Y1, Z1, x2, y2, take):
    """Mixed Jacobian+affine add (11 field muls, no doubling branch):
    lanes where ``take`` is false keep the accumulator, an accumulator at
    infinity takes the point.  Also returns the per-lane hazard flag
    'accumulator equals the incoming point', where the formula is wrong."""
    Z1Z1 = fq.mont_mul(Z1, Z1)
    U2 = fq.mont_mul(x2, Z1Z1)
    S2 = fq.mont_mul(fq.mont_mul(y2, Z1), Z1Z1)
    H = fq.sub(U2, X1)
    r0 = fq.sub(S2, Y1)
    r = fq.add(r0, r0)
    H2 = fq.add(H, H)
    I = fq.mont_mul(H2, H2)
    RR = fq.mont_mul(r, r)
    J = fq.mont_mul(H, I)
    V = fq.mont_mul(X1, I)
    X3 = fq.sub(fq.sub(RR, J), fq.add(V, V))
    RVX = fq.mont_mul(r, fq.sub(V, X3))
    SJ = fq.mont_mul(Y1, J)
    Z1H = fq.mont_mul(Z1, H)
    Y3 = fq.sub(RVX, fq.add(SJ, SJ))
    Z3 = fq.add(Z1H, Z1H)

    p_inf = fq.is_zero(Z1)
    one = fq.one(X1.shape[1:], X1.device)
    X3 = fq.select(p_inf, x2, X3)
    Y3 = fq.select(p_inf, y2, Y3)
    Z3 = fq.select(p_inf, one, Z3)

    X3 = fq.select(take, X3, X1)
    Y3 = fq.select(take, Y3, Y1)
    Z3 = fq.select(take, Z3, Z1)
    same = take & fq.is_zero(H) & fq.is_zero(r0) & ~p_inf
    return X3, Y3, Z3, same


def _padd_mixed(X1, Y1, Z1, x2, y2, take) -> Point:
    """P + Q with Q affine (Z2 = 1), NO equal-points branch.  ``take``
    masks lanes."""
    return _padd_mixed_flag(X1, Y1, Z1, x2, y2, take)[:3]


def _padd_mixed_safe_flag(X1, Y1, Z1, x2, y2, take):
    """Mixed add WITH the equal-points branch, for accumulators that can
    coincide with an input point (duplicate or adversarial bases): the
    lanes ``_padd_mixed_flag`` flags double instead.  Also returns the
    flag.  The doubling's products are skipped when no lane is flagged."""
    X3, Y3, Z3, same = _padd_mixed_flag(X1, Y1, Z1, x2, y2, take)
    if bool(same.any()):
        dX, dY, dZ = _pdouble(X1, Y1, Z1)
        X3, Y3, Z3 = (fq.select(same, dX, X3), fq.select(same, dY, Y3),
                      fq.select(same, dZ, Z3))
    return X3, Y3, Z3, same


def _padd_mixed_safe(X1, Y1, Z1, x2, y2, take) -> Point:
    """``_padd_mixed_safe_flag`` without the flag."""
    return _padd_mixed_safe_flag(X1, Y1, Z1, x2, y2, take)[:3]


# ---------------------------------------------------------------------------
# padd: the general add as a tensor op
# ---------------------------------------------------------------------------

def padd_plain(X1, Y1, Z1, X2, Y2, Z2,
               mask: Optional[torch.Tensor] = None) -> Point:
    """``_padd`` where ``mask`` is set (everywhere without a mask), else
    the first operand."""
    X3, Y3, Z3 = _padd(X1, Y1, Z1, X2, Y2, Z2)
    if mask is None:
        return X3, Y3, Z3
    return (fq.select(mask, X3, X1), fq.select(mask, Y3, Y1),
            fq.select(mask, Z3, Z1))


def _check_point_planes(ts: Sequence[torch.Tensor], n: int) -> None:
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 limb planes, got {t.dtype}")
        if tuple(t.shape) != (NUM_LIMBS, n):
            raise ValueError(
                f"expected ({NUM_LIMBS}, {n}) limb planes, got "
                f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("limb planes must be contiguous")


def padd(X1, Y1, Z1, X2, Y2, Z2,
         mask: Optional[torch.Tensor] = None) -> Point:
    """Per lane P1 + P2 (Jacobian, ``(8, N)`` Fq planes each) where the
    ``(N,)`` bool ``mask`` is set, P1 elsewhere; no mask adds every lane.
    One kernel launch on a CUDA device."""
    n = X1.shape[-1]
    planes = (X1, Y1, Z1, X2, Y2, Z2)
    _check_point_planes(planes, n)
    tensors = planes if mask is None else planes + (mask,)
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != (n,):
            raise ValueError(f"mask: expected ({n},) bool, got "
                             f"{tuple(mask.shape)} {mask.dtype}")
        if not mask.is_contiguous():
            raise ValueError("mask must be contiguous")
    if not _on_cuda(*tensors):
        return padd_plain(X1, Y1, Z1, X2, Y2, Z2, mask)
    from .._build import msm_library

    lib = msm_library()
    out = tuple(torch.empty_like(X1) for _ in range(3))
    _raise_on(lib.tnsh_g1_padd(
        *(_ptr(t) for t in planes),
        None if mask is None else _ptr(mask),
        *(_ptr(t) for t in out), n, _stream(X1)), "padd", lib)
    padd.launches += 1
    return out


padd.launches = 0


def tree_reduce_points(X, Y, Z) -> Point:
    """Collapse N Jacobian lanes (a power of two) to lane 0 by masked
    pairwise addition."""
    n = X.shape[-1]
    if n & (n - 1):
        raise ValueError("tree_reduce_points needs a power-of-two lane count")
    lane = torch.arange(n, device=X.device)
    shift = n // 2
    while shift >= 1:
        X, Y, Z = padd(
            X, Y, Z,
            torch.roll(X, -shift, dims=1), torch.roll(Y, -shift, dims=1),
            torch.roll(Z, -shift, dims=1), (lane < shift).contiguous())
        shift //= 2
    return X, Y, Z


# ---------------------------------------------------------------------------
# Host-facing API
# ---------------------------------------------------------------------------

def pack_g1_points(points: Sequence[G1], device
                   ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Affine coordinates as Montgomery ``(8, N)`` Fq planes on ``device``
    plus a host validity mask.  Identity points are marked invalid (they
    contribute nothing to an MSM) and get coordinates 0."""
    n = len(points)
    xs: List[int] = []
    ys: List[int] = []
    valid = np.zeros((n,), dtype=bool)
    for i, p in enumerate(points):
        if p.is_zero():
            xs.append(0)
            ys.append(0)
        else:
            ax, ay = p.to_affine()
            xs.append(ax)
            ys.append(ay)
            valid[i] = True
    return (limbs.pack(xs, device, FQ_SPEC), limbs.pack(ys, device, FQ_SPEC),
            valid)


def jacobian_to_g1(X, Y, Z, lane: int = 0) -> G1:
    """One lane of Jacobian planes as a host ``G1``."""
    xv = limbs.unpack(X[:, lane:lane + 1], FQ_SPEC)[0]
    yv = limbs.unpack(Y[:, lane:lane + 1], FQ_SPEC)[0]
    zv = limbs.unpack(Z[:, lane:lane + 1], FQ_SPEC)[0]
    if zv == 0:
        return G1.zero()
    return G1(xv, yv, zv)
