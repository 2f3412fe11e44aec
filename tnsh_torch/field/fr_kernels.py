"""The sum-check round's CUDA kernels, each beside its plain PyTorch version.

Counterpart of ``tnsh.field.fr_pallas``.  Every wrapper follows one rule:
a tensor on the CPU goes to the plain version (built from
``tnsh_torch.field.fr_ops``); a tensor on a CUDA device goes to the
hand-written kernel in ``tnsh_torch/csrc/fr_kernels.cu`` or the wrapper
raises.  There is no size gate and no fallback: every round of a proof on
the card runs through the kernels, down to 2-lane tables.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the current stream,
raises if the launch reports an error, and then adds one to its own
``launches`` counter (``launch_counts`` / ``reset_launch_counts``), so a
run can show that its path went through the kernels.

Layouts (``tnsh_torch.field.limbs``): ``(8, N)`` int32 limb planes, and
stacked ``(F, 8, N)`` tables so one launch serves every table of an
oracle.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from . import fr_ops
from .limbs import (
    NUM_LIMBS,
    R2_MOD_P,
    R_MOD_P,
    mont_words,
    raw_planes,
    scalar,
)

L = NUM_LIMBS


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------

def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on any
    other device."""
    kinds = {t.device.type for t in tensors}
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    (kind,) = kinds
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind == "cuda"


def _check_planes(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limb planes, got {t.dtype}")
    if t.dim() < 2 or t.shape[-2] != L:
        raise ValueError(
            f"{name}: expected (..., {L}, N) limb planes, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: limb planes must be contiguous")


def _check_pow2_lanes(t: torch.Tensor, name: str) -> None:
    n = t.shape[-1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"{name}: lane count must be a power of two >= 2, "
                         f"got {n}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(code: int, what: str, lib=None) -> None:
    if code:
        lib = _lib() if lib is None else lib
        msg = lib.tnsh_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _lib():
    from .._build import library

    return library()


# ---------------------------------------------------------------------------
# mont_mul_chain  (replaces tnsh/field/fr_pallas.py _chain_call)
# ---------------------------------------------------------------------------

def chain_plain(ops, x: torch.Tensor, y: torch.Tensor,
                iters: int) -> torch.Tensor:
    """x * y^iters in Montgomery form, by iterated ``ops.mont_mul`` (the
    plain ops of either field)."""
    n = x.shape[-1]
    acc = x.reshape(-1, L, n).transpose(0, 1)  # (8, batch, n)
    yb = y.unsqueeze(1)                          # (8, 1, n or 1)
    for _ in range(iters):
        acc = ops.mont_mul(acc, yb)
    return acc.transpose(0, 1).reshape(x.shape).contiguous()


def check_chain_args(x: torch.Tensor, y: torch.Tensor, iters: int) -> None:
    _check_planes(x, "x")
    _check_planes(y, "y")
    n = x.shape[-1]
    if y.dim() != 2 or y.shape[1] not in (1, n):
        raise ValueError(f"y: expected (8, {n}) or (8, 1), got {tuple(y.shape)}")
    if iters < 0:
        raise ValueError("iters must be non-negative")


def launch_chain(entry, lib, x: torch.Tensor, y: torch.Tensor, iters: int,
                 what: str) -> torch.Tensor:
    """Launch one field's chain kernel (``entry`` is its C function)."""
    n = x.shape[-1]
    out = torch.empty_like(x)
    batch = x.numel() // (L * n) if n else 0
    _raise_on(entry(_ptr(x), _ptr(y), _ptr(out), n, batch, y.shape[1],
                    iters, _stream(x)), what, lib)
    return out


def mont_mul_chain_plain(x: torch.Tensor, y: torch.Tensor,
                         iters: int) -> torch.Tensor:
    """x * y^iters in Fr, by iterated ``fr_ops.mont_mul``."""
    return chain_plain(fr_ops.fr, x, y, iters)


def mont_mul_chain(x: torch.Tensor, y: torch.Tensor,
                   iters: int) -> torch.Tensor:
    """``iters`` back-to-back Montgomery multiplications per lane:
    x * y^iters.  ``x`` is ``(..., 8, n)``; ``y`` is ``(8, n)`` or
    ``(8, 1)`` and broadcasts over x's leading axes (and over lanes when
    it has one).  ``iters = 1`` is the elementwise product."""
    check_chain_args(x, y, iters)
    if not _on_cuda(x, y):
        return mont_mul_chain_plain(x, y, iters)
    lib = _lib()
    out = launch_chain(lib.tnsh_fr_chain, lib, x, y, iters, "mont_mul_chain")
    mont_mul_chain.launches += 1
    return out


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Canonical limbs -> Montgomery form: one chain step by R^2 mod p."""
    return mont_mul_chain(a, raw_planes(R2_MOD_P, a.device), 1)


# ---------------------------------------------------------------------------
# fold  (replaces tnsh/field/fr_pallas.py _fold_call)
# ---------------------------------------------------------------------------

def fold_plain(tables: torch.Tensor, r) -> torch.Tensor:
    """out[f][i] = lo + r (hi - lo) over even/odd lanes, by ``fr_ops``."""
    t = tables.transpose(0, 1)                   # (8, F, N)
    lo, hi = t[..., 0::2], t[..., 1::2]
    rr = scalar(r, tables.device).view(L, 1, 1)
    out = fr_ops.add(lo, fr_ops.mont_mul(rr, fr_ops.sub(hi, lo)))
    return out.transpose(0, 1).contiguous()


def fold(tables: torch.Tensor, r) -> torch.Tensor:
    """Bind variable 0 of every stacked table to the field element ``r``:
    ``(F, 8, N)`` -> ``(F, 8, N/2)``, one launch for all F tables."""
    _check_planes(tables, "tables")
    if tables.dim() != 3:
        raise ValueError(f"tables: expected (F, 8, N), got {tuple(tables.shape)}")
    _check_pow2_lanes(tables, "tables")
    if not _on_cuda(tables):
        return fold_plain(tables, r)
    f, _, n = tables.shape
    out = torch.empty((f, L, n // 2), dtype=torch.int32, device=tables.device)
    r_words = (ctypes.c_uint32 * L)(*mont_words(r))
    _raise_on(_lib().tnsh_fr_fold(_ptr(tables), _ptr(out),
                                  ctypes.cast(r_words, ctypes.c_void_p),
                                  f, n // 2, _stream(tables)),
              "fold")
    fold.launches += 1
    return out


# ---------------------------------------------------------------------------
# round evaluations  (replaces tnsh/field/fr_pallas.py _product_evals_call
# and _sop_evals_call)
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class Terms:
    """CSR descriptor of a sum of products: term t multiplies the stacked
    tables ``idxs[t]``.  ``off`` / ``idx`` are its int32 device copies."""

    idxs: Tuple[Tuple[int, ...], ...]
    off: torch.Tensor
    idx: torch.Tensor

    @property
    def num_tables(self) -> int:
        return 1 + max(max(t) for t in self.idxs)


def terms(term_idxs: Sequence[Sequence[int]], device) -> Terms:
    """Build and validate a term descriptor on ``device``."""
    idxs = tuple(tuple(int(f) for f in t) for t in term_idxs)
    if not idxs or any(not t for t in idxs):
        raise ValueError("a sum of products needs terms of at least one table")
    if min(min(t) for t in idxs) < 0:
        raise ValueError("negative table index")
    off = [0]
    for t in idxs:
        off.append(off[-1] + len(t))
    flat = [f for t in idxs for f in t]
    return Terms(
        idxs,
        torch.tensor(off, dtype=torch.int32).to(device),
        torch.tensor(flat, dtype=torch.int32).to(device),
    )


def round_evals_plain(tables: torch.Tensor, coeffs: torch.Tensor,
                      desc: Terms, npts: int) -> torch.Tensor:
    """[g(0..npts-1)] -> (8, npts), by ``fr_ops``: per table the X-point
    values lo, hi, hi + d, ... are extended incrementally, multiplied per
    term, scaled by the term's coefficient and summed over lanes."""
    t = tables.transpose(0, 1)                   # (8, F, N)
    lo, hi = t[..., 0::2], t[..., 1::2]
    d = fr_ops.sub(hi, lo)
    vals = [lo, hi]
    for _ in range(npts - 2):
        vals.append(fr_ops.add(vals[-1], d))
    v = torch.stack(vals, dim=1)                 # (8, npts, F, half)
    acc = None
    for k, idxs in enumerate(desc.idxs):
        prod = v[:, :, idxs[0]]
        for f in idxs[1:]:
            prod = fr_ops.mont_mul(prod, v[:, :, f])
        prod = fr_ops.mont_mul(coeffs[:, k].reshape(L, 1, 1), prod)
        acc = prod if acc is None else fr_ops.add(acc, prod)
    return fr_ops.sum_lanes(acc).squeeze(-1).contiguous()


def _check_round_args(tables, coeffs, desc, npts) -> None:
    _check_planes(tables, "tables")
    if tables.dim() != 3:
        raise ValueError(f"tables: expected (F, 8, N), got {tuple(tables.shape)}")
    _check_pow2_lanes(tables, "tables")
    _check_planes(coeffs, "coeffs")
    if coeffs.shape != (L, len(desc.idxs)):
        raise ValueError(f"coeffs: expected ({L}, {len(desc.idxs)}), got "
                         f"{tuple(coeffs.shape)}")
    if desc.num_tables > tables.shape[0]:
        raise ValueError("term index beyond the stacked tables")
    if npts < 2:
        raise ValueError("npts must be at least 2")


def _launch_round_evals(tables, coeffs, desc, npts, what) -> torch.Tensor:
    if desc.off.device != tables.device or desc.idx.device != tables.device:
        raise ValueError("term descriptor on another device than the tables")
    lib = _lib()
    half = tables.shape[2] // 2
    nblk = lib.tnsh_fr_round_evals_blocks(half)
    partials = torch.empty((nblk, npts, L), dtype=torch.int32,
                           device=tables.device)
    out = torch.empty((L, npts), dtype=torch.int32, device=tables.device)
    _raise_on(lib.tnsh_fr_round_evals(
        _ptr(tables), half, _ptr(desc.off), _ptr(desc.idx), len(desc.idxs),
        _ptr(coeffs), npts, _ptr(partials), nblk, _ptr(out), _stream(tables),
    ), what)
    return out


def sum_of_products_round_evals(tables: torch.Tensor, coeffs: torch.Tensor,
                                desc: Terms, npts: int) -> torch.Tensor:
    """[g(0..npts-1)] of Σ_t c_t Π_{f∈t} T_f(lo + X (hi - lo)), summed over
    lane pairs: stacked ``(F, 8, N)`` tables, ``(8, T)`` Montgomery
    coefficients, a ``Terms`` descriptor -> ``(8, npts)``."""
    _check_round_args(tables, coeffs, desc, npts)
    if not _on_cuda(tables, coeffs):
        return round_evals_plain(tables, coeffs, desc, npts)
    out = _launch_round_evals(tables, coeffs, desc, npts,
                              "sum_of_products_round_evals")
    sum_of_products_round_evals.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _product_desc(num_tables: int, device: torch.device):
    """One term over ``num_tables`` stacked tables and the coefficient
    one, built once per shape and device."""
    return (raw_planes(R_MOD_P, device),
            terms([range(num_tables)], device))


def _product_term(tables: torch.Tensor, scale):
    """The product of all stacked tables as one term, coefficient scale
    (or one)."""
    one, desc = _product_desc(tables.shape[0], tables.device)
    return (one if scale is None else scale), desc


def product_round_evals_plain(tables: torch.Tensor,
                              scale: torch.Tensor = None) -> torch.Tensor:
    coeff, desc = _product_term(tables, scale)
    return round_evals_plain(tables, coeff, desc, 4)


def product_round_evals(tables: torch.Tensor,
                        scale: torch.Tensor = None) -> torch.Tensor:
    """[g(0..3)] of Π_f (lo_f + X (hi_f - lo_f)) over lane pairs, times an
    optional ``(8, 1)`` scale -> ``(8, 4)``.  The one-term case of the
    round-evaluation kernel; the TPU applied the scale after the sum,
    which is the same value by distributivity."""
    coeff, desc = _product_term(tables, scale)
    _check_round_args(tables, coeff, desc, 4)
    if not _on_cuda(tables, coeff):
        return product_round_evals_plain(tables, scale)
    out = _launch_round_evals(tables, coeff, desc, 4, "product_round_evals")
    product_round_evals.launches += 1
    return out


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

KERNELS = (mont_mul_chain, fold, product_round_evals,
           sum_of_products_round_evals)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
