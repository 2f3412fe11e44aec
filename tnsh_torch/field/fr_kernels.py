"""The sum-check round's CUDA kernels, the PST openings' (``rlc``,
``open_level``), TwistBits' j-phase Val scan (``prefix_scan``) and its k
rounds (``twist_k_buckets``, ``twist_k_round``, ``twist_k_bind``), each
beside its plain PyTorch version.

Counterpart of ``tnsh.field.fr_pallas``.  Every wrapper follows one rule:
a tensor on the CPU goes to the plain version (built from
``tnsh_torch.field.fr_ops``); a tensor on a CUDA device goes to the
hand-written kernel in ``tnsh_torch/csrc/fr_kernels.cu`` or the wrapper
raises.  There is no size gate and no fallback: every round of a proof on
the card runs through the kernels, down to 2-lane tables.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the current stream,
raises if the launch reports an error, and then adds one to its own
``launches`` counter and to that of its input's shape in its ``shapes``
(``launch_counts`` / ``launch_shapes`` / ``reset_launch_counts``), so a
run can show that its path went through the kernels, and at which shapes.

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
    _count(mont_mul_chain, x)
    return out


@functools.lru_cache(maxsize=None)
def const_planes(value: int, device: torch.device) -> torch.Tensor:
    """A raw 256-bit constant as ``(8, 1)`` planes, built once per value
    and device (a pageable host-to-device copy otherwise, on every call).
    Read-only: callers never write into it."""
    return raw_planes(value, device)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Canonical limbs -> Montgomery form: one chain step by R^2 mod p."""
    return mont_mul_chain(a, const_planes(R2_MOD_P, a.device), 1)


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
    _count(fold, tables)
    return out


# ---------------------------------------------------------------------------
# the openings' tables: the gamma-RLC and a level of the PST quotients
# (the host engine's fr_rlc and fr_ml_open in the JAX package)
# ---------------------------------------------------------------------------

def rlc_plain(tables: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Σ_f coeffs[f] · tables[f] lane by lane, by ``fr_ops``."""
    acc = None
    for f in range(tables.shape[0]):
        term = fr_ops.mont_mul(coeffs[f].view(L, 1), tables[f])
        acc = term if acc is None else fr_ops.add(acc, term)
    return acc.contiguous()


def rlc(tables: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """The linear combination Σ_f c_f · T_f of ``(F, 8, N)`` stacked
    Montgomery tables, ``coeffs`` an ``(F, 8)`` tensor of Montgomery
    words (c_f in row f) -> ``(8, N)``, one launch."""
    _check_planes(tables, "tables")
    if tables.dim() != 3:
        raise ValueError(f"tables: expected (F, 8, N), got {tuple(tables.shape)}")
    f, _, n = tables.shape
    if (coeffs.dtype != torch.int32 or coeffs.shape != (f, L)
            or not coeffs.is_contiguous()):
        raise ValueError(f"coeffs: expected contiguous int32 ({f}, {L}), got "
                         f"{coeffs.dtype} {tuple(coeffs.shape)}")
    if f < 1:
        raise ValueError("rlc needs at least one table")
    if not _on_cuda(tables, coeffs):
        return rlc_plain(tables, coeffs)
    out = torch.empty((L, n), dtype=torch.int32, device=tables.device)
    _raise_on(_lib().tnsh_fr_rlc(_ptr(tables), _ptr(coeffs), _ptr(out), f, n,
                                 _stream(tables)), "rlc")
    _count(rlc, tables)
    return out


def open_level_plain(table: torch.Tensor, r,
                     quot: torch.Tensor) -> torch.Tensor:
    """``open_level`` by ``fr_ops``."""
    lo, hi = table[:, 0::2], table[:, 1::2]
    d = fr_ops.sub(hi, lo)
    quot.copy_(fr_ops.canon(fr_ops.from_mont(d)).t())
    rr = scalar(r, table.device)
    return fr_ops.add(lo, fr_ops.mont_mul(rr, d)).contiguous()


def open_level(table: torch.Tensor, r, quot: torch.Tensor) -> torch.Tensor:
    """One level of a PST opening of an ``(8, N)`` Montgomery table at
    ``r``: writes the quotient hi - lo of each lane pair, canonical, into
    ``quot`` (``(N/2, 8)``, row-major: the 32-byte little-endian words an
    MSM takes) and returns the folded table lo + r (hi - lo), ``(8, N/2)``
    in Montgomery form."""
    _check_planes(table, "table")
    if table.dim() != 2:
        raise ValueError(f"table: expected (8, N), got {tuple(table.shape)}")
    _check_pow2_lanes(table, "table")
    half = table.shape[1] // 2
    if (quot.dtype != torch.int32 or quot.shape != (half, L)
            or not quot.is_contiguous()):
        raise ValueError(f"quot: expected contiguous int32 ({half}, {L}), got "
                         f"{quot.dtype} {tuple(quot.shape)}")
    if not _on_cuda(table, quot):
        return open_level_plain(table, r, quot)
    out = torch.empty((L, half), dtype=torch.int32, device=table.device)
    r_words = (ctypes.c_uint32 * L)(*mont_words(r))
    _raise_on(_lib().tnsh_fr_open_level(
        _ptr(table), _ptr(out), _ptr(quot),
        ctypes.cast(r_words, ctypes.c_void_p), half, _stream(table)),
        "open_level")
    _count(open_level, table)
    return out


# ---------------------------------------------------------------------------
# the exclusive prefix sum: TwistBits' j-phase Val table (no TPU kernel:
# the JAX package walks the write cycles on the host)
# ---------------------------------------------------------------------------

def scan_weights_plain(values: torch.Tensor, addr: torch.Tensor,
                       flags: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """flags(j) · values(j) · table(addr(j) mod K), lane by lane, by
    ``fr_ops`` (zero where the flag is clear)."""
    idx = (addr & (table.shape[1] - 1)).long()
    w = fr_ops.mont_mul(values, table[:, idx])
    return torch.where(flags.unsqueeze(0), w, torch.zeros_like(w))


def prefix_scan_plain(values: torch.Tensor, out: torch.Tensor,
                      addr: torch.Tensor, flags: torch.Tensor,
                      table: torch.Tensor) -> None:
    """``prefix_scan`` by ``fr_ops``: the weights, then log2 N doubling
    steps of field adds (each lane adds the lane d below it)."""
    x = scan_weights_plain(values, addr, flags, table)
    n, d = x.shape[1], 1
    while d < n:
        x = torch.cat([x[:, :d], fr_ops.add(x[:, d:], x[:, :-d])], dim=1)
        d <<= 1
    out[:, :1] = 0
    out[:, 1:] = x[:, :-1]


def _check_scan_args(values, out, addr, flags, table) -> None:
    for t, name in ((values, "values"), (out, "out"), (table, "table")):
        _check_planes(t, name)
        if t.dim() != 2:
            raise ValueError(f"{name}: expected (8, N), got {tuple(t.shape)}")
    n, k = values.shape[1], table.shape[1]
    if out.shape != values.shape:
        raise ValueError(f"out: expected {tuple(values.shape)}, got "
                         f"{tuple(out.shape)}")
    if addr.dtype != torch.int32 or addr.shape != (n,) or \
            not addr.is_contiguous():
        raise ValueError(f"addr: expected contiguous int32 ({n},), got "
                         f"{addr.dtype} {tuple(addr.shape)}")
    if flags.dtype != torch.bool or flags.shape != (n,) or \
            not flags.is_contiguous():
        raise ValueError(f"flags: expected contiguous bool ({n},), got "
                         f"{flags.dtype} {tuple(flags.shape)}")
    if k < 1 or k & (k - 1):
        raise ValueError(f"table: expected (8, K), K a power of two, got "
                         f"{tuple(table.shape)}")


def prefix_scan(values: torch.Tensor, out: torch.Tensor, addr: torch.Tensor,
                flags: torch.Tensor, table: torch.Tensor) -> None:
    """Write into ``out`` the exclusive prefix sums of the weights
    w(j) = flags(j) · values(j) · table(addr(j) mod K), formed in the
    scan's first pass: out[j] = Σ_{j' < j} w(j'), in [0, 2p).
    ``values`` is an ``(8, N)`` Montgomery table, ``addr`` int32 ``(N,)``,
    ``flags`` bool ``(N,)`` and ``table`` an ``(8, K)`` Montgomery table,
    K a power of two; TwistBits' V~(r_k, j) takes ic, the write addresses,
    the write flags and eq(r_k, .).  One call is three launches on a CUDA
    device (one up to 1024 lanes), counted as one."""
    _check_scan_args(values, out, addr, flags, table)
    if not _on_cuda(values, out, addr, flags, table):
        prefix_scan_plain(values, out, addr, flags, table)
        return
    lib = _lib()
    n = values.shape[1]
    totals = torch.empty((lib.tnsh_fr_prefix_scan_blocks(n), L),
                         dtype=torch.int32, device=values.device)
    _raise_on(lib.tnsh_fr_prefix_scan(
        _ptr(values), _ptr(addr), _ptr(flags), _ptr(table), table.shape[1],
        _ptr(out), _ptr(totals), n, _stream(values)), "prefix_scan", lib)
    _count(prefix_scan, values)


# ---------------------------------------------------------------------------
# TwistBits' k rounds: the chunk-start buckets, a round's sums and the bind
# (the host engine's tbk_round_evals / tbk_bind; no TPU kernel: the JAX
# package walks the cycles on the host)
# ---------------------------------------------------------------------------

#: the sums a k round returns: the read part at X = 0..2, the write part
#: (without alpha) at X = 0..3, and, when rv is given, the sum of eq1 * rv
K_ROUND_SUMS = 8

#: the most buckets a walk block holds in shared memory: (8 nb + 544) words
#: within the kernel's 227 KB (``kMaxWalkShared``)
K_MAX_BUCKETS = 1 << 12


def _k_address(ra, wa, flags, shift: int) -> torch.Tensor:
    """Each cycle's address (its write address on a write, its read
    address on a read) shifted right by ``shift``, as int64."""
    return (torch.where(flags, wa, ra) >> shift).long()


def _fr_prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis, by doubling steps of
    ``fr_ops.add``."""
    n, d = x.shape[-1], 1
    while d < n:
        x = torch.cat([x[..., :d], fr_ops.add(x[..., d:], x[..., :-d])],
                      dim=-1)
        d <<= 1
    return x


def _k_writes(ra, wa, flags, amul, ic, chunk: int, shift: int, nb: int,
              key_of):
    """The writes' weights ic * A sorted by ``key_of(chunk, address,
    cycle)``: (sorted keys, (8, W + 1) exclusive prefix sums of the
    sorted weights)."""
    a = _k_address(ra, wa, flags, shift)
    idx = torch.nonzero(flags).squeeze(1)
    w = ic[:, idx]
    if amul is not None and idx.numel():
        w = fr_ops.mont_mul(w, amul[:, idx])
    key = key_of(idx // chunk, a[idx], idx)
    order = torch.argsort(key, stable=True)
    prefix = _fr_prefix(w[:, order]) if idx.numel() else w
    zero = torch.zeros((L, 1), dtype=torch.int32, device=ic.device)
    return key[order], torch.cat([zero, prefix], dim=1)


def _range_sums(keys, prefix, lo, hi) -> torch.Tensor:
    """Σ of the sorted weights whose keys lie in [lo, hi), lane by lane."""
    return fr_ops.sub(prefix[:, torch.searchsorted(keys, hi)],
                      prefix[:, torch.searchsorted(keys, lo)])


def twist_k_buckets_plain(ra, wa, flags, amul, ic, table: torch.Tensor,
                          chunk: int, shift: int) -> torch.Tensor:
    """``twist_k_buckets`` by ``fr_ops``: the chunks' bucket sums by a sort
    of the writes and a prefix sum, then their exclusive prefix sums over
    the chunks by doubling."""
    t, nb = ra.shape[0], table.shape[1]
    chunks = -(-t // chunk)
    keys, prefix = _k_writes(ra, wa, flags, amul, ic, chunk, shift, nb,
                             lambda c, a, j: c * nb + a)
    grid = torch.arange(chunks * nb + 1, device=ra.device)
    own = _range_sums(keys, prefix, grid[:-1], grid[1:])
    own = own.view(L, chunks, nb).transpose(1, 2)          # (8, nb, chunks)
    before = torch.cat([torch.zeros_like(own[..., :1]),
                        _fr_prefix(own)[..., :-1]], dim=-1)
    return torch.cat([before.permute(2, 0, 1), table.unsqueeze(0)],
                     dim=0).contiguous()


def twist_k_round_plain(ra, wa, flags, amul, eq1, eqs, ic, wv, rv,
                        buckets: torch.Tensor, chunk: int,
                        shift: int) -> torch.Tensor:
    """``twist_k_round`` by ``fr_ops``: every cycle's buckets (its chunk's
    row of ``buckets`` plus the chunk's earlier writes, by a sort of the
    writes and a prefix sum), then the read and write parts at their
    points, summed over the cycles."""
    t, nb = ra.shape[0], buckets.shape[2]
    dev = ra.device
    keys, prefix = _k_writes(ra, wa, flags, amul, ic, chunk, shift, nb,
                             lambda c, a, j: (c * nb + a) * t + j)
    a = _k_address(ra, wa, flags, shift)
    bit = (a & 1).bool().unsqueeze(0)
    j = torch.arange(t, device=dev)
    c = j // chunk

    def bucket(q):
        lo = (c * nb + q) * t
        return fr_ops.add(buckets[c, :, q].t(),
                          _range_sums(keys, prefix, lo, lo + j))

    pair = (a >> 1) << 1
    b0, b1 = bucket(pair), bucket(pair + 1)
    d = fr_ops.sub(b1, b0)

    def with_a(tab):
        return tab if amul is None else fr_ops.mont_mul(tab, amul)

    def chi(x):
        return torch.where(bit, scalar(x, dev), scalar(1 - x, dev))

    def total(mask, term):
        return fr_ops.sum_lanes(
            torch.where(mask.unsqueeze(0), term, torch.zeros_like(term)))

    sums = []
    wr, vp = with_a(eq1), b0
    for x in range(3):
        sums.append(total(~flags,
                          fr_ops.mont_mul(fr_ops.mont_mul(wr, chi(x)), vp)))
        vp = fr_ops.add(vp, d)
    e_tab = buckets[-1]
    e = e_tab[:, pair]
    ed = fr_ops.sub(e_tab[:, pair + 1], e)
    base, v = with_a(eqs), fr_ops.add(fr_ops.sub(ic, wv), b0)
    for x in range(4):
        term = fr_ops.mont_mul(fr_ops.mont_mul(base, chi(x)), e)
        sums.append(total(flags, fr_ops.mont_mul(term, v)))
        e, v = fr_ops.add(e, ed), fr_ops.add(v, d)
    if rv is not None:
        sums.append(fr_ops.sum_lanes(fr_ops.mont_mul(eq1, rv)))
    return torch.cat(sums, dim=1).contiguous()


def twist_k_bind_plain(ra, wa, flags, amul, r, shift: int) -> torch.Tensor:
    """``twist_k_bind`` by ``fr_ops``."""
    bit = ((_k_address(ra, wa, flags, shift) & 1) == 1).unsqueeze(0)
    dev = ra.device
    chi = torch.where(bit, scalar(r, dev), scalar(1 - int(r), dev))
    return (chi if amul is None else fr_ops.mont_mul(amul, chi)).contiguous()


def _check_k_args(ra, wa, flags, amul, tables, buckets=None) -> int:
    """Validate a k launch's cycle columns; returns T."""
    t = ra.shape[0] if ra.dim() == 1 else -1
    for x, name in ((ra, "ra"), (wa, "wa")):
        if x.dtype != torch.int32 or x.shape != (t,) or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous int32 ({t},), got "
                             f"{x.dtype} {tuple(x.shape)}")
    if t < 2 or t & (t - 1):
        raise ValueError(f"cycles: expected a power of two >= 2, got {t}")
    if flags.dtype != torch.bool or flags.shape != (t,) or \
            not flags.is_contiguous():
        raise ValueError(f"flags: expected contiguous bool ({t},), got "
                         f"{flags.dtype} {tuple(flags.shape)}")
    for x, name in list(tables) + [(amul, "amul")]:
        if x is None:
            continue
        _check_planes(x, name)
        if x.shape != (L, t):
            raise ValueError(f"{name}: expected ({L}, {t}), got "
                             f"{tuple(x.shape)}")
    if buckets is not None:
        _check_planes(buckets, "buckets")
        nb = buckets.shape[-1]
        if buckets.dim() != 3 or nb < 2 or nb & (nb - 1) or \
                nb > K_MAX_BUCKETS:
            raise ValueError(f"buckets: expected (chunks + 1, {L}, nb), nb "
                             f"a power of two in [2, {K_MAX_BUCKETS}], got "
                             f"{tuple(buckets.shape)}")
    return t


def _present(*tensors):
    """The tensors given, the optional ones left out where None."""
    return [x for x in tensors if x is not None]


def _check_chunks(t: int, chunk: int, rows: int) -> None:
    if chunk < 1 or rows != -(-t // chunk):
        raise ValueError(f"buckets: {rows} chunk rows for {t} cycles in "
                         f"chunks of {chunk}")


def twist_k_buckets(ra: torch.Tensor, wa: torch.Tensor, flags: torch.Tensor,
                    amul, ic: torch.Tensor, table: torch.Tensor, chunk: int,
                    shift: int) -> torch.Tensor:
    """The buckets' stack of TwistBits' k round ``shift``:
    ``(chunks + 1, 8, nb)``, chunks = T / ``chunk`` rounded up, nb the
    lanes of ``table``.  Row c is the write buckets at chunk c's start:
    Σ ic · A over the writes of the chunks before c, by the write address
    shifted right by ``shift``; the last row is ``table`` (E, the folded
    eq(σ_k, ·)).  ``ra`` / ``wa`` int32 and ``flags`` bool ``(T,)``;
    ``amul`` the running χ products A ``(8, T)``, or None for A = 1; ``ic``
    and ``table`` Montgomery.  Two launches on a CUDA device (the chunks'
    walks and the scan over the chunks), counted as one."""
    if table.dim() != 2:
        raise ValueError(f"table: expected ({L}, nb), got "
                         f"{tuple(table.shape)}")
    t = _check_k_args(ra, wa, flags, amul, [(ic, "ic")],
                      table.unsqueeze(0))
    if not _on_cuda(*_present(ra, wa, flags, amul, ic, table)):
        return twist_k_buckets_plain(ra, wa, flags, amul, ic, table, chunk,
                                     shift)
    nb = table.shape[1]
    chunks = -(-t // chunk)
    out = torch.empty((chunks + 1, L, nb), dtype=torch.int32,
                      device=ra.device)
    out[chunks].copy_(table)
    _raise_on(_lib().tnsh_tbk_buckets(
        _ptr(ra), _ptr(wa), _ptr(flags), None if amul is None else _ptr(amul),
        _ptr(ic), _ptr(out), t, chunk, shift, nb, _stream(ra)),
        "twist_k_buckets")
    _count(twist_k_buckets, ic)
    return out


def twist_k_round(ra: torch.Tensor, wa: torch.Tensor, flags: torch.Tensor,
                  amul, eq1: torch.Tensor, eqs: torch.Tensor,
                  ic: torch.Tensor, wv: torch.Tensor, rv,
                  buckets: torch.Tensor, chunk: int,
                  shift: int) -> torch.Tensor:
    """A TwistBits k round's sums -> ``(8, 7)``, or ``(8, 8)`` with ``rv``:
    the read part Σ eq1 · A · χ(X, b) · vp(X) at X = 0..2, the write part
    Σ eqs · A · χ(X, b) · E(s, X) · (ic - wv + vp(X)) at X = 0..3, and with
    ``rv`` Σ eq1 · rv.  A cycle's remaining address is its read or write
    address shifted right by ``shift``, s its pair and b its bit;
    vp(X) = (1 - X) B[2s] + X B[2s + 1], B the buckets before the cycle
    (its chunk's row of ``buckets``, ``twist_k_buckets`` or its folds, and
    the chunk's earlier writes), E the last row of ``buckets``.  Two
    launches on a CUDA device (the chunks' walks and the sum over them),
    counted as one."""
    tables = [(eq1, "eq1"), (eqs, "eqs"), (ic, "ic"), (wv, "wv"),
              (rv, "rv")]
    t = _check_k_args(ra, wa, flags, amul, tables, buckets)
    _check_chunks(t, chunk, buckets.shape[0] - 1)
    if not _on_cuda(*_present(ra, wa, flags, amul, eq1, eqs, ic, wv, rv,
                              buckets)):
        return twist_k_round_plain(ra, wa, flags, amul, eq1, eqs, ic, wv, rv,
                                   buckets, chunk, shift)
    nsums = K_ROUND_SUMS if rv is not None else K_ROUND_SUMS - 1
    chunks = buckets.shape[0] - 1
    partials = torch.empty((chunks, nsums, L), dtype=torch.int32,
                           device=ra.device)
    out = torch.empty((L, nsums), dtype=torch.int32, device=ra.device)
    _raise_on(_lib().tnsh_tbk_round(
        _ptr(ra), _ptr(wa), _ptr(flags), None if amul is None else _ptr(amul),
        _ptr(eq1), _ptr(eqs), _ptr(ic), _ptr(wv),
        None if rv is None else _ptr(rv), _ptr(buckets), _ptr(partials),
        _ptr(out), t, chunk, shift, buckets.shape[2], _stream(ra)),
        "twist_k_round")
    _count(twist_k_round, eq1)
    return out


def twist_k_bind(ra: torch.Tensor, wa: torch.Tensor, flags: torch.Tensor,
                 amul, r, shift: int) -> torch.Tensor:
    """The running χ products after binding address bit ``shift`` to
    ``r``: A · χ(r, bit ``shift`` of each cycle's read or write address),
    ``(8, T)`` Montgomery; ``amul`` None stands for A = 1.  On a CUDA
    device the product is written into ``amul`` when it is given."""
    t = _check_k_args(ra, wa, flags, amul, [])
    if not _on_cuda(*_present(ra, wa, flags, amul)):
        return twist_k_bind_plain(ra, wa, flags, amul, r, shift)
    out = (torch.empty((L, t), dtype=torch.int32, device=ra.device)
           if amul is None else amul)
    r_words = (ctypes.c_uint32 * L)(*mont_words(r))
    om_words = (ctypes.c_uint32 * L)(*mont_words(1 - int(r)))
    _raise_on(_lib().tnsh_tbk_bind(
        _ptr(ra), _ptr(wa), _ptr(flags), None if amul is None else _ptr(amul),
        _ptr(out), ctypes.cast(r_words, ctypes.c_void_p),
        ctypes.cast(om_words, ctypes.c_void_p), t, shift, _stream(ra)),
        "twist_k_bind")
    _count(twist_k_bind, ra)
    return out


# ---------------------------------------------------------------------------
# round evaluations  (replaces tnsh/field/fr_pallas.py _product_evals_call
# and _sop_evals_call)
# ---------------------------------------------------------------------------

#: Instructions of a round program (``op + 8 * arg``); the kernel's
#: ``RoundOp`` in ``csrc/fr_kernels.cu`` has the same numbers.
OP_LOADC, OP_ADDC, OP_MUL, OP_PUSH, OP_ACC, OP_POPADD = range(6)

#: Most stack slots a program may need (slot 0, the total, included): with
#: the running value they are what a thread keeps in shared memory a point.
MAX_STACK_SLOTS = 7


@dataclass(frozen=True, eq=False)
class Terms:
    """A sum of products, as its terms and as the straight-line program
    that evaluates them: term t multiplies the stacked tables ``idxs[t]``
    and coefficient t.

    ``program`` is a tuple of ``(op, arg)`` over a running value ``cur``
    (one value a point) and a stack of sums ``S`` whose slot 0 is the
    result: ``LOADC c`` cur = coefficient c; ``ADDC c`` cur += coefficient
    c; ``MUL f`` cur *= table f's values; ``PUSH`` S[sp++] = cur; ``ACC``
    S[sp-1] += cur; ``POPADD`` cur += S[--sp].  ``code`` is its int32
    device copy, ``depth`` the stack slots it needs, ``products`` its MULs
    (the Montgomery products a lane pair and point) and
    ``products_unfactored`` what term-by-term evaluation takes (every
    factor and the coefficient: one product each but the first)."""

    idxs: Tuple[Tuple[int, ...], ...]
    program: Tuple[Tuple[int, int], ...]
    code: torch.Tensor
    depth: int

    @property
    def num_tables(self) -> int:
        return 1 + max(max(t) for t in self.idxs)

    @property
    def products(self) -> int:
        return sum(1 for op, _ in self.program if op == OP_MUL)

    @property
    def products_unfactored(self) -> int:
        return sum(len(t) for t in self.idxs)


class _Node:
    """A node of the terms' prefix trie: one table, the coefficients of the
    terms that end here, and the nodes of the factors that follow."""

    def __init__(self, table: int):
        self.table = table
        self.coeffs = []
        self.children = {}


def _round_program(idxs):
    """The program of a prefix trie over the terms' factor lists, in the
    order given: a node's value is v_f * (its coefficients + the sum of
    its children), so a shared prefix is multiplied once, and every node
    costs one product."""
    root = {}
    for t, factors in enumerate(idxs):
        level = root
        for f in factors:
            node = level.get(f)
            if node is None:
                node = level[f] = _Node(f)
            level = node.children
        node.coeffs.append(t)
    ops = []

    def emit_sum(nodes):
        """cur = the sum of the nodes' values."""
        for k, node in enumerate(nodes):
            emit(node)
            if len(nodes) > 1:
                ops.append((OP_PUSH if k == 0 else
                            OP_POPADD if k == len(nodes) - 1 else OP_ACC, 0))

    def emit(node):
        """cur = the node's value."""
        coeffs = list(node.coeffs)
        if node.children:
            emit_sum(list(node.children.values()))
        else:
            ops.append((OP_LOADC, coeffs.pop(0)))
        ops.extend((OP_ADDC, c) for c in coeffs)
        ops.append((OP_MUL, node.table))

    for node in root.values():
        emit(node)
        ops.append((OP_ACC, 0))
    sp = depth = 1
    for op, _ in ops:
        sp += (op == OP_PUSH) - (op == OP_POPADD)
        depth = max(depth, sp)
    return tuple(ops), depth


def terms(term_idxs: Sequence[Sequence[int]], device) -> Terms:
    """Validate the terms, build their program and put it on ``device``."""
    idxs = tuple(tuple(int(f) for f in t) for t in term_idxs)
    if not idxs or any(not t for t in idxs):
        raise ValueError("a sum of products needs terms of at least one table")
    if min(min(t) for t in idxs) < 0:
        raise ValueError("negative table index")
    program, depth = _round_program(idxs)
    if depth > MAX_STACK_SLOTS:
        raise ValueError(f"the terms' prefix trie nests {depth} sums deep; "
                         f"the kernel keeps {MAX_STACK_SLOTS}")
    code = torch.tensor([op + 8 * arg for op, arg in program],
                        dtype=torch.int32).to(device)
    return Terms(idxs, program, code, depth)


def round_evals_plain(tables: torch.Tensor, coeffs: torch.Tensor,
                      desc: Terms, npts: int) -> torch.Tensor:
    """[g(0..npts-1)] -> (8, npts), by ``fr_ops``: per table the X-point
    values lo, hi, hi + d, ... are extended incrementally, then the
    program of ``desc`` runs on ``(8, npts, half)`` values and its result
    is summed over lanes."""
    t = tables.transpose(0, 1)                   # (8, F, N)
    lo, hi = t[..., 0::2], t[..., 1::2]
    d = fr_ops.sub(hi, lo)
    vals = [lo, hi]
    for _ in range(npts - 2):
        vals.append(fr_ops.add(vals[-1], d))
    v = torch.stack(vals, dim=1)                 # (8, npts, F, half)
    shape = (L, npts, v.shape[-1])
    cur, stack = None, [None]
    for op, arg in desc.program:
        if op == OP_LOADC:
            cur = coeffs[:, arg].reshape(L, 1, 1).expand(shape)
        elif op == OP_ADDC:
            cur = fr_ops.add(cur, coeffs[:, arg].reshape(L, 1, 1).expand(shape))
        elif op == OP_MUL:
            cur = fr_ops.mont_mul(cur, v[:, :, arg])
        elif op == OP_PUSH:
            stack.append(cur)
        elif op == OP_ACC:
            stack[-1] = cur if stack[-1] is None else fr_ops.add(stack[-1],
                                                                 cur)
        elif op == OP_POPADD:
            cur = fr_ops.add(cur, stack.pop())
        else:
            raise ValueError(f"unknown round-program op {op}")
    return fr_ops.sum_lanes(stack[0]).squeeze(-1).contiguous()


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


def round_evals_blocks(half: int) -> int:
    """Blocks along the lane pairs of a round-evaluation launch on the
    current CUDA device; one block means the round takes one launch (the
    block writes the result, no summing launch follows)."""
    return _round_evals_blocks(_lib(), half)


def _round_evals_blocks(lib, half: int) -> int:
    nblk = lib.tnsh_fr_round_evals_blocks(half)
    _raise_on(max(-nblk, 0), "round_evals_blocks", lib)
    return nblk


def _launch_round_evals(tables, coeffs, desc, npts, what) -> torch.Tensor:
    if desc.code.device != tables.device:
        raise ValueError("term descriptor on another device than the tables")
    if tables.data_ptr() % 8:
        raise ValueError(f"{what}: tables must be 8-byte aligned")
    lib = _lib()
    half = tables.shape[2] // 2
    nblk = _round_evals_blocks(lib, half)
    partials = (None if nblk == 1 else
                torch.empty((nblk, npts, L), dtype=torch.int32,
                            device=tables.device))
    out = torch.empty((L, npts), dtype=torch.int32, device=tables.device)
    _raise_on(lib.tnsh_fr_round_evals(
        _ptr(tables), half, _ptr(desc.code), len(desc.program), desc.depth,
        _ptr(coeffs), coeffs.shape[1], npts,
        None if partials is None else _ptr(partials), nblk, _ptr(out),
        _stream(tables),
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
    _count(sum_of_products_round_evals, tables)
    return out


@functools.lru_cache(maxsize=None)
def _product_desc(num_tables: int, device: torch.device):
    """One term over ``num_tables`` stacked tables and the coefficient
    one, built once per shape and device."""
    return (const_planes(R_MOD_P, device),
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
    _count(product_round_evals, tables)
    return out


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

KERNELS = (mont_mul_chain, fold, product_round_evals,
           sum_of_products_round_evals, rlc, open_level, prefix_scan,
           twist_k_buckets, twist_k_round, twist_k_bind)


def _count(fn, x: torch.Tensor) -> None:
    """One launch of ``fn``'s kernel, on an input of ``x``'s shape."""
    fn.launches += 1
    shape = tuple(x.shape)
    fn.shapes[shape] = fn.shapes.get(shape, 0) + 1


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.shapes = {}


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def launch_shapes() -> dict:
    """Launches since the last reset by kernel and input shape: the
    chain's ``x``, the others' (stacked) tables."""
    return {fn.__name__: dict(fn.shapes) for fn in KERNELS}


reset_launch_counts()
