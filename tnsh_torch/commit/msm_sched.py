"""Cell-scheduled Pippenger MSM on a torch device: the port of
``tnsh/commit/msm_sched.py``, with its device side laid out for an H100.

Pippenger's bucket method restructured so that every bucket insertion is
conflict free and every data structure stays on the device:

  * **Signed 8-bit windows**: scalars split into W windows of signed
    digits in [-128, 127]; W adapts to the scalar magnitude, so bit
    columns get W = 4 instead of 32.  On a CUDA device the digits come
    from ``msm_digits`` (``msm_digits_kernel``), which reads the scalars'
    32-byte words on the card and counts the digits in the same pass; on
    the CPU from ``signed_digits`` (numpy), the plain version.
  * **A data-dependent lane plan** (``MsmPlan``, host numpy, from the
    (chunk, window, |digit|) counts alone: ``MsmPlan.from_counts``): every
    (window, |digit|) group gets a power-of-two number K of accumulator
    lanes out of the plan's lane budget, sized so that the worst group
    needs as few insertion steps as possible whatever the digit
    distribution.  The budget is an argument.  On a CUDA device it is the
    number of threads the insertion kernel can keep resident on the card
    (asked of the CUDA runtime once, rounded down to a power of two: tens
    of thousands on an H100); on the CPU it is ``CPU_LANES``.  Groups are
    packed by descending size, so each starts at a multiple of its own K:
    a group of up to 256 lanes lies inside one 256-lane tile and a larger
    one covers whole tiles, which lets the tail fold in shared memory.
  * **Chunk streaming**: points stream in m-point chunks.  Each chunk has
    an insertion schedule: the rank of a point inside its bucket (its
    order among the chunk's points of the same window and magnitude), then
    (step, lane) from the plan, as +-(index + 1) in ``(steps, lanes)``.
    On a CUDA device ``msm_rank`` (``msm_rank_kernel``) writes every
    chunk's schedule in one launch; ``build_schedule``, a cumulative
    one-hot sum, is its plain version.
  * **The insertion** (``insert_steps``): step s adds the s-th member of
    every group lane, all lanes at once, by one masked mixed add.  This is
    the kernel: ``msm_insert_kernel`` in ``tnsh_torch/csrc/
    msm_kernels.cu`` replaces the Pallas kernel ``seg_kernel`` of
    ``tnsh/commit/msm_sched.py`` (``_make_insert_seg_cached``).  Beside it
    stands ``insert_steps_plain``, a Python loop over steps on the plain
    Fq ops.  The wider the plan, the fewer steps: the work (one mixed add
    an entry) is fixed by the digits, its shape (lanes x steps) by the
    budget.
  * **The tail** (``msm_tail``): a tree fold of each group's lanes onto
    its base lane (level t adds lane + 2^t into the lanes whose offset in
    their group is a multiple of 2^(t+1); a byte a lane, the group's
    log2 K, says where), a gather into the canonical (window, magnitude)
    layout, per window Σ_d d·B_d by a suffix scan and a tree sum, and the
    hazard count beside them.  On a CUDA device two kernels of
    ``msm_kernels.cu`` do all of it in shared memory (three when a group
    is wider than a tile); ``msm_tail_plain`` is the same stages level by
    level on ``msm_group.padd_plain``, and ``msm_tail_levelwise`` the
    same on ``msm_group.padd`` (one launch and three ``torch.roll`` copies
    a level: the route the tail kernels replaced, kept to be timed
    against).  Then a W-window Horner combine on the host.

Group-law hazard: the mixed add is wrong where the incoming point equals
the accumulator.  Inside one bucket lane the accumulator is a partial sum
of distinct earlier points of the same bucket, so for SRS bases equality
is cryptographically negligible; it is nevertheless detected, counted
(``ScheduledMsmContext.hazard_count``) and answered in the lane itself by
a doubling, so the result is always exact and stays on the device.  (The
Pallas kernel could not branch per lane and sent such an MSM to the
host.)  Equal points that land in different lanes of one group meet in
the fold, whose general add doubles too; those are not hazards.

There is one engine.  On a CUDA device the digits and their counts, the
schedule, the insertion, the tail and the Montgomery conversion of the
bases are hand-written kernels, and the host sizes the lanes from the
counts (one small copy, the MSM's only wait); on the CPU (tests) the host
plans in numpy and each wrapper runs its plain version.  ``msm_async``
launches on a CUDA stream of the context and returns a finisher that
waits on an event.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..field import fq_kernels, fr_ops
from ..field.fr_kernels import (_on_cuda, _ptr, _raise_on, _stream,
                                const_planes)
from ..field.g1 import G1
from ..field.limbs import FQ_SPEC, NUM_LIMBS, le_bytes, raw_ints
from ..utils.profiling import count, span
from .msm_group import _padd_mixed_safe_flag, padd, padd_plain

fq = fr_ops.fq
_L = NUM_LIMBS


# ---------------------------------------------------------------------------
# Host-side preparation (numpy, vectorized)
# ---------------------------------------------------------------------------

def scalars_to_byte_matrix(scalars, n: int) -> np.ndarray:
    """(n, 32) uint8 little-endian scalar bytes of bytes, an integer
    array, a CPU ``(n, 8)`` int32 tensor of words or field elements."""
    if isinstance(scalars, (bytes, bytearray)):
        out = np.frombuffer(bytes(scalars), dtype=np.uint8)
        return out.reshape(-1, 32)[:n]
    if isinstance(scalars, torch.Tensor):
        return _check_words(scalars)[:n].numpy().view(np.uint8)
    if isinstance(scalars, np.ndarray) and scalars.dtype.kind in "iu":
        out = np.zeros((n, 32), dtype=np.uint8)
        v = scalars[:n].astype(np.uint64)
        for b in range(8):
            out[:, b] = ((v >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(
                np.uint8
            )
        return out
    data = le_bytes(scalars[:n])
    return np.frombuffer(data, dtype=np.uint8).reshape(-1, 32)


def num_scalars(scalars) -> int:
    """How many scalars: 32 bytes each, a row each of an ``(n, 8)`` word
    tensor, or one a field element or array entry."""
    if isinstance(scalars, (bytes, bytearray)):
        return len(scalars) // 32
    if isinstance(scalars, torch.Tensor):
        return scalars.shape[0]
    return len(scalars)


def _window_count(used: np.ndarray) -> int:
    """W of scalars whose byte positions ``used`` (32 bools) are nonzero
    somewhere: up to the highest such byte, one carry window, rounded up
    to a multiple of 4 to bound the number of distinct shapes."""
    nonzero = np.nonzero(used)[0]
    hb = int(nonzero[-1]) if nonzero.size else 0
    return (min(hb + 2, 32) + 3) // 4 * 4


def _signed_windows(sb: np.ndarray, w_count: int):
    """((w_count, n) int8 signed digits, (n,) bool carry out of the top
    window) of (n, 32) uint8 scalar bytes."""
    n = sb.shape[0]
    d = sb[:, :w_count].astype(np.int16).T.copy()  # (W, n)
    carry = np.zeros(n, dtype=np.int16)
    for w in range(w_count):
        v = d[w] + carry
        carry = (v >= 128).astype(np.int16)
        d[w] = v - (carry << 8)
    return d.astype(np.int8), carry.astype(bool)


def signed_digits(sb: np.ndarray) -> np.ndarray:
    """(W, n) int8 signed base-256 digits of (n, 32) uint8 scalar bytes.

    Digits lie in [-128, 127]; W adapts to the highest nonzero byte (+1
    carry window, padded to a multiple of 4 to bound the number of
    distinct shapes).  Σ_w d_w 256^w reconstructs each scalar exactly.
    The plain version of ``msm_digits``' digits."""
    d, carry = _signed_windows(sb, _window_count(sb.any(axis=0)))
    if carry.any():  # only possible for byte 31 >= 0x7F: not a valid Fr
        raise ValueError("scalar out of field range for signed windows")
    return d


def digit_counts(d: np.ndarray, m: int) -> np.ndarray:
    """(chunks, W, 129) occupancy counts of (W, n_pad) signed digits in
    chunks of m points: how many points of each chunk have each |digit|
    in each window, zero digits not counted.  The native counting loop,
    or under TNSH_NO_NATIVE one numpy bincount (same counts)."""
    from .. import _native

    w_count, n_pad = d.shape
    chunks = n_pad // m
    if _native.available:
        ccnt = _native.msm_digit_counts(d, m)
    else:
        mags = np.abs(d.astype(np.int16)).astype(np.int32)
        keys = (mags.reshape(w_count, chunks, m)
                + (np.arange(w_count, dtype=np.int32) * 129)[:, None, None]
                + (np.arange(chunks, dtype=np.int32)
                   * (w_count * 129))[None, :, None])
        ccnt = np.bincount(
            keys.ravel(), minlength=chunks * w_count * 129
        ).reshape(chunks, w_count, 129)
    ccnt[:, :, 0] = 0
    return ccnt


#: Accumulator-lane budget of a plan on the CPU (the JAX package's width).
#: On a CUDA device the budget is derived from the card: see
#: ``resident_lanes``.
CPU_LANES = 4096
#: Fold levels one launch of the tail's fold kernel runs: a tile of 256
#: lanes in one thread block's shared memory.
_TILE_LEVELS = 8


class MsmPlan:
    """Host-computed, data-dependent plan for one MSM call.

    Every (window, |digit|) group is assigned K_g = pow2 accumulator lanes
    out of the budget ``lanes`` (a power of two; one group may claim all
    of it); insert ``rank`` maps to (step = rank >> log2 K_g, lane =
    base_g + (rank & K_g-1)).  K_g sizes come from a binary search
    equalizing the worst per-chunk step count: heavy groups (repeated
    Twist addresses, the near-constant top windows of small or
    consecutive-valued scalars, even ALL-identical scalars) simply claim
    more lanes, so total work stays ~n*W lane-adds and the step count
    stays ~n*W/lanes regardless of the digit distribution.

    Groups are packed by descending K (in (window, digit) order within one
    K), so ``base_map[w, d]`` is a multiple of the group's K.
    ``lane_logk`` is the one per-lane table: log2 K of the group that owns
    the lane (0 for a lane no group owns), from which the fold knows each
    lane's offset in its group, ``lane & (K - 1)``.  ``fold_levels`` is the
    largest log2 K.  ``canon_src[w * 128 + b]`` is the base lane of
    (window w, magnitude b + 1) where ``canon_mask`` is set.

    ``MsmPlan(d, m, lanes)`` counts the ``(W, n_pad)`` digits ``d`` by
    chunks of m points and sizes the lanes from the counts;
    ``MsmPlan.from_counts`` sizes them from counts made elsewhere (on the
    card, by ``msm_digits``).  Both run the one sizing code.
    """

    def __init__(self, d: np.ndarray, m: int, lanes: int):
        self._size(digit_counts(d, m), lanes)

    @classmethod
    def from_counts(cls, ccnt: np.ndarray, lanes: int) -> "MsmPlan":
        """The plan of the ``(chunks, W, 129)`` occupancy counts ``ccnt``
        (how many points of each chunk have each |digit| in each window;
        the column of digit 0 is not read) at the budget ``lanes``."""
        plan = cls.__new__(cls)
        plan._size(ccnt, lanes)
        return plan

    def _size(self, ccnt: np.ndarray, lanes: int) -> None:
        if lanes < 1 or lanes & (lanes - 1):
            raise ValueError(f"lane budget {lanes} is not a power of two")
        ccnt = np.array(ccnt, dtype=np.int64)
        chunks, w_count, _ = ccnt.shape
        self.w_count = w_count
        self.lanes = lanes
        ccnt[:, :, 0] = 0
        #: the non-zero digits the plan inserts
        self.digits = int(ccnt.sum())
        mc = ccnt.max(axis=0)  # (W, 129) worst chunk count
        supported = mc > 0
        self.r_exact = 0
        self.fold_levels = 0
        self.base_map = np.zeros((w_count, 129), dtype=np.int32)
        self.logk_map = np.zeros((w_count, 129), dtype=np.int32)
        self.lane_logk = np.zeros((lanes,), dtype=np.uint8)
        self.canon_src = np.zeros((w_count * 128,), dtype=np.int32)
        self.canon_mask = np.zeros((w_count * 128,), dtype=bool)
        self.rc_per_chunk = np.zeros((chunks,), dtype=np.int32)
        if not supported.any():
            return

        def lanes_needed(r: int) -> np.ndarray:
            k = -(-mc // r)  # ceil
            k = np.maximum(k, 1)
            # next_pow2, capped
            k = (1 << np.ceil(np.log2(k)).astype(np.int64)).astype(np.int64)
            return np.minimum(np.where(supported, k, 0), lanes)

        # The least r that fits the budget, by bisection.  Every group's K
        # is below 2 (mc / r + 1), so r = 2 sum(mc) / (lanes - 2 groups)
        # fits whatever the digits: the bisection's top where that is
        # positive (the same r, in fewer steps: none for a bit column).
        lo, hi = 1, int(mc.max())
        groups = int(supported.sum())
        if lanes > 2 * groups:
            hi = min(hi, -(-2 * int(mc.sum()) // (lanes - 2 * groups)))
        while lo < hi:
            mid = (lo + hi) // 2
            if int(lanes_needed(mid).sum()) <= lanes:
                hi = mid
            else:
                lo = mid + 1
        r = lo
        k_g = lanes_needed(r)
        if int(k_g.sum()) > lanes:
            raise RuntimeError("MSM lane budget infeasible")
        self.r_exact = int(np.max(np.where(k_g > 0, -(-mc // np.maximum(k_g, 1)), 0)))
        # Per-chunk step counts: a chunk runs the insertion steps IT needs,
        # not the worst chunk's count.
        kq = np.maximum(k_g, 1)[None]  # (1, W, 129)
        self.rc_per_chunk = np.max(
            np.where(k_g[None] > 0, -(-ccnt // kq), 0), axis=(1, 2)
        ).astype(np.int32)
        logk = np.where(
            supported,
            np.log2(np.maximum(k_g, 1)).astype(np.int64),
            0,
        )
        self.logk_map = logk.astype(np.int32)
        self.fold_levels = int(logk.max())
        # pack groups by descending size: every base is a multiple of its K
        flat_k = k_g.ravel()
        order = np.argsort(-flat_k, kind="stable")
        sorted_k = flat_k[order]
        bases = np.zeros_like(flat_k)
        bases[order] = np.cumsum(sorted_k) - sorted_k
        bases[flat_k == 0] = 0
        self.base_map = bases.reshape(k_g.shape).astype(np.int32)
        owned = np.repeat(logk.ravel()[order], sorted_k).astype(np.uint8)
        self.lane_logk[:owned.shape[0]] = owned
        # canonical magnitude layout: lane w*128+(b) = digit b+1
        self.canon_mask = supported[:, 1:].reshape(-1).copy()
        self.canon_src = np.where(
            self.canon_mask, self.base_map[:, 1:].reshape(-1), 0
        ).astype(np.int32)


def bytes_to_limb_planes(b: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 LE bytes -> (8, n) int32 limb planes (standard form;
    the Montgomery conversion happens on the device).  Eight 32-bit limbs
    are a view of the bytes."""
    words = np.ascontiguousarray(b, dtype=np.uint8).view("<u4")  # (n, 8)
    return np.ascontiguousarray(words.T).astype(np.uint32).view(np.int32)


def _choose_chunk(n: int) -> int:
    """Chunk size: the next power of two from 512 up, capped at 32768 (the
    plain schedule's one-hot rank tensor of a chunk is W x m x 128 int32;
    the insertion reads a chunk's points as one slice of the bases)."""
    m = 512
    while m < n and m < 32768:
        m *= 2
    return m


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------

def build_schedule(dch: torch.Tensor, base_map: torch.Tensor,
                   logk_map: torch.Tensor, steps: int,
                   lanes: int) -> torch.Tensor:
    """The ``(steps, lanes)`` int32 insertion schedule of one chunk.

    ``dch`` is the chunk's ``(W, m)`` signed digits (any integer dtype),
    ``base_map`` / ``logk_map`` the plan's ``(W, 129)`` tables on the same
    device, ``lanes`` the plan's width.  Point i with digit d != 0 in window w has rank r among the
    chunk's points of the same (w, |d|); it lands at step r >> logk and
    lane base + (r & (K - 1)) as +(i + 1) or, for d < 0, -(i + 1).  Every
    (step, lane) cell receives at most one point.  Zero digits are sent
    to a spare row past the schedule, which is then cut off, so they are
    dropped rather than clamped onto a real cell."""
    w_count, m = dch.shape
    dev = dch.device
    dch = dch.to(torch.int64)
    mag = dch.abs()
    bucket = (mag - 1).clamp(min=0)
    # one-hot as (W, 128, m) so that the cumulative sum runs along the
    # innermost axis
    onehot = (bucket.unsqueeze(1)
              == torch.arange(128, device=dev).view(1, 128, 1))
    onehot &= (mag > 0).unsqueeze(1)
    cs = torch.cumsum(onehot, dim=2, dtype=torch.int32)
    rank = torch.gather(cs, 1, bucket.unsqueeze(1)).squeeze(1).to(
        torch.int64) - 1
    row = torch.arange(w_count, device=dev).unsqueeze(1) * 129
    lk = logk_map.reshape(-1).to(torch.int64)[row + mag]
    base = base_map.reshape(-1).to(torch.int64)[row + mag]
    step_idx = rank >> lk
    lane = base + (rank & ((1 << lk) - 1))
    flat = torch.where(mag > 0, step_idx * lanes + lane,
                       torch.full_like(mag, steps * lanes))
    ids = torch.arange(1, m + 1, device=dev, dtype=torch.int32)
    vals = torch.where(dch < 0, -ids, ids)
    sched = torch.zeros((steps + 1) * lanes, dtype=torch.int32, device=dev)
    sched[flat.reshape(-1)] = vals.reshape(-1)
    return sched[:steps * lanes].view(steps, lanes)


#: Windows the digits kernel writes (every scalar's 32 bytes), and the
#: int32 words behind its counts: the OR of the scalars' eight words and
#: the carry flag.
_WINDOWS = 32
_META_WORDS = 9


def _check_words(words: torch.Tensor) -> torch.Tensor:
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[1] != _L or not words.is_contiguous():
        raise ValueError("scalar words: expected a contiguous (n, 8) int32 "
                         f"tensor, got {tuple(words.shape)} {words.dtype}")
    return words


def _check_digits_args(words, valid, m: int) -> None:
    _check_words(words)
    if valid is not None and (
            valid.dtype != torch.uint8 or valid.dim() != 1
            or valid.shape[0] < words.shape[0] or not valid.is_contiguous()):
        raise ValueError(f"valid: expected contiguous (>= {words.shape[0]},) "
                         f"uint8, got {tuple(valid.shape)} {valid.dtype}")
    if m < 512 or m & (m - 1):
        raise ValueError(f"chunk size {m} is not a power of two from 512")


def msm_digits_plain(words: torch.Tensor, valid: torch.Tensor, m: int):
    """The plain version of ``msm_digits``: ``_signed_windows`` over all 32
    windows, ``digit_counts`` and the words' OR, in numpy."""
    n = words.shape[0]
    chunks = -(-n // m)
    w = words.cpu().numpy().view(np.uint32)
    d, carry = _signed_windows(w.view(np.uint8), _WINDOWS)
    if valid is not None:
        d[:, valid[:n].cpu().numpy() == 0] = 0
    d = np.pad(d, ((0, 0), (0, chunks * m - n)))
    meta = np.zeros(_META_WORDS, dtype=np.uint32)
    meta[:_L] = np.bitwise_or.reduce(w, axis=0)
    meta[_L] = int(carry.any())
    stats = np.concatenate([digit_counts(d, m).ravel().astype(np.int32),
                            meta.view(np.int32)])
    return (torch.from_numpy(d).to(words.device),
            torch.from_numpy(stats).to(words.device))


def msm_digits(words: torch.Tensor, valid: torch.Tensor, m: int):
    """Signed digits and their counts of n scalars, on the device.

    ``words`` is ``(n, 8)`` int32: each scalar's standard-form
    little-endian bytes as eight words; ``valid`` ``(>= n,)`` uint8, zero
    where the base a scalar multiplies is not a point (its digits are
    zeroed), or None where every base is one; ``m`` the chunk size (a power of two from 512).  Returns
    ``(digits, stats)``: ``digits`` ``(32, n_ck)`` int8, window-major, n_ck
    = n rounded up to a multiple of m, zero past n; ``stats`` int32 of
    ``chunks x 32 x 129 + 9``, the ``(chunks, 32, 129)`` counts of nonzero
    digits by (chunk, window, |digit|), then the OR of the scalars' eight
    words and a carry flag (nonzero where a scalar does not fit the signed
    windows).  Digit rows from ``_window_count`` of the OR up are zero
    where no scalar carries.  One launch of ``msm_digits_kernel`` on a
    CUDA device."""
    _check_digits_args(words, valid, m)
    if not _on_cuda(words, *([] if valid is None else [valid])):
        return msm_digits_plain(words, valid, m)
    from .._build import msm_library

    lib = msm_library()
    n = words.shape[0]
    chunks = -(-n // m)
    digits = torch.empty((_WINDOWS, chunks * m), dtype=torch.int8,
                         device=words.device)
    stats = torch.zeros((chunks * _WINDOWS * 129 + _META_WORDS,),
                        dtype=torch.int32, device=words.device)
    _raise_on(lib.tnsh_msm_digits(
        _ptr(words), n, None if valid is None else _ptr(valid), chunks * m,
        m, _ptr(digits),
        _ptr(stats), _ptr(stats[-_META_WORDS:]), _stream(words)),
        "msm_digits", lib)
    msm_digits.launches += 1
    return digits, stats


msm_digits.launches = 0


def plan_of_stats(stats: np.ndarray, chunks: int, lanes: int) -> MsmPlan:
    """The plan of ``msm_digits``' stats (on the host): W from the words'
    OR as ``signed_digits`` takes it, the counts of windows below W, and
    ``MsmPlan.from_counts``.  A carry out of the top window raises
    ``signed_digits``' ``ValueError``."""
    meta = np.ascontiguousarray(stats[-_META_WORDS:]).view(np.uint32)
    if meta[_L]:
        raise ValueError("scalar out of field range for signed windows")
    used = meta[:_L].astype("<u4").view(np.uint8) != 0
    counts = stats[:-_META_WORDS].reshape(chunks, _WINDOWS, 129)
    return MsmPlan.from_counts(counts[:, :_window_count(used)], lanes)


def _check_rank_args(digits, base_map, logk_map, steps, row_off, rows: int,
                     m: int, lanes: int) -> None:
    if digits.dtype != torch.int8 or digits.dim() != 2 \
            or not digits.is_contiguous():
        raise ValueError("digits: expected contiguous (W, n_ck) int8, got "
                         f"{tuple(digits.shape)} {digits.dtype}")
    w_count = base_map.shape[0] if base_map.dim() == 2 else 0
    for name, t in (("base_map", base_map), ("logk_map", logk_map)):
        if t.dtype != torch.int32 or tuple(t.shape) != (w_count, 129) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous (W, 129) int32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if not 1 <= w_count <= digits.shape[0]:
        raise ValueError(f"{w_count} windows of {digits.shape[0]} digit rows")
    chunks = steps.shape[0] if steps.dim() == 1 else -1
    for name, t in (("steps", steps), ("row_off", row_off)):
        if t.dtype != torch.int32 or tuple(t.shape) != (chunks,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous (chunks,) int32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if m < 256 or m & (m - 1) or chunks * m > digits.shape[1]:
        raise ValueError(f"{chunks} chunks of {m} points over "
                         f"{digits.shape[1]} digit columns")
    if lanes < 1 or lanes & (lanes - 1) or rows < 0:
        raise ValueError(f"schedule of {rows} rows x {lanes} lanes")


def msm_rank_plain(digits, base_map, logk_map, steps, row_off, rows: int,
                   m: int, lanes: int) -> torch.Tensor:
    """The plain version of ``msm_rank``: ``build_schedule`` a chunk."""
    w_count = base_map.shape[0]
    sched = torch.zeros((rows, lanes), dtype=torch.int32,
                        device=digits.device)
    for c, (s, o) in enumerate(zip(steps.tolist(), row_off.tolist())):
        if s:
            sched[o:o + s] = build_schedule(
                digits[:w_count, c * m:(c + 1) * m], base_map, logk_map, s,
                lanes)
    return sched


def msm_rank(digits: torch.Tensor, base_map: torch.Tensor,
             logk_map: torch.Tensor, steps: torch.Tensor,
             row_off: torch.Tensor, rows: int, m: int,
             lanes: int) -> torch.Tensor:
    """Every chunk's insertion schedule, on the device.

    ``digits`` is ``(>= W, n_ck)`` int8 (``msm_digits``' rows, of which
    the first W are read), ``base_map`` / ``logk_map`` the plan's ``(W,
    129)`` int32 tables, ``steps`` ``(chunks,)`` int32 the plan's steps of
    each chunk of m points, ``row_off`` ``(chunks,)`` int32 the first row
    of each chunk's schedule, ``rows`` their total, ``lanes`` the plan's
    width.  Returns ``(rows, lanes)`` int32: rows ``row_off[c]`` to
    ``row_off[c] + steps[c]`` are ``build_schedule`` of chunk c, element
    for element.  One launch of ``msm_rank_kernel`` (a block a chunk and
    window) on a CUDA device, behind the schedule's zero fill."""
    _check_rank_args(digits, base_map, logk_map, steps, row_off, rows, m,
                     lanes)
    args = (digits, base_map, logk_map, steps, row_off)
    if not _on_cuda(*args):
        return msm_rank_plain(*args, rows, m, lanes)
    from .._build import msm_library

    lib = msm_library()
    sched = torch.zeros((rows, lanes), dtype=torch.int32,
                        device=digits.device)
    _raise_on(lib.tnsh_msm_rank(
        _ptr(digits), digits.shape[1], m, base_map.shape[0], steps.shape[0],
        *(_ptr(t) for t in args[1:]), _ptr(sched), rows, lanes,
        _stream(digits)),
        "msm_rank", lib)
    msm_rank.launches += 1
    return sched


msm_rank.launches = 0


def insert_steps_plain(sched, px, py, X, Y, Z, hazards, steps: int):
    """The plain version of ``insert_steps``: a Python loop over steps,
    ``index_select`` for the gather, ``_padd_mixed_safe_flag`` on the plain
    Fq ops."""
    m = px.shape[1]
    hz = hazards.clone()
    for s in range(steps):
        row = sched[s]
        idx = (row.abs().to(torch.int64) - 1).clamp(0, m - 1)
        gx = px.index_select(1, idx)
        gy = py.index_select(1, idx)
        gy = fq.select(row < 0, fq.neg(gy), gy)
        X, Y, Z, same = _padd_mixed_safe_flag(X, Y, Z, gx, gy, row != 0)
        hz = hz + same.sum().to(torch.int32)
    return X.contiguous(), Y.contiguous(), Z.contiguous(), hz


def _check_insert_args(sched, px, py, acc, hazards, steps) -> None:
    lanes = acc[0].shape[-1]
    if sched.dtype != torch.int32 or sched.dim() != 2 \
            or sched.shape[1] != lanes or not sched.is_contiguous():
        raise ValueError(f"sched: expected contiguous (steps, {lanes}) int32, "
                         f"got {tuple(sched.shape)} {sched.dtype}")
    if not 0 <= steps <= sched.shape[0]:
        raise ValueError(f"steps {steps} outside the schedule's "
                         f"{sched.shape[0]} rows")
    for name, p in (("px", px), ("py", py)):
        if p.dtype != torch.int32 or p.dim() != 2 or p.shape[0] != _L:
            raise ValueError(f"{name}: expected (8, m) int32 planes, got "
                             f"{tuple(p.shape)} {p.dtype}")
        if p.stride(1) != 1:
            raise ValueError(f"{name}: lanes must be contiguous")
    if px.shape != py.shape or px.stride(0) != py.stride(0):
        raise ValueError("px and py must share shape and limb stride")
    if px.shape[1] < 1:
        raise ValueError("the chunk holds no point")
    for t in acc:
        if t.dtype != torch.int32 or tuple(t.shape) != (_L, lanes) \
                or not t.is_contiguous():
            raise ValueError(f"accumulators: expected contiguous (8, {lanes}) "
                             f"int32, got {tuple(t.shape)} {t.dtype}")
    if hazards.dtype != torch.int32 or hazards.numel() != 1:
        raise ValueError("hazards: expected one int32")


def insert_steps(sched: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                 X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor,
                 hazards: torch.Tensor, steps: Optional[int] = None):
    """Run the first ``steps`` rows of a chunk's schedule (default: all).

    ``sched`` is ``(rows, lanes)`` int32 (a chunk's rows of ``msm_rank``'s
    schedule, or ``build_schedule``'s); ``px``, ``py`` the chunk's affine
    Montgomery ``(8, m)`` Fq planes (a column slice of a wider tensor is
    taken as it is); ``X, Y, Z`` the Jacobian
    accumulators ``(8, lanes)``; ``hazards`` a one-element int32 count.
    Returns the new ``X, Y, Z`` and the count grown by the lanes whose
    accumulator equalled the incoming point (those lanes double, so the
    sums stay exact).  Nothing is updated in place.  One kernel launch on
    a CUDA device."""
    steps = sched.shape[0] if steps is None else int(steps)
    _check_insert_args(sched, px, py, (X, Y, Z), hazards, steps)
    if not _on_cuda(sched, px, py, X, Y, Z, hazards):
        return insert_steps_plain(sched, px, py, X, Y, Z, hazards, steps)
    from .._build import msm_library

    lib = msm_library()
    out = tuple(torch.empty_like(X) for _ in range(3))
    hz = hazards.clone()
    _raise_on(lib.tnsh_msm_insert(
        _ptr(sched), X.shape[1], steps, _ptr(px), _ptr(py), px.stride(0),
        px.shape[1], _ptr(X), _ptr(Y), _ptr(Z),
        *(_ptr(t) for t in out), _ptr(hz), _stream(X)), "insert_steps", lib)
    insert_steps.launches += 1
    return out[0], out[1], out[2], hz


insert_steps.launches = 0


def _rolled(X, Y, Z, shift: int):
    return (torch.roll(X, -shift, dims=1), torch.roll(Y, -shift, dims=1),
            torch.roll(Z, -shift, dims=1))


def fold_groups(X, Y, Z, lane_logk: torch.Tensor, levels: int, add=padd):
    """Tree-fold each group's K lanes onto its base lane, one masked
    ``add`` a level: level t adds lane + 2^t into the lanes that belong to
    a group of more than 2^t lanes and whose offset in it, ``lane &
    (K - 1)``, is a multiple of 2^(t+1).  ``lane_logk`` is the plan's
    per-lane log2 K (uint8) on the device, ``levels`` its largest value.
    Groups start at multiples of their K, so the offset's low bits are the
    lane's."""
    lane = torch.arange(X.shape[1], device=X.device)
    logk = lane_logk.to(torch.int64)
    for t in range(levels):
        mask = (logk > t) & ((lane & ((2 << t) - 1)) == 0)
        X, Y, Z = add(X, Y, Z, *_rolled(X, Y, Z, 1 << t), mask)
    return X, Y, Z


def canonicalize(X, Y, Z, canon_src: torch.Tensor, canon_mask: torch.Tensor):
    """Gather the group base lanes into the canonical layout: lane
    w*128 + b holds the bucket of digit magnitude b + 1 of window w, or
    infinity where the plan has no such group.  ``canon_src`` (integer)
    and ``canon_mask`` (bool) are the plan's tensors on the device."""
    dev = X.device
    src = canon_src.to(torch.int64)
    mask = canon_mask
    n = src.shape[0]
    one = fq.one((n,), dev)
    zero = torch.zeros((_L, n), dtype=torch.int32, device=dev)
    return (fq.select(mask, X.index_select(1, src), zero).contiguous(),
            fq.select(mask, Y.index_select(1, src), one).contiguous(),
            fq.select(mask, Z.index_select(1, src), zero).contiguous())


def window_sums(X, Y, Z, w_count: int, add=padd):
    """Per-window Σ_{d=1..128} d·B_d over flat ``(8, W*128)`` bucket lanes.

    Lane w*128+b holds bucket magnitude b+1.  Uses Σ_b (b+1) B_b = Σ_k S_k
    with S_k the in-block inclusive suffix sums: a 7-step Hillis-Steele
    suffix scan followed by a 7-step in-block tree sum."""
    total = w_count * 128
    lane = torch.arange(total, device=X.device) % 128
    for k in range(7):
        sh = 1 << k
        X, Y, Z = add(X, Y, Z, *_rolled(X, Y, Z, sh),
                      ((lane + sh) < 128).contiguous())
    for k in range(7):
        sh = 128 >> (k + 1)
        X, Y, Z = add(X, Y, Z, *_rolled(X, Y, Z, sh),
                      (lane < sh).contiguous())
    sel = torch.arange(w_count, device=X.device) * 128
    return (X.index_select(1, sel), Y.index_select(1, sel),
            Z.index_select(1, sel))


def msm_tail_levelwise(X, Y, Z, lane_logk, canon_src, canon_mask, hazards,
                       levels: int, add=padd):
    """The tail as one tensor op a level: ``fold_groups``,
    ``canonicalize``, ``window_sums`` and the packing of ``msm_tail``'s
    result, every add through ``add``.  With ``msm_group.padd`` on a CUDA
    device this is the route ``msm_tail``'s kernels took the place of (a
    launch and three rolled copies a level); it stays to be timed against
    them."""
    w_count = canon_src.shape[0] // 128
    X, Y, Z = fold_groups(X, Y, Z, lane_logk, levels, add)
    X, Y, Z = canonicalize(X, Y, Z, canon_src, canon_mask)
    Xw, Yw, Zw = window_sums(X, Y, Z, w_count, add)
    last = torch.zeros((_L, 1), dtype=torch.int32, device=X.device)
    last[0, 0] = hazards[0]
    return torch.cat([Xw, Yw, Zw, last], dim=1)


def msm_tail_plain(X, Y, Z, lane_logk, canon_src, canon_mask, hazards,
                   levels: int):
    """The plain version of ``msm_tail``: the level-wise tail on
    ``msm_group.padd_plain``."""
    return msm_tail_levelwise(X, Y, Z, lane_logk, canon_src, canon_mask,
                              hazards, levels, padd_plain)


def _check_tail_args(acc, lane_logk, canon_src, canon_mask, hazards,
                     levels) -> None:
    lanes = acc[0].shape[-1]
    if lanes < 1 or lanes & (lanes - 1):
        raise ValueError(f"the lane count {lanes} is not a power of two")
    for t in acc:
        if t.dtype != torch.int32 or tuple(t.shape) != (_L, lanes) \
                or not t.is_contiguous():
            raise ValueError(f"accumulators: expected contiguous (8, {lanes}) "
                             f"int32, got {tuple(t.shape)} {t.dtype}")
    if lane_logk.dtype != torch.uint8 or tuple(lane_logk.shape) != (lanes,) \
            or not lane_logk.is_contiguous():
        raise ValueError(f"lane_logk: expected contiguous ({lanes},) uint8, "
                         f"got {tuple(lane_logk.shape)} {lane_logk.dtype}")
    n = canon_src.shape[0] if canon_src.dim() == 1 else -1
    if canon_src.dtype != torch.int32 or n < 128 or n % 128 \
            or not canon_src.is_contiguous():
        raise ValueError("canon_src: expected contiguous (W * 128,) int32, "
                         f"got {tuple(canon_src.shape)} {canon_src.dtype}")
    if canon_mask.dtype != torch.bool or tuple(canon_mask.shape) != (n,) \
            or not canon_mask.is_contiguous():
        raise ValueError(f"canon_mask: expected contiguous ({n},) bool, got "
                         f"{tuple(canon_mask.shape)} {canon_mask.dtype}")
    if hazards.dtype != torch.int32 or hazards.numel() != 1:
        raise ValueError("hazards: expected one int32")
    if not 0 <= levels <= lanes.bit_length() - 1:
        raise ValueError(f"{levels} fold levels over {lanes} lanes")


def msm_tail(X: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor,
             lane_logk: torch.Tensor, canon_src: torch.Tensor,
             canon_mask: torch.Tensor, hazards: torch.Tensor,
             levels: Optional[int] = None) -> torch.Tensor:
    """Everything of an MSM behind its last insertion, on the device.

    ``X, Y, Z`` are the Jacobian accumulators ``(8, lanes)`` after the last
    chunk, ``lane_logk`` the plan's per-lane log2 K (uint8),
    ``canon_src`` / ``canon_mask`` its canonical table ``(W * 128,)``
    (int32, bool), ``hazards`` the insertion's one-element int32 count and
    ``levels`` the plan's largest log2 K (default: log2 lanes, which folds
    whatever the plan).  Returns ``(8, 3W + 1)`` int32: per window w the
    sum Σ_d d·B_d as Jacobian X | Y | Z in columns w, W + w, 2W + w, and
    the hazard count in limb 0 of the last column.

    On a CUDA device: one launch of ``msm_fold_tiles_kernel`` for every
    eight fold levels the plan has (one, or two when a group is wider than
    a tile of 256 lanes; none for a plan of one-lane groups), then one of
    ``msm_window_sums_kernel``."""
    lanes = X.shape[-1]
    levels = lanes.bit_length() - 1 if levels is None else int(levels)
    _check_tail_args((X, Y, Z), lane_logk, canon_src, canon_mask, hazards,
                     levels)
    tensors = (X, Y, Z, lane_logk, canon_src, canon_mask, hazards)
    if not _on_cuda(*tensors):
        return msm_tail_plain(*tensors, levels)
    from .._build import msm_library

    lib = msm_library()
    w_count = canon_src.shape[0] // 128
    folded = (X, Y, Z)
    for t0 in range(0, levels, _TILE_LEVELS):
        # The first pass writes the group bases and tile starts of a
        # scratch copy (nothing else of it is read later); a later pass
        # works on that copy in place.
        out = (tuple(torch.empty_like(X) for _ in range(3)) if t0 == 0
               else folded)
        _raise_on(lib.tnsh_msm_fold_tiles(
            *(_ptr(t) for t in folded), _ptr(lane_logk),
            *(_ptr(t) for t in out), lanes, t0, _stream(X)),
            "msm_tail (fold)", lib)
        folded = out
    packed = torch.empty((_L, 3 * w_count + 1), dtype=torch.int32,
                         device=X.device)
    _raise_on(lib.tnsh_msm_window_sums(
        *(_ptr(t) for t in folded), lanes, _ptr(canon_src),
        _ptr(canon_mask), w_count, _ptr(hazards), _ptr(packed), _stream(X)),
        "msm_tail (window sums)", lib)
    msm_tail.launches += 1
    return packed


msm_tail.launches = 0


def _combine_windows(xs, ys, zs) -> G1:
    """Host Horner combine of per-window sums (canonical ints):
    Σ_w 256^w · P_w."""
    acc = G1.zero()
    for w in range(len(xs) - 1, -1, -1):
        for _ in range(8):
            if not acc.is_zero():
                acc = acc.double()
        if zs[w] != 0:
            acc = acc.add(G1(xs[w], ys[w], zs[w]))
    return acc


# ---------------------------------------------------------------------------
# Host-facing context
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def resident_lanes(device_index: int) -> int:
    """The plan width of a CUDA device: the threads its insertion kernel
    can keep resident at once (blocks an SM by the CUDA runtime's occupancy
    calculator x SMs x block size), rounded down to a power of two, so
    that one launch is one wave with a thread a lane."""
    from .._build import msm_library

    lib = msm_library()
    threads = ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        _raise_on(lib.tnsh_msm_insert_resident_threads(ctypes.byref(threads)),
                  "resident_lanes", lib)
    if threads.value < 1:
        raise RuntimeError("the insertion kernel fits no block on this device")
    return 1 << (threads.value.bit_length() - 1)


class ScheduledMsmContext:
    """Device-resident base points for repeated scheduled-Pippenger MSMs.

    Build from explicit points (``ScheduledMsmContext(points)``), from
    affine bytes (``affine_bytes=``: 64 bytes a point, x || y little
    endian, all zero for the identity) or from a native SRS handle
    (:meth:`from_native_srs`), which exports the affine coordinates in one
    native call and never materializes Python points.  The bases are
    turned to Montgomery form on ``device`` and kept there.

    ``lanes`` is the width every MSM of the context is planned at (a power
    of two).  ``None`` derives it once, here: ``resident_lanes`` of a CUDA
    device, ``CPU_LANES`` on the CPU.
    """

    def __init__(self, points: Optional[Sequence[G1]] = None, *,
                 affine_bytes: Optional[bytes] = None, device,
                 lanes: Optional[int] = None):
        self.device = torch.device(device)
        if lanes is None:
            if self.device.type == "cuda":
                index = self.device.index
                lanes = resident_lanes(torch.cuda.current_device()
                                       if index is None else index)
            else:
                lanes = CPU_LANES
        self.lanes = int(lanes)
        if affine_bytes is not None:
            raw = np.frombuffer(affine_bytes, dtype=np.uint8).reshape(-1, 64)
            n = raw.shape[0]
            xb, yb = raw[:, :32], raw[:, 32:]
            valid = (raw != 0).any(axis=1)
        else:
            n = len(points)
            xb = np.zeros((n, 32), dtype=np.uint8)
            yb = np.zeros((n, 32), dtype=np.uint8)
            valid = np.zeros((n,), dtype=bool)
            for i, p in enumerate(points):
                if p.is_zero():
                    continue
                ax, ay = p.to_affine()
                xb[i] = np.frombuffer(ax.to_bytes(32, "little"), np.uint8)
                yb[i] = np.frombuffer(ay.to_bytes(32, "little"), np.uint8)
                valid[i] = True
        self.num_points = n
        m = _choose_chunk(n)
        n_pad = (n + m - 1) // m * m
        self.m = m
        xs = np.zeros((_L, n_pad), dtype=np.int32)
        ys = np.zeros((_L, n_pad), dtype=np.int32)
        xs[:, :n] = bytes_to_limb_planes(xb)
        ys[:, :n] = bytes_to_limb_planes(yb)
        self.xs = fq_kernels.to_mont(torch.from_numpy(xs).to(self.device))
        self.ys = fq_kernels.to_mont(torch.from_numpy(ys).to(self.device))
        self.valid_np = valid  # host-side; invalid points get zero digits
        #: the same on the device, as the digits kernel reads it; None
        #: where every base is a point (an SRS), which keeps nothing there
        self.valid = (None if valid.all() else torch.from_numpy(
            valid.astype(np.uint8)).to(self.device))
        #: lanes, over all MSMs so far, whose accumulator met its own point
        self.hazard_count = 0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    @classmethod
    def from_native_srs(cls, srs_id: int, *, device, n: Optional[int] = None,
                        lanes: Optional[int] = None
                        ) -> "ScheduledMsmContext":
        from .. import _native

        if n is None:
            n = _native.srs_size(srs_id)
        data = _native.srs_export_affine(srs_id, 0, n)
        return cls(affine_bytes=data, device=device, lanes=lanes)

    def msm(self, scalars) -> G1:
        """Σ scalars[i] · base[i] over the first len(scalars) base points."""
        return self.msm_async(scalars)()

    def msm_async(self, scalars) -> Callable[[], G1]:
        """Dispatch the MSM and return a zero-argument finisher.

        ``scalars`` are bytes (32 standard-form little-endian bytes a
        scalar), field elements, an integer array, or an ``(n, 8)`` int32
        tensor of the bytes' words; on a CUDA context that tensor may lie
        on the context's device, where it is read as it is.  On a CUDA
        device the digits, their counts and the schedule are made on the
        card (the host waits once, for the counts, and sizes the lanes);
        the work is queued on the context's stream and the finisher waits
        on an event recorded behind it, so a caller can plan and dispatch
        the next MSM, or run host work, while the card computes.  On the
        CPU the host plans and the work is done before this returns."""
        n = num_scalars(scalars)
        if n == 0:
            return G1.zero
        if n > self.num_points:
            raise ValueError("more scalars than base points")
        if self._stream is None:
            plan, packed, event = self._host_msm(scalars, n)
        else:
            plan, packed, event = self._card_msm(scalars, n)
        if plan.r_exact == 0:
            return G1.zero

        def finish() -> G1:
            if event is not None:
                with span("wait"):
                    event.synchronize()
            with span("combine"):
                self.hazard_count += int(packed[0, -1])
                w = plan.w_count
                vals = [v * FQ_SPEC.r_inv % FQ_SPEC.modulus
                        for v in raw_ints(packed[:, :3 * w])]
                return _combine_windows(vals[:w], vals[w:2 * w], vals[2 * w:])

        return finish

    def _on_stream(self):
        """The context's stream made current (nothing on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _host_msm(self, scalars, n: int):
        """The MSM planned on the host and run by the wrappers' plain
        versions (the CPU): (plan, the ``(8, 3W + 1)`` result, None)."""
        if isinstance(scalars, torch.Tensor) and scalars.device.type != "cpu":
            raise ValueError(f"scalar words on {scalars.device} for an MSM "
                             f"on {self.device}")
        m = self.m
        chunks = (n + m - 1) // m
        with span("plan"):
            sb = scalars_to_byte_matrix(scalars, n)
            d = signed_digits(sb)
            if not self.valid_np[:n].all():
                d[:, np.nonzero(~self.valid_np[:n])[0]] = 0
            if d.shape[1] < chunks * m:
                d = np.pad(d, ((0, 0), (0, chunks * m - d.shape[1])))
            plan = MsmPlan(d, m, self.lanes)
            count("msm_digits", plan.digits)
        if plan.r_exact == 0:
            return plan, None, None
        lanes = plan.lanes
        with span("upload"):
            digits = torch.from_numpy(d)
            base_map = torch.from_numpy(plan.base_map)
            logk_map = torch.from_numpy(plan.logk_map)
            tail = tuple(torch.from_numpy(t) for t in (
                plan.lane_logk, plan.canon_src, plan.canon_mask))
        with span("launch"):
            X = torch.zeros((_L, lanes), dtype=torch.int32)
            Y = fq.one((lanes,), self.device)
            Z = torch.zeros((_L, lanes), dtype=torch.int32)
            hz = torch.zeros((1,), dtype=torch.int32)
            for g in range(chunks):
                steps = int(plan.rc_per_chunk[g])
                if steps == 0:
                    continue
                sched = build_schedule(digits[:, g * m:(g + 1) * m],
                                       base_map, logk_map, steps, lanes)
                X, Y, Z, hz = insert_steps(
                    sched, self.xs[:, g * m:(g + 1) * m],
                    self.ys[:, g * m:(g + 1) * m], X, Y, Z, hz)
            out = msm_tail(X, Y, Z, *tail, hz, plan.fold_levels)
        return plan, out, None

    def _device_words(self, scalars, n: int) -> torch.Tensor:
        """The scalars as ``(n, 8)`` int32 words on the device, for the
        context's stream: a tensor there as it is (kept alive for the
        stream), host scalars up once through pinned memory."""
        if isinstance(scalars, torch.Tensor) and scalars.device.type != "cpu":
            if scalars.device != self._stream.device:   # "cuda" has an index
                raise ValueError(f"scalar words on {scalars.device} for an "
                                 f"MSM on {self._stream.device}")
            words = _check_words(scalars)[:n]
            words.record_stream(self._stream)
            return words
        sb = scalars_to_byte_matrix(scalars, n)
        staged = torch.empty((n, 32), dtype=torch.uint8, pin_memory=True)
        staged.numpy()[:] = sb
        return staged.to(self.device, non_blocking=True).view(torch.int32)

    def _card_msm(self, scalars, n: int):
        """The MSM planned and run on the card, queued on the context's
        stream behind the work already queued on the current one: (plan,
        the ``(8, 3W + 1)`` result in pinned host memory, window sums X |
        Y | Z side by side and the hazard count in the last lane of limb 0;
        the event recorded behind its copy).  The words, digits and
        schedule are freed in stream order as this returns."""
        dev = self.device
        m = self.m
        chunks = (n + m - 1) // m
        with span("upload"):
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with self._on_stream():
                words = self._device_words(scalars, n)
        with span("plan"):
            with self._on_stream():
                digits, stats = msm_digits(words, self.valid, m)
                del words
                counted = torch.empty(stats.shape, dtype=stats.dtype,
                                      pin_memory=True)
                counted.copy_(stats, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(self._stream)
            ready.synchronize()
            plan = plan_of_stats(counted.numpy(), chunks, self.lanes)
            count("msm_digits", plan.digits)
            count("msm_device_plans", 1)
        if plan.r_exact == 0:
            return plan, None, None
        lanes = plan.lanes
        w_count = plan.w_count
        steps = plan.rc_per_chunk
        row_off = np.cumsum(steps, dtype=np.int32) - steps
        rows = int(steps.sum())
        with span("upload"), self._on_stream():
            # the plan's maps in one pinned copy (a pageable one waits for
            # the stream); the byte tables narrowed on the card
            parts = (plan.base_map.ravel(), plan.logk_map.ravel(),
                     plan.canon_src, steps, row_off, plan.lane_logk,
                     plan.canon_mask)
            maps = torch.from_numpy(np.concatenate(parts).astype(
                np.int32)).pin_memory().to(dev, non_blocking=True)
            (base_map, logk_map, canon_src, steps_d, off_d, lane_logk,
             canon_mask) = torch.split(maps, [p.size for p in parts])
            lane_logk = lane_logk.to(torch.uint8)
            canon_mask = canon_mask.bool()
        with span("launch"), self._on_stream():
            sched = msm_rank(digits, base_map.view(w_count, 129),
                             logk_map.view(w_count, 129), steps_d, off_d,
                             rows, m, lanes)
            del digits
            X = torch.zeros((_L, lanes), dtype=torch.int32, device=dev)
            # the Montgomery one from a cached constant: a fresh host copy
            # would wait for the stream
            Y = const_planes(FQ_SPEC.r_mod_p, self._stream.device).expand(
                _L, lanes).contiguous()
            Z = torch.zeros((_L, lanes), dtype=torch.int32, device=dev)
            hz = torch.zeros((1,), dtype=torch.int32, device=dev)
            for g, (first, count_g) in enumerate(zip(row_off.tolist(),
                                                     steps.tolist())):
                if count_g == 0:
                    continue
                X, Y, Z, hz = insert_steps(
                    sched[first:first + count_g],
                    self.xs[:, g * m:(g + 1) * m],
                    self.ys[:, g * m:(g + 1) * m], X, Y, Z, hz)
            del sched
            out = msm_tail(X, Y, Z, lane_logk, canon_src, canon_mask, hz,
                           plan.fold_levels)
            packed = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            packed.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
            return plan, packed, event
