"""ctypes loader for the port's native host engine (``csrc/tnsh_native.cpp``).

The shared library is compiled with g++ at first use through
``tnsh_torch._build`` into ``build/tnsh_torch/<hash>/`` and loaded lazily:
importing this module builds nothing.  A failed build raises with the
compiler's output; there is no silent pure-Python fallback.  ``available``
is False only when the caller asks for the pure-Python golden path by
setting ``TNSH_NO_NATIVE``; otherwise reading it loads the library.

Handles (``srs_id``, ``tbk``, ``sop`` ...) index tables inside this
library and mean nothing to any other copy of the engine loaded in the
same process.

ABI conventions: 32-byte little-endian field elements; affine G1 points are
64 bytes (x || y), affine G2 points 128 bytes (x.c0 || x.c1 || y.c0 || y.c1);
the all-zero point is the identity.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import List, Optional, Sequence, Tuple

from ..field.limbs import le_bytes

_loaded: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


class _LazyLib:
    """Attribute access loads (and, the first time, builds) the library."""

    def __getattr__(self, name):
        return getattr(_load(), name)


_lib = _LazyLib()


def __getattr__(name):
    if name == "available":
        if os.environ.get("TNSH_NO_NATIVE"):
            return False
        _load()
        return True
    raise AttributeError(name)


def cached_per_mode(maxsize: int):
    """Cache a set-up on its arguments AND the engine mode.

    The decorated function takes the mode as its last argument,
    ``native``; the function returned takes the other arguments, reads
    ``available`` and passes it on.  Its group elements are the same in
    both modes, but a set-up built with the engine holds engine handles
    (``NativeSRS``) that a prove without it must never reach.
    ``cache_clear`` and ``cache_info`` are the one cache's, both modes.
    """
    def wrap(fn):
        inner = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def cached(*args):
            return inner(*args, __getattr__("available"))

        cached.cache_clear = inner.cache_clear
        cached.cache_info = inner.cache_info
        return cached

    return wrap


def _load() -> ctypes.CDLL:
    global _loaded
    if _loaded is not None:
        return _loaded
    with _load_lock:
        if _loaded is None:
            _loaded = _bind(_open())
    return _loaded


def _open() -> ctypes.CDLL:
    from .._build import native_library_path

    lib = ctypes.CDLL(native_library_path())
    lib.tnsh_native_version.restype = ctypes.c_int
    if lib.tnsh_native_version() != 1:
        raise RuntimeError("native engine: unexpected ABI version")
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, argtypes, restype in [
        ("fr_interp_range", [c_u8p, ctypes.c_size_t, c_u8p], None),
        ("fr_horner", [c_u8p, ctypes.c_size_t, c_u8p, c_u8p], None),
        ("fr_quotient", [c_u8p, ctypes.c_size_t, c_u8p, c_u8p], None),
        ("fr_lagrange_tau", [c_u8p, ctypes.c_size_t, c_u8p], None),
        (
            "fr_ml_open",
            [c_u8p, ctypes.c_size_t, c_u8p, ctypes.c_size_t, c_u8p, c_u8p],
            None,
        ),
        ("fr_open_evals", [c_u8p, ctypes.c_size_t, c_u8p, c_u8p, c_u8p], None),
        ("g1_scalar_mul_c", [c_u8p, c_u8p, c_u8p], None),
        ("g1_add_c", [c_u8p, c_u8p, c_u8p], None),
        ("g1_msm", [c_u8p, c_u8p, ctypes.c_size_t, c_u8p], None),
        ("g1_fixed_base_batch", [c_u8p, c_u8p, ctypes.c_size_t, c_u8p], None),
        ("g2_scalar_mul_c", [c_u8p, c_u8p, c_u8p], None),
        ("g2_add_c", [c_u8p, c_u8p, c_u8p], None),
        ("g2_neg_c", [c_u8p, c_u8p], None),
        ("pairing_equal", [c_u8p, c_u8p, c_u8p, c_u8p], ctypes.c_int),
        (
            "pairing_product_is_one_c",
            [c_u8p, c_u8p, ctypes.c_size_t],
            ctypes.c_int,
        ),
        ("srs_create_fixed_base", [c_u8p, c_u8p, ctypes.c_size_t], ctypes.c_int),
        ("srs_create_from_points", [c_u8p, ctypes.c_size_t], ctypes.c_int),
        ("srs_size", [ctypes.c_int], ctypes.c_long),
        ("srs_get_point", [ctypes.c_int, ctypes.c_size_t, c_u8p], None),
        (
            "srs_export_affine",
            [ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t, c_u8p],
            None,
        ),
        (
            "msm_digit_counts",
            [ctypes.POINTER(ctypes.c_int8), ctypes.c_size_t, ctypes.c_size_t,
             ctypes.c_size_t, ctypes.POINTER(ctypes.c_int32)],
            None,
        ),
        ("srs_msm", [ctypes.c_int, c_u8p, ctypes.c_size_t, c_u8p], None),
        ("srs_free", [ctypes.c_int], None),
        (
            "sop_create",
            [c_u8p, ctypes.c_size_t, ctypes.c_size_t,
             ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t, c_u8p],
            ctypes.c_int,
        ),
        ("fs_challenge", [c_u8p, ctypes.c_size_t, c_u8p], None),
        ("sop_round_evals", [ctypes.c_int, c_u8p], None),
        ("sop_bind", [ctypes.c_int, c_u8p], None),
        ("sop_final", [ctypes.c_int, c_u8p], None),
        ("sop_free", [ctypes.c_int], None),
        (
            "tbk_create",
            [ctypes.c_int, ctypes.c_int,
             ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
             c_u8p, c_u8p, c_u8p, c_u8p, c_u8p, c_u8p, c_u8p, c_u8p,
             c_u8p, ctypes.c_size_t, c_u8p, ctypes.c_int],
            ctypes.c_int,
        ),
        ("tbk_round_evals", [ctypes.c_int, c_u8p], None),
        ("tbk_bind", [ctypes.c_int, c_u8p], None),
        ("tbk_free", [ctypes.c_int], None),
        (
            "sbk_create",
            [ctypes.c_int, ctypes.c_int, c_u8p, ctypes.c_size_t,
             ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
             c_u8p, ctypes.c_size_t, c_u8p,
             ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t, ctypes.c_int],
            ctypes.c_int,
        ),
        ("sbk_round_evals", [ctypes.c_int, c_u8p], None),
        ("sbk_bind", [ctypes.c_int, c_u8p], None),
        ("sbk_free", [ctypes.c_int], None),
        (
            "sco_create",
            [ctypes.c_int, ctypes.c_int, c_u8p, ctypes.c_size_t,
             c_u8p, ctypes.c_size_t,
             ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
             c_u8p, ctypes.c_size_t,
             ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
             c_u8p, ctypes.c_size_t,
             c_u8p, ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t],
            ctypes.c_int,
        ),
        ("sco_round_evals", [ctypes.c_int, c_u8p], None),
        ("sco_bind", [ctypes.c_int, c_u8p], None),
        ("sco_set_inc_start", [ctypes.c_int, c_u8p, ctypes.c_size_t], None),
        ("sco_inc_totals", [ctypes.c_int, c_u8p], None),
        ("sco_make_sop", [ctypes.c_int], ctypes.c_int),
        ("sco_free", [ctypes.c_int], None),
        (
            "fr_rlc",
            [c_u8p, ctypes.c_size_t, ctypes.c_size_t, c_u8p, c_u8p],
            None,
        ),
        (
            "fr_mle_eval_many",
            [c_u8p, ctypes.c_size_t, ctypes.c_size_t, c_u8p,
             ctypes.c_size_t, c_u8p],
            None,
        ),
        ("fr_eq_table", [c_u8p, ctypes.c_int, c_u8p], None),
        ("fr_lt_table", [c_u8p, ctypes.c_int, c_u8p], None),
        (
            "wt_col_scalars",
            [ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
             c_u8p, ctypes.c_longlong, c_u8p, ctypes.c_longlong,
             ctypes.c_int, c_u8p, ctypes.POINTER(ctypes.c_uint64)],
            None,
        ),
        (
            "wt_residue",
            [ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
             c_u8p, ctypes.c_longlong, c_u8p, ctypes.c_longlong,
             ctypes.c_int, c_u8p, ctypes.POINTER(ctypes.c_uint64)],
            None,
        ),
        (
            "wt_export_std",
            [ctypes.POINTER(ctypes.c_uint64), ctypes.c_longlong, c_u8p],
            None,
        ),
        (
            "wt_mle",
            [ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
             c_u8p, ctypes.c_longlong, c_u8p, ctypes.c_longlong, c_u8p,
             ctypes.c_int, c_u8p],
            None,
        ),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _buf(data: bytes):
    return ctypes.cast(
        ctypes.create_string_buffer(data, len(data)),
        ctypes.POINTER(ctypes.c_uint8),
    )


def _out(n: int):
    raw = ctypes.create_string_buffer(n)
    return raw, ctypes.cast(raw, ctypes.POINTER(ctypes.c_uint8))


# -- typed helpers over host objects ----------------------------------------

def _g1_to_bytes(p) -> bytes:
    x, y = p.to_affine()
    return x.to_bytes(32, "little") + y.to_bytes(32, "little")


def _g1_from_bytes(data: bytes):
    from ..field.g1 import G1

    x = int.from_bytes(data[:32], "little")
    y = int.from_bytes(data[32:], "little")
    if x == 0 and y == 0:
        return G1.zero()
    return G1(x, y, 1)


def _g2_to_bytes(p) -> bytes:
    (x, y) = p.to_affine()
    return (
        x[0].to_bytes(32, "little")
        + x[1].to_bytes(32, "little")
        + y[0].to_bytes(32, "little")
        + y[1].to_bytes(32, "little")
    )


def interp_range(values) -> list:
    """Native Newton interpolation over {0..n-1} (list of Fr -> list of Fr)."""
    from ..field.fr import Fr

    n = len(values)
    if n == 0:
        return []
    data = b"".join(int(v).to_bytes(32, "little") for v in values)
    raw, out = _out(32 * n)
    _lib.fr_interp_range(_buf(data), n, out)
    return [Fr(int.from_bytes(raw.raw[32 * i:32 * i + 32], "little")) for i in range(n)]


def horner(coeffs, point):
    from ..field.fr import Fr

    data = b"".join(int(c).to_bytes(32, "little") for c in coeffs)
    raw, out = _out(32)
    _lib.fr_horner(_buf(data), len(coeffs), _buf(int(point).to_bytes(32, "little")), out)
    return Fr(int.from_bytes(raw.raw, "little"))


def quotient(coeffs, z) -> list:
    from ..field.fr import Fr

    n = len(coeffs)
    if n < 2:
        return []
    data = b"".join(int(c).to_bytes(32, "little") for c in coeffs)
    raw, out = _out(32 * (n - 1))
    _lib.fr_quotient(_buf(data), n, _buf(int(z).to_bytes(32, "little")), out)
    return [
        Fr(int.from_bytes(raw.raw[32 * i:32 * i + 32], "little"))
        for i in range(n - 1)
    ]


def msm(points, scalars):
    """Native Pippenger MSM over host G1 points / Fr scalars."""
    n = min(len(points), len(scalars))
    pts = b"".join(_g1_to_bytes(p) for p in points[:n])
    scs = b"".join(int(s).to_bytes(32, "little") for s in scalars[:n])
    raw, out = _out(64)
    _lib.g1_msm(_buf(pts), _buf(scs), n, out)
    return _g1_from_bytes(raw.raw)


def g1_scalar_mul(point, scalar):
    raw, out = _out(64)
    _lib.g1_scalar_mul_c(
        _buf(_g1_to_bytes(point)), _buf(int(scalar).to_bytes(32, "little")), out
    )
    return _g1_from_bytes(raw.raw)


def fixed_base_batch(base, scalars) -> list:
    """[s * base for s in scalars] with a shared window table (setup path)."""
    n = len(scalars)
    if n == 0:
        return []
    scs = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    raw, out = _out(64 * n)
    _lib.g1_fixed_base_batch(_buf(_g1_to_bytes(base)), _buf(scs), n, out)
    return [
        _g1_from_bytes(raw.raw[64 * i:64 * i + 64]) for i in range(n)
    ]


def g2_scalar_mul(point, scalar):
    from ..field.g2 import G2

    raw, out = _out(128)
    _lib.g2_scalar_mul_c(
        _buf(_g2_to_bytes(point)), _buf(int(scalar).to_bytes(32, "little")), out
    )
    d = raw.raw
    x = (int.from_bytes(d[:32], "little"), int.from_bytes(d[32:64], "little"))
    y = (int.from_bytes(d[64:96], "little"), int.from_bytes(d[96:], "little"))
    if x == (0, 0) and y == (0, 0):
        return G2.zero()
    return G2(x, y)


def fs_challenge(state: bytes) -> int:
    """Fiat-Shamir challenge over the transcript byte state (standard form).

    Native twin of Transcript.challenge_field_element's digest->seed->Fr::rand
    pipeline (reference utils.rs:172-192); returns the Fr value as an int.
    """
    raw, out = _out(32)
    _lib.fs_challenge(_buf(state), len(state), out)
    return int.from_bytes(raw.raw, "little")


def pairing_equal(a1, a2, b1, b2) -> bool:
    """e(a1, a2) == e(b1, b2) with one shared final exponentiation."""
    return bool(
        _lib.pairing_equal(
            _buf(_g1_to_bytes(a1)),
            _buf(_g2_to_bytes(a2)),
            _buf(_g1_to_bytes(b1)),
            _buf(_g2_to_bytes(b2)),
        )
    )


def pairing_product_is_one(pairs) -> bool:
    g1s = b"".join(_g1_to_bytes(p) for p, _ in pairs)
    g2s = b"".join(_g2_to_bytes(q) for _, q in pairs)
    return bool(_lib.pairing_product_is_one_c(_buf(g1s), _buf(g2s), len(pairs)))


def _scalar_bytes(scalars) -> tuple:
    """(raw bytes, count) for a scalar sequence; raw bytes pass through."""
    if isinstance(scalars, (bytes, bytearray)):
        return bytes(scalars), len(scalars) // 32
    return le_bytes(scalars), len(scalars)


def fr_lagrange_tau(tau, n: int) -> bytes:
    """Raw bytes of [L_i(tau)]_{i<n} for the domain {0..n-1} (n * 32 B)."""
    raw, out = _out(32 * n)
    _lib.fr_lagrange_tau(_buf(int(tau).to_bytes(32, "little")), n, out)
    return raw.raw


def fr_eq_table(point) -> bytes:
    """Raw bytes of [eq(b, point)] over {0,1}^n, little-endian bit order."""
    pb = b"".join(int(p).to_bytes(32, "little") for p in point)
    raw, out = _out(32 << len(point))
    _lib.fr_eq_table(_buf(pb), len(point), out)
    return raw.raw


def fr_lt_table(y) -> bytes:
    """Raw bytes of [lt~(bits(j), y)] over {0,1}^n."""
    pb = b"".join(int(p).to_bytes(32, "little") for p in y)
    raw, out = _out(32 << len(y))
    _lib.fr_lt_table(_buf(pb), len(y), out)
    return raw.raw


# -- witness-table (CSR) kernels ---------------------------------------------

def _i32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def wt_csr(cols):
    """CSR for ONE per-column entry-list table: (off_np, pos_np, val_bytes).
    Cache the result per table — the marshal is the expensive part."""
    return _sco_csr([cols], len(cols))


class WtAccumulator:
    """A Montgomery-form accumulator of ``n`` Fr values for the witness
    kernels: several coeff-weighted tables accumulate in, one export out
    (the RLC batch opener's scalar combiner)."""

    __slots__ = ("n", "_raw", "_ptr")

    def __init__(self, n: int):
        self.n = n
        self._raw = ctypes.create_string_buffer(32 * n)
        self._ptr = ctypes.cast(self._raw,
                                ctypes.POINTER(ctypes.c_uint64))

    def add_col_scalars(self, csr, eqk, k_size: int, incremental: bool,
                        coeff: int = 1) -> "WtAccumulator":
        off, pos, val = csr
        _lib.wt_col_scalars(
            _i32p(off), _i32p(pos), _buf(val), self.n,
            _buf(le_bytes(eqk)), k_size,
            1 if incremental else 0,
            _buf(int(coeff).to_bytes(32, "little")), self._ptr,
        )
        return self

    def add_residue(self, csr, t_size: int, eqw, incremental: bool,
                    coeff: int = 1) -> "WtAccumulator":
        off, pos, val = csr
        _lib.wt_residue(
            _i32p(off), _i32p(pos), _buf(val), t_size,
            _buf(le_bytes(eqw)), self.n,
            1 if incremental else 0,
            _buf(int(coeff).to_bytes(32, "little")), self._ptr,
        )
        return self

    def export(self) -> bytes:
        raw, out = _out(32 * self.n)
        _lib.wt_export_std(self._ptr, self.n, out)
        return raw.raw


def wt_mle(csr, t_size: int, eqk, k_size: int, eqj, incremental: bool):
    """~table(point) from the eq tables of the point's k/j parts."""
    from ..field.fr import Fr

    off, pos, val = csr
    raw, out = _out(32)
    _lib.wt_mle(_i32p(off), _i32p(pos), _buf(val), t_size,
                _buf(le_bytes(eqk)), k_size, _buf(le_bytes(eqj)),
                1 if incremental else 0, out)
    return Fr(int.from_bytes(raw.raw, "little"))


def fr_ml_open(values, point):
    """(value, [quotient_bytes per variable]) of a multilinear opening.

    ``values``: 2^n Fr/ints or raw bytes; ``point``: n field elements.
    Level i's quotient table has 2^(n-1-i) elements."""
    from ..field.fr import Fr

    vals, size = _scalar_bytes(values)
    n_vars = size.bit_length() - 1
    pt = b"".join(int(p).to_bytes(32, "little") for p in point)
    raw_q, out_q = _out(32 * max(size - 1, 1))
    raw_v, out_v = _out(32)
    _lib.fr_ml_open(_buf(vals), size, _buf(pt), n_vars, out_q, out_v)
    levels = []
    off = 0
    for v in range(n_vars):
        half = size >> (v + 1)
        levels.append(raw_q.raw[32 * off:32 * (off + half)])
        off += half
    return Fr(int.from_bytes(raw_v.raw, "little")), levels


def fr_open_evals(values, z):
    """(value, quotient_bytes) of the {0..n-1}-interpolant opening at z.

    ``values`` may be a sequence of Fr or raw bytes.  Matches
    barycentric_eval + the Python quotient loop bit-for-bit."""
    from ..field.fr import Fr

    vals, n = _scalar_bytes(values)
    raw_q, out_q = _out(32 * n)
    raw_v, out_v = _out(32)
    _lib.fr_open_evals(_buf(vals), n, _buf(int(z).to_bytes(32, "little")),
                       out_q, out_v)
    return Fr(int.from_bytes(raw_v.raw, "little")), raw_q.raw


# -- native-resident SRS handles --------------------------------------------

def srs_create_fixed_base(base, scalars) -> int:
    """Build {s_i * base} in native memory; returns a handle id.
    ``scalars`` may be a sequence of Fr or raw 32 B/elem bytes."""
    scs, n = _scalar_bytes(scalars)
    return int(_lib.srs_create_fixed_base(_buf(_g1_to_bytes(base)), _buf(scs),
                                          n))


def srs_create_from_points(points) -> int:
    data = b"".join(_g1_to_bytes(p) for p in points)
    return int(_lib.srs_create_from_points(_buf(data), len(points)))


def srs_size(srs_id: int) -> int:
    return int(_lib.srs_size(srs_id))


def srs_point(srs_id: int, idx: int):
    raw, out = _out(64)
    _lib.srs_get_point(srs_id, idx, out)
    return _g1_from_bytes(raw.raw)


def msm_digit_counts(digits, m: int):
    """(chunks, w_count, 129) int32 occupancy counts of an (w_count, n_pad)
    int8 signed-digit matrix, chunked by m columns."""
    import numpy as np

    d = np.ascontiguousarray(digits, dtype=np.int8)
    w_count, n_pad = d.shape
    chunks = n_pad // m
    out = np.zeros((chunks, w_count, 129), dtype=np.int32)
    _lib.msm_digit_counts(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        w_count, n_pad, m,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def srs_export_affine(srs_id: int, start: int = 0, count: int = -1) -> bytes:
    """Standard-form affine bytes (64 B/point) for SRS points
    [start, start+count); identity points are all-zero."""
    if count < 0:
        count = srs_size(srs_id) - start
    raw, out = _out(64 * count)
    _lib.srs_export_affine(srs_id, start, count, out)
    return raw.raw


def srs_msm(srs_id: int, scalars):
    """MSM of the first len(scalars) SRS points against the scalars
    (sequence of Fr or raw 32 B/elem bytes)."""
    scs, n = _scalar_bytes(scalars)
    raw, out = _out(64)
    _lib.srs_msm(srs_id, _buf(scs), n, out)
    return _g1_from_bytes(raw.raw)


def srs_free(srs_id: int) -> None:
    _lib.srs_free(srs_id)


# -- native sum-of-products sum-check oracle ---------------------------------

def sop_create(tables, terms) -> int:
    """Create a native oracle handle.

    ``tables``: list of equal-length int/Fr lists; ``terms``: list of
    ``(coeff, [table_index, ...])``.  Returns a handle id."""
    size = len(tables[0])
    blob = b"".join(le_bytes(t) for t in tables)
    spec = []
    coeffs = b""
    for coeff, idxs in terms:
        spec.append(len(idxs))
        spec.extend(idxs)
        coeffs += int(coeff).to_bytes(32, "little")
    spec_arr = (ctypes.c_int32 * len(spec))(*spec)
    return int(
        _lib.sop_create(_buf(blob), len(tables), size, spec_arr,
                        len(terms), _buf(coeffs))
    )


def sop_round_evals(sop_id: int):
    from ..field.fr import Fr

    raw, out = _out(4 * 32)
    _lib.sop_round_evals(sop_id, out)
    return [
        Fr(int.from_bytes(raw.raw[32 * i:32 * i + 32], "little"))
        for i in range(4)
    ]


def sop_bind(sop_id: int, r) -> None:
    _lib.sop_bind(sop_id, _buf(int(r).to_bytes(32, "little")))


def sop_final(sop_id: int):
    from ..field.fr import Fr

    raw, out = _out(32)
    _lib.sop_final(sop_id, out)
    return Fr(int.from_bytes(raw.raw, "little"))


def sop_free(sop_id: int) -> None:
    _lib.sop_free(sop_id)


# -- native sparse-cube sum-check oracle (k-phase) ----------------------------

def _sco_csr(tabs, t_size: int):
    """Global CSR arrays for a list of per-column entry lists.

    Returns (off_np, pos_np, val_bytes): int32 numpy arrays (callers pass
    ``arr.ctypes.data_as(...)`` and must keep the arrays alive across the
    native call) — building 1M-entry ctypes arrays element-wise cost ~1 s
    per prove at T=2^20."""
    import numpy as _np

    lens: List[int] = []
    poss: List[int] = []
    vals: List[int] = []
    for cols in tabs:
        for col in cols:
            lens.append(len(col))
            for p, v in col:
                poss.append(p)
                vals.append(int(v))
        # each table contributes t_size+1 offsets (incl. its leading one)
    n_off = len(lens) + len(tabs)
    off_np = _np.zeros(max(n_off, 1), dtype=_np.int32)
    if lens:
        # per-table leading offset repeats the running total: splice the
        # cumsum with duplicates at each table boundary
        cs = _np.cumsum(_np.asarray(lens, dtype=_np.int64))
        out_i = 0
        in_i = 0
        for cols in tabs:
            off_np[out_i] = cs[in_i - 1] if in_i else 0
            k = len(cols)
            off_np[out_i + 1:out_i + 1 + k] = cs[in_i:in_i + k]
            out_i += 1 + k
            in_i += k
    pos_np = _np.asarray(poss if poss else [0], dtype=_np.int32)
    return off_np, pos_np, le_bytes(vals)


def _sco_csr_concat(csrs):
    """Combine per-table CSRs (from ``wt_csr``, cached on the tables) into
    the multi-table layout ``sco_create`` expects — numpy concat only, no
    per-entry Python work."""
    import numpy as _np

    offs = []
    poss = []
    vals = []
    base = 0
    for off, pos, val in csrs:
        nnz = len(val) // 32
        offs.append(off.astype(_np.int64) + base)
        if nnz:
            poss.append(pos[:nnz])
        vals.append(val)
        base += nnz
    if not offs:
        return (_np.zeros(1, _np.int32), _np.zeros(1, _np.int32), b"")
    off_np = _np.concatenate(offs).astype(_np.int32)
    pos_np = (_np.concatenate(poss).astype(_np.int32)
              if poss else _np.zeros(1, _np.int32))
    return off_np, pos_np, b"".join(vals)


def sco_create(log_k: int, log_t: int, eqk_tables, eqj_tables, sparse_tabs,
               inc_tabs, coeffs, term_spec,
               sparse_csrs=None, inc_csrs=None) -> int:
    """Create a native sparse-cube oracle handle.

    ``eqk_tables``: list of 2^log_k-int lists; ``eqj_tables``: list of
    2^log_t-int lists; ``sparse_tabs``/``inc_tabs``: lists of per-column
    ``[(pos, value), ...]`` lists (2^log_t columns each); ``coeffs``: per
    term an int; ``term_spec``: per term ``(sp_idx, sp_power, eqj_idx list,
    eqk_idx list, inc_idx list)``.  Per-column term weights are computed
    natively.  ``sparse_csrs``/``inc_csrs``: optional per-table cached CSRs
    (``wt_csr``) matching the tab lists — skips the per-entry re-marshal."""
    t_size = 1 << log_t
    eqk_blob = b"".join(le_bytes(t) for t in eqk_tables)
    eqj_blob = b"".join(le_bytes(t) for t in eqj_tables)
    if sparse_csrs is not None:
        sp_off, sp_pos, sp_val = _sco_csr_concat(sparse_csrs)
    else:
        sp_off, sp_pos, sp_val = _sco_csr(sparse_tabs, t_size)
    if inc_csrs is not None:
        inc_off, inc_pos, inc_val = _sco_csr_concat(inc_csrs)
    else:
        inc_off, inc_pos, inc_val = _sco_csr(inc_tabs, t_size)
    c_blob = b"".join(int(c).to_bytes(32, "little") for c in coeffs)
    spec: List[int] = []
    for sp_idx, sp_power, eqj_idx, eqk_idx, inc_idx in term_spec:
        spec.append(sp_idx)
        spec.append(sp_power)
        spec.append(len(eqj_idx))
        spec.extend(eqj_idx)
        spec.append(len(eqk_idx))
        spec.extend(eqk_idx)
        spec.append(len(inc_idx))
        spec.extend(inc_idx)
    spec_arr = (ctypes.c_int32 * len(spec))(*spec)

    def _i32p(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    return int(_lib.sco_create(
        log_k, log_t, _buf(eqk_blob), len(eqk_tables),
        _buf(eqj_blob), len(eqj_tables),
        _i32p(sp_off), _i32p(sp_pos), _buf(sp_val), len(sparse_tabs),
        _i32p(inc_off), _i32p(inc_pos), _buf(inc_val), len(inc_tabs),
        _buf(c_blob), spec_arr, len(term_spec),
    ))


def sco_round_evals(sco_id: int):
    from ..field.fr import Fr

    raw, out = _out(4 * 32)
    _lib.sco_round_evals(sco_id, out)
    return [
        Fr(int.from_bytes(raw.raw[32 * i:32 * i + 32], "little"))
        for i in range(4)
    ]


def sco_bind(sco_id: int, r) -> None:
    _lib.sco_bind(sco_id, _buf(int(r).to_bytes(32, "little")))


def sco_set_inc_start(sco_id: int, states) -> None:
    """Seed the next round's colinc scan: ``states`` holds, per inc
    table, K_rem ints at the current fold level (an empty list clears the
    seed; a bind clears it too)."""
    blob = b"".join(le_bytes(v) for v in states)
    _lib.sco_set_inc_start(sco_id, _buf(blob), len(states))


def sco_inc_totals(sco_id: int, n_inc: int, k_rem: int) -> List[List[int]]:
    """Per inc table, the sum of its deltas at each of the K_rem residual
    positions of the current fold level."""
    raw, out = _out(32 * n_inc * k_rem)
    _lib.sco_inc_totals(sco_id, out)
    vals = [int.from_bytes(raw.raw[32 * i:32 * i + 32], "little")
            for i in range(n_inc * k_rem)]
    return [vals[i * k_rem:(i + 1) * k_rem] for i in range(n_inc)]


def sco_make_sop(sco_id: int) -> int:
    """Build the dense j-phase delegate's native sop handle directly from
    the folded sco state (no Python round-trip of the T-sized tables)."""
    return int(_lib.sco_make_sop(sco_id))


def sco_free(sco_id: int) -> None:
    _lib.sco_free(sco_id)


# -- bit-column sound protocols: native k-phase oracles ----------------------

def _u64_arr(vals):
    """numpy uint64 array + ctypes pointer (keep the array alive)."""
    import numpy as _np

    arr = _np.ascontiguousarray(vals, dtype=_np.uint64)
    if arr.size == 0:
        arr = _np.zeros(1, dtype=_np.uint64)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def tbk_create(log_k: int, log_t: int, r_addr, w_addr, ot_flags,
               rv, wv, ic, eq1, eqsj, eqb, eqsk, apow, kinv,
               npts: int) -> int:
    """Native TwistBits phase-A k-round state (tnsh_torch.iop.bits_oracle.
    TwistBitsSparseOracle's fast path).  The inputs' marshalling is the
    span ``marshal``."""
    import numpy as _np

    from ..utils.profiling import span

    with span("marshal"):
        ra_np, ra_p = _u64_arr(r_addr)
        wa_np, wa_p = _u64_arr(w_addr)
        flags = _np.ascontiguousarray(ot_flags, dtype=_np.bool_).tobytes()
        args = (
            log_k, log_t, ra_p, wa_p, _buf(flags), _buf(le_bytes(rv)),
            _buf(le_bytes(wv)), _buf(le_bytes(ic)),
            _buf(le_bytes(eq1)), _buf(le_bytes(eqsj)),
            _buf(le_bytes(eqb)), _buf(le_bytes(eqsk)),
            _buf(le_bytes(apow)), len(apow),
            _buf(int(kinv).to_bytes(32, "little")), npts,
        )
    return int(_lib.tbk_create(*args))


def tbk_round_evals(tbk_id: int, npts: int):
    from ..field.fr import Fr

    raw, out = _out(npts * 32)
    _lib.tbk_round_evals(tbk_id, out)
    return [
        Fr(int.from_bytes(raw.raw[32 * i:32 * i + 32], "little"))
        for i in range(npts)
    ]


def tbk_bind(tbk_id: int, r) -> None:
    _lib.tbk_bind(tbk_id, _buf(int(r).to_bytes(32, "little")))


def tbk_free(tbk_id: int) -> None:
    _lib.tbk_free(tbk_id)


def sbk_create(log_k: int, log_t: int, j_tables, addr_tables, k_tables,
               terms, npts: int) -> int:
    """Native ShoutBits k-phase state.

    ``terms``: ``(coeff, jt_idx_list, addr_idx_or_None, kt_idx_or_None)``.
    The inputs' marshalling is the span ``marshal``.
    """
    import numpy as _np

    from ..utils.profiling import span

    t_size = 1 << log_t
    with span("marshal"):
        jt_blob = b"".join(le_bytes(t) for t in j_tables)
        ad_np, ad_p = _u64_arr(_np.concatenate(addr_tables)
                               if addr_tables else [])
        kt_blob = b"".join(le_bytes(t) for t in k_tables)
        spec = []
        coeffs = b""
        for coeff, jt_idx, a_idx, k_idx in terms:
            spec.append(len(jt_idx))
            spec.extend(jt_idx)
            spec.append(-1 if a_idx is None else a_idx)
            spec.append(-1 if k_idx is None else k_idx)
            coeffs += int(coeff).to_bytes(32, "little")
        spec_arr = (ctypes.c_int32 * len(spec))(*spec)
    assert all(len(a) == t_size for a in addr_tables)
    return int(_lib.sbk_create(
        log_k, log_t, _buf(jt_blob), len(j_tables), ad_p, len(addr_tables),
        _buf(kt_blob), len(k_tables), _buf(coeffs), spec_arr, len(terms),
        npts,
    ))


def sbk_round_evals(sbk_id: int, npts: int):
    from ..field.fr import Fr

    raw, out = _out(npts * 32)
    _lib.sbk_round_evals(sbk_id, out)
    return [
        Fr(int.from_bytes(raw.raw[32 * i:32 * i + 32], "little"))
        for i in range(npts)
    ]


def sbk_bind(sbk_id: int, r) -> None:
    _lib.sbk_bind(sbk_id, _buf(int(r).to_bytes(32, "little")))


def sbk_free(sbk_id: int) -> None:
    _lib.sbk_free(sbk_id)


def fr_rlc(tables, gamma) -> bytes:
    """Raw bytes of ``sum_i gamma^i * tables[i]`` pointwise (the gamma-RLC
    table for batched PST openings)."""
    size = len(tables[0])
    blob = b"".join(le_bytes(t) for t in tables)
    raw, out = _out(32 * size)
    _lib.fr_rlc(_buf(blob), len(tables), size,
                _buf(int(gamma).to_bytes(32, "little")), out)
    return raw.raw


def fr_mle_eval_many(tables, point):
    """[~table(point) for each table] — one native call for a batch of
    equal-length columns (variable 0 folded first)."""
    from ..field.fr import Fr

    size = len(tables[0])
    n_vars = size.bit_length() - 1
    blob = b"".join(le_bytes(t) for t in tables)
    pt = b"".join(int(p).to_bytes(32, "little") for p in point)
    raw, out = _out(32 * len(tables))
    _lib.fr_mle_eval_many(_buf(blob), len(tables), size, _buf(pt),
                          n_vars, out)
    return [
        Fr(int.from_bytes(raw.raw[32 * i:32 * i + 32], "little"))
        for i in range(len(tables))
    ]
