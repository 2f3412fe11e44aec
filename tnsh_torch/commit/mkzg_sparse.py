"""Factorized sparse PST commitments for (k, j)-cube witnesses.

Counterpart of ``tnsh/commit/mkzg_sparse.py``.  Sound-mode witnesses live
on the (memory x time) cube with index x = j*K + k (variable 0 = k_0, the
fastest bit).  The PST Lagrange basis factorizes over the variable split:

    [eq(x, taus)]_1 = eq(k, tau_k-part) * [eq(j, tau_j-part)]_1

so a commitment to a cube table is ONE T-point MSM with scalars
s_j = column_j~(tau_k-part): for a column-sparse table (ra one-hots) the
weighted sum of the column's few entries, O(nnz) field work; for a
column-incremental one (Twist's Val) the prefix sums of its weighted
deltas, O(T).  ``commit_cube_async`` dispatches several such MSMs before
any is waited for.

Openings fold the j variables FIRST: the j-level quotients are plain
odd-even differences of the T-vector s_j, each committed as one MSM over
the matching j-suffix SRS; after the j variables bind, the k-residue
g(k) = sum_j eq(j, r_j) col_j(k) is a K-vector whose levels commit over a
k-suffix SRS.  Quotients come out in VARIABLE order (k levels first);
the PST verifier accepts any peeling order, so only the proof BYTES
differ from the suffix-order ``MultilinearKZG.open``, and the dense sound
prover uses ``open_dense_cube`` (the same order) so dense and sparse proofs
stay byte-identical.

Every MSM goes through the router of ``tnsh_torch.commit.kzg`` on the
device the caller names (``srs_msm_async`` over a native-resident SRS,
``msm`` over explicit points); an opening dispatches every level's MSM
before it waits for any.  ``prepare_device`` uploads the segments those
MSMs use once, as set-up work.

The column scalars, the sparse MLE evaluations and the k residue come
from the native witness accumulator over each table's CSR view, or under
``TNSH_NO_NATIVE`` from Python ints over the (position, value) lists, as
the JAX package's fallback computes them: the same values either way.

The factorized scalars need tau_k, known under the repo's DETERMINISTIC
setup only; under an external ceremony SRS the sparse prover refuses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

from .. import _native
from ..core.params import SETUP_SEED, NativeSRS
from ..core.rng import ChaCha20Rng, fr_rand
from ..errors import CommitmentError
from ..field.fr import MODULUS, Fr, FrTable
from ..field.g1 import G1
from ..field.g2 import G2
from ..utils.profiling import span
from . import kzg
from .kzg import (
    KZGCommitmentValue,
    device_srs_context,
    msm,
    srs_msm_async,
)
from .mkzg import MLOpeningProof, MLVerificationKey

_P = MODULUS


def eq_table_ints(point: Sequence[int]):
    """eq(b, point) for all b, little-endian (bit 0 = point[0]).

    Large tables come back as a bytes-backed ``FrTable`` (same values,
    list-like) built by the native kernel."""
    if len(point) >= 11 and _native.available:
        return FrTable(_native.fr_eq_table([int(p) % _P for p in point]))
    table = [1]
    for t in point:
        ti = int(t) % _P
        nt = (1 - ti) % _P
        table = [v * nt % _P for v in table] + [v * ti % _P for v in table]
    return table


@dataclass
class CubeParams:
    """Factorized SRS for (log_k + log_t)-variable cube commitments."""

    log_k: int
    log_t: int
    taus: List[Fr]                       # all log_k + log_t trapdoors
    j_bases: List[object]                # j-suffix SRS levels (NativeSRS or
    #                                      G1 lists), sizes 2^(log_t - l)
    k_bases: List[object]                # k-suffix SRS levels,
    #                                      sizes 2^(log_k - l)
    eqk_tables: List[List[int]]          # eq-tables of tau_k suffixes,
    #                                      eqk_tables[i] = eq(. , taus[i:log_k])
    vk: MLVerificationKey


@_native.cached_per_mode(32)
def cube_params(log_k: int, log_t: int, native: bool) -> CubeParams:
    """Deterministic factorized setup: SAME taus (ChaCha prefix) as
    ``setup_multilinear_params(log_k + log_t)``, but only O(T + K) points
    are ever materialized; called as ``cube_params(log_k, log_t)``.
    Cached per size and engine mode: with the engine the bases are
    ``NativeSRS`` handles, under ``TNSH_NO_NATIVE`` lists of ``G1`` (the
    same elements)."""
    n = log_k + log_t
    rng = ChaCha20Rng.from_seed(SETUP_SEED)
    taus = [fr_rand(rng) for _ in range(n)]
    tau_j = [int(t) for t in taus[log_k:]]
    g1 = G1.generator()
    g2 = G2.generator()

    def make_base(scalars) -> object:
        if native:
            seg = getattr(scalars, "raw", None)  # FrTable: zero-copy
            if seg is None:
                seg = b"".join(s.to_bytes(32, "little") for s in scalars)
            return NativeSRS(_native.srs_create_fixed_base(g1, seg))
        return [g1.scalar_mul(s) for s in scalars]

    tau_k = [int(t) for t in taus[:log_k]]
    j_bases = [make_base(eq_table_ints(tau_j[lv:])) for lv in range(log_t + 1)]
    k_bases = [make_base(eq_table_ints(tau_k[lv:])) for lv in range(log_k + 1)]
    eqk_tables = [
        list(eq_table_ints([int(t) for t in taus[i:log_k]]))
        for i in range(log_k + 1)
    ]
    if native:
        g2_taus = [_native.g2_scalar_mul(g2, t) for t in taus]
    else:
        g2_taus = [g2.scalar_mul(int(t)) for t in taus]
    vk = MLVerificationKey(g1_generator=g1, g2_generator=g2, g2_taus=g2_taus)
    return CubeParams(
        log_k=log_k, log_t=log_t, taus=taus,
        j_bases=j_bases, k_bases=k_bases, eqk_tables=eqk_tables, vk=vk,
    )


def prepare_device(params: CubeParams, device) -> None:
    """Upload every SRS segment that a commitment or an opening on
    ``device`` will send there (those of ``DEVICE_MSM_MIN`` points or
    more), once: set-up work, kept out of the first commitment's time.
    ``k_bases[0]`` is left out: no MSM runs over it."""
    for seg in list(params.j_bases) + list(params.k_bases[1:]):
        if isinstance(seg, NativeSRS) and len(seg) >= kzg.DEVICE_MSM_MIN:
            device_srs_context(seg.srs_id, device)


# ---------------------------------------------------------------------------
# Cube table representations
# ---------------------------------------------------------------------------

class SparseCubeTable:
    """Column-sparse (k, j) table: per cycle j a few (position, value)
    entries over the k-cube (ra/wa: one; inc: at most one)."""

    def __init__(self, log_k: int, log_t: int):
        self.log_k = log_k
        self.log_t = log_t
        self.cols: List[List[Tuple[int, int]]] = [
            [] for _ in range(1 << log_t)
        ]
        self._csr = None

    def set(self, j: int, k: int, value: int) -> None:
        self.cols[j].append((k, int(value) % _P))
        self._csr = None

    def csr(self):
        """Native CSR view, marshalled once and cached until mutation."""
        if self._csr is None:
            self._csr = _native.wt_csr(self.cols)
        return self._csr

    def to_dense(self) -> List[int]:
        k_size = 1 << self.log_k
        out = [0] * (k_size << self.log_t)
        for j, col in enumerate(self.cols):
            for k, v in col:
                out[j * k_size + k] = (out[j * k_size + k] + v) % _P
        return out


class IncrementalCubeTable:
    """Column-incremental (k, j) table: column j+1 = column j + sparse
    updates applied AT cycle j (Twist's Val: one write per cycle).  Column 0
    is all-zero (memory starts zeroed)."""

    def __init__(self, log_k: int, log_t: int):
        self.log_k = log_k
        self.log_t = log_t
        #: updates[j] applied after column j is read
        self.updates: List[List[Tuple[int, int]]] = [
            [] for _ in range(1 << log_t)
        ]
        self._csr = None

    def add_update(self, j: int, k: int, delta: int) -> None:
        self.updates[j].append((k, int(delta) % _P))
        self._csr = None

    def csr(self):
        """Native CSR view, marshalled once and cached until mutation."""
        if self._csr is None:
            self._csr = _native.wt_csr(self.updates)
        return self._csr

    def to_dense(self) -> List[int]:
        k_size = 1 << self.log_k
        cur = [0] * k_size
        out = [0] * (k_size << self.log_t)
        for j in range(1 << self.log_t):
            out[j * k_size: (j + 1) * k_size] = cur
            for k, d in self.updates[j]:
                cur[k] = (cur[k] + d) % _P
        return out


# ---------------------------------------------------------------------------
# Commit
# ---------------------------------------------------------------------------

def _msm_async(base: object, scalars, device):
    """Dispatch one MSM over ``base`` through the router; returns its
    finisher.  A native-resident SRS goes to ``srs_msm_async``, explicit
    points to ``msm`` (which runs in the finisher)."""
    if isinstance(base, NativeSRS):
        return srs_msm_async(base.srs_id, scalars, device)
    return lambda: msm(base, scalars, device)


def _col_scalars(table, eqk) -> List[int]:
    """s_j = <column_j, eqk> for every cycle j of one cube table, in Python
    ints: an ``IncrementalCubeTable``'s column j is the sum of the updates
    before cycle j, so its s_j are prefix sums of the weighted deltas."""
    if isinstance(table, IncrementalCubeTable):
        scalars: List[int] = []
        cur = 0
        for ups in table.updates:
            scalars.append(cur)
            for k, d in ups:
                cur = (cur + d * eqk[k]) % _P
        return scalars
    return [sum(v * eqk[k] for k, v in col) % _P for col in table.cols]


def _commit_scalars(params: CubeParams, table):
    """The T-vector of eq(tau_k)-weighted column scalars of one cube table
    (the prefix-sum form for an ``IncrementalCubeTable``): bytes from the
    native accumulator, under ``TNSH_NO_NATIVE`` a list of ints."""
    eqk = params.eqk_tables[0]
    if _native.available:
        return _native.WtAccumulator(1 << params.log_t).add_col_scalars(
            table.csr(), eqk, 1 << params.log_k,
            isinstance(table, IncrementalCubeTable)).export()
    return _col_scalars(table, eqk)


def commit_cube_async(params: CubeParams, tables, device
                      ) -> List[Callable[[], KZGCommitmentValue]]:
    """Dispatch the commitment MSM of each cube table (``SparseCubeTable``
    or ``IncrementalCubeTable``) over the j basis and return their
    finishers: the card starts on one table's MSM while the host builds
    the next table's scalars, and a caller can dispatch other MSMs before
    it waits for any.  Each table's scalars are timed as the child span
    ``scalars``."""
    fins = []
    for t in tables:
        with span("scalars"):
            scalars = _commit_scalars(params, t)
        fins.append(_msm_async(params.j_bases[0], scalars, device))
    return [lambda fin=fin: KZGCommitmentValue(fin()) for fin in fins]


def commit_cube_batch(params: CubeParams, tables, device
                      ) -> List[KZGCommitmentValue]:
    """Commit several cube tables in ONE burst: every MSM is dispatched
    before any is waited for.  The same group elements as committing one
    at a time."""
    return [fin() for fin in commit_cube_async(params, tables, device)]


def commit_sparse(params: CubeParams, table: SparseCubeTable, device
                  ) -> KZGCommitmentValue:
    return commit_cube_batch(params, [table], device)[0]


def commit_incremental(params: CubeParams, table: IncrementalCubeTable,
                       device) -> KZGCommitmentValue:
    return commit_cube_batch(params, [table], device)[0]


# ---------------------------------------------------------------------------
# Open (fold j variables first — see module docstring for why)
# ---------------------------------------------------------------------------

def _open_j_then_k(params: CubeParams, s, make_g, point: Sequence[Fr],
                   device) -> Tuple[Fr, MLOpeningProof]:
    """Shared j-first opening routine.

    ``s``: the T-vector of eq(tau_k)-weighted column scalars
    s_j = <column_j, eq(., tau_k)> — these fold LINEARLY under j-variable
    binding, so the j-phase quotient scalars are plain odd-even diffs.
    ``make_g(eqw)``: builds the k-residue K-vector
    g(k) = sum_j eqw[j] * column_j(k) from the eq-table of the j-point.
    Every level's MSM is dispatched before any is waited for (the j levels
    before the k-residue is built); quotients are returned in VARIABLE
    order (k levels first)."""
    log_k, log_t = params.log_k, params.log_t
    if len(point) != log_k + log_t:
        raise CommitmentError("opening point has wrong arity")
    rk = [int(p) % _P for p in point[:log_k]]
    rj = [int(p) % _P for p in point[log_k:]]
    native = _native.available

    if log_t == 0:
        j_levels = []
    elif native:
        # the fold-and-quotient pass IS a multilinear opening over the
        # j variables: one native call yields every level's quotient bytes
        _, j_levels = _native.fr_ml_open(s, [Fr(x) for x in rj])
    else:
        j_levels = []
        cur = [int(v) % _P for v in s]
        for r in rj:
            half = len(cur) // 2
            diff = [(cur[2 * x + 1] - cur[2 * x]) % _P for x in range(half)]
            j_levels.append(diff)
            cur = [(cur[2 * x] + r * diff[x]) % _P for x in range(half)]
    fins_j = [_msm_async(params.j_bases[i + 1], j_levels[i], device)
              for i in range(log_t)]

    g = make_g(eq_table_ints(rj))
    if native and log_k > 0:
        gval, k_levels = _native.fr_ml_open(g, [Fr(x) for x in rk])
        gval = int(gval) % _P
    else:
        k_levels = []
        if isinstance(g, (bytes, bytearray)):   # the native residue
            g = FrTable(bytes(g))
        g = [int(v) % _P for v in g]
        for r in rk:
            half = len(g) // 2
            diff = [(g[2 * x + 1] - g[2 * x]) % _P for x in range(half)]
            k_levels.append(diff)
            g = [(g[2 * x] + r * diff[x]) % _P for x in range(half)]
        gval = g[0] % _P
    fins_k = [_msm_async(params.k_bases[i + 1], k_levels[i], device)
              for i in range(log_k)]
    quotients = [fin() for fin in fins_k] + [fin() for fin in fins_j]
    return Fr(gval), MLOpeningProof(quotients)


def open_sparse(params: CubeParams, table: SparseCubeTable,
                point: Sequence[Fr], device) -> Tuple[Fr, MLOpeningProof]:
    return open_combined(params, [(1, table)], [], point, device)


def open_incremental(params: CubeParams, table: IncrementalCubeTable,
                     point: Sequence[Fr], device) -> Tuple[Fr, MLOpeningProof]:
    """Open a column-incremental table: its column scalars are prefix sums
    of weighted deltas, and the k residue weights each delta by the STRICT
    suffix sum of eq(j, r_j) (cell k holds a delta from the cycle after
    it was written onward)."""
    return open_combined(params, [], [(1, table)], point, device)


def _wt_mle(table, point: Sequence[Fr], incremental: bool) -> Fr:
    eqk = eq_table_ints([int(p) for p in point[:table.log_k]])
    eqj = eq_table_ints([int(p) for p in point[table.log_k:]])
    if _native.available:
        return _native.wt_mle(table.csr(), 1 << table.log_t, eqk,
                              1 << table.log_k, eqj, incremental)
    return Fr(sum(w * v for w, v in zip(eqj, _col_scalars(table, eqk)))
              % _P)


def sparse_mle_eval(table: SparseCubeTable, point: Sequence[Fr]) -> Fr:
    """~table(point) for a column-sparse cube table, O(nnz + T + K)."""
    return _wt_mle(table, point, False)


def incremental_mle_eval(table: IncrementalCubeTable,
                         point: Sequence[Fr]) -> Fr:
    """~table(point) for a column-incremental cube table, O(T + K)."""
    return _wt_mle(table, point, True)


def open_combined(params: CubeParams,
                  sparse_parts: Sequence[Tuple[int, SparseCubeTable]],
                  inc_parts: Sequence[Tuple[int, IncrementalCubeTable]],
                  point: Sequence[Fr], device) -> Tuple[Fr, MLOpeningProof]:
    """Open the random linear combination sum_i c_i*S_i + sum_m d_m*V_m
    (S column-sparse, V column-incremental) with ONE j-first quotient set:
    one opening's MSM work (~T+K point-ops) for the whole batch.
    Byte-identical to ``open_dense_cube`` on the pointwise RLC of the dense
    tables."""
    eqk = params.eqk_tables[0]
    t_size = 1 << params.log_t
    k_size = 1 << params.log_k
    if _native.available:
        acc = _native.WtAccumulator(t_size)
        for c, tab in sparse_parts:
            acc.add_col_scalars(tab.csr(), eqk, k_size, False, int(c) % _P)
        for d, tab in inc_parts:
            acc.add_col_scalars(tab.csr(), eqk, k_size, True, int(d) % _P)
        s = acc.export()

        def make_g(eqw):
            ga = _native.WtAccumulator(k_size)
            for c, tab in sparse_parts:
                ga.add_residue(tab.csr(), t_size, eqw, False, int(c) % _P)
            for d, tab in inc_parts:
                ga.add_residue(tab.csr(), t_size, eqw, True, int(d) % _P)
            return ga.export()

        return _open_j_then_k(params, s, make_g, point, device)

    s = [0] * t_size
    for c, tab in list(sparse_parts) + list(inc_parts):
        c = int(c) % _P
        for j, v in enumerate(_col_scalars(tab, eqk)):
            s[j] = (s[j] + c * v) % _P

    def make_g(eqw) -> List[int]:
        # a delta written at cycle j is in every column after j: the
        # incremental part weighs it by the strict suffix sum of eqw
        eqw = list(eqw)
        g = [0] * k_size
        for c, tab in sparse_parts:
            c = int(c) % _P
            for j, col in enumerate(tab.cols):
                w = eqw[j] * c % _P
                for k, v in col:
                    g[k] = (g[k] + w * v) % _P
        if inc_parts:
            suffix = [0] * (t_size + 1)
            for j in range(t_size - 1, -1, -1):
                suffix[j] = (suffix[j + 1] + eqw[j]) % _P
            for d, tab in inc_parts:
                d = int(d) % _P
                for j, ups in enumerate(tab.updates):
                    w = suffix[j + 1] * d % _P
                    for k, dv in ups:
                        g[k] = (g[k] + w * dv) % _P
        return g

    return _open_j_then_k(params, s, make_g, point, device)


def open_dense_cube(params: CubeParams, dense: Sequence,
                    point: Sequence[Fr], device) -> Tuple[Fr, MLOpeningProof]:
    """j-first opening of a DENSE (k, j) table (index = j*K + k) — the
    dense sound prover's counterpart of :func:`open_sparse`, producing
    byte-identical proofs to it on equal data.  Requires the deterministic
    factorized SRS (the scalars need tau_k)."""
    log_k, log_t = params.log_k, params.log_t
    k_size = 1 << log_k
    if len(dense) != (k_size << log_t):
        raise CommitmentError("dense cube table has wrong size")
    vals = [int(v) % _P for v in dense]
    eqk = params.eqk_tables[0]
    s = [
        sum(vals[j * k_size + k] * eqk[k] for k in range(k_size)) % _P
        for j in range(1 << log_t)
    ]

    def make_g(eqw) -> List[int]:
        eqw = list(eqw)
        return [
            sum(eqw[j] * vals[j * k_size + k] for j in range(1 << log_t)) % _P
            for k in range(k_size)
        ]

    return _open_j_then_k(params, s, make_g, point, device)
