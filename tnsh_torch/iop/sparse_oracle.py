"""The sparse (k, j)-cube sum-check oracle with its j phase on the card:
the port of ``tnsh.iop.sparse_oracle.SparseCubeOracle``.

The sound protocols' checks are degree-<=3 sums of products over the
(memory x time) cube, variable 0 = k_0 (the fastest bit).  Factor kinds
per term:

  ("eqj", table_T)       j-only table (constant over k): eq kernels, rv;
  ("eqk", table_K)       k-only table (constant over j): eq(rho_k, .),
                         the lookup table;
  ("colsparse", SparseCubeTable)   few entries a cycle column (one-hots);
                         a term may use the SAME table twice (ra * ra);
  ("colinc", IncrementalCubeTable) column-incremental (Twist's Val).

The log K k rounds run on the port's native C++ engine (``sco_*``), as
tnsh's default path does: the engine's state is made (``sco_create``)
under the ``oracle_a_build`` stage, as the bit-column oracles' is, and
the rounds run under ``k_rounds``.  At the last k bind (at construction
when log K = 0) the native state is freed and the j phase is built here,
term for term as tnsh's ``_delegate_terms`` specifies, under
``j_build``:

  * a ``colsparse`` table folded at r_k is ONE table over j,
    ra_f(j) = sum of the column's entries weighted by eq(r_k, position)
    (bit 0 = r_k[0], the order the k folds bind in), from the native
    witness accumulator over the table's CSR; a ``colinc`` table is the
    same call's prefix-sum form;
  * an ``eqk`` factor folds to the host scalar ~table(r_k), multiplied
    into its term's coefficient; a term left with no table sums its
    coefficient over j, which an all-ones table carries;
  * the eqj tables and the folded columns go up in one transfer into a
    ``TorchSumOfProductsOracle`` (degree 3), so every j round is one
    round-evaluation launch and every j bind one fold launch, under
    ``j_rounds``.

``use_native=False`` runs the k phase in Python instead, as tnsh's
fallback does (the default under ``TNSH_NO_NATIVE``), with the three term
classes of a k round:

  * class S (a colsparse factor): each column's entries pin its
    contribution to one residual position, where its eqk and colinc
    factors are read (the colinc "current column" is kept by an in-order
    scan over j);
  * class I (colinc, no colsparse): the running sum over the residual
    positions of eqk * current column is updated with each colinc delta,
    so a round stays O(T + K);
  * class E (eqk and eqj only): the k sum and the j sum factorize.

That path needs no native engine for its k rounds; its j phase is built
from the folded columns themselves (``_delegate_terms``).

On either path the colinc scan can be seeded with the state of columns
held elsewhere (``set_colinc_start``, beside ``inc_totals``): the
column-sharded mesh oracle
(``tnsh_torch.parallel.mesh.ShardedSparseCubeOracle``) runs one such
oracle on each rank's slice of the columns.  tnsh seeds only its Python
k phase; the port's engine takes the seed too (``sco_set_inc_start``).

Round polynomials equal tnsh's bit for bit on either path (exact
arithmetic).
"""

from __future__ import annotations

from typing import List, Optional

from .. import _native
from ..commit.mkzg_sparse import eq_table_ints
from ..errors import SumCheckError
from ..field.fr import MODULUS, Fr, FrTable
from ..poly.eq import mle_eval
from .bits_oracle import _BitsOracle
from .sumcheck import SumcheckOracle, TorchSumOfProductsOracle

_P = MODULUS


class SparseCubeOracle(_BitsOracle, SumcheckOracle):
    """Degree-3 sum-check oracle over a (k, j) cube term system.

    ``terms``: sequence of ``(coeff, [(kind, payload), ...])``.  Factors
    are deduplicated by identity, so a shared table folds once.  ``timer``
    (an optional ``PhaseTimer``) splits the work into ``oracle_a_build``
    (the native state), ``k_rounds``, ``j_build`` and ``j_rounds``.
    ``use_native=False`` runs the k rounds in Python (module docstring);
    ``None`` takes the engine where it is available, so under
    ``TNSH_NO_NATIVE`` the Python k phase, and an explicit ``True``
    without the engine raises.  Call ``release()`` when
    done."""

    def __init__(self, log_k: int, log_t: int, terms, *, device,
                 timer=None, use_native: Optional[bool] = None):
        if use_native is None:
            use_native = _native.available
        super().__init__("sparse cube oracle's", log_k, log_t, 3, device,
                         timer, native=use_native)
        self.use_native = use_native
        t_size = 1 << log_t
        self._eqj: List = []
        self._eqk: List[List[int]] = []
        self._sparse: List = []      # SparseCubeTable objects
        self._inc: List = []         # IncrementalCubeTable objects
        #: (coeff, eqj idx, eqk idx, colsparse idx or None, its power,
        #: colinc idx)
        self._terms = []
        seen = {}
        for coeff, factors in terms:
            eqj_idx: List[int] = []
            eqk_idx: List[int] = []
            sp_idx = None
            sp_power = 0
            inc_idx: List[int] = []
            for kind, payload in factors:
                if kind == "eqj":
                    key = ("eqj", id(payload))
                    if key not in seen:
                        if len(payload) != t_size:
                            raise SumCheckError("eqj table size mismatch")
                        seen[key] = len(self._eqj)
                        # bytes-backed FrTable payloads pass through
                        self._eqj.append(
                            payload if hasattr(payload, "raw")
                            else [int(v) % _P for v in payload]
                        )
                    eqj_idx.append(seen[key])
                elif kind == "eqk":
                    key = ("eqk", id(payload))
                    if key not in seen:
                        if len(payload) != (1 << log_k):
                            raise SumCheckError("eqk table size mismatch")
                        seen[key] = len(self._eqk)
                        self._eqk.append([int(v) % _P for v in payload])
                    eqk_idx.append(seen[key])
                elif kind == "colsparse":
                    key = ("sp", id(payload))
                    if key not in seen:
                        seen[key] = len(self._sparse)
                        self._sparse.append(payload)
                    if sp_idx is not None and sp_idx != seen[key]:
                        raise SumCheckError(
                            "one distinct colsparse factor per term"
                        )
                    sp_idx = seen[key]
                    sp_power += 1
                elif kind == "colinc":
                    key = ("inc", id(payload))
                    if key not in seen:
                        seen[key] = len(self._inc)
                        self._inc.append(payload)
                    inc_idx.append(seen[key])
                else:
                    raise SumCheckError(f"unknown factor kind {kind}")
            if sp_idx is None and len(inc_idx) > 1:
                raise SumCheckError(
                    "a term without a colsparse factor supports at most "
                    "one colinc factor (class I)"
                )
            self._terms.append((int(coeff) % _P, eqj_idx, eqk_idx, sp_idx,
                                sp_power, inc_idx))
        if not self._terms:
            raise SumCheckError("SparseCubeOracle needs at least one term")
        self._k_rem = 1 << log_k
        #: externally seeded colinc scan state (column-sharded mode): per
        #: inc table, the K_rem-vector of the deltas of the columns held
        #: by earlier ranks.  None = this oracle holds ALL columns.
        self._inc_start: Optional[List[List[int]]] = None
        if not use_native:
            self._init_python_k_phase()
        if log_k == 0:
            with self._phase("j_build"):
                self._build_delegate()
            return
        if not use_native:
            return
        with self._phase("oracle_a_build"):
            self._k = _native.sco_create(
                log_k, log_t, self._eqk, self._eqj,
                [t.cols for t in self._sparse],
                [t.updates for t in self._inc],
                [t[0] for t in self._terms],
                [(-1 if t[3] is None else t[3], t[4], t[1], t[2], t[5])
                 for t in self._terms],
                sparse_csrs=[t.csr() for t in self._sparse],
                inc_csrs=[t.csr() for t in self._inc],
            )

    # -- the k phase ----------------------------------------------------------

    def _init_python_k_phase(self) -> None:
        """State of the Python k rounds: the columns as (position, value)
        lists (the caller's, read only: a bind rebinds to new lists), the
        colinc scan's current columns, and per term its weights over j,
        coeff times its eqj factors (static in k)."""
        t_size = 1 << self.log_t
        self._sp_cols = [t.cols for t in self._sparse]
        self._inc_ups = [t.updates for t in self._inc]
        self._inc_cur = [[0] * self._k_rem for _ in self._inc]
        self._weights = []
        for coeff, eqj_idx, *_ in self._terms:
            w = [coeff] * t_size
            for ji in eqj_idx:
                w = [a * b % _P for a, b in zip(w, self._eqj[ji])]
            self._weights.append(w)

    def set_colinc_start(self, states: Optional[List[List[int]]]) -> None:
        """Seed the colinc in-order scan (and the class-I running sums)
        with the prefix state of the columns held by earlier ranks:
        ``states`` holds, per inc table, a K_rem-sized int vector at the
        CURRENT fold level (``None``: this oracle holds every column).  A
        bind clears it; the sharded oracle sets it again before every
        round, and once more after the last k bind for the j phase's
        colinc tables."""
        if states is not None and (
                len(states) != len(self._inc)
                or any(len(v) != self._k_rem for v in states)):
            raise SumCheckError(
                f"colinc start: {len(self._inc)} vectors of {self._k_rem} "
                "values expected")
        self._inc_start = states
        if self._k is not None:
            _native.sco_set_inc_start(self._k, states or [])

    def inc_totals(self) -> List[List[int]]:
        """Per inc table, the sum of its deltas at each of the K_rem
        residual positions of the current fold level: the state this
        oracle's columns leave for the columns after them."""
        if not self.use_native:
            ups = self._inc_ups
        elif self._k is not None:
            return _native.sco_inc_totals(self._k, len(self._inc),
                                          self._k_rem)
        elif self.log_k == 0:   # no k round: every position is 0
            ups = [t.updates for t in self._inc]
        else:
            raise SumCheckError("the native k state is already freed")
        out = []
        for cols in ups:
            vec = [0] * self._k_rem
            for col in cols:
                for pos, d in col:
                    vec[pos] += int(d)
            out.append([v % _P for v in vec])
        return out

    def _k_round_evals(self) -> List[Fr]:
        if self.use_native:
            return _native.sco_round_evals(self._k)
        return self._py_round_evals()

    def _k_bind(self, challenge) -> None:
        if self.use_native:
            _native.sco_bind(self._k, challenge)
            self._k_rem //= 2
            self._inc_start = None  # the engine clears its own at a bind
        else:
            self._py_bind(challenge)

    @staticmethod
    def _k_free(handle: int) -> None:
        _native.sco_free(handle)

    def _py_round_evals(self) -> List[Fr]:
        t_size = 1 << self.log_t
        starts = self._inc_start
        inc_cur_all = self._inc_cur
        for ii, cur in enumerate(inc_cur_all):
            src = starts[ii] if starts is not None else None
            for i in range(len(cur)):
                cur[i] = src[i] if src is not None else 0
        # products of <= 4 linear forms at X = 0..3, summed unreduced (one
        # mod a round)
        sparse = self._sp_cols
        eqk_all = self._eqk
        s0 = s1 = s2 = s3 = 0
        cls_s = []  # (weights, eqk idx, colsparse idx, power, colinc idx)
        cls_i = []  # [weights, eqk idx, colinc idx, h0, h1, h2, h3]
        half = self._k_rem // 2
        for w, (_c, _j, eqk_idx, sp_idx, sp_power, inc_idx) in zip(
                self._weights, self._terms):
            if sp_idx is not None:
                cls_s.append((w, eqk_idx, sp_idx, sp_power, inc_idx))
            elif inc_idx:
                cls_i.append([w, eqk_idx, inc_idx[0], 0, 0, 0, 0])
            else:
                # class E: the k sum and the j sum factorize
                wsum = sum(w) % _P
                if wsum == 0:
                    continue
                e0 = e1 = e2 = e3 = 0
                for rest in range(half):
                    p0 = p1 = p2 = p3 = 1
                    for ei in eqk_idx:
                        arr = eqk_all[ei]
                        a0 = arr[2 * rest]
                        d = arr[2 * rest + 1] - a0
                        p0 = p0 * a0 % _P
                        p1 = p1 * (a0 + d) % _P
                        p2 = p2 * (a0 + 2 * d) % _P
                        p3 = p3 * (a0 + 3 * d) % _P
                    e0 += p0
                    e1 += p1
                    e2 += p2
                    e3 += p3
                s0 += wsum * e0
                s1 += wsum * e1
                s2 += wsum * e2
                s3 += wsum * e3

        # column-sharded mode: each class-I running sum starts from the
        # earlier ranks' prefix state
        if starts is not None:
            for rec in cls_i:
                cur0 = inc_cur_all[rec[2]]
                h0 = h1 = h2 = h3 = 0
                for rest in range(half):
                    b0 = cur0[2 * rest]
                    b1 = cur0[2 * rest + 1]
                    if b0 == 0 and b1 == 0:
                        continue
                    d = b1 - b0
                    v0, v1, v2 = b0, b1, b1 + d
                    v3 = v2 + d
                    for ei in rec[1]:
                        arr = eqk_all[ei]
                        a0 = arr[2 * rest]
                        da = arr[2 * rest + 1] - a0
                        v0 *= a0
                        v1 *= a0 + da
                        v2 *= a0 + 2 * da
                        v3 *= a0 + 3 * da
                    h0 += v0
                    h1 += v1
                    h2 += v2
                    h3 += v3
                rec[3:7] = [h0 % _P, h1 % _P, h2 % _P, h3 % _P]

        for j in range(t_size):
            for w, eqk_idx, sp_idx, sp_power, inc_idx in cls_s:
                wj = w[j]
                if wj == 0:
                    continue
                col = sparse[sp_idx][j]
                if sp_power == 2 and len(col) > 1:
                    # merge a pair's entries BEFORE squaring: the column's
                    # restriction to a pair is ONE linear form, so
                    # (a + b)^2, not a^2 + b^2
                    acc = {}
                    for p, c in col:
                        lo, hi = acc.get(p >> 1, (0, 0))
                        if p & 1:
                            hi += c
                        else:
                            lo += c
                        acc[p >> 1] = (lo, hi)
                    forms = [(2 * rest, lo % _P, (hi - lo) % _P)
                             for rest, (lo, hi) in acc.items()]
                else:
                    forms = []
                    for p, c in col:
                        forms.append((p & ~1, 0, c) if p & 1
                                     else (p, c, -c))
                for rest2, lo, d in forms:
                    v0, v1 = lo, lo + d
                    v2, v3 = v1 + d, v1 + 2 * d
                    if sp_power == 2:
                        v0 *= v0
                        v1 *= v1
                        v2 *= v2
                        v3 *= v3
                    v0 *= wj
                    v1 *= wj
                    v2 *= wj
                    v3 *= wj
                    for ei in eqk_idx:
                        arr = eqk_all[ei]
                        a0 = arr[rest2]
                        da = arr[rest2 + 1] - a0
                        v0 *= a0
                        v1 *= a0 + da
                        v2 *= a0 + 2 * da
                        v3 *= a0 + 3 * da
                    for ii in inc_idx:
                        cur = inc_cur_all[ii]
                        a0 = cur[rest2]
                        da = cur[rest2 + 1] - a0
                        v0 *= a0
                        v1 *= a0 + da
                        v2 *= a0 + 2 * da
                        v3 *= a0 + 3 * da
                    s0 += v0
                    s1 += v1
                    s2 += v2
                    s3 += v3
            for rec in cls_i:
                wj = rec[0][j]
                if wj:
                    s0 += wj * rec[3]
                    s1 += wj * rec[4]
                    s2 += wj * rec[5]
                    s3 += wj * rec[6]
            for ii, cur in enumerate(inc_cur_all):
                for p, d in self._inc_ups[ii][j]:
                    cur[p] = (cur[p] + d) % _P
                    # this delta's linear form times the class-I term's
                    # eqk forms at the same pair
                    rest2 = p & ~1
                    for rec in cls_i:
                        if rec[2] != ii:
                            continue
                        if p & 1:
                            u0, u1, u2, u3 = 0, d, 2 * d, 3 * d
                        else:
                            u0, u1, u2, u3 = d, 0, -d, -2 * d
                        for ei in rec[1]:
                            arr = eqk_all[ei]
                            a0 = arr[rest2]
                            da = arr[rest2 + 1] - a0
                            u0 *= a0
                            u1 *= a0 + da
                            u2 *= a0 + 2 * da
                            u3 *= a0 + 3 * da
                        rec[3] = (rec[3] + u0) % _P
                        rec[4] = (rec[4] + u1) % _P
                        rec[5] = (rec[5] + u2) % _P
                        rec[6] = (rec[6] + u3) % _P
        return [Fr(v % _P) for v in (s0, s1, s2, s3)]

    def _py_bind(self, challenge) -> None:
        r = int(challenge) % _P
        nr = (1 - r) % _P
        self._eqk = [
            [(t[2 * i] + r * (t[2 * i + 1] - t[2 * i])) % _P
             for i in range(len(t) // 2)]
            for t in self._eqk
        ]

        def fold_cols(cols):
            out = []
            for col in cols:
                if len(col) == 1:  # the common one-hot case: no merging
                    p, c = col[0]
                    out.append([(p >> 1, c * (r if p & 1 else nr) % _P)])
                    continue
                acc = {}
                for p, c in col:
                    key = p >> 1
                    acc[key] = (acc.get(key, 0)
                                + c * (r if p & 1 else nr)) % _P
                out.append(list(acc.items()))
            return out

        self._sp_cols = [fold_cols(c) for c in self._sp_cols]
        self._inc_ups = [fold_cols(u) for u in self._inc_ups]
        self._k_rem //= 2
        self._inc_cur = [[0] * self._k_rem for _ in self._inc]
        self._inc_start = None  # stale after a fold; seeded again a round

    # -- the j phase ----------------------------------------------------------

    def _delegate_terms(self):
        """The j-phase terms ``(coeff, [T-sized tables])`` after the k
        binds; a table shared by terms is one object.  The column-sharded
        mesh oracle takes them from its rank's slice."""
        t_size = 1 << self.log_t
        if self.use_native:
            r_k = [int(c) % _P for c in self._challenges]
            eq_rk = eq_table_ints(r_k)
            k_size = 1 << self.log_k

            def folded(table, incremental: bool) -> FrTable:
                return FrTable(_native.WtAccumulator(t_size).add_col_scalars(
                    table.csr(), eq_rk, k_size, incremental).export())

            sp_tables = [folded(t, False) for t in self._sparse]
            inc_tables = [folded(t, True) for t in self._inc]
            if self._inc_start is not None:
                # the lower ranks' columns start each prefix table
                inc_tables = [
                    FrTable(b"".join(((v + st[0]) % _P).to_bytes(
                        32, "little") for v in tab))
                    for tab, st in zip(inc_tables, self._inc_start)]
            # ~table(r_k) of each eqk table: the k folds' little-endian order
            eqk_at = [int(mle_eval(t, r_k)) for t in self._eqk]
        else:
            # fully folded columns hold their entries at position 0
            sp_tables = [[sum(c for _, c in col) % _P for col in cols]
                         for cols in self._sp_cols]
            inc_tables = []
            for ii, ups in enumerate(self._inc_ups):
                cur = (self._inc_start[ii][0] if self._inc_start is not None
                       else 0)
                tab = []
                for col in ups:
                    tab.append(cur)
                    for _, d in col:
                        cur = (cur + d) % _P
                inc_tables.append(tab)
            eqk_at = [t[0] for t in self._eqk]
        ones = None
        terms = []
        for coeff, eqj_idx, eqk_idx, sp_idx, sp_power, inc_idx in self._terms:
            c = coeff
            for ei in eqk_idx:
                c = c * eqk_at[ei] % _P
            tabs = [self._eqj[ji] for ji in eqj_idx]
            if sp_idx is not None:
                tabs += [sp_tables[sp_idx]] * sp_power
            tabs += [inc_tables[ii] for ii in inc_idx]
            if not tabs:
                if ones is None:
                    ones = [1] * t_size
                tabs = [ones]
            terms.append((c, tabs))
        return terms

    def _build_delegate(self) -> None:
        """The j phase on a ``TorchSumOfProductsOracle``."""
        self._delegate = TorchSumOfProductsOracle(
            self.log_t, self._delegate_terms(), device=self.device)
