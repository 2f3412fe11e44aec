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
tnsh's default path does, under the ``k_rounds`` stage.  At the last k
bind (at construction when log K = 0) the native state is freed and the
j phase is built here, term for term as tnsh's ``_delegate_terms``
specifies, under ``j_build``:

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

There is no pure-Python k phase: without the native engine the oracle
raises.  Round polynomials equal tnsh's bit for bit (exact arithmetic).
"""

from __future__ import annotations

from typing import List

from .. import _native
from ..commit.mkzg_sparse import eq_table_ints
from ..errors import SumCheckError
from ..field.fr import MODULUS, FrTable
from ..poly.eq import mle_eval
from .bits_oracle import _BitsOracle
from .sumcheck import SumcheckOracle, TorchSumOfProductsOracle

_P = MODULUS


class SparseCubeOracle(_BitsOracle, SumcheckOracle):
    """Degree-3 sum-check oracle over a (k, j) cube term system.

    ``terms``: sequence of ``(coeff, [(kind, payload), ...])``.  Factors
    are deduplicated by identity, so a shared table folds once.  ``timer``
    (an optional ``PhaseTimer``) splits the work into ``k_rounds``,
    ``j_build`` and ``j_rounds``.  Call ``release()`` when done."""

    def __init__(self, log_k: int, log_t: int, terms, *, device,
                 timer=None):
        super().__init__("sparse cube oracle's", log_k, log_t, 3, device,
                         timer)
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
        if log_k == 0:
            with self._phase("j_build"):
                self._build_delegate()
            return
        with self._phase("k_rounds"):
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

    def _k_round_evals(self):
        return _native.sco_round_evals(self._k)

    def _k_bind(self, challenge) -> None:
        _native.sco_bind(self._k, challenge)

    @staticmethod
    def _k_free(handle: int) -> None:
        _native.sco_free(handle)

    def _build_delegate(self) -> None:
        """The j-phase terms after the k binds (tnsh's ``_delegate_terms``)
        on a ``TorchSumOfProductsOracle``."""
        t_size, k_size = 1 << self.log_t, 1 << self.log_k
        r_k = [int(c) % _P for c in self._challenges]
        eq_rk = eq_table_ints(r_k)

        def folded(table, incremental: bool) -> FrTable:
            return FrTable(_native.WtAccumulator(t_size).add_col_scalars(
                table.csr(), eq_rk, k_size, incremental).export())

        sp_tables = [folded(t, False) for t in self._sparse]
        inc_tables = [folded(t, True) for t in self._inc]
        # ~table(r_k) of each eqk table: the k folds' little-endian order
        eqk_at = [int(mle_eval(t, r_k)) for t in self._eqk]
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
        self._delegate = TorchSumOfProductsOracle(self.log_t, terms,
                                                  device=self.device)
