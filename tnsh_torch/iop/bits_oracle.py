"""TwistBits phase-A oracle with its j phase on the card: the port of
``tnsh.iop.bits_oracle.TwistBitsSparseOracle``.

The log K k rounds run on the port's native C++ engine (``tbk_*``),
exactly as tnsh's default path does on its own.  After the last k bind the native state is
freed and the j-phase sum of products is built here, term for term as
``TwistBitsSparseOracle._build_delegate`` specifies, and handed to
``TorchSopOracleD``, so every j round is one round-evaluation launch and
every j bind one fold launch.  (The engine's ``tbk_make_sopd`` is not used: its
native j tables cannot be exported.)

j-phase tables:

  * chi(r_m, b(j)) columns take one of two values per lane, so each is a
    ``torch.where`` over the bit column between two packed constants; the
    boolean columns and ot / 1 - ot likewise;
  * eq1, eq(sigma_j), eqb, rv, wv, ic and the Val prefix sums go up from
    the host in one transfer;
  * A^w(j) = Π_m chi(r_m, wb_m(j)) and the prefix sums
    V(j) = Σ_{j' < j, write} ic(j') A^w(j') are host ints, computed over
    the write cycles only.

Round polynomials equal tnsh's bit for bit (exact arithmetic; the tests
pin the proof bytes).
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import _native
from ..field.fr import MODULUS, Fr
from ..poly.eq import eq_eval, eq_table

from ..field import limbs
from .sumcheck_d import TorchSopOracleD

_P = MODULUS


def chi_column(bits: torch.Tensor, r: int, device) -> torch.Tensor:
    """chi(r, b(j)) over a boolean column: r where the bit is set, 1 - r
    where it is not, as an ``(8, T)`` Montgomery tensor."""
    return torch.where(bits.unsqueeze(0), limbs.scalar(r, device),
                       limbs.scalar(1 - int(r), device))


class TwistBitsSparseOracle:
    """Structured oracle for the full TwistBits phase-A term system.

    Takes the protocol columns and challenges of ``TwistBits.prove``
    (``sigma_k`` is the k half of sigma; its eq table feeds the native k
    phase and its evaluation at r_k weights the INC terms of the j phase).
    Call ``release()`` when done: it frees the native k-phase state if a
    round raised before the j phase began.  ``timer`` (an optional
    ``PhaseTimer``) splits the work into ``k_rounds``, ``j_build`` and
    ``j_rounds``.
    """

    def __init__(self, log_k: int, log_t: int, *, rb, wb, ot, rv, wv, ic,
                 eq1, sigma_k, eqs_j, eqb, alpha_powers, kinv, degree: int,
                 device, timer=None):
        if not _native.available:
            raise RuntimeError(
                "TwistBits' k phase runs on the native engine, which "
                "TNSH_NO_NATIVE switches off")
        self.log_k = log_k
        self.log_t = log_t
        self.num_vars = log_k + log_t
        self.degree = degree
        self.device = torch.device(device)
        self._round = 0
        self._timer = timer
        self._delegate = None
        self._challenges: List[Fr] = []
        self._rb, self._wb = rb, wb
        self._ot, self._rv, self._wv, self._ic = ot, rv, wv, ic
        self._eq1, self._eqsj, self._eqb = eq1, eqs_j, eqb
        self._sigma_k = list(sigma_k)
        self._ap = [int(a) % _P for a in alpha_powers]
        self._kinv = int(kinv) % _P
        #: (cycle, Π_m chi(r_m, wb_m(cycle))) for every write cycle, and
        #: the chi(r_m, wb_m) device columns -- set after the k phase
        self.write_weights: List[Tuple[int, int]] = []
        self.chi_w: List[torch.Tensor] = []

        t_size = 1 << log_t
        ra = np.zeros(t_size, dtype=np.uint64)
        wa = np.zeros(t_size, dtype=np.uint64)
        for i in range(log_k):
            ra |= np.asarray(rb[i], dtype=np.uint64) << np.uint64(i)
            wa |= np.asarray(wb[i], dtype=np.uint64) << np.uint64(i)
        self._tbk = _native.tbk_create(
            log_k, log_t, ra, wa, ot, ot, rv, wv, ic,
            eq1, eqs_j, eqb, eq_table(self._sigma_k), alpha_powers, kinv,
            degree + 1,
        )

    def release(self) -> None:
        """Free native state and device tables (idempotent)."""
        if self._tbk is not None:
            _native.tbk_free(self._tbk)
            self._tbk = None
        if self._delegate is not None:
            self._delegate.release()
        self.chi_w = []

    def _build_delegate(self) -> None:
        _native.tbk_free(self._tbk)
        self._tbk = None
        dev = self.device
        log_k, t_size = self.log_k, 1 << self.log_t
        r_k = [int(c) % _P for c in self._challenges]
        om = [(1 - r) % _P for r in r_k]
        rbits = torch.from_numpy(
            np.asarray(self._rb, dtype=np.bool_).reshape(log_k, t_size)
        ).to(dev)
        wbits = torch.from_numpy(
            np.asarray(self._wb, dtype=np.bool_).reshape(log_k, t_size)
        ).to(dev)
        ot_flags = np.fromiter((int(v) & 1 for v in self._ot),
                               dtype=np.bool_, count=t_size)
        otbits = torch.from_numpy(ot_flags).to(dev)
        chi_r = [chi_column(rbits[m], r_k[m], dev) for m in range(log_k)]
        self.chi_w = [chi_column(wbits[m], r_k[m], dev)
                      for m in range(log_k)]

        # V~(r_k, j): prefix sums of ic * A^w over the write cycles
        wb = self._wb
        weights = []
        for j in np.flatnonzero(ot_flags).tolist():
            aw = 1
            for m in range(log_k):
                aw = aw * (r_k[m] if wb[m][j] else om[m]) % _P
            weights.append((j, aw))
        self.write_weights = weights
        ic = list(self._ic)
        aw_of = dict(weights)
        Vj = [0] * t_size
        cur = 0
        for j in range(t_size):
            Vj[j] = cur
            aw = aw_of.get(j)
            if aw is not None:
                cur = (cur + ic[j] * aw) % _P

        one = limbs.scalar(1, dev)
        zero = torch.zeros_like(one)

        def as_col(bits):
            return torch.where(bits.unsqueeze(0), one, zero)

        ot_col = as_col(otbits)
        rt_col = torch.where(otbits.unsqueeze(0), zero, one)
        eqsk_r = int(eq_eval(self._sigma_k, r_k))
        a1 = self._ap[1]
        kv = self._kinv
        terms = [
            (1, [self._eq1, rt_col] + chi_r + [Vj]),
            (_P - kv, [self._eq1, self._rv]),
            (a1 * eqsk_r % _P,
             [self._eqsj, ot_col] + self.chi_w + [self._ic]),
            ((_P - a1) * eqsk_r % _P,
             [self._eqsj, ot_col] + self.chi_w + [self._wv]),
            (a1 * eqsk_r % _P,
             [self._eqsj, ot_col] + self.chi_w + [Vj]),
        ]
        bool_cols = ([as_col(rbits[m]) for m in range(log_k)]
                     + [as_col(wbits[m]) for m in range(log_k)]
                     + [ot_col])
        for m, col in enumerate(bool_cols):
            w = self._ap[2 + m] * kv % _P
            terms.append((w, [self._eqb, col, col]))
            terms.append((_P - w, [self._eqb, col]))
        self._delegate = TorchSopOracleD(self.log_t, terms, self.degree,
                                         device=dev)

    def _phase(self, name: str):
        if self._timer is None:
            return contextlib.nullcontext()
        return self._timer.phase(name)

    def round_evaluations(self, round_index: int) -> List[Fr]:
        if self._round < self.log_k:
            with self._phase("k_rounds"):
                return _native.tbk_round_evals(self._tbk, self.degree + 1)
        with self._phase("j_rounds"):
            return self._delegate.round_evaluations(round_index - self.log_k)

    def bind(self, challenge: Fr) -> None:
        if self._round < self.log_k:
            self._challenges.append(challenge)
            with self._phase("k_rounds"):
                _native.tbk_bind(self._tbk, challenge)
            if self._round == self.log_k - 1:
                with self._phase("j_build"):
                    self._build_delegate()
        else:
            with self._phase("j_rounds"):
                self._delegate.bind(challenge)
        self._round += 1

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        return self._delegate.final_evaluation(challenges[self.log_k:])
