"""The bit-column phase-A oracles with their j phase on the card: the
ports of ``tnsh.iop.bits_oracle.TwistBitsSparseOracle`` and
``ShoutBitsSparseOracle``.

TwistBits' log K k rounds run on the card when its prove's device is a
CUDA device (``iop.twist_k_card``: the bucket walk as one chunked kernel
a round, counted as ``k_device_rounds``); on the CPU they run on the
port's native C++ engine (``tbk_*``), exactly as tnsh's default path does
on its own.  ShoutBits' run on the engine (``sbk_*``) on every device.
With ``native=False`` (the provers pass it under TNSH_NO_NATIVE) the
host's k rounds run in Python ints instead, tnsh's pure-Python k phase
line for line: one ascending-j walk a round over the cycles' address
suffixes.  After the last k bind the k state is freed and the j-phase
sum of products is built here, term for term as tnsh's ``_build_delegate``
specifies, and handed to ``TorchSopOracleD``, so every j round is one
round-evaluation launch and every j bind one fold launch, whichever k
phase ran.  Both oracles take their columns from the prove's
``protocols.bit_columns.BitColumns``: its addresses, write flags and value
words (TwistBits), or its bit rows as j tables and bit columns (ShoutBits).

j-phase tables:

  * TwistBits' are written into the slots of one ``(9 + 4 log K, 8, T)``
    stack (``twist_cube_slots``, the dense cube's layout over j alone),
    which ``TorchSopOracleD`` folds without a copy;
  * the read and write addresses go up as int32 arrays and the write
    flags as bytes, with the six tables below (on the card route before
    the k phase, which reads them too); the bit rows are their shifts on
    the device;
  * chi(r_m, b(j)) columns take one of two values per lane, so each is a
    ``torch.where`` over a bit row between two packed constants; the
    boolean columns and ot / 1 - ot likewise;
  * rv, wv and ic go up from the host as their canonical words, one copy
    a table, and so do eq1, eq(sigma_j) and eqb off the card; on the
    card route each eq table is built in its slot from two half tables
    (``twist_k_card.eq_planes``);
  * V~(r_k, j) = Σ_{j' < j} ot(j') ic(j') eq(r_k, wa(j')) is one
    exclusive prefix scan on the device (``fr_kernels.prefix_scan``), the
    write weight formed in its first pass from the K-entry table
    eq(r_k, .);
  * a ShoutBits k table enters as one host scalar, its full fold at r_k,
    multiplied into its term's coefficient.

Round polynomials equal tnsh's bit for bit (exact arithmetic; the tests
pin the proof bytes).

``DenseCubeOracle`` is the dense path's phase A (TNSH_BITS_DENSE) on the
same staging: one ``TorchSopOracleD`` over the whole (k, j) cube, its
k rounds as well as its j rounds on the kernels.  It makes that oracle
under the child span ``oracle`` of the phase open around it
(``cube_build/oracle`` in the provers), beside the cube build's spans
``cube_build/columns``, ``/lift``, ``/chi``, ``/val`` and ``/eq`` and
their counter ``cube_lanes`` (``protocols.twist_bits._twist_cube``).
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from .. import _native
from ..errors import SumCheckError
from ..field import fr_kernels, limbs
from ..field.fr import MODULUS, Fr
from ..poly.eq import eq_eval, eq_table, mle_eval
from ..utils.profiling import count, span
from . import twist_k_card
from .sumcheck_d import TorchSopOracleD

_P = MODULUS
L = limbs.NUM_LIMBS


def _chi(x: int, b: int) -> int:
    """(1-x)(1-b) + x b mod p for boolean b and any x."""
    return (x if b else (1 - x)) % _P


def address_bits(addr: torch.Tensor, log_k: int) -> torch.Tensor:
    """``(log K, N)`` booleans: bit i of each of the ``(N,)`` addresses."""
    shifts = torch.arange(log_k, dtype=addr.dtype,
                          device=addr.device).unsqueeze(1)
    return ((addr.unsqueeze(0) >> shifts) & 1).bool()


def chi_column(bits: torch.Tensor, r: int, device,
               out: torch.Tensor = None) -> torch.Tensor:
    """chi(r, b(j)) over a boolean column: r where the bit is set, 1 - r
    where it is not, as an ``(8, T)`` Montgomery tensor (written into
    ``out`` when given)."""
    return torch.where(bits.unsqueeze(0), limbs.scalar(r, device),
                       limbs.scalar(1 - int(r), device), out=out)


class TwistCubeSlots(NamedTuple):
    """The slots of a TwistBits phase-A stack, over the dense (k, j) cube
    or over j alone (``TwistBitsSparseOracle``'s j phase): eq1, 1 - ot,
    the chi_r columns, V, rv, eq(sigma), ot, the chi_w columns, ic, wv,
    eqb, the rb_i and the wb_i (9 + 4 log K in all)."""

    eq1: int
    not_ot: int
    chi_r: List[int]
    val: int
    rv: int
    eqs: int
    ot: int
    chi_w: List[int]
    ic: int
    wv: int
    eqb: int
    rbit: List[int]
    wbit: List[int]
    count: int


def twist_cube_slots(log_k: int) -> TwistCubeSlots:
    return TwistCubeSlots(
        eq1=0, not_ot=1, chi_r=list(range(2, 2 + log_k)), val=2 + log_k,
        rv=3 + log_k, eqs=4 + log_k, ot=5 + log_k,
        chi_w=list(range(6 + log_k, 6 + 2 * log_k)), ic=6 + 2 * log_k,
        wv=7 + 2 * log_k, eqb=8 + 2 * log_k,
        rbit=list(range(9 + 2 * log_k, 9 + 3 * log_k)),
        wbit=list(range(9 + 3 * log_k, 9 + 4 * log_k)),
        count=9 + 4 * log_k)


def twist_cube_terms(log_k: int, a_pow, kinv: int, inc_scale: int = 1):
    """TwistBits' phase-A terms, tnsh's term for term
    (``twist_bits.py:319-329``), as ``(coefficient, slot indices)`` into
    ``twist_cube_slots``.  The three INC terms carry ``inc_scale``: 1
    over the dense cube, whose eq(sigma) slot holds eq(sigma, (k, j));
    eq(sigma_k, r_k) over the j-phase stack, whose slot holds
    eq(sigma_j, j)."""
    s = twist_cube_slots(log_k)
    a1 = a_pow[1] * inc_scale % _P
    terms = [
        (1, [s.eq1, s.not_ot] + s.chi_r + [s.val]),
        (_P - kinv, [s.eq1, s.rv]),
        (a1, [s.eqs, s.ot] + s.chi_w + [s.ic]),
        ((_P - a1) % _P, [s.eqs, s.ot] + s.chi_w + [s.wv]),
        (a1, [s.eqs, s.ot] + s.chi_w + [s.val]),
    ]
    for i, col in enumerate(s.rbit + s.wbit + [s.ot]):
        w = a_pow[2 + i] * kinv % _P
        terms.append((w, [s.eqb, col, col]))
        terms.append((_P - w, [s.eqb, col]))
    return terms


class _BitsOracle:
    """The seam the bit-column oracles and ``iop.sparse_oracle``'s cube
    oracle share: the log K k rounds on a native engine
    (``_k_round_evals``, ``_k_bind``, ``_k_free`` over the handle ``_k``),
    then the j phase on the ``TorchSopOracleD`` that ``_build_delegate``
    makes after the last k bind, once the native state is freed (unless
    the oracle has held its delegate from the start, as the dense cube's
    does).
    ``timer`` (an optional ``PhaseTimer``) splits the work into
    ``k_rounds``, ``j_build`` and ``j_rounds``.  Call ``release()`` when
    done: it frees the native state if a round raised before the j phase
    began.  ``native=False`` is for a k phase that runs without the
    engine (the Python k phases); ``native=True`` without the engine
    raises."""

    def __init__(self, protocol: str, log_k: int, log_t: int, degree: int,
                 device, timer, native: bool = True):
        if native and not _native.available:
            raise RuntimeError(
                f"the {protocol} k phase runs on the native engine, which "
                "TNSH_NO_NATIVE switches off")
        self.log_k = log_k
        self.log_t = log_t
        self.num_vars = log_k + log_t
        self.degree = degree
        self.device = torch.device(device)
        self.native = native
        self._round = 0
        self._timer = timer
        self._delegate = None
        self._challenges: List[Fr] = []
        self._k = None

    def _free_k(self) -> None:
        if self._k is not None:
            self._k_free(self._k)
            self._k = None

    def release(self) -> None:
        """Free native state and device tables (idempotent)."""
        self._free_k()
        if self._delegate is not None:
            self._delegate.release()

    def _phase(self, name: str):
        if self._timer is None:
            return contextlib.nullcontext()
        return self._timer.phase(name)

    def round_evaluations(self, round_index: int) -> List[Fr]:
        if self._round < self.log_k:
            with self._phase("k_rounds"):
                return self._k_round_evals()
        with self._phase("j_rounds"):
            return self._delegate.round_evaluations(round_index - self.log_k)

    def bind(self, challenge: Fr) -> None:
        if self._round < self.log_k:
            self._challenges.append(challenge)
            with self._phase("k_rounds"):
                self._k_bind(challenge)
            if self._round == self.log_k - 1 and self._delegate is None:
                with self._phase("j_build"):
                    self._free_k()
                    self._build_delegate()
        else:
            with self._phase("j_rounds"):
                self._delegate.bind(challenge)
        self._round += 1

    def final_evaluation(self, challenges: Sequence[Fr]) -> Fr:
        return self._delegate.final_evaluation(challenges[self.log_k:])

    @property
    def tables(self) -> torch.Tensor:
        """The j phase's (or the dense cube's) stack as the binds have
        folded it."""
        return self._delegate.tables


class DenseCubeOracle(_BitsOracle):
    """Phase A over the dense (k, j) cube (TNSH_BITS_DENSE): one
    ``TorchSopOracleD`` over all log K + log T variables, made from the
    ``terms`` over the ``(F, 8, K T)`` ``stack`` under the child span
    ``oracle``, and staged as the structured oracles are (the first log K
    rounds, which bind the k bits, as ``k_rounds``, the rest as
    ``j_rounds``; nothing to build between them, so no ``j_build``)."""

    def __init__(self, protocol: str, log_k: int, log_t: int, terms,
                 degree: int, stack: torch.Tensor, timer):
        super().__init__(protocol, log_k, log_t, degree, stack.device,
                         timer, native=False)
        with span("oracle"):
            self._delegate = TorchSopOracleD(log_k + log_t, terms, degree,
                                             device=stack.device,
                                             stack=stack)

    def _k_round_evals(self) -> List[Fr]:
        return self._delegate.round_evaluations(self._round)

    def _k_bind(self, challenge: Fr) -> None:
        self._delegate.bind(challenge)


class TwistBitsSparseOracle(_BitsOracle):
    """Structured oracle for the full TwistBits phase-A term system.

    Takes the prove's marshalled ``BitColumns`` and the challenges of
    ``TwistBits.prove``: the points ``rho1``, ``sigma_j`` and ``rhob`` of
    the j tables eq1, eq(sigma_j) and eqb, and ``sigma_k``, the k half of
    sigma, whose eq table feeds the k phase and whose evaluation at r_k
    weights the INC terms of the j phase.  On a CUDA device the k rounds
    run on the card (``twist_k_card.on_card``): under the child span
    ``marshal`` the j stack is allocated, the three eq tables are built in
    their slots (``twist_k_card.eq_planes``), rv, wv and ic, the addresses
    and the write flags go up, and the kernels read them.  Elsewhere the
    eq tables are built on the host and the k rounds run on the native
    engine, or with ``native=False`` in Python (tnsh's ``_k_round_evals``
    / ``_k_bind``, O(T + K) a round), and the engine's inputs are the span
    ``marshal``.
    """

    def __init__(self, columns, *, rho1, sigma_k, sigma_j, rhob,
                 alpha_powers, kinv, degree: int, device, timer=None,
                 native: bool = True):
        log_k, log_t = columns.log_k, columns.log_t
        super().__init__("TwistBits", log_k, log_t, degree, device, timer,
                         native)
        self._cols = columns
        #: the points of eq1, eq(sigma_j) and eqb, in their slots' order
        self._eq_points = (list(rho1), list(sigma_j), list(rhob))
        self._sigma_k = list(sigma_k)
        self._ap = [int(a) % _P for a in alpha_powers]
        self._kinv = int(kinv) % _P
        #: the ``(log K, T)`` write-bit rows on the device (phase B's chi
        #: columns) -- set after the k phase
        self.wbits = None
        #: the j stack with its six tables, and the addresses and write
        #: flags, on the device (``_upload_j_inputs``)
        self._j_inputs = None
        self._eq_tabs = None
        if twist_k_card.on_card(self.device, log_k):
            with span("marshal"):
                self._j_inputs = self._upload_j_inputs()
            stack, ra, wa, otbits = self._j_inputs
            self._k = twist_k_card.TwistKCard(
                log_k, ra, wa, otbits, stack, twist_cube_slots(log_k),
                self._sigma_k, self._ap[1], self._kinv, degree + 1)
            return
        #: eq1, eq(sigma_j) and eqb on the host
        self._eq_tabs = [eq_table(pt) for pt in self._eq_points]
        if native:
            self._k = _native.tbk_create(
                log_k, log_t, columns.read_addr, columns.write_addr,
                columns.write_flags, columns.rv, columns.wv, columns.ic,
                *self._eq_tabs, eq_table(self._sigma_k), alpha_powers,
                kinv, degree + 1,
            )
            return
        t_size = 1 << log_t
        with span("marshal"):
            as_int = lambda tab: [int(v) % _P for v in tab]  # noqa: E731
            self._ot = columns.write_flags.astype(np.int64).tolist()
            self._rv, self._wv, self._ic = columns.values
            self._eq1, self._eqsj, self._eqb = (as_int(tab)
                                                for tab in self._eq_tabs)
            self._eqsk = as_int(eq_table(self._sigma_k))  # folded by binds
            self._r_addr = columns.read_addr.tolist()
            self._w_addr = columns.write_addr.tolist()
            bits = [row.tolist() for row in columns.read_bits
                    + columns.write_bits] + [self._ot]
        self._Ar = [1] * t_size
        self._Aw = [1] * t_size
        # the j-lifted column terms (rv's and the boolean checks) are the
        # same every k round but for the 2^{free k bits} scale
        kv = self._kinv
        s_lift = 0
        for j in range(t_size):
            s_lift -= kv * self._eq1[j] % _P * self._rv[j]
            eb = self._eqb[j]
            for m, row in enumerate(bits):
                b = row[j]
                w = self._ap[2 + m] * kv % _P * eb % _P
                s_lift += w * b % _P * b - w * b
        self._s_lift = s_lift % _P

    def _k_round_evals(self) -> List[Fr]:
        if isinstance(self._k, twist_k_card.TwistKCard):
            return self._k.round_evals()
        if self.native:
            return _native.tbk_round_evals(self._k, self.degree + 1)
        npts = self.degree + 1
        i = self._round
        v_lift = self._s_lift * pow(2, self.log_k - i - 1, _P) % _P
        acc = [v_lift] * npts
        xs = range(npts)
        E = self._eqsk
        a1 = self._ap[1]
        # one ascending-j walk: the one-hot terms and the V terms, with
        # B[2 s + b] the sum of ic * A^w over earlier writes whose
        # remaining address suffix is s and current bit b
        B = [0] * (1 << (self.log_k - i))
        for j in range(1 << self.log_t):
            otj = self._ot[j]
            # READ: eq1 * rt * onehot(rb) * V    (rt = 1 - ot)
            w = self._eq1[j] * ((1 - otj) % _P) % _P * self._Ar[j] % _P
            if w:
                ra = self._r_addr[j]
                b, s2 = ra & 1, (ra >> 1) << 1
                b0, b1 = B[s2], B[s2 + 1]
                for x in xs:
                    vp = ((1 - x) * b0 + x * b1) % _P
                    if vp:
                        acc[x] += w * _chi(x, b) % _P * vp
            if otj:
                wa = self._w_addr[j]
                b, s = wa & 1, wa >> 1
                base = self._eqsj[j] * otj % _P * self._Aw[j] % _P
                if base:
                    # E folded over the bound bits, at the remaining write
                    # suffix, its current bit at X
                    et0 = E[2 * s]
                    edt = (E[2 * s + 1] - et0) % _P
                    b0, b1 = B[2 * s], B[2 * s + 1]
                    ic_wv = (self._ic[j] - self._wv[j]) % _P
                    for x in xs:
                        cx = _chi(x, b)
                        if not cx:
                            continue
                        head = a1 * base % _P * cx % _P * (
                            (et0 + x * edt) % _P) % _P
                        # INC terms: + ic - wv, and + V
                        acc[x] += head * ic_wv
                        vp = ((1 - x) * b0 + x * b1) % _P
                        if vp:
                            acc[x] += head * vp
                # the bucket takes this write after its own terms
                B[wa] = (B[wa] + self._ic[j] * self._Aw[j]) % _P
        return [Fr(v % _P) for v in acc]

    def _k_bind(self, challenge: Fr) -> None:
        if isinstance(self._k, twist_k_card.TwistKCard):
            self._k.bind(challenge)
            return
        if self.native:
            _native.tbk_bind(self._k, challenge)
            return
        r = int(challenge)
        om = (1 - r) % _P
        for j in range(1 << self.log_t):
            ra, wa = self._r_addr[j], self._w_addr[j]
            self._Ar[j] = self._Ar[j] * (r if ra & 1 else om) % _P
            self._Aw[j] = self._Aw[j] * (r if wa & 1 else om) % _P
            self._r_addr[j] = ra >> 1
            self._w_addr[j] = wa >> 1
        E = self._eqsk
        self._eqsk = [(E[2 * m] + r * (E[2 * m + 1] - E[2 * m])) % _P
                      for m in range(len(E) // 2)]

    @staticmethod
    def _k_free(handle) -> None:
        if isinstance(handle, twist_k_card.TwistKCard):
            handle.free()
        else:
            _native.tbk_free(handle)

    def release(self) -> None:
        super().release()
        self.wbits = self._j_inputs = None

    def _upload_j_inputs(self):
        """(the j phase's ``(9 + 4 log K, 8, T)`` stack with the six tables
        eq1, eq(sigma_j), eqb, rv, wv and ic in their slots, the read and
        write addresses as int32 and the write flags as bool) on the
        device.  The eq tables are built there (``eq_planes``) unless the
        host built them; rv, wv and ic are packed from the record's
        words."""
        dev, cols = self.device, self._cols
        s = twist_cube_slots(self.log_k)
        ra, wa = (torch.from_numpy(a.astype(np.int32)).to(dev)
                  for a in (cols.read_addr, cols.write_addr))
        otbits = torch.from_numpy(cols.write_flags).to(dev)
        stack = torch.empty((s.count, L, 1 << self.log_t),
                            dtype=torch.int32, device=dev)
        eq_slots = (s.eq1, s.eqs, s.eqb)
        if self._eq_tabs is None:
            for f, pt in zip(eq_slots, self._eq_points):
                twist_k_card.eq_planes(pt, stack[f])
        else:
            for f, tab in zip(eq_slots, self._eq_tabs):
                stack[f].copy_(limbs.pack(tab, dev))
        for f, tab in ((s.rv, cols.rv), (s.wv, cols.wv), (s.ic, cols.ic)):
            stack[f].copy_(limbs.pack(tab, dev))
        return stack, ra, wa, otbits

    def _build_delegate(self) -> None:
        """The j phase's ``(9 + 4 log K, 8, T)`` stack, every table written
        into its slot (``twist_cube_slots``): the six tables, the addresses
        and the write flags go up under the child span ``upload`` (on the
        card route the k phase put them there, and the span holds the pack
        of eq(r_k, .) alone); the bit, chi and ot
        columns are selects on the card, and V~(r_k, j) is the write
        weights' exclusive prefix sum (``prefix_scan``, counted as
        ``j_scan_lanes``)."""
        dev = self.device
        log_k, t_size = self.log_k, 1 << self.log_t
        r_k = [int(c) % _P for c in self._challenges]
        s = twist_cube_slots(log_k)
        with span("upload"):
            if self._j_inputs is None:
                self._j_inputs = self._upload_j_inputs()
            eq_rk = limbs.pack(eq_table(r_k), dev)
        stack, ra, wa, otbits = self._j_inputs
        self._j_inputs = None
        rbits, wbits = address_bits(ra, log_k), address_bits(wa, log_k)
        one = limbs.scalar(1, dev)
        zero = torch.zeros_like(one)
        for m in range(log_k):
            chi_column(rbits[m], r_k[m], dev, out=stack[s.chi_r[m]])
            chi_column(wbits[m], r_k[m], dev, out=stack[s.chi_w[m]])
        for f, bits in zip(s.rbit + s.wbit + [s.ot],
                           list(rbits) + list(wbits) + [otbits]):
            torch.where(bits.unsqueeze(0), one, zero, out=stack[f])
        torch.where(otbits.unsqueeze(0), zero, one, out=stack[s.not_ot])
        fr_kernels.prefix_scan(stack[s.ic], stack[s.val], wa, otbits, eq_rk)
        count("j_scan_lanes", t_size)
        self.wbits = wbits
        del ra, wa, rbits, otbits, eq_rk
        terms = twist_cube_terms(log_k, self._ap, self._kinv,
                                 int(eq_eval(self._sigma_k, r_k)))
        self._delegate = TorchSopOracleD(self.log_t, terms, self.degree,
                                         device=dev, stack=stack)


def _bool_column(col, t_size: int) -> np.ndarray:
    """``col`` as an array of T booleans, or SumCheckError.  A boolean
    array is taken as it is."""
    if isinstance(col, np.ndarray) and col.dtype == np.bool_:
        arr = col
    else:
        try:
            arr = np.asarray(col, dtype=np.uint64)
        except (OverflowError, ValueError, TypeError):
            arr = None
        if arr is not None and np.any(arr > 1):
            arr = None
    if arr is None or arr.size != t_size:
        raise SumCheckError(
            "bit columns must be boolean for the structured prover")
    return arr.astype(np.bool_, copy=False)


class ShoutBitsSparseOracle(_BitsOracle):
    """Structured oracle for single-one-hot bit-column term systems (the
    ShoutBits phase-A statement).

    ``terms``: sequence of ``(coeff, j_tables, bits, k_table)`` where
    ``j_tables`` is a list of T-point tables, ``bits`` is either None or
    the list of log K T-point boolean bit columns of the one-hot address,
    and ``k_table`` is either None or a K-point table attached to the
    one-hot (the public lookup table).  ``k_table`` without ``bits`` is
    refused.  Tables and columns are deduplicated by identity: a bit
    column that is also a j table becomes one device table, folded once a
    round.  ``native=False`` runs the k rounds in Python (tnsh's
    ``_k_round_evals`` / ``_k_bind``, O(T) a term and round).
    """

    def __init__(self, log_k: int, log_t: int, terms, degree: int, *,
                 device, timer=None, native: bool = True):
        super().__init__("ShoutBits", log_k, log_t, degree, device, timer,
                         native)
        #: (coeff, j_tables, bits or None, k_table or None), as given
        self._terms = []
        #: id(bit column) -> its values as a boolean array
        self._bit_arrays = {}
        with span("marshal"):
            jt_tabs, addr_tabs, kt_tabs, spec = self._validate(
                terms, 1 << log_t, 1 << log_k)
        if native:
            self._k = _native.sbk_create(log_k, log_t, jt_tabs, addr_tabs,
                                         kt_tabs, spec, degree + 1)
            return
        # the Python k state, one entry a term: its j-table product, or
        # its cycles' address suffixes, running chi products A and folded
        # k table
        jt_ints = [[int(v) % _P for v in tab] for tab in jt_tabs]
        self._py = []
        for coeff, jt_idx, a_idx, k_idx in spec:
            jt = [jt_ints[i] for i in jt_idx]
            if a_idx is None:
                total = 0
                for j in range(1 << log_t):
                    prod = coeff
                    for tab in jt:
                        prod = prod * tab[j] % _P
                    total += prod
                self._py.append({"lift": total % _P})
                continue
            self._py.append({
                "coeff": coeff, "jt": jt,
                "addr": [int(a) for a in addr_tabs[a_idx].tolist()],
                "A": [1] * (1 << log_t),
                "T": (None if k_idx is None
                      else [int(v) % _P for v in kt_tabs[k_idx]])})

    def _validate(self, terms, t_size: int, k_size: int):
        """Validate the terms as tnsh's ``_sbk_init`` does and record
        them: (the distinct j tables, address columns and k tables, and a
        term spec over their indices)."""
        jt_tabs: List = []
        jt_seen = {}
        addr_tabs: List = []
        addr_seen = {}
        kt_tabs: List = []
        kt_seen = {}
        spec = []
        for coeff, j_tables, bits, k_table in terms:
            jt_idx = []
            for tab in j_tables:
                if len(tab) != t_size:
                    raise SumCheckError("j table size mismatch")
                key = id(tab)
                if key not in jt_seen:
                    jt_seen[key] = len(jt_tabs)
                    jt_tabs.append(tab)
                jt_idx.append(jt_seen[key])
            self._terms.append((int(coeff) % _P, list(j_tables), bits,
                                k_table))
            if bits is None:
                if k_table is not None:
                    raise SumCheckError("k_table needs bits")
                spec.append((int(coeff) % _P, jt_idx, None, None))
                continue
            if len(bits) != self.log_k:
                raise SumCheckError("need log_k bit columns")
            key = tuple(id(c) for c in bits)
            if key not in addr_seen:
                addr = np.zeros(t_size, dtype=np.uint64)
                for i, col in enumerate(bits):
                    arr = self._bit_arrays.get(id(col))
                    if arr is None:
                        arr = _bool_column(col, t_size)
                        self._bit_arrays[id(col)] = arr
                    addr |= arr.astype(np.uint64) << np.uint64(i)
                addr_seen[key] = len(addr_tabs)
                addr_tabs.append(addr)
            k_idx = None
            if k_table is not None:
                if len(k_table) != k_size:
                    raise SumCheckError("k table size mismatch")
                kkey = id(k_table)
                if kkey not in kt_seen:
                    kt_seen[kkey] = len(kt_tabs)
                    kt_tabs.append(k_table)
                k_idx = kt_seen[kkey]
            spec.append((int(coeff) % _P, jt_idx, addr_seen[key], k_idx))
        if not spec:
            raise SumCheckError("ShoutBitsSparseOracle needs terms")
        return jt_tabs, addr_tabs, kt_tabs, spec

    def _k_round_evals(self) -> List[Fr]:
        if self.native:
            return _native.sbk_round_evals(self._k, self.degree + 1)
        npts = self.degree + 1
        pow_free = pow(2, self.log_k - self._round - 1, _P)
        acc = [0] * npts
        for tm in self._py:
            if "lift" in tm:
                # a j-lifted term: constant along k
                v = tm["lift"] * pow_free % _P
                for x in range(npts):
                    acc[x] += v
                continue
            addr, A, T, jt = tm["addr"], tm["A"], tm["T"], tm["jt"]
            for j in range(len(addr)):
                if A[j] == 0:
                    continue
                w = tm["coeff"] * A[j] % _P
                for tab in jt:
                    w = w * tab[j] % _P
                if w == 0:
                    continue
                b, s_j = addr[j] & 1, addr[j] >> 1
                if T is not None:
                    t0 = T[2 * s_j]
                    dt = (T[2 * s_j + 1] - t0) % _P
                else:
                    t0, dt = 1, 0
                # w * chi(X, b) * (t0 + X dt) at X = 0..D
                for x in range(npts):
                    cx = _chi(x, b)
                    if cx:
                        acc[x] += w * cx % _P * ((t0 + x * dt) % _P)
        return [Fr(v % _P) for v in acc]

    def _k_bind(self, challenge: Fr) -> None:
        if self.native:
            _native.sbk_bind(self._k, challenge)
            return
        r = int(challenge)
        om = (1 - r) % _P
        for tm in self._py:
            if "lift" in tm:
                continue
            addr, A = tm["addr"], tm["A"]
            for j in range(len(addr)):
                A[j] = A[j] * (r if addr[j] & 1 else om) % _P
                addr[j] >>= 1
            T = tm["T"]
            if T is not None:
                tm["T"] = [(T[2 * m] + r * (T[2 * m + 1] - T[2 * m])) % _P
                           for m in range(len(T) // 2)]

    @staticmethod
    def _k_free(handle: int) -> None:
        _native.sbk_free(handle)

    def _build_delegate(self) -> None:
        dev = self.device
        r_k = [int(c) % _P for c in self._challenges]
        # every bit column up in one transfer, one row a column object
        rows = {key: i for i, key in enumerate(self._bit_arrays)}
        with span("upload"):
            bits = torch.from_numpy(np.stack(
                list(self._bit_arrays.values()))).to(dev) if rows else None
        one = limbs.scalar(1, dev)
        zero = torch.zeros_like(one)
        as_table = {}     # id(bit column) -> its 0/1 device table
        chi = {}          # (id(bit column), i) -> chi(r_i, b(j))
        terms = []
        for coeff, j_tables, cols, k_table in self._terms:
            tabs = []
            for tab in j_tables:
                row = rows.get(id(tab))
                if row is not None:
                    if id(tab) not in as_table:
                        as_table[id(tab)] = torch.where(
                            bits[row].unsqueeze(0), one, zero)
                    tab = as_table[id(tab)]
                tabs.append(tab)
            if cols is not None:
                for i, col in enumerate(cols):
                    key = (id(col), i)
                    if key not in chi:
                        chi[key] = chi_column(bits[rows[id(col)]], r_k[i],
                                              dev)
                    tabs.append(chi[key])
            if k_table is not None:
                # T~(r_k): the k folds' little-endian order
                coeff = coeff * int(mle_eval(k_table, self._challenges)) % _P
            terms.append((coeff, tabs))
        with span("upload"):
            self._delegate = TorchSopOracleD(self.log_t, terms, self.degree,
                                             device=dev)
