"""The bit-column provers on a torch device: the port of ``TwistBits``,
``ShoutBits`` and ``ShoutBitsCommitted`` from
``tnsh.protocols.twist_bits``.

The provers follow the JAX package's line for line, on the port's own
host layers (column simulation, transcript and challenge schedule, PST
commitments, the proof types).  A prove's committed columns are made once,
as one ``protocols.bit_columns.BitColumns`` record, which every stage
below reads.  What runs on ``device``:

  * the column commitments (2 log K + 4 for TwistBits, log K + 1 for
    ShoutBits, and the table's for ShoutBitsCommitted) and the quotient
    MSMs of the PST openings, through ``MultilinearKZG.commit_many`` /
    ``.commit`` / ``.open`` and the router of ``tnsh_torch.commit.kzg``
    into the scheduled Pippenger of ``tnsh_torch.commit.msm_sched``;
  * on a CUDA device with the engine on and 1024 cycles or more, the
    openings' tables: the column values at the opening points, the
    gamma-RLC tables and their quotients, from the committed columns
    uploaded once (``_Openings``; the host engine computes them
    otherwise);
  * phase A's j tables and j rounds, on ``TorchSopOracleD``
    (``tnsh_torch.iop.bits_oracle``; TwistBits' V~(r_k, j) by the prefix
    scan kernel); its k rounds run on the native host engine, or, under
    TNSH_NO_NATIVE, in host Python ints (tnsh's pure-Python k phase; the
    j tables and rounds stay on ``device``);
  * TwistBits' phase B, the one-term Val-evaluation sum-check, on
    ``TorchSopOracleD``; v_val is V's table after phase A's binds;
  * under TNSH_BITS_DENSE (read at prove time, as tnsh reads it), all of
    phase A on ``device``: the (k, j) cube's 9 + 4 log K tables (TwistBits;
    4 + 2 log K for the Shout provers) built there into one stack
    (``lift_j``, ``lift_k``, ``chi_cube``, ``eq_cube``, ``val_cube``) and
    its log K + log T rounds on ``TorchSopOracleD``: on a CUDA device every
    round is a round-evaluation launch and every bind a fold launch, on the
    CPU their plain versions run.  TwistBits' v_val is then V's cube table
    after the last bind.  The cube holds K T lanes a table, so the path
    fits one 80 GB card up to K T = 2^24; a cube that does not fit the
    card's free memory raises ``InvalidParametersError`` before the stack
    is allocated (``_check_cube_fits``).  Inside the fenced phase
    ``cube_build`` the unfenced child spans ``cube_build/columns`` (the
    columns' and eq tables' uploads, the bit rows), ``cube_build/lift``
    (``lift_j``, ``lift_k``, ``select_cube``), ``cube_build/chi``,
    ``cube_build/val`` and ``cube_build/eq`` (TwistBits only) time the
    build's host side, and ``cube_build/oracle`` the sum-check oracle
    made over the stack (``DenseCubeOracle``); the counter ``cube_lanes``
    adds the stack's F K T lanes as it is allocated (49 x 2^24 for a
    TwistBits prove at K = 2^10, T = 2^14).

``verify`` and ``to_bytes`` are the port's own code; the bytes equal the
JAX package's for the same trace or lookup log and seed, and each
package's verifier accepts the other's proofs, on every path.  The host
types a caller needs (``MemoryTrace``, ``LookupTable``, ``Fr``,
``setup_params``, ``setup_multilinear_params``) are re-exported here, so a
program can drive the port through this module.

As in the JAX package, the three provers (and the sound tier's two) run
with the cyclic garbage collector paused (``_gc_paused``; TNSH_GC_PAUSE=0
opts out), and free the native k-phase state and the device tables of
their oracles in a ``finally``, so nothing waits for a collection while
it is paused.  Unlike the JAX package's, the pause is counted: proves
that overlap in threads keep the collector paused until the last of them
returns.  With TNSH_PROFILE=1 ``TwistBits.prove`` prints the JAX
package's stage lines to stderr (``_stage_profiler``).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import os
import sys
import threading
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import torch

from .. import _native
from ..commit.kzg import KZGCommitmentValue
from ..commit.mkzg import (
    ColumnStack,
    MLOpeningProof,
    MultilinearKZG,
    batch_verify_openings,
    multilinear_verification_key,
    setup_multilinear_params,
)
from ..core.params import ProverParams, VerifierParams, setup_params
from ..core.proof_io import (
    MAX_LOG_SIZE,
    shout_bits_comm_proof_to_bytes,
    shout_bits_proof_to_bytes,
    twist_bits_proof_to_bytes,
)
from ..core.transcript import Transcript
from ..errors import InvalidParametersError
from ..field import fr_kernels, limbs
from ..field.fr import MODULUS, Fr
from ..iop.bits_oracle import (
    DenseCubeOracle,
    ShoutBitsSparseOracle,
    TwistBitsSparseOracle,
    address_bits,
    chi_column,
    twist_cube_slots,
    twist_cube_terms,
)
from ..iop.sumcheck_d import (
    SumCheckD,
    SumCheckDProof,
    TorchSopOracleD,
    stack_tables,
)
from ..poly.eq import eq_eval, eq_table, lt_eval, lt_partial_table, mle_eval
from ..utils.profiling import PhaseTimer, count, span
from .bit_columns import BitColumns, padded_table
from .shout import LookupTable
from .sound import (
    _kinv,
    _mle_eval_many,
    _next_power_of_two,
    _rlc_commitments,
    _rlc_tables,
    _rlc_values,
)
from .twist import MemoryTrace

__all__ = ["Fr", "LookupTable", "MemoryTrace", "ShoutBits",
           "ShoutBitsCommProof", "ShoutBitsCommitted", "ShoutBitsProof",
           "TwistBits", "TwistBitsProof", "setup_multilinear_params",
           "setup_params"]

_P = MODULUS
L = limbs.NUM_LIMBS


@dataclass
class TwistBitsProof:
    """Wire version 3: bit-column sound Twist."""

    log_memory: int
    log_ops: int
    #: rb_0..rb_{logK-1}, wb_0..wb_{logK-1}, ot, rv, wv, ic
    column_commitments: List[KZGCommitmentValue]
    #: phase A: the batched claim-0 constraint sum-check over (k, j)
    check_a: SumCheckDProof
    #: v_V = V~(r) claimed between the phases
    v_val: Fr
    #: phase B: the Val-evaluation sum-check over j'
    check_b: SumCheckDProof
    #: committed-column values at r_j: rb_i, wb_i, ot, rv, wv, ic
    values_rj: List[Fr]
    #: committed-column values at s: wb_i, ot, ic
    values_s: List[Fr]
    #: gamma-RLC PST opening of all columns at r_j
    proof_rj: MLOpeningProof
    #: gamma-RLC PST opening of (wb_*, ot, ic) at s
    proof_s: MLOpeningProof


def _chi_scalar(r_ki: int, b: int) -> int:
    return ((1 - r_ki) * ((1 - b) % _P) + r_ki * (b % _P)) % _P


#: The stages the JAX package's ``TwistBits.prove`` prints under
#: TNSH_PROFILE, in its order.
PROFILE_STAGES = ("simulate", "srs", "commit", "oracle_a_build", "phase_a",
                  "phase_b", "open/evals", "open/rlc", "openings")


@contextlib.contextmanager
def _stage_profiler(label: str, timer: PhaseTimer):
    """With TNSH_PROFILE set, print ``[profile] <label>/<stage>: <s> s``
    to stderr as each of ``PROFILE_STAGES`` closes, its seconds those
    ``timer`` measured (one clock); without it, nothing.  The names are
    the JAX package's: ``cube_build`` (TNSH_BITS_DENSE) prints as
    ``oracle_a_build``, which times the dense cube there, and
    ``openings`` is ``open`` less its ``open/evals`` and ``open/rlc``."""
    if not os.environ.get("TNSH_PROFILE"):
        yield
        return
    inner = {}

    def show(name: str, seconds: float) -> None:
        if name == "cube_build":
            name = "oracle_a_build"
        elif name in ("open/evals", "open/rlc"):
            inner[name] = seconds
        elif name == "open":
            name, seconds = "openings", seconds - sum(inner.values())
        if name in PROFILE_STAGES:
            print(f"[profile] {label}/{name}: {seconds:.3f} s",
                  file=sys.stderr)

    timer.listeners.append(show)
    try:
        yield
    finally:
        timer.listeners.remove(show)


#: The proves in flight under ``_gc_paused``, and the lock around it.
_gc_lock = threading.Lock()
_gc_in_flight = 0


def _gc_paused(fn):
    """Pause the cyclic GC for the duration of a prove (opt out with
    TNSH_GC_PAUSE=0, read at call time).  A full collection walks every
    tracked object, the trace's 2^20 operations among them at T=2^20, and
    a prove's allocation bursts bring such collections due (seconds of a
    TwistSound prove at that size).  The provers release their native
    state and device tables in a ``finally``, so nothing depends on a
    collection while the collector is paused.

    The JAX package's pause is re-enabled by whichever prove returns
    first, so a prove overlapping it in another thread runs on with the
    collector back on.  This one counts the proves in flight: the first
    pauses the collector if it is enabled, and the last to return enables
    it again; a collector its caller disabled stays disabled."""

    @functools.wraps(fn)
    def wrap(*args, **kwargs):
        global _gc_in_flight
        with _gc_lock:
            pause = (os.environ.get("TNSH_GC_PAUSE", "1") != "0"
                     and (_gc_in_flight > 0 or gc.isenabled()))
            if pause:
                _gc_in_flight += 1
                gc.disable()
        try:
            return fn(*args, **kwargs)
        finally:
            if pause:
                with _gc_lock:
                    _gc_in_flight -= 1
                    if _gc_in_flight == 0:
                        gc.enable()

    return wrap


def _check_cube_fits(n_tables: int, log_k: int, log_t: int, device,
                     free_bytes: Optional[int] = None) -> None:
    """Raise ``InvalidParametersError`` unless the dense cube's stack of
    ``n_tables`` tables of K T lanes and its first fold (half the stack)
    fit in ``free_bytes``: by default, on a CUDA device, the device's free
    memory and what the caching allocator holds unused; on the CPU host
    memory is the limit, as in the JAX package, and nothing is
    checked."""
    if free_bytes is None:
        device = torch.device(device)
        if device.type != "cuda":
            return
        free_bytes = (torch.cuda.mem_get_info(device)[0]
                      + torch.cuda.memory_reserved(device)
                      - torch.cuda.memory_allocated(device))
    need = n_tables * L * 4 * (1 << (log_k + log_t)) * 3 // 2
    if need > free_bytes:
        raise InvalidParametersError(
            f"the dense cube at K=2^{log_k}, T=2^{log_t} needs {need} "
            f"bytes ({n_tables} tables and the first fold), {free_bytes} "
            "are free")


# ---------------------------------------------------------------------------
# the dense (k, j) cube (TNSH_BITS_DENSE)
# ---------------------------------------------------------------------------
#
# A cube table is an (8, K*T) Montgomery tensor with lane j*K + k (k
# fastest), tnsh's ``_lift_j`` / ``_chi_cube`` order, so the first log K
# folds bind the k bits.  Every table is written straight into its slot of
# one (F, 8, K*T) stack; nothing passes through host lists of K*T values.

def lift_j(slot: torch.Tensor, col: torch.Tensor) -> None:
    """Write the ``(8, T)`` column ``col`` into the cube table ``slot``,
    constant along k (tnsh's ``_lift_j``)."""
    t_size = col.shape[1]
    k_size = slot.shape[1] // t_size
    slot.view(L, t_size, k_size).copy_(
        col.unsqueeze(2).expand(L, t_size, k_size))


def lift_k(slot: torch.Tensor, tab: torch.Tensor) -> None:
    """Write the ``(8, K)`` table ``tab`` into the cube table ``slot``,
    repeated over j (tnsh's ``list(entries) * T``)."""
    k_size = tab.shape[1]
    t_size = slot.shape[1] // k_size
    slot.view(L, t_size, k_size).copy_(
        tab.unsqueeze(1).expand(L, t_size, k_size))


def select_cube(slot: torch.Tensor, mask: torch.Tensor) -> None:
    """Write one where the ``(T, K)`` boolean ``mask`` is set and zero
    elsewhere into the cube table ``slot``."""
    one = limbs.scalar(1, slot.device).view(L, 1, 1)
    torch.where(mask.unsqueeze(0), one, torch.zeros_like(one),
                out=slot.view(L, *mask.shape))


def k_bits(log_k: int, device) -> torch.Tensor:
    """``(log K, K)`` booleans: bit i of k."""
    return address_bits(torch.arange(1 << log_k, device=device), log_k)


def chi_cube(slot: torch.Tensor, bits: torch.Tensor,
             kbit: torch.Tensor) -> None:
    """chi(k_i, b(j)) into ``slot``: one exactly where bit i of k
    (``kbit``, ``(K,)``) equals the column bit b(j) (``bits``, ``(T,)``),
    tnsh's ``_chi_cube``."""
    select_cube(slot, bits.unsqueeze(1) == kbit.unsqueeze(0))


def eq_cube(slot: torch.Tensor, eq_k: torch.Tensor,
            eq_j: torch.Tensor) -> None:
    """eq(sigma, (k, j)) = eq(sigma_k, k) eq(sigma_j, j) into ``slot``
    from the two ``(8, K)`` and ``(8, T)`` eq tables: one product a lane
    (``mont_mul_chain``, iters 1)."""
    lift_j(slot, eq_j)
    over_k = torch.empty_like(slot)
    lift_k(over_k, eq_k)
    slot.copy_(fr_kernels.mont_mul_chain(slot, over_k, 1))


def val_cube(slot: torch.Tensor, waddr: torch.Tensor, wflag: torch.Tensor,
             wv: torch.Tensor) -> None:
    """The virtual Val cube V(k, j) into ``slot``: the value last written
    to cell k before cycle j, or 0.  (tnsh's loop adds ic(j) into cur[a];
    since ic = v - mem[a], cur[a] is mem[a] throughout.)  ``waddr`` and
    ``wflag`` are the cycles' write addresses and write flags, ``wv`` the
    ``(8, T)`` written values.  Index operations only: each write marks
    1 + its cycle at (its cell, the next cycle), a running maximum over j
    carries the mark forward, and the marks gather from [0] + wv."""
    t_size = waddr.shape[0]
    k_size = slot.shape[1] // t_size
    marks = torch.zeros((k_size, t_size + 1), dtype=torch.long,
                        device=slot.device)
    j = torch.nonzero(wflag).squeeze(1)
    marks[waddr[j], j + 1] = j + 1
    last = torch.cummax(marks, dim=1).values[:, :t_size]
    src = torch.cat([torch.zeros_like(wv[:, :1]), wv], dim=1)
    torch.index_select(src, 1, last.t().reshape(-1), out=slot)


def _twist_cube(columns: BitColumns, eq1, eqb, sigma, device):
    """Phase A's dense stack on ``device`` in ``twist_cube_slots``' order,
    and the ``(log K, T)`` write-bit rows (phase B's chi columns), from
    the marshalled ``columns``.  The tables are written under the child
    spans ``columns`` (the uploads, the bit rows as shifts of the
    addresses), ``lift``, ``chi``, ``val`` and ``eq`` of the open phase;
    the stack's F K T lanes are counted as ``cube_lanes``."""
    log_k, log_t = columns.log_k, columns.log_t
    s = twist_cube_slots(log_k)
    _check_cube_fits(s.count, log_k, log_t, device)
    t_size, k_size = 1 << log_t, 1 << log_k
    with span("columns"):
        eq1_c, eqsj_c, eqb_c, rv_c, wv_c, ic_c = stack_tables(
            [eq1, eq_table(sigma[log_k:]), eqb, columns.rv, columns.wv,
             columns.ic], device)
        eqsk_c = stack_tables([eq_table(sigma[:log_k])], device)[0]
        waddr = torch.from_numpy(columns.write_addr).to(device)
        rbits = address_bits(torch.from_numpy(columns.read_addr).to(device),
                             log_k)
        wbits = address_bits(waddr, log_k)
        otbits = torch.from_numpy(columns.write_flags).to(device)
        kbit = k_bits(log_k, device)
    stack = torch.empty((s.count, L, t_size << log_k), dtype=torch.int32,
                        device=device)
    count("cube_lanes", s.count << (log_k + log_t))
    with span("lift"):
        for f, col in ((s.eq1, eq1_c), (s.rv, rv_c), (s.ic, ic_c),
                       (s.wv, wv_c), (s.eqb, eqb_c)):
            lift_j(stack[f], col)
        for f, row in zip([s.not_ot, s.ot] + s.rbit + s.wbit,
                          [~otbits, otbits] + list(rbits) + list(wbits)):
            select_cube(stack[f], row.unsqueeze(1).expand(t_size, k_size))
    with span("chi"):
        for i in range(log_k):
            chi_cube(stack[s.chi_r[i]], rbits[i], kbit[i])
            chi_cube(stack[s.chi_w[i]], wbits[i], kbit[i])
    with span("val"):
        val_cube(stack[s.val], waddr, otbits, wv_c)
    with span("eq"):
        eq_cube(stack[s.eqs], eqsk_c, eqsj_c)
    return stack, wbits


class ShoutCubeSlots(NamedTuple):
    """The slots of the dense Shout stack: eq1, the chi(k_i, rb_i) cubes,
    the table over k, rv, eqb and the rb_i (4 + 2 log K in all)."""

    eq1: int
    chi_r: List[int]
    tab: int
    rv: int
    eqb: int
    rbit: List[int]
    count: int


def shout_cube_slots(log_k: int) -> ShoutCubeSlots:
    return ShoutCubeSlots(
        eq1=0, chi_r=list(range(1, 1 + log_k)), tab=1 + log_k, rv=2 + log_k,
        eqb=3 + log_k, rbit=list(range(4 + log_k, 4 + 2 * log_k)),
        count=4 + 2 * log_k)


def shout_cube_terms(log_k: int, a_pow, kinv: int):
    """The Shout statement's terms over the dense cube, tnsh's term for
    term (``_shout_build_oracle``, ``twist_bits.py:733-746``), as
    ``(coefficient, slot indices)`` into ``shout_cube_slots``."""
    s = shout_cube_slots(log_k)
    terms = [(1, [s.eq1] + s.chi_r + [s.tab]), (_P - kinv, [s.eq1, s.rv])]
    for i, col in enumerate(s.rbit):
        w = a_pow[1 + i] * kinv % _P
        terms.append((w, [s.eqb, col, col]))
        terms.append((_P - w, [s.eqb, col]))
    return terms


def _shout_cube(columns: BitColumns, entries, eq1, eqb, device):
    """The Shout statement's dense stack on ``device`` in
    ``shout_cube_slots``' order, from the marshalled ``columns``, built
    under the child spans ``columns``, ``lift`` and ``chi`` and counted as
    ``cube_lanes``, as ``_twist_cube``'s."""
    log_k, log_t = columns.log_k, columns.log_t
    s = shout_cube_slots(log_k)
    _check_cube_fits(s.count, log_k, log_t, device)
    t_size, k_size = 1 << log_t, 1 << log_k
    with span("columns"):
        eq1_c, rv_c, eqb_c = stack_tables([eq1, columns.rv, eqb], device)
        tab_c = stack_tables([entries], device)[0]
        rbits = address_bits(torch.from_numpy(columns.read_addr).to(device),
                             log_k)
        kbit = k_bits(log_k, device)
    stack = torch.empty((s.count, L, t_size << log_k), dtype=torch.int32,
                        device=device)
    count("cube_lanes", s.count << (log_k + log_t))
    with span("lift"):
        for f, col in ((s.eq1, eq1_c), (s.rv, rv_c), (s.eqb, eqb_c)):
            lift_j(stack[f], col)
        lift_k(stack[s.tab], tab_c)
        for i in range(log_k):
            select_cube(stack[s.rbit[i]],
                        rbits[i].unsqueeze(1).expand(t_size, k_size))
    with span("chi"):
        for i in range(log_k):
            chi_cube(stack[s.chi_r[i]], rbits[i], kbit[i])
    return stack


def _device_openings(device, size: int) -> bool:
    """The openings' route: their tables (column values, gamma-RLC tables,
    quotients) are computed on ``device`` from the committed columns when
    it is a CUDA device, the engine is on and the columns have 1024 lanes
    or more; on the host engine otherwise."""
    return (torch.device(device).type == "cuda" and size >= 1024
            and _native.available)


class _Openings:
    """A bit-column prover's gamma-RLC PST openings: ``groups`` of
    committed columns (indices into ``columns``, the record's words),
    each opened at its point, in the phases ``open/evals`` (``values``)
    and ``open/rlc`` (``rlc``), then ``open`` itself.

    On the device route (``_device_openings``) the columns go up once as a
    ``ColumnStack``; the stack is dropped once the RLC tables are made,
    and the tables as their quotients come back, before any opening MSM
    is queued.  On the host route the engine's
    ``_mle_eval_many``, ``_rlc_tables`` and ``MultilinearKZG.open`` do the
    same work.  Values and proofs are the same on both."""

    def __init__(self, columns, groups, device):
        self.columns, self.groups, self.device = columns, groups, device
        self.on_device = _device_openings(device, len(columns[0]))
        self.stack = None
        self.tables = []

    def values(self) -> List[List[Fr]]:
        """Each group's column values at its point."""
        if self.on_device:
            self.stack = ColumnStack(self.columns, self.device)
            return [self.stack.evals(cols, pt) for cols, pt in self.groups]
        return [_mle_eval_many([self.columns[c] for c in cols], pt)
                for cols, pt in self.groups]

    def rlc(self, gamma: int) -> None:
        """Each group's gamma-RLC table."""
        if self.on_device:
            self.tables = [self.stack.rlc(cols, gamma)
                           for cols, _ in self.groups]
            self.stack = None
        else:
            self.tables = [_rlc_tables([self.columns[c] for c in cols],
                                       gamma) for cols, _ in self.groups]

    def open(self, params) -> List[tuple]:
        """(value, proof) of each group's opening."""
        tables, self.tables = self.tables, []
        points = [pt for _, pt in self.groups]
        if self.on_device:
            return MultilinearKZG.open_device(params, tables, points,
                                              self.device)
        return [MultilinearKZG.open(params, t, pt, self.device)
                for t, pt in zip(tables, points)]

    def release(self) -> None:
        """Drop the device tables, which a prove that raised may still
        hold."""
        self.stack = None
        self.tables = []


def _bind_statement(transcript: Transcript, log_k: int, log_t: int,
                    comms: Sequence[KZGCommitmentValue]) -> None:
    transcript.append_field_element(b"tbits_version", Fr(3))
    transcript.append_field_element(b"tbits_log_memory", Fr(log_k))
    transcript.append_field_element(b"tbits_log_ops", Fr(log_t))
    for idx, c in enumerate(comms):
        transcript.append_field_element(
            b"tbits_col_commitment_%d" % idx, c.hash()
        )


def _challenges(transcript: Transcript, log_k: int, log_t: int):
    n = log_k + log_t
    rho1 = transcript.challenge_field_elements(b"tbits_rho_read", log_t)
    sigma = transcript.challenge_field_elements(b"tbits_sigma", n)
    rhob = transcript.challenge_field_elements(b"tbits_rho_bool", log_t)
    alpha = transcript.challenge_field_element(b"tbits_alpha")
    return rho1, sigma, rhob, alpha


def _alpha_powers(alpha: Fr, count: int) -> List[int]:
    a = int(alpha)
    out = [1]
    for _ in range(count):
        out.append(out[-1] * a % _P)
    return out


class TwistBits:
    """Trapdoor-free verifier-enforced Twist (bit-column commitments)."""

    @staticmethod
    @_gc_paused
    def prove(trace: MemoryTrace, prover_params: ProverParams, device,
              timer: Optional[PhaseTimer] = None) -> TwistBitsProof:
        """Prove ``trace``; commitments, openings and the j-phase
        sum-check work run on ``device`` (a CUDA device, or the CPU with
        the kernels' plain versions).

        ``timer`` (optional) receives one phase per prover stage, phase
        A's split into ``k_rounds``, ``j_build`` and ``j_rounds`` (under
        TNSH_BITS_DENSE ``cube_build`` in place of ``oracle_a_build``, and
        no ``j_build``), ``open``'s tables as ``open/evals`` (the column
        evaluations) and ``open/rlc`` (the gamma combinations),
        and child spans (``PhaseTimer.span``): the columns' marshalling as
        ``commit/marshal``, the quotient tables as ``open/quotients``, the
        MSMs' stages as ``commit/plan``, ``commit/upload``,
        ``commit/launch``, ``commit/wait``, ``commit/combine`` and
        ``commit/host_msm`` (and the same under ``open``), the k phase's
        inputs as ``oracle_a_build/marshal`` (on a CUDA device the j
        stack with its six tables, the addresses and the write flags,
        which the k rounds on the card read, counted as
        ``k_device_rounds``; elsewhere the engine's inputs), the j phase's
        inputs as ``j_build/upload`` (eq(r_k, .), and off the card the
        addresses, the write flags and the six host tables, into their
        slots of the j stack; the rest of ``j_build`` is card work: the
        bit and chi columns and V's prefix scan, counted as
        ``j_scan_lanes``), and under TNSH_BITS_DENSE the
        cube's build steps as ``cube_build/columns``, ``/lift``, ``/chi``,
        ``/val``, ``/eq`` and ``/oracle``.  With TNSH_PROFILE set the JAX
        package's nine stage lines go to stderr (``_stage_profiler``)."""
        timer = PhaseTimer() if timer is None else timer
        with _stage_profiler("TwistBits.prove", timer):
            return TwistBits._prove(trace, prover_params, device, timer)

    @staticmethod
    def _prove(trace: MemoryTrace, prover_params: ProverParams, device,
               timer: PhaseTimer) -> TwistBitsProof:
        # --- committed columns by honest simulation ----------------------
        with timer.phase("simulate"):
            cols = BitColumns.from_trace(trace)
        log_k, log_t = cols.log_k, cols.log_t

        with timer.phase("srs"):
            params_t, _ = setup_multilinear_params(log_t)
            MultilinearKZG.prepare_device(params_t, device)
        with timer.phase("commit"):
            # one burst: all 2logK+4 column MSMs dispatched together
            comms = MultilinearKZG.commit_many(params_t, cols.marshal(),
                                               device)

        transcript = Transcript(prover_params.fiat_shamir_seed)
        _bind_statement(transcript, log_k, log_t, comms)
        rho1, sigma, rhob, alpha = _challenges(transcript, log_k, log_t)

        # --- phase A: batched constraint sum-check over the cube ---------
        a_pow = _alpha_powers(alpha, 2 + 2 * log_k + 1)
        kinv = _kinv(log_k)
        n = log_k + log_t
        degree = log_k + 3
        dense = bool(os.environ.get("TNSH_BITS_DENSE"))
        oracle_a = oracle_b = None
        try:
            if dense:
                # the (k, j) cube on the device: phase A's n rounds on the
                # round-evaluation and fold kernels
                with timer.phase("cube_build"):
                    stack, wbits = _twist_cube(
                        cols, eq_table(rho1), eq_table(rhob), sigma, device)
                    oracle_a = DenseCubeOracle(
                        "TwistBits", log_k, log_t,
                        twist_cube_terms(log_k, a_pow, kinv), degree, stack,
                        timer)
                    del stack
            else:
                with timer.phase("oracle_a_build"):
                    oracle_a = TwistBitsSparseOracle(
                        cols, rho1=rho1, sigma_k=sigma[:log_k],
                        sigma_j=sigma[log_k:], rhob=rhob,
                        alpha_powers=a_pow, kinv=kinv, degree=degree,
                        device=device, timer=timer,
                        native=_native.available,
                    )
            with timer.phase("phase_a"):
                check_a, r = SumCheckD(n, Fr(0), degree).prove_with_challenges(
                    oracle_a, transcript
                )
            r_k, r_j = r[:log_k], r[log_k:]

            # --- phase B: Val-evaluation sum-check over j' ---------------
            with timer.phase("phase_b"):
                lt_col = lt_partial_table(log_t, r_j)
                # V~(r) = Σ_j lt~(j, r_j) · ot ic Π chi(r_k, wb(j)), the
                # identity phase B proves: V's table after phase A's n
                # binds (tnsh's _mle_eval(V, r)), the cube's or the j
                # stack's
                v_val = Fr(limbs.unpack(
                    oracle_a.tables[twist_cube_slots(log_k).val])[0])
                # the chi_w columns live only until the oracle's stack
                # holds them
                rows = wbits if dense else oracle_a.wbits
                oracle_b = TorchSopOracleD(
                    log_t, [(1, [lt_col, cols.ot, cols.ic] + [
                        chi_column(rows[m], int(r_k[m]), device)
                        for m in range(log_k)])], degree, device=device)
                del rows
                transcript.append_field_element(b"tbits_v_val", v_val)
                check_b, s = SumCheckD(
                    log_t, v_val, degree
                ).prove_with_challenges(oracle_b, transcript)
        finally:
            for o in (oracle_a, oracle_b):
                if o is not None:
                    o.release()

        # --- batched openings --------------------------------------------
        # all columns at r_j; (wb_*, ot, ic) at s
        cols_s = list(range(log_k, 2 * log_k + 1)) + [2 * log_k + 3]
        openings = _Openings(
            cols.columns, [(range(2 * log_k + 4), r_j), (cols_s, s)], device)
        try:
            with timer.phase("open"):
                with timer.phase("open/evals"):
                    values_rj, values_s = openings.values()
                transcript.append_field_elements(b"tbits_values_rj",
                                                 values_rj)
                transcript.append_field_elements(b"tbits_values_s", values_s)
                gamma = transcript.challenge_field_element(b"tbits_gamma")
                g = int(gamma)
                with timer.phase("open/rlc"):
                    openings.rlc(g)
                (val_rj, proof_rj), (val_s, proof_s) = openings.open(
                    params_t)
                if int(val_rj) != _rlc_values(values_rj, g) or int(
                        val_s) != _rlc_values(values_s, g):
                    raise AssertionError("opened values disagree with the "
                                         "claimed column values")
        finally:
            openings.release()

        return TwistBitsProof(
            log_memory=log_k,
            log_ops=log_t,
            column_commitments=comms,
            check_a=check_a,
            v_val=Fr(v_val),
            check_b=check_b,
            values_rj=values_rj,
            values_s=values_s,
            proof_rj=proof_rj,
            proof_s=proof_s,
        )

    @staticmethod
    def verify(proof: TwistBitsProof, verifier_params: VerifierParams
               ) -> bool:
        log_k, log_t = proof.log_memory, proof.log_ops
        # Bound untrusted size fields BEFORE any allocation or challenge
        # draw (malicious bytes could otherwise drive 2^63-scale work).
        if not (1 <= log_k <= MAX_LOG_SIZE and 0 <= log_t <= MAX_LOG_SIZE):
            return False
        n = log_k + log_t
        n_cols = 2 * log_k + 4
        if len(proof.column_commitments) != n_cols:
            return False
        if len(proof.values_rj) != n_cols:
            return False
        if len(proof.values_s) != log_k + 2:
            return False

        transcript = Transcript(verifier_params.fiat_shamir_seed)
        _bind_statement(transcript, log_k, log_t, proof.column_commitments)
        rho1, sigma, rhob, alpha = _challenges(transcript, log_k, log_t)

        degree = log_k + 3
        ok, r = SumCheckD(n, Fr(0), degree).verify(
            proof.check_a, transcript
        )
        if not ok:
            return False
        r_k, r_j = r[:log_k], r[log_k:]

        transcript.append_field_element(b"tbits_v_val", proof.v_val)
        ok, s = SumCheckD(log_t, proof.v_val, degree).verify(
            proof.check_b, transcript
        )
        if not ok:
            return False

        # --- final-evaluation binding, phase A ---------------------------
        vals = [int(v) % _P for v in proof.values_rj]
        v_rb = vals[:log_k]
        v_wb = vals[log_k: 2 * log_k]
        v_ot, v_rv, v_wv, v_ic = vals[2 * log_k:]
        v_V = int(proof.v_val)
        a_pow = _alpha_powers(alpha, 2 + 2 * log_k + 1)
        kinv = _kinv(log_k)
        e1 = int(eq_eval(rho1, r_j))
        es = int(eq_eval(sigma, r))
        eb = int(eq_eval(rhob, r_j))
        ra_r = (1 - v_ot) % _P
        wa_r = v_ot
        for i in range(log_k):
            ra_r = ra_r * _chi_scalar(int(r_k[i]), v_rb[i]) % _P
            wa_r = wa_r * _chi_scalar(int(r_k[i]), v_wb[i]) % _P
        want = (
            e1 * ra_r % _P * v_V
            - kinv * e1 % _P * v_rv
            + a_pow[1] * es % _P * wa_r % _P
            * ((v_ic - v_wv + v_V) % _P)
        ) % _P
        for i, b in enumerate(v_rb + v_wb + [v_ot]):
            want = (
                want
                + a_pow[2 + i] * kinv % _P * eb % _P * b % _P
                * ((b - 1) % _P)
            ) % _P
        if int(proof.check_a.final_evaluation) != want:
            return False

        # --- final-evaluation binding, phase B ---------------------------
        sv = [int(v) % _P for v in proof.values_s]
        s_wb = sv[:log_k]
        s_ot, s_ic = sv[log_k], sv[log_k + 1]
        want_b = int(lt_eval(s, r_j)) * s_ot % _P * s_ic % _P
        for i in range(log_k):
            want_b = want_b * _chi_scalar(int(r_k[i]), s_wb[i]) % _P
        if int(proof.check_b.final_evaluation) != want_b:
            return False

        # --- two batched PST openings back every claimed value -----------
        transcript.append_field_elements(b"tbits_values_rj",
                                         list(proof.values_rj))
        transcript.append_field_elements(b"tbits_values_s",
                                         list(proof.values_s))
        gamma = transcript.challenge_field_element(b"tbits_gamma")
        g = int(gamma)
        vk_t = multilinear_verification_key(log_t)
        comms = proof.column_commitments
        comm_rj = _rlc_commitments(comms, g)
        comms_s = comms[log_k: 2 * log_k] + [comms[2 * log_k],
                                             comms[2 * log_k + 3]]
        comm_s = _rlc_commitments(comms_s, g)
        return batch_verify_openings([
            (vk_t, comm_rj, r_j,
             Fr(_rlc_values(proof.values_rj, g)), proof.proof_rj),
            (vk_t, comm_s, s,
             Fr(_rlc_values(proof.values_s, g)), proof.proof_s),
        ])

    @staticmethod
    def to_bytes(proof: TwistBitsProof) -> bytes:
        """The wire-v3 encoding of ``proof``."""
        return twist_bits_proof_to_bytes(proof)


@dataclass
class ShoutBitsProof:
    """Wire version 3: bit-column sound Shout."""

    log_table: int
    log_lookups: int
    #: rb_0..rb_{logK-1}, rv
    column_commitments: List[KZGCommitmentValue]
    #: the batched claim-0 constraint sum-check over (k, j)
    check: SumCheckDProof
    #: committed-column values at r_j: rb_i, rv
    values_rj: List[Fr]
    #: gamma-RLC PST opening of all columns at r_j
    proof_rj: MLOpeningProof


@dataclass
class ShoutBitsCommProof:
    """Wire version 3 (magic SHBC): committed-table sound Shout.

    The verifier's table input is a PST commitment, not the entries, so
    verification is O(logK + logT) group and field work.  The table
    commitment is public preprocessing: anyone can compute it once from
    the public table with :meth:`ShoutBitsCommitted.preprocess`."""

    log_table: int
    log_lookups: int
    #: rb_0..rb_{logK-1}, rv
    column_commitments: List[KZGCommitmentValue]
    #: the batched claim-0 constraint sum-check over (k, j)
    check: SumCheckDProof
    #: committed-column values at r_j: rb_i, rv
    values_rj: List[Fr]
    #: T~(r_k), opened against the table commitment
    t_value: Fr
    #: gamma-RLC PST opening of all columns at r_j
    proof_rj: MLOpeningProof
    #: PST opening of the table commitment at r_k
    proof_t: MLOpeningProof


def _shout_phase_a(timer: PhaseTimer, cols: BitColumns, entries,
                   transcript: Transcript, rho1, rhob, alpha, device):
    """The claim-0 sum-check both Shout provers run over the marshalled
    ``cols``, staged as ``oracle_a_build`` (under TNSH_BITS_DENSE
    ``cube_build``) and ``phase_a``: (proof, challenges).  The oracle is
    released whatever happens."""
    log_k, log_t = cols.log_k, cols.log_t
    a_pow = _alpha_powers(alpha, 1 + log_k)
    kinv = _kinv(log_k)
    eq1 = eq_table(rho1)
    eqb = eq_table(rhob)
    degree = log_k + 2
    n = log_k + log_t
    oracle = None
    try:
        if os.environ.get("TNSH_BITS_DENSE"):
            with timer.phase("cube_build"):
                stack = _shout_cube(cols, entries, eq1, eqb, device)
                oracle = DenseCubeOracle(
                    "ShoutBits", log_k, log_t,
                    shout_cube_terms(log_k, a_pow, kinv), degree, stack,
                    timer)
                del stack
        else:
            with timer.phase("oracle_a_build"):
                rb = cols.read_bits
                sparse_terms = [
                    (1, [eq1], rb, entries),
                    (_P - kinv, [eq1, cols.rv], None, None),
                ]
                for i in range(log_k):
                    w = a_pow[1 + i] * kinv % _P
                    sparse_terms.append((w, [eqb, rb[i], rb[i]], None, None))
                    sparse_terms.append((_P - w, [eqb, rb[i]], None, None))
                oracle = ShoutBitsSparseOracle(
                    log_k, log_t, sparse_terms, degree, device=device,
                    timer=timer, native=_native.available)
        with timer.phase("phase_a"):
            return SumCheckD(n, Fr(0), degree).prove_with_challenges(
                oracle, transcript)
    finally:
        if oracle is not None:
            oracle.release()


def _shout_claim(proof, r_k, r_j, rho1, rhob, alpha, t_value: int) -> int:
    """What phase A's final evaluation must be, from the claimed column
    values and T~(r_k)."""
    log_k = len(r_k)
    vals = [int(v) % _P for v in proof.values_rj]
    v_rb, v_rv = vals[:log_k], vals[log_k]
    a_pow = _alpha_powers(alpha, 1 + log_k)
    kinv = _kinv(log_k)
    e1 = int(eq_eval(rho1, r_j))
    eb = int(eq_eval(rhob, r_j))
    ra_r = 1
    for i in range(log_k):
        ra_r = ra_r * _chi_scalar(int(r_k[i]), v_rb[i]) % _P
    want = (e1 * ra_r % _P * t_value - kinv * e1 % _P * v_rv) % _P
    for i, b in enumerate(v_rb):
        want = (
            want
            + a_pow[1 + i] * kinv % _P * eb % _P * b % _P * ((b - 1) % _P)
        ) % _P
    return want


class ShoutBits:
    """Trapdoor-free verifier-enforced Shout (bit-column commitments).

    Lookups are read-only against a public table, so there is no virtual
    Val and no second sum-check: the one-hot expansion
    ra(k,j) = Π_i chi(k_i, rb_i(j)) is always active (padding cycles look
    up slot 0, whose bits are zero), and the whole statement is one
    claim-0 sum-check at round degree logK+2:

      0 = Σ_{k,j}  eq(rho1,j) ra(k,j) T~(k) - (1/K) eq(rho1,j) rv(j)
         + alpha^{1+i} (1/K) eq(rhob,j) rb_i(j) (rb_i(j)-1)   i < logK
    """

    @staticmethod
    @_gc_paused
    def prove(table: LookupTable, prover_params: ProverParams, device,
              timer: Optional[PhaseTimer] = None) -> ShoutBitsProof:
        """Prove ``table``'s lookup log; commitments, the opening and the
        j-phase sum-check work run on ``device`` (a CUDA device, or the
        CPU with the kernels' plain versions).  ``timer`` (optional)
        receives the stages as ``TwistBits.prove`` names them (no
        ``phase_b``; ``open/evals`` and ``open/rlc`` inside ``open``)."""
        timer = PhaseTimer() if timer is None else timer
        with timer.phase("simulate"):
            entries, cols = BitColumns.from_lookups(table)
        log_k, log_t = cols.log_k, cols.log_t
        with timer.phase("srs"):
            params_t, _ = setup_multilinear_params(log_t)
            MultilinearKZG.prepare_device(params_t, device)
        with timer.phase("commit"):
            comms = MultilinearKZG.commit_many(params_t, cols.marshal(),
                                               device)

        transcript = Transcript(prover_params.fiat_shamir_seed)
        _shout_bind_statement(transcript, log_k, log_t, entries, comms)
        rho1, rhob, alpha = _shout_challenges(transcript, log_k, log_t)
        check, r = _shout_phase_a(timer, cols, entries, transcript, rho1,
                                  rhob, alpha, device)
        r_j = r[log_k:]

        openings = _Openings(cols.columns, [(range(log_k + 1), r_j)],
                             device)
        try:
            with timer.phase("open"):
                with timer.phase("open/evals"):
                    (values_rj,) = openings.values()
                transcript.append_field_elements(b"sbits_values_rj",
                                                 values_rj)
                gamma = transcript.challenge_field_element(b"sbits_gamma")
                g = int(gamma)
                with timer.phase("open/rlc"):
                    openings.rlc(g)
                ((val_rj, proof_rj),) = openings.open(params_t)
                if int(val_rj) != _rlc_values(values_rj, g):
                    raise AssertionError("opened value disagrees with the "
                                         "claimed column values")
        finally:
            openings.release()

        return ShoutBitsProof(
            log_table=log_k,
            log_lookups=log_t,
            column_commitments=comms,
            check=check,
            values_rj=values_rj,
            proof_rj=proof_rj,
        )

    @staticmethod
    def verify(proof: ShoutBitsProof, table_entries: Sequence[Fr],
               verifier_params: VerifierParams) -> bool:
        log_k, log_t = proof.log_table, proof.log_lookups
        # The honest log_table is a function of the verifier's own table;
        # recomputing it rejects malicious size fields before the
        # 2^log_table padding allocation.
        if not table_entries or log_t > MAX_LOG_SIZE:
            return False
        expected_k = _next_power_of_two(len(table_entries))
        if log_k != max(expected_k.bit_length() - 1, 1):
            return False
        n = log_k + log_t
        entries = [int(e) % _P for e in table_entries]
        k_size = 1 << log_k
        if len(entries) > k_size:
            return False
        entries = entries + [0] * (k_size - len(entries))
        if len(proof.column_commitments) != log_k + 1:
            return False
        if len(proof.values_rj) != log_k + 1:
            return False

        transcript = Transcript(verifier_params.fiat_shamir_seed)
        _shout_bind_statement(
            transcript, log_k, log_t, entries, proof.column_commitments
        )
        rho1, rhob, alpha = _shout_challenges(transcript, log_k, log_t)

        degree = log_k + 2
        ok, r = SumCheckD(n, Fr(0), degree).verify(proof.check, transcript)
        if not ok:
            return False
        r_k, r_j = r[:log_k], r[log_k:]
        want = _shout_claim(proof, r_k, r_j, rho1, rhob, alpha,
                            int(mle_eval(entries, r_k)))
        if int(proof.check.final_evaluation) != want:
            return False

        transcript.append_field_elements(b"sbits_values_rj",
                                         list(proof.values_rj))
        gamma = transcript.challenge_field_element(b"sbits_gamma")
        g = int(gamma)
        vk_t = multilinear_verification_key(log_t)
        comm = _rlc_commitments(proof.column_commitments, g)
        return batch_verify_openings([
            (vk_t, comm, r_j,
             Fr(_rlc_values(proof.values_rj, g)), proof.proof_rj),
        ])

    @staticmethod
    def to_bytes(proof: ShoutBitsProof) -> bytes:
        """The wire-v3 encoding of ``proof`` (magic SHBT)."""
        return shout_bits_proof_to_bytes(proof)


class ShoutBitsCommitted:
    """Committed-table Shout: an O(logK + logT) verifier.

    ``preprocess`` commits the public table once (deterministic given the
    SRS); ``prove``/``verify`` then exchange only the commitment.  The
    statement, challenges and sum-check mirror :class:`ShoutBits` with
    their own Fiat-Shamir labels ("sbitc_*"), so the two proof families
    cannot be replayed against each other."""

    @staticmethod
    def preprocess(table_entries: Sequence[Fr], device) -> KZGCommitmentValue:
        """The PST commitment of the padded table, its MSM on ``device``
        (from 1024 entries up; a smaller one on the host)."""
        entries, log_k = padded_table(table_entries)
        params_k, _ = setup_multilinear_params(log_k)
        return MultilinearKZG.commit(params_k, entries, device)

    @staticmethod
    @_gc_paused
    def prove(table: LookupTable, prover_params: ProverParams, device,
              timer: Optional[PhaseTimer] = None) -> ShoutBitsCommProof:
        """As :meth:`ShoutBits.prove`, and the table's commitment and
        opening at r_k on ``device`` too."""
        timer = PhaseTimer() if timer is None else timer
        with timer.phase("simulate"):
            entries, cols = BitColumns.from_lookups(table)
        log_k, log_t = cols.log_k, cols.log_t
        with timer.phase("srs"):
            params_t, _ = setup_multilinear_params(log_t)
            params_k, _ = setup_multilinear_params(log_k)
            MultilinearKZG.prepare_device(params_t, device)
            MultilinearKZG.prepare_device(params_k, device)
        with timer.phase("commit"):
            comms = MultilinearKZG.commit_many(params_t, cols.marshal(),
                                               device)
            t_comm = MultilinearKZG.commit(params_k, entries, device)

        transcript = Transcript(prover_params.fiat_shamir_seed)
        _shoutc_bind_statement(transcript, log_k, log_t, t_comm, comms)
        rho1, rhob, alpha = _shoutc_challenges(transcript, log_k, log_t)
        check, r = _shout_phase_a(timer, cols, entries, transcript, rho1,
                                  rhob, alpha, device)
        r_k, r_j = r[:log_k], r[log_k:]

        openings = _Openings(cols.columns, [(range(log_k + 1), r_j)],
                             device)
        try:
            with timer.phase("open"):
                with timer.phase("open/evals"):
                    (values_rj,) = openings.values()
                    t_value = Fr(mle_eval(entries, r_k))
                transcript.append_field_elements(b"sbitc_values_rj",
                                                 values_rj)
                transcript.append_field_element(b"sbitc_t_value", t_value)
                gamma = transcript.challenge_field_element(b"sbitc_gamma")
                g = int(gamma)
                with timer.phase("open/rlc"):
                    openings.rlc(g)
                ((val_rj, proof_rj),) = openings.open(params_t)
                # the table's opening stays on the host route
                tv, proof_t = MultilinearKZG.open(params_k, entries, r_k,
                                                  device)
                if int(val_rj) != _rlc_values(values_rj, g) or int(
                        tv) != int(t_value):
                    raise AssertionError("opened values disagree with the "
                                         "claimed values")
        finally:
            openings.release()

        return ShoutBitsCommProof(
            log_table=log_k,
            log_lookups=log_t,
            column_commitments=comms,
            check=check,
            values_rj=values_rj,
            t_value=t_value,
            proof_rj=proof_rj,
            proof_t=proof_t,
        )

    @staticmethod
    def verify(proof: ShoutBitsCommProof,
               table_commitment: KZGCommitmentValue,
               verifier_params: VerifierParams) -> bool:
        log_k, log_t = proof.log_table, proof.log_lookups
        if not (1 <= log_k <= MAX_LOG_SIZE and 0 <= log_t <= MAX_LOG_SIZE):
            return False
        n = log_k + log_t
        if len(proof.column_commitments) != log_k + 1:
            return False
        if len(proof.values_rj) != log_k + 1:
            return False

        transcript = Transcript(verifier_params.fiat_shamir_seed)
        _shoutc_bind_statement(
            transcript, log_k, log_t, table_commitment,
            proof.column_commitments,
        )
        rho1, rhob, alpha = _shoutc_challenges(transcript, log_k, log_t)

        degree = log_k + 2
        ok, r = SumCheckD(n, Fr(0), degree).verify(proof.check, transcript)
        if not ok:
            return False
        r_k, r_j = r[:log_k], r[log_k:]
        want = _shout_claim(proof, r_k, r_j, rho1, rhob, alpha,
                            int(proof.t_value))
        if int(proof.check.final_evaluation) != want:
            return False

        transcript.append_field_elements(b"sbitc_values_rj",
                                         list(proof.values_rj))
        transcript.append_field_element(b"sbitc_t_value", proof.t_value)
        gamma = transcript.challenge_field_element(b"sbitc_gamma")
        g = int(gamma)
        vk_t = multilinear_verification_key(log_t)
        vk_k = multilinear_verification_key(log_k)
        comm = _rlc_commitments(proof.column_commitments, g)
        return batch_verify_openings([
            (vk_t, comm, r_j,
             Fr(_rlc_values(proof.values_rj, g)), proof.proof_rj),
            (vk_k, table_commitment, r_k, proof.t_value, proof.proof_t),
        ])

    @staticmethod
    def to_bytes(proof: ShoutBitsCommProof) -> bytes:
        """The wire-v3 encoding of ``proof`` (magic SHBC)."""
        return shout_bits_comm_proof_to_bytes(proof)


def _shoutc_bind_statement(transcript: Transcript, log_k: int, log_t: int,
                           t_comm: KZGCommitmentValue,
                           comms: Sequence[KZGCommitmentValue]) -> None:
    transcript.append_field_element(b"sbitc_version", Fr(3))
    transcript.append_field_element(b"sbitc_log_table", Fr(log_k))
    transcript.append_field_element(b"sbitc_log_lookups", Fr(log_t))
    transcript.append_field_element(b"sbitc_table_commitment",
                                    t_comm.hash())
    for idx, c in enumerate(comms):
        transcript.append_field_element(
            b"sbitc_col_commitment_%d" % idx, c.hash()
        )


def _shoutc_challenges(transcript: Transcript, log_k: int, log_t: int):
    rho1 = transcript.challenge_field_elements(b"sbitc_rho_read", log_t)
    rhob = transcript.challenge_field_elements(b"sbitc_rho_bool", log_t)
    alpha = transcript.challenge_field_element(b"sbitc_alpha")
    return rho1, rhob, alpha


def _shout_bind_statement(transcript: Transcript, log_k: int, log_t: int,
                          entries: Sequence[int],
                          comms: Sequence[KZGCommitmentValue]) -> None:
    transcript.append_field_element(b"sbits_version", Fr(3))
    transcript.append_field_element(b"sbits_log_table", Fr(log_k))
    transcript.append_field_element(b"sbits_log_lookups", Fr(log_t))
    transcript.append_field_elements(
        b"sbits_table", [Fr(e) for e in entries]
    )
    for idx, c in enumerate(comms):
        transcript.append_field_element(
            b"sbits_col_commitment_%d" % idx, c.hash()
        )


def _shout_challenges(transcript: Transcript, log_k: int, log_t: int):
    rho1 = transcript.challenge_field_elements(b"sbits_rho_read", log_t)
    rhob = transcript.challenge_field_elements(b"sbits_rho_bool", log_t)
    alpha = transcript.challenge_field_element(b"sbits_alpha")
    return rho1, rhob, alpha
