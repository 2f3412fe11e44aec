"""Judge a TwistSound proof (magic TWSS, format version 2) of a memory
trace.

The statement is Twist (Setty and Thaler, ePrint 2025/105, read-write
memory checking) with one-hot addresses in one chunk (d = 1).  Over K =
2^log_k cells and T = 2^log_t cycles, on the (k, j) cube (index j K + k,
variable 0 the lowest bit of k), the prover commits seven tables:

  ra(k, j), wa(k, j)   1 where cycle j reads (writes) cell k, else 0;
  Inc(k, j)            what cycle j's write adds to cell k;
  Val(k, j)            cell k before cycle j: the sum of Inc(k, j') over
                       the cycles j' < j (memory starts at zero);
  ot(j), rv(j), wv(j)  over the cycles: the write flag, the value read
                       and the value written (0 where there is none).

One sum-check of degree 3 over all log K + log T variables shows that a
sum of eight constraint groups is 0, each group weighted by an eq
polynomial at a challenge point of its own and the groups batched by the
powers 1, alpha, ..., alpha^7:

  READ     rv(j) = sum_k ra(k, j) Val(k, j)
  VAL      Val(tau) = sum_(k, j) eq(tau_k, k) lt(j, tau_j) Inc(k, j)
  INC      Inc = wa (wv - Val)
  BOOL     ra, wa and ot take only the values 0 and 1
  ROW-SUM  sum_k ra(k, j) = 1 - ot(j) and sum_k wa(k, j) = ot(j)

A group that holds cycle by cycle (READ, ROW-SUM, ot's BOOL) puts its
cycle-only part on the cube with the weight 1/K, so that its sum over k
is the cycle's constraint.  The sum-check's last claim is then a
polynomial in the seven tables' values at its point r = (r_k, r_j), the
four cube tables at r and the cycle columns at r_j; two PST openings of
gamma-combinations, one a side, pin those values to the commitments.

Where this judge departs from the paper, it follows the program's
statement: d = 1; cycles past the trace up to a power of two read cell 0
and write nothing; the cube tables are committed under the deterministic
PST set-up of log K + log T variables and the cycle columns under that of
log T (each trapdoor the first n draws of the set-up's one ChaCha
stream, ``pst.srs_taus``); the openings' equation is checked in G1
through the trapdoor (``pst``).

The judge never makes the 2^(log K + log T) cube.  A cube table's value
at a point (p_k, p_j) is a sum over the cycles: eq(p_k, address) eq(p_j,
j) for ra and wa, times the increment for Inc; for Val each write's
increment weighs eq(p_k, address) by the sum of eq(p_j, j') over the
cycles j' after the write (it is in memory from the next cycle on)."""

from __future__ import annotations

import struct
from operator import mul
from typing import List, Sequence

from . import pst
from .columns import _next_pow2
from .curve import P, Malformed, x_hash
from .pst import eq_eval, eq_table, lt_eval, rlc
from .transcript import Transcript
from .wire import Reader

#: the committed tables in the order of the proof and the transcript
CUBE_TABLES = ("ra", "wa", "inc", "val")
CYCLE_COLUMNS = ("ot", "rv", "wv")
#: the round polynomials' coefficients (degree 3)
COEFFS = 4


class TwistSoundColumns:
    """The seven tables of a memory trace, kept sparse: the cycles that
    read and the cell each reads, the value each returns; the cycles that
    write, their cell, value and increment.  Cycles past the trace up to
    the next power of two read cell 0."""

    def __init__(self, log_k: int, is_write: Sequence[int],
                 addr: Sequence[int], value: Sequence[int]):
        self.log_k = log_k
        self.log_t = _next_pow2(len(addr)).bit_length() - 1
        mem = [0] * (1 << log_k)
        self.reads, self.read_cell, self.read_value = [], [], []
        self.writes, self.write_cell = [], []
        self.write_value, self.increment = [], []
        for j, (w, a, v) in enumerate(zip(is_write, addr, value)):
            if w:
                v %= P
                self.writes.append(j)
                self.write_cell.append(a)
                self.write_value.append(v)
                self.increment.append((v - mem[a]) % P)
                mem[a] = v
            else:
                self.reads.append(j)
                self.read_cell.append(a)
                self.read_value.append(mem[a])
        for j in range(len(addr), 1 << self.log_t):
            self.reads.append(j)
            self.read_cell.append(0)
            self.read_value.append(mem[0])
        self._at_cube_tau = None

    def at_eq(self, eq: Sequence[int]) -> List[int]:
        """ot, rv and wv at the point whose eq table over the cycles is
        ``eq``."""
        return [sum([eq[j] for j in self.writes]) % P,
                sum(map(mul, [eq[j] for j in self.reads],
                        self.read_value)) % P,
                sum(map(mul, [eq[j] for j in self.writes],
                        self.write_value)) % P]

    def cube_at_eq(self, eq_k: Sequence[int], eq_j: Sequence[int]
                   ) -> List[int]:
        """ra, wa, Inc and Val at the cube point (p_k, p_j) whose halves'
        eq tables are ``eq_k`` (over the cells) and ``eq_j`` (over the
        cycles)."""
        ra = sum(eq_k[a] * eq_j[j]
                 for j, a in zip(self.reads, self.read_cell)) % P
        at_write = [eq_k[a] * eq_j[j] % P
                    for j, a in zip(self.writes, self.write_cell)]
        wa = sum(at_write) % P
        inc = sum(map(mul, at_write, self.increment)) % P
        # after[j]: eq_j summed over the cycles from j on
        after = [0] * (len(eq_j) + 1)
        for j in range(len(eq_j) - 1, -1, -1):
            after[j] = (after[j + 1] + eq_j[j]) % P
        val = sum(eq_k[a] * d % P * after[j + 1]
                  for j, a, d in zip(self.writes, self.write_cell,
                                     self.increment)) % P
        return [ra, wa, inc, val]

    def cube_at(self, point: Sequence[int]) -> List[int]:
        return self.cube_at_eq(eq_table(point[:self.log_k]),
                               eq_table(point[self.log_k:]))

    def at_cube_tau(self) -> List[int]:
        """The cube tables at the trapdoor of the cube's SRS: the scalars
        of their commitments (kept: every proof of this trace reads
        them)."""
        if self._at_cube_tau is None:
            self._at_cube_tau = self.cube_at(
                pst.srs_taus(self.log_k + self.log_t))
        return self._at_cube_tau


class _Reader(Reader):
    """``wire.Reader`` for the sound tier's format version 2."""

    def __init__(self, data: bytes, magic: bytes):
        if data[:4] != magic or len(data) < 8:
            raise Malformed(f"not a {magic!r} proof")
        if struct.unpack_from("<I", data, 4)[0] != 2:
            raise Malformed("not version 2")
        self.data, self.off = data, 8

    def fixed_points(self, n: int) -> List[bytes]:
        """``n`` compressed G1 points with no count before them."""
        if self.off + 32 * n > len(self.data):
            raise Malformed("truncated")
        out = [self.data[self.off + 32 * i: self.off + 32 * (i + 1)]
               for i in range(n)]
        self.off += 32 * n
        return out


def _parse(data: bytes) -> dict:
    rd = _Reader(data, b"TWSS")
    pf = {"log_k": rd.u64(), "log_t": rd.u64(),
          "comms": rd.fixed_points(len(CUBE_TABLES) + len(CYCLE_COLUMNS)),
          "rounds": [rd.fr_vec() for _ in range(rd.count())],
          "final": rd.fr(), "cube_values": rd.fr_vec(),
          "col_values": rd.fr_vec(), "cube_proof": rd.points(),
          "col_proof": rd.points()}
    rd.end()
    return pf


def _final_claim(log_k: int, ch: dict, r: Sequence[int],
                 cube: Sequence[int], cyc: Sequence[int]) -> int:
    """The batched constraint at r from the claimed values: each group's
    polynomial in the tables' values, times its eq weight at r."""
    r_k, r_j = r[:log_k], r[log_k:]
    v_ra, v_wa, v_inc, v_val = cube
    v_ot, v_rv, v_wv = cyc
    kinv = pow(1 << log_k, -1, P)
    tau = ch["tau"]
    groups = [
        # READ
        eq_eval(ch["rho_read"], r_j) * (v_ra * v_val - kinv * v_rv),
        # VAL
        eq_eval(tau, r) * v_val
        - eq_eval(tau[:log_k], r_k) * lt_eval(r_j, tau[log_k:]) * v_inc,
        # INC
        eq_eval(ch["sigma"], r) * (v_inc - v_wa * (v_wv - v_val)),
        # BOOL: ra, wa, ot
        eq_eval(ch["rho_bool_ra"], r) * v_ra * (v_ra - 1),
        eq_eval(ch["rho_bool_wa"], r) * v_wa * (v_wa - 1),
        eq_eval(ch["rho_bool_ot"], r_j) * v_ot * (v_ot - 1),
        # ROW-SUM: ra, wa
        eq_eval(ch["rho_rowsum_ra"], r_j) * (v_ra - kinv * (1 - v_ot)),
        eq_eval(ch["rho_rowsum_wa"], r_j) * (v_wa - kinv * v_ot),
    ]
    return rlc([g % P for g in groups], ch["alpha"])


def judge(data: bytes, cols: TwistSoundColumns, taus: Sequence[int],
          eq_tau_values: Sequence[int] = None) -> List[str]:
    """The names of the checks ``data`` fails as a proof of the trace
    whose tables are ``cols``; [] for a proof that is right.  ``taus``:
    the trapdoor of the log T set-up, which commits the cycle columns;
    ``eq_tau_values``: the cycle columns at it, where the caller has
    them.  The cube's trapdoor is the judge's own (``pst.srs_taus``)."""
    try:
        pf = _parse(data)
    except Malformed as exc:
        return [f"wire: {exc}"]
    log_k, log_t = cols.log_k, cols.log_t
    n = log_k + log_t
    if (pf["log_k"], pf["log_t"]) != (log_k, log_t):
        return ["sizes"]
    if (len(pf["rounds"]) != n
            or any(len(p) != COEFFS for p in pf["rounds"])
            or len(pf["cube_values"]) != len(CUBE_TABLES)
            or len(pf["col_values"]) != len(CYCLE_COLUMNS)
            or len(pf["cube_proof"]) != n or len(pf["col_proof"]) != log_t):
        return ["shape"]
    failed = []

    # the commitments, made again through the two trapdoors
    at_tau = (cols.at_eq(eq_table(taus)) if eq_tau_values is None
              else list(eq_tau_values))
    at_cube_tau = cols.at_cube_tau()
    for name, got, want in zip(CUBE_TABLES + CYCLE_COLUMNS, pf["comms"],
                               at_cube_tau + at_tau):
        if got != pst.commitment(want):
            failed.append(f"commitment_{name}")

    tr = Transcript()
    tr.append(b"tsound_version", 2)
    tr.append(b"tsound_log_memory", log_k)
    tr.append(b"tsound_log_ops", log_t)
    for name, enc in zip(CUBE_TABLES + CYCLE_COLUMNS, pf["comms"]):
        tr.append(b"tsound_%s_commitment" % name.encode(), x_hash(enc))
    ch = {}
    for label, size in (("rho_read", log_t), ("tau", n), ("sigma", n),
                        ("rho_bool_ra", n), ("rho_bool_wa", n),
                        ("rho_bool_ot", log_t), ("rho_rowsum_ra", log_t),
                        ("rho_rowsum_wa", log_t)):
        ch[label] = tr.challenges(f"tsound_{label}", size)
    ch["alpha"] = tr.challenge(b"tsound_alpha")

    bad, r = pst.sumcheck(tr, 0, pf["rounds"], pf["final"])
    failed += [f"sumcheck_{b}" for b in bad]
    cube, cyc = pf["cube_values"], pf["col_values"]
    if pf["final"] != _final_claim(log_k, ch, r, cube, cyc):
        failed.append("statement")

    # the claimed values against the trace's own tables
    r_j = r[log_k:]
    eq_rj = eq_table(r_j)
    want_cube = cols.cube_at_eq(eq_table(r[:log_k]), eq_rj)
    want_cyc = cols.at_eq(eq_rj)
    failed += [f"value_{name}" for name, got, want in
               zip(CUBE_TABLES + CYCLE_COLUMNS, cube + cyc,
                   want_cube + want_cyc) if got != want]

    # the two gamma-batched PST openings
    tr.append(b"tsound_cube_values", *cube)
    tr.append(b"tsound_col_values", *cyc)
    g = tr.challenge(b"tsound_gamma")
    if not pst.opening_holds(pst.srs_taus(n), rlc(at_cube_tau, g),
                             rlc(cube, g), r, pf["cube_proof"]):
        failed.append("opening_cube")
    if not pst.opening_holds(taus, rlc(at_tau, g), rlc(cyc, g), r_j,
                             pf["col_proof"]):
        failed.append("opening_cycles")
    return failed
