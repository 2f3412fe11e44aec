"""Judge a ShoutSound proof (magic SHSS, format version 2) of a lookup log
into a public table.

The statement is Shout (Setty and Thaler, ePrint 2025/105, read-only
lookups) with a one-hot address table in one chunk (d = 1).  Over a
public table of K = 2^log_k entries T~ and T = 2^log_t lookups, on the
(k, j) cube (index j K + k, variable 0 the lowest bit of k), the prover
commits two tables:

  ra(k, j)   1 where lookup j reads slot k, else 0;
  rv(j)      over the cycles: the value lookup j returns.

One sum-check of degree 3 over all log K + log T variables shows that a
sum of three constraint groups is 0, each weighted by an eq polynomial at
a challenge point of its own and the groups batched by 1, alpha, alpha^2:

  READ      rv(j) = sum_k ra(k, j) T~(k)
  BOOL      ra takes only the values 0 and 1
  ONE-HOT   sum_k ra(k, j) = 1

READ and ONE-HOT hold cycle by cycle, so their cycle-only parts (rv, 1)
go on the cube with the weight 1/K.  The sum-check's last claim is then a
polynomial in ra at its point r = (r_k, r_j), rv at r_j and the public
table at r_k; two PST openings, ra's over the cube (opened j first) and
rv's over the cycles, pin the two values to the commitments.

Where this judge departs from the paper, it follows the program's
statement: d = 1; cycles past the log up to a power of two look up slot 0;
entries past the table up to a power of two are 0; ra is committed under
the deterministic PST set-up of log K + log T variables and rv under that
of log T (each trapdoor the first n draws of the set-up's one ChaCha
stream, ``pst.srs_taus``); the openings' equation is checked in G1
through the trapdoor (``pst``).

The judge never makes the 2^(log K + log T) cube: ra at a point (p_k,
p_j) is sum_j eq(p_j, j) eq(p_k, slot_j), summed slot by slot, and rv at
p_j is the same slot sums weighed by the table's entries."""

from __future__ import annotations

import functools
from typing import List, Sequence

from . import pst
from .columns import _bucket, _group, _next_pow2
from .curve import P, Malformed, x_hash
from .pst import eq_eval, eq_table
from .transcript import Transcript
from .twist_sound import COEFFS, _Reader

#: the committed tables in the order of the proof and the transcript
TABLES = ("ra", "rv")


@functools.lru_cache(maxsize=2)
def _cube_tau_eq(log_k: int, log_t: int):
    """The eq tables of the two halves of the cube SRS's trapdoor: over
    the slots and over the cycles (the same for every log of a size)."""
    taus = pst.srs_taus(log_k + log_t)
    return eq_table(taus[:log_k]), eq_table(taus[log_k:])


class ShoutSoundColumns:
    """The two tables of a lookup log, kept sparse: the cycles that look
    up each slot.  Cycles past the log up to the next power of two look
    up slot 0."""

    def __init__(self, log_k: int, entries: Sequence[int],
                 index: Sequence[int]):
        self.log_k = log_k
        self.log_t = _next_pow2(len(index)).bit_length() - 1
        k_size = 1 << log_k
        self.entries = ([e % P for e in entries]
                        + [0] * (k_size - len(entries)))
        t_size = 1 << self.log_t
        slots = list(index) + [0] * (t_size - len(index))
        self._by_slot = _group(slots, range(t_size))
        self._at_cube_tau = None

    def _slot_sums(self, eq_j: Sequence[int]):
        """slot -> eq_j summed over the cycles that look it up."""
        return _bucket(eq_j, self._by_slot)

    def at_eq(self, eq: Sequence[int]) -> List[int]:
        """[rv] at the point whose eq table over the cycles is ``eq``."""
        sums = self._slot_sums(eq)
        return [sum(self.entries[a] * s for a, s in sums.items()) % P]

    def cube_at_eq(self, eq_k: Sequence[int], eq_j: Sequence[int]
                   ) -> List[int]:
        """[ra] at the cube point (p_k, p_j) whose halves' eq tables are
        ``eq_k`` (over the slots) and ``eq_j`` (over the cycles)."""
        sums = self._slot_sums(eq_j)
        return [sum(eq_k[a] * s for a, s in sums.items()) % P]

    def cube_at(self, point: Sequence[int]) -> List[int]:
        return self.cube_at_eq(eq_table(point[:self.log_k]),
                               eq_table(point[self.log_k:]))

    def at_cube_tau(self) -> List[int]:
        """[ra] at the trapdoor of the cube's SRS: the scalar of its
        commitment (kept: every proof of this log reads it)."""
        if self._at_cube_tau is None:
            self._at_cube_tau = self.cube_at_eq(
                *_cube_tau_eq(self.log_k, self.log_t))
        return self._at_cube_tau


def _parse(data: bytes) -> dict:
    rd = _Reader(data, b"SHSS")
    pf = {"log_k": rd.u64(), "log_t": rd.u64(),
          "comms": rd.fixed_points(len(TABLES)),
          "rounds": [rd.fr_vec() for _ in range(rd.count())],
          "final": rd.fr(),
          "v_ra": rd.fr(), "ra_proof": rd.points(),
          "v_rv": rd.fr(), "rv_proof": rd.points()}
    rd.end()
    return pf


def _final_claim(log_k: int, ch: dict, r: Sequence[int], v_ra: int,
                 v_rv: int, entries: Sequence[int]) -> int:
    """The batched constraint at r from the claimed values: each group's
    polynomial in them and the table at r_k, times its eq weight at r."""
    r_k, r_j = r[:log_k], r[log_k:]
    kinv = pow(1 << log_k, -1, P)
    alpha = ch["alpha"]
    e_read = eq_eval(ch["rho_read"], r_j)
    e_onehot = eq_eval(ch["rho_onehot"], r_j)
    read = e_read * (v_ra * pst.mle(entries, r_k) - kinv * v_rv)
    boolean = eq_eval(ch["rho_bool"], r) * v_ra * (v_ra - 1)
    onehot = e_onehot * (v_ra - kinv)
    return (read + alpha * boolean + alpha * alpha % P * onehot) % P


def judge(data: bytes, cols: ShoutSoundColumns, taus: Sequence[int],
          eq_tau_values: Sequence[int] = None) -> List[str]:
    """The names of the checks ``data`` fails as a proof of the lookup log
    whose tables are ``cols``; [] for a proof that is right.  ``taus``:
    the trapdoor of the log T set-up, which commits rv; ``eq_tau_values``:
    [rv] at it, where the caller has it.  The cube's trapdoor is the
    judge's own (``pst.srs_taus``)."""
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
            or len(pf["ra_proof"]) != n or len(pf["rv_proof"]) != log_t):
        return ["shape"]
    failed = []

    # the commitments, made again through the two trapdoors
    at_tau = (cols.at_eq(eq_table(taus)) if eq_tau_values is None
              else list(eq_tau_values))
    at_cube_tau = cols.at_cube_tau()
    for name, got, want in zip(TABLES, pf["comms"], at_cube_tau + at_tau):
        if got != pst.commitment(want):
            failed.append(f"commitment_{name}")

    tr = Transcript()
    tr.append(b"ssound_version", 2)
    tr.append(b"ssound_log_table", log_k)
    tr.append(b"ssound_log_lookups", log_t)
    tr.append(b"ssound_table", *cols.entries)
    for name, enc in zip(TABLES, pf["comms"]):
        tr.append(b"ssound_%s_commitment" % name.encode(), x_hash(enc))
    ch = {}
    for label, size in (("rho_read", log_t), ("rho_bool", n),
                        ("rho_onehot", log_t)):
        ch[label] = tr.challenges(f"ssound_{label}", size)
    ch["alpha"] = tr.challenge(b"ssound_alpha")

    bad, r = pst.sumcheck(tr, 0, pf["rounds"], pf["final"])
    failed += [f"sumcheck_{b}" for b in bad]
    v_ra, v_rv = pf["v_ra"], pf["v_rv"]
    if pf["final"] != _final_claim(log_k, ch, r, v_ra, v_rv, cols.entries):
        failed.append("statement")

    # the claimed values against the log's own tables
    r_j = r[log_k:]
    eq_rj = eq_table(r_j)
    if v_ra != cols.cube_at_eq(eq_table(r[:log_k]), eq_rj)[0]:
        failed.append("value_ra")
    if v_rv != cols.at_eq(eq_rj)[0]:
        failed.append("value_rv")

    # the two PST openings, ra's over the cube and rv's over the cycles
    if not pst.opening_holds(pst.srs_taus(n), at_cube_tau[0], v_ra, r,
                             pf["ra_proof"]):
        failed.append("opening_ra")
    if not pst.opening_holds(taus, at_tau[0], v_rv, r_j, pf["rv_proof"]):
        failed.append("opening_rv")
    return failed
