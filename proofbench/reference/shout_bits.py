"""Judge a ShoutBits proof (magic SHBT) of a lookup log into a public
table.

The statement: over K = 2^log_k entries and T = 2^log_t lookups, the
committed columns are those the log gives, and one batched constraint sums
to zero over (k, j): every lookup reads the table's entry at its index
(eq(rho1, j) ra(k, j) T(k) against rv), and every index bit is boolean.
"""

from __future__ import annotations

from typing import List, Sequence

from . import pst
from .columns import ShoutColumns
from .curve import P, Malformed, x_hash
from .pst import chi, eq_eval, rlc
from .transcript import Transcript
from .wire import Reader


def _parse(data: bytes):
    rd = Reader(data, b"SHBT")
    pf = {"log_k": rd.u64(), "log_t": rd.u64(), "comms": rd.points(),
          "check": rd.sumcheck(), "values_rj": rd.fr_vec(),
          "proof_rj": rd.points()}
    rd.end()
    return pf


def judge(data: bytes, cols: ShoutColumns, taus: Sequence[int],
          eq_tau_values: Sequence[int] = None) -> List[str]:
    """As ``twist_bits.judge``, for a lookup log's columns."""
    try:
        pf = _parse(data)
    except Malformed as exc:
        return [f"wire: {exc}"]
    log_k, log_t = cols.log_k, cols.log_t
    degree = log_k + 2
    if (pf["log_k"], pf["log_t"]) != (log_k, log_t):
        return ["sizes"]
    if (len(pf["comms"]) != log_k + 1 or len(pf["values_rj"]) != log_k + 1
            or pf["check"][0] != degree
            or len(pf["check"][1]) != log_k + log_t
            or any(len(p) != degree + 1 for p in pf["check"][1])):
        return ["shape"]
    failed = []

    at_tau = cols.at(taus) if eq_tau_values is None else eq_tau_values
    for c, (got, want) in enumerate(zip(pf["comms"], at_tau)):
        if got != pst.commitment(want):
            failed.append(f"commitment_{c}")

    entries = cols.entries
    tr = Transcript()
    tr.append(b"sbits_version", 3)
    tr.append(b"sbits_log_table", log_k)
    tr.append(b"sbits_log_lookups", log_t)
    tr.append(b"sbits_table", *entries)
    for c, enc in enumerate(pf["comms"]):
        tr.append(b"sbits_col_commitment_%d" % c, x_hash(enc))
    rho1 = tr.challenges("sbits_rho_read", log_t)
    rhob = tr.challenges("sbits_rho_bool", log_t)
    alpha = tr.challenge(b"sbits_alpha")

    bad, r = pst.sumcheck(tr, 0, pf["check"][1], pf["check"][2])
    failed += [f"phase_a_{b}" for b in bad]
    r_k, r_j = r[:log_k], r[log_k:]

    vals = pf["values_rj"]
    v_rb, v_rv = vals[:log_k], vals[log_k]
    kinv = pow(1 << log_k, -1, P)
    e1, eb = eq_eval(rho1, r_j), eq_eval(rhob, r_j)
    ra = 1
    for i in range(log_k):
        ra = ra * chi(r_k[i], v_rb[i]) % P
    want = (e1 * ra * pst.mle(entries, r_k) - kinv * e1 * v_rv) % P
    for i, b in enumerate(v_rb):
        want = (want + pow(alpha, 1 + i, P) * kinv * eb * b * (b - 1)) % P
    if pf["check"][2] != want:
        failed.append("phase_a_statement")

    at_rj = cols.at(r_j)
    failed += [f"value_rj_{c}" for c in range(log_k + 1)
               if vals[c] != at_rj[c]]

    tr.append(b"sbits_values_rj", *vals)
    g = tr.challenge(b"sbits_gamma")
    if not pst.opening_holds(taus, rlc(at_tau, g), rlc(vals, g), r_j,
                             pf["proof_rj"]):
        failed.append("opening_rj")
    return failed

