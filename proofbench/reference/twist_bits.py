"""Judge a TwistBits proof (magic TWBT) of a memory trace.

The statement: over K = 2^log_k cells and T = 2^log_t cycles, the
committed columns are those the trace gives, and the batched constraint of
phase A sums to zero over (k, j) -- reads return what the memory holds
(through V, the value held, claimed as v_val), writes add their increment,
every address bit is boolean -- while phase B proves v_val as the sum over
earlier write cycles of lt(j', r_j) ot ic prod_i chi(r_k, wb_i).
"""

from __future__ import annotations

from typing import List, Sequence

from . import pst
from .columns import TwistColumns
from .curve import P, Malformed, x_hash
from .pst import chi, eq_eval, lt_eval, rlc
from .transcript import Transcript
from .wire import Reader


def _parse(data: bytes):
    rd = Reader(data, b"TWBT")
    pf = {"log_k": rd.u64(), "log_t": rd.u64(), "comms": rd.points(),
          "check_a": rd.sumcheck(), "v_val": rd.fr(),
          "check_b": rd.sumcheck(), "values_rj": rd.fr_vec(),
          "values_s": rd.fr_vec(), "proof_rj": rd.points(),
          "proof_s": rd.points()}
    rd.end()
    return pf


def judge(data: bytes, cols: TwistColumns, taus: Sequence[int],
          eq_tau_values: Sequence[int] = None) -> List[str]:
    """The names of the checks ``data`` fails as a proof of the trace
    whose columns are ``cols``; [] for a proof that is right.  ``taus``:
    the SRS trapdoor of log T variables; ``eq_tau_values``: the columns at
    tau, where the caller has them."""
    try:
        pf = _parse(data)
    except Malformed as exc:
        return [f"wire: {exc}"]
    log_k, log_t = cols.log_k, cols.log_t
    n_cols = 2 * log_k + 4
    degree = log_k + 3
    if (pf["log_k"], pf["log_t"]) != (log_k, log_t):
        return ["sizes"]
    if (len(pf["comms"]) != n_cols or len(pf["values_rj"]) != n_cols
            or len(pf["values_s"]) != log_k + 2
            or pf["check_a"][0] != degree or pf["check_b"][0] != degree
            or len(pf["check_a"][1]) != log_k + log_t
            or len(pf["check_b"][1]) != log_t
            or any(len(p) != degree + 1
                   for p in pf["check_a"][1] + pf["check_b"][1])):
        return ["shape"]
    failed = []

    # the commitments, made again through the trapdoor
    at_tau = cols.at(taus) if eq_tau_values is None else eq_tau_values
    for c, (got, want) in enumerate(zip(pf["comms"], at_tau)):
        if got != pst.commitment(want):
            failed.append(f"commitment_{c}")

    tr = Transcript()
    tr.append(b"tbits_version", 3)
    tr.append(b"tbits_log_memory", log_k)
    tr.append(b"tbits_log_ops", log_t)
    for c, enc in enumerate(pf["comms"]):
        tr.append(b"tbits_col_commitment_%d" % c, x_hash(enc))
    rho1 = tr.challenges("tbits_rho_read", log_t)
    sigma = tr.challenges("tbits_sigma", log_k + log_t)
    rhob = tr.challenges("tbits_rho_bool", log_t)
    alpha = tr.challenge(b"tbits_alpha")

    bad, r = pst.sumcheck(tr, 0, pf["check_a"][1], pf["check_a"][2])
    failed += [f"phase_a_{b}" for b in bad]
    r_k, r_j = r[:log_k], r[log_k:]
    v_val = pf["v_val"]
    tr.append(b"tbits_v_val", v_val)
    bad, s = pst.sumcheck(tr, v_val, pf["check_b"][1], pf["check_b"][2])
    failed += [f"phase_b_{b}" for b in bad]

    # phase A's final evaluation from the claimed values at r
    vals = pf["values_rj"]
    v_rb, v_wb = vals[:log_k], vals[log_k:2 * log_k]
    v_ot, v_rv, v_wv, v_ic = vals[2 * log_k:]
    a_pow = [pow(alpha, i, P) for i in range(2 * log_k + 3)]
    kinv = pow(1 << log_k, -1, P)
    e1, es, eb = eq_eval(rho1, r_j), eq_eval(sigma, r), eq_eval(rhob, r_j)
    ra, wa = (1 - v_ot) % P, v_ot
    for i in range(log_k):
        ra = ra * chi(r_k[i], v_rb[i]) % P
        wa = wa * chi(r_k[i], v_wb[i]) % P
    want = (e1 * ra * v_val - kinv * e1 * v_rv
            + a_pow[1] * es * wa * (v_ic - v_wv + v_val)) % P
    for i, b in enumerate(v_rb + v_wb + [v_ot]):
        want = (want + a_pow[2 + i] * kinv * eb * b * (b - 1)) % P
    if pf["check_a"][2] != want:
        failed.append("phase_a_statement")

    # phase B's final evaluation from the claimed values at s
    sv = pf["values_s"]
    want_b = lt_eval(s, r_j) * sv[log_k] * sv[log_k + 1] % P
    for i in range(log_k):
        want_b = want_b * chi(r_k[i], sv[i]) % P
    if pf["check_b"][2] != want_b:
        failed.append("phase_b_statement")

    # the claimed values against the columns themselves
    at_rj = cols.at(r_j)
    at_s = cols.at(s)
    cols_s = list(range(log_k, 2 * log_k)) + [2 * log_k, 2 * log_k + 3]
    failed += [f"value_rj_{c}" for c in range(n_cols)
               if vals[c] != at_rj[c]]
    failed += [f"value_s_{c}" for i, c in enumerate(cols_s)
               if sv[i] != at_s[c]]

    # the two gamma-batched PST openings
    tr.append(b"tbits_values_rj", *vals)
    tr.append(b"tbits_values_s", *sv)
    g = tr.challenge(b"tbits_gamma")
    if not pst.opening_holds(taus, rlc(at_tau, g), rlc(vals, g), r_j,
                             pf["proof_rj"]):
        failed.append("opening_rj")
    if not pst.opening_holds(taus, rlc([at_tau[c] for c in cols_s], g),
                             rlc(sv, g), s, pf["proof_s"]):
        failed.append("opening_s")
    return failed

