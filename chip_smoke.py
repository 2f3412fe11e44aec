"""GPU smoke run of the tnsh_torch port: builds the CUDA kernels and the
native host engine from this checkout, holds each kernel against its plain
PyTorch version on the card, then proves TwistBits, ShoutBits,
ShoutBitsCommitted, ShoutSound, TwistSound, Twist and Shout statements at
K=2^10, T=2^16 through the port, with their commitments, openings and
sum-check rounds on the card,
and checks the proofs with the port's verifier and against references on
small inputs.

Usage (from the repository root, on a machine with one NVIDIA GPU):

    python3 chip_smoke.py [--log-t 18] [--profile] [--msm-launches]
                          [--fe-mul-sass]

Phases, one result line each, with ``script_s``, the host seconds since
the script started:

  0  setup     card name, power limit and clock; the three libraries
               (two nvcc, one g++) built side by side, with ptxas'
               registers and spills per kernel
  1  field     mont_mul_chain against its plain version and host
               arithmetic, and the chain probe's rate at 2^19 lanes x 256;
               the same kernel compiled for Fq at the SRS upload's shape;
               both shapes timed on constants built before the timed loop;
               the SASS instruction counts of the chain kernel (one
               product inlined) where cuobjdump gives them
  2  kernels   fold, round evaluations (npts 4 and 14) and
               product_round_evals (with and without scale) against their
               plain versions at N = 2 .. 2^16 on the TwistBits j-phase
               term structure (49 tables, 47 terms); kernel and plain
               times; the round program's products a pair and point beside
               the unfactored count; the round evaluations at npts 14 at
               every halving from N = 2^16 to 2 (the 16 rounds of a
               proof) with how many took one launch, and on phase B's
               one-term 13-factor shape
  3  entry     the flagship round step against its plain version
  7  group     the Jacobian add kernel against its plain version (equal
               points, inverse points, infinities, masked lanes), and its
               own path, ``tree_reduce_points`` over 4096 points, counted
  8  insert    the MSM insertion kernel against its plain version at the
               main path's shape (m = 32768, 32 windows) planned at the
               width derived from the card, and at a small one with
               negative digits, idle lanes, infinity accumulators and a
               forced hazard (the lane doubles): accumulators equal limb
               for limb, hazard counts equal; its time on the same digits
               planned at 4096, 16384, 32768 and 65536 lanes
  10 tail      ``msm_tail`` (group fold, canonical gather, window sums in
               two or three kernels) against its plain version on phase
               8's accumulators (W = 32), on a bit column's (W = 4, one
               group holds half the lanes) and on a small plan with an
               empty window, a one-lane group, infinities, inverse points
               and equal points in one group (the fold doubles); its time
               against the level-wise path (a launch and three rolled
               copies a level), in turns
  9  msm       a 2^16-point MSM on the card with full-width scalars
               (W = 32) and with bit scalars (W = 4) against the native
               host MSM over the same SRS, both times, and the kernel and
               copy launches of each; a 2^14-point MSM over equal bases
               with equal scalars planned at 4096 lanes, where every lane
               meets its own point (hazards counted), and at the derived
               width, where the equal points meet in the tail's fold: both
               the host's element
  4  e2e       TwistBits.prove on the card at K=2^10, T=2^LOG_T (default
               16): verified, a forged proof rejected, launch counts show
               every j round, every commitment and both openings ran on
               the kernels (insertion and tail; no level-wise add) with 0
               hazards; prove time, stage split, MSMs by route and peak
               device memory
  5  reference the proof of the frozen K=8 T=64 trace matches its pinned
               digest, and at K=2^10 T=2^11 the proof on the card equals
               the port's proof on the host (plain versions; the MSMs of
               that host prove on the native host MSM)
  11 shout     the ShoutBits j phase's round evaluations (23 tables, 22
               terms, npts 13) against their plain version at N = 2 ..
               2^16, timed, with the program's products; ShoutBits and
               ShoutBitsCommitted on the card at K=2^10, T=2^LOG_T over
               the lookups ``benches/bits_bench.py`` makes, each with its
               counts set to 0 just before it: verified, forged proofs
               rejected, two proves equal, log T round-evaluation and fold
               launches in phase A, commitments and openings on the
               insertion and tail kernels with 0 hazards, MSMs by route,
               prove times, stage split, peak device memory; the table's
               commitment on the card; the frozen K=8 T=64 ShoutBits
               digest on the card, and at K=2^10 T=2^11 both provers'
               card bytes equal to the port's CPU bytes (plain versions;
               the MSMs of that CPU prove on the native host MSM)
  12 sound     the ShoutSound j phase's round evaluations (5 tables, 6
               terms, npts 4, the folded one-hot twice in one term)
               against their plain version at N = 2 .. 2^16, timed, with
               the program's products; ShoutSound (the sparse path) on the
               card at K=2^10, T=2^LOG_T over the lookups
               ``benches/sound_sparse_bench.py`` makes, its counts set to 0
               just before it: verified, forged proofs (rv value, final
               evaluation, another table) rejected, two proves equal, log T
               round-evaluation and fold launches in the j rounds, both
               commitments and both openings on the insertion and tail
               kernels with 0 hazards, MSMs by route (device
               2 + 2 (log T - 10), host 20 + log K), prove times, stage
               split, peak device memory; the frozen SHSS digests (sizes 4,
               8, 16: the dense path) on the card, dense bytes equal to
               sparse bytes on the card, and at K=2^10 T=2^11 the card's
               bytes equal to the port's CPU bytes (plain versions, host
               MSMs)
  13 twist_sound  the TwistSound j phase's round evaluations (16 tables,
               18 terms, npts 4, 29 products against 41; ra_f and wa_f
               twice in their booleanity terms, ot in its own) against
               their plain version at N = 2 .. 2^16, timed; TwistSound
               (the sparse path) on the card at K=2^10, T=2^LOG_T over the
               trace ``benches/sound_sparse_bench.py`` makes, its counts
               set to 0 just before it: verified, forged proofs (rv value,
               val value, final evaluation) rejected, two proves equal,
               log T round-evaluation and fold launches in the j rounds,
               the seven commitments and both openings on the insertion
               and tail kernels with 0 hazards, no Fq chain (phases 4 and
               12 uploaded its SRSs), MSMs by route (device
               7 + 2 (log T - 10), host 20 + log K), prove times, stage
               split, peak device memory; the frozen TWSS digests (sizes
               4, 8, 16: the dense path) on the card, dense bytes equal to
               sparse bytes on the card, and at K=2^10 T=2^11 the card's
               bytes equal to the port's CPU bytes (plain versions, host
               MSMs)
  14 parity    the product kernel on sound mode's one-factor shape against
               its plain version at N = 2 .. 2^16, timed; the parity Twist
               and Shout (``setup_params(log T - 2)``, the Lagrange SRSs of
               T and K points built on the host first) on the card at
               K=2^10, T=2^LOG_T over phase 4's trace and phase 11's
               lookups, each prove with its counts set to 0 just before it,
               in default and in sound mode: verified (lenient, strict,
               fast), a forged final evaluation and a forged opening
               rejected, two proves equal, MSMs by route device 4 / host 0,
               every MSM on the insertion and tail kernels with 0 hazards,
               the Fq chain on each Lagrange SRS's first upload, in sound
               mode log T product-round and fold launches; prove times,
               stage split, peak device memory, the Lagrange SRSs' build and
               upload seconds; the frozen TWST / SHOT digests (sizes 4, 8,
               16) on the card, and at K=2^10 T=2^11 in sound mode the
               card's bytes equal to the port's CPU bytes (plain versions,
               host MSMs)
  6  profile   (with --profile) one more TwistBits, ShoutBits, ShoutSound,
               TwistSound, Twist and Shout prove under torch.profiler:
               device busy time and share, the busiest device kernels

``--fe-mul-sass`` only builds the sum-check library of the tree it stands
in and prints the SASS instruction counts of its chain kernel (a copy of
the script counts an older tree's product too).

``--msm-launches`` only counts the kernel and copy launches of one
2^16-point MSM under ``torch.profiler`` (W = 32 and W = 4) and prints
neither the kernels' line nor the result line; it calls nothing but
``ScheduledMsmContext.from_native_srs`` and ``msm``.

Then one JSON line with every kernel (route, source, launches on the main
path, worst canonical difference from its plain version, its time by CUDA
events over back-to-back calls (``ms``) and the same with the calls queued
behind a long kernel (``queued_ms``; the smaller where a launch is shorter
than the host takes to queue it), the plain version's, and the least time
the card could take for the same bytes and multiplies; ``launches_by_path``
gives each prover's own count, TwistBits' (the main path's), ShoutBits',
ShoutBitsCommitted's, ShoutSound's, TwistSound's, and Twist's and Shout's
(each its default and its sound-mode prove together), the round
evaluations' row the ShoutBits, ShoutSound and TwistSound shapes as
``shout_bits_shape``, ``shout_sound_shape`` and ``twist_sound_shape``, and
the product row sound mode's one-factor shape as
``twist_parity_sound_shape``), the card's name and power limit, and last
the result
line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line is printed.  Needs no network and one card; exits non-zero
without CUDA.  Every time printed is taken on the card named above it.

It imports nothing of the JAX package and checks so at its end.  The
byte-for-byte comparison with the JAX package's host provers is a test:
``python -m pytest tests/test_torch_twist_bits.py
tests/test_torch_shout_bits.py tests/test_torch_shout_sound.py
tests/test_torch_twist_sound.py tests/test_torch_twist_shout.py -m cuda
-s``.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import random
import re
import subprocess
import sys
import time

import torch

#: (length, sha256) of the K=8, T=64 proof of ``frozen_trace`` (wire v3)
FROZEN = (4856,
          "948e0609dd4a33266972f0cce3e6dc2d8ae8a10b38d448f70ab2cbc1322cffed")

#: (length, sha256) of the K=8, T=64 ShoutBits proof of ``frozen_lookups``
FROZEN_SHOUT = (
    2344, "689c1c848809eb688a42f4301a0b269b48d77dbfa0900123cf1679017b1a9dca")

#: size -> (length, sha256) of the ShoutSound proof of ``golden_lookups``
#: (the dense path; tests/test_golden_vectors.py)
FROZEN_SOUND = {
    4: (944, "44a59504317d1ee44029c01056ccbb2a64d7c8f6e6e07156d1c50cd6430c91a1"),
    8: (1312, "7bab951a9092bae5bb218ae69bd67be91dd89f114c3fcd2c62db97f5f1d1c04c"),
    16: (1680,
         "2984f618d43d2266dc57a30618ff4043501b6972c0e2a9d6d2dd81bd05960794"),
}

#: size -> (length, sha256) of the TwistSound proof of ``golden_trace``
#: (the dense path; tests/test_golden_vectors.py)
FROZEN_TWIST_SOUND = {
    4: (1280, "fe15a0d7c7eea336b6bf36d12903ba038c5186b5da570883d4aae2a200abd34f"),
    8: (1648, "cde2f0f9c146d92d2ad7d6d1f8ea03074ff5ca2387ab0ff6dbbef486da87e91f"),
    16: (2016,
         "9139c9a87ad807fd3de1e67d52c15612ac6a96d313af4fafe22861b787eef58d"),
}

#: size -> ((length, sha256) of the Twist proof of ``golden_trace``,
#: (length, sha256) of the Shout proof of ``golden_lookups``)
#: (tests/test_golden_vectors.py, ``_PROOF_VECTORS``)
FROZEN_PARITY = {
    4: ((528, "c5716ad1c6ddd41fa89494cd8fd49cc481a673ed3007e3da44d37ffbdc8d3ee0"),
        (528, "b3ac5d90d5356c8910fdb231ba3d3ea7e358e20c9e0426bd687d9685648c84e9")),
    8: ((664, "f005ef68d9e9840e1b190c0d1a3911d025e07b43f0d9134a74324a20c6f193f5"),
        (664, "95685f9ab9b298f31ee2e71cee018d3f8752f4914815ed7838bfbab974cd271f")),
    16: ((800,
          "f871ea9056e5f50103dd0da89a0df33411a8eea99b6a079575633b7265b2708e"),
         (800,
          "7ad98c9cee79c36bbde02c112ecced6406eb309905101d2b588370778eac141e")),
}

#: The card's memory rate (NVIDIA's H100 SXM data sheet), bytes a second.
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer multiply-add instructions a clock: 132 SMs x 64 lanes.
IMAD_PER_CLOCK = 132 * 64
#: One CIOS Montgomery product of eight 32-bit limbs is 136 32x32-bit
#: products (64 of a*b, 64 of m*p, 8 of t0*n0), the low and the high half
#: of each an instruction.
IMAD_PER_MUL = 2 * 136


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


#: host clock when the script started, for each phase line's ``script_s``
START = time.perf_counter()


def phase(n: int, name: str, **fields) -> None:
    fields["script_s"] = time.perf_counter() - START
    print(f"[phase {n}] {name} " + json.dumps(fields), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def bound(n_bytes: float, n_muls: float, clock_hz: float):
    """(ms, "bytes" | "operations"): the least time the card could take
    to move ``n_bytes`` (each input read once, each output written once)
    and to do ``n_muls`` Montgomery products."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_muls * IMAD_PER_MUL / (IMAD_PER_CLOCK * clock_hz) * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def product_work(tables) -> tuple:
    """(bytes, Montgomery products) that ``product_round_evals(tables)``
    needs: each table read once and four values written; F - 1 products a
    lane pair and point for F factors, since lo + t (hi - lo) at t = 0..3
    takes only additions."""
    factors, _, n = tables.shape
    return tables.numel() * 4 + 4 * 32, n // 2 * 4 * (factors - 1)


def ptxas_summary(log: str) -> dict:
    """kernel -> {registers, spill_stores, spill_loads}, from what
    ``ptxas -v`` printed during the build."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            known = [k for k in ("fe_chain_kernel", "fr_fold_kernel",
                                 "fr_round_evals_kernel",
                                 "fr_sum_partials_kernel", "g1_padd_kernel",
                                 "msm_insert_kernel", "msm_fold_tiles_kernel",
                                 "msm_window_sums_kernel")
                     if k in m.group(1)]
            name = known[0] if known else m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def fe_mul_sass() -> dict:
    """SASS instruction counts of ``fe_chain_kernel<FrField>``, whose loop
    body is one inlined ``fe_mul`` (the rest: eight loads, eight stores
    and the index arithmetic): the total, every IMAD form, IADD3, and the
    opcodes met most often.  ``{"error": ...}`` where cuobjdump is missing
    or prints nothing for the kernel."""
    import os

    from tnsh_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    try:
        text = subprocess.run(
            [tool, "-sass", _build.build("fr")], capture_output=True,
            text=True, timeout=300, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return {"error": f"{type(exc).__name__}: {exc}"[:200]}
    counts = {}
    for body in text.split("Function :")[1:]:
        if "fe_chain_kernel" not in body.splitlines()[0]:
            continue
        for m in re.finditer(
                r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                body, flags=re.M):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    if not counts:
        return {"error": "no SASS for fe_chain_kernel"}
    by_base = {}
    for op, n in counts.items():
        base = op.split(".")[0]
        by_base[base] = by_base.get(base, 0) + n
    return {"total": sum(counts.values()), "imad": by_base.get("IMAD", 0),
            "imad_wide": sum(n for op, n in counts.items()
                             if op.startswith("IMAD.WIDE")),
            "iadd3": by_base.get("IADD3", 0),
            "top": dict(sorted(by_base.items(), key=lambda kv: -kv[1])[:8])}


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int, blocker) -> float:
    """Mean device time of one call of ``fn`` with the card's queue kept
    full: ``blocker`` puts some milliseconds of work on the stream, the
    ``reps`` calls are queued behind it while it runs, and CUDA events
    around them time the card running them back to back.  Unlike
    ``cuda_ms`` no gap in which the card waits for the host counts, so
    this is the kernel's own time even where a launch is shorter than the
    host takes to queue it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    blocker()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Mean host time of ``fn`` over ``reps`` calls, the card idle before
    and after, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / reps * 1e3


def traced(fn) -> tuple:
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activity),
    synchronized inside the trace: (the CUDA events it saw, the wall
    seconds).  A CUPTI trace now and then comes back without a single
    device event; the call is then traced again, three times in all, and
    the caller's own check decides after that."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        events = [evt for evt in prof.key_averages()
                  if evt.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    return events, wall_s


def device_launches(fn) -> dict:
    """Every kernel, copy and memset that ``fn`` puts on the card, as
    ``torch.profiler`` counts them: the total and the names launched most
    often."""
    counts = {}
    for evt in traced(fn)[0]:
        name = evt.key.replace("(anonymous namespace)::", "")
        name = re.split(r"[<(]", name.removeprefix("void "))[0].strip()
        counts[name] = counts.get(name, 0) + evt.count
    check(bool(counts), "the profiler saw no device activity")
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:6]
    return {"total": sum(counts.values()), "top": dict(top)}


def msm_launches(n: int, seed: int) -> dict:
    """Kernel and copy launches of one ``n``-point MSM over a random SRS,
    with full-width scalars (W = 32) and with bit scalars (W = 4)."""
    import numpy as np

    from tnsh_torch import _native
    from tnsh_torch.commit import msm_sched
    from tnsh_torch.field.g1 import G1

    rng = np.random.default_rng(seed)

    def raw(count):
        w = rng.integers(0, 1 << 32, (count, 8), dtype=np.uint64).astype(
            "<u4")
        w[:, 7] &= 0x0FFFFFFF
        return w.tobytes()

    srs = _native.srs_create_fixed_base(G1.generator(), raw(n))
    out = {}
    try:
        ctx = msm_sched.ScheduledMsmContext.from_native_srs(
            srs, device=torch.device("cuda", 0))
        for name, scal in (
                ("full_w32", raw(n)),
                ("bits_w4", b"".join(bytes([b]) + bytes(31)
                                     for b in rng.integers(0, 2, n).tolist()))):
            check(ctx.msm(scal) == _native.srs_msm(srs, scal),
                  f"msm {name}: the card's result differs from the host's")
            out[name] = device_launches(lambda: ctx.msm(scal))
    finally:
        _native.srs_free(srs)
    return out


def j_phase_terms(log_k: int):
    """The TwistBits phase-A j-phase term structure
    (tnsh/iop/bits_oracle.py ``_build_delegate``) as table indices:
    eq1, rt, chi_r*, Vj, rv, eqsj, ot, chi_w*, ic, wv, eqb, rb*, wb*.
    Returns (term index tuples, number of tables, indices of 0/1 tables)."""
    eq1, rt = 0, 1
    chi_r = list(range(2, 2 + log_k))
    vj, rv, eqsj, ot = 2 + log_k, 3 + log_k, 4 + log_k, 5 + log_k
    chi_w = list(range(6 + log_k, 6 + 2 * log_k))
    ic, wv, eqb = 6 + 2 * log_k, 7 + 2 * log_k, 8 + 2 * log_k
    rbits = list(range(9 + 2 * log_k, 9 + 3 * log_k))
    wbits = list(range(9 + 3 * log_k, 9 + 4 * log_k))
    terms = [
        tuple([eq1, rt] + chi_r + [vj]),
        (eq1, rv),
        tuple([eqsj, ot] + chi_w + [ic]),
        tuple([eqsj, ot] + chi_w + [wv]),
        tuple([eqsj, ot] + chi_w + [vj]),
    ]
    for col in rbits + wbits + [ot]:
        terms.append((eqb, col, col))
        terms.append((eqb, col))
    return tuple(terms), 9 + 4 * log_k, set(rbits + wbits + [rt, ot])


def shout_j_terms(log_k: int):
    """The ShoutBits phase-A j-phase term structure as
    ``ShoutBitsSparseOracle`` hands it to ``TorchSopOracleD``: eq1, the
    chi(r_i, rb_i) columns, rv, eqb, rb*.  Returns (term index tuples,
    number of tables, indices of 0/1 tables)."""
    eq1 = 0
    chi = list(range(1, 1 + log_k))
    rv, eqb = 1 + log_k, 2 + log_k
    rbits = list(range(3 + log_k, 3 + 2 * log_k))
    terms = [tuple([eq1] + chi), (eq1, rv)]
    for col in rbits:
        terms += [(eqb, col, col), (eqb, col)]
    return tuple(terms), 3 + 2 * log_k, set(rbits)


def sound_j_terms():
    """The ShoutSound j-phase term structure as ``SparseCubeOracle`` hands
    it to ``TorchSumOfProductsOracle``: eq_r, ra_f (the one-hot column
    folded at r_k: ONE table), rv, eq_b's j half, eq_o; the booleanity
    term holds ra_f twice.  Returns (term index tuples, number of
    tables)."""
    eq_r, ra_f, rv, ejb, eq_o = range(5)
    return ((eq_r, ra_f), (eq_r, rv), (ejb, ra_f, ra_f), (ejb, ra_f),
            (eq_o, ra_f), (eq_o,)), 5


def twist_sound_j_terms():
    """The TwistSound j-phase term structure as ``SparseCubeOracle`` hands
    it to ``TorchSumOfProductsOracle``: the tables in order of first
    appearance (``_f``: a cube column folded at r_k, val_f in its
    prefix-sum form; the four eqk factors are scalars in their terms'
    coefficients), 18 terms; ra_f and wa_f twice in their booleanity
    terms, ot twice in its own.  Returns (term index tuples, number of
    tables)."""
    (eq1, ra_f, val_f, rv, eq_tauj, lt_tj, inc_f, ej_s, wv, wa_f, ej4, ej5,
     eq6, ot, eq7, eq8) = range(16)
    return ((eq1, ra_f, val_f), (eq1, rv), (eq_tauj, val_f), (lt_tj, inc_f),
            (ej_s, inc_f), (ej_s, wv, wa_f), (ej_s, wa_f, val_f),
            (ej4, ra_f, ra_f), (ej4, ra_f), (ej5, wa_f, wa_f), (ej5, wa_f),
            (eq6, ot, ot), (eq6, ot), (eq7, ra_f), (eq7, ot), (eq7,),
            (eq8, wa_f), (eq8, ot)), 16


class Errors:
    """Worst canonical difference from the plain version, per kernel."""

    def __init__(self):
        self.worst = {}

    def compare(self, kernel: str, got, want, what: str, spec=None) -> None:
        """Canonical values of ``got`` and ``want`` (limb planes of Fr, or
        of ``spec``'s field) must be equal."""
        from tnsh_torch.field import limbs

        spec = limbs.FR_SPEC if spec is None else spec
        a = limbs.unpack(_flat(got), spec)
        b = limbs.unpack(_flat(want), spec)
        check(len(a) == len(b), f"{what}: shapes differ")
        err = max((abs(x - y) for x, y in zip(a, b)), default=0)
        self.worst[kernel] = max(self.worst.get(kernel, 0), err)
        check(err == 0, f"{what}: kernel differs from its plain version")


def _flat(t):
    """(…, 8, n) limb planes -> (8, everything) for unpacking."""
    return t.reshape(-1, 8, t.shape[-1]).transpose(0, 1).reshape(8, -1)


def bench_trace(log_k: int, log_t: int):
    """The trace ``bench.py`` proves: ``random.seed(5)``, a write of 42 i
    every third cycle, reads of random cells otherwise."""
    from tnsh_torch.protocols.twist_bits import Fr, MemoryTrace

    random.seed(5)
    tr = MemoryTrace(1 << log_k)
    for i in range(1 << log_t):
        if i % 3 == 0:
            tr.write(random.randrange(1 << log_k), Fr(42 * i))
        else:
            tr.read(random.randrange(1 << log_k))
    return tr


def frozen_trace():
    """The K=8, T=64 trace whose proof digest is ``FROZEN``."""
    from tnsh_torch.protocols.twist_bits import Fr, MemoryTrace

    random.seed(1234)
    tr = MemoryTrace(8)
    for i in range(64):
        if i % 3 == 0:
            tr.write(random.randrange(8), Fr(random.randrange(1 << 61)))
        else:
            tr.read(random.randrange(8))
    return tr


def bench_lookups(log_k: int, log_t: int):
    """The lookup log ``benches/bits_bench.py`` proves: entries 3i + 1,
    T - 1 lookups drawn from ``random.Random(11)``; the padding cycle looks
    up slot 0."""
    from tnsh_torch.protocols.twist_bits import Fr, LookupTable

    rng = random.Random(11)
    tbl = LookupTable([Fr(3 * i + 1) for i in range(1 << log_k)])
    for _ in range((1 << log_t) - 1):
        tbl.lookup(rng.randrange(1 << log_k))
    return tbl


def frozen_lookups():
    """The K=8, T=64 lookup log whose proof digest is ``FROZEN_SHOUT``."""
    from tnsh_torch.protocols.twist_bits import Fr, LookupTable

    random.seed(99)
    tbl = LookupTable([Fr(i * i + 3) for i in range(8)])
    for _ in range(64):
        tbl.lookup(random.randrange(8))
    return tbl


def sound_lookups(log_k: int, log_t: int):
    """The lookup log ``benches/sound_sparse_bench.py`` proves: entries
    i^2 + 1, T lookups drawn from ``random.Random(1)``."""
    from tnsh_torch.protocols.twist_bits import Fr, LookupTable

    rng = random.Random(1)
    tbl = LookupTable([Fr(i * i + 1) for i in range(1 << log_k)])
    for _ in range(1 << log_t):
        tbl.lookup(rng.randrange(1 << log_k))
    return tbl


def golden_lookups(size: int):
    """The lookup log of the frozen SHSS digests: entries i^2, lookups
    3i mod size."""
    from tnsh_torch.protocols.twist_bits import Fr, LookupTable

    tbl = LookupTable([Fr(i * i) for i in range(size)])
    for i in range(size):
        tbl.lookup((i * 3) % size)
    return tbl


def sound_trace(log_k: int, log_t: int):
    """The trace ``benches/sound_sparse_bench.py`` proves with TwistSound:
    ``random.seed(1)``, a write of 42 i to a random cell when i % 3 == 0,
    else a read of a random cell."""
    from tnsh_torch.protocols.twist_bits import Fr, MemoryTrace

    rng = random.Random(1)
    tr = MemoryTrace(1 << log_k)
    for i in range(1 << log_t):
        if i % 3 == 0:
            tr.write(rng.randrange(1 << log_k), Fr(42 * i))
        else:
            tr.read(rng.randrange(1 << log_k))
    return tr


def golden_trace(size: int):
    """The trace of the frozen TWSS digests: write 42 (i + 1) to cell i,
    then read it, for i < size / 2."""
    from tnsh_torch.protocols.twist_bits import Fr, MemoryTrace

    tr = MemoryTrace(size)
    for i in range(size // 2):
        tr.write(i % size, Fr(42 * (i + 1)))
        tr.read(i % size)
    return tr


def mixed_trace(size: int, n_ops: int):
    """``tests/test_sound_sparse.py``'s mixed trace (seed 3): every third
    operation a write of a random 31-bit value, reads otherwise."""
    from tnsh_torch.protocols.twist_bits import Fr, MemoryTrace

    rng = random.Random(3)
    tr = MemoryTrace(size)
    for i in range(n_ops):
        if i % 3 == 0:
            tr.write(rng.randrange(size), Fr(rng.randrange(1 << 31)))
        else:
            tr.read(rng.randrange(size))
    return tr


def profile_prove(prove) -> dict:
    """One ``prove()`` under ``torch.profiler``: the device time of every
    CUDA kernel and copy it traced, against the prove's wall time."""
    events, wall_s = traced(prove)
    rows = []
    for evt in events:
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us, evt.key, evt.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    check(device_ms > 0, "the profiler saw no device time")
    return {"wall_s": wall_s, "device_ms": device_ms,
            "busy_share": device_ms / 1e3 / wall_s,
            "device_launches": sum(r[2] for r in rows),
            "top": [{"name": k[:60], "ms": us / 1e3, "calls": n}
                    for us, k, n in rows[:8]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-t", type=int, default=16,
                    help="log2 of the end-to-end trace length (default 16)")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more prove with torch.profiler")
    ap.add_argument("--msm-launches", action="store_true",
                    help="only count the launches of one 2^16-point MSM")
    ap.add_argument("--fe-mul-sass", action="store_true",
                    help="only count the chain kernel's SASS instructions")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if opts.fe_mul_sass:
        print(json.dumps({"fe_mul_sass": fe_mul_sass(),
                          "card": card_line()}), flush=True)
        return 0
    if opts.msm_launches:
        print(json.dumps({"msm_launches": msm_launches(1 << 16, 7),
                          "card": card_line()}), flush=True)
        return 0

    import numpy as np

    from tnsh_torch import _build, _native
    from tnsh_torch.commit import kzg, msm_group, msm_sched
    from tnsh_torch.entry import entry
    from tnsh_torch.field import fq_kernels, fr_ops
    from tnsh_torch.field import fr_kernels as K
    from tnsh_torch.field import limbs
    from tnsh_torch.field.fr import MODULUS as P
    from tnsh_torch.field.g1 import G1
    from tnsh_torch.commit.mkzg_sparse import cube_params
    from tnsh_torch.core.proof_io import (
        shout_proof_to_bytes,
        twist_proof_to_bytes,
    )
    from tnsh_torch.protocols.shout import Shout
    from tnsh_torch.protocols.sound import ShoutSound, TwistSound
    from tnsh_torch.protocols.twist import Twist
    from tnsh_torch.protocols.twist_bits import (
        Fr,
        LookupTable,
        ShoutBits,
        ShoutBitsCommitted,
        TwistBits,
        setup_multilinear_params,
        setup_params,
    )
    from tnsh_torch.utils.profiling import (
        PhaseTimer,
        launch_counts,
        reset_launch_counts,
    )

    FQ = limbs.FQ_SPEC
    fq = fr_ops.fq
    log_t, profile = opts.log_t, opts.profile
    dev = torch.device("cuda", 0)
    card = card_line()
    clock_hz = sm_clock_hz()
    t0 = time.perf_counter()
    _build.build_all()           # two nvcc and one g++, side by side
    build_s = time.perf_counter() - t0
    _build.library(), _build.msm_library()
    check(_native.available, "the native host engine must load")
    ptxas = {**ptxas_summary(_build.compiler_log("fr")),
             **{"fq:" + k if k == "fe_chain_kernel" else k: v for k, v in
                ptxas_summary(_build.compiler_log("msm")).items()}}
    phase(0, "setup", card=card, sm_clock_mhz=clock_hz / 1e6,
          torch=torch.__version__, cuda=torch.version.cuda, native=True,
          build_s=build_s, ptxas=ptxas)

    rng = np.random.default_rng(7)
    errors = Errors()
    times = {}    # kernel -> (kernel ms, plain ms) at the main path's shape
    dev_times = {}  # kernel -> its ms there with the card's queue kept full
    work = {}     # kernel -> (bytes moved, Montgomery products) of that call

    def rand_raw(count):
        """``count`` random field values below 2^252 < p, as 32-byte LE
        words."""
        w = rng.integers(0, 1 << 32, (count, 8), dtype=np.uint64).astype(
            "<u4")
        w[:, 7] &= 0x0FFFFFFF
        return w.tobytes()

    def rand_vals(n):
        raw = rand_raw(n)
        return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
                for i in range(n)]

    def rand_words(shape):
        """Random field values as (..., 8, n) Montgomery words, packed on
        the device."""
        count = int(np.prod(shape[:-2], dtype=np.int64)) * shape[-1]
        flat = limbs.pack(rand_raw(count), dev)           # (8, count)
        return flat.view(8, -1, shape[-1]).transpose(0, 1).reshape(
            shape).contiguous()

    # ---- phase 1: field ------------------------------------------------
    n1 = 1 << 16
    xs, ys = rand_vals(n1), rand_vals(n1)
    x, y = limbs.pack(xs, dev), limbs.pack(ys, dev)
    got = K.mont_mul_chain(x, y, 4)
    errors.compare("mont_mul_chain", got,
                   K.mont_mul_chain_plain(x, y, 4), "chain 2^16")
    sample = limbs.unpack(got[:, :64].contiguous())
    check(sample == [a * pow(b, 4, P) % P for a, b in zip(xs[:64], ys[:64])],
          "chain against host Fr")
    nb, iters = 1 << 19, 256
    xb = rand_words((8, nb))
    chain_ms = cuda_ms(lambda: K.mont_mul_chain(xb, xb, iters), 3)

    def blocker():
        """Some 9 ms of products on the stream, for ``queued_ms``."""
        K.mont_mul_chain(xb, xb, 4 * iters)

    # the main path's shape: the Montgomery conversion of phase A's seven
    # host-built j tables (eq1, Vj, rv, eq(sigma_j), ic, wv, eqb) at pack
    xp = rand_words((8, 7 << 16))
    r2 = limbs.raw_planes(limbs.R2_MOD_P, dev)
    times["mont_mul_chain"] = (
        cuda_ms(lambda: K.mont_mul_chain(xp, r2, 1), 10),
        cuda_ms(lambda: K.mont_mul_chain_plain(xp, r2, 1), 2))
    dev_times["mont_mul_chain"] = queued_ms(
        lambda: K.mont_mul_chain(xp, r2, 1), 10, blocker)
    work["mont_mul_chain"] = (2 * xp.numel() * 4 + 32, xp.shape[1])
    errors.compare("mont_mul_chain", K.mont_mul_chain(xp, r2, 1),
                   K.mont_mul_chain_plain(xp, r2, 1), "to_mont 7x2^16")
    # the same kernel compiled for Fq, at the shape the SRS upload gives
    # it: one coordinate plane of 2^16 bases to Montgomery form
    q = FQ.modulus
    xq = limbs.pack(rand_raw(1 << 16), dev, FQ)
    yq = limbs.pack(rand_raw(1 << 16), dev, FQ)
    errors.compare("fq_mont_mul_chain", fq_kernels.mont_mul_chain(xq, yq, 3),
                   fq_kernels.mont_mul_chain_plain(xq, yq, 3),
                   "fq chain 2^16", FQ)
    xv, yv = limbs.unpack(xq[:, :64].contiguous(), FQ), limbs.unpack(
        yq[:, :64].contiguous(), FQ)
    check(limbs.unpack(fq_kernels.mont_mul(xq, yq)[:, :64].contiguous(), FQ)
          == [a * b % q for a, b in zip(xv, yv)], "fq product against host")
    check(torch.equal(fq_kernels.to_mont(xq), fq.to_mont(xq)),
          "fq to_mont limb for limb")
    # timed as the Fr shape is: R^2 on the card before the timed loop
    r2q = limbs.raw_planes(FQ.r2_mod_p, dev)
    check(torch.equal(fq_kernels.mont_mul_chain(xq, r2q, 1),
                      fq_kernels.to_mont(xq)), "fq chain by R^2 is to_mont")
    times["fq_mont_mul_chain"] = (
        cuda_ms(lambda: fq_kernels.mont_mul_chain(xq, r2q, 1), 10),
        cuda_ms(lambda: fq_kernels.mont_mul_chain_plain(xq, r2q, 1), 2))
    dev_times["fq_mont_mul_chain"] = queued_ms(
        lambda: fq_kernels.mont_mul_chain(xq, r2q, 1), 10, blocker)
    work["fq_mont_mul_chain"] = (2 * xq.numel() * 4 + 32, xq.shape[1])
    # to_mont keeps its R^2 planes once a device: a second call makes none
    for mod in (K, fq_kernels):
        mod.to_mont(xq)
        built = K.const_planes.cache_info().misses
        mod.to_mont(xq)
        check(K.const_planes.cache_info().misses == built,
              "to_mont builds its constant once a device")
    phase(1, "field", chain_equal=True, host_sample=64,
          chain_lanes=nb, chain_iters=iters, chain_ms=chain_ms,
          chain_mmuls_per_s=nb * iters / (chain_ms * 1e-3) / 1e6,
          to_mont_ms=times["mont_mul_chain"][0],
          to_mont_plain_ms=times["mont_mul_chain"][1],
          to_mont_queued_ms=dev_times["mont_mul_chain"],
          fq_to_mont_queued_ms=dev_times["fq_mont_mul_chain"],
          fq_equal=True, fq_to_mont_ms=times["fq_mont_mul_chain"][0],
          fq_to_mont_plain_ms=times["fq_mont_mul_chain"][1],
          fe_mul_sass=fe_mul_sass())

    # ---- phase 2: kernels against their plain versions ------------------
    log_k = 10
    term_idxs, n_tables, bit_tables = j_phase_terms(log_k)
    check((n_tables, len(term_idxs)) == (49, 47), "j-phase term structure")
    coeffs = rand_words((8, len(term_idxs)))
    desc = K.terms(term_idxs, dev)
    check(desc.products_unfactored == 159 and desc.products <= 100,
          "the j-phase program: 100 products a pair and point or fewer")
    scale = limbs.scalar(0xC0FFEE, dev)
    rows = []
    for n in (2, 4, 64, 2048, 1 << 16):
        tabs = rand_words((n_tables, 8, n))
        bits = torch.from_numpy(rng.integers(0, 2, (len(bit_tables), n))
                                .astype(np.bool_)).to(dev)
        one, zero = limbs.scalar(1, dev), torch.zeros(
            (8, 1), dtype=torch.int32, device=dev)
        for i, f in enumerate(sorted(bit_tables)):
            tabs[f] = torch.where(bits[i].unsqueeze(0), one, zero)
        r = random.Random(n).randrange(P)
        errors.compare("fold", K.fold(tabs, r), K.fold_plain(tabs, r),
                       f"fold N={n}")
        for npts in (4, 14):
            errors.compare(
                "sum_of_products_round_evals",
                K.sum_of_products_round_evals(tabs, coeffs, desc, npts),
                K.round_evals_plain(tabs, coeffs, desc, npts),
                f"round evals N={n} npts={npts}")
        t3 = tabs[:3].contiguous()
        for s in (None, scale):
            errors.compare("product_round_evals",
                           K.product_round_evals(t3, s),
                           K.product_round_evals_plain(t3, s),
                           f"product evals N={n} scale={s is not None}")
        row = {"n": n}
        if n == 1 << 16:
            reps, preps = 20, 1
            times["fold"] = (
                cuda_ms(lambda: K.fold(tabs, r), reps),
                cuda_ms(lambda: K.fold_plain(tabs, r), preps))
            times["sum_of_products_round_evals"] = (
                cuda_ms(lambda: K.sum_of_products_round_evals(
                    tabs, coeffs, desc, 14), reps),
                cuda_ms(lambda: K.round_evals_plain(
                    tabs, coeffs, desc, 14), preps))
            dev_times["fold"] = queued_ms(lambda: K.fold(tabs, r), reps,
                                          blocker)
            dev_times["sum_of_products_round_evals"] = queued_ms(
                lambda: K.sum_of_products_round_evals(
                    tabs, coeffs, desc, 14), reps, blocker)
            row["sop_npts4_ms"] = cuda_ms(
                lambda: K.sum_of_products_round_evals(
                    tabs, coeffs, desc, 4), reps)
            row["product_ms"] = cuda_ms(
                lambda: K.product_round_evals(t3, scale), reps)
            row["product_plain_ms"] = cuda_ms(
                lambda: K.product_round_evals_plain(t3, scale), preps)
            for k in ("fold", "sum_of_products_round_evals"):
                row[k + "_ms"], row[k + "_plain_ms"] = times[k]
            half = n // 2
            work["fold"] = (tabs.numel() * 4 * 3 // 2, n_tables * half)
            # the bound counts the cheapest evaluation order known for
            # the function: the program's products, not the 159 factors
            work["sum_of_products_round_evals"] = (
                tabs.numel() * 4 + coeffs.numel() * 4 + 14 * 32,
                half * 14 * desc.products)
            # the 16 rounds of a T=2^16 proof: every halving, npts 14
            halvings, single = [], 0
            for lg in range(16, 0, -1):
                th = tabs[:, :, :1 << lg].contiguous()
                one_launch = K.round_evals_blocks(1 << (lg - 1)) == 1
                single += one_launch
                halvings.append({
                    "n": 1 << lg, "launches": 1 if one_launch else 2,
                    "ms": cuda_ms(lambda: K.sum_of_products_round_evals(
                        th, coeffs, desc, 14), reps)})
            # phase B's shape: one term of 13 factors (lt, ot, ic, chi_w)
            desc_b = K.terms([tuple(range(13))], dev)
            tabs_b = tabs[:13].contiguous()
            one_b = K.const_planes(limbs.R_MOD_P, dev)
            errors.compare(
                "sum_of_products_round_evals",
                K.sum_of_products_round_evals(tabs_b, one_b, desc_b, 14),
                K.round_evals_plain(tabs_b, one_b, desc_b, 14),
                "round evals, one term of 13 factors")
            rounds = {
                "halvings": halvings, "one_launch_rounds": single,
                "sum_ms": sum(h["ms"] for h in halvings),
                "phase_b_shape_ms": cuda_ms(
                    lambda: K.sum_of_products_round_evals(
                        tabs_b, one_b, desc_b, 14), reps),
                "phase_b_products": desc_b.products}
        rows.append(row)
    phase(2, "kernels", equal=True, tables=n_tables,
          terms=len(term_idxs), products_unfactored=desc.products_unfactored,
          products_program=desc.products, program_ops=len(desc.program),
          program_stack_slots=desc.depth, sizes=rows, rounds=rounds)

    # ---- phase 3: entry ---------------------------------------------------
    step, args = entry(dev)
    evals, folded = step(*args)
    stacked = torch.stack(args[:3])
    errors.compare("product_round_evals", evals,
                   K.product_round_evals_plain(stacked), "entry evals")
    errors.compare("fold", torch.stack(folded),
                   K.fold_plain(stacked, args[3]), "entry fold")
    times["product_round_evals"] = (
        cuda_ms(lambda: K.product_round_evals(stacked), 20),
        cuda_ms(lambda: K.product_round_evals_plain(stacked), 3))
    dev_times["product_round_evals"] = queued_ms(
        lambda: K.product_round_evals(stacked), 20, blocker)
    work["product_round_evals"] = product_work(stacked)
    phase(3, "entry", equal=True, lanes=args[0].shape[1],
          step_evals_ms=times["product_round_evals"][0],
          step_evals_plain_ms=times["product_round_evals"][1])


    # ---- phase 7: the Jacobian add -----------------------------------------
    def rand_points(n):
        """n random multiples of the generator as affine Montgomery planes,
        through a native fixed-base SRS (no Python point arithmetic)."""
        srs = _native.srs_create_fixed_base(G1.generator(), rand_raw(n))
        try:
            ctx = msm_sched.ScheduledMsmContext.from_native_srs(
                srs, device=dev)
        finally:
            _native.srs_free(srs)
        return ctx.xs[:, :n].contiguous(), ctx.ys[:, :n].contiguous()

    lanes = 4096
    ax, ay = rand_points(lanes)
    bx, by = torch.roll(ax, -1, dims=1), torch.roll(ay, -1, dims=1)
    one = fq.one((lanes,), dev)
    z1, z2 = one.clone(), one.clone()
    bx[:, 3], by[:, 3] = ax[:, 3], ay[:, 3]                 # equal points
    bx[:, 4], by[:, 4] = ax[:, 4], fq.neg(ay[:, 4:5])[:, 0]  # inverse points
    z1[:, 5] = 0
    z2[:, 6] = 0
    z1[:, 7] = 0
    z2[:, 7] = 0
    jx, jy, jz = msm_group.padd(ax, ay, z1, ax, ay, z1)      # Z != 1 lanes
    lane_mask = torch.from_numpy(rng.random(lanes) < 0.6).to(dev)
    for name, pts in (("affine", (ax, ay, z1, bx, by, z2)),
                       ("jacobian", (jx, jy, jz, bx, by, z2)),
                       ("doubling", (jx, jy, jz, jx, jy, jz))):
        for msk in (None, lane_mask):
            got = msm_group.padd(*pts, msk)
            want = msm_group.padd_plain(*pts, msk)
            for g_, w_ in zip(got, want):
                errors.compare("g1_padd", g_, w_, f"padd {name}", FQ)
                check(torch.equal(g_, w_), f"padd {name}: limb for limb")
    times["g1_padd"] = (
        cuda_ms(lambda: msm_group.padd(jx, jy, jz, bx, by, z2), 20),
        cuda_ms(lambda: msm_group.padd_plain(jx, jy, jz, bx, by, z2), 2))
    dev_times["g1_padd"] = queued_ms(
        lambda: msm_group.padd(jx, jy, jz, bx, by, z2), 20, blocker)
    # 6 planes read and 3 written; a general add is 16 products
    work["g1_padd"] = (9 * jx.numel() * 4, 16 * (lanes - 3))
    # the add's own path now that the MSM folds in its tail kernels:
    # tree_reduce_points over 4096 points, counted, against the host's sum
    srs = _native.srs_create_fixed_base(G1.generator(), rand_raw(lanes))
    try:
        tctx = msm_sched.ScheduledMsmContext.from_native_srs(srs, device=dev)
        want_sum = _native.srs_msm(srs, (1).to_bytes(32, "little") * lanes)
    finally:
        _native.srs_free(srs)
    reset_launch_counts()
    total = msm_group.tree_reduce_points(
        tctx.xs[:, :lanes].contiguous(), tctx.ys[:, :lanes].contiguous(),
        fq.one((lanes,), dev))
    padd_path_launches = launch_counts()["g1_padd"]
    check(msm_group.jacobian_to_g1(*total) == want_sum,
          "tree_reduce_points differs from the host's sum")
    check(padd_path_launches == 12, "12 add launches reduce 4096 points")
    phase(7, "group", equal=True, lanes=lanes, padd_ms=times["g1_padd"][0],
          padd_plain_ms=times["g1_padd"][1],
          tree_reduce_launches=padd_path_launches)

    # ---- phase 8: the insertion --------------------------------------------
    def fresh_acc(n):
        return (torch.zeros((8, n), dtype=torch.int32, device=dev),
                fq.one((n,), dev),
                torch.zeros((8, n), dtype=torch.int32, device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev))

    def same_insert(sched, px, py, acc, steps, what):
        got = msm_sched.insert_steps(sched, px, py, *acc, steps)
        want = msm_sched.insert_steps_plain(sched, px, py, *acc, steps)
        for g_, w_ in zip(got[:3], want[:3]):
            errors.compare("msm_insert_steps", g_, w_, what, FQ)
            check(torch.equal(g_, w_), f"{what}: limb for limb")
        check(int(got[3]) == int(want[3]), f"{what}: hazard counts differ")
        return got

    # small: 256 lanes, 64 points, negative digits, idle lanes, infinity
    # accumulators, P + (-P), and a forced hazard (one point twice in a
    # row on an empty lane)
    small = np.zeros((6, 256), dtype=np.int32)
    for st in range(6):
        small[st] = np.where(rng.random(256) < 0.3, 0,
                             rng.integers(1, 65, 256)
                             * rng.choice([-1, 1], 256))
    small[0, 0], small[1, 0] = 9, 9
    small[0, 1], small[1, 1] = 9, -9
    small = torch.from_numpy(small).to(dev)
    wide_x = torch.zeros((8, 192), dtype=torch.int32, device=dev)
    wide_y = torch.zeros_like(wide_x)
    wide_x[:, 64:128], wide_y[:, 64:128] = ax[:, :64], ay[:, :64]
    px, py = wide_x[:, 64:128], wide_y[:, 64:128]        # a column slice
    acc = same_insert(small, px, py, fresh_acc(256), 4, "insert small a")
    acc = same_insert(small[4:].contiguous(), px, py, acc, 2,
                      "insert small b")
    forced = int(acc[3])
    check(forced >= 1, "the forced hazard was not counted")

    # the main path's shape: one 32768-point chunk of full-width scalars,
    # planned at the width derived from the card
    width = msm_sched.resident_lanes(0)
    check(width >= 4096 and width & (width - 1) == 0,
          "the derived width is a power of two of 4096 lanes or more")
    m_big = 32768
    bxs, bys = rand_points(m_big)

    def planned(digits, n_lanes):
        """(plan, its tensors on the card, steps, schedule) of one chunk."""
        plan = msm_sched.MsmPlan(digits, m_big, n_lanes)
        steps = int(plan.rc_per_chunk[0])
        sched = msm_sched.build_schedule(
            torch.from_numpy(digits).to(dev),
            torch.from_numpy(plan.base_map).to(dev),
            torch.from_numpy(plan.logk_map).to(dev), steps, n_lanes)
        tail_args = tuple(torch.from_numpy(t).to(dev) for t in (
            plan.lane_logk, plan.canon_src, plan.canon_mask))
        return plan, tail_args, steps, sched

    def insert_work(sched, n_lanes):
        """(bytes, products) of one insertion: the first entry of a lane
        meets an empty accumulator and is a copy; every other entry is a
        mixed add of 11 products."""
        nz = sched != 0
        adds = int(nz.sum()) - int(nz.any(dim=0).sum())
        return (sched.numel() * 4 + 2 * bxs.numel() * 4 + 6 * 8 * n_lanes * 4,
                11 * adds)

    digits = msm_sched.signed_digits(np.frombuffer(
        rand_raw(m_big), dtype=np.uint8).reshape(-1, 32))
    plan, main_tail_args, steps, sched = planned(digits, width)
    nz = sched != 0
    entries = int(nz.sum())
    check(digits.shape[0] >= 8 and steps * width >= entries
          and steps <= 3 * -(-entries // width),
          "the insertion's main-path shape: 8 windows or more, and within "
          "3x of the fewest steps that hold every entry")
    check(entries == int(np.count_nonzero(digits)),
          "the schedule holds every nonzero digit once")
    check(bool((sched < 0).any()) and bool((~nz).any()),
          "negative digits and idle lanes in the schedule")
    big = same_insert(sched, bxs, bys, fresh_acc(width), steps, "insert main")
    check(int(big[3]) == 0, "hazard among random bases")
    acc_w = fresh_acc(width)
    times["msm_insert_steps"] = (
        cuda_ms(lambda: msm_sched.insert_steps(sched, bxs, bys, *acc_w), 5),
        cuda_ms(lambda: msm_sched.insert_steps_plain(
            sched, bxs, bys, *acc_w, steps), 1))
    dev_times["msm_insert_steps"] = queued_ms(
        lambda: msm_sched.insert_steps(sched, bxs, bys, *acc_w), 5, blocker)
    work["msm_insert_steps"] = insert_work(sched, width)
    # the same digits planned at other widths, the old design's among them
    curve = []
    for n_lanes in sorted({4096, 16384, 32768, 65536, width}):
        _, _, c_steps, c_sched = planned(digits, n_lanes)
        c_acc = fresh_acc(n_lanes)
        c_work = insert_work(c_sched, n_lanes)
        curve.append({
            "lanes": n_lanes, "steps": c_steps,
            "entries": int((c_sched != 0).sum()), "products": c_work[1],
            "bound_ms": bound(*c_work, clock_hz)[0],
            "ms": cuda_ms(lambda: msm_sched.insert_steps(
                c_sched, bxs, bys, *c_acc), 10)})
        del c_sched, c_acc
    at = {row["lanes"]: row["ms"] for row in curve}
    phase(8, "insert", equal=True, forced_hazards=forced, m=m_big,
          lanes=width, windows=int(digits.shape[0]), steps=steps,
          entries=entries, insert_ms=times["msm_insert_steps"][0],
          insert_plain_ms=times["msm_insert_steps"][1], widths=curve,
          faster_than_4096_lanes=at[width] < at[4096])

    # ---- phase 10: the tail ---------------------------------------------------
    def same_tail(acc, tail_args, levels, what):
        args = (*acc[:3], *tail_args, acc[3])
        got = msm_sched.msm_tail(*args, levels)
        want = msm_sched.msm_tail_plain(*args, levels)
        errors.compare("msm_tail", got[:, :-1].contiguous(),
                       want[:, :-1].contiguous(), what, FQ)
        check(torch.equal(got, want), f"{what}: limb for limb, hazards too")
        return args

    def tail_work(acc, plan):
        """(bytes, products) of one tail: a general add of 16 products for
        every occupied lane folded away, and 2 x 127 adds a window."""
        occupied = int((~fq.is_zero(acc[2])).sum())
        groups = int(plan.canon_mask.sum())
        w = plan.w_count
        return (3 * 8 * plan.lanes * 4 + plan.lanes + w * 128 * 5
                + 8 * (3 * w + 1) * 4,
                16 * (max(occupied - groups, 0) + 2 * 127 * w))

    def tail_row(args, plan):
        """msm_tail against the level-wise path on the add kernel, in turns:
        device ms by CUDA events and host ms a call."""
        levels = plan.fold_levels
        run = lambda: msm_sched.msm_tail(*args, levels)
        old = lambda: msm_sched.msm_tail_levelwise(*args, levels)
        check(torch.equal(run(), old()), "tail: kernels against level-wise")
        row = {"windows": plan.w_count, "lanes": plan.lanes,
               "fold_levels": levels, "depth": levels + 14,
               "tail_ms": [], "levelwise_ms": []}
        for _ in range(2):
            row["tail_ms"].append(cuda_ms(run, 10))
            row["levelwise_ms"].append(cuda_ms(old, 3))
        row["tail_host_ms"] = wall_ms(run, 10)
        row["levelwise_host_ms"] = wall_ms(old, 3)
        row["tail_launches"] = device_launches(run)["total"]
        row["levelwise_launches"] = device_launches(old)["total"]
        row["faster"] = max(row["tail_ms"]) < min(row["levelwise_ms"])
        return row

    main_args = same_tail(big, main_tail_args, plan.fold_levels, "tail main")
    work["msm_tail"] = tail_work(big, plan)
    tail_rows = {"full_w32": tail_row(main_args, plan)}
    times["msm_tail"] = (
        min(tail_rows["full_w32"]["tail_ms"]),
        cuda_ms(lambda: msm_sched.msm_tail_plain(
            *main_args, plan.fold_levels), 1))
    dev_times["msm_tail"] = queued_ms(
        lambda: msm_sched.msm_tail(*main_args, plan.fold_levels), 10, blocker)
    # a bit column: W = 4, the group of digit 1 holds half the lanes
    bit_digits = msm_sched.signed_digits(np.frombuffer(
        b"".join(bytes([b]) + bytes(31)
                 for b in rng.integers(0, 2, m_big).tolist()),
        dtype=np.uint8).reshape(-1, 32))
    bplan, btail_args, bsteps, bsched = planned(bit_digits, width)
    check(bplan.w_count == 4 and bplan.fold_levels > 8,
          "the bit column: 4 windows and a group wider than a tile")
    bacc = same_insert(bsched, bxs, bys, fresh_acc(width), bsteps,
                       "insert bit column")
    bit_args = same_tail(bacc, btail_args, bplan.fold_levels,
                         "tail bit column")
    tail_rows["bits_w4"] = tail_row(bit_args, bplan)
    # a small plan: window 0 one group of 256 points that are equal in
    # pairs (the fold doubles) with one pair of opposite sign (the fold
    # meets inverse points), window 1 one point (a one-lane group), window
    # 2 empty, window 3 random digits; idle lanes are infinities
    m_small = 512
    sd = np.zeros((4, m_small), dtype=np.int8)
    sd[0, :256] = 5
    sd[0, 1] = -5
    sd[1, 300] = 7
    sd[3] = rng.integers(-128, 128, m_small)
    sx, sy = bxs[:, :m_small].clone(), bys[:, :m_small].clone()
    sx[:, 1:256:2], sy[:, 1:256:2] = sx[:, 0:256:2], sy[:, 0:256:2]
    splan = msm_sched.MsmPlan(sd, m_small, 4096)
    check(splan.fold_levels == 8 and splan.logk_map[1, 7] == 0
          and not splan.canon_mask[2 * 128:3 * 128].any(),
          "the small plan: a 256-lane group, a one-lane group, an empty window")
    ssched = msm_sched.build_schedule(
        torch.from_numpy(sd).to(dev), torch.from_numpy(splan.base_map).to(dev),
        torch.from_numpy(splan.logk_map).to(dev),
        int(splan.rc_per_chunk[0]), 4096)
    sacc = same_insert(ssched, sx, sy, fresh_acc(4096),
                       int(splan.rc_per_chunk[0]), "insert small plan")
    small_args = same_tail(sacc, tuple(
        torch.from_numpy(t).to(dev) for t in (
            splan.lane_logk, splan.canon_src, splan.canon_mask)),
        splan.fold_levels, "tail small plan")
    packed = msm_sched.msm_tail(*small_args)       # default: every level
    check(torch.equal(packed, msm_sched.msm_tail(*small_args, 8)),
          "tail small plan: default levels")
    check(not bool(fq.is_zero(packed[:, 8:9]).all())
          and bool(fq.is_zero(packed[:, 10:11]).all()),
          "tail small plan: window 0 has a sum, the empty window infinity")
    add_ms = times["g1_padd"][0]
    for row in tail_rows.values():
        row["depth_x_add_ms"] = row["depth"] * add_ms
    phase(10, "tail", equal=True, add_latency_ms=add_ms, **tail_rows,
          plain_ms=times["msm_tail"][1],
          faster_than_levelwise=all(r["faster"] for r in tail_rows.values()))
    del big, bacc, sched, bsched, acc_w

    # ---- phase 9: whole MSMs against the native host MSM -------------------
    n_msm = 1 << 16
    srs = _native.srs_create_fixed_base(G1.generator(), rand_raw(n_msm))
    try:
        ctx = msm_sched.ScheduledMsmContext.from_native_srs(srs, device=dev)
        msm_rows = {}
        for name, scal in (
                ("full_w32", rand_raw(n_msm)),
                ("bits_w4", b"".join(
                    bytes([b]) + bytes(31)
                    for b in rng.integers(0, 2, n_msm).tolist()))):
            t0 = time.perf_counter()
            want = _native.srs_msm(srs, scal)
            host_s = time.perf_counter() - t0
            got = ctx.msm(scal)                      # warm: first launch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got2 = ctx.msm(scal)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            check(got == want and got2 == want,
                  f"msm {name}: the card's result differs from the host's")
            msm_rows[name] = {
                "card_s": card_s, "host_native_s": host_s,
                "launches": device_launches(lambda: ctx.msm(scal))}
        check(ctx.hazard_count == 0, "hazard in a random-base MSM")
        check(ctx.lanes == width, "the context plans at the derived width")
    finally:
        _native.srs_free(srs)
    # equal bases, equal scalars: one bucket of 2^14 points.  Planned at
    # 4096 lanes each lane's second insertion meets the lane's own point
    # and doubles; at the derived width every point has a lane of its own
    # (where the width allows) and the equal points meet in the tail's fold
    n_eq = 1 << 14
    srs = _native.srs_create_fixed_base(
        G1.generator(), (7).to_bytes(32, "little") * n_eq)
    try:
        ones = (1).to_bytes(32, "little") * n_eq
        want = _native.srs_msm(srs, ones)
        eq_hazards = {}
        for n_lanes in (4096, None):
            ctx = msm_sched.ScheduledMsmContext.from_native_srs(
                srs, device=dev, lanes=n_lanes)
            check(ctx.msm(ones) == want, f"msm over equal bases at "
                  f"{ctx.lanes} lanes: the card's result differs from the "
                  "host's")
            eq_hazards[ctx.lanes] = ctx.hazard_count
        check(eq_hazards[4096] == 4096,
              "one hazard a lane over equal bases on 4096 lanes")
        check(eq_hazards[width] == (0 if width >= n_eq else width),
              "equal bases at the derived width: the doubling is the fold's")
    finally:
        _native.srs_free(srs)
    phase(9, "msm", points=n_msm, equal=True, hazards=0, lanes=width,
          equal_bases_points=n_eq, equal_bases_hazards=eq_hazards,
          **msm_rows, stage_seconds=msm_sched.stage_seconds())

    # ---- phase 4: end to end ---------------------------------------------
    pp, vp = setup_params(12)
    tr = bench_trace(log_k, log_t)
    t0 = time.perf_counter()
    setup_multilinear_params(log_t)   # the PST SRS, cached per process
    srs_s = time.perf_counter() - t0

    # the main path: the entry step and a TwistBits prove, counted; the
    # peak is the device memory the prove takes above what was live before
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    live = torch.cuda.memory_allocated(dev)
    kzg.reset_route_counts()
    reset_launch_counts()
    step(*args)
    timer = PhaseTimer()
    t0 = time.perf_counter()
    proof = TwistBits.prove(tr, pp, dev, timer)
    torch.cuda.synchronize()
    port_s = time.perf_counter() - t0
    launches = launch_counts()
    routes = kzg.route_counts()
    hazards = sum(c.hazard_count for c in kzg.device_contexts())
    peak_gb = (torch.cuda.max_memory_allocated(dev) - live) / 1e9

    t0 = time.perf_counter()
    again = TwistBits.prove(tr, pp, dev)
    torch.cuda.synchronize()
    port2_s = time.perf_counter() - t0

    got_b = TwistBits.to_bytes(proof)
    check(TwistBits.to_bytes(again) == got_b, "two proves of one trace differ")
    check(TwistBits.verify(proof, vp), "the verifier rejects the proof")
    forged = dataclasses.replace(proof, v_val=Fr(int(proof.v_val) + 1))
    check(not TwistBits.verify(forged, vp), "a forged v_val verifies")
    per = timer.launches
    for name in ("phase_a", "phase_b"):
        check(per[name]["sum_of_products_round_evals"] == log_t,
              f"{name}: {log_t} round-evaluation launches")
        check(per[name]["fold"] == log_t, f"{name}: {log_t} fold launches")
    check(launches["sum_of_products_round_evals"] == 2 * log_t,
          "2 log T round-evaluation launches in the prove")
    for name in ("commit", "open"):
        check(per[name]["msm_insert_steps"] > 0 and per[name]["msm_tail"] > 0,
              f"{name}: its MSMs ran through the insertion and tail kernels")
    check(launches["g1_padd"] == 0,
          "the MSMs of a prove launch no level-wise add")
    check(launches["msm_tail"] == routes["device"],
          "one tail a device MSM")
    check(per["srs"]["fq_mont_mul_chain"] > 0,
          "the SRS went to Montgomery form through the Fq kernel")
    check(hazards == 0, f"{hazards} hazards among SRS bases: a bug")
    check(routes["device"] >= 2 * log_k + 4 + 2,
          "every commitment and each opening's large MSMs ran on the card")
    check(all(v > 0 for k, v in launches.items() if k != "g1_padd"),
          "every kernel of the prove's path launched in it")
    phase(4, "e2e", K=1 << log_k, T=1 << log_t, verified=True,
          forged_rejected=True, proof_bytes=len(got_b), srs_s=srs_s,
          port_prove_s=port_s, port_prove_again_s=port2_s,
          peak_device_gb=peak_gb, hazards=hazards, msm_routes=routes,
          j_rounds=timer.phases["j_rounds"], phase_b=timer.phases["phase_b"],
          stages_s=timer.phases, stage_launches=per, launches=launches)

    # ---- phase 5: the proof against references on small inputs ----------
    # the frozen wire-v3 digest of tests/test_twist_bits.py (K=8, T=64),
    # and the card against the port's plain versions on the host at
    # K=2^10, T=2^11 (the main path's 49 tables, 47 terms, degree 13)
    small = TwistBits.to_bytes(
        TwistBits.prove(frozen_trace(), setup_params(8)[0], dev))
    check((len(small), hashlib.sha256(small).hexdigest()) == FROZEN,
          "the K=8 T=64 proof differs from the frozen digest")
    tr12 = bench_trace(log_k, 11)
    proof12 = TwistBits.prove(tr12, pp, dev)
    # the host side's MSMs on the native host MSM: the plain MSM, held
    # against the kernels in phases 8 to 10, takes seconds an MSM there
    device_min, kzg.DEVICE_MSM_MIN = kzg.DEVICE_MSM_MIN, 1 << 62
    try:
        host12 = TwistBits.to_bytes(TwistBits.prove(tr12, pp, "cpu"))
    finally:
        kzg.DEVICE_MSM_MIN = device_min
    check(TwistBits.to_bytes(proof12) == host12,
          "K=2^10 T=2^11: the proof on the card differs from the host's")
    check(TwistBits.verify(proof12, vp), "K=2^10 T=2^11 proof verifies")
    phase(5, "reference", frozen_digest=True, card_equals_host_t11=True)

    # ---- phase 11: the lookup provers ----------------------------------------
    # the ShoutBits j phase's round evaluations at the main path's shape
    s_idxs, s_tables, s_bits = shout_j_terms(log_k)
    s_desc = K.terms(s_idxs, dev)
    check((s_tables, len(s_idxs), s_desc.products,
           s_desc.products_unfactored) == (23, 22, 33, 63),
          "the ShoutBits j-phase program: 23 tables, 22 terms, 33 products")
    s_npts = log_k + 3
    s_coeffs = rand_words((8, len(s_idxs)))
    one, zero = limbs.scalar(1, dev), torch.zeros(
        (8, 1), dtype=torch.int32, device=dev)
    for n in (2, 64, 2048, 1 << 16):
        s_tabs = rand_words((s_tables, 8, n))
        sbits = torch.from_numpy(rng.integers(0, 2, (len(s_bits), n))
                                 .astype(np.bool_)).to(dev)
        for i, f in enumerate(sorted(s_bits)):
            s_tabs[f] = torch.where(sbits[i].unsqueeze(0), one, zero)
        errors.compare(
            "sum_of_products_round_evals",
            K.sum_of_products_round_evals(s_tabs, s_coeffs, s_desc, s_npts),
            K.round_evals_plain(s_tabs, s_coeffs, s_desc, s_npts),
            f"ShoutBits round evals N={n}")
    s_run = lambda: K.sum_of_products_round_evals(  # noqa: E731
        s_tabs, s_coeffs, s_desc, s_npts)
    s_bound = bound(s_tabs.numel() * 4 + s_coeffs.numel() * 4 + s_npts * 32,
                    (s_tabs.shape[2] // 2) * s_npts * s_desc.products,
                    clock_hz)
    shout_shape = {
        "tables": s_tables, "terms": len(s_idxs), "n": s_tabs.shape[2],
        "npts": s_npts, "products_program": s_desc.products,
        "products_unfactored": s_desc.products_unfactored,
        "program_ops": len(s_desc.program),
        "program_stack_slots": s_desc.depth,
        "ms": cuda_ms(s_run, 20), "queued_ms": queued_ms(s_run, 20, blocker),
        "plain_ms": cuda_ms(lambda: K.round_evals_plain(
            s_tabs, s_coeffs, s_desc, s_npts), 1),
        "bound_ms": s_bound[0], "bound_by": s_bound[1]}
    check(min(shout_shape["ms"], shout_shape["queued_ms"]) >= s_bound[0],
          "ShoutBits round evals: faster than their bound")
    del s_tabs, sbits

    def counted(fn):
        """``fn(timer)`` with every launch and route count set to 0 just
        before it: (its result, seconds, timer, launches, routes, the
        device memory it took above what was live, in GB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        kzg.reset_route_counts()
        reset_launch_counts()
        timer = PhaseTimer()
        t0 = time.perf_counter()
        out = fn(timer)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (out, secs, timer, launch_counts(), kzg.route_counts(),
                (torch.cuda.max_memory_allocated(dev) - before) / 1e9)

    def lookup_path(name, launches, timer, routes, want_routes, srs_upload):
        """The checks every lookup prove passes, and its result fields."""
        per = timer.launches
        check(per["phase_a"]["sum_of_products_round_evals"] == log_t
              and launches["sum_of_products_round_evals"] == log_t,
              f"{name}: {log_t} round-evaluation launches, all in phase A")
        check(per["phase_a"]["fold"] == log_t, f"{name}: {log_t} folds")
        for st in ("commit", "open"):
            check(per[st]["msm_insert_steps"] > 0 and per[st]["msm_tail"] > 0,
                  f"{name} {st}: its MSMs ran through the insertion and "
                  "tail kernels")
        check(routes == want_routes, f"{name}: MSMs by route {routes}, "
              f"expected {want_routes}")
        check(launches["msm_tail"] == routes["device"],
              f"{name}: one tail a device MSM")
        path = ["mont_mul_chain", "fold", "sum_of_products_round_evals",
                "msm_insert_steps", "msm_tail"]
        path += ["fq_mont_mul_chain"] if srs_upload else []
        check(all(launches[k] > 0 for k in path),
              f"{name}: every kernel of its path launched in it")
        check(launches["g1_padd"] == 0 and launches["product_round_evals"]
              == 0 and (srs_upload or launches["fq_mont_mul_chain"] == 0),
              f"{name}: no kernel off its path launched")
        return {"stages_s": timer.phases, "stage_launches": per,
                "launches": launches, "msm_routes": routes}

    s_tbl = bench_lookups(log_k, log_t)
    s_entries = s_tbl.entries
    setup_multilinear_params(log_k)     # the table's PST SRS, host side
    # ShoutBits: its SRS went up in phase 4 (the same T), so no Fq chain
    # 11 column commitments and the large quotient MSMs of one opening
    want_sb = {"device": log_k + 1 + log_t - 10, "host": 10}
    sproof, sb_s, timer, sb_launches, routes, sb_peak = counted(
        lambda tm: ShoutBits.prove(s_tbl, pp, dev, tm))
    sb = lookup_path("ShoutBits", sb_launches, timer, routes, want_sb, False)
    t0 = time.perf_counter()
    again = ShoutBits.prove(s_tbl, pp, dev)
    torch.cuda.synchronize()
    sb_again_s = time.perf_counter() - t0
    sb_bytes = ShoutBits.to_bytes(sproof)
    check(ShoutBits.to_bytes(again) == sb_bytes,
          "two ShoutBits proves of one lookup log differ")
    check(ShoutBits.verify(sproof, s_entries, vp),
          "the verifier rejects the ShoutBits proof")
    forged = dataclasses.replace(sproof, values_rj=list(sproof.values_rj))
    forged.values_rj[log_k] = Fr(int(forged.values_rj[log_k]) + 1)
    check(not ShoutBits.verify(forged, s_entries, vp),
          "a ShoutBits proof with a forged rv value verifies")
    check(not ShoutBits.verify(sproof, [Fr(int(e) + 1) for e in s_entries],
                               vp), "a ShoutBits proof verifies against "
          "another table")

    # ShoutBitsCommitted: the table's SRS goes up in this prove; the table
    # commitment adds one MSM of K points (card) and its opening ten host
    # ones
    want_sc = {"device": want_sb["device"] + 1, "host": 20}
    cproof, sc_s, timer, sc_launches, routes, sc_peak = counted(
        lambda tm: ShoutBitsCommitted.prove(s_tbl, pp, dev, tm))
    sc = lookup_path("ShoutBitsCommitted", sc_launches, timer, routes,
                     want_sc, True)
    t0 = time.perf_counter()
    again = ShoutBitsCommitted.prove(s_tbl, pp, dev)
    torch.cuda.synchronize()
    sc_again_s = time.perf_counter() - t0
    sc_bytes = ShoutBitsCommitted.to_bytes(cproof)
    check(ShoutBitsCommitted.to_bytes(again) == sc_bytes,
          "two ShoutBitsCommitted proves of one lookup log differ")
    t_comm, pre_s, _, pre_launches, pre_routes, _ = counted(
        lambda tm: ShoutBitsCommitted.preprocess(s_entries, dev))
    check(pre_routes == {"device": 1, "host": 0}
          and pre_launches["msm_tail"] == 1,
          "the table's commitment ran on the card")
    check(ShoutBitsCommitted.verify(cproof, t_comm, vp),
          "the verifier rejects the ShoutBitsCommitted proof")
    forged = dataclasses.replace(cproof, t_value=Fr(int(cproof.t_value) + 1))
    check(not ShoutBitsCommitted.verify(forged, t_comm, vp),
          "a ShoutBitsCommitted proof with a forged t_value verifies")
    hazards = sum(c.hazard_count for c in kzg.device_contexts())
    check(hazards == 0, f"{hazards} hazards among SRS bases: a bug")

    # references: the frozen digest on the card, and at K=2^10 T=2^11 the
    # card against the port's plain versions on the host, whose MSMs go to
    # the native host MSM (the plain MSM takes seconds an MSM there)
    small = ShoutBits.to_bytes(
        ShoutBits.prove(frozen_lookups(), setup_params(8)[0], dev))
    check((len(small), hashlib.sha256(small).hexdigest()) == FROZEN_SHOUT,
          "the K=8 T=64 ShoutBits proof differs from the frozen digest")
    tbl11 = bench_lookups(log_k, 11)
    card11 = [ShoutBits.to_bytes(ShoutBits.prove(tbl11, pp, dev)),
              ShoutBitsCommitted.to_bytes(
                  ShoutBitsCommitted.prove(tbl11, pp, dev))]
    device_min, kzg.DEVICE_MSM_MIN = kzg.DEVICE_MSM_MIN, 1 << 62
    try:
        host11 = [ShoutBits.to_bytes(ShoutBits.prove(tbl11, pp, "cpu")),
                  ShoutBitsCommitted.to_bytes(
                      ShoutBitsCommitted.prove(tbl11, pp, "cpu"))]
    finally:
        kzg.DEVICE_MSM_MIN = device_min
    check(card11 == host11, "K=2^10 T=2^11: a lookup proof on the card "
          "differs from the host's")
    phase(11, "shout", K=1 << log_k, T=1 << log_t, verified=True,
          forged_rejected=True, wrong_table_rejected=True,
          frozen_digest=True, card_equals_host_t11=True, hazards=hazards,
          round_evals=shout_shape,
          shout_bits={"proof_bytes": len(sb_bytes), "prove_s": sb_s,
                      "prove_again_s": sb_again_s, "peak_device_gb": sb_peak,
                      **sb},
          shout_bits_committed={
              "proof_bytes": len(sc_bytes), "prove_s": sc_s,
              "prove_again_s": sc_again_s, "peak_device_gb": sc_peak,
              "preprocess_s": pre_s, **sc})

    # ---- phase 12: ShoutSound ----------------------------------------------
    # its j phase's round evaluations: 5 tables, 6 terms, npts 4, ra_f twice
    # in one term
    v_idxs, v_tables = sound_j_terms()
    v_desc = K.terms(v_idxs, dev)
    check((v_tables, len(v_idxs), v_desc.products,
           v_desc.products_unfactored, v_desc.depth) == (5, 6, 8, 12, 2),
          "the ShoutSound j-phase program: 5 tables, 6 terms, 8 products")
    v_npts = 4
    v_coeffs = rand_words((8, len(v_idxs)))
    for n in (2, 64, 2048, 1 << 16):
        v_tabs = rand_words((v_tables, 8, n))
        errors.compare(
            "sum_of_products_round_evals",
            K.sum_of_products_round_evals(v_tabs, v_coeffs, v_desc, v_npts),
            K.round_evals_plain(v_tabs, v_coeffs, v_desc, v_npts),
            f"ShoutSound round evals N={n}")
    v_run = lambda: K.sum_of_products_round_evals(  # noqa: E731
        v_tabs, v_coeffs, v_desc, v_npts)
    v_bound = bound(v_tabs.numel() * 4 + v_coeffs.numel() * 4 + v_npts * 32,
                    (v_tabs.shape[2] // 2) * v_npts * v_desc.products,
                    clock_hz)
    sound_shape = {
        "tables": v_tables, "terms": len(v_idxs), "n": v_tabs.shape[2],
        "npts": v_npts, "products_program": v_desc.products,
        "products_unfactored": v_desc.products_unfactored,
        "program_ops": len(v_desc.program),
        "program_stack_slots": v_desc.depth,
        "ms": cuda_ms(v_run, 20), "queued_ms": queued_ms(v_run, 20, blocker),
        "plain_ms": cuda_ms(lambda: K.round_evals_plain(
            v_tabs, v_coeffs, v_desc, v_npts), 1),
        "bound_ms": v_bound[0], "bound_by": v_bound[1]}
    check(min(sound_shape["ms"], sound_shape["queued_ms"]) >= v_bound[0],
          "ShoutSound round evals: faster than their bound")
    del v_tabs

    # the prove at the main shape; the factorized cube SRS is built on the
    # host first (set-up, as phase 4's PST SRS), and goes to the card in
    # the prove's srs stage
    v_tbl = sound_lookups(log_k, log_t)
    v_entries = v_tbl.entries
    t0 = time.perf_counter()
    cube_params(log_k, log_t)
    cube_srs_s = time.perf_counter() - t0
    # 2 commitments and the levels of 2^10 points or more of both openings
    # on the card; the smaller levels (j and k of ra, j of rv) on the host
    want_ss = {"device": 2 + 2 * (log_t - 10), "host": 20 + log_k}
    vproof, ss_s, timer, ss_launches, routes, ss_peak = counted(
        lambda tm: ShoutSound.prove(v_tbl, pp, dev, tm))
    per = timer.launches
    check(per["j_rounds"]["sum_of_products_round_evals"] == log_t
          and ss_launches["sum_of_products_round_evals"] == log_t,
          f"ShoutSound: {log_t} round-evaluation launches, all j rounds")
    check(per["j_rounds"]["fold"] == log_t
          and ss_launches["fold"] == log_t, f"ShoutSound: {log_t} folds")
    for st in ("commit", "open"):
        check(per[st]["msm_insert_steps"] > 0 and per[st]["msm_tail"] > 0,
              f"ShoutSound {st}: its MSMs ran through the insertion and "
              "tail kernels")
    check(routes == want_ss, f"ShoutSound: MSMs by route {routes}, "
          f"expected {want_ss}")
    check(ss_launches["msm_tail"] == routes["device"],
          "ShoutSound: one tail a device MSM")
    check(per["srs"]["fq_mont_mul_chain"] > 0,
          "ShoutSound: the cube's SRS went up through the Fq kernel")
    check(all(ss_launches[k] > 0 for k in (
        "mont_mul_chain", "fold", "sum_of_products_round_evals",
        "msm_insert_steps", "msm_tail", "fq_mont_mul_chain")),
        "ShoutSound: every kernel of its path launched in it")
    check(ss_launches["g1_padd"] == 0
          and ss_launches["product_round_evals"] == 0,
          "ShoutSound: no kernel off its path launched")
    t0 = time.perf_counter()
    again = ShoutSound.prove(v_tbl, pp, dev)
    torch.cuda.synchronize()
    ss_again_s = time.perf_counter() - t0
    ss_bytes = ShoutSound.to_bytes(vproof)
    check(ShoutSound.to_bytes(again) == ss_bytes,
          "two ShoutSound proves of one lookup log differ")
    check(ShoutSound.verify(vproof, v_entries, vp),
          "the verifier rejects the ShoutSound proof")
    forged = dataclasses.replace(vproof, rv_at_r=dataclasses.replace(
        vproof.rv_at_r, value=Fr(int(vproof.rv_at_r.value) + 1)))
    check(not ShoutSound.verify(forged, v_entries, vp),
          "a ShoutSound proof with a forged rv value verifies")
    forged = dataclasses.replace(vproof, check=dataclasses.replace(
        vproof.check, final_evaluation=Fr(
            int(vproof.check.final_evaluation) + 1)))
    check(not ShoutSound.verify(forged, v_entries, vp),
          "a ShoutSound proof with a forged final evaluation verifies")
    check(not ShoutSound.verify(vproof, [Fr(int(e) + 1) for e in v_entries],
                                vp),
          "a ShoutSound proof verifies against another table")
    hazards = sum(c.hazard_count for c in kzg.device_contexts())
    check(hazards == 0, f"{hazards} hazards among SRS bases: a bug")

    # references: the frozen dense-path digests on the card, dense against
    # sparse on the card, and at K=2^10 T=2^11 the card against the port's
    # plain versions on the host (the MSMs of that side on the native host
    # MSM)
    for size, want in FROZEN_SOUND.items():
        small = ShoutSound.to_bytes(ShoutSound.prove(
            golden_lookups(size), setup_params(size.bit_length() - 1)[0],
            dev))
        check((len(small), hashlib.sha256(small).hexdigest()) == want,
              f"the size-{size} ShoutSound proof differs from its frozen "
              "digest")
    random.seed(13)
    mix = LookupTable([Fr(i * i) for i in range(8)])
    for _ in range(16):
        mix.lookup(random.randrange(8))
    pp4 = setup_params(4)[0]
    check(ShoutSound.to_bytes(ShoutSound.prove(mix, pp4, dev, sparse=False))
          == ShoutSound.to_bytes(ShoutSound.prove(mix, pp4, dev,
                                                  sparse=True)),
          "ShoutSound: dense and sparse bytes differ on the card")
    tbl11 = sound_lookups(log_k, 11)
    card11 = ShoutSound.to_bytes(ShoutSound.prove(tbl11, pp, dev))
    device_min, kzg.DEVICE_MSM_MIN = kzg.DEVICE_MSM_MIN, 1 << 62
    try:
        host11 = ShoutSound.to_bytes(ShoutSound.prove(tbl11, pp, "cpu"))
    finally:
        kzg.DEVICE_MSM_MIN = device_min
    check(card11 == host11, "K=2^10 T=2^11: the ShoutSound proof on the "
          "card differs from the host's")
    phase(12, "sound", K=1 << log_k, T=1 << log_t, verified=True,
          forged_rejected=True, wrong_table_rejected=True,
          frozen_digests=sorted(FROZEN_SOUND), dense_equals_sparse=True,
          card_equals_host_t11=True, hazards=hazards,
          round_evals=sound_shape, cube_srs_host_s=cube_srs_s,
          proof_bytes=len(ss_bytes), prove_s=ss_s, prove_again_s=ss_again_s,
          peak_device_gb=ss_peak, stages_s=timer.phases, stage_launches=per,
          launches=ss_launches, msm_routes=routes)

    # ---- phase 13: TwistSound ----------------------------------------------
    # its j phase's round evaluations: 16 tables, 18 terms, npts 4; ra_f and
    # wa_f twice in their booleanity terms, ot twice in its own
    w_idxs, w_tables = twist_sound_j_terms()
    w_desc = K.terms(w_idxs, dev)
    check((w_tables, len(w_idxs), w_desc.products,
           w_desc.products_unfactored, w_desc.depth) == (16, 18, 29, 41, 2),
          "the TwistSound j-phase program: 16 tables, 18 terms, 29 products")
    w_npts = 4
    w_coeffs = rand_words((8, len(w_idxs)))
    for n in (2, 64, 2048, 1 << 16):
        w_tabs = rand_words((w_tables, 8, n))
        errors.compare(
            "sum_of_products_round_evals",
            K.sum_of_products_round_evals(w_tabs, w_coeffs, w_desc, w_npts),
            K.round_evals_plain(w_tabs, w_coeffs, w_desc, w_npts),
            f"TwistSound round evals N={n}")
    w_run = lambda: K.sum_of_products_round_evals(  # noqa: E731
        w_tabs, w_coeffs, w_desc, w_npts)
    w_bound = bound(w_tabs.numel() * 4 + w_coeffs.numel() * 4 + w_npts * 32,
                    (w_tabs.shape[2] // 2) * w_npts * w_desc.products,
                    clock_hz)
    twist_sound_shape = {
        "tables": w_tables, "terms": len(w_idxs), "n": w_tabs.shape[2],
        "npts": w_npts, "products_program": w_desc.products,
        "products_unfactored": w_desc.products_unfactored,
        "program_ops": len(w_desc.program),
        "program_stack_slots": w_desc.depth,
        "ms": cuda_ms(w_run, 20), "queued_ms": queued_ms(w_run, 20, blocker),
        "plain_ms": cuda_ms(lambda: K.round_evals_plain(
            w_tabs, w_coeffs, w_desc, w_npts), 1),
        "bound_ms": w_bound[0], "bound_by": w_bound[1]}
    check(min(twist_sound_shape["ms"], twist_sound_shape["queued_ms"])
          >= w_bound[0], "TwistSound round evals: faster than their bound")
    del w_tabs

    # the prove at the main shape, over the trace of
    # benches/sound_sparse_bench.py; the cube's SRS went up in phase 12 and
    # the T-point PST SRS in phase 4 (the same K and T), so no Fq chain
    w_tr = sound_trace(log_k, log_t)
    # 7 commitments and the levels of 2^10 points or more of both openings
    # on the card; the smaller levels (the cube's j and k, the columns' j)
    # on the host
    want_ts = {"device": 7 + 2 * (log_t - 10), "host": 20 + log_k}
    wproof, ts_s, timer, ts_launches, routes, ts_peak = counted(
        lambda tm: TwistSound.prove(w_tr, pp, dev, tm))
    per = timer.launches
    check(per["j_rounds"]["sum_of_products_round_evals"] == log_t
          and ts_launches["sum_of_products_round_evals"] == log_t,
          f"TwistSound: {log_t} round-evaluation launches, all j rounds")
    check(per["j_rounds"]["fold"] == log_t
          and ts_launches["fold"] == log_t, f"TwistSound: {log_t} folds")
    for st in ("commit", "open"):
        check(per[st]["msm_insert_steps"] > 0 and per[st]["msm_tail"] > 0,
              f"TwistSound {st}: its MSMs ran through the insertion and "
              "tail kernels")
    check(routes == want_ts, f"TwistSound: MSMs by route {routes}, "
          f"expected {want_ts}")
    check(ts_launches["msm_tail"] == routes["device"],
          "TwistSound: one tail a device MSM")
    check(all(ts_launches[k] > 0 for k in (
        "mont_mul_chain", "fold", "sum_of_products_round_evals",
        "msm_insert_steps", "msm_tail")),
        "TwistSound: every kernel of its path launched in it")
    check(ts_launches["g1_padd"] == 0
          and ts_launches["product_round_evals"] == 0
          and ts_launches["fq_mont_mul_chain"] == 0,
          "TwistSound: no kernel off its path launched")
    t0 = time.perf_counter()
    again = TwistSound.prove(w_tr, pp, dev)
    torch.cuda.synchronize()
    ts_again_s = time.perf_counter() - t0
    ts_bytes = TwistSound.to_bytes(wproof)
    check(TwistSound.to_bytes(again) == ts_bytes,
          "two TwistSound proves of one trace differ")
    check(TwistSound.verify(wproof, vp),
          "the verifier rejects the TwistSound proof")
    for what, field, idx in (("rv", "col_values", 1),
                             ("val", "cube_values", 3)):
        forged = dataclasses.replace(wproof, **{field: list(
            getattr(wproof, field))})
        getattr(forged, field)[idx] = Fr(int(getattr(forged, field)[idx]) + 1)
        check(not TwistSound.verify(forged, vp),
              f"a TwistSound proof with a forged {what} value verifies")
    forged = dataclasses.replace(wproof, check=dataclasses.replace(
        wproof.check, final_evaluation=Fr(
            int(wproof.check.final_evaluation) + 1)))
    check(not TwistSound.verify(forged, vp),
          "a TwistSound proof with a forged final evaluation verifies")
    hazards = sum(c.hazard_count for c in kzg.device_contexts())
    check(hazards == 0, f"{hazards} hazards among SRS bases: a bug")

    # references: the frozen dense-path digests on the card, dense against
    # sparse on the card, and at K=2^10 T=2^11 the card against the port's
    # plain versions on the host (the MSMs of that side on the native host
    # MSM)
    for size, want in FROZEN_TWIST_SOUND.items():
        small = TwistSound.to_bytes(TwistSound.prove(
            golden_trace(size), setup_params(size.bit_length() - 1)[0],
            dev))
        check((len(small), hashlib.sha256(small).hexdigest()) == want,
              f"the size-{size} TwistSound proof differs from its frozen "
              "digest")
    mix = mixed_trace(8, 11)
    check(TwistSound.to_bytes(TwistSound.prove(mix, pp4, dev, sparse=False))
          == TwistSound.to_bytes(TwistSound.prove(mix, pp4, dev,
                                                  sparse=True)),
          "TwistSound: dense and sparse bytes differ on the card")
    tr11 = sound_trace(log_k, 11)
    card11 = TwistSound.to_bytes(TwistSound.prove(tr11, pp, dev))
    device_min, kzg.DEVICE_MSM_MIN = kzg.DEVICE_MSM_MIN, 1 << 62
    try:
        host11 = TwistSound.to_bytes(TwistSound.prove(tr11, pp, "cpu"))
    finally:
        kzg.DEVICE_MSM_MIN = device_min
    check(card11 == host11, "K=2^10 T=2^11: the TwistSound proof on the "
          "card differs from the host's")
    phase(13, "twist_sound", K=1 << log_k, T=1 << log_t, verified=True,
          forged_rejected=True, frozen_digests=sorted(FROZEN_TWIST_SOUND),
          dense_equals_sparse=True, card_equals_host_t11=True,
          hazards=hazards, round_evals=twist_sound_shape,
          proof_bytes=len(ts_bytes), prove_s=ts_s, prove_again_s=ts_again_s,
          peak_device_gb=ts_peak, stages_s=timer.phases, stage_launches=per,
          launches=ts_launches, msm_routes=routes)

    # ---- phase 14: the parity Twist and Shout --------------------------------
    # the product kernel on sound mode's one-factor shape, N = 2 .. 2^16
    for n in (2, 4, 64, 2048, 1 << 16):
        t1 = rand_words((1, 8, n))
        errors.compare("product_round_evals", K.product_round_evals(t1),
                       K.product_round_evals_plain(t1),
                       f"product evals, one factor, N={n}")
    p_run = lambda: K.product_round_evals(t1)  # noqa: E731
    p_work = product_work(t1)
    p_bound = bound(*p_work, clock_hz)
    parity_shape = {
        "factors": 1, "n": t1.shape[2], "npts": 4, "products": p_work[1],
        "ms": cuda_ms(p_run, 20), "queued_ms": queued_ms(p_run, 20, blocker),
        "plain_ms": cuda_ms(lambda: K.product_round_evals_plain(t1), 2),
        "bound_ms": p_bound[0], "bound_by": p_bound[1]}
    check(min(parity_shape["ms"], parity_shape["queued_ms"]) >= p_bound[0],
          "one-factor product evals: faster than their bound")
    del t1

    # set-up: the trusted setup for T operations and the two Lagrange SRSs
    # (T points for the columns, K for Shout's table), built on the host
    t0 = time.perf_counter()
    pp14, vp14 = setup_params(log_t - 2)
    setup14_s = time.perf_counter() - t0
    cp14 = pp14.commitment_params
    t0 = time.perf_counter()
    lag_t = kzg.lagrange_srs(cp14, 1 << log_t)
    lag_k = kzg.lagrange_srs(cp14, 1 << log_k)
    lagrange_build_s = time.perf_counter() - t0
    tw_tr, sh_tbl = bench_trace(log_k, log_t), bench_lookups(log_k, log_t)

    def parity_path(name, launches, timer, routes, sound, fq_launches):
        """The checks every parity prove passes, and its result fields:
        two commitments and two openings on the card, each on the
        insertion and tail kernels; in sound mode log T product-round and
        fold launches and one Fr chain (the err vector's pack)."""
        per = timer.launches
        check(routes == {"device": 4, "host": 0},
              f"{name}: MSMs by route {routes}, expected 4 / 0")
        check(launches["msm_tail"] == 4, f"{name}: one tail a device MSM")
        for st in ("commit", "open"):
            check(per[st]["msm_insert_steps"] > 0 and per[st]["msm_tail"] == 2,
                  f"{name} {st}: its MSMs ran through the insertion and "
                  "tail kernels")
        check(launches["fq_mont_mul_chain"] == fq_launches,
              f"{name}: {fq_launches} Fq chain launches (SRS uploads)")
        want = ({"product_round_evals": log_t, "fold": log_t,
                 "mont_mul_chain": 1} if sound else
                {"product_round_evals": 0, "fold": 0, "mont_mul_chain": 0})
        check({k: launches[k] for k in want} == want,
              f"{name}: sum-check launches {launches}, expected {want}")
        if sound:
            check(per["rounds"]["product_round_evals"] == log_t
                  and per["rounds"]["fold"] == log_t,
                  f"{name}: every round on the product and fold kernels")
        check(launches["g1_padd"] == 0
              and launches["sum_of_products_round_evals"] == 0,
              f"{name}: no kernel off its path launched")
        return {"stages_s": timer.phases, "stage_launches": per,
                "launches": launches, "msm_routes": routes}

    parity = {}
    parity_launches = {}
    for who, prover, x, fq_first in (
            ("twist", Twist(pp14, dev), tw_tr, 2),
            ("shout", Shout(pp14, dev), sh_tbl, 2)):
        to_b = twist_proof_to_bytes if who == "twist" else \
            shout_proof_to_bytes
        rows = {}
        for sound in (False, True):
            mode = "sound" if sound else "default"
            proof, secs, timer, lc, routes, peak = counted(
                lambda tm: prover.prove(x, sound_mode=sound, timer=tm))
            # the first prove of each prover uploads its new Lagrange SRS:
            # the T-point one for Twist, the K-point table's for Shout
            row = parity_path(f"{who} {mode}", lc, timer, routes, sound,
                              0 if sound else fq_first)
            t0 = time.perf_counter()
            again = prover.prove(x, sound_mode=sound)
            torch.cuda.synchronize()
            again_s = time.perf_counter() - t0
            got_b = to_b(proof)
            check(to_b(again) == got_b,
                  f"{who} {mode}: two proves of one input differ")
            check(prover.verify(proof, vp14)
                  and prover.verify(proof, vp14, strict=True)
                  and prover.verify(proof, vp14, fast=True),
                  f"{who} {mode}: the verifier rejects the proof")
            forged = dataclasses.replace(
                proof, final_evaluations=list(proof.final_evaluations))
            forged.final_evaluations[0] = Fr(
                int(forged.final_evaluations[0]) + 1)
            check(not prover.verify(forged, vp14),
                  f"{who} {mode}: a forged final evaluation verifies")
            forged = dataclasses.replace(
                proof, opening_proofs=proof.opening_proofs[::-1])
            check(not prover.verify(forged, vp14),
                  f"{who} {mode}: a forged opening verifies")
            parity_launches.setdefault(who, []).append(lc)
            rows[mode] = {"proof_bytes": len(got_b), "prove_s": secs,
                          "prove_again_s": again_s, "peak_device_gb": peak,
                          **row}
        parity[who] = rows
    hazards = sum(c.hazard_count for c in kzg.device_contexts())
    check(hazards == 0, f"{hazards} hazards among SRS bases: a bug")
    # the upload the first proves made, once more on its own
    t0 = time.perf_counter()
    for srs in (lag_t, lag_k):
        msm_sched.ScheduledMsmContext.from_native_srs(srs.srs_id, device=dev)
    torch.cuda.synchronize()
    lagrange_upload_s = time.perf_counter() - t0

    # references: the frozen TWST / SHOT digests on the card, and at
    # K=2^10 T=2^11 in sound mode the card against the port's plain
    # versions on the host (the MSMs of that side on the native host MSM)
    for size, (want_tw, want_sh) in FROZEN_PARITY.items():
        pp_s = setup_params(size.bit_length() - 1)[0]
        got = twist_proof_to_bytes(Twist(pp_s, dev).prove(
            golden_trace(size)))
        check((len(got), hashlib.sha256(got).hexdigest()) == want_tw,
              f"the size-{size} Twist proof differs from its frozen digest")
        got = shout_proof_to_bytes(Shout(pp_s, dev).prove(
            golden_lookups(size)))
        check((len(got), hashlib.sha256(got).hexdigest()) == want_sh,
              f"the size-{size} Shout proof differs from its frozen digest")
    x11 = (bench_trace(log_k, 11), bench_lookups(log_k, 11))
    card11 = [twist_proof_to_bytes(Twist(pp14, dev).prove(
                  x11[0], sound_mode=True)),
              shout_proof_to_bytes(Shout(pp14, dev).prove(
                  x11[1], sound_mode=True))]
    device_min, kzg.DEVICE_MSM_MIN = kzg.DEVICE_MSM_MIN, 1 << 62
    try:
        host11 = [twist_proof_to_bytes(Twist(pp14, "cpu").prove(
                      x11[0], sound_mode=True)),
                  shout_proof_to_bytes(Shout(pp14, "cpu").prove(
                      x11[1], sound_mode=True))]
    finally:
        kzg.DEVICE_MSM_MIN = device_min
    check(card11 == host11, "K=2^10 T=2^11: a parity proof on the card "
          "differs from the host's")
    phase(14, "parity", K=1 << log_k, T=1 << log_t, verified=True,
          forged_rejected=True, frozen_digests=sorted(FROZEN_PARITY),
          card_equals_host_t11=True, hazards=hazards,
          setup_host_s=setup14_s, lagrange_build_s=lagrange_build_s,
          lagrange_upload_s=lagrange_upload_s,
          product_one_factor=parity_shape, **parity)

    if profile:
        phase(6, "profile",
              twist_bits=profile_prove(lambda: TwistBits.prove(tr, pp, dev)),
              shout_bits=profile_prove(
                  lambda: ShoutBits.prove(s_tbl, pp, dev)),
              shout_sound=profile_prove(
                  lambda: ShoutSound.prove(v_tbl, pp, dev)),
              twist_sound=profile_prove(
                  lambda: TwistSound.prove(w_tr, pp, dev)),
              twist=profile_prove(lambda: Twist(pp14, dev).prove(tw_tr)),
              shout=profile_prove(lambda: Shout(pp14, dev).prove(sh_tbl)))

    check(not [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "tnsh")],
          "the JAX package or jax itself was imported")
    fr_src = "tnsh_torch/csrc/fr_kernels.cu"
    msm_src = "tnsh_torch/csrc/msm_kernels.cu"
    # name -> (source, the TPU kernel or, for g1_padd, the XLA function
    # whose place it takes)
    table = {
        "mont_mul_chain": (fr_src, "tnsh/field/fr_pallas.py:401"),
        "fold": (fr_src, "tnsh/field/fr_pallas.py:149"),
        "product_round_evals": (fr_src, "tnsh/field/fr_pallas.py:231"),
        "sum_of_products_round_evals": (fr_src,
                                        "tnsh/field/fr_pallas.py:335"),
        "fq_mont_mul_chain": (msm_src, "tnsh/field/fr_pallas.py:401"),
        "g1_padd": (msm_src, "tnsh/commit/msm_jax.py:72"),
        "msm_insert_steps": (msm_src, "tnsh/commit/msm_sched.py:560"),
        # the XLA stages behind the Pallas insertion in
        # _compiled_msm_kernel_pallas_cached: the group fold (:706-723),
        # the canon_src gather (:724-730) and _window_sums (:295, called
        # at :731)
        "msm_tail": (msm_src, "tnsh/commit/msm_sched.py:706"),
    }
    # the add is no longer on the prove's path; its count is that of its
    # own path, tree_reduce_points in phase 7
    # each prover's own counts: TwistBits (the main path) and the two
    # lookup provers
    # and the parity provers', each the sum of its default and its
    # sound-mode prove
    by_path = {"twist_bits": launches, "shout_bits": sb_launches,
               "shout_bits_committed": sc_launches,
               "shout_sound": ss_launches, "twist_sound": ts_launches,
               **{who: {k: sum(c[k] for c in counts) for k in counts[0]}
                  for who, counts in parity_launches.items()}}
    launches = {**launches, "g1_padd": padd_path_launches}
    kernels = []
    for name, (source, replaces) in table.items():
        bound_ms, bound_by = bound(*work[name], clock_hz)
        check(min(times[name][0], dev_times[name]) >= bound_ms,
              f"{name}: faster than its bound; the bound miscounts the work")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errors.worst[name], "ms": times[name][0],
            "queued_ms": dev_times[name],
            "plain_ms": times[name][1], "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no PyTorch call multiplies 256-bit residues or adds curve
            # points
            "library_ms": None,
            "launches_by_path": {p: c[name] for p, c in by_path.items()}})
        if name == "product_round_evals":
            kernels[-1]["twist_parity_sound_shape"] = {
                **parity_shape,
                "launches": parity_launches["twist"][1][name],
                "max_abs_err": errors.worst[name], "library_ms": None}
        if name == "sum_of_products_round_evals":
            kernels[-1].update(
                products_unfactored=desc.products_unfactored,
                products_program=desc.products,
                shout_bits_shape={
                    **shout_shape, "launches": sb_launches[name],
                    "max_abs_err": errors.worst[name], "library_ms": None},
                shout_sound_shape={
                    **sound_shape, "launches": ss_launches[name],
                    "max_abs_err": errors.worst[name], "library_ms": None},
                twist_sound_shape={
                    **twist_sound_shape, "launches": ts_launches[name],
                    "max_abs_err": errors.worst[name], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
