"""GPU smoke run of the tnsh_torch port: builds the CUDA kernels and the
native host engine from this checkout, holds each kernel against its plain
PyTorch version on the card, then proves TwistBits, ShoutBits,
ShoutBitsCommitted, ShoutSound, TwistSound, Twist and Shout statements at
K=2^10, T=2^16 through the port, with their commitments, openings and
sum-check rounds on the card,
and checks the proofs with the port's verifier and against references on
small inputs; then it runs the sharded oracles and the sharded MSM of the
mesh on one and on two ranks, the bit-column provers' dense (k, j)-cube
path at K=2^10, T=2^14 against their structured path, the sound tier
without the native engine (TNSH_NO_NATIVE) and the bench command line,
and last TwistBits and ShoutBits at K=2^10, T=2^20 with the cyclic GC
paused and, for TwistBits, not paused.

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
               one-term 13-factor shape; the dense cube's term structures
               (TwistBits 49 tables, 47 terms, npts 14; the Shout
               statement 24 tables, 22 terms, npts 13), their fold and the
               eq(sigma) cube's product at K=2^10, T=2^4; the openings'
               kernels on TwistBits' stack of 24 random columns of 2^log_t
               lanes uploaded as a prove uploads them: the RLC over the
               stack and the open level on its table's first level limb
               for limb against their plain versions, timed; the values,
               RLC tables (the whole stack, TwistBits' second opening
               group, ShoutBits' 11 columns) and the opening of the
               stack's table against the host engine's bytes
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
  19 plan      the MSM's plan on the card against its plain versions:
               ``msm_digits`` (signed digits, their (chunk, window,
               magnitude) counts, the words' OR and the carry flag) and
               ``msm_rank`` (every chunk's schedule at the derived width)
               on 2^16 and 2^20 scalars of each kind the main path commits
               (bit columns, ``bench_rw``'s values, full-width Fr),
               element for element, each timed by events and queued beside
               its byte bound
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
  15 mesh     ``tnsh_torch.parallel.mesh`` at K=2^10, T=2^LOG_T, twice:
               world 1 on NCCL and world 2 over gloo, two spawned ranks on
               this one card (NCCL refuses two ranks on one GPU), each rank
               its block of lanes on the card's kernels: ``ShardedSopOracleD``
               over the TwistBits j-phase terms (49 tables, 47 terms,
               degree 13), ``ShardedSumOfProductsOracle`` over the
               TwistSound j-phase terms (16 tables, 18 terms) with
               ``max_sharded_rounds`` unset and 8, ``ShardedProductMLEOracle``
               over three factors, ``ShardedSparseCubeOracle`` over tnsh's
               S / I / E cube system (the native k phase on each rank's
               slice, its colinc scan seeded with the lower ranks'), the
               sharded MSM of 2^LOG_T bases with full-width scalars and
               the prover step, every launch and collective count set to
               0 just before: every rank's bytes equal, equal
               to the unsharded oracles' on the card (``TorchSopOracleD``,
               ``TorchSumOfProductsOracle``, ``TorchProductMLEOracle``, the
               native ``SparseCubeOracle``), world 1's equal to world 2's,
               the MSM equal to the native host MSM with 0 hazards, kernels
               #1-#5 and ``msm_tail`` launched on every rank and the
               Jacobian add at world 2 only; each oracle's seconds beside
               the unsharded one's, the collectives and their seconds,
               the seconds in ``psum_field``, the launches by rank.  World 2 on one card is no scaling figure
  16 dense     TwistBits, ShoutBits and ShoutBitsCommitted at K=2^10,
               T=2^14 (``bench.py``'s trace, ``benches/bits_bench.py``'s
               lookups) on the structured path and then with
               TNSH_BITS_DENSE set, counts set to 0 just before each prove:
               dense bytes equal to structured bytes, both verified, 0
               hazards, log K + log T round-evaluation and fold launches in
               phase A and the cube build's chain launches (its packs' and,
               for TwistBits, the eq cube's); the dense stages (cube_build,
               k_rounds, j_rounds, phase_b) beside the structured phase
               A's, launches, peak device memory; then the round
               evaluations (TwistBits' and the Shout shape), the fold and
               the eq cube's product timed at 2^24 lanes, each held on its
               timed launch: the lanes are 256 tiles of 2^16 full-range
               random lanes, so the round evaluations must be 256 times
               the plain version's over one tile, and the fold and the
               product the plain version's tile 256 times
  17 engine_free  ShoutSound and TwistSound (the sparse path) at K=2^10,
               T=2^12 over phase 12's lookups and phase 13's trace, in a
               subprocess started with TNSH_NO_NATIVE=1 (``engine_free_child``:
               the pure-Python set-ups, host work in Python ints, the j
               rounds and every MSM of 1024 points or more on the card),
               each prove with its counts set to 0 just before it: the
               engine never loaded, 0 hazards, the round evaluations, the
               fold, the insertion and the tail launched, MSMs by route as
               with the engine; the same proves with the engine in this
               process: bytes equal, both proofs verified, both stage splits
               and launches side by side; then ``python -m
               tnsh_torch.bench.cli`` on the card, each exit 0: quick (a
               smoke run; the harness raises on a proof that fails), then
               sound and bits at the main path's K and T (a warm prove a
               prover, every proof verified), with their operations a
               second
  18 bits_at_scale  TwistBits and ShoutBits at K=2^10, T=2^20 (the
               north-star row of the bit-column tier) over ``bench_trace``
               and ``bench_lookups``, the SRS uploaded first, in the turns
               of ``SCALE_TURNS``: TwistBits with the cyclic GC paused,
               then with TNSH_GC_PAUSE=0, ShoutBits paused, each prove
               with its counts set to 0 just before it: verified by the
               port's verifier, two proves of one input equal, 0 hazards,
               0 generation-2 collections in a paused prove, log T
               round-evaluation and fold launches a sum-check, the MSMs on
               the insertion and tail kernels, every device MSM planned on
               the card (``msm_device_plans`` and the digits launches equal
               to the device route's count); each prove's seconds,
               stages (with ``open/evals`` and ``open/rlc``), generation-2
               collections and their seconds, peak device memory, MSMs by
               route and launches; then the round evaluations (TwistBits'
               j program, npts 14) and the fold on 49 tables of 2^20
               random lanes, the RLC on 24 and the open level on the first
               level of its table, held against their plain versions on
               the same lanes, timed, with their bounds
  20 k_round  TwistBits' k rounds on the card at K=2^10, T=2^16 and
               2^20 over ``bench_trace``'s columns: the bucket stack, the
               round kernel at rounds 0 and 3 and three binds against
               their plain versions; the round kernel timed by events and
               queued, beside its plain version, the engine's
               ``tbk_round_evals`` on the host and its bound (phase 18
               checks log K ``k_device_rounds`` a TwistBits prove)
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
path, worst canonical difference from its plain version (a shape row: that
of the comparison at its timed shape), its time by CUDA
events over back-to-back calls (``ms``) and the same with the calls queued
behind a long kernel (``queued_ms``; the smaller where a launch is shorter
than the host takes to queue it), the plain version's, and the least time
the card could take for the same bytes and multiplies; ``launches_by_path``
gives each prover's own count, TwistBits' (the main path's), ShoutBits',
ShoutBitsCommitted's, ShoutSound's, TwistSound's, Twist's and Shout's
(each its default and its sound-mode prove together), and the mesh's
(phase 15: every rank of both worlds), the round
evaluations' row the ShoutBits, ShoutSound and TwistSound shapes as
``shout_bits_shape``, ``shout_sound_shape`` and ``twist_sound_shape``, and
the product row sound mode's one-factor shape as
``twist_parity_sound_shape``; phase 16's dense shapes as the round
evaluations' ``twist_bits_dense_shape`` and ``shout_bits_dense_shape``,
the fold's ``twist_bits_dense_shape`` and the chain's ``eq_cube_shape``,
``launches_by_path`` its three dense proves as ``dense`` and phase 17's
two engine-free proves as ``engine_free``; phase 18's shapes as the round
evaluations', the fold's, the RLC's and the open level's
``twist_bits_t20_shape``, its first paused
TwistBits and ShoutBits proves as ``twist_bits_t20`` and
``shout_bits_t20``), the card's
name and power limit, and last
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
import os
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

#: The transcript seed of phase 15's proofs, and the seed of its inputs.
MESH_SEED = bytes([15]) * 32
MESH_INPUTS_SEED = 15

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
                                 "msm_window_sums_kernel",
                                 "msm_digits_kernel", "msm_rank_kernel")
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


def timed(fn, reps: int) -> tuple:
    """(mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call; the last call's result)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = None      # back to the allocator: the next call reuses it
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def cuda_ms(fn, reps: int) -> float:
    return timed(fn, reps)[0]


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


def mesh_inputs(log_k: int, log_t: int, seed: int) -> dict:
    """Phase 15's inputs, made from ``seed`` with numpy: the same in every
    rank and in the parent.  Table values are below 2^252 (32-byte LE
    words in ``FrTable``s), the tables a term structure names 0/1 are
    boolean.

      sopd     the TwistBits j-phase terms (``j_phase_terms``: 49 tables,
               47 terms, degree log K + 3) with random coefficients;
      sop      the TwistSound j-phase terms (``twist_sound_j_terms``: 16
               tables, 18 terms, degree 3);
      product  three factors of 2^log_t lanes;
      cube     tnsh's S / I / E cube system (tests/test_jax_backend.py's
               sharded cube case) at (log K, log T): a one-hot column a
               cycle, a colinc update at every cycle j with j % 3 != 0;
      secrets, scalars   the MSM: base i is secrets[i] * G, 2^log_t
               full-width scalars;
      r        the prover step's challenge."""
    import numpy as np

    from tnsh_torch.commit.mkzg_sparse import (
        IncrementalCubeTable,
        SparseCubeTable,
    )
    from tnsh_torch.field.fr import MODULUS, Fr, FrTable
    from tnsh_torch.poly.mle_host import MultilinearExtension

    rng = np.random.default_rng(seed)
    n = 1 << log_t

    def raw(count):
        w = rng.integers(0, 1 << 32, (count, 8), dtype=np.uint64).astype(
            "<u4")
        w[:, 7] &= 0x0FFFFFFF
        return w.tobytes()

    def table(boolean=False):
        if not boolean:
            return FrTable(raw(n))
        w = np.zeros((n, 8), dtype="<u4")
        w[:, 0] = rng.integers(0, 2, n)
        return FrTable(w.tobytes())

    def terms(idxs, tabs):
        coeffs = FrTable(raw(len(idxs)))
        return [(c, [tabs[i] for i in t]) for c, t in zip(coeffs, idxs)]

    idxs, n_tables, bools = j_phase_terms(log_k)
    sopd = terms(idxs, [table(i in bools) for i in range(n_tables)])
    idxs, n_tables = twist_sound_j_terms()
    sop = terms(idxs, [table() for _ in range(n_tables)])
    factors = [MultilinearExtension(log_t, table()) for _ in range(3)]
    sp = SparseCubeTable(log_k, log_t)
    inc = IncrementalCubeTable(log_k, log_t)
    pos = rng.integers(0, 1 << log_k, (2, n)).tolist()
    deltas = FrTable(raw(n))
    for j in range(n):
        sp.set(j, pos[0][j], 1)
        if j % 3:
            inc.add_update(j, pos[1][j], deltas[j])
    eqj = FrTable(raw(n))
    eqk = list(FrTable(raw(1 << log_k)))
    cube = [
        (1, [("eqj", eqj), ("colsparse", sp), ("colinc", inc)]),
        (MODULUS - 2, [("eqk", eqk), ("colsparse", sp), ("colsparse", sp)]),
        (3, [("eqk", eqk), ("colinc", inc)]),
        (5, [("eqj", eqj), ("eqk", eqk)]),
    ]
    return {"sopd": sopd, "sopd_degree": log_k + 3, "sop": sop,
            "product": factors, "cube": cube, "secrets": raw(n),
            "scalars": raw(n), "r": Fr(int.from_bytes(raw(1), "little"))}


def mesh_rank(mesh, log_k: int, log_t: int, seed: int, claims: dict) -> dict:
    """Phase 15 on one rank of a spawned world: the four sharded oracles'
    proofs (the sum of products with and without ``max_sharded_rounds``
    = 8), the sharded MSM over the rank's block of bases, and the prover
    step, on the rank's card, with every launch and collective count set
    to 0 just before; before that, the unsharded sums of products over the
    rank's full tables, timed, whose bytes the sharded ones must equal.
    Returns the proofs' digests, the seconds of each, the MSM's element,
    the step's results, the launches, the collectives, the seconds in
    ``psum_field`` and the hazards."""
    import hashlib

    from tnsh_torch import _native
    from tnsh_torch.commit import kzg
    from tnsh_torch.core.params import NativeSRS
    from tnsh_torch.core.proof_io import (
        sumcheck_d_proof_to_bytes,
        sumcheck_proof_to_bytes,
    )
    from tnsh_torch.core.transcript import Transcript
    from tnsh_torch.field import limbs
    from tnsh_torch.field.fr import Fr
    from tnsh_torch.field.g1 import G1
    from tnsh_torch.iop.sumcheck import SumCheck
    from tnsh_torch.iop.sumcheck_d import SumCheckD
    from tnsh_torch.parallel import mesh as M
    from tnsh_torch.utils.profiling import launch_counts, reset_launch_counts

    check(mesh.device.type == "cuda", f"rank {mesh.rank} is not on a card")
    x = mesh_inputs(log_k, log_t, seed)
    n = 1 << log_t
    lo, hi = M.block(mesh, n)
    srs = NativeSRS(_native.srs_create_fixed_base(
        G1.generator(), x["secrets"][32 * lo:32 * hi]))
    scalars = x["scalars"][32 * lo:32 * hi]
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    def sumcheck(name, claim, num_vars, oracle):
        proof = timed(name, lambda: SumCheck(num_vars, Fr(claim)).prove(
            oracle(), Transcript(MESH_SEED)))
        return hashlib.sha256(sumcheck_proof_to_bytes(proof)).hexdigest()

    # not counted: the first collective (NCCL builds its communicator
    # there), a first launch from each kernel library, and the unsharded
    # sums of products over the rank's full tables, timed: the seconds
    # below compare with those in the same process
    from tnsh_torch.field import fq_kernels, fr_kernels
    from tnsh_torch.iop.sumcheck import TorchSumOfProductsOracle
    from tnsh_torch.iop.sumcheck_d import TorchSopOracleD

    one = limbs.pack([1, 2], mesh.device)
    M.psum_field(fr_kernels.fold(one.unsqueeze(0), 3)[0], mesh)
    fq_kernels.to_mont(one)
    deg = x["sopd_degree"]
    proof = timed("sopd_unsharded", lambda: SumCheckD(
        log_t, Fr(claims["sopd"]), deg).prove_with_challenges(
            TorchSopOracleD(log_t, x["sopd"], deg, device=mesh.device),
            Transcript(MESH_SEED))[0])
    unsharded = {"sopd": hashlib.sha256(
        sumcheck_d_proof_to_bytes(proof)).hexdigest()}
    unsharded["sop"] = sumcheck(
        "sop_unsharded", claims["sop"], log_t,
        lambda: TorchSumOfProductsOracle(log_t, x["sop"], device=mesh.device))
    torch.cuda.synchronize()
    reset_launch_counts()
    mesh.collectives, mesh.collective_s, mesh.psum_s = 0, 0.0, 0.0
    start = time.perf_counter()
    proof = timed("sopd", lambda: SumCheckD(
        log_t, Fr(claims["sopd"]), deg).prove_with_challenges(
            M.ShardedSopOracleD(log_t, x["sopd"], deg, mesh),
            Transcript(MESH_SEED))[0])
    proofs = {"sopd": hashlib.sha256(
        sumcheck_d_proof_to_bytes(proof)).hexdigest()}
    for cap in (None, 8):
        proofs[f"sop_cap{cap}"] = sumcheck(
            f"sop_cap{cap}", claims["sop"], log_t,
            lambda: M.ShardedSumOfProductsOracle(log_t, x["sop"], mesh,
                                                 max_sharded_rounds=cap))
    proofs["product"] = sumcheck(
        "product", claims["product"], log_t,
        lambda: M.ShardedProductMLEOracle(x["product"], mesh))
    proofs["cube"] = sumcheck(
        "cube", claims["cube"], log_k + log_t,
        lambda: M.ShardedSparseCubeOracle(log_k, log_t, x["cube"], mesh))
    got = timed("msm", lambda: M.sharded_msm(mesh, srs, scalars))
    tables = torch.stack([limbs.pack(f.evaluations[lo:hi], mesh.device)
                          for f in x["product"]])
    evals, folded, step_msm = timed(
        "step", lambda: M.build_sharded_prover_step(mesh)(
            tables, x["r"], srs, scalars))
    wall = time.perf_counter() - start
    launches = launch_counts()
    _native.srs_free(srs.srs_id)
    canon = b"".join(v.to_bytes(32, "little") for t in folded
                     for v in limbs.unpack(t))
    check(unsharded["sopd"] == proofs["sopd"]
          and unsharded["sop"] == proofs["sop_capNone"],
          f"rank {mesh.rank}: the sharded sums of products differ from the "
          "unsharded oracles in the same process")
    return {"device": str(mesh.device), "proofs": proofs, "s": secs,
            "wall_s": wall, "msm": got.to_affine(),
            "step": {"evals": limbs.unpack(evals),
                     "folded": hashlib.sha256(canon).hexdigest(),
                     "msm": step_msm.to_affine()},
            "launches": launches, "collectives": mesh.collectives,
            "collective_s": mesh.collective_s, "psum_s": mesh.psum_s,
            "hazards": kzg.hazard_count()}


class Errors:
    """Worst canonical difference from the plain version, per kernel."""

    def __init__(self):
        self.worst = {}

    def compare(self, kernel: str, got, want, what: str, spec=None) -> int:
        """Canonical values of ``got`` and ``want`` (limb planes of Fr, or
        of ``spec``'s field) must be equal; returns this comparison's
        worst difference."""
        from tnsh_torch.field import limbs

        spec = limbs.FR_SPEC if spec is None else spec
        return self.compare_values(kernel, limbs.unpack(_flat(got), spec),
                                   limbs.unpack(_flat(want), spec), what)

    def compare_tensors(self, kernel: str, got, want, what: str) -> int:
        """As ``compare`` for Fr, with the canonical values compared on
        the card and only the lanes that differ unpacked: a Python
        comparison of 2^25 values takes minutes."""
        from tnsh_torch.field import fr_ops, limbs

        a, b = fr_ops.canon(_flat(got)), fr_ops.canon(_flat(want))
        check(a.shape == b.shape, f"{what}: shapes differ")
        lanes = (a != b).any(0).nonzero().squeeze(1)
        return self.compare_values(kernel, limbs.unpack(a[:, lanes]),
                                   limbs.unpack(b[:, lanes]), what)

    def compare_ints(self, kernel: str, got, want, what: str) -> int:
        """Integer tensors (digits, counts, schedules) must be equal
        element for element; returns the worst difference."""
        check(got.shape == want.shape, f"{what}: shapes differ")
        err = (int((got.long() - want.long()).abs().max())
               if got.numel() else 0)
        self.worst[kernel] = max(self.worst.get(kernel, 0), err)
        check(err == 0, f"{what}: kernel differs from its plain version")
        return err

    def compare_values(self, kernel: str, a, b, what: str) -> int:
        """The canonical values ``a`` (the kernel's) and ``b`` must be
        equal; returns the worst difference."""
        check(len(a) == len(b), f"{what}: shapes differ")
        err = max((abs(x - y) for x, y in zip(a, b)), default=0)
        self.worst[kernel] = max(self.worst.get(kernel, 0), err)
        check(err == 0, f"{what}: kernel differs from its plain version")
        return err


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


def counted(fn, dev) -> tuple:
    """``fn(timer)`` with every launch and route count set to 0 just
    before it: (its result, seconds, timer, launches, routes, the device
    memory it took above what was live, in GB)."""
    from tnsh_torch.commit import kzg
    from tnsh_torch.utils.profiling import (
        PhaseTimer,
        launch_counts,
        reset_launch_counts,
    )

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


#: log2 of phase 17's trace length: the pure-Python cube SRS (built in the
#: engine-free subprocess, O(T) host scalar multiplications) cuts it from
#: the main path's 2^16
ENGINE_FREE_LOG_T = 12
#: the bench command line's modes phase 17 runs on the card; sound and
#: bits at the main path's K and T
CLI_MODES = ("quick", "sound", "bits")


def engine_free_child(log_k: int, log_t: int, device) -> int:
    """Phase 17's subprocess, started with TNSH_NO_NATIVE=1: ShoutSound and
    TwistSound on the sparse path over ``sound_lookups`` / ``sound_trace``
    on ``device``, each with its counts set to 0 just before it; prints
    one JSON line with each proof's bytes and SHA-256 digest, stages,
    launches and MSM routes, the hazards, the host seconds of the
    pure-Python set-ups, and whether the native engine was ever loaded."""
    from tnsh_torch import _native
    from tnsh_torch.commit import kzg
    from tnsh_torch.commit.mkzg import setup_multilinear_params
    from tnsh_torch.commit.mkzg_sparse import cube_params
    from tnsh_torch.core.params import setup_params
    from tnsh_torch.protocols.sound import ShoutSound, TwistSound
    from tnsh_torch.utils.profiling import (
        PhaseTimer,
        launch_counts,
        reset_launch_counts,
    )

    check(not _native.available, "TNSH_NO_NATIVE is not set")
    dev = torch.device(device)
    t0 = time.perf_counter()
    cube_params(log_k, log_t)
    setup_multilinear_params(log_t)
    pp = setup_params(4)[0]
    srs_s = time.perf_counter() - t0
    out = {"srs_host_s": srs_s, "provers": {}}
    tbl, tr = sound_lookups(log_k, log_t), sound_trace(log_k, log_t)
    for name, prove, to_bytes in (
            ("shout_sound", lambda tm: ShoutSound.prove(
                tbl, pp, dev, tm, sparse=True), ShoutSound.to_bytes),
            ("twist_sound", lambda tm: TwistSound.prove(
                tr, pp, dev, tm, sparse=True), TwistSound.to_bytes)):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        kzg.reset_route_counts()
        reset_launch_counts()
        timer = PhaseTimer()
        t0 = time.perf_counter()
        proof = prove(timer)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        b = to_bytes(proof)
        out["provers"][name] = {
            "prove_s": secs, "bytes": b.hex(),
            "sha256": hashlib.sha256(b).hexdigest(),
            "stages_s": timer.phases, "stage_launches": timer.launches,
            "launches": launch_counts(), "msm_routes": kzg.route_counts()}
    out["hazards"] = kzg.hazard_count()
    out["native_loaded"] = _native._loaded is not None
    print(json.dumps(out), flush=True)
    return 0


#: log2 of phase 18's trace length: K=2^10, T=2^20 is the north-star row
#: of the bit-column tier, the size its users prove
SCALE_LOG_T = 20
#: phase 18's proves in the order they run: (prover, collector paused);
#: TwistBits paused, then unpaused
SCALE_TURNS = (("twist_bits", True), ("twist_bits", False),
               ("shout_bits", True))


def bits_at_scale(log_k: int, log_t: int, dev, pp, vp, clock_hz: float,
                  errors, rand_words, blocker) -> tuple:
    """Phase 18: TwistBits over ``bench_trace`` and ShoutBits over
    ``bench_lookups`` at K=2^log_k, T=2^log_t on ``dev``, in the order of
    ``SCALE_TURNS``, TwistBits' unpaused turn with TNSH_GC_PAUSE=0; each
    prove with its counts set to 0 just before it, verified by the port's
    verifier, its generation-2 collections counted; then the round
    evaluations (TwistBits' j program, npts 14) and the fold timed on 49
    tables of 2^log_t random lanes against their plain versions on the
    same lanes.  Returns (the phase's fields, the two kernel shapes, the
    launches of the first paused prove of each prover).  Each shape's
    ``launches_at_shape`` is the count of its kernel's launches on tables
    of that shape in the first paused TwistBits prove."""
    from tnsh_torch.commit import kzg
    from tnsh_torch.commit.mkzg import MultilinearKZG
    from tnsh_torch.field import fr_kernels as K
    from tnsh_torch.field import limbs
    from tnsh_torch.field.fr import MODULUS as P
    from tnsh_torch.protocols.twist_bits import (
        ShoutBits,
        TwistBits,
        setup_multilinear_params,
    )
    from tnsh_torch.utils.profiling import GcCollections, launch_shapes

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tr, tbl = bench_trace(log_k, log_t), bench_lookups(log_k, log_t)
    inputs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params_t, _ = setup_multilinear_params(log_t)   # cached per process
    srs_s = time.perf_counter() - t0
    # the SRS goes up before the proves, so that no turn carries it
    _, upload_s, _, upload_launches, _, _ = counted(
        lambda tm: MultilinearKZG.prepare_device(params_t, dev), dev)
    check(upload_launches["fq_mont_mul_chain"] > 0,
          f"the 2^{log_t} SRS went to Montgomery form through the Fq kernel")
    # MSMs by route: the column commitments and the opening levels of
    # 1024 points or more on the card, the ten smaller levels of each
    # opening on the host
    big = log_t - 10
    provers = {
        "twist_bits": (lambda tm: TwistBits.prove(tr, pp, dev, tm),
                       lambda pf: TwistBits.verify(pf, vp),
                       TwistBits.to_bytes, ("phase_a", "phase_b"),
                       {"device": 2 * log_k + 4 + 2 * big, "host": 20}),
        "shout_bits": (lambda tm: ShoutBits.prove(tbl, pp, dev, tm),
                       lambda pf: ShoutBits.verify(pf, tbl.entries, vp),
                       ShoutBits.to_bytes, ("phase_a",),
                       {"device": log_k + 1 + big, "host": 10}),
    }
    path = ("mont_mul_chain", "fold", "sum_of_products_round_evals",
            "msm_digits", "msm_rank", "msm_insert_steps", "msm_tail", "rlc",
            "open_level")
    proves, digests, first_launches, first_shapes = {}, {}, {}, {}
    for name, paused in SCALE_TURNS:
        prove, verify, to_bytes, rounds, want_routes = provers[name]
        label = name if paused else name + "_unpaused"
        if not paused:
            os.environ["TNSH_GC_PAUSE"] = "0"
        try:
            with GcCollections() as gcs:
                proof, secs, timer, launches, routes, peak = counted(prove,
                                                                     dev)
                shapes_seen = launch_shapes()
        finally:
            os.environ.pop("TNSH_GC_PAUSE", None)
        max_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        check(verify(proof), f"{label} T=2^{log_t}: the verifier rejects "
              "the proof")
        digest = hashlib.sha256(to_bytes(proof)).hexdigest()
        check(digests.setdefault(name, digest) == digest,
              f"{name} T=2^{log_t}: two proves differ")
        del proof
        check(not paused or gcs.count == 0,
              f"{label}: {gcs.count} generation-2 collections while paused")
        per = timer.launches
        for st in rounds:
            # TwistBits' phase A also folds its k phase's bucket stack at
            # each k bind but the last
            folds = log_t + (log_k - 1 if (name, st) == ("twist_bits",
                                                         "phase_a") else 0)
            check(per[st]["sum_of_products_round_evals"] == log_t
                  and per[st]["fold"] == folds,
                  f"{label} {st}: {log_t} round-evaluation and {folds} "
                  "fold launches")
        for st in ("commit", "open"):
            check(per[st]["msm_insert_steps"] > 0 and per[st]["msm_tail"] > 0,
                  f"{label} {st}: its MSMs ran through the insertion and "
                  "tail kernels")
        check(launches["msm_tail"] == routes["device"]
              and routes == want_routes,
              f"{label}: MSMs by route {routes}, expected {want_routes}")
        # every device MSM planned on the card: digits and counts, then
        # its schedule, by the two kernels
        check(timer.counters.get("msm_device_plans", 0) == routes["device"]
              and launches["msm_digits"] == routes["device"]
              and launches["msm_rank"] == launches["msm_tail"],
              f"{label}: {timer.counters.get('msm_device_plans')} MSMs "
              f"planned on the card, {launches['msm_digits']} digits and "
              f"{launches['msm_rank']} rank launches for "
              f"{routes['device']} device MSMs")
        check(all(launches[k] > 0 for k in path),
              f"{label}: every kernel of its path launched in it")
        # TwistBits' k rounds on the card: log K of them, counted
        k_rounds = log_k if name == "twist_bits" else 0
        check(timer.counters.get("k_device_rounds", 0) == k_rounds
              and launches["twist_k_round"] == k_rounds,
              f"{label}: {timer.counters.get('k_device_rounds')} k rounds "
              f"on the card, {launches['twist_k_round']} round launches, "
              f"expected {k_rounds}")
        # the j stack's V: one scan of T lanes a TwistBits prove
        scans = 1 if name == "twist_bits" else 0
        check(launches["prefix_scan"] == scans
              and timer.counters.get("j_scan_lanes", 0) == scans << log_t,
              f"{label}: {scans} prefix scan of 2^{log_t} lanes, counted")
        if paused:
            first_launches.setdefault(name, launches)
            first_shapes.setdefault(name, shapes_seen)
        proves.setdefault(label, []).append({
            "prove_s": secs, "gen2_collections": gcs.count,
            "gen2_s": gcs.seconds, "gen01_collections": gcs.young_count,
            "gen01_s": gcs.young_seconds, "peak_above_live_gb": peak,
            "max_memory_allocated_gb": max_gb, "msm_routes": routes,
            "stages_s": timer.phases,
            "launches": {k: v for k, v in launches.items() if v}})
    hazards = kzg.hazard_count()
    check(hazards == 0, f"{hazards} hazards in phase 18's proves: a bug")
    proves_s = time.perf_counter() - t_phase

    # the kernels at the prove's largest shapes: phase A's first j round
    # and its fold, 49 tables of 2^log_t lanes, on random words
    term_idxs, n_tables, _ = j_phase_terms(log_k)
    desc = K.terms(term_idxs, dev)
    n, npts = 1 << log_t, 14
    tabs = rand_words((n_tables, 8, n))
    cf = rand_words((8, len(term_idxs)))
    sop_ms, got = timed(lambda: K.sum_of_products_round_evals(
        tabs, cf, desc, npts), 5)
    t0 = time.perf_counter()
    want = K.round_evals_plain(tabs, cf, desc, npts)
    torch.cuda.synchronize()
    sop_plain_ms = (time.perf_counter() - t0) * 1e3
    sop_err = errors.compare_tensors(
        "sum_of_products_round_evals", got, want,
        f"round evals, {n_tables} x 2^{log_t} lanes")
    del got, want
    sop_bound = bound(tabs.numel() * 4 + cf.numel() * 4 + npts * 32,
                      n // 2 * npts * desc.products, clock_hz)
    check(sop_ms >= sop_bound[0],
          "round evals at 2^20 lanes: faster than their bound")
    r = random.Random(log_t).randrange(P)
    fold_ms, folded = timed(lambda: K.fold(tabs, r), 5)
    fold_err = errors.compare_tensors("fold", folded, K.fold_plain(tabs, r),
                                      f"fold, {n_tables} x 2^{log_t} lanes")
    fold_plain_ms = cuda_ms(lambda: K.fold_plain(tabs, r), 1)
    del folded, tabs
    torch.cuda.empty_cache()
    fold_bound = bound(n_tables * 8 * n * 4 * 3 // 2, n_tables * n // 2,
                       clock_hz)
    check(fold_ms >= fold_bound[0], "fold at 2^20 lanes: faster than its "
          "bound")
    # the openings' kernels at the prove's shapes: the RLC of TwistBits'
    # stack of 2 log K + 4 columns, and its table's first opening level
    f_twist = 2 * log_k + 4
    stack = rand_words((f_twist, 8, n))
    coeffs = rand_words((8, f_twist)).t().contiguous()
    rlc_ms, table = timed(lambda: K.rlc(stack, coeffs), 5)
    want = K.rlc_plain(stack, coeffs)
    check(torch.equal(table, want), f"rlc, {f_twist} x 2^{log_t} lanes: "
          "not limb for limb its plain version's")
    rlc_err = errors.compare_tensors("rlc", table, want,
                                     f"rlc, {f_twist} x 2^{log_t} lanes")
    del want
    rlc_plain_ms = cuda_ms(lambda: K.rlc_plain(stack, coeffs), 1)
    rlc_bound = bound(stack.numel() * 4 + coeffs.numel() * 4
                      + table.numel() * 4, f_twist * n, clock_hz)
    check(rlc_ms >= rlc_bound[0], "rlc at 2^20 lanes: faster than its bound")
    del stack
    quot = torch.empty((n // 2, limbs.NUM_LIMBS), dtype=torch.int32,
                       device=dev)
    want_quot = torch.empty_like(quot)
    level_ms, nxt = timed(lambda: K.open_level(table, r, quot), 5)
    want = K.open_level_plain(table, r, want_quot)
    check(torch.equal(nxt, want) and torch.equal(quot, want_quot),
          f"open_level, 2^{log_t} lanes: not limb for limb its plain "
          "version's")
    level_err = max(
        errors.compare_tensors("open_level", nxt, want,
                               f"open level, 2^{log_t} lanes"),
        errors.compare_tensors("open_level", quot.t(), want_quot.t(),
                               f"open level quotients, 2^{log_t} lanes"))
    level_plain_ms = cuda_ms(
        lambda: K.open_level_plain(table, r, want_quot), 1)
    level_bound = bound(table.numel() * 4 * 2, n, clock_hz)
    check(level_ms >= level_bound[0], "open_level at 2^20 lanes: faster "
          "than its bound")
    del table, nxt, want, quot, want_quot
    torch.cuda.empty_cache()
    scan_fields = scan_kernel(log_k, log_t, dev, clock_hz, errors,
                              rand_words, blocker)[0]
    torch.cuda.empty_cache()
    twist_launches = first_launches["twist_bits"]
    at_shape = {k: first_shapes["twist_bits"][k].get((n_tables, 8, n), 0)
                for k in ("sum_of_products_round_evals", "fold")}
    at_shape["rlc"] = first_shapes["twist_bits"]["rlc"].get(
        (f_twist, 8, n), 0)
    at_shape["open_level"] = first_shapes["twist_bits"]["open_level"].get(
        (8, n), 0)
    at_shape["prefix_scan"] = first_shapes["twist_bits"]["prefix_scan"].get(
        (8, n), 0)
    check(all(at_shape.values()),
          f"the first paused TwistBits prove launched the round evaluations "
          f"and the fold on {n_tables} x 2^{log_t} lanes, the RLC on "
          f"{f_twist} x 2^{log_t}, an open level and the prefix scan on "
          f"2^{log_t}: "
          f"{at_shape}")
    shapes = {
        "sum_of_products_round_evals": {
            "tables": n_tables, "terms": len(term_idxs), "n": n,
            "npts": npts, "products_program": desc.products,
            "ms": sop_ms, "plain_ms": sop_plain_ms, "max_abs_err": sop_err,
            "bound_ms": sop_bound[0], "bound_by": sop_bound[1],
            "launches": twist_launches["sum_of_products_round_evals"],
            "launches_at_shape": at_shape["sum_of_products_round_evals"]},
        "fold": {
            "tables": n_tables, "n": n, "ms": fold_ms,
            "plain_ms": fold_plain_ms, "max_abs_err": fold_err,
            "bound_ms": fold_bound[0], "bound_by": fold_bound[1],
            "launches": twist_launches["fold"],
            "launches_at_shape": at_shape["fold"]},
        "rlc": {
            "tables": f_twist, "n": n, "ms": rlc_ms,
            "plain_ms": rlc_plain_ms, "max_abs_err": rlc_err,
            "bound_ms": rlc_bound[0], "bound_by": rlc_bound[1],
            "launches": twist_launches["rlc"],
            "launches_at_shape": at_shape["rlc"]},
        "open_level": {
            "n": n, "ms": level_ms, "plain_ms": level_plain_ms,
            "max_abs_err": level_err, "bound_ms": level_bound[0],
            "bound_by": level_bound[1],
            "launches": twist_launches["open_level"],
            "launches_at_shape": at_shape["open_level"]},
        "prefix_scan": {
            **scan_fields, "launches": twist_launches["prefix_scan"],
            "launches_at_shape": at_shape["prefix_scan"]},
    }
    fields = {"K": 1 << log_k, "T": 1 << log_t, "verified": True,
              "hazards": hazards, "inputs_s": inputs_s, "srs_s": srs_s,
              "srs_upload_s": upload_s,
              "srs_upload_fq_chain_launches":
                  upload_launches["fq_mont_mul_chain"],
              "turns": [who + ("" if paused else "_unpaused")
                        for who, paused in SCALE_TURNS],
              "proves": proves, "proves_s": proves_s,
              "kernels_at_scale": shapes,
              "phase_s": time.perf_counter() - t_phase}
    return fields, shapes, first_launches


def scan_kernel(log_k: int, log_t: int, dev, clock_hz: float, errors,
                rand_words, blocker) -> tuple:
    """The Val prefix scan (``prefix_scan``) on 2^log_t lanes of random
    words with write addresses of log_k bits, a third of the lanes
    written, as the j stack's V is built (weights from the 2^log_k-entry
    eq table of a random point), and the plain scan of the values (every
    flag set, a one-entry table of one), each against the plain version
    (canonical values equal); then the weighted scan timed by events over
    back-to-back calls and queued behind ``blocker``, its plain version
    once, and its bound: the written lanes' values, the addresses, the
    flags and the table read and V written once, and one product a
    written lane.  Returns (the shape's fields, (kernel ms, plain ms),
    queued ms, (bytes, products))."""
    from tnsh_torch.field import fr_kernels as K
    from tnsh_torch.field import limbs
    from tnsh_torch.poly.eq import eq_table

    import numpy as np

    n = 1 << log_t
    gen = np.random.default_rng(log_t)
    values = rand_words((8, n))
    addr = torch.from_numpy(gen.integers(0, 1 << log_k, n,
                                         dtype=np.int32)).to(dev)
    flags = torch.from_numpy(gen.random(n) < 1 / 3).to(dev)
    table = limbs.pack(eq_table(
        [int(x) for x in gen.integers(0, 1 << 62, log_k)]), dev)
    plain = (torch.zeros_like(addr), torch.ones_like(flags),
             limbs.scalar(1, dev))
    out, want = torch.empty_like(values), torch.empty_like(values)
    err = 0
    for weight, what in ((plain, "plain"), ((addr, flags, table), "eq")):
        K.prefix_scan(values, out, *weight)
        K.prefix_scan_plain(values, want, *weight)
        err = max(err, errors.compare_tensors(
            "prefix_scan", out, want,
            f"prefix scan, 2^{log_t} lanes, {what} weight"))

    def kernel():
        K.prefix_scan(values, out, addr, flags, table)

    writes = int(flags.sum())
    work = (writes * 32 + addr.numel() * 4 + flags.numel()
            + table.numel() * 4 + out.numel() * 4, writes)
    ms = (cuda_ms(kernel, 20),
          cuda_ms(lambda: K.prefix_scan_plain(values, want, addr, flags,
                                              table), 1))
    queued = queued_ms(kernel, 20, blocker)
    bound_ms, bound_by = bound(*work, clock_hz)
    check(min(ms[0], queued) >= bound_ms,
          f"prefix_scan at 2^{log_t} lanes: faster than its bound")
    fields = {"n": n, "log_k": log_k, "writes": writes, "ms": ms[0],
              "queued_ms": queued, "plain_ms": ms[1], "max_abs_err": err,
              "bound_ms": bound_ms, "bound_by": bound_by}
    return fields, ms, queued, work


#: log2 of the trace lengths phase 20 times the k round at
K_ROUND_LOG_TS = (16, 20)


def k_round_kernel(log_k: int, log_t: int, dev, clock_hz: float, errors,
                   rand_words, blocker) -> tuple:
    """Phase 20, one length: TwistBits' k rounds over ``bench_trace``'s
    columns at K=2^log_k, T=2^log_t, the five tables random words.  The
    bucket stack (``twist_k_buckets``), the round's sums at round 0 (with
    the lift) and at round 3 (after three binds, each a ``twist_k_bind``
    and a fold of the stack) and the binds' products against their plain
    versions on the same tensors; then the round kernel at round 0 timed
    by events and queued behind ``blocker``, its plain version once, the
    engine's ``tbk_round_evals`` (host ms, round 0 of an oracle on the
    CPU), and its bound: the products (3 a read, 8 a write, 1 a cycle for
    the lift) and the bytes (each cycle's address, flag and tables once,
    the bucket stack once).  Returns (the fields, (kernel ms, plain ms),
    queued ms, (bytes, products))."""
    import numpy as np

    from tnsh_torch.field import fr_kernels as K
    from tnsh_torch.iop.bits_oracle import TwistBitsSparseOracle
    from tnsh_torch.iop.twist_k_card import CHUNK
    from tnsh_torch.protocols.bit_columns import BitColumns
    from tnsh_torch.protocols.sound import _kinv
    from tnsh_torch.protocols.twist_bits import Fr

    n = 1 << log_t
    cols = BitColumns.from_trace(bench_trace(log_k, log_t))
    cols.marshal()
    ra, wa = (torch.from_numpy(a.astype(np.int32)).to(dev)
              for a in (cols.read_addr, cols.write_addr))
    flags = torch.from_numpy(cols.write_flags).to(dev)
    eq1, eqs, ic, wv, rv = (rand_words((8, n)) for _ in range(5))
    eqk = rand_words((8, 1 << log_k))
    chunk = min(CHUNK, n)
    what = f"k round, K=2^{log_k}, T=2^{log_t}"
    buckets = K.twist_k_buckets(ra, wa, flags, None, ic, eqk, chunk, 0)
    err = errors.compare_tensors(
        "twist_k_round", buckets.transpose(0, 1),
        K.twist_k_buckets_plain(ra, wa, flags, None, ic, eqk, chunk,
                                0).transpose(0, 1), what + ", buckets")

    def kernel():
        return K.twist_k_round(ra, wa, flags, None, eq1, eqs, ic, wv, rv,
                               buckets, chunk, 0)

    def plain():
        return K.twist_k_round_plain(ra, wa, flags, None, eq1, eqs, ic, wv,
                                     rv, buckets, chunk, 0)

    err = max(err, errors.compare_tensors("twist_k_round", kernel(), plain(),
                                          what + ", round 0"))
    amul, stack = None, buckets
    rng = random.Random(log_t)
    from tnsh_torch.field.fr import MODULUS as P
    for i in range(3):
        r = rng.randrange(P)
        want = K.twist_k_bind_plain(ra, wa, flags, amul, r, i)
        amul = K.twist_k_bind(ra, wa, flags, amul, r, i)
        err = max(err, errors.compare_tensors("twist_k_round", amul, want,
                                              f"{what}, bind {i}"))
        stack = K.fold(stack, r)
    err = max(err, errors.compare_tensors(
        "twist_k_round",
        K.twist_k_round(ra, wa, flags, amul, eq1, eqs, ic, wv, None, stack,
                        chunk, 3),
        K.twist_k_round_plain(ra, wa, flags, amul, eq1, eqs, ic, wv, None,
                              stack, chunk, 3), what + ", round 3"))
    del amul, stack
    ms = (cuda_ms(kernel, 20), cuda_ms(plain, 1))
    queued = queued_ms(kernel, 20, blocker)
    writes = int(flags.sum())
    reads = n - writes
    products = 3 * reads + 8 * writes + n
    work = (reads * (4 + 1 + 32) + writes * (4 + 1 + 3 * 32) + n * 2 * 32
            + buckets.numel() * 4, products)
    bound_ms, bound_by = bound(*work, clock_hz)
    check(min(ms[0], queued) >= bound_ms,
          f"twist_k_round at 2^{log_t}: faster than its bound")
    # the engine's round 0 on the same columns, on the host
    prng = random.Random(log_t)

    def pt(m):
        return [Fr(prng.randrange(P)) for _ in range(m)]

    oracle = TwistBitsSparseOracle(
        cols, rho1=pt(log_t), sigma_k=pt(log_k), sigma_j=pt(log_t),
        rhob=pt(log_t),
        alpha_powers=[prng.randrange(P) for _ in range(3 + 2 * log_k)],
        kinv=_kinv(log_k), degree=log_k + 3, device="cpu")
    try:
        t0 = time.perf_counter()
        oracle.round_evaluations(0)
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        oracle.release()
    fields = {"n": n, "log_k": log_k, "chunk": chunk, "writes": writes,
              "ms": ms[0], "queued_ms": queued, "plain_ms": ms[1],
              "tbk_round_evals_host_ms": host_ms, "max_abs_err": err,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "products": products}
    return fields, ms, queued, work


def plan_words(kind: str, n: int, seed: int, dev) -> torch.Tensor:
    """``(n, 8)`` int32 words of n scalars of a kind the main path
    commits: 0/1 bit columns (W = 4), ``bench_rw``'s values 42 i + 1
    (W = 8), full-width Fr (W = 32: the top word below the modulus')."""
    import numpy as np

    from tnsh_torch.field.fr import MODULUS as P

    gen = np.random.default_rng(seed)
    w = np.zeros((n, 8), dtype=np.uint32)
    if kind == "bits":
        w[:, 0] = gen.integers(0, 2, n)
    elif kind == "values":
        w[:, 0] = 42 * gen.integers(0, 1 << 20, n) + 1
    else:
        w[:] = gen.integers(0, 1 << 32, (n, 8), dtype=np.uint64)
        w[:, 7] %= P >> 224
    return torch.from_numpy(w.view(np.int32)).to(dev)


def plan_kernels(dev, clock_hz: float, errors, blocker) -> tuple:
    """Phase 19: ``msm_digits`` and ``msm_rank`` against their plain
    versions on the card (the digits and counts of ``signed_digits`` and
    ``digit_counts``, the schedule of ``build_schedule`` a chunk), at
    2^16 and 2^20 scalars of each kind, the schedule at the derived width;
    each timed by CUDA events (``ms``) and queued behind a long kernel
    (``queued_ms``) beside its byte bound.  Returns (the phase's fields,
    times, queued times, work) with the main row at 2^20 full-width
    scalars."""
    from tnsh_torch.commit import msm_sched as S

    width = S.resident_lanes(0)
    rows_out, times, dev_times, work = {}, {}, {}, {}
    for log_n in (16, 20):
        n = 1 << log_n
        m = S._choose_chunk(n)
        chunks = -(-n // m)
        valid = torch.ones(n, dtype=torch.uint8, device=dev)
        valid[11] = 0
        for seed, kind in enumerate(("bits", "values", "full")):
            what = f"{kind} scalars, 2^{log_n}"
            words = plan_words(kind, n, seed + log_n, dev)
            digits, stats = S.msm_digits(words, valid, m)
            want_d, want_s = S.msm_digits_plain(words, valid, m)
            errors.compare_ints("msm_digits", digits, want_d,
                                f"digits of {what}")
            errors.compare_ints("msm_digits", stats, want_s,
                                f"counts of {what}")
            del want_d, want_s
            plan = S.plan_of_stats(stats.cpu().numpy(), chunks, width)
            check(plan.w_count == {"bits": 4, "values": 8}.get(kind, 32),
                  f"{what}: the windows signed_digits gives")
            steps = torch.from_numpy(plan.rc_per_chunk)
            off = torch.cumsum(steps, 0, dtype=torch.int32) - steps
            rows = int(steps.sum())
            args = (digits, torch.from_numpy(plan.base_map).to(dev),
                    torch.from_numpy(plan.logk_map).to(dev), steps.to(dev),
                    off.to(dev), rows, m, width)
            sched = S.msm_rank(*args)
            errors.compare_ints("msm_rank", sched, S.msm_rank_plain(*args),
                                f"schedule of {what} at {width} lanes")
            check(int((sched != 0).sum()) == plan.digits,
                  f"{what}: the schedule holds every nonzero digit once")
            del sched
            digits_work = (n * 32 + n + digits.numel() + stats.numel() * 4,
                           0)
            rank_work = (plan.w_count * digits.shape[1]
                         + rows * width * 4 + 2 * plan.w_count * 129 * 4, 0)
            row = {"n": n, "m": m, "windows": plan.w_count, "lanes": width,
                   "rows": rows, "digits": plan.digits}
            for name, fn, plain, reps, bytes_ops in (
                    ("msm_digits", lambda: S.msm_digits(words, valid, m),
                     lambda: S.msm_digits_plain(words, valid, m), 20,
                     digits_work),
                    ("msm_rank", lambda: S.msm_rank(*args),
                     lambda: S.msm_rank_plain(*args), 20, rank_work)):
                ms = cuda_ms(fn, reps)
                queued = queued_ms(fn, reps, blocker)
                plain_ms = cuda_ms(plain, 1)
                bound_ms, bound_by = bound(*bytes_ops, clock_hz)
                check(min(ms, queued) >= bound_ms,
                      f"{name}, {what}: faster than its bound")
                row[name] = {"ms": ms, "queued_ms": queued,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by}
                if log_n == 20 and kind == "full":
                    times[name] = (ms, plain_ms)
                    dev_times[name] = queued
                    work[name] = bytes_ops
            rows_out[f"{kind}_2^{log_n}"] = row
            del digits, stats, args, words
            torch.cuda.empty_cache()
    return {"equal": True, "shapes": rows_out}, times, dev_times, work


def canonical_words(table: torch.Tensor) -> bytes:
    """An ``(8, N)`` Montgomery table's values as 32-byte LE words."""
    from tnsh_torch.field import fr_ops

    return fr_ops.canon(fr_ops.from_mont(table)).t().contiguous().cpu(
    ).numpy().tobytes()


def opening_kernels(log_k: int, log_t: int, dev, clock_hz: float, errors,
                    rand_raw, times: dict, dev_times: dict, work: dict,
                    blocker) -> dict:
    """Phase 2's openings: TwistBits' stack of 2 log K + 4 columns of
    2^log_t random words, uploaded as a prove uploads its committed
    columns (``ColumnStack``).  The RLC kernel over the whole stack and the
    open-level kernel on its table's first level are held limb for limb
    against their plain versions and timed there (the main path's
    shapes, into ``times``, ``dev_times`` and ``work``); the values of
    the stack, of TwistBits' second opening group (a gather) and of
    ShoutBits' log K + 1 columns, their RLC tables and the opening of the
    whole stack's table (value and every level's quotient words) against
    the host engine's bytes.  Returns the phase's fields."""
    from tnsh_torch import _native
    from tnsh_torch.commit.mkzg import ColumnStack, _device_quotients
    from tnsh_torch.field import fr_kernels as K
    from tnsh_torch.field import limbs
    from tnsh_torch.field.fr import MODULUS as P
    from tnsh_torch.field.fr import Fr, FrTable

    import numpy as np

    n = 1 << log_t
    f_twist = 2 * log_k + 4
    cols = [FrTable(rand_raw(n)) for _ in range(f_twist)]
    rng = random.Random(log_t)
    gamma = rng.randrange(P)
    point = [Fr(rng.randrange(P)) for _ in range(log_t)]
    t0 = time.perf_counter()
    stack = ColumnStack(cols, dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    groups = {"twist_bits": list(range(f_twist)),
              "twist_bits_s": list(range(log_k, 2 * log_k + 1))
              + [2 * log_k + 3],
              "shout_bits": list(range(log_k + 1))}
    for who, group in groups.items():
        sub = [cols[c] for c in group]
        check([int(v) for v in stack.evals(group, point)]
              == [int(v) for v in _native.fr_mle_eval_many(sub, point)],
              f"{who}: the stack's values at a point differ from the host "
              "engine's")
        check(canonical_words(stack.rlc(group, gamma))
              == _native.fr_rlc(sub, gamma),
              f"{who}: the RLC table differs from the host engine's")
    coeffs = torch.from_numpy(np.array(
        [limbs.mont_words(pow(gamma, i, P)) for i in range(f_twist)],
        dtype=np.uint32).view(np.int32)).to(dev)
    table = K.rlc(stack.stack, coeffs)
    plain = K.rlc_plain(stack.stack, coeffs)
    check(torch.equal(table, plain), "rlc: not limb for limb its plain "
          "version's")
    errors.compare_tensors("rlc", table, plain,
                           f"rlc, {f_twist} x 2^{log_t} lanes")
    del plain
    r = rng.randrange(P)
    quot = torch.empty((n // 2, limbs.NUM_LIMBS), dtype=torch.int32,
                       device=dev)
    want_quot = torch.empty_like(quot)
    nxt = K.open_level(table, r, quot)
    want_nxt = K.open_level_plain(table, r, want_quot)
    check(torch.equal(nxt, want_nxt) and torch.equal(quot, want_quot),
          "open_level: not limb for limb its plain version's")
    errors.compare_tensors("open_level", nxt, want_nxt,
                           f"open level, 2^{log_t} lanes")
    errors.compare_tensors("open_level", quot.t(), want_quot.t(),
                           f"open level quotients, 2^{log_t} lanes")
    value, levels = _device_quotients(table, point)
    want_value, want_levels = _native.fr_ml_open(
        FrTable(canonical_words(table)), point)
    # the levels of device MSMs stay on the card as (N, 8) word tensors
    levels = [lv.cpu().numpy().tobytes() if isinstance(lv, torch.Tensor)
              else lv for lv in levels]
    check(int(value) == int(want_value)
          and b"".join(levels) == b"".join(want_levels),
          "the opening of the RLC table differs from the host engine's")
    times["rlc"] = (cuda_ms(lambda: K.rlc(stack.stack, coeffs), 20),
                    cuda_ms(lambda: K.rlc_plain(stack.stack, coeffs), 1))
    dev_times["rlc"] = queued_ms(lambda: K.rlc(stack.stack, coeffs), 20,
                                 blocker)
    # each table read once, the coefficients, the one table written
    work["rlc"] = (stack.stack.numel() * 4 + coeffs.numel() * 4
                   + table.numel() * 4, f_twist * n)
    times["open_level"] = (
        cuda_ms(lambda: K.open_level(table, r, quot), 20),
        cuda_ms(lambda: K.open_level_plain(table, r, want_quot), 1))
    dev_times["open_level"] = queued_ms(
        lambda: K.open_level(table, r, quot), 20, blocker)
    # the table read, half of it written as the fold and half as the
    # quotients; two products a lane pair (the quotient's by 1, r's)
    work["open_level"] = (table.numel() * 4 * 2, n)
    del stack, table, nxt, want_nxt, quot, want_quot
    return {"columns": f_twist, "n": n, "equal": True,
            "host_engine_equal": list(groups), "upload_s": upload_s,
            "rlc_ms": times["rlc"][0], "open_level_ms": times["open_level"][0]}


def parse_cli_rates(text: str) -> dict:
    """Operations a second of the bench command line's sound and bits
    modes: the header's operations over each warm prove's milliseconds, by
    protocol and log K; fails unless every row says its proof verified."""
    rates = {}
    ops = int(re.search(r", (\d+) ops\) ===", text).group(1))
    for line in text.splitlines():
        cells = [c.strip() for c in line.split("|")]
        if len(cells) == 5 and cells[0] in ("Twist", "Shout") \
                and cells[1].isdigit():
            check(cells[4] == "True",
                  f"bench cli: {cells[0]} at log K {cells[1]} not verified")
            rates[f"{cells[0].lower()}_log{cells[1]}"] = \
                ops / (float(cells[2]) / 1e3)
    return rates


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
        shout_sound_proof_from_bytes,
        twist_proof_to_bytes,
        twist_sound_proof_from_bytes,
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
        shout_cube_terms,
        twist_cube_terms,
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

    # the main path's shape: the Montgomery conversion of one of phase A's
    # six host j tables (eq1, eq(sigma_j), eqb, rv, wv, ic), as each goes
    # up into its slot of the j stack
    xp = rand_words((8, 1 << 16))
    r2 = limbs.raw_planes(limbs.R2_MOD_P, dev)
    times["mont_mul_chain"] = (
        cuda_ms(lambda: K.mont_mul_chain(xp, r2, 1), 10),
        cuda_ms(lambda: K.mont_mul_chain_plain(xp, r2, 1), 2))
    dev_times["mont_mul_chain"] = queued_ms(
        lambda: K.mont_mul_chain(xp, r2, 1), 10, blocker)
    work["mont_mul_chain"] = (2 * xp.numel() * 4 + 32, xp.shape[1])
    errors.compare("mont_mul_chain", K.mont_mul_chain(xp, r2, 1),
                   K.mont_mul_chain_plain(xp, r2, 1), "to_mont 2^16")
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
    # the dense (k, j) cube's term structures (TNSH_BITS_DENSE) on a small
    # cube, K=2^10, T=2^4: TwistBits' 49 tables at npts 14 and the Shout
    # statement's 24 at npts 13, fold, and the eq(sigma) cube's product
    dense_descs = {}
    for who, cube_terms, npts_d in (("twist_bits", twist_cube_terms, 14),
                                    ("shout_bits", shout_cube_terms, 13)):
        d_terms = cube_terms(log_k, [1] * (3 + 2 * log_k), 1)
        d_desc = K.terms([t for _, t in d_terms], dev)
        d_coeffs = rand_words((8, len(d_terms)))
        d_tabs = rand_words((d_desc.num_tables, 8, 1 << (log_k + 4)))
        errors.compare(
            "sum_of_products_round_evals",
            K.sum_of_products_round_evals(d_tabs, d_coeffs, d_desc, npts_d),
            K.round_evals_plain(d_tabs, d_coeffs, d_desc, npts_d),
            f"{who} dense round evals N=2^{log_k + 4}")
        r = random.Random(npts_d).randrange(P)
        errors.compare("fold", K.fold(d_tabs, r), K.fold_plain(d_tabs, r),
                       f"{who} dense fold N=2^{log_k + 4}")
        dense_descs[who] = (d_desc, npts_d, len(d_terms))
    xe, ye = rand_words((8, 1 << (log_k + 4))), rand_words(
        (8, 1 << (log_k + 4)))
    errors.compare("mont_mul_chain", K.mont_mul_chain(xe, ye, 1),
                   K.mont_mul_chain_plain(xe, ye, 1), "eq cube 2^14")
    check((dense_descs["twist_bits"][0].num_tables,
           dense_descs["twist_bits"][2],
           dense_descs["shout_bits"][0].num_tables,
           dense_descs["shout_bits"][2]) == (49, 47, 24, 22),
          "the dense cube: 49 tables, 47 terms; 24 tables, 22 terms")
    openings = opening_kernels(log_k, log_t, dev, clock_hz, errors, rand_raw,
                               times, dev_times, work, blocker)
    scan, times["prefix_scan"], dev_times["prefix_scan"], \
        work["prefix_scan"] = scan_kernel(log_k, log_t, dev, clock_hz,
                                          errors, rand_words, blocker)
    phase(2, "kernels", equal=True, tables=n_tables,
          terms=len(term_idxs), products_unfactored=desc.products_unfactored,
          products_program=desc.products, program_ops=len(desc.program),
          program_stack_slots=desc.depth, sizes=rows, rounds=rounds,
          dense={who: {"tables": d.num_tables, "terms": nt, "npts": np_,
                       "products_program": d.products,
                       "products_unfactored": d.products_unfactored,
                       "program_stack_slots": d.depth,
                       "n_compared": 1 << (log_k + 4)}
                 for who, (d, np_, nt) in dense_descs.items()},
          openings=openings, prefix_scan=scan)

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
        # the timed MSM of each kind as a phase: its child spans split it
        msm_timer = PhaseTimer()
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
            with msm_timer.phase(name):
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
          **msm_rows, stage_seconds={k: v for k, v in msm_timer.phases.items()
                                     if "/" in k})

    # ---- phase 19: the MSM plan on the card --------------------------------
    plan_fields, plan_times, plan_dev_times, plan_work = plan_kernels(
        dev, clock_hz, errors, blocker)
    times.update(plan_times)
    dev_times.update(plan_dev_times)
    work.update(plan_work)
    phase(19, "plan", **plan_fields)

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
    hazards = kzg.hazard_count()
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
    # phase A folds the j stack at each j bind and the k phase's bucket
    # stack at each k bind but the last
    check(per["phase_a"]["fold"] == log_t + log_k - 1
          and per["k_rounds"]["fold"] == log_k - 1,
          f"phase_a: {log_t} + {log_k - 1} fold launches")
    check(per["phase_b"]["fold"] == log_t, f"phase_b: {log_t} fold launches")
    check(per["k_rounds"]["twist_k_round"] == log_k
          and timer.counters.get("k_device_rounds") == log_k,
          f"{log_k} k rounds on the card")
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
        s_err = errors.compare(
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
        "bound_ms": s_bound[0], "bound_by": s_bound[1],
        "max_abs_err": s_err}
    check(min(shout_shape["ms"], shout_shape["queued_ms"]) >= s_bound[0],
          "ShoutBits round evals: faster than their bound")
    del s_tabs, sbits

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
                "msm_insert_steps", "msm_tail", "rlc", "open_level"]
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
        lambda tm: ShoutBits.prove(s_tbl, pp, dev, tm), dev)
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
        lambda tm: ShoutBitsCommitted.prove(s_tbl, pp, dev, tm), dev)
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
        lambda tm: ShoutBitsCommitted.preprocess(s_entries, dev), dev)
    check(pre_routes == {"device": 1, "host": 0}
          and pre_launches["msm_tail"] == 1,
          "the table's commitment ran on the card")
    check(ShoutBitsCommitted.verify(cproof, t_comm, vp),
          "the verifier rejects the ShoutBitsCommitted proof")
    forged = dataclasses.replace(cproof, t_value=Fr(int(cproof.t_value) + 1))
    check(not ShoutBitsCommitted.verify(forged, t_comm, vp),
          "a ShoutBitsCommitted proof with a forged t_value verifies")
    hazards = kzg.hazard_count()
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
        v_err = errors.compare(
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
        "bound_ms": v_bound[0], "bound_by": v_bound[1],
        "max_abs_err": v_err}
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
        lambda tm: ShoutSound.prove(v_tbl, pp, dev, tm), dev)
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
    hazards = kzg.hazard_count()
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
        w_err = errors.compare(
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
        "bound_ms": w_bound[0], "bound_by": w_bound[1],
        "max_abs_err": w_err}
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
        lambda tm: TwistSound.prove(w_tr, pp, dev, tm), dev)
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
    hazards = kzg.hazard_count()
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
        p_err = errors.compare("product_round_evals",
                               K.product_round_evals(t1),
                               K.product_round_evals_plain(t1),
                               f"product evals, one factor, N={n}")
    p_run = lambda: K.product_round_evals(t1)  # noqa: E731
    p_work = product_work(t1)
    p_bound = bound(*p_work, clock_hz)
    parity_shape = {
        "factors": 1, "n": t1.shape[2], "npts": 4, "products": p_work[1],
        "ms": cuda_ms(p_run, 20), "queued_ms": queued_ms(p_run, 20, blocker),
        "plain_ms": cuda_ms(lambda: K.product_round_evals_plain(t1), 2),
        "bound_ms": p_bound[0], "bound_by": p_bound[1],
        "max_abs_err": p_err}
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
                lambda tm: prover.prove(x, sound_mode=sound, timer=tm), dev)
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
    hazards = kzg.hazard_count()
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

    # ---- phase 15: the mesh -------------------------------------------------
    # the unsharded oracles on the card over the phase's inputs first: their
    # proofs, their seconds, and the claims the ranks prove; then world 1 on
    # NCCL and world 2 over gloo, both on this card, each rank its block
    from tnsh_torch.core.proof_io import (
        sumcheck_d_proof_to_bytes,
        sumcheck_proof_to_bytes,
    )
    from tnsh_torch.core.transcript import Transcript
    from tnsh_torch.iop.sparse_oracle import SparseCubeOracle
    from tnsh_torch.iop.sumcheck import (
        SumCheck,
        TorchProductMLEOracle,
        TorchSumOfProductsOracle,
    )
    from tnsh_torch.iop.sumcheck_d import SumCheckD, TorchSopOracleD
    from tnsh_torch.parallel import mesh as M

    t15 = time.perf_counter()
    x15 = mesh_inputs(log_k, log_t, MESH_INPUTS_SEED)
    deg15 = x15["sopd_degree"]

    def on_card(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def digest(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()

    plain15 = {}   # name -> (proof digest, seconds) of the unsharded oracle
    claims = {}
    for name, num_vars, make in (
            ("sopd", log_t, lambda: TorchSopOracleD(
                log_t, x15["sopd"], deg15, device=dev)),
            ("sop", log_t, lambda: TorchSumOfProductsOracle(
                log_t, x15["sop"], device=dev)),
            ("product", log_t, lambda: TorchProductMLEOracle(
                x15["product"], device=dev)),
            ("cube", log_k + log_t, lambda: SparseCubeOracle(
                log_k, log_t, x15["cube"], device=dev))):
        probe = make()
        ev = probe.round_evaluations(0)
        claims[name] = int(ev[0] + ev[1])
        if hasattr(probe, "release"):
            probe.release()
        if name == "sopd":
            proof, secs = on_card(lambda: SumCheckD(
                num_vars, Fr(claims[name]), deg15).prove_with_challenges(
                    make(), Transcript(MESH_SEED))[0])
            plain15[name] = (digest(sumcheck_d_proof_to_bytes(proof)), secs)
        else:
            proof, secs = on_card(lambda: SumCheck(
                num_vars, Fr(claims[name])).prove(make(),
                                                  Transcript(MESH_SEED)))
            plain15[name] = (digest(sumcheck_proof_to_bytes(proof)), secs)
    full_srs = _native.srs_create_fixed_base(G1.generator(), x15["secrets"])
    want_msm, host_msm_s = on_card(
        lambda: _native.srs_msm(full_srs, x15["scalars"]))
    _native.srs_free(full_srs)
    full = torch.stack([limbs.pack(f.evaluations, dev)
                        for f in x15["product"]])
    want_evals = limbs.unpack(K.product_round_evals(full))
    folded_full = K.fold(full, x15["r"])
    del full

    def folded_digest(world: int, rank: int) -> str:
        per = folded_full.shape[-1] // world
        return digest(b"".join(
            v.to_bytes(32, "little")
            for t in folded_full[:, :, rank * per:(rank + 1) * per]
            for v in limbs.unpack(t)))

    reference_s = time.perf_counter() - t15
    worlds15 = {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.perf_counter()
        ranks = M.run_ranks(mesh_rank, world, "cuda:0", backend,
                            (log_k, log_t, MESH_INPUTS_SEED, claims))
        run_s = time.perf_counter() - t0
        for rank, res in enumerate(ranks):
            where = f"mesh world {world} rank {rank}"
            check(res["device"] == "cuda:0", f"{where}: not on the card")
            check(res["proofs"] == ranks[0]["proofs"],
                  f"{where}: its proofs differ from rank 0's")
            for name, want in (("sopd", "sopd"), ("sop_capNone", "sop"),
                               ("sop_cap8", "sop"), ("product", "product"),
                               ("cube", "cube")):
                check(res["proofs"][name] == plain15[want][0],
                      f"{where}: the sharded {name} proof differs from the "
                      "unsharded oracle's")
            check(res["msm"] == want_msm.to_affine()
                  and res["step"]["msm"] == want_msm.to_affine(),
                  f"{where}: the sharded MSM differs from the host MSM")
            check(res["step"]["evals"] == want_evals,
                  f"{where}: the step's round evaluations differ")
            check(res["step"]["folded"] == folded_digest(world, rank),
                  f"{where}: the step's folded block differs")
            check(res["hazards"] == 0, f"{where}: {res['hazards']} hazards")
            lc = res["launches"]
            for kernel in ("fold", "product_round_evals",
                           "sum_of_products_round_evals", "msm_insert_steps",
                           "msm_tail", "mont_mul_chain", "fq_mont_mul_chain"):
                check(lc[kernel] > 0, f"{where}: no {kernel} launch")
            check((lc["g1_padd"] > 0) == (world > 1),
                  f"{where}: {lc['g1_padd']} Jacobian adds of the partials")
        worlds15[world] = {
            "backend": backend, "spawn_to_results_s": run_s,
            "rank_wall_s": [r["wall_s"] for r in ranks],
            "sharded_s": {k: [r["s"][k] for r in ranks]
                          for k in ranks[0]["s"]},
            "collectives": [r["collectives"] for r in ranks],
            "collective_s": [r["collective_s"] for r in ranks],
            "psum_s": [r["psum_s"] for r in ranks],
            "launches": [r["launches"] for r in ranks],
            "proofs": ranks[0]["proofs"]}
    check(worlds15[1]["proofs"] == worlds15[2]["proofs"],
          "mesh: world 1 and world 2 prove different bytes")
    mesh_launches = {
        k: sum(c[k] for w in worlds15.values() for c in w["launches"])
        for k in worlds15[1]["launches"][0]}
    for w in worlds15.values():
        del w["proofs"]
    phase(15, "mesh", K=1 << log_k, T=1 << log_t, equal=True, hazards=0,
          unsharded_s={k: v[1] for k, v in plain15.items()},
          host_msm_s=host_msm_s, reference_s=reference_s,
          phase_s=time.perf_counter() - t15,
          **{f"world_{w}": v for w, v in worlds15.items()})

    # ---- phase 16: the dense (k, j) cube ------------------------------------
    # TwistBits, ShoutBits and ShoutBitsCommitted at K=2^10, T=2^14 (the
    # largest dense TwistBits cube one 80 GB card holds: 49 tables of 2^24
    # lanes, 26.3 GB, and the first fold's 13.2 GB), each proved on the
    # structured path and then with TNSH_BITS_DENSE set, counts set to 0
    # just before each prove
    t16 = time.perf_counter()
    log_t16 = 14
    n16 = log_k + log_t16
    tr16 = bench_trace(log_k, log_t16)
    tbl16 = bench_lookups(log_k, log_t16)
    t0 = time.perf_counter()
    setup_multilinear_params(log_t16)   # the PST SRS, cached per process
    srs16_s = time.perf_counter() - t0
    comm16 = ShoutBitsCommitted.preprocess(tbl16.entries, dev)
    provers16 = {
        "twist_bits": (lambda tm: TwistBits.prove(tr16, pp, dev, tm),
                       TwistBits.to_bytes,
                       lambda pf: TwistBits.verify(pf, vp)),
        "shout_bits": (lambda tm: ShoutBits.prove(tbl16, pp, dev, tm),
                       ShoutBits.to_bytes,
                       lambda pf: ShoutBits.verify(pf, tbl16.entries, vp)),
        "shout_bits_committed": (
            lambda tm: ShoutBitsCommitted.prove(tbl16, pp, dev, tm),
            ShoutBitsCommitted.to_bytes,
            lambda pf: ShoutBitsCommitted.verify(pf, comm16, vp)),
    }
    # the chain launches of cube_build: the Montgomery conversions of its
    # two packs (the T-lane columns in one, the K-lane table -- eq(sigma_k)
    # or the lookup table -- in the other), and TwistBits' eq(sigma) cube
    cube_chains = {"twist_bits": 2 + 1, "shout_bits": 2,
                   "shout_bits_committed": 2}
    dense16, dense_launches = {}, {}
    for name, (prove16, to_bytes16, verify16) in provers16.items():
        proof_s, s_s, s_timer, _, _, _ = counted(prove16, dev)
        os.environ["TNSH_BITS_DENSE"] = "1"
        try:
            proof_d, d_s, d_timer, d_launches, _, d_peak = counted(
                prove16, dev)
            d_max_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        finally:
            del os.environ["TNSH_BITS_DENSE"]
        check(to_bytes16(proof_d) == to_bytes16(proof_s),
              f"{name} K=2^10 T=2^14: the dense proof differs from the "
              "structured one")
        check(verify16(proof_s) and verify16(proof_d),
              f"{name} K=2^10 T=2^14: the verifier rejects a proof")
        per = d_timer.launches
        check(per["phase_a"]["sum_of_products_round_evals"] == n16
              and per["phase_a"]["fold"] == n16,
              f"{name} dense: {n16} round-evaluation and fold launches in "
              "phase A")
        check(per["cube_build"]["mont_mul_chain"] == cube_chains[name],
              f"{name} dense: {cube_chains[name]} chain launches in the "
              "cube build")
        check(all(d_launches[k] > 0 for k in (
            "mont_mul_chain", "fold", "sum_of_products_round_evals",
            "msm_insert_steps", "msm_tail", "rlc", "open_level")),
              f"{name} dense: every kernel of its path launched in it")
        check("oracle_a_build" not in d_timer.phases
              and "j_build" not in d_timer.phases,
              f"{name} dense: the structured oracle ran")
        stages = s_timer.phases
        dense_launches[name] = d_launches
        dense16[name] = {
            "proof_bytes": len(to_bytes16(proof_d)),
            "dense_prove_s": d_s, "structured_prove_s": s_s,
            "dense_stages_s": {k: d_timer.phases.get(k) for k in (
                "cube_build", "k_rounds", "j_rounds", "phase_a",
                "phase_b")},
            "structured_phase_a_s": sum(stages.get(k, 0.0) for k in (
                "oracle_a_build", "k_rounds", "j_build", "j_rounds")),
            "structured_stages_s": {k: stages.get(k) for k in (
                "oracle_a_build", "k_rounds", "j_build", "j_rounds",
                "phase_b")},
            "dense_launches": {k: d_launches[k] for k in (
                "mont_mul_chain", "fold", "sum_of_products_round_evals")},
            "dense_stage_launches": {k: per[k] for k in (
                "cube_build", "phase_a")},
            "dense_peak_above_live_gb": d_peak,
            "dense_max_memory_allocated_gb": d_max_gb}
    del proof_s, proof_d
    hazards = kzg.hazard_count()
    check(hazards == 0, f"{hazards} hazards among SRS bases: a bug")
    proves16_s = time.perf_counter() - t16

    # the kernels at the dense shapes, each held on its timed launch: the
    # 2^24 lanes are 256 tiles of the same 2^16 full-range random lanes,
    # and lane pairs (2i, 2i + 1) stay inside a tile, so the round
    # evaluations over the cube are 256 times the plain version's over one
    # tile, and the fold and the eq cube's product hold one tile's result
    # 256 times (every tile bitwise equal to the first, the first equal to
    # the plain version's): no plain run at 2^24
    torch.cuda.empty_cache()
    nd, plain_n = 1 << n16, 1 << 16
    n_tiles = nd // plain_n

    def tiles_agree(t, n):
        """Whether every ``n``-lane tile of ``t`` holds its first tile's
        words."""
        v = t.view(*t.shape[:-1], -1, n)
        return bool((v == v[..., :1, :]).all())

    dense_shapes = {}
    head = rand_words((49, 8, plain_n))
    big = head.repeat(1, 1, n_tiles)
    for who, n_tab in (("twist_bits", 49), ("shout_bits", 24)):
        d_desc, npts_d, nt = dense_descs[who]
        check(d_desc.num_tables == n_tab, f"{who}: {n_tab} dense tables")
        tabs, tabs_h = big[:n_tab], head[:n_tab]
        cf = rand_words((8, nt))
        d_ms, got = timed(lambda: K.sum_of_products_round_evals(
            tabs, cf, d_desc, npts_d), 3)
        d_err = errors.compare_values(
            "sum_of_products_round_evals", limbs.unpack(got),
            [n_tiles * v % P for v in limbs.unpack(K.round_evals_plain(
                tabs_h, cf, d_desc, npts_d))],
            f"{who} dense round evals over 2^24 lanes, against {n_tiles} "
            "times the plain version's over one tile")
        d_bound = bound(tabs.numel() * 4 + cf.numel() * 4 + npts_d * 32,
                        nd // 2 * npts_d * d_desc.products, clock_hz)
        dense_shapes[who] = {
            "tables": n_tab, "terms": nt, "n": nd, "npts": npts_d,
            "products_program": d_desc.products,
            "products_unfactored": d_desc.products_unfactored,
            "ms": d_ms, "max_abs_err": d_err, "plain_n": plain_n,
            "plain_ms": cuda_ms(lambda: K.round_evals_plain(
                tabs_h, cf, d_desc, npts_d), 1),
            "ms_at_plain_n": cuda_ms(lambda: K.sum_of_products_round_evals(
                tabs_h, cf, d_desc, npts_d), 5),
            "bound_ms": d_bound[0], "bound_by": d_bound[1],
            "launches": dense_launches[
                "twist_bits" if who == "twist_bits" else "shout_bits"][
                    "sum_of_products_round_evals"]}
        check(dense_shapes[who]["ms"] >= d_bound[0],
              f"{who} dense round evals: faster than their bound")
    del tabs, got
    r16 = random.Random(16).randrange(P)
    f_ms, folded = timed(lambda: K.fold(big, r16), 3)
    f_err = errors.compare("fold", folded[:, :, :plain_n // 2],
                           K.fold_plain(head, r16),
                           "dense fold, first tile of 2^24 lanes")
    check(tiles_agree(folded, plain_n // 2),
          "dense fold: a tile of the 2^24-lane fold differs from the first")
    f_bound = bound(big.numel() * 4 * 3 // 2, 49 * nd // 2, clock_hz)
    fold_dense = {
        "tables": 49, "n": nd, "ms": f_ms, "max_abs_err": f_err,
        "plain_n": plain_n,
        "plain_ms": cuda_ms(lambda: K.fold_plain(head, r16), 1),
        "ms_at_plain_n": cuda_ms(lambda: K.fold(head, r16), 5),
        "bound_ms": f_bound[0], "bound_by": f_bound[1],
        "launches": dense_launches["twist_bits"]["fold"]}
    check(fold_dense["ms"] >= f_bound[0], "dense fold: faster than its bound")
    del big, head, folded
    torch.cuda.empty_cache()
    xh, yh = rand_words((8, plain_n)), rand_words((8, plain_n))
    xe, ye = xh.repeat(1, n_tiles), yh.repeat(1, n_tiles)
    e_ms, prod = timed(lambda: K.mont_mul_chain(xe, ye, 1), 5)
    e_err = errors.compare("mont_mul_chain", prod[:, :plain_n],
                           K.mont_mul_chain_plain(xh, yh, 1),
                           "eq cube product, first tile of 2^24 lanes")
    check(tiles_agree(prod, plain_n),
          "eq cube product: a tile of 2^24 lanes differs from the first")
    e_bound = bound(3 * xe.numel() * 4, nd, clock_hz)
    eq_cube_shape = {
        "n": nd, "iters": 1, "ms": e_ms, "max_abs_err": e_err,
        "plain_n": plain_n,
        "plain_ms": cuda_ms(lambda: K.mont_mul_chain_plain(xh, yh, 1), 1),
        "bound_ms": e_bound[0], "bound_by": e_bound[1],
        "launches": sum(c["mont_mul_chain"] for c in dense_launches.values())}
    check(eq_cube_shape["ms"] >= e_bound[0],
          "eq cube product: faster than its bound")
    del xe, ye, prod
    torch.cuda.empty_cache()
    phase(16, "dense", K=1 << log_k, T=1 << log_t16, equal=True,
          verified=True, hazards=hazards, srs_s=srs16_s,
          proves_s=proves16_s, phase_s=time.perf_counter() - t16,
          **dense16, kernels_at_dense_shape={
              "round_evals": dense_shapes, "fold": fold_dense,
              "eq_cube_chain": eq_cube_shape})

    # ---- phase 17: the engine-free path -------------------------------------
    # ShoutSound and TwistSound at K=2^10, T=2^12 in a subprocess with
    # TNSH_NO_NATIVE=1 (host work in Python ints, the j phase and the MSMs
    # of 1024 points or more on the card, the engine never loaded), held
    # against the same proves with the engine in this process; then the
    # bench command line's modes on the card
    t17 = time.perf_counter()
    log_t17 = ENGINE_FREE_LOG_T
    here = os.path.dirname(os.path.abspath(__file__))
    child = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.engine_free_child("
         f"{log_k}, {log_t17}, 'cuda'))"],
        cwd=here, env={**os.environ, "TNSH_NO_NATIVE": "1"},
        capture_output=True, text=True, timeout=600)
    check(child.returncode == 0,
          f"the engine-free subprocess failed: {child.stderr[-3000:]}")
    free = json.loads(child.stdout.strip().splitlines()[-1])
    check(not free["native_loaded"],
          "the engine-free subprocess loaded the native engine")
    check(free["hazards"] == 0,
          f"{free['hazards']} hazards in the engine-free proves: a bug")
    pp4, vp4 = setup_params(4)
    t0 = time.perf_counter()
    cube_params(log_k, log_t17)
    setup_multilinear_params(log_t17)
    srs17_s = time.perf_counter() - t0
    engine17, free_launches = {}, {}
    tbl17, tr17 = sound_lookups(log_k, log_t17), sound_trace(log_k, log_t17)
    for name, prove, verify, to_bytes, from_bytes in (
            ("shout_sound",
             lambda tm: ShoutSound.prove(tbl17, pp4, dev, tm, sparse=True),
             lambda pf: ShoutSound.verify(pf, tbl17.entries, vp4),
             ShoutSound.to_bytes, shout_sound_proof_from_bytes),
            ("twist_sound",
             lambda tm: TwistSound.prove(tr17, pp4, dev, tm, sparse=True),
             lambda pf: TwistSound.verify(pf, vp4),
             TwistSound.to_bytes, twist_sound_proof_from_bytes)):
        got = free["provers"][name]
        proof, secs, timer, on_launches, routes, _ = counted(prove, dev)
        b = to_bytes(proof)
        check(got["sha256"] == hashlib.sha256(b).hexdigest()
              and bytes.fromhex(got["bytes"]) == b,
              f"{name}: the engine-free proof differs from the engine's")
        check(verify(proof) and verify(from_bytes(bytes.fromhex(
            got["bytes"]))), f"{name}: the verifier rejects a proof")
        for k in ("sum_of_products_round_evals", "fold", "msm_insert_steps",
                  "msm_tail"):
            check(got["launches"][k] > 0,
                  f"{name}: {k} did not launch on the engine-free path")
        check(got["launches"]["msm_tail"] == got["msm_routes"]["device"]
              and got["msm_routes"] == routes,
              f"{name}: engine-free MSMs by route {got['msm_routes']}, "
              f"with the engine {routes}")
        free_launches[name] = got["launches"]
        engine17[name] = {"prove_s": secs, "stages_s": timer.phases,
                          "launches": on_launches}
        del got["bytes"]
    hazards17 = kzg.hazard_count()
    check(hazards17 == 0, f"{hazards17} hazards in phase 17's proves with "
          "the engine: a bug")
    cli = {}
    for mode in CLI_MODES:
        size = [] if mode == "quick" else [
            "--min-log-size", str(log_k), "--max-log-size", str(log_k),
            "--operations", str(1 << log_t)]
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "tnsh_torch.bench.cli", mode, *size,
             "--device", "cuda"], cwd=here, capture_output=True, text=True,
            timeout=600)
        check(run.returncode == 0, f"bench cli {mode}: exit "
              f"{run.returncode}: {run.stdout[-2000:]} {run.stderr[-2000:]}")
        cli[mode] = {"rc": run.returncode, "s": time.perf_counter() - t0}
        if mode == "quick":
            check("Comparative Analysis" in run.stdout,
                  "bench cli quick: the suite did not finish")
            continue
        cli[mode]["ops_per_s"] = parse_cli_rates(run.stdout)
        check(len(cli[mode]["ops_per_s"]) == 2,
              f"bench cli {mode}: {cli[mode]['ops_per_s']}")
    phase(17, "engine_free", K=1 << log_k, T=1 << log_t17, equal=True,
          verified=True, native_loaded=False, hazards=free["hazards"],
          engine_free=free, engine=engine17, engine_srs_host_s=srs17_s,
          cli=cli, phase_s=time.perf_counter() - t17)

    # ---- phase 18: the bit-column tier at T=2^20 -----------------------------
    # TwistBits and ShoutBits at K=2^10, T=2^20 under the GC pause,
    # TwistBits also unpaused; the kernels at the prove's
    # largest shapes
    scale, scale_shapes, scale_launches = bits_at_scale(
        log_k, SCALE_LOG_T, dev, pp, vp, clock_hz, errors, rand_words,
        blocker)
    phase(18, "bits_at_scale", **scale)

    # ---- phase 20: TwistBits' k rounds on the card ---------------------------
    k_rounds = {}
    for lt in K_ROUND_LOG_TS:
        k_rounds[f"t{lt}"], times["twist_k_round"], \
            dev_times["twist_k_round"], work["twist_k_round"] = \
            k_round_kernel(log_k, lt, dev, clock_hz, errors, rand_words,
                           blocker)
        torch.cuda.empty_cache()
    phase(20, "k_round", **k_rounds)

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
    # whose place it takes, or, for rlc and open_level, the host engine's
    # call)
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
        # the openings' tables, which the JAX package computes on the host
        # engine: its gamma-RLC tables and its PST quotients
        "rlc": (fr_src, "tnsh/protocols/twist_bits.py:399"),
        "open_level": (fr_src, "tnsh/commit/mkzg.py:324"),
        # TwistBits' j-phase Val table, which the JAX package walks on the
        # host (no TPU kernel)
        "prefix_scan": (fr_src, "tnsh/iop/bits_oracle.py:272"),
        # the MSM's plan, which the JAX package makes on the host
        # (signed_digits and MsmPlan's counts) and in XLA (the one-hot
        # cumulative sum of the schedule)
        "msm_digits": (msm_src, "tnsh/commit/msm_sched.py:84"),
        "msm_rank": (msm_src, "tnsh/commit/msm_sched.py:648"),
        # TwistBits' k rounds, which the JAX package walks on the host
        # (no TPU kernel): the round's walk and its sum, timed at the
        # last of phase 20's lengths
        "twist_k_round": (fr_src, "tnsh/iop/bits_oracle.py:127"),
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
                  for who, counts in parity_launches.items()},
               "mesh": mesh_launches,
               # phase 16's three dense proves together
               "dense": {k: sum(c[k] for c in dense_launches.values())
                         for k in launches},
               # phase 17's two engine-free proves together
               "engine_free": {k: sum(c[k] for c in free_launches.values())
                               for k in launches},
               # phase 18's first paused prove of each prover at T=2^20
               "twist_bits_t20": scale_launches["twist_bits"],
               "shout_bits_t20": scale_launches["shout_bits"]}
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
        if name == "mont_mul_chain":
            kernels[-1]["eq_cube_shape"] = {**eq_cube_shape,
                                             "library_ms": None}
        if name == "fold":
            kernels[-1]["twist_bits_dense_shape"] = {**fold_dense,
                                                      "library_ms": None}
            kernels[-1]["twist_bits_t20_shape"] = {**scale_shapes["fold"],
                                                    "library_ms": None}
        if name in ("rlc", "open_level", "prefix_scan"):
            kernels[-1]["twist_bits_t20_shape"] = {**scale_shapes[name],
                                                    "library_ms": None}
        if name == "product_round_evals":
            kernels[-1]["twist_parity_sound_shape"] = {
                **parity_shape,
                "launches": parity_launches["twist"][1][name],
                "library_ms": None}
        if name == "sum_of_products_round_evals":
            kernels[-1].update(
                products_unfactored=desc.products_unfactored,
                products_program=desc.products,
                shout_bits_shape={
                    **shout_shape, "launches": sb_launches[name],
                    "library_ms": None},
                shout_sound_shape={
                    **sound_shape, "launches": ss_launches[name],
                    "library_ms": None},
                twist_sound_shape={
                    **twist_sound_shape, "launches": ts_launches[name],
                    "library_ms": None},
                twist_bits_dense_shape={
                    **dense_shapes["twist_bits"], "library_ms": None},
                shout_bits_dense_shape={
                    **dense_shapes["shout_bits"], "library_ms": None},
                twist_bits_t20_shape={
                    **scale_shapes["sum_of_products_round_evals"],
                    "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
