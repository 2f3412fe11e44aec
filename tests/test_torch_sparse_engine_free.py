"""The port's engine-free mode (``TNSH_NO_NATIVE``) against its engine
and against tnsh, on the CPU.

* The factorized cube helpers (``commit_sparse``, ``commit_incremental``,
  ``sparse_mle_eval``, ``incremental_mle_eval``, ``open_combined``) give
  the values and group elements of tnsh's Python branch and of the port's
  engine branch on the same seeded tables.
* Every prover of the port proves without the engine, to the bytes it
  proves with it, after the engine's set-ups of the same sizes were cached
  in the process; ``tnsh_torch._native._load`` raises throughout, so a
  single reach into the engine fails the case.
* The set-up caches serve each mode its own set-up; the MSM plan's
  numpy digit counts equal the engine's.
* ``PhaseTimer.phase_report()`` has tnsh's keys and counts.

Field elements cross between the packages as ints, group elements as
compressed bytes."""

import contextlib
import random

import numpy as np
import pytest
import torch

import tnsh_torch._native as _native
from tnsh.commit import mkzg_sparse as ref_sparse
from tnsh.core.serialize import g1_to_bytes as ref_g1_to_bytes
from tnsh.field.fr import Fr as RefFr
from tnsh.utils.profiling import PhaseTimer as RefPhaseTimer
from tnsh_torch.commit import kzg, mkzg_sparse, msm_sched
from tnsh_torch.commit.mkzg import (
    multilinear_verification_key,
    setup_multilinear_params,
)
from tnsh_torch.core.params import NativeSRS, setup_params
from tnsh_torch.core.proof_io import (
    shout_proof_to_bytes,
    twist_proof_to_bytes,
)
from tnsh_torch.core.serialize import g1_to_bytes, g2_to_bytes
from tnsh_torch.field.fr import MODULUS as P
from tnsh_torch.field.fr import Fr
from tnsh_torch.protocols.shout import LookupTable, Shout
from tnsh_torch.protocols.sound import ShoutSound, TwistSound
from tnsh_torch.protocols.twist import MemoryTrace, Twist
from tnsh_torch.protocols.twist_bits import (
    ShoutBits,
    ShoutBitsCommitted,
    TwistBits,
)
from tnsh_torch.utils.profiling import PhaseTimer

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)


def _engine_refused():
    raise RuntimeError("the native engine was reached under TNSH_NO_NATIVE")


@pytest.fixture
def engine_free(monkeypatch):
    """A context that switches the engine off and makes any reach into it
    raise; leaving it switches the engine on again."""
    @contextlib.contextmanager
    def switched_off():
        with monkeypatch.context() as m:
            m.setenv("TNSH_NO_NATIVE", "1")
            m.setattr(_native, "_load", _engine_refused)
            yield

    return switched_off


# ---------------------------------------------------------------------------
# The factorized cube helpers
# ---------------------------------------------------------------------------

def _rand_fe(rng) -> int:
    return int.from_bytes(rng.bytes(32), "little") % P


def _cube_tables(log_k, log_t, seed):
    """Two column-sparse tables (one a one-hot, one with two or three
    entries a column, same-pair ones among them) and one incremental
    table, as (position, value) entries from a numpy generator."""
    rng = np.random.default_rng(seed)
    k_size, t_size = 1 << log_k, 1 << log_t
    onehot = [[(int(rng.integers(k_size)), 1)] for _ in range(t_size)]
    multi = []
    for j in range(t_size):
        k0 = int(rng.integers(k_size))
        col = [(k0, _rand_fe(rng)), (k0 ^ 1 if k_size > 1 else k0,
                                    _rand_fe(rng))]
        if j % 2:
            col.append((int(rng.integers(k_size)), _rand_fe(rng)))
        multi.append(col)
    inc = [[(int(rng.integers(k_size)), _rand_fe(rng))] if j % 3 else []
           for j in range(t_size)]
    point = [_rand_fe(rng) for _ in range(log_k + log_t)]
    coeffs = [_rand_fe(rng) for _ in range(3)]
    return onehot, multi, inc, point, coeffs


def _build(mod, log_k, log_t, onehot, multi, inc):
    tabs = []
    for cols in (onehot, multi):
        t = mod.SparseCubeTable(log_k, log_t)
        for j, col in enumerate(cols):
            for k, v in col:
                t.set(j, k, v)
        tabs.append(t)
    t = mod.IncrementalCubeTable(log_k, log_t)
    for j, ups in enumerate(inc):
        for k, d in ups:
            t.add_update(j, k, d)
    tabs.append(t)
    return tabs


def _port_helper(helper, log_k, log_t, data):
    """The port's helper on fresh tables; group elements as bytes."""
    onehot, multi, inc, point, coeffs = data
    sp1, sp2, val = _build(mkzg_sparse, log_k, log_t, onehot, multi, inc)
    pt = [Fr(x) for x in point]
    cp = mkzg_sparse.cube_params(log_k, log_t)
    if helper == "commit_sparse":
        return g1_to_bytes(mkzg_sparse.commit_sparse(cp, sp2, "cpu")
                           .commitment)
    if helper == "commit_incremental":
        return g1_to_bytes(mkzg_sparse.commit_incremental(cp, val, "cpu")
                           .commitment)
    if helper == "sparse_mle_eval":
        return int(mkzg_sparse.sparse_mle_eval(sp2, pt))
    if helper == "incremental_mle_eval":
        return int(mkzg_sparse.incremental_mle_eval(val, pt))
    value, proof = mkzg_sparse.open_combined(
        cp, [(coeffs[0], sp1), (coeffs[1], sp2)], [(coeffs[2], val)], pt,
        "cpu")
    return int(value), [g1_to_bytes(q) for q in proof.quotients]


def _ref_helper(helper, log_k, log_t, data):
    """tnsh's helper (its Python branch under TNSH_NO_NATIVE)."""
    onehot, multi, inc, point, coeffs = data
    sp1, sp2, val = _build(ref_sparse, log_k, log_t, onehot, multi, inc)
    pt = [RefFr(x) for x in point]
    cp = ref_sparse.cube_params(log_k, log_t)
    if helper == "commit_sparse":
        return ref_g1_to_bytes(ref_sparse.commit_sparse(cp, sp2).commitment)
    if helper == "commit_incremental":
        return ref_g1_to_bytes(ref_sparse.commit_incremental(cp, val)
                               .commitment)
    if helper == "sparse_mle_eval":
        return int(ref_sparse.sparse_mle_eval(sp2, pt))
    if helper == "incremental_mle_eval":
        return int(ref_sparse.incremental_mle_eval(val, pt))
    value, proof = ref_sparse.open_combined(
        cp, [(coeffs[0], sp1), (coeffs[1], sp2)], [(coeffs[2], val)], pt)
    return int(value), [ref_g1_to_bytes(q) for q in proof.quotients]


@pytest.mark.parametrize("shape", [(3, 5), (0, 3)])
@pytest.mark.parametrize("helper", ["commit_sparse", "commit_incremental",
                                    "sparse_mle_eval", "incremental_mle_eval",
                                    "open_combined"])
def test_cube_helpers_equal_engine_and_tnsh(helper, shape, engine_free,
                                            monkeypatch):
    log_k, log_t = shape
    monkeypatch.setattr(kzg, "DEVICE_MSM_MIN", 1 << 62)
    data = _cube_tables(log_k, log_t, seed=17 * log_k + log_t)
    want = _port_helper(helper, log_k, log_t, data)   # the engine's
    with engine_free():
        got = _port_helper(helper, log_k, log_t, data)
        ref = _ref_helper(helper, log_k, log_t, data)
    assert got == want
    assert got == ref


# ---------------------------------------------------------------------------
# Every prover, with the engine and without it
# ---------------------------------------------------------------------------

def _trace(size, n_ops, seed):
    rng = random.Random(seed)
    tr = MemoryTrace(size)
    for i in range(n_ops):
        if i % 3 == 0:
            tr.write(rng.randrange(size), Fr(42 * i + 1))
        else:
            tr.read(rng.randrange(size))
    return tr


def _lookups(size, n_ops, seed):
    rng = random.Random(seed)
    tbl = LookupTable([Fr(3 * i + 1) for i in range(size)])
    for _ in range(n_ops):
        tbl.lookup(rng.randrange(size))
    return tbl


#: prover -> prove(pp) giving the proof's bytes, at a tiny size
PROVERS = {
    "twist_bits": lambda pp: TwistBits.to_bytes(
        TwistBits.prove(_trace(8, 64, 3), pp, "cpu")),
    "shout_bits": lambda pp: ShoutBits.to_bytes(
        ShoutBits.prove(_lookups(8, 64, 4), pp, "cpu")),
    "shout_bits_committed": lambda pp: ShoutBitsCommitted.to_bytes(
        ShoutBitsCommitted.prove(_lookups(8, 64, 5), pp, "cpu")),
    "shout_sound_sparse": lambda pp: ShoutSound.to_bytes(
        ShoutSound.prove(_lookups(4, 16, 6), pp, "cpu", sparse=True)),
    "shout_sound_dense": lambda pp: ShoutSound.to_bytes(
        ShoutSound.prove(_lookups(4, 16, 6), pp, "cpu", sparse=False)),
    "twist_sound_sparse": lambda pp: TwistSound.to_bytes(
        TwistSound.prove(_trace(4, 16, 7), pp, "cpu", sparse=True)),
    "twist_sound_dense": lambda pp: TwistSound.to_bytes(
        TwistSound.prove(_trace(4, 16, 7), pp, "cpu", sparse=False)),
    "twist": lambda pp: twist_proof_to_bytes(
        Twist(pp, "cpu").prove(_trace(8, 16, 8))),
    "twist_sound_mode": lambda pp: twist_proof_to_bytes(
        Twist(pp, "cpu").prove(_trace(8, 16, 8), sound_mode=True)),
    "shout": lambda pp: shout_proof_to_bytes(
        Shout(pp, "cpu").prove(_lookups(8, 16, 9))),
    "shout_sound_mode": lambda pp: shout_proof_to_bytes(
        Shout(pp, "cpu").prove(_lookups(8, 16, 9), sound_mode=True)),
}


@pytest.mark.parametrize("prover", sorted(PROVERS))
def test_prover_proves_without_engine(prover, engine_free):
    """The engine's prove first (it caches the set-ups of these sizes),
    then the same prove with the engine switched off and refused: it must
    not be served the engine's set-ups, and it proves the same bytes."""
    prove = PROVERS[prover]
    want = prove(setup_params(4)[0])
    with engine_free():
        got = prove(setup_params(4)[0])
    assert got == want


# ---------------------------------------------------------------------------
# Set-up caches and the MSM plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("setup", ["setup_params", "setup_multilinear_params",
                                   "cube_params", "verification_key"])
def test_setup_caches_keyed_on_the_mode(setup, engine_free):
    """Each mode gets its own cached set-up: engine handles with the
    engine, lists of points without it; the group elements are equal."""
    build, segments, g2s = {
        "setup_params": (lambda: setup_params(3),
                         lambda o: [o[0].commitment_params.g1_powers],
                         lambda o: [o[1].commitment_vk.g2_tau]),
        "setup_multilinear_params": (lambda: setup_multilinear_params(4),
                                     lambda o: o[0].basis,
                                     lambda o: o[1].g2_taus),
        "cube_params": (lambda: mkzg_sparse.cube_params(2, 3),
                        lambda o: list(o.j_bases) + list(o.k_bases),
                        lambda o: o.vk.g2_taus),
        "verification_key": (lambda: multilinear_verification_key(5),
                             lambda o: [],
                             lambda o: o.g2_taus),
    }[setup]
    with_engine = build()
    with engine_free():
        without = build()
        assert without is build()            # cached in this mode
        segs = segments(without)
        assert not any(isinstance(s, NativeSRS) for s in segs)
        free_g1 = [[g1_to_bytes(p) for p in s] for s in segs]
        free_g2 = [g2_to_bytes(q) for q in g2s(without)]
    assert without is not with_engine
    assert [[g1_to_bytes(p) for p in s] for s in segments(with_engine)] \
        == free_g1
    assert [g2_to_bytes(q) for q in g2s(with_engine)] == free_g2


@pytest.mark.parametrize("n", [700, 4096])
def test_msm_plan_counts_without_engine(n, engine_free):
    """The plan's (chunk, window, |digit|) counts by numpy give the plan
    the engine's counting loop gives: every field equal."""
    rng = np.random.default_rng(n)
    scalars = [_rand_fe(rng) for _ in range(n)]
    scalars[: n // 4] = [7] * (n // 4)       # a heavy group
    m = msm_sched._choose_chunk(n)
    sb = msm_sched.scalars_to_byte_matrix(scalars, n)
    digits = msm_sched.signed_digits(sb)
    d = np.zeros((digits.shape[0], -(-n // m) * m), dtype=np.int8)
    d[:, :n] = digits
    want = msm_sched.MsmPlan(d, m, 4096)
    with engine_free():
        got = msm_sched.MsmPlan(d, m, 4096)
    assert vars(got).keys() == vars(want).keys()
    for key, value in vars(want).items():
        assert np.array_equal(vars(got)[key], value), key


def test_host_msm_route_honours_the_mode(engine_free):
    """``kzg.msm``'s host route over explicit points takes the
    pure-Python MSM under TNSH_NO_NATIVE, to the engine's element."""
    from tnsh_torch.field.g1 import G1

    g = G1.generator()
    points = [g.scalar_mul(i + 2) for i in range(9)]
    scalars = [Fr(3 * i + 5) for i in range(9)]
    want = g1_to_bytes(kzg.msm(points, scalars, "cpu"))
    assert want == g1_to_bytes(kzg.host_msm(points, scalars, native=False))
    with engine_free():
        got = g1_to_bytes(kzg.msm(points, scalars, "cpu"))
    assert got == want


# ---------------------------------------------------------------------------
# PhaseTimer's report
# ---------------------------------------------------------------------------

def test_phase_report_matches_tnsh():
    """The same sequence of phases gives tnsh's keys and counts; ``fence``
    takes values."""
    timers = (PhaseTimer(), RefPhaseTimer())
    for t in timers:
        for name in ("a", "b", "a", "c", "a"):
            with t.phase(name):
                t.fence(torch.zeros(2), torch.ones(1))
    port, ref = (t.phase_report() for t in timers)
    assert port.keys() == ref.keys() == {"a", "b", "c"}
    for name in port:
        assert port[name].keys() == ref[name].keys()
        assert port[name]["count"] == ref[name]["count"]
        assert port[name]["total_s"] == timers[0].phases[name]
        assert port[name]["mean_ms"] == pytest.approx(
            port[name]["total_s"] / port[name]["count"] * 1e3)
    assert port["a"]["count"] == 3


@pytest.mark.parametrize("prover", ["shout_sound_sparse", "twist_bits"])
def test_phase_report_of_a_prove_holds_every_stage(prover):
    """A timed prove's report holds every stage it timed, the MSM stage
    split's included, each entered at least once."""
    timer = PhaseTimer()
    pp = setup_params(4)[0]
    if prover == "twist_bits":
        TwistBits.prove(_trace(8, 64, 3), pp, "cpu", timer)
    else:
        ShoutSound.prove(_lookups(4, 16, 6), pp, "cpu", timer, sparse=True)
    report = timer.phase_report()
    assert report.keys() == timer.phases.keys()
    assert {"commit", "open", "commit/host_msm", "open/host_msm",
            "j_rounds"} <= report.keys()
    assert all(rep["count"] >= 1 for rep in report.values())
