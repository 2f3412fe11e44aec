"""The provers' instruments on the CPU: the cyclic GC paused for the
length of a prove (``twist_bits._gc_paused``, counted across threads,
``TNSH_GC_PAUSE=0`` opts out), ``TNSH_PROFILE``'s stage lines against
tnsh's, ``PhaseTimer``'s split of ``open``, and the dense cube's size
check.  Tiny sizes throughout: these are control-flow checks, and the
proofs' bytes are held against tnsh by the provers' own test files."""

import functools
import gc
import os
import random
import re
import threading
from unittest import mock

import pytest
import torch

import tnsh_torch._native as _native
from tnsh.core.params import setup_params as ref_setup_params
from tnsh.field.fr import Fr as RefFr
from tnsh.protocols.twist import MemoryTrace as RefMemoryTrace
from tnsh.protocols.twist_bits import TwistBits as RefTwistBits
from tnsh_torch.commit.mkzg import MultilinearKZG
from tnsh_torch.core.params import setup_params
from tnsh_torch.errors import InvalidParametersError
from tnsh_torch.field.fr import Fr
from tnsh_torch.iop import bits_oracle
from tnsh_torch.iop.sumcheck_d import TorchSopOracleD
from tnsh_torch.protocols import twist_bits
from tnsh_torch.protocols.shout import LookupTable, Shout
from tnsh_torch.protocols.sound import ShoutSound, TwistSound
from tnsh_torch.protocols.twist import MemoryTrace, Twist
from tnsh_torch.protocols.twist_bits import (
    PROFILE_STAGES,
    ShoutBits,
    ShoutBitsCommitted,
    TwistBits,
)
from tnsh_torch.field import fr_kernels
from tnsh_torch.utils.profiling import (
    PhaseTimer,
    launch_counts,
    launch_shapes,
    reset_launch_counts,
)

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)


def _ops(size, n_ops, seed):
    """(is_write, address, value) triples: every third a write."""
    rng = random.Random(seed)
    return [(i % 3 == 0, rng.randrange(size), 42 * i + 1)
            for i in range(n_ops)]


def _trace(size, n_ops, seed, trace_cls=MemoryTrace, fr=Fr):
    tr = trace_cls(size)
    for is_write, addr, value in _ops(size, n_ops, seed):
        if is_write:
            tr.write(addr, fr(value))
        else:
            tr.read(addr)
    return tr


def _lookups(size, n_ops, seed):
    rng = random.Random(seed)
    tbl = LookupTable([Fr(3 * i + 1) for i in range(size)])
    for _ in range(n_ops):
        tbl.lookup(rng.randrange(size))
    return tbl


@pytest.fixture(scope="module")
def pp():
    return setup_params(4)[0]


def _dense(prove):
    """``prove`` on the dense (k, j)-cube path (TNSH_BITS_DENSE)."""
    def run(pp, tm):
        with mock.patch.dict(os.environ, {"TNSH_BITS_DENSE": "1"}):
            return prove(pp, tm)
    return run


def _twist_bits(pp, tm):
    return TwistBits.prove(_trace(8, 64, 3), pp, "cpu", tm)


def _shout_bits(pp, tm):
    return ShoutBits.prove(_lookups(8, 64, 4), pp, "cpu", tm)


#: the five provers tnsh pauses (the sound tier's on both paths, the bits
#: tier's TwistBits and ShoutBits on the dense path too): prove(pp, timer)
PAUSED = {
    "twist_bits": _twist_bits,
    "twist_bits_dense": _dense(_twist_bits),
    "shout_bits": _shout_bits,
    "shout_bits_dense": _dense(_shout_bits),
    "shout_bits_committed": lambda pp, tm: ShoutBitsCommitted.prove(
        _lookups(8, 64, 5), pp, "cpu", tm),
    "shout_sound_sparse": lambda pp, tm: ShoutSound.prove(
        _lookups(4, 16, 6), pp, "cpu", tm, sparse=True),
    "shout_sound_dense": lambda pp, tm: ShoutSound.prove(
        _lookups(4, 16, 6), pp, "cpu", tm, sparse=False),
    "twist_sound_sparse": lambda pp, tm: TwistSound.prove(
        _trace(4, 16, 7), pp, "cpu", tm, sparse=True),
    "twist_sound_dense": lambda pp, tm: TwistSound.prove(
        _trace(4, 16, 7), pp, "cpu", tm, sparse=False),
}

#: the parity provers, which tnsh does not pause
UNPAUSED = {
    "twist": lambda pp, tm: Twist(pp, "cpu").prove(
        _trace(8, 16, 8), sound_mode=True, timer=tm),
    "shout": lambda pp, tm: Shout(pp, "cpu").prove(
        _lookups(8, 16, 9), sound_mode=True, timer=tm),
}


class GcSeen(PhaseTimer):
    """A ``PhaseTimer`` that records ``gc.isenabled()`` as each phase
    opens and as it closes."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def phase(self, name):
        inner = super().phase(name)
        seen = self.seen

        class _Seen:
            def __enter__(self):
                seen.append((name, gc.isenabled()))
                return inner.__enter__()

            def __exit__(self, *exc):
                seen.append((name, gc.isenabled()))
                return inner.__exit__(*exc)

        return _Seen()


@pytest.fixture
def gc_on():
    """The collector enabled before the test, and again after it."""
    assert gc.isenabled()
    yield
    gc.enable()


@pytest.mark.parametrize("prover", sorted(PAUSED))
def test_collector_paused_in_every_phase(prover, pp, gc_on):
    timer = GcSeen()
    PAUSED[prover](pp, timer)
    assert len(timer.seen) >= 8
    assert not [s for s in timer.seen if s[1]]
    assert gc.isenabled()


@pytest.mark.parametrize("prover", sorted(UNPAUSED))
def test_parity_provers_not_paused(prover, pp, gc_on):
    timer = GcSeen()
    UNPAUSED[prover](pp, timer)
    assert timer.seen and all(on for _, on in timer.seen)


@pytest.mark.parametrize("prover", ["twist_bits", "twist_sound_sparse"])
def test_pause_opt_out(prover, pp, gc_on, monkeypatch):
    """TNSH_GC_PAUSE=0, read at call time, leaves the collector on."""
    monkeypatch.setenv("TNSH_GC_PAUSE", "0")
    timer = GcSeen()
    PAUSED[prover](pp, timer)
    assert timer.seen and all(on for _, on in timer.seen)


@pytest.mark.parametrize("prover", ["shout_bits", "shout_sound_sparse"])
def test_collector_the_caller_disabled_stays_disabled(prover, pp, gc_on):
    gc.disable()
    timer = GcSeen()
    PAUSED[prover](pp, timer)
    assert not gc.isenabled()
    assert not [s for s in timer.seen if s[1]]


@pytest.fixture
def native_handles(monkeypatch):
    """(created, live): the handles of the engine's k-phase states
    (``tbk``, ``sbk``, ``sco``) made so far, and those not yet freed,
    tracked through their create and free calls."""
    created, live = [], set()
    for kind in ("tbk", "sbk", "sco"):
        create = getattr(_native, f"{kind}_create")
        free = getattr(_native, f"{kind}_free")

        def tracked_create(*args, _create=create, _kind=kind, **kwargs):
            handle = _create(*args, **kwargs)
            created.append((_kind, handle))
            live.add((_kind, handle))
            return handle

        def tracked_free(handle, _free=free, _kind=kind):
            live.discard((_kind, handle))
            _free(handle)

        monkeypatch.setattr(_native, f"{kind}_create", tracked_create)
        monkeypatch.setattr(_native, f"{kind}_free", tracked_free)
    return created, live


@pytest.fixture
def device_oracles(monkeypatch):
    """Every ``TorchSopOracleD`` made so far: the j phases' and the dense
    cube's oracles, whose stacked tables ``release()`` drops."""
    made = []
    init = TorchSopOracleD.__init__

    def tracked_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(TorchSopOracleD, "__init__", tracked_init)
    return made


class Boom(RuntimeError):
    pass


def _raise(*args, **kwargs):
    raise Boom()


@pytest.mark.parametrize("where", ["open", "k_round"])
@pytest.mark.parametrize("prover", ["twist_bits", "shout_bits",
                                    "shout_bits_committed",
                                    "shout_sound_sparse",
                                    "twist_sound_sparse",
                                    "twist_bits_dense", "shout_bits_dense"])
def test_raising_prove_resumes_collector_and_frees_native_state(
        prover, where, pp, gc_on, native_handles, device_oracles,
        monkeypatch):
    """A prove that raises in its opening, or in its first k round while
    the engine's k-phase state (on the dense path: the cube's stack) is
    live, re-enables the collector, has freed every native handle it
    created and has released every device oracle it made."""
    created, live = native_handles
    if where == "open":
        monkeypatch.setattr(MultilinearKZG, "open", staticmethod(_raise))
    else:
        monkeypatch.setattr(bits_oracle._BitsOracle, "round_evaluations",
                            _raise)
    with pytest.raises(Boom):
        PAUSED[prover](pp, PhaseTimer())
    assert gc.isenabled()
    if prover.endswith("_dense"):    # the dense cube uses no engine state
        assert device_oracles and not created
    else:
        assert created
    assert not live
    assert all(o.tables is None for o in device_oracles)


def test_overlapping_proves_keep_collector_paused(pp, gc_on):
    """Prove A enters, prove B enters in another thread, A returns while
    B is still in flight: the collector stays paused until B returns."""
    a_in, b_in, a_done = (threading.Event() for _ in range(3))
    errors = []

    class Hold(PhaseTimer):
        def __init__(self, mine, wait_for):
            super().__init__()
            self.mine, self.wait_for = mine, wait_for

        def phase(self, name):
            if not self.mine.is_set():
                self.mine.set()
                if not self.wait_for.wait(60):
                    errors.append(f"{name}: timed out")
            return super().phase(name)

    def run(prove, timer):
        try:
            prove(pp, timer)
        except Exception as exc:   # reported by the test thread
            errors.append(repr(exc))

    a = threading.Thread(target=run, args=(PAUSED["shout_bits"],
                                           Hold(a_in, b_in)))
    b = threading.Thread(target=run, args=(PAUSED["twist_bits"],
                                           Hold(b_in, a_done)))
    a.start()
    assert a_in.wait(60)
    b.start()
    a.join(120)
    assert not a.is_alive()
    during = gc.isenabled()          # B is held in its first phase
    a_done.set()
    b.join(120)
    assert not b.is_alive()
    assert not errors
    assert during is False
    assert gc.isenabled()
    assert twist_bits._gc_in_flight == 0


def _profile_lines(text):
    return re.findall(r"^\[profile\] TwistBits\.prove/(\S+): [0-9.]+ s$",
                      text, flags=re.M)


@pytest.mark.parametrize("dense", [False, True])
def test_profile_lines_match_tnsh(dense, pp, capsys, monkeypatch):
    """TNSH_PROFILE=1: the port's TwistBits prints tnsh's nine stage names
    in tnsh's order, on the structured and the dense path (names only:
    the seconds differ); without the variable it prints none."""
    if dense:
        monkeypatch.setenv("TNSH_BITS_DENSE", "1")
    TwistBits.prove(_trace(8, 64, 11), pp, "cpu")
    assert _profile_lines(capsys.readouterr().err) == []
    monkeypatch.setenv("TNSH_PROFILE", "1")
    timer = PhaseTimer()
    TwistBits.prove(_trace(8, 64, 11), pp, "cpu", timer)
    port = _profile_lines(capsys.readouterr().err)
    RefTwistBits.prove(_trace(8, 64, 11, RefMemoryTrace, RefFr),
                       ref_setup_params(4)[0])
    ref = _profile_lines(capsys.readouterr().err)
    assert port == ref == list(PROFILE_STAGES)
    assert not timer.listeners


@pytest.mark.parametrize("prover", ["twist_bits", "shout_bits",
                                    "shout_bits_committed"])
def test_phase_timer_splits_open(prover, pp):
    """``open/evals`` and ``open/rlc`` are phases inside ``open``, once a
    prove each."""
    timer = PhaseTimer()
    PAUSED[prover](pp, timer)
    for inner in ("open/evals", "open/rlc"):
        assert timer.counts[inner] == 1
        assert timer.phases[inner] <= timer.phases["open"]
    assert (timer.phases["open/evals"] + timer.phases["open/rlc"]
            <= timer.phases["open"])


def test_phase_listeners_see_every_close():
    timer = PhaseTimer()
    heard = []
    timer.listeners.append(lambda name, s: heard.append((name, s)))
    with timer.phase("outer"):
        with timer.phase("inner"):
            pass
    assert [n for n, _ in heard] == ["inner", "outer"]
    assert [s for _, s in heard] == [timer.phases["inner"],
                                    timer.phases["outer"]]


def test_launch_shapes_count_by_input_shape():
    """A sum-check kernel's launch adds one to its count and to its input
    shape's; a reset clears both.  (A CPU tensor launches nothing, so the
    launch site's counter is called directly.)"""
    reset_launch_counts()
    try:
        for n in (8, 8, 4):
            fr_kernels._count(fr_kernels.fold, torch.empty((49, 8, n)))
        assert launch_counts()["fold"] == 3
        assert launch_shapes()["fold"] == {(49, 8, 8): 2, (49, 8, 4): 1}
        assert launch_shapes()["sum_of_products_round_evals"] == {}
    finally:
        reset_launch_counts()
    assert launch_counts()["fold"] == 0
    assert launch_shapes()["fold"] == {}


@pytest.mark.parametrize("n_tables, log_k, log_t", [
    (9 + 4 * 10, 10, 14), (4 + 2 * 10, 10, 14), (9 + 4 * 10, 10, 15)])
def test_dense_cube_size_check(n_tables, log_k, log_t):
    """The stack and its first fold, F 32 K T 1.5 bytes, against a stated
    free size: one byte short raises naming K, T and both sizes; enough
    passes.  On the CPU without a stated size nothing is checked."""
    need = n_tables * 32 * (1 << (log_k + log_t)) * 3 // 2
    twist_bits._check_cube_fits(n_tables, log_k, log_t, "cuda",
                                free_bytes=need)
    with pytest.raises(InvalidParametersError) as err:
        twist_bits._check_cube_fits(n_tables, log_k, log_t, "cuda",
                                    free_bytes=need - 1)
    msg = str(err.value)
    assert f"K=2^{log_k}, T=2^{log_t}" in msg
    assert str(need) in msg and str(need - 1) in msg
    twist_bits._check_cube_fits(n_tables, 30, 30, "cpu")


@pytest.mark.parametrize("prover", ["twist_bits", "shout_bits"])
def test_dense_prove_checks_the_cube_first(prover, pp, gc_on, monkeypatch):
    """A dense prove whose cube does not fit raises the port's error
    (here: against a stated free size of one byte), and resumes the
    collector."""
    monkeypatch.setenv("TNSH_BITS_DENSE", "1")
    monkeypatch.setattr(twist_bits, "_check_cube_fits", functools.partial(
        twist_bits._check_cube_fits, free_bytes=1))
    with pytest.raises(InvalidParametersError, match="dense cube"):
        PAUSED[prover](pp, PhaseTimer())
    assert gc.isenabled()


@pytest.mark.parametrize("prover", ["twist_bits", "shout_bits",
                                    "shout_sound_sparse",
                                    "twist_sound_sparse",
                                    "twist_bits_dense", "shout_bits_dense"])
def test_prove_leaves_no_tensor_in_a_cycle(prover, pp, gc_on):
    """What a prove allocates is freed by reference counting alone, so
    the paused collector holds no tensor back: after a prove, a
    collection finds no tensor among the objects it would free."""
    PAUSED[prover](pp, PhaseTimer())      # set-ups cached
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.disable()
        PAUSED[prover](pp, PhaseTimer())
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []
