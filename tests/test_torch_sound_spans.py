"""The sound tier's stages and spans on the CPU, on the sparse path: the
k phase's tables and the engine's state (``oracle_a_build``) apart from
the k rounds, as the bit-column provers stage them; TwistSound's
``commit/marshal`` and ``commit/scalars`` and its ``open/evals``,
``open/cube`` and ``open/rlc``, with the MSMs' spans still named after
the phase (``open/host_msm``), and ShoutSound's ``commit/scalars``,
``open/evals`` and ``open/cube``; the counter ``cube_entries``; the j
programs that ``proofbench/metrics/sound_round_evals_roofline.py`` and
``shout_sound_round_evals_roofline.py`` freeze; and proof bytes that stay
tnsh's.

K = 2^3, T = 2^6 with ``sparse=True``: every MSM is under 1024 points and
runs on the native host MSM."""

import functools
import random

import pytest
import torch

from tnsh.core.params import setup_params as ref_setup_params
from tnsh.core.proof_io import shout_sound_proof_to_bytes as ref_shout_bytes
from tnsh.core.proof_io import twist_sound_proof_to_bytes as ref_twist_bytes
from tnsh.field.fr import Fr as RefFr
from tnsh.protocols.shout import LookupTable as RefLookupTable
from tnsh.protocols.sound import ShoutSound as RefShoutSound
from tnsh.protocols.sound import TwistSound as RefTwistSound
from tnsh.protocols.twist import MemoryTrace as RefMemoryTrace
from tnsh_torch import _native
from tnsh_torch.core.params import setup_params
from tnsh_torch.core.transcript import Transcript
from tnsh_torch.field.fr import Fr
from tnsh_torch.iop.sparse_oracle import SparseCubeOracle
from tnsh_torch.protocols import sound
from tnsh_torch.protocols.shout import LookupTable
from tnsh_torch.protocols.sound import ShoutSound, TwistSound
from tnsh_torch.protocols.twist import MemoryTrace
from tnsh_torch.utils import profiling
from tnsh_torch.utils.profiling import PhaseTimer

torch.set_num_threads(1)

LOG_K, LOG_T = 3, 6


def _twist(trace_cls, fr):
    rng = random.Random(7)
    tr = trace_cls(1 << LOG_K)
    for i in range(1 << LOG_T):
        if i % 3 == 0:
            tr.write(rng.randrange(1 << LOG_K), fr(42 * i + 5))
        else:
            tr.read(rng.randrange(1 << LOG_K))
    return tr


def _shout(table_cls, fr):
    rng = random.Random(9)
    tbl = table_cls([fr(3 * i + 1) for i in range(1 << LOG_K)])
    for _ in range((1 << LOG_T) - 3):
        tbl.lookup(rng.randrange(1 << LOG_K))
    return tbl


#: (the port's prove with a timer, tnsh's proof bytes, the port's bytes)
PROVERS = {
    "twist_sound": (
        lambda pp, timer: TwistSound.prove(_twist(MemoryTrace, Fr), pp,
                                           "cpu", timer, sparse=True),
        lambda: ref_twist_bytes(RefTwistSound.prove(
            _twist(RefMemoryTrace, RefFr), ref_setup_params(4)[0],
            sparse=True)),
        TwistSound.to_bytes),
    "shout_sound": (
        lambda pp, timer: ShoutSound.prove(_shout(LookupTable, Fr), pp,
                                           "cpu", timer, sparse=True),
        lambda: ref_shout_bytes(RefShoutSound.prove(
            _shout(RefLookupTable, RefFr), ref_setup_params(4)[0],
            sparse=True)),
        ShoutSound.to_bytes),
}


@functools.lru_cache(maxsize=None)
def _proved(name):
    """One timed sparse prove, with the name of the phase open around
    each ``sco_create`` call."""
    prove, ref_bytes, to_bytes = PROVERS[name]
    created_in = []
    real = _native.sco_create

    def sco_create(*args, **kwargs):
        timer = profiling._current.get()
        created_in.append(timer.spans[timer._open[-1]].name)
        return real(*args, **kwargs)

    timer = PhaseTimer()
    _native.sco_create = sco_create
    try:
        proof = prove(setup_params(4)[0], timer)
    finally:
        _native.sco_create = real
    return name, timer, created_in, to_bytes(proof), ref_bytes


@pytest.fixture(params=sorted(PROVERS))
def proved(request):
    return _proved(request.param)


def _entries(timer, name):
    return [s for s in timer.spans if s.name == name]


def test_engine_state_is_built_apart_from_the_k_rounds(proved):
    """``sco_create`` runs inside ``oracle_a_build``, which closes before
    the first k round opens, and no k round builds anything."""
    _, timer, created_in, _, _ = proved
    assert created_in == ["oracle_a_build"]
    builds = _entries(timer, "oracle_a_build")
    rounds = _entries(timer, "k_rounds")
    assert builds and len(rounds) == 2 * LOG_K
    assert max(s.end for s in builds) <= min(s.start for s in rounds)
    assert all(s.fenced and s.parent is None for s in builds + rounds)
    order = [s.name for s in timer.spans if s.parent is None]
    stages = ["simulate", "srs", "commit", "oracle_a_build", "k_rounds",
              "j_build", "j_rounds", "open"]
    assert [n for i, n in enumerate(order)
            if n in stages and (i == 0 or order[i - 1] != n)] == stages


def test_twist_commit_and_open_spans():
    _, timer, _, _, _ = _proved("twist_sound")
    for child, phase in (("commit/marshal", "commit"),
                         ("commit/scalars", "commit"),
                         ("open/evals", "open"), ("open/cube", "open"),
                         ("open/rlc", "open")):
        assert timer.phases[child] <= timer.phases[phase]
        for s in _entries(timer, child):
            assert timer.spans[s.parent].name == phase
    assert timer.counts["commit/scalars"] == 4      # ra, wa, Inc, Val
    assert timer.counts["commit/marshal"] == 1
    assert not any(s.fenced for s in _entries(timer, "open/cube"))
    # the cube opening's MSMs keep the phase's name
    cube = _entries(timer, "open/cube")[0]
    inside = [s.name for s in timer.spans
              if s.parent is not None
              and timer.spans[s.parent] is cube]
    assert inside and set(inside) == {"open/host_msm"}
    assert not [k for k in timer.phases if k.startswith("open/cube/")]


def test_shout_commit_and_open_spans():
    """ShoutSound's sparse path: ra's column scalars once in ``commit``;
    ``open/evals`` (ra's sparse and rv's evaluations) and ``open/cube``
    (ra's j-first opening, unfenced, its MSMs under the phase's name)
    inside ``open``; no ``open/rlc`` (two openings, no gamma-RLC)."""
    _, timer, _, _, _ = _proved("shout_sound")
    for child, phase in (("commit/scalars", "commit"),
                         ("open/evals", "open"), ("open/cube", "open")):
        assert timer.phases[child] <= timer.phases[phase]
        for s in _entries(timer, child):
            assert timer.spans[s.parent].name == phase
    assert timer.counts["commit/scalars"] == 1      # ra
    assert timer.counts["open/evals"] == timer.counts["open/cube"] == 1
    assert "commit/marshal" not in timer.phases
    assert "open/rlc" not in timer.phases
    assert not any(s.fenced for s in _entries(timer, "open/cube"))
    # the cube opening's MSMs keep the phase's name
    cube = _entries(timer, "open/cube")[0]
    inside = [s.name for s in timer.spans
              if s.parent is not None
              and timer.spans[s.parent] is cube]
    assert inside and set(inside) == {"open/host_msm"}
    assert not [k for k in timer.phases if k.startswith("open/cube/")]


def test_cube_entries_counts_the_witness(proved):
    name, timer, _, _, _ = proved
    if name != "twist_sound":
        assert "cube_entries" not in timer.counters
        return
    ops = list(_twist(MemoryTrace, Fr).operations)
    ra, wa, inc, val, *_ = sound._twist_witness(ops, LOG_K, LOG_T)
    want = (sum(map(len, ra.cols)) + sum(map(len, wa.cols))
            + sum(map(len, inc.cols)) + sum(map(len, val.updates)))
    writes = sum(op.is_write for op in ops)
    assert (timer.counters["cube_entries"] == want
            == (1 << LOG_T) + 2 * writes)


def test_bytes_equal_tnsh(proved):
    _, _, _, data, ref_bytes = proved
    assert data == ref_bytes()


def test_twist_j_program_is_the_frozen_one():
    """The j phase of TwistSound: 16 stacked tables, 18 terms, 29 products
    a lane pair and point (41 multiplied out), 4 points a round."""
    ops = list(_twist(MemoryTrace, Fr).operations)
    witness = sound._twist_witness(ops, LOG_K, LOG_T)
    tr = Transcript(setup_params(4)[0].fiat_shamir_seed)
    ch = sound._twist_challenges(tr, LOG_K, LOG_T)
    oracle = SparseCubeOracle(LOG_K, LOG_T, sound._twist_sparse_terms(
        LOG_K, LOG_T, witness, ch), device="cpu")
    try:
        for rd in range(LOG_K + 1):
            oracle.round_evaluations(rd)
            oracle.bind(Fr(rd + 11))
        delegate = oracle._delegate
        assert tuple(delegate.tables.shape) == (16, 8, 1 << (LOG_T - 1))
        assert len(delegate._idxs) == 18
        assert delegate._desc.products == 29
        assert delegate._desc.products_unfactored == 41
        assert delegate.degree + 1 == 4
    finally:
        oracle.release()



def test_shout_j_program_is_the_frozen_one(monkeypatch):
    """The j phase a sparse ShoutSound prove hands the round kernels,
    which ``proofbench/metrics/shout_sound_round_evals_roofline.py``
    freezes: 5 stacked tables, 6 terms, 8 products a lane pair and point
    (12 multiplied out), 4 points a round."""
    built = []
    real = SparseCubeOracle._build_delegate

    def build(self):
        real(self)
        d = self._delegate
        built.append((tuple(d.tables.shape), len(d._idxs), d._desc.products,
                      d._desc.products_unfactored, d.degree + 1))

    monkeypatch.setattr(SparseCubeOracle, "_build_delegate", build)
    ShoutSound.prove(_shout(LookupTable, Fr), setup_params(4)[0], "cpu",
                     sparse=True)
    assert built == [((5, 8, 1 << LOG_T), 6, 8, 12, 4)]
