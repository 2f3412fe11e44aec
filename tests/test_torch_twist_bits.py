"""The port's TwistBits against tnsh's: byte-identical proofs, and each
package's verifier accepts the other's bytes, on the CPU (the plain
PyTorch versions of the kernels) and, marked ``cuda``, on the card at the
README's K=2^10 sizes.  Mirrors ``tests/test_twist_bits.py``, including
its frozen wire-v3 digest.

The two packages share no objects: each gets its own trace, parameters and
native engine (their handle tables are separate), and proofs cross over
only as bytes.  At T = 2^11 the port's commitments and the large MSMs of
its openings run through its scheduled Pippenger (plain versions)."""

import dataclasses
import hashlib
import os
import random
import subprocess
import sys
import time

import pytest
import torch

import tnsh_torch._native as _native
from tnsh.commit import kzg as ref_kzg
from tnsh.commit.mkzg import setup_multilinear_params as ref_ml_params
from tnsh.core.params import setup_params as ref_setup_params
from tnsh.core.proof_io import (
    twist_bits_proof_from_bytes as ref_from_bytes,
    twist_bits_proof_to_bytes as ref_to_bytes,
)
from tnsh.field.fr import Fr as RefFr
from tnsh.protocols.twist import MemoryTrace as RefMemoryTrace
from tnsh.protocols.twist_bits import TwistBits as RefTwistBits
from tnsh_torch.commit import kzg
from tnsh_torch.core.proof_io import twist_bits_proof_from_bytes
from tnsh_torch.field import fr_kernels
from tnsh_torch.protocols.twist_bits import (
    Fr,
    MemoryTrace,
    TwistBits,
    setup_multilinear_params,
    setup_params,
)
from tnsh_torch.utils.profiling import GcCollections, PhaseTimer

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

LOG_K, LOG_T = 3, 6


@pytest.fixture(scope="module")
def params():
    """((port pp, vp), (tnsh pp, vp)) from the same deterministic setup."""
    return setup_params(8), ref_setup_params(8)


def _ops(seed, log_k, log_t):
    """(is_write, address, value) triples from a seeded generator."""
    rng = random.Random(seed)
    k = 1 << log_k
    ops = []
    for i in range(1 << log_t):
        if i % 3 == 0 or i == 0:
            ops.append((True, rng.randrange(k), rng.randrange(1 << 61)))
        else:
            ops.append((False, rng.randrange(k), 0))
    return ops


def _fill(trace, fr, ops):
    for is_write, addr, value in ops:
        if is_write:
            trace.write(addr, fr(value))
        else:
            trace.read(addr)
    return trace


def _trace(seed, log_k, log_t):
    return _fill(MemoryTrace(1 << log_k), Fr, _ops(seed, log_k, log_t))


def _ref_trace(seed, log_k, log_t):
    return _fill(RefMemoryTrace(1 << log_k), RefFr, _ops(seed, log_k, log_t))


def _ref_bytes(seed, log_k, log_t, ref_pp):
    return ref_to_bytes(RefTwistBits.prove(_ref_trace(seed, log_k, log_t),
                                           ref_pp))


def _cross_verify(port_bytes, ref_bytes, vp, ref_vp):
    """tnsh's verifier on the port's bytes, the port's on tnsh's."""
    assert RefTwistBits.verify(ref_from_bytes(port_bytes), ref_vp)
    assert TwistBits.verify(twist_bits_proof_from_bytes(ref_bytes), vp)


def test_proof_bytes_equal_tnsh_and_frozen_digest(params):
    (pp, vp), (ref_pp, ref_vp) = params
    tr = _trace(1234, LOG_K, LOG_T)
    timer = PhaseTimer()
    proof = TwistBits.prove(tr, pp, "cpu", timer)
    b = TwistBits.to_bytes(proof)
    assert (len(b), hashlib.sha256(b).hexdigest()) == (
        4856,
        "948e0609dd4a33266972f0cce3e6dc2d8ae8a10b38d448f70ab2cbc1322cffed",
    )
    ref_b = _ref_bytes(1234, LOG_K, LOG_T, ref_pp)
    assert b == ref_b
    assert TwistBits.verify(proof, vp)
    _cross_verify(b, ref_b, vp, ref_vp)
    assert {"simulate", "commit", "phase_a", "phase_b", "open"} <= set(
        timer.phases)
    # on the CPU every kernel wrapper takes its plain version
    assert all(n == 0 for per in timer.launches.values()
               for n in per.values())


def test_native_column_path_equals_tnsh(params):
    """T = 2^11: bytes-backed FrTable columns and eq tables go to the
    oracles, which the port packs straight from their raw words; the 10
    column commitments and the 1024-point quotient MSM of each opening go
    through the port's scheduled Pippenger, the rest to the host MSM."""
    (pp, vp), (ref_pp, ref_vp) = params
    kzg.reset_route_counts()
    timer = PhaseTimer()
    proof = TwistBits.prove(_trace(77, 3, 11), pp, "cpu", timer)
    assert kzg.route_counts() == {"device": 12, "host": 20}
    assert sum(c.hazard_count for c in kzg.device_contexts()) == 0
    assert {"commit/marshal", "commit/plan", "commit/upload", "commit/launch",
            "commit/combine", "open/quotients", "open/plan", "open/launch",
            "open/combine", "open/host_msm"} <= set(timer.phases)
    b = TwistBits.to_bytes(proof)
    ref_b = _ref_bytes(77, 3, 11, ref_pp)
    assert b == ref_b
    _cross_verify(b, ref_b, vp, ref_vp)
    forged = dataclasses.replace(proof, v_val=Fr(int(proof.v_val) + 1))
    assert not TwistBits.verify(forged, vp)


@pytest.mark.parametrize("kind", ["writes_only", "reads_only"])
def test_one_sided_traces_equal_tnsh(kind, params):
    (pp, vp), (ref_pp, ref_vp) = params
    k = 1 << LOG_K
    # reads are of never-written memory (zeros)
    ops = [(kind == "writes_only", i % k, 100 + i) for i in range(8)]
    proof = TwistBits.prove(_fill(MemoryTrace(k), Fr, ops), pp, "cpu")
    b = TwistBits.to_bytes(proof)
    ref_b = ref_to_bytes(RefTwistBits.prove(
        _fill(RefMemoryTrace(k), RefFr, ops), ref_pp))
    assert b == ref_b
    _cross_verify(b, ref_b, vp, ref_vp)


def _record_frees(monkeypatch):
    created, freed = [], []
    real_create, real_free = _native.tbk_create, _native.tbk_free

    def create(*args):
        h = real_create(*args)
        created.append(h)
        return h

    def free(h):
        freed.append(h)
        real_free(h)

    monkeypatch.setattr(_native, "tbk_create", create)
    monkeypatch.setattr(_native, "tbk_free", free)
    return created, freed


def test_tbk_freed_when_a_k_round_raises(params, monkeypatch):
    pp, _ = params[0]
    created, freed = _record_frees(monkeypatch)

    def boom(*_args):
        raise RuntimeError("k round failed")

    monkeypatch.setattr(_native, "tbk_round_evals", boom)
    with pytest.raises(RuntimeError, match="k round failed"):
        TwistBits.prove(_trace(5, LOG_K, LOG_T), pp, "cpu")
    assert len(created) == 1 and freed == created


def test_tbk_freed_once_when_a_j_round_raises(params, monkeypatch):
    pp, _ = params[0]
    created, freed = _record_frees(monkeypatch)

    def boom(*_args):
        raise RuntimeError("j round failed")

    monkeypatch.setattr(fr_kernels, "sum_of_products_round_evals", boom)
    with pytest.raises(RuntimeError, match="j round failed"):
        TwistBits.prove(_trace(6, LOG_K, LOG_T), pp, "cpu")
    assert len(created) == 1 and freed == created


def test_python_k_phase_without_native_engine(params, monkeypatch):
    """Under TNSH_NO_NATIVE the k rounds run in Python and the proof is
    tnsh's, byte for byte."""
    (pp, vp), (ref_pp, ref_vp) = params
    # the way a caller asks for the pure-Python path; patching the lazy
    # ``available`` itself would leave a real attribute behind on undo
    monkeypatch.setenv("TNSH_NO_NATIVE", "1")
    assert _native.available is False
    timer = PhaseTimer()
    proof = TwistBits.prove(_trace(7, LOG_K, LOG_T), pp, "cpu", timer)
    monkeypatch.delenv("TNSH_NO_NATIVE")
    assert {"k_rounds", "j_build", "j_rounds"} <= set(timer.phases)
    b = TwistBits.to_bytes(proof)
    ref_b = _ref_bytes(7, LOG_K, LOG_T, ref_pp)
    assert b == ref_b
    _cross_verify(b, ref_b, vp, ref_vp)


def test_prove_runs_with_jax_blocked():
    """The port stands alone: with ``tnsh``, ``jax`` and ``jaxlib``
    unimportable, every module of ``tnsh_torch`` imports, and the port
    proves and verifies K=8, T=64 with TwistBits, ShoutBits and
    ShoutBitsCommitted, on each of its three phase-A paths (native k
    phase, TNSH_BITS_DENSE, TNSH_NO_NATIVE) to the same bytes."""
    code = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("tnsh", "jax", "jaxlib"):
            raise ImportError(name + " is blocked")
        return None

sys.meta_path.insert(0, Block())
import random
import tnsh_torch
names = [m.name for m in pkgutil.walk_packages(tnsh_torch.__path__,
                                                "tnsh_torch.")]
for name in names:
    importlib.import_module(name)
from tnsh_torch.protocols.twist_bits import (
    Fr, MemoryTrace, TwistBits, setup_params)

random.seed(3)
tr = MemoryTrace(8)
for i in range(64):
    if i % 3 == 0:
        tr.write(random.randrange(8), Fr(42 * i))
    else:
        tr.read(random.randrange(8))
pp, vp = setup_params(4)
from tnsh_torch.core.proof_io import twist_bits_proof_from_bytes
from tnsh_torch.protocols.twist_bits import (
    LookupTable, ShoutBits, ShoutBitsCommitted)
tbl = LookupTable([Fr(3 * i + 1) for i in range(8)])
for _ in range(63):
    tbl.lookup(random.randrange(8))
comm = ShoutBitsCommitted.preprocess(tbl.entries, "cpu")
import os
paths = []
for env in ({}, {"TNSH_BITS_DENSE": "1"}, {"TNSH_NO_NATIVE": "1"}):
    os.environ.update(env)
    proof = TwistBits.prove(tr, pp, "cpu")
    assert TwistBits.verify(proof, vp)
    assert TwistBits.verify(
        twist_bits_proof_from_bytes(TwistBits.to_bytes(proof)), vp)
    sproof = ShoutBits.prove(tbl, pp, "cpu")
    assert ShoutBits.verify(sproof, tbl.entries, vp)
    cproof = ShoutBitsCommitted.prove(tbl, pp, "cpu")
    assert ShoutBitsCommitted.verify(cproof, comm, vp)
    paths.append((TwistBits.to_bytes(proof), ShoutBits.to_bytes(sproof),
                  ShoutBitsCommitted.to_bytes(cproof)))
    for var in env:
        del os.environ[var]
assert paths[0] == paths[1] == paths[2]
assert not [m for m in sys.modules
            if m.split(".")[0] in ("tnsh", "jax", "jaxlib")]
print("ok", len(names))
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ok, count = proc.stdout.split()
    assert ok == "ok" and int(count) >= 25


@pytest.mark.cuda
@pytest.mark.parametrize("log_t", [16, 18, 20])
def test_card_proof_equals_tnsh_host_proof(log_t, params, monkeypatch,
                                           request):
    """K=2^10 on the card (commitments, openings and sum-check rounds)
    against tnsh's host-native prover, with the trace ``bench.py`` proves.
    Run with ``-s`` to see the prove times, taken in turns port, tnsh,
    port, tnsh in one process, and each prove's generation-2 collections
    and their seconds (both packages pause the cyclic GC during a prove:
    none is expected)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # keep tnsh's MSMs on the host: its commit_many otherwise builds a
    # device MSM context under jax before it falls back to the host
    monkeypatch.setenv("TNSH_TPU_MSM", "0")
    monkeypatch.setattr(ref_kzg, "_TPU_MSM_FRACTION", "0")
    (pp, vp), (ref_pp, ref_vp) = params
    log_k = 10
    rng = random.Random(5)
    ops = [(i % 3 == 0, rng.randrange(1 << log_k), 42 * i)
           for i in range(1 << log_t)]
    tr = _fill(MemoryTrace(1 << log_k), Fr, ops)
    ref_tr = _fill(RefMemoryTrace(1 << log_k), RefFr, ops)
    dev = torch.device("cuda", 0)
    # a prover's process keeps torch's own thread count; the CPU tests'
    # single thread is put back at the end
    torch.set_num_threads(os.cpu_count() or 1)
    request.addfinalizer(lambda: torch.set_num_threads(1))
    TwistBits.prove(_trace(1, LOG_K, LOG_T), pp, dev)  # CUDA start-up
    # both PST SRSs and the port's device copy, kept out of the timing
    params_t, _ = setup_multilinear_params(log_t)
    from tnsh_torch.commit.mkzg import MultilinearKZG

    MultilinearKZG.prepare_device(params_t, dev)
    ref_ml_params(log_t)
    times = {"port": [], "tnsh": []}
    gen2 = {"port": [], "tnsh": []}
    out = {}
    for who in ("port", "tnsh", "port", "tnsh"):
        with GcCollections() as gcs:
            t0 = time.perf_counter()
            if who == "port":
                proof = TwistBits.prove(tr, pp, dev)
                torch.cuda.synchronize()
            else:
                proof = RefTwistBits.prove(ref_tr, ref_pp)
            times[who].append(time.perf_counter() - t0)
        gen2[who].append((gcs.count, gcs.seconds, gcs.young_count,
                          gcs.young_seconds))
        b = (TwistBits.to_bytes if who == "port" else ref_to_bytes)(proof)
        assert out.setdefault(who, b) == b
    assert out["port"] == out["tnsh"]
    _cross_verify(out["port"], out["tnsh"], vp, ref_vp)
    assert sum(c.hazard_count for c in kzg.device_contexts()) == 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"\nTwistBits K=2^{log_k} T=2^{log_t} on {card}: "
          f"port prove s {times['port']}, tnsh host prove s {times['tnsh']}; "
          f"collections (gen-2 count, s, gen-0/1 count, s) {gen2}")
    assert [c[0] for c in gen2["port"] + gen2["tnsh"]] == [0] * 4
