"""The openings' tables from device-resident columns, on the CPU: the
plain versions of the RLC and open-level kernels, and the fold chain of a
``ColumnStack``, held byte for byte against the host engine
(``_native.fr_rlc``, ``fr_ml_open``, ``fr_mle_eval_many``); the two new
CUDA kernels compiled by g++ against a mock of the CUDA runtime and held
against the plain versions; and the three bit-column provers driven
through the device route (the route predicate patched, the plain kernels
on CPU tensors) against their host route: the same proof bytes, the
stack counted, the spans kept, and no device table alive once the opening
MSMs are queued."""

import ctypes
import os
import random
import re
import shutil
import subprocess
import weakref
from unittest import mock

import numpy as np
import pytest
import torch

import tnsh_torch._native as _native
from tnsh_torch.commit import kzg, mkzg
from tnsh_torch.commit.mkzg import ColumnStack, MultilinearKZG
from tnsh_torch.field import fr_kernels, limbs
from tnsh_torch.field.fr import MODULUS as P
from tnsh_torch.field.fr import Fr, FrTable
from tnsh_torch.protocols import twist_bits
from tnsh_torch.protocols.shout import LookupTable
from tnsh_torch.protocols.twist import MemoryTrace
from tnsh_torch.protocols.twist_bits import (
    ShoutBits,
    ShoutBitsCommitted,
    TwistBits,
    setup_params,
)
from tnsh_torch.utils.profiling import PhaseTimer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not _native.available,
                                reason="needs the native engine")


def _column(kind: str, n: int, rng: random.Random):
    if kind == "random":
        return [rng.randrange(P) for _ in range(n)]
    if kind == "zero":
        return [0] * n
    if kind == "p_minus_1":
        return [P - 1] * n
    return [rng.randrange(2) for _ in range(n)]        # a bit column


def _columns(kind: str, f: int, n: int, seed: int):
    rng = random.Random(seed)
    return [FrTable(limbs.le_bytes(_column(kind, n, rng)))
            for _ in range(f)]


def _canonical_bytes(t: torch.Tensor) -> bytes:
    """An ``(8, N)`` Montgomery table's values as 32-byte LE words."""
    return b"".join(v.to_bytes(32, "little") for v in limbs.unpack(t))


def _level_bytes(levels, device: torch.device) -> list:
    """``_device_quotients``' levels as bytes: a level of
    ``kzg.DEVICE_MSM_MIN`` words or more is an ``(N, 8)`` int32 tensor on
    the table's ``device``, a smaller one bytes."""
    out = []
    for lv in levels:
        if isinstance(lv, torch.Tensor):
            assert lv.shape[0] >= kzg.DEVICE_MSM_MIN and lv.shape[1] == 8
            assert lv.dtype == torch.int32 and lv.device == device
            out.append(lv.cpu().numpy().tobytes())
        else:
            assert len(lv) < 32 * kzg.DEVICE_MSM_MIN
            out.append(lv)
    return out


KINDS = ("random", "zero", "p_minus_1", "bits")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("f", [1, 11, 24])
@pytest.mark.parametrize("log_n", [10, 12])
@pytest.mark.parametrize("table", ["evals", "rlc", "quotients"])
def test_device_tables_match_the_host_engine(table, log_n, f, kind):
    """Column values at a point (a fold chain over the stack), the gamma-RLC
    table (``fr_kernels.rlc``) and the opening of that table (its value and
    every level's quotient words, ``fr_kernels.open_level``) equal the host
    engine's byte for byte."""
    n = 1 << log_n
    cols = _columns(kind, f, n, seed=1000 * log_n + f)
    rng = random.Random(7 + log_n + f)
    point = [Fr(rng.randrange(P)) for _ in range(log_n)]
    gamma = rng.randrange(P)
    stack = ColumnStack(cols, "cpu")
    if table == "evals":
        got = stack.evals(range(f), point)
        assert [int(v) for v in got] == [
            int(v) for v in _native.fr_mle_eval_many(cols, point)]
        return
    rlc = stack.rlc(range(f), gamma)
    want_rlc = _native.fr_rlc(cols, gamma)
    if table == "rlc":
        assert rlc.shape == (8, n) and _canonical_bytes(rlc) == want_rlc
        return
    value, levels = mkzg._device_quotients(rlc, point)
    levels = _level_bytes(levels, rlc.device)
    want_value, want_levels = _native.fr_ml_open(FrTable(want_rlc), point)
    assert int(value) == int(want_value)
    assert [len(lv) for lv in levels] == [32 * (n >> (i + 1))
                                          for i in range(log_n)]
    assert b"".join(levels) == b"".join(want_levels)


def test_stack_groups_of_any_columns():
    """A stack gives any group of its columns, in any order and with
    repeats, their values and RLC table (all the columns in order from the
    stack itself, any other group from a gather of its rows), and counts
    its columns once."""
    from tnsh_torch.utils import profiling

    n, f = 1 << 10, 7
    cols = _columns("random", f, n, seed=3)
    rng = random.Random(9)
    point = [Fr(rng.randrange(P)) for _ in range(10)]
    gamma = rng.randrange(P)
    profiling.reset_launch_counts()
    stack = ColumnStack(cols, "cpu")
    assert profiling.counter_totals() == {"open_device_columns": 7}
    for group in (range(7), [6, 2, 1], [1, 5, 3], [5], [0, 3], [2, 2]):
        sub = [cols[c] for c in group]
        assert [int(v) for v in stack.evals(group, point)] == [
            int(v) for v in _native.fr_mle_eval_many(sub, point)]
        assert _canonical_bytes(stack.rlc(group, gamma)) == _native.fr_rlc(
            sub, gamma)
    assert stack._rows(range(7)) is stack.stack
    profiling.reset_launch_counts()


def test_open_device_matches_open():
    """``MultilinearKZG.open_device`` gives ``open``'s values and quotient
    commitments, and empties the list of tables it was handed."""
    from tnsh_torch.commit.mkzg import setup_multilinear_params

    log_n = 10
    n = 1 << log_n
    params, _ = setup_multilinear_params(log_n)
    cols = _columns("random", 3, n, seed=21)
    rng = random.Random(22)
    points = [[Fr(rng.randrange(P)) for _ in range(log_n)] for _ in range(2)]
    stack = ColumnStack(cols, "cpu")
    tables = [stack.rlc([0, 1, 2], 5), stack.rlc([2, 1], 11)]
    with mock.patch.object(kzg, "DEVICE_MSM_MIN", 1 << 62):
        got = MultilinearKZG.open_device(params, tables, points, "cpu")
        want = [MultilinearKZG.open(params, FrTable(_native.fr_rlc(t, g)),
                                    pt, "cpu")
                for t, g, pt in (([cols[0], cols[1], cols[2]], 5, points[0]),
                                 ([cols[2], cols[1]], 11, points[1]))]
    assert tables == []
    for (gv, gp), (wv, wp) in zip(got, want):
        assert int(gv) == int(wv)
        assert gp.serialize_compressed() == wp.serialize_compressed()


def test_kernel_arguments_are_checked():
    stack = torch.zeros((3, 8, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="coeffs"):
        fr_kernels.rlc(stack, torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="quot"):
        fr_kernels.open_level(stack[0], 3,
                              torch.zeros((16, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="power of two"):
        fr_kernels.open_level(torch.zeros((8, 12), dtype=torch.int32), 3,
                              torch.zeros((6, 8), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the CUDA source, run on the host
# ---------------------------------------------------------------------------

_MOCK_RUNTIME = r"""
#pragma once
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__ static const
#define __restrict__
#define __shared__
#define __launch_bounds__(n)
#define __syncthreads()
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 threadIdx(0, 0, 0), blockIdx(0, 0, 0), blockDim(1), gridDim(1);
struct uint2 { uint32_t x, y; };
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaDevAttrMultiProcessorCount = 16,
       cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 1; return 0; }
template <class K> inline cudaError_t cudaFuncSetAttribute(K, int, int) {
  return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
template <class T> inline T __shfl_up_sync(unsigned, T v, int) { return v; }
inline unsigned __match_any_sync(unsigned, int) { return 1u; }
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """``csrc/fr_kernels.cu`` built by g++ with the mock runtime: a launch
    becomes a call of the kernel, which runs as one thread of a one-block
    grid, so its grid-stride loop covers every lane; the PTX carry chains
    run emulated (``field.cuh``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("fr_kernels_host")
    csrc = os.path.join(REPO, "tnsh_torch", "csrc")
    field = open(os.path.join(csrc, "field.cuh")).read()
    field = re.sub(r"<<<.*?>>>", "", field, flags=re.S)
    src = open(os.path.join(csrc, "fr_kernels.cu")).read()
    src = re.sub(r"<<<.*?>>>", "", src, flags=re.S)
    src = src.replace("extern __shared__ uint32_t sh[];",
                      "static uint32_t sh[1];")
    (tmp / "field.cuh").write_text(field)
    (tmp / "fr_kernels.cpp").write_text(src)
    (tmp / "cuda_runtime.h").write_text(_MOCK_RUNTIME)
    lib_path = tmp / "libfr_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(tmp),
         str(tmp / "fr_kernels.cpp"), "-o", str(lib_path)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib = ctypes.CDLL(str(lib_path))
    lib.tnsh_fr_rlc.argtypes = [vp, vp, vp, i64, i64, vp]
    lib.tnsh_fr_open_level.argtypes = [vp, vp, vp, vp, i64, vp]
    lib.tnsh_fr_fold.argtypes = [vp, vp, vp, i64, i64, vp]
    return lib


def _lazy_table(rng, f, n):
    """``(F, 8, N)`` Montgomery words anywhere in the lazy domain [0, 2p),
    edge values among them."""
    edge = [0, 1, P - 1, P, P + 1, 2 * P - 1]
    vals = [edge[i] if i < len(edge) else rng.randrange(2 * P)
            for i in range(f * n)]
    words = np.array([limbs.int_to_words(v) for v in vals], dtype=np.uint32)
    return torch.from_numpy(
        words.reshape(f, n, 8).transpose(0, 2, 1).copy().view(np.int32))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("f", [1, 5])
def test_cuda_kernels_on_the_host_match_the_plain_versions(host_kernels, f):
    """``fr_rlc_kernel``, ``fr_open_level_kernel`` and the fold the
    evaluations chain, from the CUDA source, give the plain versions'
    limbs (the plain ops compute the same CIOS integers)."""
    rng = random.Random(40 + f)
    n = 64
    tabs = _lazy_table(rng, f, n)
    coeffs = torch.from_numpy(np.array(
        [limbs.mont_words(rng.randrange(P)) for _ in range(f)],
        dtype=np.uint32).view(np.int32))
    out = torch.empty((8, n), dtype=torch.int32)
    assert host_kernels.tnsh_fr_rlc(_p(tabs), _p(coeffs), _p(out), f, n,
                                    None) == 0
    assert torch.equal(out, fr_kernels.rlc_plain(tabs, coeffs))

    r = rng.randrange(P)
    r_words = (ctypes.c_uint32 * 8)(*limbs.mont_words(r))
    quot = torch.empty((n // 2, 8), dtype=torch.int32)
    nxt = torch.empty((8, n // 2), dtype=torch.int32)
    assert host_kernels.tnsh_fr_open_level(
        _p(tabs[0]), _p(nxt), _p(quot),
        ctypes.cast(r_words, ctypes.c_void_p), n // 2, None) == 0
    want_quot = torch.empty_like(quot)
    want_next = fr_kernels.open_level_plain(tabs[0].contiguous(), r,
                                            want_quot)
    assert torch.equal(nxt, want_next) and torch.equal(quot, want_quot)
    # the quotient words are canonical: below p, the values of hi - lo
    lo, hi = limbs.unpack(tabs[0][:, 0::2]), limbs.unpack(tabs[0][:, 1::2])
    got = np.ascontiguousarray(quot.numpy().view(np.uint32)).tobytes()
    assert got == b"".join(((h - l) % P).to_bytes(32, "little")
                           for l, h in zip(lo, hi))

    folded = torch.empty((f, 8, n // 2), dtype=torch.int32)
    assert host_kernels.tnsh_fr_fold(
        _p(tabs), _p(folded), ctypes.cast(r_words, ctypes.c_void_p), f,
        n // 2, None) == 0
    assert torch.equal(folded, fr_kernels.fold_plain(tabs, r))


def test_plain_quotients_are_canonical_at_the_edges():
    """hi - lo at the lazy domain's edges (0 and p both zero) leaves
    ``open_level_plain`` as canonical words."""
    vals = [0, P, P, 0, 2 * P - 1, P - 1, 1, P + 1]
    t = torch.from_numpy(np.array([limbs.int_to_words(v) for v in vals],
                                  dtype=np.uint32).T.copy().view(np.int32))
    quot = torch.empty((4, 8), dtype=torch.int32)
    fr_kernels.open_level_plain(t, 5, quot)
    words = np.ascontiguousarray(quot.numpy().view(np.uint32))
    got = [int.from_bytes(w.tobytes(), "little") for w in words]
    r_inv = limbs.R_INV
    assert got == [(h - l) * r_inv % P
                   for l, h in zip(vals[0::2], vals[1::2])]


# ---------------------------------------------------------------------------
# the provers on the device route
# ---------------------------------------------------------------------------

LOG_K, LOG_T = 10, 11


def _twist_trace():
    rng = random.Random(5)
    tr = MemoryTrace(1 << LOG_K)
    for i in range(1 << LOG_T):
        if i % 3 == 0:
            tr.write(rng.randrange(1 << LOG_K), Fr(42 * i + 1))
        else:
            tr.read(rng.randrange(1 << LOG_K))
    return tr


def _lookups():
    rng = random.Random(11)
    tbl = LookupTable([Fr(3 * i + 1) for i in range(1 << LOG_K)])
    for _ in range((1 << LOG_T) - 1):
        tbl.lookup(rng.randrange(1 << LOG_K))
    return tbl


#: prover -> (prove(pp, device, timer) -> bytes, the stack's F)
PROVERS = {
    "twist_bits": (lambda pp, device, timer: TwistBits.to_bytes(
        TwistBits.prove(_twist_trace(), pp, device, timer)), 2 * LOG_K + 4),
    "shout_bits": (lambda pp, device, timer: ShoutBits.to_bytes(
        ShoutBits.prove(_lookups(), pp, device, timer)), LOG_K + 1),
    "shout_bits_committed": (
        lambda pp, device, timer: ShoutBitsCommitted.to_bytes(
            ShoutBitsCommitted.prove(_lookups(), pp, device, timer)),
        LOG_K + 1),
}


@pytest.mark.parametrize("prover", sorted(PROVERS))
def test_provers_on_the_device_route(prover):
    """Each bit-column prover with the route predicate patched to the
    device route (the plain kernels on CPU tensors) gives its host route's
    proof bytes, counts its stack's F columns (none on the host route),
    keeps the spans of ``open``, and holds no stack, fold of it, RLC table
    or quotient level when the first opening MSM is queued."""
    prove, n_cols = PROVERS[prover]
    pp = setup_params(4)[0]
    alive = []
    real_init, real_fold = ColumnStack.__init__, fr_kernels.fold
    real_rlc, real_level = fr_kernels.rlc, fr_kernels.open_level
    real_msms = mkzg._level_msms

    def track(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if alive:                 # from the stack's upload on
                alive.append(weakref.ref(out))
            return out
        return wrapped

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        alive.append(weakref.ref(self.stack))

    queued = []

    def level_msms(*args, **kwargs):
        if not queued:
            queued.append(sum(ref() is not None for ref in alive))
        return real_msms(*args, **kwargs)

    # the MSMs on the host engine, as both routes' are: this test is about
    # the tables
    with mock.patch.object(kzg, "DEVICE_MSM_MIN", 1 << 62):
        host_timer = PhaseTimer()
        host = prove(pp, "cpu", host_timer)
        timer = PhaseTimer()
        with mock.patch.object(twist_bits, "_device_openings",
                               lambda device, size: True), \
                mock.patch.object(ColumnStack, "__init__", init), \
                mock.patch.object(fr_kernels, "fold", track(real_fold)), \
                mock.patch.object(fr_kernels, "rlc", track(real_rlc)), \
                mock.patch.object(fr_kernels, "open_level",
                                  track(real_level)), \
                mock.patch.object(mkzg, "_level_msms", level_msms):
            device = prove(pp, "cpu", timer)
    assert device == host
    assert "open_device_columns" not in host_timer.counters
    assert timer.counters["open_device_columns"] == n_cols
    assert {"open", "open/evals", "open/rlc", "open/quotients"} <= set(
        timer.phases)
    assert len(alive) > 1 + LOG_T and queued == [0]
    assert all(ref() is None for ref in alive)


def test_route_predicate(monkeypatch):
    """The device route is taken on a CUDA device with the engine on and
    1024 lanes or more, and nowhere else: not on the CPU, not at 512
    lanes, not under TNSH_NO_NATIVE."""
    n = 1024
    assert not twist_bits._device_openings("cpu", n)
    assert not twist_bits._device_openings("cuda", n // 2)
    assert twist_bits._device_openings("cuda", n)
    assert twist_bits._device_openings(torch.device("cuda", 0), 1 << 20)
    monkeypatch.setenv("TNSH_NO_NATIVE", "1")
    assert not twist_bits._device_openings("cuda", n)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [10, 16])
def test_card_tables_match_the_host_engine(cuda, log_n):
    """On 24 columns (the TwistBits stack) of 2^10 and 2^16 lanes, the RLC
    and open-level kernels equal their plain versions limb for limb, and
    the stack's values, RLC table and opening equal the host engine's
    bytes."""
    n, f = 1 << log_n, 24
    cols = _columns("random", f, n, seed=log_n)
    rng = random.Random(log_n)
    point = [Fr(rng.randrange(P)) for _ in range(log_n)]
    gamma = rng.randrange(P)
    stack = ColumnStack(cols, cuda)
    assert [int(v) for v in stack.evals(range(f), point)] == [
        int(v) for v in _native.fr_mle_eval_many(cols, point)]
    rlc = stack.rlc(range(f), gamma)
    coeffs = torch.from_numpy(np.array(
        [limbs.mont_words(pow(gamma, i, P)) for i in range(f)],
        dtype=np.uint32).view(np.int32)).to(cuda)
    assert torch.equal(rlc, fr_kernels.rlc_plain(stack.stack, coeffs))
    want_rlc = _native.fr_rlc(cols, gamma)
    assert _canonical_bytes(rlc) == want_rlc
    quot = torch.empty((n // 2, 8), dtype=torch.int32, device=cuda)
    want_quot = torch.empty_like(quot)
    nxt = fr_kernels.open_level(rlc, point[0], quot)
    assert torch.equal(nxt, fr_kernels.open_level_plain(rlc, point[0],
                                                        want_quot))
    assert torch.equal(quot, want_quot)
    value, levels = mkzg._device_quotients(rlc, point)
    want_value, want_levels = _native.fr_ml_open(FrTable(want_rlc), point)
    assert int(value) == int(want_value)
    assert b"".join(_level_bytes(levels, rlc.device)) == b"".join(
        want_levels)


@pytest.mark.cuda
@pytest.mark.parametrize("prover", sorted(PROVERS))
def test_card_provers_device_route(cuda, prover):
    """Each bit-column prover on the card takes the device route by
    itself and gives the bytes of its host route on the same card, and
    its MSMs the same digits."""
    prove, n_cols = PROVERS[prover]
    pp = setup_params(4)[0]
    timer, host_timer = PhaseTimer(), PhaseTimer()
    device = prove(pp, cuda, timer)
    with mock.patch.object(twist_bits, "_device_openings",
                           lambda device, size: False):
        host = prove(pp, cuda, host_timer)
    assert device == host
    assert timer.counters["open_device_columns"] == n_cols
    assert "open_device_columns" not in host_timer.counters
    assert timer.counters["msm_digits"] == host_timer.counters["msm_digits"]
    assert timer.launches["open/rlc"]["rlc"] == (
        2 if prover == "twist_bits" else 1)
