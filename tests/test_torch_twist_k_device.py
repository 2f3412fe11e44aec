"""TwistBits' k rounds on the card (``iop.twist_k_card``, the kernels
``fr_kernels.twist_k_buckets`` / ``twist_k_round`` / ``twist_k_bind``).

On the CPU: the plain versions, driven by ``TwistKCard`` as the card route
drives the kernels, against the host engine's ``tbk_round_evals`` /
``tbk_bind`` round by round, over random, all-read, all-write and
one-hot-address traces, with chunks shorter than T and writes on the
chunks' edges; the bucket stack folded by each bind against the stack
rebuilt from scratch; the CUDA source compiled by g++ against a mock of
the CUDA runtime (a block's threads as threads, ``__match_any_sync`` an
exchange between warp barriers) and held against the plain versions;
whole proves on the card route (forced on the CPU) against the engine's
bytes, and the counter ``k_device_rounds``.  Marked ``cuda``: the kernels
against ``tbk_*`` every round at T = 2^16 and 2^20, and the card route's
peak memory against the host route's.

Imports nothing of the JAX package."""

import ctypes
import os
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import tnsh_torch._native as _native
from tnsh_torch.field import fr_kernels, fr_ops, limbs
from tnsh_torch.field.fr import MODULUS as P
from tnsh_torch.field.fr import Fr
from tnsh_torch.iop import twist_k_card
from tnsh_torch.iop.bits_oracle import TwistBitsSparseOracle, twist_cube_slots
from tnsh_torch.poly.eq import eq_table
from tnsh_torch.protocols.bit_columns import BitColumns
from tnsh_torch.protocols.sound import _kinv
from tnsh_torch.protocols.twist import MemoryTrace
from tnsh_torch.protocols.twist_bits import TwistBits, setup_params
from tnsh_torch.utils.profiling import PhaseTimer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_engine = pytest.mark.skipif(not _native.available,
                                  reason="needs the native engine")

#: traffic patterns: which cycles write, and to which addresses
PATTERNS = ("random", "reads", "writes", "one_hot", "edges")


def _record(log_k: int, log_t: int, pattern: str, seed: int,
            chunk: int = 64) -> BitColumns:
    """TwistBits' columns of a trace by ``pattern`` (``edges``: the writes
    on the first and last cycle of every ``chunk``), as the prover's
    marshalled record."""
    rng = random.Random(seed)
    k_size, t_size = 1 << log_k, 1 << log_t
    ra = np.zeros(t_size, dtype=np.int64)
    wa = np.zeros(t_size, dtype=np.int64)
    ot = np.zeros(t_size, dtype=np.bool_)
    rv, wv, ic = ([0] * t_size for _ in range(3))
    mem = [0] * k_size
    hot = rng.randrange(k_size)
    for j in range(t_size):
        write = {"random": rng.random() < 1 / 3, "reads": False,
                 "writes": True, "one_hot": j % 3 == 0,
                 "edges": j % chunk in (0, chunk - 1)}[pattern]
        a = hot if pattern == "one_hot" else rng.randrange(k_size)
        if write:
            v = rng.randrange(P)
            ot[j], wa[j] = True, a
            wv[j], ic[j] = v, (v - mem[a]) % P
            mem[a] = v
        else:
            ra[j], rv[j] = a, mem[a]
    record = BitColumns(log_k, log_t, ra, wa, ot, [rv, wv, ic])
    record.marshal()
    return record


def _oracle(record, seed: int, device="cpu", native=True):
    rng = random.Random(seed)
    log_k, log_t = record.log_k, record.log_t

    def pt(n):
        return [Fr(rng.randrange(P)) for _ in range(n)]

    return TwistBitsSparseOracle(
        record, rho1=pt(log_t), sigma_k=pt(log_k), sigma_j=pt(log_t),
        rhob=pt(log_t),
        alpha_powers=[rng.randrange(P) for _ in range(3 + 2 * log_k)],
        kinv=_kinv(log_k), degree=log_k + 3, device=device, native=native)


@pytest.fixture
def card_route(monkeypatch):
    """Called with a chunk length: the card route on the CPU (the kernels'
    plain versions) from then on, in chunks of that many cycles."""

    def chunk(n):
        monkeypatch.setattr(twist_k_card, "on_card",
                            lambda device, log_k: True)
        monkeypatch.setattr(twist_k_card, "CHUNK", n)

    return chunk


@needs_engine
@pytest.mark.parametrize("log_k,log_t,pattern,chunk", [
    (4, 8, "random", 64), (5, 9, "random", 48), (6, 10, "random", 256),
    (4, 8, "reads", 64), (4, 8, "writes", 32), (5, 8, "one_hot", 64),
    (4, 9, "edges", 64), (6, 8, "random", 1024)])
def test_card_route_equals_tbk_round_by_round(card_route, monkeypatch, log_k,
                                              log_t, pattern, chunk):
    """The card route's round evaluations (the plain round and bind
    kernels, the buckets folded by each bind) equal the engine's every k
    round, and the j stacks they leave are equal slot for slot."""
    card_route(chunk)
    record = _record(log_k, log_t, pattern, seed=log_k * log_t, chunk=chunk)
    card = _oracle(record, seed=log_t)
    assert isinstance(card._k, twist_k_card.TwistKCard)
    with monkeypatch.context() as m:
        m.setattr(twist_k_card, "on_card", lambda device, lk: False)
        host = _oracle(record, seed=log_t)
    assert isinstance(host._k, int)
    rng = random.Random(log_k)
    try:
        for i in range(log_k):
            got = card.round_evaluations(i)
            assert got == host.round_evaluations(i), f"round {i}"
            assert len(got) == log_k + 4
            r = Fr(rng.randrange(P))
            card.bind(r)
            host.bind(r)
        assert card._k is None
        assert torch.equal(fr_ops.canon(card.tables.transpose(0, 1)),
                           fr_ops.canon(host.tables.transpose(0, 1)))
    finally:
        card.release()
        host.release()


@pytest.mark.parametrize("log_k,log_t,chunk", [(4, 8, 64), (5, 9, 100)])
def test_bucket_fold_equals_the_rebuilt_buckets(log_k, log_t, chunk):
    """P_{i+1} = fold(P_i, r_i): the chunk-start buckets folded by each
    bind equal those built from scratch with the bound products A and
    the shifted addresses, and E folds to eq(sigma_k, .) at the bound
    point."""
    record = _record(log_k, log_t, "random", seed=7 * log_k)
    dev = "cpu"
    ra, wa = (torch.from_numpy(a.astype(np.int32))
              for a in (record.read_addr, record.write_addr))
    flags = torch.from_numpy(record.write_flags)
    ic = limbs.pack(record.ic, dev)
    rng = random.Random(log_t)
    sigma = [rng.randrange(P) for _ in range(log_k)]
    eqk = limbs.pack(eq_table(sigma), dev)
    buckets = fr_kernels.twist_k_buckets(ra, wa, flags, None, ic, eqk, chunk,
                                         0)
    assert buckets.shape == (-(-(1 << log_t) // chunk) + 1, 8, 1 << log_k)
    amul = None
    for i in range(log_k - 1):
        r = rng.randrange(P)
        amul = fr_kernels.twist_k_bind(ra, wa, flags, amul, r, i)
        buckets = fr_kernels.fold(buckets, r)
        eqk = fr_kernels.fold(eqk.unsqueeze(0), r)[0].contiguous()
        rebuilt = fr_kernels.twist_k_buckets(ra, wa, flags, amul, ic, eqk,
                                             chunk, i + 1)
        assert torch.equal(fr_ops.canon(buckets.transpose(0, 1)),
                           fr_ops.canon(rebuilt.transpose(0, 1))), i


def test_bucket_sums_by_python_ints():
    """The round-0 stack by a direct walk in Python ints: row c is the sum
    of ic over the writes of the chunks before c, by address."""
    log_k, log_t, chunk = 3, 7, 40
    record = _record(log_k, log_t, "random", seed=5)
    ra, wa = (torch.from_numpy(a.astype(np.int32))
              for a in (record.read_addr, record.write_addr))
    flags = torch.from_numpy(record.write_flags)
    eqk = limbs.pack(eq_table([3, 5, 7]), "cpu")
    got = fr_kernels.twist_k_buckets(ra, wa, flags, None,
                                     limbs.pack(record.ic, "cpu"), eqk,
                                     chunk, 0)
    ic = record.values[2]
    run = [0] * (1 << log_k)
    for c in range(got.shape[0] - 1):
        assert limbs.unpack(got[c]) == run, c
        for j in range(c * chunk, min((c + 1) * chunk, 1 << log_t)):
            if record.write_flags[j]:
                a = int(record.write_addr[j])
                run[a] = (run[a] + ic[j]) % P
    assert limbs.unpack(got[-1]) == limbs.unpack(eqk)


def test_k_arguments_are_checked():
    t = 16
    ra = torch.zeros(t, dtype=torch.int32)
    flags = torch.zeros(t, dtype=torch.bool)
    tab = torch.zeros((8, t), dtype=torch.int32)
    eqk = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="ra"):
        fr_kernels.twist_k_buckets(ra.long(), ra, flags, None, tab, eqk, 4, 0)
    with pytest.raises(ValueError, match="flags"):
        fr_kernels.twist_k_buckets(ra, ra, flags[:8], None, tab, eqk, 4, 0)
    with pytest.raises(ValueError, match="power of two"):
        fr_kernels.twist_k_bind(ra[:12].contiguous(), ra[:12].contiguous(),
                                flags[:12].contiguous(), None, 3, 0)
    with pytest.raises(ValueError, match="buckets"):
        fr_kernels.twist_k_buckets(ra, ra, flags, None, tab,
                                   eqk[:, :3].contiguous(), 4, 0)
    buckets = torch.zeros((4, 8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk rows"):
        fr_kernels.twist_k_round(ra, ra, flags, None, tab, tab, tab, tab,
                                 None, buckets, 8, 0)
    with pytest.raises(ValueError, match="eq1"):
        fr_kernels.twist_k_round(ra, ra, flags, None, tab[:, :8], tab, tab,
                                 tab, None, buckets, 4, 0)


def test_k_route_and_shared_memory_limit():
    """The card route on a CUDA device up to K = 2^12 buckets, which is
    what the walk block's shared memory holds: (8 nb + 2 * 8 * 32 + 32)
    words within the kernel's 227 KB."""
    assert twist_k_card.on_card("cuda", 10)
    assert twist_k_card.on_card(torch.device("cuda", 0), 12)
    assert not twist_k_card.on_card("cuda", 13)
    assert not twist_k_card.on_card("cpu", 10)
    src = open(os.path.join(REPO, "tnsh_torch", "csrc",
                            "fr_kernels.cu")).read()
    shared = int(re.search(r"kMaxWalkShared = (\d+) \* 1024;",
                           src).group(1)) * 1024
    threads = int(re.search(r"kWalkThreads = (\d+);", src).group(1))

    def words(nb):
        return 8 * nb + 2 * 8 * threads + threads

    nb = fr_kernels.K_MAX_BUCKETS
    assert 4 * words(nb) <= shared < 4 * words(2 * nb)


@pytest.mark.parametrize("n", [1, 5, 12])
def test_eq_planes_equal_the_host_table(n):
    """The card route's eq tables (two half tables, one product a lane)
    equal the host's ``eq_table``, entry for entry."""
    rng = random.Random(n)
    point = [rng.randrange(P) for _ in range(n)]
    out = torch.empty((8, 1 << n), dtype=torch.int32)
    twist_k_card.eq_planes(point, out)
    assert limbs.unpack(out) == [int(v) for v in eq_table(point)]


def test_extend_by_forward_differences():
    rng = random.Random(3)
    for deg in (2, 3):
        coeffs = [rng.randrange(P) for _ in range(deg + 1)]

        def f(x):
            return sum(c * x ** m for m, c in enumerate(coeffs)) % P

        got = twist_k_card._extend([f(x) for x in range(deg + 1)], 14)
        assert got == [f(x) for x in range(14)]


# ---------------------------------------------------------------------------
# whole proves on the card route (forced on the CPU)
# ---------------------------------------------------------------------------

def _trace(log_k: int, log_t: int, seed: int) -> MemoryTrace:
    rng = random.Random(seed)
    tr = MemoryTrace(1 << log_k)
    for i in range(1 << log_t):
        if i % 3 == 0:
            tr.write(rng.randrange(1 << log_k), Fr(42 * i + 1))
        else:
            tr.read(rng.randrange(1 << log_k))
    return tr


@pytest.mark.parametrize("log_k,log_t,chunk", [(3, 6, 1024), (4, 8, 96)])
def test_card_route_prove_gives_the_host_bytes(card_route, monkeypatch,
                                               log_k, log_t, chunk):
    """A TwistBits prove with its k rounds on the card route gives the
    bytes of the host route's prove, and counts log K ``k_device_rounds``;
    the host route counts none."""
    tr = _trace(log_k, log_t, seed=log_t)
    pp = setup_params(4)[0]
    host_timer, card_timer = PhaseTimer(), PhaseTimer()
    monkeypatch.setattr(twist_k_card, "on_card", lambda device, lk: False)
    want = TwistBits.to_bytes(TwistBits.prove(tr, pp, "cpu", host_timer))
    card_route(chunk)
    got = TwistBits.to_bytes(TwistBits.prove(tr, pp, "cpu", card_timer))
    assert got == want
    assert card_timer.counters["k_device_rounds"] == log_k
    assert "k_device_rounds" not in host_timer.counters
    # the k phase's upload and the j phase's are both timed spans
    for timer in (host_timer, card_timer):
        assert "oracle_a_build/marshal" in timer.phases
        assert "j_build/upload" in timer.phases


def test_cpu_prove_keeps_the_host_route():
    """On the CPU the k rounds stay on the engine (or in Python without
    it): no ``k_device_rounds``."""
    timer = PhaseTimer()
    TwistBits.prove(_trace(3, 5, seed=1), setup_params(4)[0], "cpu", timer)
    assert "k_device_rounds" not in timer.counters


# ---------------------------------------------------------------------------
# the CUDA source, run on the host with every thread of a block
# ---------------------------------------------------------------------------

_MOCK_RUNTIME = r"""
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__ static const
#define __restrict__
#define __shared__ static
#define __launch_bounds__(n)
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local dim3 threadIdx(0, 0, 0);
static dim3 blockIdx(0, 0, 0), blockDim(1), gridDim(1);
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
// A block's threads run as threads, one block after another: shared
// memory is static, __syncthreads a barrier of the block, a warp's
// exchange (a shuffle, __match_any_sync) a store and a load between two
// barriers of the warp.
static std::barrier<>* block_barrier;
static std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
static uint32_t warp_slots[1024];
#define __syncthreads() block_barrier->arrive_and_wait()
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int d) {
  std::barrier<>& bar = *warp_barriers[threadIdx.x / 32];
  warp_slots[threadIdx.x] = v;
  bar.arrive_and_wait();
  const uint32_t r =
      (int)(threadIdx.x % 32) >= d ? warp_slots[threadIdx.x - d] : v;
  bar.arrive_and_wait();
  return r;
}
inline unsigned __match_any_sync(unsigned, int v) {
  std::barrier<>& bar = *warp_barriers[threadIdx.x / 32];
  warp_slots[threadIdx.x] = (uint32_t)v;
  bar.arrive_and_wait();
  const unsigned w0 = threadIdx.x / 32 * 32;
  unsigned mask = 0;
  for (unsigned l = 0; l < 32 && w0 + l < blockDim.x; ++l)
    if (warp_slots[w0 + l] == (uint32_t)v) mask |= 1u << l;
  bar.arrive_and_wait();
  return mask;
}
template <class F> inline void host_launch(dim3 grid, dim3 block, F f) {
  gridDim = grid;
  blockDim = block;
  for (unsigned b = 0; b < grid.x; ++b) {
    blockIdx = dim3(b);
    std::barrier<> bar(block.x);
    block_barrier = &bar;
    warp_barriers.clear();
    for (unsigned w = 0; 32 * w < block.x; ++w)
      warp_barriers.emplace_back(new std::barrier<>(
          block.x - 32 * w < 32 ? block.x - 32 * w : 32));
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t)
      threads.emplace_back([&f, t] { threadIdx = dim3(t); f(); });
    for (auto& th : threads) th.join();
  }
}
"""


@pytest.fixture(scope="module")
def host_k(tmp_path_factory):
    """``csrc/fr_kernels.cu`` built by g++ with the threaded mock: the k
    kernels' launches and the partials' sum become ``host_launch`` calls
    (every block and thread of the grid); the other kernels are compiled,
    not run."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("fr_k_host")
    csrc = os.path.join(REPO, "tnsh_torch", "csrc")
    field = open(os.path.join(csrc, "field.cuh")).read()
    src = open(os.path.join(csrc, "fr_kernels.cu")).read()
    src = src.replace("extern __shared__ uint32_t sh[];",
                      "static uint32_t sh[1 << 16];")
    src, launches = re.subn(
        r"((?:tbk_\w+|fr_sum_partials_kernel)(?:<\w+>)?)<<<(.*?),(.*?),"
        r".*?>>>\((.*?)\);",
        r"host_launch(dim3(\2), dim3(\3), [&] { \1(\4); });", src,
        flags=re.S)
    assert launches == 6
    (tmp / "field.cuh").write_text(re.sub(r"<<<.*?>>>", "", field,
                                          flags=re.S))
    (tmp / "fr_kernels.cpp").write_text(re.sub(r"<<<.*?>>>", "", src,
                                               flags=re.S))
    (tmp / "cuda_runtime.h").write_text(_MOCK_RUNTIME)
    lib_path = tmp / "libfr_k_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I",
         str(tmp), str(tmp / "fr_kernels.cpp"), "-o", str(lib_path)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = ctypes.CDLL(str(lib_path))
    lib.tnsh_tbk_buckets.argtypes = [vp] * 6 + [i64, i64, i32, i64, vp]
    lib.tnsh_tbk_round.argtypes = [vp] * 12 + [i64, i64, i32, i64, vp]
    lib.tnsh_tbk_bind.argtypes = [vp] * 7 + [i64, i32, vp]
    return lib


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _lazy(rng, n):
    """``(8, n)`` Montgomery words anywhere in [0, 2p), edges among them."""
    edge = [0, 1, P - 1, P, P + 1, 2 * P - 1]
    vals = [edge[i] if i < len(edge) else rng.randrange(2 * P)
            for i in range(n)]
    words = np.array([limbs.int_to_words(v) for v in vals], dtype=np.uint32)
    return torch.from_numpy(words.T.copy().view(np.int32))


@pytest.mark.parametrize("pattern,chunk", [("random", 64), ("edges", 48),
                                           ("one_hot", 256)])
def test_cuda_k_kernels_on_the_host_match_the_plain_versions(host_k, pattern,
                                                             chunk):
    """The buckets' walk and scan, the round's walk with the sum over its
    blocks (round 0 with the lift, a later round with A), and the bind,
    from the CUDA source, against the plain versions on lazy [0, 2p)
    tables: canonical values equal, the bind's limbs equal."""
    log_k, log_t = 4, 8
    t = 1 << log_t
    record = _record(log_k, log_t, pattern, seed=len(pattern), chunk=chunk)
    ra, wa = (torch.from_numpy(a.astype(np.int32))
              for a in (record.read_addr, record.write_addr))
    flags = torch.from_numpy(record.write_flags)
    rng = random.Random(chunk)
    eq1, eqs, ic, wv, rv = (_lazy(rng, t) for _ in range(5))
    eqk = _lazy(rng, 1 << log_k)
    chunks = -(-t // chunk)
    amul = None
    for shift in range(3):
        nb = (1 << log_k) >> shift
        got = torch.zeros((chunks + 1, 8, nb), dtype=torch.int32)
        got[chunks] = eqk[:, :nb]
        table = eqk[:, :nb].contiguous()
        assert host_k.tnsh_tbk_buckets(_p(ra), _p(wa), _p(flags), _p(amul),
                                       _p(ic), _p(got), t, chunk, shift, nb,
                                       None) == 0
        want = fr_kernels.twist_k_buckets_plain(ra, wa, flags, amul, ic,
                                                table, chunk, shift)
        assert torch.equal(fr_ops.canon(got.transpose(0, 1)),
                           fr_ops.canon(want.transpose(0, 1))), shift
        lift = rv if shift == 0 else None
        nsums = 8 if lift is not None else 7
        partials = torch.zeros((chunks, nsums, 8), dtype=torch.int32)
        out = torch.zeros((8, nsums), dtype=torch.int32)
        assert host_k.tnsh_tbk_round(
            _p(ra), _p(wa), _p(flags), _p(amul), _p(eq1), _p(eqs), _p(ic),
            _p(wv), _p(lift), _p(want), _p(partials), _p(out), t, chunk,
            shift, nb, None) == 0
        sums = fr_kernels.twist_k_round_plain(ra, wa, flags, amul, eq1, eqs,
                                              ic, wv, lift, want, chunk,
                                              shift)
        assert limbs.unpack(out) == limbs.unpack(sums), shift
        r = rng.randrange(P)
        nxt = torch.zeros((8, t), dtype=torch.int32)
        r_words = (ctypes.c_uint32 * 8)(*limbs.mont_words(r))
        om_words = (ctypes.c_uint32 * 8)(*limbs.mont_words(1 - r))
        assert host_k.tnsh_tbk_bind(
            _p(ra), _p(wa), _p(flags), _p(amul), _p(nxt),
            ctypes.cast(r_words, ctypes.c_void_p),
            ctypes.cast(om_words, ctypes.c_void_p), t, shift, None) == 0
        assert torch.equal(nxt, fr_kernels.twist_k_bind_plain(
            ra, wa, flags, amul, r, shift))
        amul = nxt


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@needs_engine
@pytest.mark.parametrize("log_k,log_t", [(10, 16), (10, 20), (12, 14)])
def test_card_kernels_equal_tbk_every_round(log_k, log_t):
    """K = 2^10 at T = 2^16 and 2^20, and K = 2^12 (the most buckets a
    walk block holds: its shared memory past the default 48 KB): the card
    route's round evaluations equal the engine's in every k round, and so
    do the j stacks they leave; a round launch a round, a bucket build a
    prove, a bind launch a bind but the last."""
    dev = _card()
    record = _record(log_k, log_t, "random", seed=log_t)
    fr_kernels.reset_launch_counts()
    card = _oracle(record, seed=log_t, device=dev)
    assert isinstance(card._k, twist_k_card.TwistKCard)
    host = _oracle(record, seed=log_t, device="cpu")
    rng = random.Random(log_t)
    try:
        for i in range(log_k):
            assert card.round_evaluations(i) == host.round_evaluations(i), i
            r = Fr(rng.randrange(P))
            card.bind(r)
            host.bind(r)
        counts = fr_kernels.launch_counts()
        assert counts["twist_k_round"] == log_k
        assert counts["twist_k_buckets"] == 1
        assert counts["twist_k_bind"] == log_k - 1
        s = twist_cube_slots(log_k)
        for f in (s.val, s.ic, s.eqs, s.chi_w[0]):
            assert torch.equal(fr_ops.canon(card.tables[f]).cpu(),
                               fr_ops.canon(host.tables[f])), f
    finally:
        card.release()
        host.release()


@pytest.mark.cuda
@needs_engine
def test_card_route_peak_memory_not_above_the_host_route(monkeypatch):
    """A TwistBits prove at K = 2^10, T = 2^16 on the card: the same bytes
    and no higher ``max_memory_allocated`` with the k rounds on the card
    than with them on the host route; log K ``k_device_rounds``."""
    dev = _card()
    tr = _trace(10, 16, seed=16)
    pp = setup_params(14)[0]
    peaks, proofs = {}, {}
    for route in ("host", "card", "host"):
        if route == "host":
            monkeypatch.setattr(twist_k_card, "on_card",
                                lambda device, lk: False)
        else:
            monkeypatch.undo()
        timer = PhaseTimer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        proof = TwistBits.prove(tr, pp, dev, timer)
        torch.cuda.synchronize()
        peaks[route] = torch.cuda.max_memory_allocated(dev)
        proofs.setdefault(route, TwistBits.to_bytes(proof))
        assert timer.counters.get("k_device_rounds", 0) == (
            10 if route == "card" else 0)
    assert proofs["card"] == proofs["host"]
    assert peaks["card"] <= peaks["host"], peaks
