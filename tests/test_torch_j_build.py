"""TwistBits' j-phase tables built on the device: the Val prefix scan
(``fr_kernels.prefix_scan``) and the j stack of ``TwistBitsSparseOracle``.

On the CPU: the scan's plain version against Python-int prefix sums, of
the values and of the write weights, on lazy [0, 2p) inputs and the write
patterns at the edges; the scan's CUDA source compiled by g++ against a
mock of the CUDA runtime that runs each block's threads as threads (its
barriers and warp shuffles included) and held against the plain version;
the oracle's V slot against the host walk that built V before the scan;
phase B's v_val, V's slot after the j binds, against the direct sum over
the write cycles; the counter ``j_scan_lanes``.  Marked ``cuda``: the
kernel against its plain version at T = 2^16 and 2^20, and the oracle's
V slot on the card against the CPU's.

Imports nothing of the JAX package: the reference walk is here."""

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
from tnsh_torch.iop.bits_oracle import TwistBitsSparseOracle, twist_cube_slots
from tnsh_torch.poly.eq import eq_table, lt_partial_table
from tnsh_torch.protocols.bit_columns import BitColumns
from tnsh_torch.protocols.shout import LookupTable
from tnsh_torch.protocols.sound import _kinv
from tnsh_torch.protocols.twist import MemoryTrace
from tnsh_torch.protocols.twist_bits import ShoutBits, TwistBits, setup_params
from tnsh_torch.utils.profiling import PhaseTimer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: write patterns of the scan's cases: which lanes carry a write flag
PATTERNS = ("random", "none", "all", "ends", "zero_ic")


def _lazy_words(vals):
    """Raw values in [0, 2p) as an ``(8, N)`` int32 tensor."""
    words = np.array([limbs.int_to_words(v) for v in vals], dtype=np.uint32)
    return torch.from_numpy(words.T.copy().view(np.int32))


def _scan_case(pattern: str, n: int, log_k: int, seed: int):
    """(raw values, write flags, addresses, r): lazy-domain values with
    the domain's edges among them, flags by ``pattern``."""
    rng = random.Random(seed)
    edge = [0, 1, P - 1, P, P + 1, 2 * P - 1]
    vals = [edge[i] if i < len(edge) else rng.randrange(2 * P)
            for i in range(n)]
    flags = {"random": [rng.random() < 1 / 3 for _ in range(n)],
             "none": [False] * n, "all": [True] * n,
             "ends": [j in (0, n - 1) for j in range(n)],
             "zero_ic": [True] * n}[pattern]
    if pattern == "zero_ic":
        # ot set where ic is zero, both of its representations
        for j in range(0, n, 2):
            vals[j] = P if j % 4 else 0
    addr = [rng.randrange(1 << log_k) for _ in range(n)]
    r = [rng.randrange(P) for _ in range(log_k)]
    return vals, flags, addr, r


def _int_scan(vals, flags=None, addr=None, r=()):
    """Exclusive prefix sums in Python ints of the values (Montgomery raw
    words) or of their write weights."""
    out, acc = [], 0
    for j, v in enumerate(vals):
        out.append(acc)
        w = v * limbs.R_INV % P
        if flags is not None:
            if not flags[j]:
                continue
            for m, rm in enumerate(r):
                w = w * (rm if addr[j] >> m & 1 else 1 - rm) % P
        acc = (acc + w) % P
    return out


def _weight(n, flags=None, addr=None, r=(), device="cpu"):
    """``prefix_scan``'s (addr, flags, table): the write weights' with the
    eq table of r, or, without flags, every flag set and a one-entry table
    of one (the plain scan of the values)."""
    if flags is None:
        return (torch.zeros(n, dtype=torch.int32, device=device),
                torch.ones(n, dtype=torch.bool, device=device),
                limbs.scalar(1, device))
    return (torch.tensor(addr, dtype=torch.int32, device=device),
            torch.tensor(flags, device=device),
            limbs.pack(eq_table(r), device))


@pytest.mark.parametrize("log_n", [1, 10, 12])
@pytest.mark.parametrize("pattern", (None,) + PATTERNS)
def test_plain_scan_equals_python_ints(log_n, pattern):
    n, log_k = 1 << log_n, 10
    vals, flags, addr, r = _scan_case(pattern or "random", n, log_k,
                                      seed=log_n)
    values = _lazy_words(vals)
    out = torch.full_like(values, -1)
    if pattern is None:
        fr_kernels.prefix_scan(values, out, *_weight(n))
        want = _int_scan(vals)
    else:
        fr_kernels.prefix_scan(values, out, *_weight(n, flags, addr, r))
        want = _int_scan(vals, flags, addr, r)
    raw = limbs.raw_ints(out)
    assert all(v < 2 * P for v in raw)
    assert limbs.unpack(out) == want


def test_scan_arguments_are_checked():
    values = torch.zeros((8, 16), dtype=torch.int32)
    addr = torch.zeros(16, dtype=torch.int32)
    flags = torch.zeros(16, dtype=torch.bool)
    table = limbs.pack(eq_table([3, 4]), "cpu")
    out = torch.empty_like(values)
    with pytest.raises(ValueError, match="out"):
        fr_kernels.prefix_scan(values, torch.zeros((8, 8), dtype=torch.int32),
                               addr, flags, table)
    with pytest.raises(ValueError, match="addr"):
        fr_kernels.prefix_scan(values, out, addr.long(), flags, table)
    with pytest.raises(ValueError, match="flags"):
        fr_kernels.prefix_scan(values, out, addr, flags[:8], table)
    for bad in (table[:, :3].contiguous(), table[:, :0].contiguous()):
        with pytest.raises(ValueError, match="table"):
            fr_kernels.prefix_scan(values, out, addr, flags, bad)


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
// memory is static, __syncthreads a barrier of the block, a shuffle an
// exchange between two barriers of the warp.
static std::barrier<>* block_barrier;
static std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
static uint32_t shfl_slots[1024];
#define __syncthreads() block_barrier->arrive_and_wait()
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int d) {
  std::barrier<>& bar = *warp_barriers[threadIdx.x / 32];
  shfl_slots[threadIdx.x] = v;
  bar.arrive_and_wait();
  const uint32_t r =
      (int)(threadIdx.x % 32) >= d ? shfl_slots[threadIdx.x - d] : v;
  bar.arrive_and_wait();
  return r;
}
inline unsigned __match_any_sync(unsigned, int) { return 1u; }
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
def host_scan(tmp_path_factory):
    """``csrc/fr_kernels.cu`` built by g++ with the threaded mock: the
    scan's three launches become ``host_launch`` calls (every block and
    thread of the grid); the other kernels are compiled, not run."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("fr_scan_host")
    csrc = os.path.join(REPO, "tnsh_torch", "csrc")
    field = open(os.path.join(csrc, "field.cuh")).read()
    src = open(os.path.join(csrc, "fr_kernels.cu")).read()
    src = src.replace("extern __shared__ uint32_t sh[];",
                      "static uint32_t sh[1];")
    src, launches = re.subn(
        r"(fr_scan_\w+(?:<\w+>)?)<<<(.*?),(.*?),.*?>>>\((.*?)\);",
        r"host_launch(dim3(\2), dim3(\3), [&] { \1(\4); });", src,
        flags=re.S)
    assert launches == 3
    (tmp / "field.cuh").write_text(re.sub(r"<<<.*?>>>", "", field,
                                          flags=re.S))
    (tmp / "fr_kernels.cpp").write_text(re.sub(r"<<<.*?>>>", "", src,
                                               flags=re.S))
    (tmp / "cuda_runtime.h").write_text(_MOCK_RUNTIME)
    lib_path = tmp / "libfr_scan_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I",
         str(tmp), str(tmp / "fr_kernels.cpp"), "-o", str(lib_path)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib = ctypes.CDLL(str(lib_path))
    lib.tnsh_fr_prefix_scan_blocks.argtypes = [i64]
    lib.tnsh_fr_prefix_scan.argtypes = [vp, vp, vp, vp, i64, vp, vp, i64,
                                        vp]
    return lib


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("n,pattern", [(1, None), (7, "random"),
                                       (1024, "ends"), (1025, None),
                                       (2100, "random"), (2100, "zero_ic")])
def test_cuda_scan_on_the_host_matches_the_plain_version(host_scan, n,
                                                         pattern):
    """One block, a block and a lane, and three blocks (the totals' scan
    and the offsets' pass), of the values and of the write weights."""
    log_k = 10
    vals, flags, addr, r = _scan_case(pattern or "random", n, log_k, seed=n)
    values = _lazy_words(vals)
    weight = (_weight(n) if pattern is None
              else _weight(n, flags, addr, r))
    totals = torch.zeros((host_scan.tnsh_fr_prefix_scan_blocks(n), 8),
                         dtype=torch.int32)
    out = torch.full_like(values, -1)
    assert host_scan.tnsh_fr_prefix_scan(
        _p(values), *map(_p, weight), weight[2].shape[1], _p(out),
        _p(totals), n, None) == 0
    want = torch.empty_like(values)
    fr_kernels.prefix_scan_plain(values, want, *weight)
    assert limbs.unpack(out) == limbs.unpack(want)
    assert all(v < 2 * P for v in limbs.raw_ints(out))


# ---------------------------------------------------------------------------
# the oracle's j stack
# ---------------------------------------------------------------------------

def _columns(log_k: int, log_t: int, seed: int, pattern: str = "random"):
    """TwistBits' committed columns of a random trace, simulated as the
    prover does (``TwistBits._prove``): rb, wb, ot, rv, wv, ic."""
    rng = random.Random(seed)
    k_size, t_size = 1 << log_k, 1 << log_t
    rb = [[0] * t_size for _ in range(log_k)]
    wb = [[0] * t_size for _ in range(log_k)]
    ot, rv, wv, ic = ([0] * t_size for _ in range(4))
    mem = [0] * k_size
    for j in range(t_size):
        write = {"random": rng.random() < 1 / 3, "none": False,
                 "all": True, "ends": j in (0, t_size - 1)}[pattern]
        a = rng.randrange(k_size)
        if write:
            v = rng.randrange(P)
            ot[j] = 1
            for i in range(log_k):
                wb[i][j] = (a >> i) & 1
            wv[j], ic[j] = v, (v - mem[a]) % P
            mem[a] = v
        else:
            for i in range(log_k):
                rb[i][j] = (a >> i) & 1
            rv[j] = mem[a]
    return rb, wb, ot, rv, wv, ic


def _host_v(wb, ot, ic, r_k):
    """V~(r_k, j) as the host walked it before the scan kernel: A^w(j) =
    Π_m chi(r_m, wb_m(j)) over the write cycles, then the prefix sums
    V(j) = Σ_{j' < j, write} ic(j') A^w(j')."""
    log_k, t_size = len(wb), len(ot)
    om = [(1 - r) % P for r in r_k]
    aw_of = {}
    for j in np.flatnonzero(np.asarray(ot)).tolist():
        aw = 1
        for m in range(log_k):
            aw = aw * (r_k[m] if wb[m][j] else om[m]) % P
        aw_of[j] = aw
    vj, cur = [0] * t_size, 0
    for j in range(t_size):
        vj[j] = cur
        aw = aw_of.get(j)
        if aw is not None:
            cur = (cur + ic[j] * aw) % P
    return vj


def _record(cols, log_k, log_t):
    """The columns as the prover's marshalled ``BitColumns`` record: each
    cycle's address from its bits."""
    rb, wb, ot, rv, wv, ic = cols

    def addr(bits):
        return sum(np.asarray(b, dtype=np.int64) << i
                   for i, b in enumerate(bits))

    record = BitColumns(log_k, log_t, addr(rb), addr(wb),
                        np.asarray(ot, dtype=np.bool_), [rv, wv, ic])
    record.marshal()
    return record


def _oracle(cols, log_k, log_t, device, seed):
    """A ``TwistBitsSparseOracle`` over the columns with random
    challenges, its k phase bound at random r_k: (oracle, r_k)."""
    rng = random.Random(seed)

    def pt(n):
        return [Fr(rng.randrange(P)) for _ in range(n)]

    oracle = TwistBitsSparseOracle(
        _record(cols, log_k, log_t), rho1=pt(log_t), sigma_k=pt(log_k),
        sigma_j=pt(log_t), rhob=pt(log_t),
        alpha_powers=[rng.randrange(P) for _ in range(3 + 2 * log_k)],
        kinv=_kinv(log_k), degree=log_k + 3, device=device,
        native=_native.available)
    r_k = pt(log_k)
    for c in r_k:
        oracle.bind(c)
    return oracle, [int(c) for c in r_k]


@pytest.mark.parametrize("log_k,log_t,pattern", [
    (2, 6, "random"), (4, 7, "ends"), (4, 5, "none"), (4, 5, "all"),
    (10, 8, "random")])
def test_oracle_v_slot_equals_the_host_walk(log_k, log_t, pattern):
    cols = _columns(log_k, log_t, seed=log_k + log_t, pattern=pattern)
    oracle, r_k = _oracle(cols, log_k, log_t, "cpu", seed=log_k)
    try:
        s = twist_cube_slots(log_k)
        assert oracle.tables.shape == (s.count, 8, 1 << log_t)
        _, wb, ot, _, _, ic = cols
        assert limbs.unpack(oracle.tables[s.val]) == _host_v(wb, ot, ic,
                                                             r_k)
        assert limbs.unpack(oracle.tables[s.ic]) == ic
        assert torch.equal(oracle.wbits.long(),
                           torch.tensor(wb, dtype=torch.long))
    finally:
        oracle.release()


@pytest.mark.parametrize("log_k,log_t", [(3, 6), (10, 7)])
def test_v_slot_after_the_j_binds_is_phase_b_claim(log_k, log_t):
    """V's slot folded at r_j is Σ_j lt~(j, r_j) ot(j) ic(j) A^w(j), the
    claim phase B proves (the sum the prover computed before)."""
    cols = _columns(log_k, log_t, seed=7 * log_k)
    oracle, r_k = _oracle(cols, log_k, log_t, "cpu", seed=log_t)
    try:
        rng = random.Random(log_k * log_t)
        r_j = [Fr(rng.randrange(P)) for _ in range(log_t)]
        for c in r_j:
            oracle.bind(c)
        v_val = limbs.unpack(oracle.tables[twist_cube_slots(log_k).val])[0]
    finally:
        oracle.release()
    _, wb, ot, _, _, ic = cols
    lt = lt_partial_table(log_t, r_j)
    want = 0
    for j in range(1 << log_t):
        if ot[j]:
            aw = 1
            for m in range(log_k):
                aw = aw * (r_k[m] if wb[m][j] else 1 - r_k[m]) % P
            want += int(lt[j]) * ic[j] % P * aw
    assert v_val == want % P


@pytest.mark.parametrize("prover", ["twist_bits", "twist_bits_dense",
                                    "shout_bits"])
def test_j_scan_lanes_counts_the_structured_twist_prove(prover,
                                                        monkeypatch):
    """T a structured TwistBits prove; nothing in a dense TwistBits or a
    ShoutBits prove, which build no such table."""
    log_t = 6
    rng = random.Random(3)
    pp = setup_params(4)[0]
    timer = PhaseTimer()
    if prover == "shout_bits":
        tbl = LookupTable([Fr(3 * i + 1) for i in range(8)])
        for _ in range((1 << log_t) - 1):
            tbl.lookup(rng.randrange(8))
        ShoutBits.prove(tbl, pp, "cpu", timer)
    else:
        if prover == "twist_bits_dense":
            monkeypatch.setenv("TNSH_BITS_DENSE", "1")
        tr = MemoryTrace(8)
        for i in range(1 << log_t):
            if i % 3 == 0:
                tr.write(rng.randrange(8), Fr(42 * i + 1))
            else:
                tr.read(rng.randrange(8))
        TwistBits.prove(tr, pp, "cpu", timer)
    want = 1 << log_t if prover == "twist_bits" else 0
    assert timer.counters.get("j_scan_lanes", 0) == want


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [16, 20])
def test_card_scan_equals_plain(log_n):
    """The kernel against its plain version on the same device tensors,
    the write weights at K = 2^10 with a third of the lanes written, and
    the plain scan of the values; canonical values equal, the kernel's in
    [0, 2p); one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    n, log_k = 1 << log_n, 10
    gen = np.random.default_rng(log_n)
    words = gen.integers(0, 1 << 32, (8, n), dtype=np.uint64)
    words[7] %= 0x60C89CE5  # below 2p's top limb: the lazy [0, 2p)
    values = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
    addr = torch.from_numpy(gen.integers(0, 1 << log_k, n,
                                         dtype=np.int32)).to(dev)
    flags = torch.from_numpy(gen.random(n) < 1 / 3).to(dev)
    table = limbs.pack(eq_table(
        [int(x) for x in gen.integers(0, 1 << 62, log_k)]), dev)
    fr_kernels.reset_launch_counts()
    for weight in (_weight(n, device=dev), (addr, flags, table)):
        out = torch.empty_like(values)
        fr_kernels.prefix_scan(values, out, *weight)
        want = torch.empty_like(values)
        fr_kernels.prefix_scan_plain(values, want, *weight)
        torch.cuda.synchronize()
        got_c = fr_ops.canon(out)
        assert torch.equal(got_c, fr_ops.canon(want))
        assert torch.equal(fr_ops.canon(got_c), got_c)
    assert fr_kernels.launch_counts()["prefix_scan"] == 2


@pytest.mark.cuda
def test_card_oracle_v_slot_equals_the_cpu():
    """The j stack built on the card at K = 2^10, T = 2^16 equals the
    CPU's (plain versions), slot for slot, V's included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    log_k, log_t = 10, 16
    cols = _columns(log_k, log_t, seed=16)
    stacks = []
    for device in ("cpu", torch.device("cuda", 0)):
        oracle, _ = _oracle(cols, log_k, log_t, device, seed=16)
        try:
            stacks.append(fr_ops.canon(
                oracle.tables.transpose(0, 1)).cpu())
        finally:
            oracle.release()
    assert torch.equal(stacks[0], stacks[1])
