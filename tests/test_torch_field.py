"""The port's Fr layer against the JAX package: limb layout, plain field
ops, the chain kernel's plain version and the CUDA source's constants.

Every comparison is exact equality of canonical field elements
(tolerance 0: the arithmetic is exact integer arithmetic).  Inputs come
from seeded generators and go to both packages."""

import os
import random
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnsh.field.fr import MODULUS, FrTable
from tnsh.field.fr_jax import fr_add, fr_mont_mul, fr_ops, fr_sub
from tnsh.field.limbs import FR_SPEC, pack_ints, unpack_ints
from tnsh_torch.field import fr_kernels, fr_ops as tops, limbs

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

P = MODULUS
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _values(seed, n):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)] + [0, 1, P - 1, P - 2]


def _port(vals):
    return limbs.pack(vals, "cpu")


def _jax(vals):
    return jnp.asarray(pack_ints(vals, FR_SPEC))


def _jax_canon(planes):
    return unpack_ints(np.asarray(planes), FR_SPEC)


def _raw(values):
    """Raw (8, N) words of already-encoded values, no conversion."""
    return torch.from_numpy(limbs.canonical_words(
        b"".join(v.to_bytes(32, "little") for v in values)))


def test_pack_unpack_roundtrip():
    vals = _values(1, 40)
    assert limbs.unpack(_port(vals)) == vals
    # bytes-backed FrTable, raw LE bytes, small ints and unreduced ints
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    assert limbs.unpack(limbs.pack(FrTable(raw), "cpu")) == vals
    assert limbs.unpack(limbs.pack(raw, "cpu")) == vals
    small = list(range(17))
    assert limbs.unpack(limbs.pack(small, "cpu")) == small
    assert limbs.unpack(limbs.pack([P + 5, -1], "cpu")) == [5, P - 1]
    assert limbs.unpack(limbs.scalar(P - 3, "cpu")) == [P - 3]


def test_jax_planes_conversion():
    vals = _values(2, 30)
    planes = pack_ints(vals, FR_SPEC)
    words = limbs.from_jax_planes(planes)
    assert words.shape == (8, len(vals)) and words.dtype == np.int32
    assert limbs.unpack(torch.from_numpy(words)) == vals
    assert np.array_equal(limbs.to_jax_planes(_port(vals)), planes)
    # lazily reduced JAX planes (value + p in the 2p domain) convert too
    lazy = fr_ops.add(jnp.asarray(planes), jnp.asarray(
        pack_ints([0] * len(vals), FR_SPEC)))
    assert limbs.unpack(torch.from_numpy(
        limbs.from_jax_planes(np.asarray(lazy)))) == vals


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mont_mul"])
def test_plain_ops_match_jax(op):
    xs = _values(10, 50)
    ys = list(reversed(_values(11, 50)))
    ax, ay = _port(xs), _port(ys)
    jx, jy = _jax(xs), _jax(ys)
    if op == "neg":
        got = limbs.unpack(tops.neg(ax))
        want = _jax_canon(fr_ops.neg(jx))
        assert want == [(-x) % P for x in xs]
    else:
        got = limbs.unpack(getattr(tops, op)(ax, ay))
        jfn = {"add": fr_add, "sub": fr_sub, "mont_mul": fr_mont_mul}[op]
        want = _jax_canon(jfn(jx, jy))
    assert got == want


def test_chained_2p_domain_matches_jax():
    # (a*b + a - b) * b stays exact across the lazy-reduction domain
    xs, ys = _values(13, 16), _values(14, 16)
    ax, ay = _port(xs), _port(ys)
    got = tops.mont_mul(tops.sub(tops.add(tops.mont_mul(ax, ay), ax), ay), ay)
    jx, jy = _jax(xs), _jax(ys)
    want = fr_mont_mul(fr_sub(fr_add(fr_mont_mul(jx, jy), jx), jy), jy)
    assert limbs.unpack(got) == _jax_canon(want) == [
        (x * y % P + x - y) * y % P for x, y in zip(xs, ys)]


def test_raw_2p_domain_inputs_and_both_zeros():
    """Raw words in [p, 2p) are valid lazily reduced inputs: every op
    treats them as their value mod p, and zero is 0 or p."""
    rng = random.Random(15)
    a_raw = [P + rng.randrange(P) for _ in range(12)] + [P, 0, 2 * P - 1]
    b_raw = [rng.randrange(2 * P) for _ in range(len(a_raw))]
    a, b = _raw(a_raw), _raw(b_raw)
    val = lambda v: v * limbs.R_INV % P  # noqa: E731
    av, bv = [val(v) for v in a_raw], [val(v) for v in b_raw]
    assert limbs.unpack(tops.mont_mul(a, b)) == [
        x * y % P for x, y in zip(av, bv)]
    assert limbs.unpack(tops.add(a, b)) == [
        (x + y) % P for x, y in zip(av, bv)]
    assert limbs.unpack(tops.sub(a, b)) == [
        (x - y) % P for x, y in zip(av, bv)]
    assert limbs.unpack(tops.neg(a)) == [(-x) % P for x in av]
    # outputs stay in [0, 2p); canon brings them to [0, p)
    for out in (tops.mont_mul(a, b), tops.add(a, b), tops.sub(a, b)):
        assert all(v < 2 * P for v in limbs.raw_ints(out))
    assert all(v < P for v in limbs.raw_ints(tops.canon(a)))
    zeros = tops.is_zero(a).tolist()
    assert zeros[-3:] == [True, True, False] and not any(zeros[:-3])
    assert limbs.raw_ints(tops.from_mont(_port([0, 7]))) == [0, 7]
    assert limbs.raw_ints(tops.to_mont(_raw([7]))) == [7 * limbs.R % P]


def test_mont_mul_chain_plain_matches_iterated_jax():
    xs, ys = _values(20, 28), _values(21, 28)
    iters = 5
    got = fr_kernels.mont_mul_chain_plain(_port(xs), _port(ys), iters)
    want = _jax(xs)
    jy = _jax(ys)
    for _ in range(iters):
        want = fr_mont_mul(want, jy)
    assert limbs.unpack(got) == _jax_canon(want)


def test_chain_wrapper_routes_cpu_to_plain():
    xs, ys = _values(22, 12), _values(23, 12)
    x = torch.stack([_port(xs), _port(ys)])       # (2, 8, n) batch
    y = limbs.scalar(3, "cpu")                     # (8, 1) broadcast
    before = fr_kernels.launch_counts()
    out = fr_kernels.mont_mul_chain(x, y, 4)
    assert fr_kernels.launch_counts() == before   # no kernel on the CPU
    assert limbs.unpack(out[0]) == [v * 81 % P for v in xs]
    assert limbs.unpack(out[1]) == [v * 81 % P for v in ys]
    assert torch.equal(out, fr_kernels.mont_mul_chain_plain(x, y, 4))


def test_wrappers_reject_bad_inputs():
    t = _port(list(range(8)))
    with pytest.raises(TypeError):
        fr_kernels.mont_mul_chain(t.to(torch.int64), t, 1)
    with pytest.raises(ValueError):
        fr_kernels.mont_mul_chain(t, t[:, :3].contiguous(), 1)
    with pytest.raises(ValueError):
        fr_kernels.mont_mul_chain(t[:, ::2], t[:, ::2].contiguous(), 1)
    with pytest.raises(ValueError):
        fr_kernels.fold(t[:, :6].contiguous().unsqueeze(0), 5)  # 6 lanes
    with pytest.raises(ValueError):
        fr_kernels.terms([(0, 1), ()], "cpu")


def test_cuda_source_constants_match_the_field():
    """The moduli, 2p and n0' of both fields in the shared CUDA header, and
    Fq's Montgomery one in the MSM kernels, against the port's specs."""
    csrc = os.path.join(REPO, "tnsh_torch", "csrc")
    src = open(os.path.join(csrc, "field.cuh")).read()
    msm = open(os.path.join(csrc, "msm_kernels.cu")).read()

    def words(name, text=src):
        body = re.search(name + r"\[L\] = \{([^}]*)\}", text).group(1)
        return [int(w.strip().rstrip("u"), 16) for w in body.split(",")]

    for tag, spec in (("Fr", limbs.FR_SPEC), ("Fq", limbs.FQ_SPEC)):
        p = spec.modulus
        assert words(f"k{tag}P") == limbs.int_to_words(p)
        assert words(f"k{tag}P2") == limbs.int_to_words(2 * p)
        n0 = int(re.search(
            r"struct %sField \{\s*static constexpr uint32_t N0 = "
            r"(0x[0-9a-f]+)u" % tag, src).group(1), 16)
        assert n0 == (-pow(p, -1, 1 << 32)) % (1 << 32) == spec.n0
        assert 4 * p < limbs.R  # the lazy [0, 2p) domain needs 4p < R
    assert limbs.FR_SPEC.modulus == P
    assert words("kFqOne", msm) == limbs.int_to_words(limbs.FQ_SPEC.r_mod_p)
    # the round program's instruction numbers and its shared-memory budget
    frk = open(os.path.join(csrc, "fr_kernels.cu")).read()
    ops = dict(re.findall(r"kOp(\w+) = (\d+),", frk))
    assert {k: int(v) for k, v in ops.items()} == {
        "LoadC": fr_kernels.OP_LOADC, "AddC": fr_kernels.OP_ADDC,
        "Mul": fr_kernels.OP_MUL, "Push": fr_kernels.OP_PUSH,
        "Acc": fr_kernels.OP_ACC, "PopAdd": fr_kernels.OP_POPADD}
    threads = int(re.search(r"kEvalThreads = (\d+);", frk).group(1))
    shared_kb = int(re.search(r"kMaxEvalShared = (\d+) \* 1024;",
                              frk).group(1))
    # the deepest program the host builds leaves a run of one point or more
    assert (1 + fr_kernels.MAX_STACK_SLOTS) * threads * 32 <= shared_kb * 1024


def _code_lines(text):
    """A CUDA source without its // comments."""
    return [line.split("//")[0] for line in text.splitlines()]


def test_device_build_has_one_product_body():
    """One ``fe_mul``, ``fe_add``, ``fe_sub`` and ``fe_reduce_2p`` in the
    shared header, written in the PTX carry-chain instructions; the only
    conditional compilation is the choice between nvcc (inline asm) and a
    host compiler (the instructions emulated), and no condition tests
    ``__CUDA_ARCH__`` or sits inside a function of the field."""
    src = open(os.path.join(REPO, "tnsh_torch", "csrc", "field.cuh")).read()
    code = "\n".join(_code_lines(src))
    for fn in ("fe_mul", "fe_add", "fe_sub", "fe_reduce_2p", "mont_row"):
        assert len(re.findall(r"\bvoid %s\(" % fn, code)) == 1, fn
    conds = re.findall(r"^\s*#\s*(if\w*|elif|else)\b(.*)$", code, flags=re.M)
    assert [(kind, rest.strip()) for kind, rest in conds] == [
        ("ifdef", "__CUDACC__"), ("else", "")]
    assert "__CUDA_ARCH__" not in code
    field_part = code[code.index("fe_reduce_2p"):]
    assert "#if" not in field_part and "#else" not in field_part
    asm = set(re.findall(r'TNSH_PTX[23]\(\w+, "([\w.]+)"\)', code))
    assert asm == {"add.cc.u32", "addc.cc.u32", "addc.u32", "sub.cc.u32",
                   "subc.cc.u32", "subc.u32", "mul.lo.u32", "mul.hi.u32",
                   "mad.lo.cc.u32", "madc.lo.cc.u32", "madc.hi.cc.u32",
                   "madc.hi.u32"}
    # the arithmetic goes through those instructions only: no 64-bit
    # intermediate in the field's functions
    assert "uint64_t" not in field_part.split("fe_chain_kernel")[0]


def test_sm_count_is_asked_of_the_runtime():
    csrc = os.path.join(REPO, "tnsh_torch", "csrc")
    field = "\n".join(_code_lines(open(os.path.join(csrc, "field.cuh")).read()))
    frk = "\n".join(_code_lines(
        open(os.path.join(csrc, "fr_kernels.cu")).read()))
    assert "cudaDevAttrMultiProcessorCount" in field
    for code in (field, frk):
        assert not re.search(r"\b132\b", code)
    assert "sm_count(&sms)" in re.search(
        r"inline cudaError_t grid_for\(.*?\n}", field, flags=re.S).group(0)
    assert "grid_for(" in re.search(
        r"int tnsh_fr_round_evals_blocks\(.*?\n}", frk, flags=re.S).group(0)
    # a failed runtime call reaches the caller: no count is made up
    body = re.search(r"inline cudaError_t sm_count\(.*?\n}", field,
                     flags=re.S).group(0)
    assert body.count("return err;") == 2 and "return 1;" not in body
    assert "-(int)err" in re.search(
        r"int tnsh_fr_round_evals_blocks\(.*?\n}", frk, flags=re.S).group(0)


def test_a_failed_block_count_raises():
    """The library reports a failed runtime call as minus its CUDA error
    code; the wrapper raises instead of launching on a made-up grid."""

    class Lib:
        def __init__(self, answer):
            self.answer = answer

        def tnsh_fr_round_evals_blocks(self, half):
            return self.answer

        def tnsh_cuda_error_string(self, code):
            return b"error %d" % code

    assert fr_kernels._round_evals_blocks(Lib(3), 300) == 3
    with pytest.raises(RuntimeError, match="CUDA error 100"):
        fr_kernels._round_evals_blocks(Lib(-100), 300)


_MOCK_RUNTIME = r"""
#pragma once
#include <cstdint>
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__ static const
#define __restrict__
struct dim3 { unsigned x = 0, y = 0, z = 0; };
static dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 1; return 0; }
"""

_HARNESS = r"""
#include "field.cuh"
using namespace tnsh;
template <class F> static void run(int op, const uint32_t* a,
                                   const uint32_t* b, uint32_t* r) {
  uint32_t x[L], y[L], z[L];
  for (int k = 0; k < L; ++k) { x[k] = a[k]; y[k] = b[k]; }
  if (op == 0) fe_mul<F>(z, x, y);
  if (op == 1) fe_add<F>(z, x, y);
  if (op == 2) fe_sub<F>(z, x, y);
  if (op == 3) { fe_mul<F>(x, x, y); for (int k = 0; k < L; ++k) z[k] = x[k]; }
  for (int k = 0; k < L; ++k) r[k] = z[k];
}
extern "C" void field_op(int fq, int op, const uint32_t* a,
                         const uint32_t* b, uint32_t* r, int n) {
  for (int i = 0; i < n; ++i) {
    if (fq) run<FqField>(op, a + 8 * i, b + 8 * i, r + 8 * i);
    else run<FrField>(op, a + 8 * i, b + 8 * i, r + 8 * i);
  }
}
"""


def test_ptx_schedule_emulated_on_the_host_matches_the_field(tmp_path):
    """``field.cuh`` compiled by g++ against a mock of the CUDA runtime:
    its PTX instructions are emulated one by one (and assert that no
    chain loses a carry), so the product's schedule, the add and the
    subtract run here.  Edge values and random values of the whole lazy
    domain [0, 2p), both fields: raw limbs equal (ab + mp) / R, a + b and
    a - b reduced once against 2p, and stay below 2p."""
    import ctypes
    import shutil

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    src = open(os.path.join(REPO, "tnsh_torch", "csrc", "field.cuh")).read()
    src = re.sub(r"[\w:]+<F><<<.*?>>>\(.*?\);", ";", src, flags=re.S)
    (tmp_path / "field.cuh").write_text(src)
    (tmp_path / "cuda_runtime.h").write_text(_MOCK_RUNTIME)
    (tmp_path / "harness.cpp").write_text(_HARNESS)
    lib_path = tmp_path / "libfield_check.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(tmp_path),
         str(tmp_path / "harness.cpp"), "-o", str(lib_path)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    rng = random.Random(4)
    for fq, spec in ((0, limbs.FR_SPEC), (1, limbs.FQ_SPEC)):
        p = spec.modulus
        edge = [0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p - 2, 0xFFFFFFFF,
                (1 << 254) - 1, ((1 << 256) - 1) % (2 * p)]
        xs = [a for a in edge for _ in edge] + [
            rng.randrange(2 * p) for _ in range(400)]
        ys = edge * len(edge) + [rng.randrange(2 * p) for _ in range(400)]
        n = len(xs)
        a = np.array([limbs.int_to_words(v) for v in xs], dtype=np.uint32)
        b = np.array([limbs.int_to_words(v) for v in ys], dtype=np.uint32)

        def run(op):
            r = np.zeros_like(a)
            lib.field_op(fq, op, a.ctypes.data_as(ctypes.c_void_p),
                         b.ctypes.data_as(ctypes.c_void_p),
                         r.ctypes.data_as(ctypes.c_void_p), n)
            return [sum(int(w) << (32 * k) for k, w in enumerate(row))
                    for row in r]

        def redc(x, y):
            m = (x * y % limbs.R) * (-pow(p, -1, limbs.R) % limbs.R) % limbs.R
            return (x * y + m * p) // limbs.R

        want_mul = [redc(x, y) for x, y in zip(xs, ys)]
        assert run(0) == want_mul
        assert run(3) == want_mul                     # r aliases a
        assert all(v < 2 * p for v in want_mul)
        assert run(1) == [x + y - 2 * p if x + y >= 2 * p else x + y
                          for x, y in zip(xs, ys)]
        assert run(2) == [x - y if x >= y else x - y + 2 * p
                          for x, y in zip(xs, ys)]


def test_port_imports_without_jax():
    """Every module of tnsh_torch imports with jax blocked."""
    code = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked")
        return None

sys.meta_path.insert(0, Block())
import tnsh_torch
names = [m.name for m in pkgutil.walk_packages(tnsh_torch.__path__,
                                                "tnsh_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_chain_kernel_matches_plain_on_card(cuda):
    xs, ys = _values(30, 1020), _values(31, 1020)
    x, y = limbs.pack(xs, cuda), limbs.pack(ys, cuda)
    got = fr_kernels.mont_mul_chain(x, y, 7)
    want = fr_kernels.mont_mul_chain_plain(x, y, 7)
    torch.cuda.synchronize()
    assert limbs.unpack(got) == limbs.unpack(want)
    assert limbs.unpack(got)[:4] == [
        a * pow(b, 7, P) % P for a, b in zip(xs[:4], ys[:4])]
