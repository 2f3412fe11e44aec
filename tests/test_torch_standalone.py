"""The port stands on its own: it imports nothing of ``tnsh`` or ``jax``,
builds its native engine itself, and its host layers (field, curve,
transcript, parameters, polynomials, serialization) give the same values
and bytes as the JAX package's, from the same seeded inputs.

Comparisons are exact.  The two packages share no objects here either:
values cross as ints and bytes.
"""

import os
import random
import re
import subprocess
import threading

import pytest
import torch

import tnsh.core.params as ref_params
import tnsh.core.proof_io as ref_proof_io
import tnsh.core.serialize as ref_serialize
import tnsh.core.transcript as ref_transcript
import tnsh.field.fr as ref_fr
import tnsh.field.g1 as ref_g1
import tnsh.field.g2 as ref_g2
import tnsh.poly.eq as ref_eq
import tnsh.poly.interp as ref_interp
import tnsh.poly.lt as ref_lt
import tnsh.poly.mle as ref_mle
from tnsh.commit import kzg as ref_kzg
from tnsh.commit import mkzg as ref_mkzg
from tnsh.core.rng import ChaCha20Rng as RefRng
from tnsh.core.rng import fr_rand as ref_fr_rand
from tnsh_torch import _build, _native
from tnsh_torch.commit import kzg, mkzg
from tnsh_torch.core import params, proof_io, serialize, transcript
from tnsh_torch.core.rng import ChaCha20Rng, fr_rand
from tnsh_torch.field import fr, g1, g2, pairing
from tnsh_torch.poly import eq, interp, lt, mle_host

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = fr.MODULUS


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "tnsh_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_no_port_source_imports_tnsh_or_jax():
    pat = re.compile(r"^\s*(from|import) +(tnsh|jax|jaxlib)\b", re.M)
    sources = _port_sources()
    assert len(sources) >= 30
    bad = [p for p in sources if pat.search(open(p).read())]
    assert not bad, bad


def test_native_engine_lives_under_build_not_in_the_package():
    assert _native.available
    lib = _build.native_library_path()
    assert lib.startswith(os.path.join(REPO, "build", "tnsh_torch") + os.sep)
    pkg = os.path.join(REPO, "tnsh_torch")
    assert not [f for _, _, fs in os.walk(pkg) for f in fs
                if f.endswith(".so")]
    assert os.path.exists(os.path.join(pkg, "csrc", "tnsh_native.cpp"))


@pytest.fixture
def tiny_target(tmp_path, monkeypatch):
    """A one-function C++ target in a private source and build directory."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "tiny.cpp").write_text(
        '#include "tiny.h"\nextern "C" int tiny() { return TINY; }\n')
    (src / "tiny.h").write_text("#define TINY 7\n")
    monkeypatch.setattr(_build, "_CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setitem(
        _build._TARGETS, "tiny",
        ("g++", ["-shared", "-fPIC", "-I", str(src)], "tiny.cpp", ["tiny.h"],
         "libtiny.so"))
    return src


def test_concurrent_builds_compile_once(tiny_target, monkeypatch):
    """Many workers asking for one library: the lock lets one compile and
    the others wait for its file."""
    compiles = []
    real_popen = subprocess.Popen

    def counting_popen(argv, **kw):
        compiles.append(argv)
        return real_popen(argv, **kw)

    monkeypatch.setattr(_build.subprocess, "Popen", counting_popen)
    results, errors = [], []

    def work():
        try:
            results.append(_build.build("tiny"))
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(set(results)) == 1 and os.path.exists(results[0])
    assert len(compiles) == 1
    import ctypes

    assert ctypes.CDLL(results[0]).tiny() == 7


def test_build_hash_covers_the_header_and_a_failed_build_raises(tiny_target):
    first = _build.build("tiny")
    (tiny_target / "tiny.h").write_text("#define TINY 8\n")
    second = _build.build("tiny")
    assert os.path.dirname(second) != os.path.dirname(first)
    (tiny_target / "tiny.h").write_text("#define TINY 8 +;\n")
    with pytest.raises(RuntimeError, match="error"):
        _build.build("tiny")


def test_pure_python_path_runs_only_when_asked(monkeypatch):
    rng = random.Random(9)
    g = g1.G1.generator()
    pts = [g * rng.randrange(1, 10 ** 6) for _ in range(6)]
    scs = [fr.Fr(rng.randrange(P)) for _ in range(6)]
    native = kzg.host_msm(pts, scs)
    assert kzg.host_msm(pts, scs, native=False) == native
    monkeypatch.setenv("TNSH_NO_NATIVE", "1")
    assert _native.available is False
    assert int(eq.eq_eval(scs[:3], scs[3:])) == int(
        ref_eq.eq_eval([ref_fr.Fr(int(s)) for s in scs[:3]],
                       [ref_fr.Fr(int(s)) for s in scs[3:]]))


# ---------------------------------------------------------------------------
# Host layers against tnsh's, value for value
# ---------------------------------------------------------------------------

def _ints(seed, n):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def test_fr_arithmetic_and_rng_equal_tnsh():
    a, b = _ints(1, 2)
    for op in ("__add__", "__sub__", "__mul__"):
        assert int(getattr(fr.Fr(a), op)(fr.Fr(b))) == int(
            getattr(ref_fr.Fr(a), op)(ref_fr.Fr(b)))
    assert int(fr.Fr(a).inverse()) == int(ref_fr.Fr(a).inverse())
    assert fr.Fr(a).to_bytes_le() == ref_fr.Fr(a).to_bytes_le()
    assert [int(v) for v in fr.batch_inverse([fr.Fr(a), fr.Fr(b)])] == [
        int(v) for v in ref_fr.batch_inverse([ref_fr.Fr(a), ref_fr.Fr(b)])]
    seed = bytes(range(32))
    rp, rr = ChaCha20Rng.from_seed(seed), RefRng.from_seed(seed)
    assert [int(fr_rand(rp)) for _ in range(5)] == [
        int(ref_fr_rand(rr)) for _ in range(5)]
    assert rp.fill_bytes(32) == rr.fill_bytes(32)


def test_transcript_challenges_equal_tnsh():
    seed = bytes([42]) * 32
    tp, tr = transcript.Transcript(seed), ref_transcript.Transcript(seed)
    vals = _ints(2, 6)
    tp.append_field_element(b"one", fr.Fr(vals[0]))
    tr.append_field_element(b"one", ref_fr.Fr(vals[0]))
    tp.append_field_elements(b"many", [fr.Fr(v) for v in vals])
    tr.append_field_elements(b"many", [ref_fr.Fr(v) for v in vals])
    assert int(tp.challenge_field_element(b"c")) == int(
        tr.challenge_field_element(b"c"))
    assert [int(c) for c in tp.challenge_field_elements(b"cs", 4)] == [
        int(c) for c in tr.challenge_field_elements(b"cs", 4)]


@pytest.mark.parametrize("n_vars", [4, 12])
def test_eq_and_lt_tables_equal_tnsh(n_vars):
    """Below and above the size where the tables are built natively."""
    point = _ints(3 + n_vars, n_vars)
    other = _ints(30 + n_vars, n_vars)
    pp, rp = [fr.Fr(v) for v in point], [ref_fr.Fr(v) for v in point]
    po, ro = [fr.Fr(v) for v in other], [ref_fr.Fr(v) for v in other]
    assert [int(v) for v in eq.eq_table(pp)] == [
        int(v) for v in ref_eq.eq_table(rp)]
    assert [int(v) for v in eq.lt_partial_table(n_vars, pp)] == [
        int(v) for v in ref_eq.lt_partial_table(n_vars, rp)]
    assert int(eq.eq_eval(pp, po)) == int(ref_eq.eq_eval(rp, ro))
    assert int(eq.lt_eval(pp, po)) == int(ref_eq.lt_eval(rp, ro))


def test_interpolation_mle_and_lt_polynomial_equal_tnsh():
    vals = _ints(5, 16)
    assert [int(c) for c in interp.interpolate_on_range(
        [fr.Fr(v) for v in vals])] == [int(c) for c in
                                       ref_interp.interpolate_on_range(
                                           [ref_fr.Fr(v) for v in vals])]
    pts = [(fr.Fr(i * 3 + 1), fr.Fr(v)) for i, v in enumerate(vals[:5])]
    rpts = [(ref_fr.Fr(i * 3 + 1), ref_fr.Fr(v))
            for i, v in enumerate(vals[:5])]
    assert [int(c) for c in interp.lagrange_interpolate(pts)] == [
        int(c) for c in ref_interp.lagrange_interpolate(rpts)]
    point = _ints(6, 4)
    m = mle_host.MultilinearExtension.from_evaluations(
        [fr.Fr(v) for v in vals])
    rm = ref_mle.MultilinearExtension.from_evaluations(
        [ref_fr.Fr(v) for v in vals])
    assert int(m.evaluate([fr.Fr(v) for v in point])) == int(
        rm.evaluate([ref_fr.Fr(v) for v in point]))
    assert lt.LessThanPolynomial.__name__ == ref_lt.LessThanPolynomial.__name__


def test_curve_points_and_serialization_equal_tnsh():
    k = 987654321
    p, rp = g1.G1.generator() * k, ref_g1.G1.generator() * k
    assert p.to_affine() == rp.to_affine()
    assert serialize.g1_to_bytes(p, compress=True) == \
        ref_serialize.g1_to_bytes(rp, compress=True)
    assert serialize.g1_from_bytes(
        ref_serialize.g1_to_bytes(rp, compress=True)) == p
    q2, rq2 = g2.G2.generator().scalar_mul(k), ref_g2.G2.generator(
    ).scalar_mul(k)
    assert q2.to_affine() == rq2.to_affine()
    assert serialize.g2_to_bytes(q2, compress=True) == \
        ref_serialize.g2_to_bytes(rq2, compress=True)
    assert int(kzg.KZGCommitmentValue(p).hash()) == int(
        ref_kzg.KZGCommitmentValue(rp).hash())
    # e(aG, bH) = e(abG, H): the port's native and pure-Python pairings
    a, b = 5, 7
    g, h = g1.G1.generator(), g2.G2.generator()
    pairs = [((g * a).neg(), h.scalar_mul(b)), (g * (a * b), h)]
    assert _native.pairing_product_is_one(pairs)
    assert pairing.pairing_product_is_one(pairs)
    assert not pairing.pairing_product_is_one(
        [((g * a).neg(), h.scalar_mul(b)), (g * (a * b + 1), h)])


def test_parameters_and_verifier_bytes_equal_tnsh():
    (pp, vp), (rpp, rvp) = params.setup_params(3), ref_params.setup_params(3)
    assert pp.fiat_shamir_seed == rpp.fiat_shamir_seed
    assert proof_io.verifier_params_to_bytes(vp) == \
        ref_proof_io.verifier_params_to_bytes(rvp)
    back = proof_io.verifier_params_from_bytes(
        ref_proof_io.verifier_params_to_bytes(rvp))
    assert back.commitment_vk.g2_tau == vp.commitment_vk.g2_tau
    assert proof_io.MAX_LOG_SIZE == ref_proof_io.MAX_LOG_SIZE
    vk, rvk = (mkzg.multilinear_verification_key(5),
               ref_mkzg.multilinear_verification_key(5))
    assert [t.to_affine() for t in vk.g2_taus] == [
        t.to_affine() for t in rvk.g2_taus]
    ml, _ = mkzg.setup_multilinear_params(5)
    rml, _ = ref_mkzg.setup_multilinear_params(5)
    vals = _ints(7, 32)
    c = mkzg.MultilinearKZG.commit(ml, [fr.Fr(v) for v in vals], "cpu")
    rc = ref_mkzg.MultilinearKZG.commit(rml, [ref_fr.Fr(v) for v in vals])
    assert c.commitment.to_affine() == rc.commitment.to_affine()
