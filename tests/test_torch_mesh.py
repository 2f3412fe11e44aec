"""The port's mesh (``tnsh_torch.parallel.mesh``) against tnsh's on the CPU.

One world of spawned gloo ranks per size (2 and 4) computes every case
once (``_cases``); each case's bytes and ints are then held, exactly,
against tnsh's host oracles at tnsh's own sizes and seeds, and once per
class against tnsh's sharded class on a 4-device virtual mesh.  The
exact field psum runs in this process.

A spawned rank imports this module to find ``_cases``, so the module
imports neither jax nor tnsh at its top: the tests import them where
they use them.
"""

import concurrent.futures
import random

import numpy as np
import pytest
import torch

from tnsh_torch.commit.mkzg_sparse import IncrementalCubeTable, SparseCubeTable
from tnsh_torch.core.proof_io import (
    sumcheck_d_proof_to_bytes,
    sumcheck_proof_to_bytes,
)
from tnsh_torch.core.transcript import Transcript
from tnsh_torch.errors import SumCheckError
from tnsh_torch.field import limbs
from tnsh_torch.field.fr import MODULUS as P
from tnsh_torch.field.fr import Fr
from tnsh_torch.field.g1 import G1
from tnsh_torch.iop.sparse_oracle import SparseCubeOracle
from tnsh_torch.iop.sumcheck import SumCheck
from tnsh_torch.iop.sumcheck_d import DenseSopOracleD, SumCheckD
from tnsh_torch.parallel import mesh as M
from tnsh_torch.poly import mle
from tnsh_torch.poly.mle_host import MultilinearExtension

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

WORLDS = (2, 4)
#: ``cube_python``: the cube oracle's ranks on the Python k phase (the
#: mesh takes it where the native engine is not loaded)
ORACLES = ("product", "sop", "sopd", "cube", "cube_python")
#: the sum-of-products oracles again with tnsh's dryrun cap of one
#: sharded round
CAPPED = ("sop_max1", "sopd_max1", "cube_max1")


# ---------------------------------------------------------------------------
# The cases, at tnsh's sizes and seeds (tests/test_jax_backend.py)
# ---------------------------------------------------------------------------

def _product_inputs():
    random.seed(91)
    a = [random.randrange(P) for _ in range(64)]
    b = [random.randrange(P) for _ in range(64)]
    return 6, a, b, sum(x * y for x, y in zip(a, b)) % P


def _sop_inputs():
    random.seed(93)
    size = 64
    t1 = [random.randrange(P) for _ in range(size)]
    t2 = [random.randrange(P) for _ in range(size)]
    t3 = [random.randrange(2) for _ in range(size)]
    terms = [(1, [t1, t2, t3]), (P - 1, [t1, t3]), (7, [t2])]
    total = sum((a * b * c - a * c + 7 * b) % P
                for a, b, c in zip(t1, t2, t3)) % P
    return 6, terms, total


def _sopd_inputs():
    random.seed(95)
    size = 64
    t1 = [random.randrange(P) for _ in range(size)]
    t2 = [random.randrange(2) for _ in range(size)]
    t3 = [random.randrange(P) for _ in range(size)]
    terms = [(3, [t1, t2, t3, t1, t2]), (P - 5, [t2, t3]),
             (11, [t3, t3, t3])]
    return 6, terms, 5


def _cube_inputs(sparse_cls=SparseCubeTable, inc_cls=IncrementalCubeTable):
    random.seed(97)
    log_k, log_t = 3, 6
    sp = sparse_cls(log_k, log_t)
    inc = inc_cls(log_k, log_t)
    for j in range(1 << log_t):
        sp.set(j, random.randrange(1 << log_k), 1)
        if j % 3:
            inc.add_update(j, random.randrange(1 << log_k),
                           random.randrange(P))
    eqj = [random.randrange(P) for _ in range(1 << log_t)]
    eqk = [random.randrange(P) for _ in range(1 << log_k)]
    terms = [
        (1, [("eqj", eqj), ("colsparse", sp), ("colinc", inc)]),
        (P - 2, [("eqk", eqk), ("colsparse", sp), ("colsparse", sp)]),
        (3, [("eqk", eqk), ("colinc", inc)]),    # class I
        (5, [("eqj", eqj), ("eqk", eqk)]),       # class E
    ]
    return log_k, log_t, terms


def _round_inputs():
    random.seed(51)
    return [[random.randrange(P) for _ in range(64)] for _ in range(2)]


def _msm_inputs(g1_cls=G1, fr_cls=Fr):
    random.seed(52)
    g = g1_cls.generator()
    points = [g * random.randrange(1, 10 ** 9) for _ in range(16)]
    scalars = [fr_cls(random.randrange(P)) for _ in range(16)]
    return points, scalars


def _sumcheck_bytes(num_vars, claim, oracle, seed):
    proof = SumCheck(num_vars, Fr(claim)).prove(oracle, Transcript(seed))
    return sumcheck_proof_to_bytes(proof)


def _proof(case, mesh, cap=None):
    """One complete sharded proof of ``case`` on ``mesh``, as bytes."""
    if case == "product":
        n, a, b, total = _product_inputs()
        factors = [MultilinearExtension.from_evaluations([Fr(v) for v in t])
                   for t in (a, b)]
        return _sumcheck_bytes(n, total, M.ShardedProductMLEOracle(
            factors, mesh), bytes([42]) * 32)
    if case == "sop":
        n, terms, total = _sop_inputs()
        return _sumcheck_bytes(n, total, M.ShardedSumOfProductsOracle(
            n, terms, mesh, max_sharded_rounds=cap), bytes([42]) * 32)
    if case == "sopd":
        n, terms, degree = _sopd_inputs()
        claim = DenseSopOracleD(n, terms, degree=degree).hypercube_sum()
        proof, _ = SumCheckD(n, claim, degree).prove_with_challenges(
            M.ShardedSopOracleD(n, terms, degree, mesh,
                                max_sharded_rounds=cap),
            Transcript(bytes([43]) * 32))
        return sumcheck_d_proof_to_bytes(proof)
    log_k, log_t, terms = _cube_inputs()
    probe = SparseCubeOracle(log_k, log_t, terms, device="cpu")
    ev = probe.round_evaluations(0)
    probe.release()
    return _sumcheck_bytes(
        log_k + log_t, int(ev[0] + ev[1]), M.ShardedSparseCubeOracle(
            log_k, log_t, terms, mesh, max_sharded_rounds=cap,
            use_native=case != "cube_python"),
        bytes([43]) * 32)


def _tail_proofs(mesh):
    """n = 2 variables (4 lanes): with 4 ranks every block holds one lane,
    so each proof runs on the gathered tail from its first round."""
    rng = random.Random(61)
    t1, t2, t3 = ([rng.randrange(P) for _ in range(4)] for _ in range(3))
    bits = [rng.randrange(2) for _ in range(4)]
    out = {}
    factors = [MultilinearExtension.from_evaluations([Fr(v) for v in t])
               for t in (t1, t2)]
    out["product"] = _sumcheck_bytes(
        2, sum(a * b for a, b in zip(t1, t2)) % P,
        M.ShardedProductMLEOracle(factors, mesh), bytes([9]) * 32)
    terms = [(1, [t1, t2, bits]), (P - 1, [t3, bits]), (5, [t2])]
    total = sum((a * b * c - d * c + 5 * b) % P
                for a, b, c, d in zip(t1, t2, bits, t3)) % P
    out["sop"] = _sumcheck_bytes(
        2, total, M.ShardedSumOfProductsOracle(2, terms, mesh),
        bytes([9]) * 32)
    dterms = [(3, [t1, bits, t3, t1]), (P - 5, [bits, t3])]
    claim = DenseSopOracleD(2, dterms, degree=4).hypercube_sum()
    proof, _ = SumCheckD(2, claim, 4).prove_with_challenges(
        M.ShardedSopOracleD(2, dterms, 4, mesh), Transcript(bytes([9]) * 32))
    out["sopd"] = sumcheck_d_proof_to_bytes(proof)
    return out, (t1, t2, t3, bits)


def _errors(mesh):
    """The cube oracle's refusals, by message."""
    log_k, log_t, terms = _cube_inputs()
    out = {}
    three = M.Mesh(None, 0, 3, torch.device("cpu"))
    for name, args in (("world_3", (log_k, log_t, terms, three)),
                       ("log_t", (log_k, mesh.size.bit_length() - 1, terms,
                                  mesh))):
        try:
            M.ShardedSparseCubeOracle(*args)
        except SumCheckError as e:
            out[name] = str(e)
    return out


def _cases(mesh):
    """Every case on one rank of a world; ints and bytes only."""
    torch.set_num_threads(1)
    out = {f"{case}": _proof(case, mesh) for case in ORACLES}
    out.update({case: _proof(case.split("_")[0], mesh, cap=1)
                for case in CAPPED})

    vals = _round_inputs()
    lo, hi = M.block(mesh, 64)
    tables = torch.stack([mle.pack_mle(v, mesh.device) for v in vals])
    evals, folded = M.sharded_round_step(
        mesh, tables[:, :, lo:hi].contiguous(), Fr(424242))
    out["round"] = (limbs.unpack(evals), [limbs.unpack(t) for t in folded])

    points, scalars = _msm_inputs()
    plo, phi = M.block(mesh, len(points))
    got = M.sharded_msm(mesh, points[plo:phi], scalars[plo:phi])
    out["msm"] = got.to_affine() if not got.is_zero() else None

    if mesh.size == 4:
        m2 = M.make_mesh_2d(ici=2, dcn=2, device="cpu")
        vals16 = [(7 * i + 3) % P for i in range(16)]
        x = mle.pack_mle(vals16[4 * mesh.rank:4 * mesh.rank + 4], "cpu")
        out["mesh_2d"] = limbs.unpack(M.psum_field(M.psum_field(x, m2.ici),
                                                   m2.dcn))
        out["tail"] = _tail_proofs(mesh)
    out["errors"] = _errors(mesh)
    out["collectives"] = mesh.collectives
    M.init_distributed(device="cpu", backend="no such backend")
    out["init_again"] = M.make_mesh("cpu").size
    return out


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    """Both worlds start at once, in threads of this process, so their
    ranks work while the tests compute tnsh's side."""
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS))
    futures = {w: pool.submit(M.run_ranks, _cases, w, "cpu")
               for w in WORLDS}
    yield futures
    pool.shutdown(wait=True)


def _ranks(worlds, w):
    return worlds[w].result(timeout=600)


@pytest.fixture(scope="module")
def jax_mesh():
    import jax
    from tnsh.parallel.mesh import make_mesh

    return make_mesh(jax.devices()[:4])


def _ref_proof(case, mesh=None):
    """tnsh's proof of ``case``: its host oracle, or with ``mesh`` its
    sharded class on that JAX mesh (a ``_max1`` case with one sharded
    round)."""
    from tnsh.commit.mkzg_sparse import (
        IncrementalCubeTable as RefInc,
        SparseCubeTable as RefSparse,
    )
    from tnsh.core.proof_io import (
        sumcheck_d_proof_to_bytes as ref_d_bytes,
        sumcheck_proof_to_bytes as ref_bytes,
    )
    from tnsh.core.transcript import Transcript as RefTranscript
    from tnsh.field.fr import Fr as RefFr
    from tnsh.iop import sparse_oracle as ref_sparse
    from tnsh.iop import sumcheck as ref_sc
    from tnsh.iop import sumcheck_d as ref_scd
    from tnsh.parallel import mesh as ref_mesh
    from tnsh.poly.mle import MultilinearExtension as RefMLE

    def prove(n, claim, oracle, seed):
        return ref_bytes(ref_sc.SumCheck(n, RefFr(claim)).prove(
            oracle, RefTranscript(seed)))

    case, _, variant = case.partition("_")
    cap = 1 if variant == "max1" else None
    if case == "product":
        n, a, b, total = _product_inputs()
        factors = [RefMLE.from_evaluations([RefFr(v) for v in t])
                   for t in (a, b)]
        oracle = (ref_sc.ProductMLEOracle(factors) if mesh is None else
                  ref_mesh.ShardedProductMLEOracle(factors, mesh))
        return prove(n, total, oracle, bytes([42]) * 32)
    if case == "sop":
        n, terms, total = _sop_inputs()
        oracle = (ref_sc.SumOfProductsOracle(n, terms) if mesh is None else
                  ref_mesh.ShardedSumOfProductsOracle(
                      n, terms, mesh, max_sharded_rounds=cap))
        return prove(n, total, oracle, bytes([42]) * 32)
    if case == "sopd":
        n, terms, degree = _sopd_inputs()
        claim = ref_scd.DenseSopOracleD(n, terms,
                                        degree=degree).hypercube_sum()
        oracle = (ref_scd.DenseSopOracleD(n, terms, degree=degree)
                  if mesh is None else
                  ref_mesh.ShardedSopOracleD(n, terms, degree, mesh,
                                             max_sharded_rounds=cap))
        proof, _ = ref_scd.SumCheckD(n, claim, degree).prove_with_challenges(
            oracle, RefTranscript(bytes([43]) * 32))
        return ref_d_bytes(proof)
    log_k, log_t, terms = _cube_inputs(RefSparse, RefInc)
    ev = ref_sparse.SparseCubeOracle(log_k, log_t, terms).round_evaluations(0)
    oracle = (ref_sparse.SparseCubeOracle(log_k, log_t, terms)
              if mesh is None else
              ref_mesh.ShardedSparseCubeOracle(log_k, log_t, terms, mesh,
                                               max_sharded_rounds=cap))
    return prove(log_k + log_t, int(ev[0] + ev[1]), oracle, bytes([43]) * 32)


# ---------------------------------------------------------------------------
# The exact field psum, in one process
# ---------------------------------------------------------------------------

def _limb_sums(values_by_term):
    """The int64 sums of the terms' 32-bit limbs, lane by lane."""
    words = np.stack([limbs.canonical_words(
        b"".join(v.to_bytes(32, "little") for v in vals)).view(np.uint32)
        for vals in values_by_term]).astype(np.int64)
    return torch.from_numpy(words.sum(axis=0))


@pytest.mark.parametrize("terms", [1, 2, 3, 8, 256, 1024])
def test_renorm_mod_equals_the_sum_and_tnsh(terms):
    """D values a lane, each below 2p (0, p and 2p - 1 among them): the
    reduced sum equals Σ mod p, and tnsh's ``_renorm_mod`` limb for limb
    where its layout holds the sum (D <= 256)."""
    rng = random.Random(terms)
    lanes = 6
    vals = [[rng.randrange(2 * P) for _ in range(lanes)]
            for _ in range(terms)]
    for t, edge in enumerate((0, P, 2 * P - 1)):
        vals[t % terms][t] = edge
    vals[-1][lanes - 1] = 2 * P - 1
    got = limbs.raw_ints(M._renorm_mod(_limb_sums(vals), terms))
    want = [sum(col) % P for col in zip(*vals)]
    assert got == want
    if terms > 256:
        return
    import jax.numpy as jnp
    from tnsh.field import limbs as ref_limbs
    from tnsh.field.fr_jax import fr_ops
    from tnsh.parallel.mesh import _renorm_mod as ref_renorm

    planes = np.zeros((ref_limbs.NUM_LIMBS, lanes), dtype=np.int32)
    for lane_vals in vals:
        for j, v in enumerate(lane_vals):
            planes[:, j] += np.asarray(ref_limbs.int_to_limbs(v),
                                       dtype=np.int32)
    ref = np.asarray(ref_renorm(jnp.asarray(planes), fr_ops.p_planes))
    assert [ref_limbs.limbs_to_int(ref[:, j]) for j in range(lanes)] == got


def test_renorm_mod_limit():
    """The port's limit, 2^31 - 1 terms: the largest limb sums it can get
    (every term 2^256 - 1) reduce exactly; one term more, or none, is
    refused."""
    top = M.MAX_PSUM_TERMS
    s = torch.full((8, 2), top * 0xFFFFFFFF, dtype=torch.int64)
    s[:, 1] = 0
    got = limbs.raw_ints(M._renorm_mod(s, top))
    assert got == [top * ((1 << 256) - 1) % P, 0]
    for bad in (0, top + 1):
        with pytest.raises(ValueError, match="limit"):
            M._renorm_mod(s, bad)


# ---------------------------------------------------------------------------
# The spawned worlds against tnsh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ORACLES + CAPPED)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_oracle_equals_tnsh_host_oracle(world, case, worlds):
    """Every rank's proof bytes equal tnsh's host oracle's."""
    got = [r[case] for r in _ranks(worlds, world)]
    assert all(g == got[0] for g in got)
    assert got[0] == _ref_proof(case)


@pytest.mark.parametrize("case", ["product"] + list(CAPPED))
def test_sharded_oracle_equals_tnsh_sharded_class(case, worlds, jax_mesh):
    """World 4's bytes against tnsh's sharded class on a 4-device mesh.
    The sum-of-products classes run with tnsh's dryrun cap of one sharded
    round: each further round is a new shard_map shape for XLA to
    compile."""
    assert _ranks(worlds, 4)[0][case] == _ref_proof(case, jax_mesh)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_round_step_equals_tnsh(world, worlds, jax_mesh):
    """Seed 51, two factors of 64 lanes: the psummed g(0..3) on every rank
    and the ranks' folded blocks equal tnsh's ``sharded_round_step`` and
    its host ``ProductMLEOracle``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from tnsh.field.fr import Fr as RefFr
    from tnsh.iop.sumcheck import ProductMLEOracle
    from tnsh.parallel.mesh import sharded_round_step
    from tnsh.poly import mle_jax
    from tnsh.poly.mle import MultilinearExtension as RefMLE

    vals = _round_inputs()
    ranks = _ranks(worlds, world)
    evals = ranks[0]["round"][0]
    assert all(r["round"][0] == evals for r in ranks)
    folded = [sum((r["round"][1][f] for r in ranks), []) for f in range(2)]
    host = ProductMLEOracle([RefMLE.from_evaluations(
        [RefFr(v) for v in t]) for t in vals])
    assert evals == [int(v) for v in host.round_evaluations(0)]
    host.bind(RefFr(424242))
    assert folded == [[v % P for v in t] for t in host.tables]
    shard = NamedSharding(jax_mesh, PartitionSpec(None, "data"))
    g, f = sharded_round_step(jax_mesh, num_factors=2)(
        tuple(jax.device_put(jnp.asarray(mle_jax.pack_mle(
            [RefFr(v) for v in t])), shard) for t in vals),
        jnp.asarray(mle_jax.pack_fr_scalar(RefFr(424242))))
    assert [int(v) for v in mle_jax.unpack_fr(g)] == evals
    assert [[int(v) for v in mle_jax.unpack_fr(t)] for t in f] == folded


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_msm_equals_tnsh(world, worlds, jax_mesh):
    """Seed 52, 16 points: every rank's sum equals tnsh's host MSM and its
    ``sharded_msm_fn`` on a 4-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from tnsh.commit.kzg import msm as ref_msm
    from tnsh.commit.msm_jax import _jacobian_to_g1, pack_g1_points
    from tnsh.field.fr import Fr as RefFr
    from tnsh.field.g1 import G1 as RefG1
    from tnsh.field.limbs import pack_scalar_bits
    from tnsh.parallel.mesh import sharded_msm_fn

    got = [r["msm"] for r in _ranks(worlds, world)]
    assert all(g == got[0] for g in got)
    points, scalars = _msm_inputs(RefG1, RefFr)
    want = ref_msm(points, scalars)
    assert got[0] == want.to_affine()
    if world != 4:
        return
    xs, ys, valid = pack_g1_points(points)
    bits = pack_scalar_bits([int(s) for s in scalars], num_bits=254)
    shard = NamedSharding(jax_mesh, PartitionSpec(None, "data"))
    shard1 = NamedSharding(jax_mesh, PartitionSpec("data"))
    X, Y, Z = sharded_msm_fn(jax_mesh)(
        jax.device_put(jnp.asarray(xs), shard),
        jax.device_put(jnp.asarray(ys), shard),
        jax.device_put(jnp.asarray(valid), shard1),
        jax.device_put(jnp.asarray(bits), shard))
    assert _jacobian_to_g1(X, Y, Z).to_affine() == got[0]


def test_mesh_2d_psum(worlds):
    """(dcn = 2, ici = 2): the psum over both axes gives lane j of every
    rank Σ_rank vals[4 rank + j], ``tools/multihost_smoke.py``'s check."""
    vals = [(7 * i + 3) % P for i in range(16)]
    want = [sum(vals[4 * d + j] for d in range(4)) % P for j in range(4)]
    assert [r["mesh_2d"] for r in _ranks(worlds, 4)] == [want] * 4


@pytest.mark.parametrize("case", ["product", "sop", "sopd"])
def test_tail_below_two_lanes_a_rank(case, worlds):
    """4 lanes over 4 ranks: the whole proof runs on the gathered tail,
    and its bytes equal tnsh's host oracle's."""
    from tnsh.core.proof_io import (
        sumcheck_d_proof_to_bytes as ref_d_bytes,
        sumcheck_proof_to_bytes as ref_bytes,
    )
    from tnsh.core.transcript import Transcript as RefTranscript
    from tnsh.field.fr import Fr as RefFr
    from tnsh.iop import sumcheck as ref_sc
    from tnsh.iop import sumcheck_d as ref_scd
    from tnsh.poly.mle import MultilinearExtension as RefMLE

    ranks = _ranks(worlds, 4)
    got = [r["tail"][0][case] for r in ranks]
    assert all(g == got[0] for g in got)
    t1, t2, t3, bits = ranks[0]["tail"][1]
    seed = RefTranscript(bytes([9]) * 32)
    if case == "product":
        total = RefFr(sum(a * b for a, b in zip(t1, t2)) % P)
        want = ref_bytes(ref_sc.SumCheck(2, total).prove(
            ref_sc.ProductMLEOracle([RefMLE.from_evaluations(
                [RefFr(v) for v in t]) for t in (t1, t2)]), seed))
    elif case == "sop":
        terms = [(1, [t1, t2, bits]), (P - 1, [t3, bits]), (5, [t2])]
        oracle = ref_sc.SumOfProductsOracle(2, terms)
        ev = oracle.round_evaluations(0)
        want = ref_bytes(ref_sc.SumCheck(2, ev[0] + ev[1]).prove(
            ref_sc.SumOfProductsOracle(2, terms), seed))
    else:
        terms = [(3, [t1, bits, t3, t1]), (P - 5, [bits, t3])]
        claim = ref_scd.DenseSopOracleD(2, terms, degree=4).hypercube_sum()
        want = ref_d_bytes(ref_scd.SumCheckD(2, claim, 4)
                           .prove_with_challenges(ref_scd.DenseSopOracleD(
                               2, terms, degree=4), seed)[0])
    assert got[0] == want


@pytest.mark.parametrize("world", WORLDS)
def test_cube_oracle_refusals(world, worlds):
    """tnsh's errors: a world that is not a power of two, and log T at or
    under log2(world)."""
    errs = [r["errors"] for r in _ranks(worlds, world)]
    assert all(e == errs[0] for e in errs)
    assert "power of two" in errs[0]["world_3"]
    assert "need log_t > log2(devices)" in errs[0]["log_t"]


def test_collectives_are_counted(worlds):
    """Each rank's mesh counts every collective it ran, the same number on
    every rank of a world."""
    for w in WORLDS:
        counts = {r["collectives"] for r in _ranks(worlds, w)}
        assert len(counts) == 1 and counts.pop() > 0


def test_init_distributed_is_a_no_op_once_joined(worlds):
    """A second ``init_distributed`` in a rank returns at once (its
    arguments are not even read) and the group stays the world's."""
    for w in WORLDS:
        assert [r["init_again"] for r in _ranks(worlds, w)] == [w] * w


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """Asking for the card where there is none raises; nothing falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device=None)


def test_dryrun_multichip_on_two_cpu_ranks():
    """The port of ``__graft_entry__.dryrun_multichip``: the prover step
    and three sharded proofs, each rank's bytes equal to the unsharded
    oracles' (the dryrun raises otherwise)."""
    from tnsh_torch.entry import dryrun_multichip

    out = dryrun_multichip(2, "cpu")
    assert out["msm_equal"] and set(out) == {"msm_equal", "sop", "cube",
                                             "sopd"}
