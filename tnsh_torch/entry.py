"""The entry points on torch: the ports of ``__graft_entry__``'s
``entry`` (the flagship round step) and ``dryrun_multichip`` (the mesh).

``entry(device)`` returns ``(step, args)``: one fused sum-check round
(product-of-MLEs evaluations + fold) over three 1024-lane tables made
from ``numpy.random.default_rng(0)``, exactly the JAX entry's inputs.
``step(*args)`` returns ([g(0..3)] before folding, the three folded
tables after binding r).
"""

from __future__ import annotations

import numpy as np

from .field.fr import Fr

from .poly import mle


def entry(device):
    n = 1024
    rng = np.random.default_rng(0)
    tables = [
        mle.pack_mle([int(v) for v in rng.integers(0, 1 << 62, n)], device)
        for _ in range(3)
    ]
    r = Fr(123456789)

    def step(table_a, table_v, table_o, r):
        return mle.product_round_step((table_a, table_v, table_o), r)

    return step, (tables[0], tables[1], tables[2], r)


def dryrun_multichip(n_ranks: int, device, backend=None) -> dict:
    """The port of ``__graft_entry__.dryrun_multichip``: ``n_ranks``
    spawned ranks (``parallel.mesh.run_ranks``) run the sharded prover
    step and three complete sharded proofs on the JAX dryrun's inputs
    (``numpy.random.default_rng(42)``, drawn in the same order), each
    rank's bytes held against the port's unsharded oracles on the rank's
    device.  ``device`` is ``"cpu"`` (gloo), ``"cuda"`` (one card a rank,
    NCCL) or one card for every rank (``"cuda:0"`` with
    ``backend="gloo"``).  Returns rank 0's summary; raises if any rank
    failed or the ranks disagree."""
    from .parallel.mesh import run_ranks

    results = run_ranks(_dryrun_rank, n_ranks, device, backend)
    if any(r != results[0] for r in results[1:]):
        raise AssertionError("the ranks' proofs differ")
    print(f"dryrun_multichip({n_ranks}, {device}): sharded round step + MSM "
          f"and the sum-of-products, sparse-cube and generic-degree proofs, "
          f"bit-identical to the unsharded oracles on every rank: "
          f"{results[0]}")
    return results[0]


def _dryrun_rank(mesh) -> dict:
    import hashlib

    import torch

    from .commit.kzg import host_msm
    from .commit.mkzg_sparse import IncrementalCubeTable, SparseCubeTable
    from .core.proof_io import (
        sumcheck_d_proof_to_bytes,
        sumcheck_proof_to_bytes,
    )
    from .core.transcript import Transcript
    from .field import limbs
    from .field.fr import MODULUS
    from .field.g1 import G1
    from .iop.sparse_oracle import SparseCubeOracle
    from .iop.sumcheck import SumCheck, TorchSumOfProductsOracle
    from .iop.sumcheck_d import SumCheckD, TorchSopOracleD
    from .parallel.mesh import (
        ShardedSopOracleD,
        ShardedSparseCubeOracle,
        ShardedSumOfProductsOracle,
        block,
        build_sharded_prover_step,
    )

    dev, w = mesh.device, mesh.size
    n_lanes, n_points = 8 * w, 4 * w
    rng = np.random.default_rng(42)
    table_vals = [[Fr(int(v)) for v in rng.integers(0, 1 << 61, n_lanes)]
                  for _ in range(3)]
    r = Fr(987654321)
    g = G1.generator()
    points = [g * int(k) for k in rng.integers(1, 1 << 31, n_points)]
    scalars = [Fr(int(s)) for s in rng.integers(1, 1 << 61, n_points)]

    full = torch.stack([mle.pack_mle(t, dev) for t in table_vals])
    lo, hi = block(mesh, n_lanes)
    plo, phi = block(mesh, n_points)
    evals, folded, got = build_sharded_prover_step(mesh)(
        full[:, :, lo:hi].contiguous(), r, points[plo:phi],
        scalars[plo:phi])
    if got != host_msm(points, scalars):
        raise AssertionError("sharded MSM differs from the host MSM")
    if limbs.unpack(evals) != limbs.unpack(mle.product_round_evals(full)):
        raise AssertionError("sharded round evaluations differ")
    want_fold = mle.fold(full, r)[:, :, lo // 2:hi // 2]
    if any(limbs.unpack(a) != limbs.unpack(b)
           for a, b in zip(folded, want_fold)):
        raise AssertionError("sharded fold differs")

    def proofs(make_sharded, make_plain, prove, to_bytes):
        a, b = (to_bytes(prove(make())) for make in (make_sharded,
                                                     make_plain))
        if a != b:
            raise AssertionError("a sharded proof differs from the "
                                 "unsharded oracle's")
        return hashlib.sha256(a).hexdigest()

    seed = bytes([7]) * 32
    out = {"msm_equal": True}
    # the sound-constraint sum-check: round 0 sharded, the tail gathered
    sop_lanes = 1 << 9
    t1 = [int(v) for v in rng.integers(0, 1 << 61, sop_lanes)]
    t2 = [int(v) % 2 for v in rng.integers(0, 1 << 31, sop_lanes)]
    terms = [(1, [t1, t2, t2]), (MODULUS - 1, [t1, t2])]
    nv = sop_lanes.bit_length() - 1
    want = Fr(sum((a * b * b - a * b) % MODULUS for a, b in zip(t1, t2)))
    out["sop"] = proofs(
        lambda: ShardedSumOfProductsOracle(nv, terms, mesh,
                                           max_sharded_rounds=1),
        lambda: TorchSumOfProductsOracle(nv, terms, device=dev),
        lambda o: SumCheck(nv, want).prove(o, Transcript(seed)),
        sumcheck_proof_to_bytes)

    # the sparse cube: one-hot colsparse, colinc Val, class I and E terms
    log_k, log_t = 3, 5
    sp_tab = SparseCubeTable(log_k, log_t)
    inc_tab = IncrementalCubeTable(log_k, log_t)
    for j in range(1 << log_t):
        sp_tab.set(j, int(rng.integers(0, 1 << log_k)), 1)
        if j % 2:
            inc_tab.add_update(j, int(rng.integers(0, 1 << log_k)),
                               int(rng.integers(1, 1 << 61)))
    eqj_t = [int(v) for v in rng.integers(0, 1 << 61, 1 << log_t)]
    eqk_t = [int(v) for v in rng.integers(0, 1 << 61, 1 << log_k)]
    cube_terms = [
        (1, [("eqj", eqj_t), ("colsparse", sp_tab), ("colinc", inc_tab)]),
        (MODULUS - 1, [("eqk", eqk_t), ("colsparse", sp_tab),
                       ("colsparse", sp_tab)]),
        (3, [("eqk", eqk_t), ("colinc", inc_tab)]),
        (5, [("eqj", eqj_t), ("eqk", eqk_t)]),
    ]
    probe = SparseCubeOracle(log_k, log_t, cube_terms, device=dev)
    ev0 = probe.round_evaluations(0)
    probe.release()
    cv = log_k + log_t
    out["cube"] = proofs(
        lambda: ShardedSparseCubeOracle(log_k, log_t, cube_terms, mesh,
                                        max_sharded_rounds=1),
        lambda: SparseCubeOracle(log_k, log_t, cube_terms, device=dev),
        lambda o: SumCheck(cv, ev0[0] + ev0[1]).prove(o, Transcript(seed)),
        sumcheck_proof_to_bytes)

    # the generic-degree bits j phase (degree 4, boolean columns)
    d_lanes = 1 << 6
    db1 = [int(v) % 2 for v in rng.integers(0, 2, d_lanes)]
    db2 = [int(v) % 2 for v in rng.integers(0, 2, d_lanes)]
    dv = [int(v) for v in rng.integers(0, 1 << 61, d_lanes)]
    de = [int(v) for v in rng.integers(0, 1 << 61, d_lanes)]
    bits_terms = [(1, [de, db1, db2, dv]), (MODULUS - 7, [de, dv]),
                  (5, [de, db1, db1]), (MODULUS - 5, [de, db1])]
    dd, dnv = 4, d_lanes.bit_length() - 1
    dev0 = TorchSopOracleD(dnv, bits_terms, dd,
                           device=dev).round_evaluations(0)
    out["sopd"] = proofs(
        lambda: ShardedSopOracleD(dnv, bits_terms, dd, mesh,
                                  max_sharded_rounds=1),
        lambda: TorchSopOracleD(dnv, bits_terms, dd, device=dev),
        lambda o: SumCheckD(dnv, dev0[0] + dev0[1], dd).prove_with_challenges(
            o, Transcript(seed))[0],
        sumcheck_d_proof_to_bytes)
    return out
