"""The port's commitment MSM against the JAX package: Fq field ops, the G1
group law, the MSM plan at a stated width, the scheduled insertion (tnsh's
Pallas kernel in interpret mode), the tail (fold, canonical gather, window
sums) and whole MSMs.

Every comparison is exact (tolerance 0: integer arithmetic): canonical
field values, group elements as affine coordinates, plan tensors element
for element.  Inputs come from seeded generators and go to both packages;
device state crosses through ``tnsh_torch.field.limbs.*_jax_planes``.  The
JAX functions run as tnsh's own tests run them on the CPU.  Mirrors
``tests/test_jax_backend.py`` (field, group law) and
``tests/test_msm_sched.py`` (plan, insertion, MSM).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnsh.commit import msm_jax
from tnsh.commit import msm_sched as ref_sched
from tnsh.commit.kzg import msm as ref_host_msm
from tnsh.field.fr import Fr as RefFr
from tnsh.field.fr_jax import fq_ops as ref_fq
from tnsh.field.g1 import G1 as RefG1
from tnsh.field.limbs import FQ_SPEC as REF_FQ_SPEC
from tnsh.field.limbs import pack_ints, unpack_ints
from tnsh_torch import _native
from tnsh_torch.commit import kzg, msm_group, msm_sched
from tnsh_torch.commit.mkzg import MultilinearKZG, setup_multilinear_params
from tnsh_torch.field import fq_kernels, fr_ops, limbs
from tnsh_torch.field.fr import MODULUS, Fr
from tnsh_torch.field.g1 import G1
from tnsh_torch.field.limbs import FQ_SPEC

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

Q = FQ_SPEC.modulus
fq = fr_ops.fq


def _fq_values(seed, n):
    rng = random.Random(seed)
    return [rng.randrange(Q) for _ in range(n)] + [0, 1, Q - 1, Q - 2]


def _port(vals):
    return limbs.pack(vals, "cpu", FQ_SPEC)


def _jax(vals):
    return jnp.asarray(pack_ints(vals, REF_FQ_SPEC))


def _from_jax(planes):
    return unpack_ints(np.asarray(planes), REF_FQ_SPEC)


def _affine(p):
    return None if p.is_zero() else tuple(int(c) for c in p.to_affine())


# ---------------------------------------------------------------------------
# Fq field ops
# ---------------------------------------------------------------------------

def test_fq_spec_matches_tnsh():
    assert FQ_SPEC.modulus == REF_FQ_SPEC.modulus
    assert 4 * Q < limbs.R
    assert FQ_SPEC.r_mod_p == (1 << 256) % Q


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_fq_binary_ops_equal_tnsh(op):
    xs, ys = _fq_values(14, 24), _fq_values(15, 24)
    got = limbs.unpack(getattr(fq, op)(_port(xs), _port(ys)), FQ_SPEC)
    want = _from_jax(getattr(ref_fq, op)(_jax(xs), _jax(ys)))
    host = {"mont_mul": lambda a, b: a * b % Q, "add": lambda a, b: (a + b) % Q,
            "sub": lambda a, b: (a - b) % Q}[op]
    assert got == want == [host(a, b) for a, b in zip(xs, ys)]


def test_fq_unary_ops_constants_and_select_equal_tnsh():
    xs = _fq_values(16, 12)
    x = _port(xs)
    assert limbs.unpack(fq.neg(x), FQ_SPEC) == _from_jax(
        ref_fq.neg(_jax(xs))) == [(-v) % Q for v in xs]
    # canon reduces the lazy [0, 2p) representative to [0, p)
    lazy = fq.add(x, torch.zeros_like(x))
    assert limbs.raw_ints(fq.canon(lazy)) == [
        v * FQ_SPEC.r_mod_p % Q for v in xs]
    # both zeros: 0 and p
    p_planes = limbs.raw_planes(Q, "cpu")
    zeros = torch.cat([torch.zeros((8, 1), dtype=torch.int32), p_planes,
                       _port([5])], dim=1)
    assert fq.is_zero(zeros).tolist() == [True, True, False]
    assert fq.is_zero(fq.sub(x, x)).all()
    one = fq.one((3,), "cpu")
    assert limbs.unpack(one, FQ_SPEC) == [1, 1, 1]
    assert limbs.unpack(fq.scalar_const(12345, (2,), "cpu"), FQ_SPEC) == \
        _from_jax(ref_fq.scalar_const(12345, (2,)))
    ys = _fq_values(17, 12)
    cond = torch.tensor([i % 3 == 0 for i in range(len(xs))])
    got = limbs.unpack(fq.select(cond, x, _port(ys)), FQ_SPEC)
    assert got == [a if c else b for a, b, c in zip(xs, ys, cond.tolist())]
    # round trips, and the chain wrapper's plain version on the CPU
    assert limbs.unpack(fq.to_mont(fq.from_mont(x)), FQ_SPEC) == xs
    assert torch.equal(fq_kernels.to_mont(fq.from_mont(x)),
                       fq.to_mont(fq.from_mont(x)))
    assert limbs.unpack(fq_kernels.mont_mul_chain(x, _port(ys), 3),
                        FQ_SPEC) == [a * pow(b, 3, Q) % Q
                                     for a, b in zip(xs, ys)]
    assert fq_kernels.mont_mul_chain.launches == 0


def test_state_crosses_between_the_layouts_for_fq_and_points():
    xs = _fq_values(18, 9)
    assert limbs.unpack(torch.from_numpy(
        limbs.from_jax_planes(pack_ints(xs, REF_FQ_SPEC), FQ_SPEC)),
        FQ_SPEC) == xs
    assert np.array_equal(limbs.to_jax_planes(_port(xs), FQ_SPEC),
                          pack_ints(xs, REF_FQ_SPEC))
    coords = (pack_ints(xs, REF_FQ_SPEC), pack_ints(xs[::-1], REF_FQ_SPEC),
              pack_ints([1] * len(xs), REF_FQ_SPEC))
    back = limbs.points_to_jax_planes(limbs.points_from_jax_planes(coords))
    assert all(np.array_equal(a, b) for a, b in zip(back, coords))


# ---------------------------------------------------------------------------
# The group law
# ---------------------------------------------------------------------------

def _point_ints(seed, n):
    """n affine points (ints) as multiples of the generator; lane 2 is the
    identity."""
    rng = random.Random(seed)
    g = G1.generator()
    pts = [g * rng.randrange(1, 10 ** 9) for _ in range(n)]
    pts[2] = G1.zero()
    return pts


def _both(pts):
    """Jacobian planes of host points in both layouts (identity: Z = 0)."""
    xs = [0 if p.is_zero() else p.to_affine()[0] for p in pts]
    ys = [1 if p.is_zero() else p.to_affine()[1] for p in pts]
    zs = [0 if p.is_zero() else 1 for p in pts]
    return (tuple(_port(v) for v in (xs, ys, zs)),
            tuple(_jax(v) for v in (xs, ys, zs)))


def _points_of(planes, unpack):
    xs, ys, zs = (unpack(c) for c in planes)
    return [_affine(G1.zero() if z == 0 else G1(x, y, z))
            for x, y, z in zip(xs, ys, zs)]


def _port_points(planes):
    return _points_of(planes, lambda c: limbs.unpack(c, FQ_SPEC))


def _jax_points(planes):
    return _points_of(planes, _from_jax)


def test_padd_equals_tnsh_with_equal_inverse_and_infinite_points():
    pts = _point_ints(41, 8)
    other = pts[1:] + pts[:1]
    other[4] = pts[4]            # equal points: the doubling branch
    other[5] = pts[5].neg()      # inverse points: infinity
    other[6] = G1.zero()         # second operand at infinity
    (p, jp), (o, jo) = _both(pts), _both(other)
    got = _port_points(msm_group.padd(*p, *o))
    assert got == _jax_points(msm_jax._padd(*jp, *jo))
    assert got == [_affine(a + b) for a, b in zip(pts, other)]
    # masked lanes keep the first operand
    mask = torch.tensor([i % 2 == 0 for i in range(8)])
    kept = _port_points(msm_group.padd(*p, *o, mask))
    assert kept == [g if m else _affine(a)
                    for g, m, a in zip(got, mask.tolist(), pts)]
    assert msm_group.padd.launches == 0


def test_pdouble_and_padd_mixed_equal_tnsh():
    pts = _point_ints(42, 8)
    other = pts[3:] + pts[:3]
    other[2] = pts[0]            # an affine operand for the identity lane
    other[7] = pts[1].double()   # (the rotation put the identity here)
    (p, jp), (o, jo) = _both(pts), _both(other)
    assert _port_points(msm_group._pdouble(*p)) == _jax_points(
        msm_jax._pdouble(*jp)) == [_affine(a.double()) for a in pts]
    take = [i != 6 for i in range(8)]
    got = _port_points(msm_group._padd_mixed(
        *p, o[0], o[1], torch.tensor(take)))
    assert got == _jax_points(msm_jax._padd_mixed(
        *jp, jo[0], jo[1], jnp.asarray(take)))
    assert got == [_affine(a + b) if t else _affine(a)
                   for a, b, t in zip(pts, other, take)]
    # the safe variant also doubles where the operands are equal
    same = list(other)
    same[1] = pts[1]
    (s, js) = _both(same)
    got = _port_points(msm_group._padd_mixed_safe(
        *p, s[0], s[1], torch.tensor(take)))
    assert got == _jax_points(msm_jax._padd_mixed_safe(
        *jp, js[0], js[1], jnp.asarray(take)))
    assert got[1] == _affine(pts[1].double())


def test_tree_reduce_points_equals_tnsh():
    pts = _point_ints(43, 8)
    pts[5] = pts[1]              # a duplicate meets itself in the tree
    p, jp = _both(pts)
    total = G1.zero()
    for a in pts:
        total = total + a
    got = msm_group.jacobian_to_g1(*msm_group.tree_reduce_points(*p))
    assert _affine(got) == _affine(total)
    assert _affine(got) == _jax_points(
        [c[:, :1] for c in msm_jax.tree_reduce_points(*jp)])[0]


def test_msm_over_explicit_points_is_served_by_the_scheduled_pippenger(
        monkeypatch):
    pts = _point_ints(44, 8)
    scs = [Fr(5), Fr(5), Fr(3), Fr(0), Fr(MODULUS - 1), Fr(7), Fr(1), Fr(2)]
    want = kzg.host_msm(pts, scs)
    assert want == kzg.host_msm(pts, scs, native=False)
    kzg.reset_route_counts()
    assert kzg.msm(pts, scs, "cpu") == want          # below the gate
    monkeypatch.setattr(kzg, "DEVICE_MSM_MIN", 8)
    assert kzg.msm(pts, scs, "cpu") == want
    raw = b"".join(int(v).to_bytes(32, "little") for v in scs)
    assert kzg.msm(pts, raw + bytes(64), "cpu") == want
    assert kzg.route_counts() == {"device": 2, "host": 1}
    assert kzg.msm([], [], "cpu").is_zero()
    xs, ys, valid = msm_group.pack_g1_points(pts, "cpu")
    assert valid.tolist() == [not p.is_zero() for p in pts]
    assert limbs.unpack(xs, FQ_SPEC)[0] == pts[0].to_affine()[0]


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

def _digit_cases():
    rng = np.random.default_rng(0)
    heavy = np.zeros((4, 256), dtype=np.int8)
    heavy[0, :128] = 3
    heavy[0, 128:] = 5
    equal = np.zeros((4, 256), dtype=np.int8)
    equal[0, :] = 5
    bits = np.zeros((4, 1024), dtype=np.int8)
    bits[0] = rng.integers(0, 2, 1024)
    return {
        "uniform": (rng.integers(-128, 128, (32, 4096), dtype=np.int8), 4096),
        "all_equal": (equal, 256),
        "bit_scalars": (bits, 512),
        "heavy_buckets": (heavy, 256),
    }


_CASES = ["uniform", "all_equal", "bit_scalars", "heavy_buckets"]


def _groups(plan):
    """(window, magnitude, base lane, K) of every group of a plan."""
    return [(w, mag, int(plan.base_map[w, mag]), 1 << int(plan.logk_map[w, mag]))
            for w in range(plan.w_count) for mag in range(1, 129)
            if plan.canon_mask[w * 128 + mag - 1]]


@pytest.mark.parametrize("name", _CASES)
def test_plan_tensors_equal_tnsh(name):
    """At 4096 lanes the port's plan gives every group tnsh's K and every
    chunk tnsh's step count; only the packing differs: by descending size,
    so that each group starts at a multiple of its K."""
    d, m = _digit_cases()[name]
    lanes = msm_sched.CPU_LANES
    got = msm_sched.MsmPlan(d.copy(), m, lanes)
    want = ref_sched.MsmPlan(d.copy(), m)
    assert got.r_exact == want.r_exact and got.w_count == want.w_count
    assert got.lanes == lanes == ref_sched.TOTAL_LANES == 4096
    for field in ("logk_map", "canon_mask", "rc_per_chunk"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field
    assert got.fold_levels == int(want.logk_map.max())
    groups = _groups(got)
    assert len(groups) == int(want.canon_mask.sum())
    owner = np.zeros(lanes, dtype=np.int64)
    for w, mag, base, k in groups:
        assert base % k == 0 and base + k <= lanes          # aligned, inside
        assert got.canon_src[w * 128 + mag - 1] == base
        owner[base:base + k] += 1
        assert (got.lane_logk[base:base + k] == got.logk_map[w, mag]).all()
    assert owner.max() == 1                                  # disjoint
    assert (got.lane_logk[owner == 0] == 0).all()
    sizes = [k for _, _, _, k in sorted(groups, key=lambda g: g[2])]
    assert sizes == sorted(sizes, reverse=True)              # by size
    assert got.canon_src.dtype == np.int32 and got.lane_logk.dtype == np.uint8


@pytest.mark.parametrize("seed", range(6))
def test_plan_of_skewed_digits_equals_tnsh(seed):
    """Skewed digits (geometric magnitudes, a few heavy windows, many
    points a chunk): the bisection's bounded top gives tnsh's plan, whose
    bisection runs from 1 to the largest count."""
    rng = np.random.default_rng(seed)
    w_count, m = (4, 8, 4, 8, 12, 4)[seed], (512, 1024, 2048, 4096, 512,
                                             4096)[seed]
    n = m * (1 + seed % 3)
    mags = np.minimum(rng.geometric(0.05 * (seed + 1), (w_count, n)), 128)
    d = (mags * rng.choice([-1, 1], (w_count, n))).astype(np.int16)
    d[rng.random((w_count, n)) < 0.2] = 0
    d[seed % w_count, : n // 2] = 1 + seed            # one heavy group
    d = np.clip(d, -128, 127).astype(np.int8)
    got = msm_sched.MsmPlan(d.copy(), m, msm_sched.CPU_LANES)
    want = ref_sched.MsmPlan(d.copy(), m)
    assert got.r_exact == want.r_exact and got.w_count == want.w_count
    for field in ("logk_map", "canon_mask", "rc_per_chunk"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field


def test_plan_takes_its_width_as_an_argument():
    d, m = _digit_cases()["bit_scalars"]
    steps = []
    for lanes in (1, 64, 4096, 1 << 15):
        plan = msm_sched.MsmPlan(d.copy(), m, lanes)
        assert plan.lane_logk.shape == (lanes,)
        assert plan.fold_levels == min(lanes.bit_length() - 1, 9)
        steps.append(plan.r_exact)
    worst = int(d[0].reshape(-1, m).sum(axis=1).max())   # ones in a chunk
    assert steps == [worst, -(-worst // 64), 1, 1]
    with pytest.raises(ValueError):
        msm_sched.MsmPlan(d.copy(), m, 3000)                 # not a power of 2
    u, mu = _digit_cases()["uniform"]
    with pytest.raises(RuntimeError):
        msm_sched.MsmPlan(u.copy(), mu, 2048)                # 4096 groups


def _old_fold_masks(base_map, logk_map, supported, lanes, levels=12):
    """The masks the fold was driven by before the per-lane ``logk`` byte
    (the JAX package's): level t folds lane + 2^t into base + j 2^(t+1)."""
    masks = np.zeros((levels, lanes), dtype=bool)
    for w in range(base_map.shape[0]):
        for dmag in np.nonzero(supported[w])[0]:
            base, k = int(base_map[w, dmag]), 1 << int(logk_map[w, dmag])
            for t in range(k.bit_length() - 1):
                masks[t, base + np.arange(0, k, 2 << t)] = True
    return masks


def _mask_fold(X, Y, Z, masks):
    for t in range(masks.shape[0]):
        if masks[t].any():
            X, Y, Z = msm_group.padd(
                X, Y, Z, *msm_sched._rolled(X, Y, Z, 1 << t),
                torch.from_numpy(masks[t]))
    return X, Y, Z


@pytest.mark.parametrize("name", _CASES)
def test_lane_logk_fold_equals_the_mask_driven_fold(name):
    """The fold driven by one ``logk`` byte a lane adds in exactly the
    lanes of the old ``(12, lanes)`` masks, so both folds agree limb for
    limb; where tnsh's own packing is aligned, its ``fold_masks`` are
    those masks too."""
    d, m = _digit_cases()[name]
    lanes = 4096
    plan = msm_sched.MsmPlan(d.copy(), m, lanes)
    supported = np.zeros((plan.w_count, 129), dtype=bool)
    supported[:, 1:] = plan.canon_mask.reshape(-1, 128)
    masks = _old_fold_masks(plan.base_map, plan.logk_map, supported, lanes)
    lane = np.arange(lanes)
    for t in range(12):
        mine = (plan.lane_logk > t) & ((lane & ((2 << t) - 1)) == 0)
        assert np.array_equal(mine, masks[t]), t
    ref = ref_sched.MsmPlan(d.copy(), m)
    aligned = all(int(ref.base_map[w, g]) % (1 << int(ref.logk_map[w, g])) == 0
                  for w, g in zip(*np.nonzero(supported)))
    assert aligned or name not in ("uniform", "all_equal")
    if aligned:
        ref_logk = np.zeros(lanes, dtype=np.uint8)
        for w, g in zip(*np.nonzero(supported)):
            base, lk = int(ref.base_map[w, g]), int(ref.logk_map[w, g])
            ref_logk[base:base + (1 << lk)] = lk
        for t in range(12):
            assert np.array_equal(
                (ref_logk > t) & ((lane & ((2 << t) - 1)) == 0),
                np.asarray(ref.fold_masks)[t]), t
    # both folds on the same accumulators: 40 points spread over the lanes
    rng = np.random.default_rng(9)
    pts = _point_ints(46, 40)
    xs = [0 if p.is_zero() else p.to_affine()[0] for p in pts]
    ys = [1 if p.is_zero() else p.to_affine()[1] for p in pts]
    pick = rng.integers(0, 40, lanes)
    pick[rng.random(lanes) < 0.3] = 2                  # the identity
    X = _port(xs)[:, pick].contiguous()
    Y = _port(ys)[:, pick].contiguous()
    Z = _port([int(not p.is_zero()) for p in pts])[:, pick].contiguous()
    got = msm_sched.fold_groups(X, Y, Z, torch.from_numpy(plan.lane_logk),
                                plan.fold_levels)
    want = _mask_fold(X, Y, Z, masks)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_signed_digits_and_limb_planes_equal_tnsh():
    rng = random.Random(3)
    vals = [0, 1, 127, 128, 255, 256, MODULUS - 1] + [
        rng.randrange(MODULUS) for _ in range(20)]
    sb = msm_sched.scalars_to_byte_matrix([Fr(v) for v in vals], len(vals))
    assert np.array_equal(sb, ref_sched.scalars_to_byte_matrix(
        [RefFr(v) for v in vals], len(vals)))
    d = msm_sched.signed_digits(sb)
    assert np.array_equal(d, ref_sched.signed_digits(sb))
    for j, v in enumerate(vals):
        assert sum(int(d[w, j]) * 256 ** w for w in range(d.shape[0])) == v
    assert msm_sched.signed_digits(
        msm_sched.scalars_to_byte_matrix([Fr(300), Fr(7)], 2)).shape[0] == 4
    # eight 32-bit limbs are a view of the bytes; same values as tnsh's 22
    planes = msm_sched.bytes_to_limb_planes(sb)
    assert limbs.raw_ints(torch.from_numpy(planes)) == vals
    assert [sum(int(x) << (12 * i) for i, x in enumerate(col))
            for col in ref_sched.bytes_to_limb_planes(sb).T] == vals
    assert [msm_sched._choose_chunk(n) for n in (1, 513, 40000)] == [
        ref_sched._choose_chunk(n) for n in (1, 513, 40000)]


def test_schedule_places_every_nonzero_digit_once():
    d, m = _digit_cases()["uniform"]
    d = d[:, :1024].copy()
    d[:, 7] = 0
    plan = msm_sched.MsmPlan(d, 1024, 4096)
    steps = int(plan.rc_per_chunk[0])
    sched = msm_sched.build_schedule(
        torch.from_numpy(d), torch.from_numpy(plan.base_map),
        torch.from_numpy(plan.logk_map), steps, 4096).numpy()
    assert sched.shape == (steps, 4096)
    entries = sched[sched != 0]
    assert len(entries) == np.count_nonzero(d)      # zero digits dropped
    assert 8 not in np.abs(entries)                 # point 7 never scheduled
    for w in range(d.shape[0]):
        for mag in (1, 77, 128):
            members = np.nonzero(np.abs(d[w].astype(np.int16)) == mag)[0]
            if not len(members):
                continue                 # an empty group owns no lane
            base, k = plan.base_map[w, mag], 1 << plan.logk_map[w, mag]
            cell = sched[:, base:base + k]
            ids = np.sort(np.abs(cell[cell != 0]) - 1)
            assert np.array_equal(ids, members)
            assert ((cell < 0) == (d[w][np.abs(cell) - 1] < 0))[
                cell != 0].all()


# ---------------------------------------------------------------------------
# The insertion against tnsh's Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def test_insertion_equals_tnsh_pallas_kernel_in_interpret_mode(monkeypatch):
    """The same schedule, points and accumulators through
    ``tnsh.commit.msm_sched._make_insert_seg`` (Mosaic interpret mode, the
    kernel the TPU compiles) and through the port's plain version: equal
    accumulators and hazard count, with negative digits, idle lanes,
    infinity accumulators and a forced hazard.  In the hazard's lane the
    Pallas kernel's sum is wrong by design (tnsh then recomputes the MSM on
    the host); the port doubles there, which is held against host
    arithmetic."""
    monkeypatch.setenv("TNSH_PALLAS_INTERPRET", "1")
    seg, lanes, m = 3, ref_sched.TOTAL_LANES, 16
    rng = np.random.default_rng(5)
    pts = _point_ints(45, m)
    pts[2] = pts[3].double()                      # no identity among bases
    xs = [p.to_affine()[0] for p in pts]
    ys = [p.to_affine()[1] for p in pts]
    sched = np.zeros((seg, lanes), dtype=np.int32)
    for s in range(seg):
        sched[s] = np.where(rng.random(lanes) < 0.5, 0,
                            rng.integers(1, m + 1, lanes)
                            * rng.choice([-1, 1], lanes))
    sched[0, 0], sched[1, 0] = 9, 9               # accumulator == input
    sched[0, 1], sched[1, 1] = 9, -9              # P + (-P)

    # the port: the chunk's planes, gathered inside
    zero = torch.zeros((8, lanes), dtype=torch.int32)
    hz0 = torch.zeros((1,), dtype=torch.int32)
    X, Y, Z, hz = msm_sched.insert_steps(
        torch.from_numpy(sched), _port(xs), _port(ys), zero,
        fq.one((lanes,), "cpu"), zero.clone(), hz0)
    assert msm_sched.insert_steps.launches == 0
    assert int(hz0) == 0                          # nothing updated in place

    # tnsh: XLA gathers the stream, the Pallas kernel consumes it
    insert_seg, p_b, p2_b, one_b = ref_sched._make_insert_seg(seg)
    idx = np.clip(np.abs(sched) - 1, 0, m - 1)
    gx = jnp.asarray(pack_ints(xs, REF_FQ_SPEC))[:, idx].transpose(1, 0, 2)
    gy = jnp.asarray(pack_ints(ys, REF_FQ_SPEC))[:, idx].transpose(1, 0, 2)
    acc0 = (jnp.zeros((22, lanes), jnp.int32),
            jnp.zeros((22, lanes), jnp.int32) + np.asarray(
                REF_FQ_SPEC.one_mont_limbs(), dtype=np.int32)[:, None],
            jnp.zeros((22, lanes), jnp.int32),
            jnp.zeros((1, 1), jnp.int32))
    rX, rY, rZ, rhz = insert_seg(jnp.asarray(sched)[:, None, :], gx, gy,
                                 p_b, p2_b, one_b, *acc0)
    # host arithmetic, lane by lane, with the lanes that meet a hazard
    sums, hazard_lanes = [], set()
    for lane in range(lanes):
        acc = G1.zero()
        for e in sched[:, lane]:
            if e:
                q = pts[abs(int(e)) - 1]
                q = q if e > 0 else q.neg()
                if acc == q:
                    hazard_lanes.add(lane)
                acc = acc + q
        sums.append(_affine(acc))
    assert 0 in hazard_lanes
    assert int(hz) == int(rhz[0, 0]) == len(hazard_lanes)
    got = _port_points((X, Y, Z))
    assert got == sums
    ref = _port_points([torch.from_numpy(c) for c in
                        limbs.points_from_jax_planes((rX, rY, rZ))])
    assert all(g == r for lane, (g, r) in enumerate(zip(got, ref))
               if lane not in hazard_lanes)
    # the infinity lane and an untouched lane
    assert limbs.unpack(Z[:, 1:2], FQ_SPEC) == [0]
    idle = int(np.nonzero((sched == 0).all(axis=0))[0][0])
    assert limbs.unpack(Z[:, idle:idle + 1], FQ_SPEC) == [0]


def test_insert_wrapper_refuses_wrong_arguments():
    lanes = 8
    z = torch.zeros((8, lanes), dtype=torch.int32)
    hz = torch.zeros((1,), dtype=torch.int32)
    px = torch.zeros((8, 4), dtype=torch.int32)
    sched = torch.zeros((2, lanes), dtype=torch.int32)
    msm_sched.insert_steps(sched, px, px, z, z, z, hz)          # accepted
    with pytest.raises(ValueError):
        msm_sched.insert_steps(sched.to(torch.int64), px, px, z, z, z, hz)
    with pytest.raises(ValueError):
        msm_sched.insert_steps(sched, px, px, z, z, z, hz, steps=3)
    with pytest.raises(ValueError):
        msm_sched.insert_steps(sched, px[:, ::2], px[:, ::2], z, z, z, hz)
    with pytest.raises(ValueError):
        msm_sched.insert_steps(sched, px, px, z[:, :4], z, z, hz)
    with pytest.raises(ValueError):
        msm_group.padd(z, z, z, z, z, z, torch.zeros(lanes))     # not bool
    with pytest.raises(ValueError):
        msm_group.padd(z, z, z, z, z, z[:, :4])


# ---------------------------------------------------------------------------
# Whole MSMs
# ---------------------------------------------------------------------------

def _scalar_ints(name, n):
    rng = random.Random(len(name) * 7919)
    return {
        "full": lambda: [rng.randrange(MODULUS) for _ in range(n)],
        "small": lambda: [rng.randrange(1 << 26) for _ in range(n)],
        "skewed": lambda: [424242] * n,
        "sparse": lambda: [0 if i % 3 else i for i in range(n)],
    }[name]()


@pytest.fixture(scope="module")
def point_ints():
    rng = random.Random(101)
    g = G1.generator()
    pts = [g * rng.randrange(1, MODULUS) for _ in range(48)]
    pts[5] = G1.zero()  # identity points must contribute nothing
    return pts


def _ref_points(pts):
    return [RefG1.zero() if p.is_zero() else RefG1(*p.to_affine(), 1)
            for p in pts]


@pytest.mark.parametrize("name", ["full", "small", "skewed", "sparse"])
def test_msm_matches_host_and_tnsh(point_ints, name):
    vals = _scalar_ints(name, len(point_ints))
    got = msm_sched.ScheduledMsmContext(point_ints, device="cpu").msm(
        [Fr(v) for v in vals])
    assert got == kzg.host_msm(point_ints, [Fr(v) for v in vals])
    ref_pts, ref_scs = _ref_points(point_ints), [RefFr(v) for v in vals]
    assert _affine(got) == _affine(ref_host_msm(ref_pts, ref_scs))
    if name == "full":
        # tnsh's own scheduled Pippenger (its XLA engine on the CPU)
        assert _affine(got) == _affine(
            ref_sched.msm_scheduled(ref_pts, ref_scs))


def test_msm_all_zero_scalars_prefix_and_bytes(point_ints):
    n = len(point_ints)
    ctx = msm_sched.ScheduledMsmContext(point_ints, device="cpu")
    assert ctx.msm([Fr(0)] * n) == G1.zero()
    assert ctx.msm([]).is_zero()
    rng = random.Random(17)
    for k in (n, 13, 1):
        scalars = [Fr(rng.randrange(MODULUS)) for _ in range(k)]
        assert ctx.msm(scalars) == kzg.host_msm(point_ints[:k], scalars)
    vals = [rng.randrange(MODULUS) for _ in range(n)]
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    assert ctx.msm(raw) == kzg.host_msm(point_ints, [Fr(v) for v in vals])
    assert ctx.msm_async(raw)() == ctx.msm(raw)
    with pytest.raises(ValueError):
        ctx.msm([Fr(1)] * (n + 1))
    assert ctx.hazard_count == 0


def _stage_scalars(name, n):
    """Scalars below 2^14 (W = 4, at most 193 groups, so 256 lanes are a
    feasible budget) in the four digit distributions of the plan tests."""
    rng = random.Random(len(name) * 104729)
    return {
        "uniform": lambda: [rng.randrange(1 << 14) for _ in range(n)],
        "all_equal": lambda: [5] * n,
        "bit_scalars": lambda: [rng.randrange(2) for _ in range(n)],
        "heavy_buckets": lambda: [3 if i < n // 2 else 5 for i in range(n)],
    }[name]()


@pytest.fixture(scope="module")
def stage_points():
    rng = random.Random(202)
    g = G1.generator()
    pts = [g * rng.randrange(1, MODULUS) for _ in range(96)]
    pts[11] = G1.zero()
    pts[40] = pts[41]            # equal bases: they may meet in a fold
    return pts


@pytest.fixture(scope="module")
def tnsh_stage_elements(stage_points):
    """The same MSMs through tnsh's own scheduled Pippenger (its XLA
    engine on the CPU, as its tests run it), once a digit case."""
    ref_pts = _ref_points(stage_points)
    return {name: _affine(ref_sched.msm_scheduled(
        ref_pts, [RefFr(v) for v in _stage_scalars(name, len(ref_pts))]))
        for name in _CASES}


@pytest.mark.parametrize("name", _CASES)
@pytest.mark.parametrize("lanes", [256, 1024, 4096])
def test_schedule_insertion_and_tail_give_the_host_element(
        stage_points, tnsh_stage_elements, lanes, name):
    """Plan at a stated width, schedule, ``insert_steps`` and ``msm_tail``
    (their plain versions on the CPU), stage by stage as the context runs
    them: the host MSM's element and tnsh's, whatever the width."""
    n = len(stage_points)
    vals = _stage_scalars(name, n)
    ctx = msm_sched.ScheduledMsmContext(stage_points, device="cpu",
                                        lanes=lanes)
    m = ctx.m
    d = msm_sched.signed_digits(msm_sched.scalars_to_byte_matrix(
        [Fr(v) for v in vals], n))
    d[:, 11] = 0                                   # the identity base
    d = np.pad(d, ((0, 0), (0, m - n)))
    plan = msm_sched.MsmPlan(d, m, lanes)
    assert plan.lanes == lanes and plan.rc_per_chunk.shape == (1,)
    steps = int(plan.rc_per_chunk[0])
    sched = msm_sched.build_schedule(
        torch.from_numpy(d), torch.from_numpy(plan.base_map),
        torch.from_numpy(plan.logk_map), steps, lanes)
    assert sched.shape == (steps, lanes)
    assert int((sched != 0).sum()) == np.count_nonzero(d)
    zero = torch.zeros((8, lanes), dtype=torch.int32)
    X, Y, Z, hz = msm_sched.insert_steps(
        sched, ctx.xs, ctx.ys, zero, fq.one((lanes,), "cpu"), zero.clone(),
        torch.zeros((1,), dtype=torch.int32))
    packed = msm_sched.msm_tail(
        X, Y, Z, torch.from_numpy(plan.lane_logk),
        torch.from_numpy(plan.canon_src), torch.from_numpy(plan.canon_mask),
        hz, plan.fold_levels)
    assert msm_sched.msm_tail.launches == 0
    w = plan.w_count
    assert packed.shape == (8, 3 * w + 1) and packed.dtype == torch.int32
    assert packed[:, -1].tolist() == [int(hz)] + [0] * 7
    coords = limbs.unpack(packed[:, :3 * w].contiguous(), FQ_SPEC)
    got = msm_sched._combine_windows(coords[:w], coords[w:2 * w],
                                     coords[2 * w:])
    want = kzg.host_msm(stage_points, [Fr(v) for v in vals])
    assert got == want
    assert _affine(got) == tnsh_stage_elements[name]
    # the context runs the same stages
    assert ctx.msm([Fr(v) for v in vals]) == want
    assert ctx.hazard_count == int(hz)


@pytest.mark.parametrize("lanes,hazards", [(64, 64), (4096, 0)])
def test_equal_points_inside_one_group_are_doubled(lanes, hazards):
    """128 equal bases with equal scalars form one group.  On 64 lanes
    each lane meets its own point in the insertion (a hazard, doubled in
    the lane); on 4096 every point has a lane of its own and the equal
    points meet in the tail's fold, whose add doubles.  Either way the
    host's element."""
    g = G1.generator()
    pts = [g * 7] * 128
    scs = [Fr(3)] * 128
    ctx = msm_sched.ScheduledMsmContext(pts, device="cpu", lanes=lanes)
    assert ctx.msm(scs) == g * (7 * 3 * 128) == kzg.host_msm(pts, scs)
    assert ctx.hazard_count == hazards


def test_tail_default_levels_and_wrong_arguments():
    lanes = 8
    pts = _point_ints(47, lanes)
    (X, Y, Z), _ = _both(pts)
    logk = torch.tensor([2, 2, 2, 2, 1, 1, 0, 0], dtype=torch.uint8)
    src = torch.zeros((128,), dtype=torch.int32)
    src[0], src[1], src[2] = 0, 4, 6           # digits 1, 2, 3 of one window
    mask = torch.zeros((128,), dtype=torch.bool)
    mask[:3] = True
    hz = torch.tensor([5], dtype=torch.int32)
    packed = msm_sched.msm_tail(X, Y, Z, logk, src, mask, hz)   # all levels
    assert torch.equal(packed, msm_sched.msm_tail(X, Y, Z, logk, src, mask,
                                                  hz, 2))
    assert torch.equal(packed, msm_sched.msm_tail_plain(X, Y, Z, logk, src,
                                                        mask, hz, 2))
    want = (pts[0] + pts[1] + pts[2] + pts[3]) + (pts[4] + pts[5]) * 2 \
        + pts[6] * 3
    assert _port_points([packed[:, i:i + 1] for i in range(3)]) == [
        _affine(want)]
    assert int(packed[0, 3]) == 5
    with pytest.raises(ValueError):
        msm_sched.msm_tail(X, Y, Z, logk.to(torch.int32), src, mask, hz)
    with pytest.raises(ValueError):
        msm_sched.msm_tail(X, Y, Z, logk[:4], src, mask, hz)
    with pytest.raises(ValueError):
        msm_sched.msm_tail(X, Y, Z, logk, src[:100], mask[:100], hz)
    with pytest.raises(ValueError):
        msm_sched.msm_tail(X, Y, Z, logk, src, mask.to(torch.uint8), hz)
    with pytest.raises(ValueError):
        msm_sched.msm_tail(X, Y, Z, logk, src, mask, hz, 4)     # 8 lanes
    with pytest.raises(ValueError):
        msm_sched.msm_tail(X[:, :6].contiguous(), Y[:, :6].contiguous(),
                           Z[:, :6].contiguous(), logk[:6], src, mask, hz)


def test_forced_hazard_is_counted_and_doubled_in_its_lane():
    """One accumulator lane and equal bases: every insertion after the
    first meets its own point or a multiple of it.  The hazards are
    counted and the result still equals the host MSM's."""
    g = G1.generator()
    pts = [g * 7] * 4
    scs = [Fr(1)] * 4
    ctx = msm_sched.ScheduledMsmContext(pts, device="cpu", lanes=1)
    assert ctx.msm(scs) == g * 28 == kzg.host_msm(pts, scs)
    assert ctx.hazard_count == 1          # P + P; 2P + P and 3P + P add
    # the same through a native SRS
    srs_id = _native.srs_create_from_points(pts)
    try:
        ctx = msm_sched.ScheduledMsmContext.from_native_srs(
            srs_id, device="cpu", lanes=1)
        assert ctx.msm(scs) == g * 28 == _native.srs_msm(srs_id, scs)
        assert ctx.hazard_count == 1
    finally:
        _native.srs_free(srs_id)


@pytest.fixture(scope="module")
def native_srs():
    rng = random.Random(31)
    n = 1536
    scal = b"".join(rng.randrange(MODULUS).to_bytes(32, "little")
                    for _ in range(n))
    srs_id = _native.srs_create_fixed_base(G1.generator(), scal)
    yield srs_id, n
    _native.srs_free(srs_id)


def test_native_srs_context_matches(native_srs):
    srs_id, _ = native_srs
    rng = random.Random(32)
    ctx = msm_sched.ScheduledMsmContext.from_native_srs(
        srs_id, device="cpu", n=32)
    scalars = [Fr(rng.randrange(MODULUS)) for _ in range(32)]
    assert ctx.msm(scalars) == _native.srs_msm(srs_id, scalars)


@pytest.mark.parametrize("n_scalars,route", [(100, "host"),
                                             (1536, "device")])
def test_router_sends_an_msm_by_its_size(native_srs, n_scalars, route):
    """``srs_msm_many`` and ``msm`` over a native SRS, below the gate (the
    native host MSM) and above it (the scheduled Pippenger on the named
    device): the same elements, counted under their route."""
    from tnsh_torch.core.params import NativeSRS

    srs_id, n = native_srs
    assert kzg.DEVICE_MSM_MIN == 1024 and n_scalars <= n
    rng = random.Random(47)
    blobs = [b"".join(rng.randrange(1 << 20).to_bytes(32, "little")
                      for _ in range(n_scalars)) for _ in range(2)]
    want = [_native.srs_msm(srs_id, b) for b in blobs]
    kzg.reset_route_counts()
    assert kzg.srs_msm_many(srs_id, blobs, "cpu") == want
    scal = [Fr(int.from_bytes(blobs[0][32 * i:32 * i + 32], "little"))
            for i in range(n_scalars)]
    assert kzg.msm(NativeSRS(srs_id), scal, "cpu") == want[0]
    other = {"host": "device", "device": "host"}[route]
    assert kzg.route_counts() == {route: 3, other: 0}


def test_every_msm_entry_point_needs_its_device():
    """No default chooses the host: an MSM entry point called without a
    device is a TypeError."""
    params, _ = setup_multilinear_params(3)
    col = [Fr(v) for v in range(8)]
    with pytest.raises(TypeError):
        msm_sched.ScheduledMsmContext([G1.generator()])
    with pytest.raises(TypeError):
        msm_sched.ScheduledMsmContext.from_native_srs(0)
    with pytest.raises(TypeError):
        kzg.msm([G1.generator()], [Fr(1)])
    with pytest.raises(TypeError):
        kzg.srs_msm_many(0, [])
    with pytest.raises(TypeError):
        msm_group.pack_g1_points([G1.generator()])
    with pytest.raises(TypeError):
        MultilinearKZG.commit(params, col)
    with pytest.raises(TypeError):
        MultilinearKZG.commit_many(params, [col])
    with pytest.raises(TypeError):
        MultilinearKZG.open(params, col, [Fr(1)] * 3)


def test_commit_many_and_open_on_the_device_equal_the_host(monkeypatch):
    """PST commitments and an opening with their MSMs through the port's
    scheduled Pippenger equal the host-MSM ones, and the opening
    verifies."""
    from tnsh_torch.commit.mkzg import multilinear_verification_key

    params, _ = setup_multilinear_params(11)
    rng = random.Random(53)
    cols = [[rng.randrange(2) for _ in range(2048)],
            [rng.randrange(MODULUS) for _ in range(2048)]]
    point = [Fr(rng.randrange(MODULUS)) for _ in range(11)]
    # the host's answers: with the gate out of reach every MSM is native
    with monkeypatch.context() as mp:
        mp.setattr(kzg, "DEVICE_MSM_MIN", 1 << 30)
        kzg.reset_route_counts()
        host = MultilinearKZG.commit_many(params, cols, "cpu")
        h_value, h_proof = MultilinearKZG.open(params, cols[1], point, "cpu")
        assert kzg.route_counts() == {"device": 0, "host": 13}
    MultilinearKZG.prepare_device(params, "cpu")
    dev = MultilinearKZG.commit_many(params, cols, "cpu")
    assert dev == host
    assert MultilinearKZG.commit(params, cols[1], "cpu") == host[1]
    value, proof = MultilinearKZG.open(params, cols[1], point, "cpu")
    assert value == h_value and proof.quotients == h_proof.quotients
    assert MultilinearKZG.verify(multilinear_verification_key(11), dev[1],
                                 point, value, proof)


# ---------------------------------------------------------------------------
# The plan on the card: the digits and rank kernels against their plain
# versions (signed_digits, the digit counts, MsmPlan, build_schedule)
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
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaDevAttrMultiProcessorCount = 16,
       cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 1; return 0; }
template <class K> inline cudaError_t
cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, K, int, int) {
  *b = 1; return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
// A block's threads run as threads, one block after another: shared
// memory is static, __syncthreads a barrier of the block, a warp's
// __match_any_sync an exchange between two barriers of the warp, atomics
// the compiler's.
static std::barrier<>* block_barrier;
static std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
static uint32_t warp_slots[1024];
static int or_slot;
#define __syncthreads() block_barrier->arrive_and_wait()
inline int __syncthreads_or(int p) {
  block_barrier->arrive_and_wait();
  if (threadIdx.x == 0) or_slot = 0;
  block_barrier->arrive_and_wait();
  if (p) __atomic_fetch_or(&or_slot, 1, __ATOMIC_RELAXED);
  block_barrier->arrive_and_wait();
  return or_slot;
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
inline int __popc(unsigned v) { return __builtin_popcount(v); }
template <class T> inline T atomicAdd(T* p, T v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }
template <class T> inline T atomicOr(T* p, T v) {
  return __atomic_fetch_or(p, v, __ATOMIC_RELAXED); }
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
def host_plan_kernels(tmp_path_factory):
    """``csrc/msm_kernels.cu`` built by g++ with the threaded mock: the
    digits and rank launches become ``host_launch`` calls (every block and
    thread of the grid); the other kernels are compiled, not run."""
    import ctypes
    import os
    import re
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("msm_plan_host")
    csrc = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tnsh_torch", "csrc")
    field = open(os.path.join(csrc, "field.cuh")).read()
    src = open(os.path.join(csrc, "msm_kernels.cu")).read()
    src, launches = re.subn(
        r"(msm_(?:digits|rank)_kernel)<<<(.*?),(.*?),.*?>>>\((.*?)\);",
        r"host_launch(dim3(\2), dim3(\3), [&] { \1(\4); });", src,
        flags=re.S)
    assert launches == 2
    (tmp / "field.cuh").write_text(re.sub(r"<<<.*?>>>", "", field,
                                          flags=re.S))
    (tmp / "msm_kernels.cpp").write_text(re.sub(r"<<<.*?>>>", "", src,
                                                flags=re.S))
    (tmp / "cuda_runtime.h").write_text(_MOCK_RUNTIME)
    lib_path = tmp / "libmsm_plan_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I",
         str(tmp), str(tmp / "msm_kernels.cpp"), "-o", str(lib_path)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = ctypes.CDLL(str(lib_path))
    lib.tnsh_msm_digits.argtypes = [vp, i64, vp, i64, i64] + [vp] * 4
    lib.tnsh_msm_rank.argtypes = [vp, i64, i64, i32, i64] + [vp] * 5 + [
        i64, i64, vp]
    return lib


def _vp(t):
    import ctypes

    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _host_digits(lib, words, valid, m):
    """``msm_digits`` through the mock-built kernel: (digits, stats)."""
    n = words.shape[0]
    chunks = -(-n // m)
    digits = torch.full((32, chunks * m), 99, dtype=torch.int8)
    stats = torch.zeros((chunks * 32 * 129 + 9,), dtype=torch.int32)
    assert lib.tnsh_msm_digits(_vp(words), n, _vp(valid), chunks * m, m,
                               _vp(digits), _vp(stats), _vp(stats[-9:]),
                               None) == 0
    return digits, stats


def _host_rank(lib, digits, plan, m):
    """``msm_rank`` through the mock-built kernel, on the plan's maps."""
    steps = torch.from_numpy(plan.rc_per_chunk)
    row_off = torch.cumsum(steps, 0, dtype=torch.int32) - steps
    rows = int(steps.sum())
    sched = torch.zeros((rows, plan.lanes), dtype=torch.int32)
    maps = [torch.from_numpy(plan.base_map), torch.from_numpy(plan.logk_map)]
    assert lib.tnsh_msm_rank(
        _vp(digits), digits.shape[1], m, plan.w_count, steps.shape[0],
        *map(_vp, maps + [steps, row_off]), _vp(sched), rows, plan.lanes,
        None) == 0
    return sched, (*maps, steps, row_off, rows)


def _kind_scalars(kind, n, seed):
    """Scalar ints of the three kinds the main path commits (0/1 bit
    columns, ``bench_rw``'s small values, full-width Fr) and the edges."""
    rng = random.Random(seed)
    if kind == "bits":
        return [rng.randrange(2) for _ in range(n)]
    if kind == "values":
        return [42 * rng.randrange(1 << 20) + 1 for _ in range(n)]
    if kind == "heavy":
        return [3 if i < n // 2 else 5 for i in range(n)]
    if kind == "all_equal":
        return [424242] * n
    edge = [0, 1, 127, 128, 255, 256, MODULUS - 1, (1 << 248) - 1]
    return edge + [rng.randrange(MODULUS) for _ in range(n - len(edge))]


def _words(vals):
    """``(n, 8)`` int32 words of scalar ints: their 32 LE bytes."""
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    return torch.frombuffer(bytearray(raw), dtype=torch.int32).view(-1, 8)


@pytest.mark.parametrize("kind,n,m,masked", [
    ("bits", 1500, 512, True), ("values", 5000, 4096, True),
    ("full", 1537, 512, True), ("full", 700, 1024, False),
    ("heavy", 2048, 512, True)])
def test_digits_kernel_equals_signed_digits_and_the_counts(
        host_plan_kernels, kind, n, m, masked):
    """The digits kernel, every thread of every block run on the host,
    against the plain version and, under it, ``signed_digits`` and the
    native counts: ragged n (zero digits past it), invalid bases (zero
    digits, not counted, but in W) or none marked (no mask), W from the
    words' OR, no carry."""
    vals = _kind_scalars(kind, n, seed=n)
    words = _words(vals)
    rng = np.random.default_rng(n)
    valid_np = rng.random(n + 5) > (0.1 if masked else -1)
    valid = torch.from_numpy(valid_np.astype(np.uint8)) if masked else None
    digits, stats = _host_digits(host_plan_kernels, words, valid, m)
    want_digits, want_stats = msm_sched.msm_digits_plain(words, valid, m)
    assert torch.equal(digits, want_digits)
    assert torch.equal(stats, want_stats)
    # the plain version against the host plan's own pieces
    sb = msm_sched.scalars_to_byte_matrix(words, n)
    d = msm_sched.signed_digits(sb)
    w_count = d.shape[0]
    assert w_count == {"bits": 4, "values": 8, "heavy": 4}.get(kind, 32)
    d[:, ~valid_np[:n]] = 0
    chunks = -(-n // m)
    d = np.pad(d, ((0, 0), (0, chunks * m - n)))
    assert np.array_equal(digits[:w_count].numpy(), d)
    assert not digits[w_count:].any()
    ccnt = _native.msm_digit_counts(d, m)
    ccnt[:, :, 0] = 0
    counts = stats[:-9].numpy().reshape(chunks, 32, 129)
    assert np.array_equal(counts[:, :w_count], ccnt)
    assert not counts[:, w_count:].any()
    plan = msm_sched.plan_of_stats(stats.numpy(), chunks, 4096)
    host = msm_sched.MsmPlan(d, m, 4096)
    assert plan.w_count == host.w_count == w_count
    assert plan.digits == host.digits == np.count_nonzero(d)


def test_digits_kernel_flags_a_scalar_out_of_range(host_plan_kernels):
    """A scalar whose top byte carries out of the 32 windows (2^255 - 1:
    not a field element) sets the carry flag, and the plan raises
    ``signed_digits``' ``ValueError``; below it nothing is flagged."""
    m = 512
    valid = torch.ones(600, dtype=torch.uint8)
    for vals, flagged in (([5] * 300 + [(1 << 255) - 1], True),
                          ([5] * 300 + [MODULUS - 1], False)):
        words = _words(vals)
        digits, stats = _host_digits(host_plan_kernels, words, valid, m)
        want_digits, want_stats = msm_sched.msm_digits_plain(words, valid, m)
        assert torch.equal(digits, want_digits)
        assert torch.equal(stats, want_stats)
        assert bool(stats[-1]) == flagged
        sb = msm_sched.scalars_to_byte_matrix(words, len(vals))
        if flagged:
            with pytest.raises(ValueError, match="out of field range"):
                msm_sched.plan_of_stats(stats.numpy(), 1, 4096)
            with pytest.raises(ValueError, match="out of field range"):
                msm_sched.signed_digits(sb)
        else:
            msm_sched.plan_of_stats(stats.numpy(), 1, 4096)


@pytest.mark.parametrize("kind,n,m,lanes", [
    ("bits", 1500, 512, 256), ("heavy", 1024, 512, 256),
    ("all_equal", 1024, 512, 1024), ("values", 1500, 512, 4096),
    ("full", 1024, 512, 4096), ("full", 600, 512, 65536)])
def test_rank_kernel_equals_build_schedule(host_plan_kernels, kind, n, m,
                                           lanes):
    """The rank kernel (ranks by ``__match_any_sync`` in a warp, the
    warps' counts scanned, the running count carried over the tiles)
    against ``build_schedule`` chunk by chunk, with ``torch.equal``: W =
    4, 8 and 32; 256 to 65,536 lanes; one heavy group, all digits equal."""
    vals = _kind_scalars(kind, n, seed=7 * n)
    valid = torch.ones(n, dtype=torch.uint8)
    valid[3] = 0
    digits, stats = _host_digits(host_plan_kernels, _words(vals), valid, m)
    plan = msm_sched.plan_of_stats(stats.numpy(), -(-n // m), lanes)
    assert plan.w_count == {"bits": 4, "heavy": 4, "all_equal": 4,
                            "values": 8}.get(kind, 32)
    sched, args = _host_rank(host_plan_kernels, digits, plan, m)
    want = msm_sched.msm_rank_plain(digits, *args, m, lanes)
    assert sched.shape == want.shape and torch.equal(sched, want)
    assert int((sched != 0).sum()) == plan.digits
    if kind in ("heavy", "all_equal"):
        assert int(plan.rc_per_chunk.max()) > 1 or plan.fold_levels > 0


def test_rank_kernel_keeps_inside_the_schedule(host_plan_kernels):
    """A chunk whose rows would leave the schedule (a row count one short
    of the steps) writes nothing; the chunks before it are written."""
    import ctypes

    n, m, lanes = 1500, 512, 4096
    digits, stats = _host_digits(host_plan_kernels, _words(
        _kind_scalars("values", n, seed=5)), torch.ones(n, dtype=torch.uint8),
        m)
    plan = msm_sched.plan_of_stats(stats.numpy(), 3, lanes)
    sched, (bmap, lmap, steps, row_off, rows) = _host_rank(
        host_plan_kernels, digits, plan, m)
    short = torch.full((rows, lanes), 7, dtype=torch.int32)
    short[:rows - 1] = 0
    assert host_plan_kernels.tnsh_msm_rank(
        _vp(digits), digits.shape[1], m, plan.w_count, 3,
        *map(_vp, (bmap, lmap, steps, row_off)), _vp(short), rows - 1,
        lanes, None) == 0
    last = int(row_off[-1])
    assert torch.equal(short[:last], sched[:last])
    assert not short[last:rows - 1].any() and (short[rows - 1] == 7).all()
    assert host_plan_kernels.tnsh_msm_rank(
        _vp(digits), digits.shape[1], 300, plan.w_count, 3,
        *map(_vp, (bmap, lmap, steps, row_off)), _vp(short), rows, lanes,
        ctypes.c_void_p()) != 0                  # a chunk size it refuses


@pytest.mark.parametrize("name", _CASES)
@pytest.mark.parametrize("lanes", [256, 4096, 1 << 16])
def test_plan_from_counts_equals_the_host_plan(name, lanes):
    """``MsmPlan.from_counts`` of the digits' counts against ``MsmPlan``
    of the digits, field by field (values and dtypes)."""
    d, m = _digit_cases()[name]
    ccnt = _native.msm_digit_counts(d, m)
    if name == "uniform" and lanes < 4096:
        with pytest.raises(RuntimeError):
            msm_sched.MsmPlan.from_counts(ccnt, lanes)
        return
    got = msm_sched.MsmPlan.from_counts(ccnt, lanes)
    want = msm_sched.MsmPlan(d.copy(), m, lanes)
    assert vars(got).keys() == vars(want).keys()
    for field, value in vars(want).items():
        mine = getattr(got, field)
        if isinstance(value, np.ndarray):
            assert mine.dtype == value.dtype, field
            assert np.array_equal(mine, value), field
        else:
            assert mine == value, field
    with pytest.raises(ValueError):
        msm_sched.MsmPlan.from_counts(ccnt, 3000)


def test_plan_wrappers_run_their_plain_versions_and_check_arguments():
    """On CPU tensors ``msm_digits`` and ``msm_rank`` are their plain
    versions (no launch counted); wrong arguments raise."""
    n, m = 900, 512
    words = _words(_kind_scalars("values", n, seed=1))
    valid = torch.ones(n, dtype=torch.uint8)
    digits, stats = msm_sched.msm_digits(words, valid, m)
    assert msm_sched.msm_digits.launches == 0
    plan = msm_sched.plan_of_stats(stats.numpy(), 2, 4096)
    steps = torch.from_numpy(plan.rc_per_chunk)
    row_off = torch.cumsum(steps, 0, dtype=torch.int32) - steps
    maps = (torch.from_numpy(plan.base_map), torch.from_numpy(plan.logk_map))
    rows = int(steps.sum())
    sched = msm_sched.msm_rank(digits, *maps, steps, row_off, rows, m, 4096)
    assert msm_sched.msm_rank.launches == 0
    assert torch.equal(sched, msm_sched.msm_rank_plain(
        digits, *maps, steps, row_off, rows, m, 4096))
    with pytest.raises(ValueError, match="words"):
        msm_sched.msm_digits(words.to(torch.int64), valid, m)
    with pytest.raises(ValueError, match="valid"):
        msm_sched.msm_digits(words, valid[:10], m)
    with pytest.raises(ValueError, match="chunk size"):
        msm_sched.msm_digits(words, valid, 300)
    with pytest.raises(ValueError, match="base_map"):
        msm_sched.msm_rank(digits, maps[0][:, :100].contiguous(), maps[1],
                           steps, row_off, rows, m, 4096)
    with pytest.raises(ValueError, match="row_off"):
        msm_sched.msm_rank(digits, *maps, steps, row_off.long(), rows, m,
                           4096)
    with pytest.raises(ValueError, match="chunks"):
        msm_sched.msm_rank(digits, *maps, steps, row_off, rows, 2048, 4096)


def test_msm_over_cpu_word_tensors(point_ints):
    """A context takes the scalars as an ``(n, 8)`` int32 tensor of their
    words too: the element of their bytes."""
    rng = random.Random(61)
    vals = [rng.randrange(MODULUS) for _ in range(len(point_ints))]
    ctx = msm_sched.ScheduledMsmContext(point_ints, device="cpu")
    want = kzg.host_msm(point_ints, [Fr(v) for v in vals])
    assert ctx.msm(_words(vals)) == want
    assert ctx.msm(_words(vals)[:13]) == kzg.host_msm(
        point_ints[:13], [Fr(v) for v in vals[:13]])


def test_open_device_sends_device_levels_as_word_tensors(monkeypatch):
    """``open_device`` keeps the quotient levels of device MSMs as word
    tensors (here the CPU's, run by the plain versions) and gives
    ``open``'s value and proof; the router counts each level once."""
    from tnsh_torch.commit import mkzg

    params, _ = setup_multilinear_params(11)
    rng = random.Random(59)
    vals = [rng.randrange(MODULUS) for _ in range(2048)]
    point = [Fr(rng.randrange(MODULUS)) for _ in range(11)]
    MultilinearKZG.prepare_device(params, "cpu")
    want_value, want_proof = MultilinearKZG.open(
        params, [Fr(v) for v in vals], point, "cpu")
    seen = []
    real = mkzg._level_msms

    def level_msms(params, levels, device):
        seen.extend(type(lv).__name__ for lv in levels)
        return real(params, levels, device)

    monkeypatch.setattr(mkzg, "_level_msms", level_msms)
    kzg.reset_route_counts()
    ((value, proof),) = MultilinearKZG.open_device(
        params, [limbs.pack(vals, "cpu")], [point], "cpu")
    assert value == want_value and proof.quotients == want_proof.quotients
    assert seen == ["Tensor"] + ["bytes"] * 10
    assert kzg.route_counts() == {"device": 1, "host": 10}


# ---------------------------------------------------------------------------
# The plan on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _kind_words(kind, n, seed, device):
    """``(n, 8)`` int32 words of n scalars of a kind, made with numpy:
    0/1 bit columns, ``bench_rw``'s values, full-width Fr (top word below
    the modulus')."""
    gen = np.random.default_rng(seed)
    w = np.zeros((n, 8), dtype=np.uint32)
    if kind == "bits":
        w[:, 0] = gen.integers(0, 2, n)
    elif kind == "values":
        w[:, 0] = 42 * gen.integers(0, 1 << 20, n) + 1
    else:
        w[:] = gen.integers(0, 1 << 32, (n, 8), dtype=np.uint64)
        w[:, 7] %= MODULUS >> 224
    return torch.from_numpy(w.view(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [16, 20])
@pytest.mark.parametrize("kind", ["bits", "values", "full"])
def test_card_plan_kernels_equal_their_plain_versions(cuda, kind, log_n):
    """On the card at the main path's shapes: the digits kernel's digits
    and stats, and the rank kernel's schedule at the derived width,
    element for element those of the plain versions (which run on the
    same tensors); one launch each."""
    n = 1 << log_n
    words = _kind_words(kind, n, log_n, cuda)
    valid = torch.ones(n, dtype=torch.uint8, device=cuda)
    valid[11] = 0
    m = msm_sched._choose_chunk(n)
    chunks = -(-n // m)
    msm_sched.msm_digits.launches = msm_sched.msm_rank.launches = 0
    digits, stats = msm_sched.msm_digits(words, valid, m)
    want_digits, want_stats = msm_sched.msm_digits_plain(words, valid, m)
    assert torch.equal(digits, want_digits)
    assert torch.equal(stats, want_stats)
    plan = msm_sched.plan_of_stats(stats.cpu().numpy(), chunks,
                                   msm_sched.resident_lanes(0))
    assert plan.w_count == {"bits": 4, "values": 8}.get(kind, 32)
    steps = torch.from_numpy(plan.rc_per_chunk)
    row_off = (torch.cumsum(steps, 0, dtype=torch.int32) - steps).to(cuda)
    maps = (torch.from_numpy(plan.base_map).to(cuda),
            torch.from_numpy(plan.logk_map).to(cuda))
    args = (digits, *maps, steps.to(cuda), row_off, int(steps.sum()), m,
            plan.lanes)
    sched = msm_sched.msm_rank(*args)
    assert torch.equal(sched, msm_sched.msm_rank_plain(*args))
    assert int((sched != 0).sum()) == plan.digits
    assert (msm_sched.msm_digits.launches, msm_sched.msm_rank.launches) == (
        1, 1)


@pytest.mark.cuda
def test_card_msm_over_device_words_equals_the_host(cuda):
    """Each scalar kind through a context on the card, as bytes and as a
    word tensor already there: the native host MSM's element; the MSM
    planned on the card once (``msm_device_plans``) with the host plan's
    digit count (``msm_digits``)."""
    from tnsh_torch.utils.profiling import PhaseTimer

    n = 1 << 14
    rng = random.Random(71)
    raw = b"".join(rng.randrange(MODULUS).to_bytes(32, "little")
                   for _ in range(n))
    srs = _native.srs_create_fixed_base(G1.generator(), raw)
    try:
        ctx = msm_sched.ScheduledMsmContext.from_native_srs(srs, device=cuda)
        for seed, kind in enumerate(("bits", "values", "full")):
            words = _kind_words(kind, n - 5, seed, cuda)
            scal = words.cpu().numpy().tobytes()
            want = _native.srs_msm(srs, scal)
            assert ctx.msm(scal) == want
            timer = PhaseTimer()
            with timer.phase("msm"):
                assert ctx.msm(words) == want
            host = msm_sched.MsmPlan(np.pad(msm_sched.signed_digits(
                msm_sched.scalars_to_byte_matrix(scal, n - 5)),
                ((0, 0), (0, 5))), ctx.m, ctx.lanes)
            assert timer.counters == {"msm_device_plans": 1,
                                      "msm_digits": host.digits}
        assert ctx.hazard_count == 0
        with pytest.raises(ValueError, match="out of field range"):
            ctx.msm(((1 << 255) - 1).to_bytes(32, "little") * 2048)
    finally:
        _native.srs_free(srs)


@pytest.mark.cuda
def test_card_commit_many_and_open_device_equal_the_host(cuda, monkeypatch):
    """PST commitments and an opening from a table on the card, their
    MSMs planned there, equal the host MSM's; the device named as the
    provers name it, ``"cuda"``, without an index."""
    params, _ = setup_multilinear_params(12)
    rng = random.Random(73)
    cols = [[rng.randrange(2) for _ in range(4096)],
            [42 * rng.randrange(1 << 20) + 1 for _ in range(4096)],
            [rng.randrange(MODULUS) for _ in range(4096)]]
    point = [Fr(rng.randrange(MODULUS)) for _ in range(12)]
    with monkeypatch.context() as mp:
        mp.setattr(kzg, "DEVICE_MSM_MIN", 1 << 30)
        host = MultilinearKZG.commit_many(params, cols, "cpu")
        h_value, h_proof = MultilinearKZG.open(params, cols[2], point, "cpu")
    MultilinearKZG.prepare_device(params, "cuda")
    kzg.reset_route_counts()
    assert MultilinearKZG.commit_many(params, cols, "cuda") == host
    ((value, proof),) = MultilinearKZG.open_device(
        params, [limbs.pack(cols[2], cuda)], [point], "cuda")
    assert value == h_value and proof.quotients == h_proof.quotients
    assert kzg.route_counts() == {"device": 5, "host": 10}


@pytest.mark.cuda
@pytest.mark.parametrize("prover", ["twist_bits", "shout_bits"])
def test_card_device_plans_equal_the_device_routes(cuda, prover):
    """Every device MSM of a TwistBits and a ShoutBits prove on the card
    is planned there: ``msm_device_plans`` equals the router's device
    count."""
    from tnsh_torch.protocols.shout import LookupTable
    from tnsh_torch.protocols.twist import MemoryTrace
    from tnsh_torch.protocols.twist_bits import ShoutBits, TwistBits, \
        setup_params
    from tnsh_torch.utils.profiling import PhaseTimer

    log_k, log_t = 10, 12
    rng = random.Random(79)
    pp = setup_params(4)[0]
    timer = PhaseTimer()
    if prover == "twist_bits":
        tr = MemoryTrace(1 << log_k)
        for i in range(1 << log_t):
            if i % 3 == 0:
                tr.write(rng.randrange(1 << log_k), Fr(42 * i + 1))
            else:
                tr.read(rng.randrange(1 << log_k))
        kzg.reset_route_counts()
        TwistBits.prove(tr, pp, cuda, timer)
    else:
        tbl = LookupTable([Fr(3 * i + 1) for i in range(1 << log_k)])
        for _ in range((1 << log_t) - 1):
            tbl.lookup(rng.randrange(1 << log_k))
        kzg.reset_route_counts()
        ShoutBits.prove(tbl, pp, cuda, timer)
    device = kzg.route_counts()["device"]
    assert device > 0 and timer.counters["msm_device_plans"] == device
