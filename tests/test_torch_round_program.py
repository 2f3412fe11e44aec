"""The round-evaluation program of the port: the factored straight-line
program that ``fr_kernels.terms`` builds from a sum of products, run by
the plain version, against the JAX package and against term-by-term
evaluation in Python integers.

Every comparison is exact equality of canonical field elements
(tolerance 0).  The JAX side runs ``sum_of_products_round_evals_d``
un-jitted, as ``tests/test_torch_mle.py`` does.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import j_phase_terms
from tnsh.field.fr import MODULUS, Fr
from tnsh.poly import mle_jax
from tnsh_torch.field import fq_kernels, fr_kernels, limbs
from tnsh_torch.field.fr import Fr as PortFr
from tnsh_torch.iop.sumcheck import (
    TorchProductMLEOracle,
    TorchSumOfProductsOracle,
)
from tnsh_torch.iop.sumcheck_d import TorchSopOracleD
from tnsh_torch.poly.mle_host import MultilinearExtension as PortMLE

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

P = MODULUS


def _inputs(seed, num_tables, num_terms, n, bit_tables=()):
    """Seeded numpy values: (tables as ints, coefficients as ints)."""
    rng = np.random.default_rng(seed)

    def field(count):
        words = rng.integers(0, 1 << 32, (count, 8), dtype=np.uint64)
        return [sum(int(w) << (32 * k) for k, w in enumerate(row)) % P
                for row in words]

    tables = [field(n) for _ in range(num_tables)]
    for f in bit_tables:
        tables[f] = [int(b) for b in rng.integers(0, 2, n)]
    return tables, field(num_terms)


def _port_evals(tables, coeffs, idxs, npts):
    stacked = torch.stack([limbs.pack(t, "cpu") for t in tables])
    cf = torch.cat([limbs.scalar(c, "cpu") for c in coeffs], dim=1)
    desc = fr_kernels.terms(idxs, "cpu")
    out = fr_kernels.sum_of_products_round_evals(stacked, cf, desc, npts)
    assert out.shape == (8, npts)
    return limbs.unpack(out), desc


def _unfactored(tables, coeffs, idxs, npts):
    """g(0..npts-1), every term multiplied out alone, in Python ints."""
    half = len(tables[0]) // 2
    out = []
    for x in range(npts):
        total = 0
        for i in range(half):
            for c, term in zip(coeffs, idxs):
                prod = c
                for f in term:
                    lo, hi = tables[f][2 * i], tables[f][2 * i + 1]
                    prod = prod * (lo + x * (hi - lo)) % P
                total += prod
        out.append(total % P)
    return out


@pytest.mark.parametrize("npts", [4, 9, 14])
@pytest.mark.parametrize("n", [2, 8, 64])
def test_j_phase_program_matches_jax(n, npts):
    """The TwistBits j-phase terms at log K = 3 (21 tables, 19 terms),
    factored, against tnsh's term-by-term round evaluations."""
    idxs, num_tables, bits = j_phase_terms(3)
    tables, coeffs = _inputs(1000 * n + npts, num_tables, len(idxs), n, bits)
    got, desc = _port_evals(tables, coeffs, idxs, npts)
    assert desc.products < desc.products_unfactored
    js = [jnp.asarray(mle_jax.pack_mle([Fr(v) for v in t])) for t in tables]
    jc = [jnp.asarray(mle_jax.pack_fr_scalar(Fr(c))) for c in coeffs]
    want = [int(v) for v in mle_jax.unpack_fr(
        mle_jax.sum_of_products_round_evals_d(js, jc, idxs, npts))]
    assert got == want


STRUCTURES = {
    "repeated_tables": ((0, 1, 0, 1), (1, 0, 1), (0, 1, 0, 2)),
    "a_table_squared": ((0, 0), (0,), (1, 1, 1), (1, 1)),
    "one_factor_terms": ((0,), (1,), (2,), (0,)),
    "no_shared_prefix": ((0, 1), (1, 0), (2, 3), (3, 2)),
    "a_term_that_is_a_prefix": ((0, 1, 2), (0, 1), (0,), (0, 1, 2, 3)),
    "the_same_term_twice": ((0, 1), (0, 1), (2,), (2,)),
    "nested_branches": ((0, 1, 2), (0, 1, 3), (0, 2, 1), (0, 2, 3), (1,)),
}


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_program_equals_unfactored_evaluation(name):
    idxs = STRUCTURES[name]
    tables, coeffs = _inputs(len(name), 4, len(idxs), 4)
    got, _ = _port_evals(tables, coeffs, idxs, 5)
    assert got == _unfactored(tables, coeffs, idxs, 5)
    # the same terms in another order: another program, the same values
    order = list(range(len(idxs)))
    random.Random(7).shuffle(order)
    again, _ = _port_evals(tables, [coeffs[k] for k in order],
                           [idxs[k] for k in order], 5)
    assert again == got


@pytest.mark.parametrize("seed", range(8))
def test_random_term_systems_equal_unfactored_evaluation(seed):
    rng = random.Random(seed)
    num_tables = rng.randrange(1, 6)
    idxs = tuple(tuple(rng.randrange(num_tables)
                       for _ in range(rng.randrange(1, 6)))
                 for _ in range(rng.randrange(1, 9)))
    used = 1 + max(max(t) for t in idxs)
    n = rng.choice([2, 4, 8])
    npts = rng.randrange(2, 8)
    tables, coeffs = _inputs(100 + seed, used, len(idxs), n)
    got, desc = _port_evals(tables, coeffs, idxs, npts)
    assert got == _unfactored(tables, coeffs, idxs, npts)
    assert desc.products <= desc.products_unfactored


def test_a_trie_deeper_than_the_stack_is_refused():
    """Branches nested deeper than the kernel's stack raise: no second,
    costlier program is built behind the caller's back."""
    levels = fr_kernels.MAX_STACK_SLOTS + 2
    idxs = tuple(tuple(range(j + 1)) + (levels + j,) for j in range(levels))
    idxs += (tuple(range(levels + 1)),)
    assert fr_kernels._round_program(idxs)[1] > fr_kernels.MAX_STACK_SLOTS
    with pytest.raises(ValueError, match="nests"):
        fr_kernels.terms(idxs, "cpu")
    # one level within the stack is built and evaluates right
    idxs = tuple(t for t in idxs if len(t) <= fr_kernels.MAX_STACK_SLOTS)
    tables, coeffs = _inputs(5, 2 * levels, len(idxs), 2)
    got, desc = _port_evals(tables, coeffs, idxs, 3)
    assert 1 < desc.depth <= fr_kernels.MAX_STACK_SLOTS
    assert got == _unfactored(tables, coeffs, idxs, 3)


def test_j_phase_product_count_is_pinned():
    """The K = 2^10 structure the GPU smoke run times: 49 tables, 47 terms
    of 159 factors in all, 72 products a lane pair and point."""
    idxs, num_tables, _ = j_phase_terms(10)
    desc = fr_kernels.terms(idxs, "cpu")
    assert (num_tables, len(idxs)) == (49, 47)
    assert desc.products_unfactored == 159
    assert desc.products == 72 <= 100
    assert desc.depth == 2 <= fr_kernels.MAX_STACK_SLOTS
    assert desc.code.dtype == torch.int32
    assert desc.code.tolist() == [op + 8 * a for op, a in desc.program]
    # one term of 13 factors (phase B): nothing to share, 13 products
    assert fr_kernels.terms([tuple(range(13))], "cpu").products == 13


def test_product_round_is_the_one_term_program():
    tables, _ = _inputs(11, 3, 1, 8)
    stacked = torch.stack([limbs.pack(t, "cpu") for t in tables])
    scale = 0xC0FFEE
    got = limbs.unpack(fr_kernels.product_round_evals(
        stacked, limbs.scalar(scale, "cpu")))
    assert got == _unfactored(tables, [scale], ((0, 1, 2),), 4)
    assert limbs.unpack(fr_kernels.product_round_evals(stacked)) == (
        _unfactored(tables, [1], ((0, 1, 2),), 4))


@pytest.mark.parametrize("make", [
    lambda **kw: TorchSopOracleD(2, [(1, [[1, 2, 3, 4]])], **kw),
    lambda **kw: TorchSumOfProductsOracle(2, [(1, [[1, 2, 3, 4]])], **kw),
    lambda **kw: TorchProductMLEOracle(
        [PortMLE.from_evaluations([PortFr(v) for v in (1, 2, 3, 4)])], **kw),
], ids=["TorchSopOracleD", "TorchSumOfProductsOracle",
        "TorchProductMLEOracle"])
def test_oracles_need_a_device(make):
    with pytest.raises(TypeError):
        make()
    assert make(device="cpu").num_vars == 2


@pytest.mark.parametrize("mod,r2", [
    (fr_kernels, limbs.FR_SPEC.r2_mod_p), (fq_kernels, limbs.FQ_SPEC.r2_mod_p),
], ids=["fr", "fq"])
def test_to_mont_builds_its_constant_once(mod, r2):
    words = torch.from_numpy(limbs.canonical_words([3, 5, 7]))
    first = mod.to_mont(words)
    built = fr_kernels.const_planes.cache_info().misses
    assert torch.equal(mod.to_mont(words), first)
    assert fr_kernels.const_planes.cache_info().misses == built
    dev = torch.device("cpu")
    assert fr_kernels.const_planes(r2, dev) is fr_kernels.const_planes(r2, dev)
    assert limbs.raw_ints(fr_kernels.const_planes(r2, dev)) == [r2]
