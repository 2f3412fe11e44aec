"""The port's MLE round functions against ``tnsh.poly.mle_jax``.

The same seeded values go to both packages.  The JAX side runs the
functions behind its XLA twins (``_fold_jit_xla`` and the
``*_round_evals_jit_xla`` jits, which ``tests/test_fr_pallas.py`` pins
equal to the Pallas kernels) op by op, un-jitted: the same exact
arithmetic, without whole-function XLA compiles, which take tens of
seconds each for these bodies on the CPU.
On the CPU the port's wrappers run their plain PyTorch versions.  Every
comparison is exact equality of canonical field elements (tolerance 0).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnsh.field.fr import MODULUS, Fr
from tnsh.poly import mle_jax
from tnsh.poly.mle import MultilinearExtension
from tnsh_torch.field import fr_kernels, limbs
from tnsh_torch.poly import mle

# The plain versions are thousands of small tensor ops: more than one
# intra-op thread only adds waiting, most of all beside other test workers.
torch.set_num_threads(1)

P = MODULUS
SIZES = [2, 16, 128]


def _vals(seed, n, bits=False):
    rng = random.Random(seed)
    if bits:
        return [rng.randrange(2) for _ in range(n)]
    return [rng.randrange(P) for _ in range(n)]


def _both(vals):
    """(port table, jax table) of the same values."""
    return (mle.pack_mle(vals, "cpu"),
            jnp.asarray(mle_jax.pack_mle([Fr(v) for v in vals])))


def _canon_j(planes):
    return [int(v) for v in mle_jax.unpack_fr(planes)]


def _canon_t(t):
    return [int(v) for v in mle.unpack_fr(t)]


@pytest.mark.parametrize("n", SIZES)
def test_fold_matches_jax(n):
    t, j = _both(_vals(n, n))
    r = Fr(0x1234567890ABCDEF + n)
    got = mle.fold(t, r)
    assert _canon_t(got) == _canon_j(
        mle_jax.fold(j, jnp.asarray(mle_jax.pack_fr_scalar(r))))
    # one stacked launch folds several tables alike
    t2, _ = _both(_vals(n + 1, n))
    both = mle.fold(torch.stack([t, t2]), r)
    assert torch.equal(both[0], got)


def test_evaluate_and_sum_tree_match_host():
    vals = _vals(7, 32)
    host = MultilinearExtension.from_evaluations([Fr(v) for v in vals])
    point = [Fr(v) for v in _vals(8, 5)]
    t, j = _both(vals)
    assert mle.unpack_fr(mle.evaluate(t, point)) == [host.evaluate(point)]
    assert mle.unpack_fr(mle.sum_tree(t)) == [host.sum_evaluations()]
    assert _canon_t(mle.sum_tree(t)) == _canon_j(mle_jax.sum_tree(j))


@pytest.mark.parametrize("n", SIZES)
def test_product_round_evals_matches_jax(n):
    pairs = [_both(_vals(100 * n + k, n)) for k in range(3)]
    ts, js = [p[0] for p in pairs], [p[1] for p in pairs]
    assert _canon_t(mle.product_round_evals(ts)) == _canon_j(
        mle_jax.product_round_evals(js, None))
    s = Fr(987654321123456789)
    assert _canon_t(mle.product_round_evals(
        ts, mle.pack_fr_scalar(s, "cpu"))) == _canon_j(
        mle_jax.product_round_evals(
            js, jnp.asarray(mle_jax.pack_fr_scalar(s))))


def _sop_inputs(seed, n):
    pairs = [_both(_vals(seed, n)), _both(_vals(seed + 1, n, bits=True)),
             _both(_vals(seed + 2, n))]
    coeffs = [1, P - 1, 7]
    idxs = ((0, 1, 2), (0, 1), (2,))
    return (
        [p[0] for p in pairs], [p[1] for p in pairs],
        [mle.pack_fr_scalar(c, "cpu") for c in coeffs],
        [jnp.asarray(mle_jax.pack_fr_scalar(Fr(c))) for c in coeffs],
        idxs,
    )


@pytest.mark.parametrize("n", SIZES)
def test_sum_of_products_round_evals_matches_jax(n):
    ts, js, tc, jc, idxs = _sop_inputs(300 + n, n)
    assert _canon_t(mle.sum_of_products_round_evals(ts, tc, idxs)) == (
        _canon_j(mle_jax.sum_of_products_round_evals(js, jc, idxs)))


@pytest.mark.parametrize("n,npts", [(32, 4), (32, 6), (32, 14), (2, 14)])
def test_sum_of_products_round_evals_d_matches_jax(n, npts):
    ts, js, tc, jc, _ = _sop_inputs(500 + n + npts, n)
    idxs = ((0, 1, 2, 0, 1), (1, 2), (0,))  # a degree-5 shared-table term
    got = mle.sum_of_products_round_evals_d(ts, tc, idxs, npts)
    assert got.shape == (8, npts)
    assert _canon_t(got) == _canon_j(
        mle_jax.sum_of_products_round_evals_d(js, jc, idxs, npts))


def test_product_round_step_matches_jax():
    pairs = [_both(_vals(900 + k, 64)) for k in range(3)]
    r = Fr(123456789)
    evals, folded = mle.product_round_step([p[0] for p in pairs], r)
    j_evals, j_folded = mle_jax.product_round_step.__wrapped__(
        tuple(p[1] for p in pairs), jnp.asarray(mle_jax.pack_fr_scalar(r)))
    assert _canon_t(evals) == _canon_j(j_evals)
    assert [_canon_t(f) for f in folded] == [_canon_j(f) for f in j_folded]


def test_jax_state_converts_into_the_port():
    """Planes taken from the JAX package mid-computation continue in the
    port: fold in JAX, convert with from_jax_planes, fold again in both."""
    _, j = _both(_vals(40, 16))
    r1, r2 = Fr(11), Fr(22)
    j1 = mle_jax.fold(j, jnp.asarray(mle_jax.pack_fr_scalar(r1)))
    t1 = torch.from_numpy(limbs.from_jax_planes(np.asarray(j1)))
    j2 = mle_jax.fold(j1, jnp.asarray(mle_jax.pack_fr_scalar(r2)))
    assert _canon_t(mle.fold(t1, r2)) == _canon_j(j2)


def test_wrappers_run_plain_on_cpu_without_launches():
    ts, _, tc, _, idxs = _sop_inputs(77, 8)
    before = fr_kernels.launch_counts()
    mle.sum_of_products_round_evals_d(ts, tc, idxs, 5)
    mle.product_round_step(ts, Fr(3))
    assert fr_kernels.launch_counts() == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 64, 2048])
def test_kernels_match_plain_on_card(cuda, n):
    ts, _, tc, _, idxs = _sop_inputs(1000 + n, n)
    tables = torch.stack(ts).to(cuda)
    coeffs = torch.cat(tc, dim=1).to(cuda)
    desc = fr_kernels.terms(idxs, cuda)
    for npts in (4, 14):
        got = fr_kernels.sum_of_products_round_evals(tables, coeffs, desc,
                                                     npts)
        want = fr_kernels.round_evals_plain(tables, coeffs, desc, npts)
        assert limbs.unpack(got) == limbs.unpack(want)
    r = Fr(0xABCDEF)
    assert torch.equal(fr_kernels.fold(tables, r),
                       fr_kernels.fold_plain(tables, r))
    assert limbs.unpack(fr_kernels.product_round_evals(tables)) == (
        limbs.unpack(fr_kernels.product_round_evals_plain(tables)))
