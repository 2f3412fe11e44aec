"""The work counts against PERF.md's kernel table: the fold at 49 x 2^20
is 0.736 ms by bytes, the round evaluations at 49 x 2^20 with 72 products
8.594 ms by operations at the 1980 MHz clock read in PR 13."""

import pytest

from proofbench import roofline

CLOCK = 1.98e9


def test_fold_49x2p20():
    b, m = roofline.fold_work(49, 1 << 20)
    assert roofline.least_s(b, m, CLOCK) * 1e3 == pytest.approx(0.736,
                                                                abs=5e-4)
    assert b / roofline.HBM_BYTES_PER_S > m * roofline.IMAD_PER_MUL / (
        roofline.IMAD_PER_CLOCK * CLOCK)


def test_round_evals_49x2p20():
    npts, products = roofline.ROUND_PROGRAMS[("twist_bits", 10)][49]
    assert (npts, products) == (14, 72)
    b, m = roofline.round_evals_work(49, 1 << 20, npts, products)
    assert roofline.least_s(b, m, CLOCK) * 1e3 == pytest.approx(8.594,
                                                                abs=5e-4)


def test_unknown_shape_counts_nothing():
    shapes = {(7, 8, 1024): 1}
    assert roofline.round_evals_least_s(shapes, "twist_bits", 10,
                                        CLOCK) is None
