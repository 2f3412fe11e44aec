"""The flagship round step on a torch device: the port of
``__graft_entry__.entry``.

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
