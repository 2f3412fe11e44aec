"""The round-evaluation kernels' share of their roofline in ShoutSound's
j phase: the least time of the window's ``sum_of_products_round_evals``
launches (shapes from the program's launch counter) over the device time
of ``fr_round_evals_kernel`` and ``fr_sum_partials_kernel``.

The work of a launch is that of ShoutSound's j program, frozen here as
``proofbench.roofline.ROUND_PROGRAMS`` freezes the bit-column provers':
after the k rounds the sparse cube oracle's 6 terms (READ's ra T~ and
rv parts, BOOL's two, ONE-HOT's two) read F = 5 stacked tables over the
cycles (eq of rho_read, ra folded at r_k, which BOOL's first term reads
twice, rv, eq of rho_bool's cycle half, eq of rho_onehot; the table's
T~ and rho_bool's slot half are scalars in their terms), evaluated
at 4 points, 8 Montgomery products a lane pair and point once shared
factors are taken out (12 multiplied out).  A launch of another F
(another program) makes the reading None."""

from proofbench import roofline
from proofbench.readers import roofline_pct

#: stacked tables F -> (points a round, products a lane pair and point)
PROGRAM = {5: (4, 8)}


def read(run):
    shapes = run.launch_shapes.get("sum_of_products_round_evals")
    if run.timeline is None or not shapes or not run.clock_hz:
        return None
    if any(s[0] not in PROGRAM for s in shapes):
        return None
    least = sum(c * roofline.least_s(*roofline.round_evals_work(
        s[0], s[2], *PROGRAM[s[0]]), run.clock_hz)
        for s, c in shapes.items())
    return roofline_pct(least, run.timeline.kernel_s(
        "fr_round_evals_kernel", "fr_sum_partials_kernel"))
