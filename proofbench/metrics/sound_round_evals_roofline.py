"""The round-evaluation kernels' share of their roofline in TwistSound's
j phase: the least time of the window's ``sum_of_products_round_evals``
launches (shapes from the program's launch counter) over the device time
of ``fr_round_evals_kernel`` and ``fr_sum_partials_kernel``.

The work of a launch is that of TwistSound's j program, frozen here as
``proofbench.roofline.ROUND_PROGRAMS`` freezes the bit-column provers':
after the k rounds the sparse cube oracle's 18 terms read F = 16 stacked
tables over the cycles (twelve tables of the cycles, the folded ra, wa
and Inc, Val's prefix form), evaluated at 4 points, 29 Montgomery
products a lane pair and point once shared factors are taken out (41
multiplied out).  A launch of another F (another program) makes the
reading None."""

from proofbench import roofline
from proofbench.readers import roofline_pct

#: stacked tables F -> (points a round, products a lane pair and point)
PROGRAM = {16: (4, 29)}


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
