"""The round-evaluation kernels' share of their roofline over the traced
window: the least time of all ``sum_of_products_round_evals`` launches
(shapes from the program's launch counter, products a lane pair and point
from ``proofbench.roofline.ROUND_PROGRAMS``) over the device time of
``fr_round_evals_kernel`` and ``fr_sum_partials_kernel``."""

from proofbench import roofline
from proofbench.readers import roofline_pct


def read(run):
    shapes = run.launch_shapes.get("sum_of_products_round_evals")
    if run.timeline is None or not shapes or not run.clock_hz:
        return None
    cfg = run.cell.config
    least = roofline.round_evals_least_s(shapes, cfg["prover"],
                                         cfg["log_k"], run.clock_hz)
    return roofline_pct(least, run.timeline.kernel_s(
        "fr_round_evals_kernel", "fr_sum_partials_kernel"))
