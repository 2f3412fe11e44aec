"""The fold kernel's share of its roofline over the traced window: the
least time of all its launches (their shapes counted by the program's
launch counter, their work by ``proofbench.roofline``) over their device
time in the trace."""

from proofbench import roofline
from proofbench.readers import roofline_pct


def read(run):
    shapes = run.launch_shapes.get("fold")
    if run.timeline is None or not shapes or not run.clock_hz:
        return None
    return roofline_pct(roofline.fold_least_s(shapes, run.clock_hz),
                        run.timeline.kernel_s("fr_fold_kernel"))
