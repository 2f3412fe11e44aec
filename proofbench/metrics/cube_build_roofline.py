"""The dense cube build's share of its byte roofline: the least time
of its writes, the program's counter ``cube_lanes`` (the F x K T lanes
of the stack a prove: 49 x 2^24 for TwistBits at K = 2^10, T = 2^14)
times the bytes of a lane at ``proofbench.roofline.HBM_BYTES_PER_S``, over
the device's busy time inside the traced window's fenced ``cube_build``
stages (every kernel, copy and memset there, overlaps counted once).
The build reads columns of T lanes, tables of K and bit rows, far less
than it writes, so the writes bound it.  None where the program keeps no
such counter, no prove built a cube, or no device work was traced."""

from proofbench import roofline, trace
from proofbench.readers import roofline_pct

#: bytes of one lane of a cube table: eight 32-bit Montgomery limbs
LANE_BYTES = 32


def read(run):
    from tnsh_torch.utils import profiling

    totals = getattr(profiling, "counter_totals", None)
    tl = run.timeline
    if totals is None or tl is None:
        return None
    lanes = totals().get("cube_lanes")
    builds = [(a, b) for n, a, b in tl.stages if n == "cube_build"]
    if not lanes or not builds:
        return None
    busy = trace._union([(max(a, lo), min(b, hi))
                         for _, a, b in tl.device for lo, hi in builds
                         if a < hi and b > lo])
    device_s = sum(b - a for a, b in busy) / 1e6
    return roofline_pct(lanes * LANE_BYTES / roofline.HBM_BYTES_PER_S,
                        device_s)
