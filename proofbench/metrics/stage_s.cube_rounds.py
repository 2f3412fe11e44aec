"""Mean seconds a prove in phase A's rounds over the dense cube: the
fenced PhaseTimer stages ``k_rounds`` and ``j_rounds`` of proves that
built a cube (``cube_build``), every round a round-evaluation launch and
every bind a fold launch."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["k_rounds", "j_rounds"], need="cube_build")
