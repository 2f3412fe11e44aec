"""Mean seconds a prove in the PhaseTimer stage ``j_build``."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["j_build"])
