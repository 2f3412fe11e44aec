"""Mean seconds a prove in the PhaseTimer stage ``open``."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["open"])
