"""Mean seconds a prove in the PhaseTimer stage ``open/rlc``: the gamma
combinations of the columns, on the host."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["open/rlc"])
