"""Mean seconds a prove in the PhaseTimer stage ``open/evals``: the
columns' evaluations at the opening points, on the host."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["open/evals"])
