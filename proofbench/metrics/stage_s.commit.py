"""Mean seconds a prove in the PhaseTimer stage ``commit``."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["commit"])
