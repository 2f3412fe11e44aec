"""Mean seconds a prove in the dense cube's build: the fenced PhaseTimer
stage ``cube_build`` (TNSH_BITS_DENSE), which holds the table writes' host
and card time, the columns' uploads and the oracle made over the
stack."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["cube_build"])
