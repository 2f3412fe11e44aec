"""Mean seconds a prove in the child span ``j_build/upload``: the bit
columns' numpy conversion and copies, and the packing and upload of the
j-phase tables.  ``j_build`` less it is the Python walk."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["j_build/upload"])
