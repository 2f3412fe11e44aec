"""Mean seconds a prove in the child span ``open/quotients``: the
openings' quotient tables (``_native.fr_ml_open``), on the host."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["open/quotients"])
