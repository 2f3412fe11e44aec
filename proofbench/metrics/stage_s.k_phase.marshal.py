"""Mean seconds a prove in the child span ``oracle_a_build/marshal``:
the k phase's inputs (address columns, flags, eq and value tables)
marshalled for the native engine."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["oracle_a_build/marshal"])
