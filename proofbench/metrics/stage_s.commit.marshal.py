"""Mean seconds a prove in the child span ``commit/marshal``: the
committed columns marshalled to bytes (``_marshal_columns``)."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["commit/marshal"])
