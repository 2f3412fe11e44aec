"""Mean seconds a prove in the child span ``commit/scalars``: the sound
tier's cube tables' factorized column scalars (``mkzg_sparse``'s
``commit_cube_async``: one scalar a cycle and table, from the native
witness accumulator over each table's CSR view), on the host."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["commit/scalars"])
