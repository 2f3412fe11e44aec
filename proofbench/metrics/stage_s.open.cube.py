"""Mean seconds a prove in the child span ``open/cube``: the sound
tier's j-first opening of the cube tables' gamma-combination
(``mkzg_sparse.open_combined``: the column scalars, the j levels'
differences, the k residue and its levels, and every level's MSM from
its dispatch to its result)."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["open/cube"])
