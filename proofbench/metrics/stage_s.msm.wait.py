"""Mean seconds a prove the host is blocked on the card's MSMs: the
child spans ``wait`` (the MSM's event) of ``commit`` and ``open``."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["commit/wait", "open/wait"], need="commit/launch")
