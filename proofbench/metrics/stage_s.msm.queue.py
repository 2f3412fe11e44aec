"""Mean seconds a prove in which the host queues the scheduled
Pippenger's work: the child spans ``upload`` (the plans' copies) and
``launch`` (schedules and kernel launches) of ``commit`` and ``open``."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["commit/upload", "commit/launch", "open/upload",
                            "open/launch"], need="commit/launch")
