"""Mean seconds a prove in the scheduled Pippenger's plans on the host
(signed digits and ``MsmPlan``): the child spans ``plan`` of ``commit``
and ``open``.  None where the program has no ``launch`` span (its MSM
stages split otherwise)."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["commit/plan", "open/plan"], need="commit/launch")
