"""Mean seconds a prove in the MSMs' host finish: the windows combined
(``combine``) and the MSMs under 1024 points run on the host
(``host_msm``), in ``commit`` and ``open``."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["commit/combine", "commit/host_msm",
                            "open/combine", "open/host_msm"],
                      need="commit/launch")
