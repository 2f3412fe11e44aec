"""Mean seconds a prove in the native k phase: the PhaseTimer stages
``oracle_a_build`` (the engine's k-phase state) and ``k_rounds``."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["oracle_a_build", "k_rounds"])
