"""Mean seconds a prove in the sum-check rounds on the card: the
PhaseTimer stages ``j_rounds`` and ``phase_b`` (0 where a prover has no
phase B)."""

from proofbench.readers import stage_mean


def read(run):
    return stage_mean(run, ["j_rounds", "phase_b"])
