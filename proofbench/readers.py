"""What the metric readers under ``metrics/`` share."""

from __future__ import annotations

from typing import Optional, Sequence


def stage_mean(run, names: Sequence[str], need: str = None) -> Optional[float]:
    """Mean seconds a prove of the sum of ``names``' PhaseTimer stages; a
    stage a prove lacks counts 0.  None where no prove had ``need`` (the
    first name if not given)."""
    need = names[0] if need is None else need
    if not run.stages or not any(need in st for st in run.stages):
        return None
    return sum(sum(st.get(n, 0.0) for n in names)
               for st in run.stages) / len(run.stages)


def roofline_pct(least_s: Optional[float], device_s: float) -> Optional[float]:
    if least_s is None or device_s <= 0:
        return None
    return 100.0 * least_s / device_s
