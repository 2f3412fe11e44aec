"""The traced window's device timeline, read from torch.profiler's Chrome
trace: the device's busy and idle time, kernel time by name, and the
longest idle gaps named by the stage the host was in.

Each prove runs under a ``proofbench.prove.<i>`` annotation, and the
harness keeps the host clock's start of each prove and of each of its
``PhaseTimer`` stages; the annotation's timestamp maps that clock onto the
trace's."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Tuple

#: the Chrome trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


@dataclass
class Timeline:
    """Times in microseconds on the trace's clock."""

    start: float
    end: float
    proves: int
    #: (name, start, end) of every device operation in the window
    device: List[Tuple[str, float, float]]
    #: (name, start, end) of every prove stage, on the trace's clock
    stages: List[Tuple[str, float, float]]

    @classmethod
    def load(cls, path: str, marks) -> "Timeline":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        notes = {e["name"]: e for e in events
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e.get("name", "").startswith("proofbench.prove.")}
        stages, starts, ends = [], [], []
        for i, h_start, h_end, spans in marks:
            note = notes.get(f"proofbench.prove.{i}")
            if note is None:
                continue
            shift = note["ts"] - h_start * 1e6
            starts.append(note["ts"])
            ends.append(note["ts"] + note["dur"])
            stages += [(n, a * 1e6 + shift, b * 1e6 + shift)
                       for n, a, b in spans]
        if not starts:
            raise RuntimeError("the trace holds no prove annotation")
        lo, hi = min(starts), max(ends)
        device = [(e.get("name") or e["cat"], e["ts"], e["ts"] + e["dur"])
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                  and e["ts"] < hi and e["ts"] + e["dur"] > lo]
        return cls(lo, hi, len(starts), device, stages)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def _busy(self) -> List[Tuple[float, float]]:
        return _union([(max(a, self.start), min(b, self.end))
                       for _, a, b in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) / 1e6

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the operations whose name holds any of
        ``names``."""
        return sum(b - a for n, a, b in self.device
                   if any(k in n for k in names)) / 1e6

    def by_name(self) -> Dict[str, float]:
        """Device seconds by operation, named without its arguments."""
        out: Dict[str, float] = {}
        for n, a, b in self.device:
            key = n.replace("(anonymous namespace)::", "").split("(")[0]
            key = key.strip() or n
            out[key] = out.get(key, 0.0) + (b - a) / 1e6
        return out

    def stage_at(self, t: float) -> str:
        """The innermost stage open at ``t``, or what lies between
        proves."""
        best = None
        for n, a, b in self.stages:
            if a <= t <= b and (best is None or b - a < best[2] - best[1]):
                best = (n, a, b)
        return best[0] if best else "between stages"

    def gaps(self) -> List[Tuple[float, float]]:
        out, at = [], self.start
        for a, b in self._busy():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.end > at:
            out.append((at, self.end))
        return out

    def breakdown(self) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.stage_at((a + b) / 2), (b - a) / 1e6]
                              for a, b in gaps]}
