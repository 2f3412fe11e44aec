"""The traced window's spans, read from torch.profiler's Chrome trace
itself.  The program's ``PhaseTimer`` runs each phase and child span under
``torch.profiler.record_function``, so a prove's spans are the
``user_annotation`` events inside its ``proofbench.prove.<i>`` annotation,
on the trace's own clock: no host-clock marks and no shift.

Beside what ``trace.Timeline`` gives (every metric reader reads either):

  * idle gaps split at span boundaries, each piece named by the innermost
    span open over it (``prove`` between a prove's stages, ``between
    proves`` outside them), so no piece is longer than its span;
  * each device operation given to the span open where the host launched
    it, matched by the trace's ``correlation`` id from the kernel, copy or
    memset back to its runtime call; what has no launch inside a prove is
    the remainder.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .trace import DEVICE_CATS, Timeline as StageTimeline

PROVE = "proofbench.prove."
#: the Chrome trace categories of a launch on the host
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _innermost(spans: List[Tuple[str, float, float]]
               ) -> Tuple[List[float], List[Optional[str]]]:
    """The innermost span open at each time, as steps: from ``times[k]``
    on, ``names[k]`` (None: no span).  ``spans`` nest."""
    times: List[float] = []
    names: List[Optional[str]] = []
    stack: List[Tuple[str, float, float]] = []

    def close_to(t: float) -> None:
        while stack and stack[-1][2] <= t:
            end = stack.pop()[2]
            times.append(end)
            names.append(stack[-1][0] if stack else None)

    for span in sorted(spans, key=lambda s: (s[1], -s[2])):
        close_to(span[1])
        stack.append(span)
        times.append(span[1])
        names.append(span[0])
    close_to(float("inf"))
    return times, names


@dataclass
class Timeline(StageTimeline):
    """``stages`` holds every span inside a prove; ``roots`` each prove's
    (start, end); ``launched`` the host timestamp of each device
    operation's launch (None where the trace has none)."""

    roots: List[Tuple[float, float]] = field(default_factory=list)
    launched: List[Optional[float]] = field(default_factory=list)

    @classmethod
    def load(cls, path: str) -> "Timeline":
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        notes = [e for e in events if e.get("cat") == "user_annotation"]
        proves = sorted((e["ts"], e["ts"] + e["dur"], e.get("tid"))
                        for e in notes if e["name"].startswith(PROVE))
        if not proves:
            raise RuntimeError("the trace holds no prove annotation")
        starts = [a for a, _, _ in proves]
        spans = []
        for e in notes:
            a, b = e["ts"], e["ts"] + e["dur"]
            k = bisect.bisect_right(starts, a) - 1
            if (not e["name"].startswith(PROVE) and k >= 0
                    and b <= proves[k][1] and e.get("tid") == proves[k][2]):
                spans.append((e["name"], a, b))
        launch_at = {e["args"]["correlation"]: e["ts"] for e in events
                     if e.get("cat") in LAUNCH_CATS
                     and "correlation" in e.get("args", {})}
        lo, hi = starts[0], max(b for _, b, _ in proves)
        device, launched = [], []
        for e in events:
            if (e.get("cat") in DEVICE_CATS and e["ts"] < hi
                    and e["ts"] + e["dur"] > lo):
                device.append((e.get("name") or e["cat"], e["ts"],
                               e["ts"] + e["dur"]))
                launched.append(launch_at.get(
                    e.get("args", {}).get("correlation")))
        return cls(lo, hi, len(proves), device, spans,
                   roots=[(a, b) for a, b, _ in proves], launched=launched)

    def _steps(self):
        return _innermost([("prove", a, b) for a, b in self.roots]
                          + self.stages)

    def idle_pieces(self) -> List[Tuple[str, float, float]]:
        """Each idle gap cut at every span boundary inside it: (the
        innermost span open over the piece, start, end)."""
        times, names = self._steps()
        out = []
        for a, b in self.gaps():
            cuts = [a] + [t for t in times[bisect.bisect_right(times, a):
                                           bisect.bisect_left(times, b)]
                          if t > a] + [b]
            for p, q in zip(cuts, cuts[1:]):
                if q > p:
                    k = bisect.bisect_right(times, p) - 1
                    out.append((names[k] if k >= 0 else None, p, q))
        return [(n or "between proves", a, b) for n, a, b in out]

    def device_by_span(self) -> Tuple[Dict[str, float], float]:
        """Device seconds of the window's operations by the span open at
        their launch, and the seconds of those launched outside every
        prove or with no launch in the trace."""
        times, names = self._steps()
        out: Dict[str, float] = {}
        rest = 0.0
        for (_, a, b), t in zip(self.device, self.launched):
            k = -1 if t is None else bisect.bisect_right(times, t) - 1
            name = names[k] if k >= 0 else None
            if name is None:
                rest += (b - a) / 1e6
            else:
                out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return out, rest

    def breakdown(self) -> dict:
        def top(d: Dict[str, float]):
            return sorted(d.items(), key=lambda kv: -kv[1])[:10]

        pieces = self.idle_pieces()
        idle: Dict[str, float] = {}
        for n, a, b in pieces:
            idle[n] = idle.get(n, 0.0) + (b - a) / 1e6
        by_span, rest = self.device_by_span()
        longest = sorted(pieces, key=lambda p: p[1] - p[2])[:10]
        return {"device_ops": [[n, s] for n, s in top(self.by_name())],
                "idle_gaps": [[n, (b - a) / 1e6] for n, a, b in longest],
                "idle_by_span": [[n, s] for n, s in top(idle)],
                "device_by_span": [[n, s] for n, s in top(by_span)],
                "device_unattributed_s": rest,
                "device_op_s": sum(b - a for _, a, b in self.device) / 1e6}
