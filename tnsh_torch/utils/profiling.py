"""Phase timing with honest device fencing and a profiler trace: the
port of ``tnsh.utils.profiling``'s ``PhaseTimer`` and ``trace``.

PyTorch returns from a CUDA call before the card finishes, so a host
clock around device work measures the enqueue.  ``fence()`` waits for
the card (``torch.cuda.synchronize``) once CUDA is in use, and every phase
fences when it opens and when it closes, so the work a phase queues is
charged to that phase.  Each phase also records how many times each CUDA
kernel of the port launched inside it (``launch_counts``), so a timed run
shows which stages went through the kernels.

``trace(log_dir)`` runs its body under ``torch.profiler`` (CPU and CUDA
activity) and writes a Chrome trace into ``log_dir``, in place of the JAX
package's ``jax.profiler`` trace.  A profiler that fails raises: unlike
the JAX package's, it is not swallowed.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


def _kernel_wrappers() -> Dict[str, object]:
    """Every kernel wrapper of the port by the name its count goes under.
    Each adds one to its ``launches`` where it launches its kernel."""
    from ..commit import msm_group, msm_sched
    from ..field import fq_kernels, fr_kernels

    named = {fn.__name__: fn for fn in fr_kernels.KERNELS}
    named["fq_mont_mul_chain"] = fq_kernels.mont_mul_chain
    named["g1_padd"] = msm_group.padd
    named["msm_insert_steps"] = msm_sched.insert_steps
    named["msm_tail"] = msm_sched.msm_tail
    return named


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


@dataclass
class PhaseTimer:
    """Accumulates wall-clock, entries and kernel launches per named
    phase; ``phase_report()`` is the JAX package's summary."""

    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    launches: Dict[str, Dict[str, int]] = field(default_factory=dict)

    @staticmethod
    def fence(*device_values) -> None:
        """Wait for every queued kernel and copy of the current CUDA
        device; nothing to wait for before CUDA is in use.  The JAX
        package's timer takes the values to wait for; a synchronize of the
        card covers every tensor, so ``device_values`` are accepted and
        need no more."""
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def phase(self, name: str):
        self.fence()
        before = launch_counts()
        start = time.perf_counter()
        try:
            yield self
        finally:
            self.fence()
            elapsed = time.perf_counter() - start
            self.phases[name] = self.phases.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1
            seen = self.launches.setdefault(name, {})
            for kernel, n in launch_counts().items():
                seen[kernel] = seen.get(kernel, 0) + n - before[kernel]

    def phase_report(self) -> Dict[str, Dict[str, float]]:
        """Per phase its total seconds, entries and mean milliseconds an
        entry, under the JAX package's keys."""
        return {
            name: {
                "total_s": total,
                "count": self.counts[name],
                "mean_ms": total / self.counts[name] * 1e3,
            }
            for name, total in self.phases.items()
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the body with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write ``trace.json``, a Chrome
    trace, into ``log_dir``; ``None`` profiles nothing."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        PhaseTimer.fence()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
