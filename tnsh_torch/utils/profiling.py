"""Phase timing with honest device fencing and a profiler trace: the
port of ``tnsh.utils.profiling``'s ``PhaseTimer`` and ``trace``.

PyTorch returns from a CUDA call before the card finishes, so a host
clock around device work measures the enqueue.  ``fence()`` waits for
the card (``torch.cuda.synchronize``) once CUDA is in use, and every phase
fences when it opens and when it closes, so the work a phase queues is
charged to that phase.  Each phase also records how many times each CUDA
kernel of the port launched inside it (``launch_counts``), so a timed run
shows which stages went through the kernels, and tells its ``listeners``
each phase's seconds as it closes (the provers' TNSH_PROFILE lines read
them).  ``GcCollections`` counts the cyclic GC's collections and their
seconds while it is installed.

``trace(log_dir)`` runs its body under ``torch.profiler`` (CPU and CUDA
activity) and writes a Chrome trace into ``log_dir``, in place of the JAX
package's ``jax.profiler`` trace.  A profiler that fails raises: unlike
the JAX package's, it is not swallowed.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

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


def launch_shapes() -> Dict[str, Dict[tuple, int]]:
    """The sum-check kernels' launches since the last reset, by kernel
    and input shape (``fr_kernels.launch_shapes``)."""
    from ..field import fr_kernels

    return fr_kernels.launch_shapes()


def reset_launch_counts() -> None:
    from ..field import fr_kernels

    for fn in _kernel_wrappers().values():
        fn.launches = 0
    fr_kernels.reset_launch_counts()


@dataclass
class PhaseTimer:
    """Accumulates wall-clock, entries and kernel launches per named
    phase; ``phase_report()`` is the JAX package's summary.  Each of
    ``listeners`` is called as ``listener(name, seconds)`` when a phase
    closes, with the seconds of that entry."""

    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    launches: Dict[str, Dict[str, int]] = field(default_factory=dict)
    listeners: List[Callable[[str, float], None]] = field(
        default_factory=list)

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
            for listener in self.listeners:
                listener(name, elapsed)

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


class GcCollections:
    """Collections of the cyclic GC while installed (``with
    GcCollections() as gcs:``): ``count`` and ``seconds`` of the
    generation-2 (full) ones, ``young_count`` and ``young_seconds`` of
    those of generations 0 and 1."""

    def __init__(self):
        self.count = self.young_count = 0
        self.seconds = self.young_seconds = 0.0
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        seconds = time.perf_counter() - self._t0
        if info["generation"] == 2:
            self.count += 1
            self.seconds += seconds
        else:
            self.young_count += 1
            self.young_seconds += seconds

    def __enter__(self) -> "GcCollections":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


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
