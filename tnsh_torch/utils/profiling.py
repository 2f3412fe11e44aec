"""Phase timing with honest device fencing: the port of
``tnsh.utils.profiling.PhaseTimer``.

PyTorch returns from a CUDA call before the card finishes, so a host
clock around device work measures the enqueue.  ``fence()`` waits for
the card (``torch.cuda.synchronize``) once CUDA is in use, and every phase
fences when it opens and when it closes, so the work a phase queues is
charged to that phase.  Each phase also records how many times each CUDA
kernel of the port launched inside it (``launch_counts``), so a timed run
shows which stages went through the kernels.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict

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
    """Accumulates wall-clock and kernel launches per named phase."""

    phases: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, Dict[str, int]] = field(default_factory=dict)

    @staticmethod
    def fence() -> None:
        """Wait for every queued kernel and copy of the current CUDA
        device; nothing to wait for before CUDA is in use."""
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
            seen = self.launches.setdefault(name, {})
            for kernel, n in launch_counts().items():
                seen[kernel] = seen.get(kernel, 0) + n - before[kernel]
