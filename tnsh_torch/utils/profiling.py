"""Phase timing with honest device fencing and a profiler trace: the
port of ``tnsh.utils.profiling``'s ``PhaseTimer`` and ``trace``, and the
port's one span recorder.

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

Every phase entry, and every child span (``span``), is kept as a ``Span``
in the timer's ``spans``, and while a profiler records its body runs under
``torch.profiler.record_function``, so a profiled run's trace holds each
span as a ``user_annotation`` event on the trace's own clock.  A child
span never fences: it times the host's part of a phase (planning,
queueing, waiting on an event, marshalling) without changing when the
card is waited for.  ``count`` adds to a work counter at the site of the
work (``msm_digits``: the non-zero signed digits the scheduled Pippenger
inserts).

``trace(log_dir)`` runs its body under ``torch.profiler`` (CPU and CUDA
activity) and writes a Chrome trace into ``log_dir``, in place of the JAX
package's ``jax.profiler`` trace.  A profiler that fails raises: unlike
the JAX package's, it is not swallowed.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import gc
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch


@functools.lru_cache(maxsize=None)
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
    named["msm_digits"] = msm_sched.msm_digits
    named["msm_rank"] = msm_sched.msm_rank
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
    """Zero the launch counts, the per-shape counts and ``counter_totals``."""
    from ..field import fr_kernels

    for fn in _kernel_wrappers().values():
        fn.launches = 0
    fr_kernels.reset_launch_counts()
    _counter_totals.clear()


#: the timer whose span is innermost open in this context
_current: contextvars.ContextVar = contextvars.ContextVar(
    "tnsh_torch_timer", default=None)
#: every ``count`` since the last ``reset_launch_counts``, by counter
_counter_totals: Dict[str, int] = {}


def counter_totals() -> Dict[str, int]:
    """Each work counter's total since the last reset, over all timers
    (and work done with no timer open)."""
    return dict(_counter_totals)


def count(name: str, n: int) -> None:
    """Add ``n`` to the work counter ``name``: to its process total and to
    the ``counters`` of the timer whose span is innermost open."""
    _counter_totals[name] = _counter_totals.get(name, 0) + n
    timer = _current.get()
    if timer is not None:
        timer.counters[name] = timer.counters.get(name, 0) + n


def _annotation(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else nothing: an untraced prove never enters the profiler's
    machinery."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def span(name: str):
    """A child span of the innermost open span of this context's timer
    (``PhaseTimer.span``); with no timer open, only the profiler's
    annotation."""
    timer = _current.get()
    if timer is None:
        return _annotation(name)
    return timer.span(name)


@dataclass
class Span:
    """One phase entry or child span of a ``PhaseTimer``.  ``name`` is the
    key its seconds add to in ``phases`` (a child span's is its enclosing
    phase's name, ``/``, its own); ``parent`` the index in ``spans`` of the
    span open around it (None at the top: the timer, one prove, is the
    root).  ``launches`` counts the port's kernel launches inside it.  A
    phase (``fenced``) also keeps ``cpu_s``, the process's CPU seconds over
    it (every thread: the engine's OpenMP workers count; a child span
    leaves it None, since one read of that clock sums every thread's time,
    tens of microseconds on a busy host), and reads, as it closes,
    ``torch.cuda.memory_allocated`` and ``max_memory_allocated`` (read,
    never reset; None before CUDA is in use)."""

    name: str
    parent: Optional[int]
    fenced: bool
    start: float = 0.0
    end: float = 0.0
    cpu_s: Optional[float] = None
    launches: Dict[str, int] = field(default_factory=dict)
    allocated: Optional[int] = None
    max_allocated: Optional[int] = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class PhaseTimer:
    """Accumulates wall-clock, entries and kernel launches per named
    phase and child span, from the ``spans`` it keeps; ``phase_report()``
    is the JAX package's summary.  Each of ``listeners`` is called as
    ``listener(name, seconds)`` when a phase closes, with the seconds of
    that entry.  ``counters`` holds the work counted (``count``) while one
    of its spans was innermost open."""

    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    launches: Dict[str, Dict[str, int]] = field(default_factory=dict)
    listeners: List[Callable[[str, float], None]] = field(
        default_factory=list)
    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    #: indices in ``spans`` of the spans open now, outermost first
    _open: List[int] = field(default_factory=list, repr=False)

    @staticmethod
    def fence(*device_values) -> None:
        """Wait for every queued kernel and copy of the current CUDA
        device; nothing to wait for before CUDA is in use.  The JAX
        package's timer takes the values to wait for; a synchronize of the
        card covers every tensor, so ``device_values`` are accepted and
        need no more."""
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def phase(self, name: str):
        """A phase: fenced as it opens and as it closes, and told to the
        ``listeners``."""
        return self._record(name, fenced=True)

    def span(self, name: str):
        """A child span of the innermost open span, timed under
        ``<innermost open phase>/<name>``: no fence, no CUDA event, no
        listener."""
        phase = next((self.spans[i].name for i in reversed(self._open)
                      if self.spans[i].fenced), None)
        return self._record(name if phase is None else f"{phase}/{name}",
                            fenced=False)

    @contextlib.contextmanager
    def _record(self, name: str, fenced: bool):
        # the clocks run from after the opening fence to after the span's
        # own bookkeeping, so that a span's cost is its own and not its
        # parent's
        if fenced:
            self.fence()
        rec = Span(name, self._open[-1] if self._open else None, fenced)
        if fenced:
            rec.cpu_s = -time.process_time()
        rec.start = time.perf_counter()
        self.spans.append(rec)
        self._open.append(len(self.spans) - 1)
        token = _current.set(self)
        before = launch_counts()
        try:
            with _annotation(name):
                try:
                    yield self
                finally:
                    if fenced:
                        self.fence()
        finally:
            after = launch_counts()
            _current.reset(token)
            self._open.pop()
            rec.end = time.perf_counter()
            if fenced:
                rec.cpu_s += time.process_time()
            rec.launches = {k: n - before[k] for k, n in after.items()}
            if fenced and torch.cuda.is_initialized():
                # one read of the allocator's counters: memory_allocated()
                # and max_memory_allocated() each flatten every statistic
                held = torch.cuda.memory_stats_as_nested_dict()[
                    "allocated_bytes"]["all"]
                rec.allocated = held["current"]
                rec.max_allocated = held["peak"]
            self._close(rec)

    def _close(self, rec: Span) -> None:
        name, elapsed = rec.name, rec.seconds
        self.phases[name] = self.phases.get(name, 0.0) + elapsed
        self.counts[name] = self.counts.get(name, 0) + 1
        seen = self.launches.setdefault(name, {})
        for kernel, n in rec.launches.items():
            seen[kernel] = seen.get(kernel, 0) + n
        if rec.fenced:
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
