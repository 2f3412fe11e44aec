"""Framework configuration: the port of ``tnsh.core.config``.

The reference's config surface is cargo features, ``setup_params(log_size)``
with derived limits and hand-rolled CLI flags.  One dataclass holds the
equivalent knobs.  The JAX package's ``use_jax`` (env ``TNSH_NO_JAX``)
becomes ``device`` (env ``TNSH_DEVICE``): the torch device the provers'
kernels run on.

The bench CLI (``tnsh_torch.bench.cli``) reads ``from_env()``: ``device``
is its ``--device`` default and ``profile_dir`` the directory of its
``torch.profiler`` trace.  The library's entry points take their device
as an argument and read no field.  ``log_size``, ``max_operations``,
``use_native`` and ``mesh_shape`` keep the JAX package's fields and
values, which nothing in either package reads: the native engine's
switch is ``TNSH_NO_NATIVE`` itself (``tnsh_torch._native``), and a mesh
takes its size from ``torch.distributed``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["TnshConfig", "from_env"]


@dataclass
class TnshConfig:
    """Global knobs (mirrors the reference's feature/flag surface)."""

    #: log2 of the memory/table size (reference setup_params arg).
    log_size: int = 4
    #: Override for max operations; None derives 2^(log_size+2) like the
    #: reference (utils.rs:80).
    max_operations: Optional[int] = None
    #: Use the C++ native host engine.  Env: TNSH_NO_NATIVE=1 disables.
    use_native: bool = True
    #: The torch device of the provers' kernels and MSMs: "cuda" (or
    #: "cuda:N") for the hand-written kernels, "cpu" for their plain
    #: versions.  Env: TNSH_DEVICE.
    device: str = "cuda"
    #: Mesh axis sizes for multi-rank runs, e.g. (8,) for 1-D sharding.
    mesh_shape: Tuple[int, ...] = (1,)
    #: Optional ``torch.profiler`` trace directory
    #: (``tnsh_torch.utils.profiling.trace``).
    profile_dir: Optional[str] = None

    def __post_init__(self) -> None:
        if not (2 <= self.log_size <= 30):
            raise ValueError("log_size must be within 2..=30")
        if os.environ.get("TNSH_NO_NATIVE"):
            self.use_native = False

    @property
    def derived_max_operations(self) -> int:
        if self.max_operations is not None:
            return self.max_operations
        return 1 << (self.log_size + 2)


def from_env() -> TnshConfig:
    """Build a config from TNSH_* environment variables."""
    cfg = TnshConfig(
        log_size=int(os.environ.get("TNSH_LOG_SIZE", "4")),
        device=os.environ.get("TNSH_DEVICE", "cuda"),
        profile_dir=os.environ.get("TNSH_PROFILE_DIR") or None,
    )
    mesh = os.environ.get("TNSH_MESH")
    if mesh:
        cfg.mesh_shape = tuple(int(x) for x in mesh.split(",") if x)
    return cfg
