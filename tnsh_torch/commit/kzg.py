"""KZG commitment values and the MSM behind every commitment.

Counterpart of ``tnsh/commit/kzg.py``, holding what the ported protocols
call: ``KZGCommitmentValue`` (a G1 point with the transcript hash of its
affine x coordinate), the host ``msm`` (native Pippenger, with the
pure-Python bucket method as the golden path), and the router that sends
an MSM over a native-resident SRS to the device.  The univariate
``KZGCommitment`` scheme and the Lagrange SRS are not ported: no ported
protocol commits with them.

The router takes the place of the JAX package's hybrid host and device
split.  There the device joined in only behind environment switches, a
warm-up gate and measured rates; here the caller names the device, and
every function that computes an MSM takes it as a required argument:

  * an MSM of ``DEVICE_MSM_MIN`` points or more runs on ``device`` through
    ``tnsh_torch.commit.msm_sched.ScheduledMsmContext`` (for a native SRS
    one context per handle and device, built once and kept);
  * a smaller one runs on the native host MSM.

Both routes produce the identical group element.  ``route_counts`` says
how many MSMs went each way.  ``host_msm`` is the host MSM over explicit
points by name: the reference the device route is held against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import torch

from ..core.params import NativeSRS
from ..core.serialize import g1_from_bytes, g1_to_bytes
from ..field.fr import Fr
from ..field.g1 import G1

#: An MSM over a native-resident SRS goes to the device from this many
#: points up.  It is the size at which ``MultilinearKZG.commit_many``
#: starts batching columns; at T = 2^16 it puts all 24 column commitments
#: of a TwistBits proof and the six largest quotient MSMs of each opening
#: on the device and leaves the short tail of each opening on the host.
DEVICE_MSM_MIN = 1024

_ROUTES = ("device", "host")
_route_counts: Dict[str, int] = dict.fromkeys(_ROUTES, 0)
#: (srs_id, device) -> ScheduledMsmContext
_device_contexts: dict = {}


def route_counts() -> Dict[str, int]:
    """MSMs through the router since the last reset, by route: ``device``
    and ``host`` (fewer than ``DEVICE_MSM_MIN`` points)."""
    return dict(_route_counts)


def reset_route_counts() -> None:
    for k in _ROUTES:
        _route_counts[k] = 0


def device_srs_context(srs_id: int, device):
    """The device-resident copy of a native SRS, built on first use."""
    from .msm_sched import ScheduledMsmContext

    device = torch.device(device)
    key = (srs_id, device)
    ctx = _device_contexts.get(key)
    if ctx is None:
        ctx = ScheduledMsmContext.from_native_srs(srs_id, device=device)
        _device_contexts[key] = ctx
    return ctx


def device_contexts() -> list:
    """Every device SRS context built so far (for hazard counts and the
    stage split)."""
    return list(_device_contexts.values())


def _num_scalars(scalars) -> int:
    if isinstance(scalars, (bytes, bytearray)):
        return len(scalars) // 32
    return len(scalars)


def srs_msm_async(srs_id: int, scalars, device) -> Callable[[], G1]:
    """Dispatch one MSM over a native SRS and return its finisher.

    The device work is launched before this returns and waited for in the
    finisher, so a caller with several MSMs dispatches them all before it
    finishes any.  A host MSM runs in the finisher."""
    from .. import _native

    if _num_scalars(scalars) < DEVICE_MSM_MIN:
        _route_counts["host"] += 1
        return lambda: _native.srs_msm(srs_id, scalars)
    _route_counts["device"] += 1
    return device_srs_context(srs_id, device).msm_async(scalars)


def srs_msm_many(srs_id: int, scalars_list, device) -> List[G1]:
    """A batch of MSMs over one native SRS: every MSM is dispatched before
    any is waited for."""
    fins = [srs_msm_async(srs_id, s, device) for s in scalars_list]
    return [fin() for fin in fins]


def msm(points: Sequence[G1], scalars: Sequence[Fr], device) -> G1:
    """Σ s_i · P_i through the router of the module docstring, over a
    native-resident SRS (``NativeSRS``) or explicit points (whose bases
    are packed and uploaded for this one call)."""
    if isinstance(points, NativeSRS):
        return srs_msm_async(points.srs_id, scalars, device)()
    n = min(len(points), _num_scalars(scalars))
    if n < DEVICE_MSM_MIN:
        _route_counts["host"] += 1
        return host_msm(points, scalars)
    from .msm_sched import ScheduledMsmContext

    _route_counts["device"] += 1
    if isinstance(scalars, (bytes, bytearray)):
        scalars = scalars[:32 * n]
    else:
        scalars = list(scalars[:n])
    return ScheduledMsmContext(points[:n], device=device).msm(scalars)


def host_msm(points: Sequence[G1], scalars: Sequence[Fr],
             native: bool = True) -> G1:
    """Σ s_i · P_i over explicit points on the host: the native Pippenger,
    or with ``native=False`` the pure-Python bucket method (the golden
    path).  Both give the same element."""
    if isinstance(scalars, (bytes, bytearray)):
        scalars = [
            Fr(int.from_bytes(scalars[32 * i:32 * i + 32], "little"))
            for i in range(len(scalars) // 32)
        ]
    n = min(len(points), len(scalars))
    if n >= 4 and native:
        from .. import _native

        return _native.msm(points[:n], scalars[:n])
    pairs = [(points[i], int(scalars[i])) for i in range(n) if int(scalars[i])]
    if not pairs:
        return G1.zero()
    if len(pairs) <= 4:
        acc = G1.zero()
        for p, s in pairs:
            acc = acc.add(p.scalar_mul(s))
        return acc
    c = max(2, len(pairs).bit_length() - 1)
    c = min(c, 13)
    num_windows = (254 + c - 1) // c
    mask = (1 << c) - 1
    result = G1.zero()
    for w in range(num_windows - 1, -1, -1):
        if not result.is_zero():
            for _ in range(c):
                result = result.double()
        buckets: List[G1] = [G1.zero()] * (mask + 1)
        shift = w * c
        for p, s in pairs:
            d = (s >> shift) & mask
            if d:
                buckets[d] = buckets[d].add(p)
        acc = G1.zero()
        running = G1.zero()
        for d in range(mask, 0, -1):
            running = running.add(buckets[d])
            acc = acc.add(running)
        result = result.add(acc)
    return result


@dataclass
class KZGCommitmentValue:
    """A KZG commitment: a point in G1."""

    commitment: G1

    def hash(self) -> Fr:
        """Affine x-coordinate LE bytes, reduced into Fr."""
        x, _ = self.commitment.to_affine()
        return Fr.from_le_bytes_mod_order(x.to_bytes(32, "little"))

    def serialize_compressed(self) -> bytes:
        return g1_to_bytes(self.commitment, compress=True)

    @classmethod
    def deserialize_compressed(cls, data: bytes) -> "KZGCommitmentValue":
        return cls(g1_from_bytes(data, compressed=True))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, KZGCommitmentValue):
            return NotImplemented
        return self.commitment == other.commitment
