"""TwistBits: read-write memory checking over a memory trace."""

from __future__ import annotations

from ..reference import twist_bits as reference
from ..reference.columns import TwistColumns

judge = reference.judge


def program_input(inp):
    from tnsh_torch.protocols.twist_bits import Fr, MemoryTrace

    tr = MemoryTrace(1 << inp.log_k)
    for w, a, v in zip(inp.is_write, inp.addr, inp.value):
        if w:
            tr.write(a, Fr(v))
        else:
            tr.read(a)
    return tr


def prove(trace, pp, device, timer):
    from tnsh_torch.protocols.twist_bits import TwistBits

    return TwistBits.prove(trace, pp, device, timer)


def to_bytes(proof) -> bytes:
    from tnsh_torch.protocols.twist_bits import TwistBits

    return TwistBits.to_bytes(proof)


def columns(inp):
    return TwistColumns(inp.log_k, inp.is_write, inp.addr, inp.value)
