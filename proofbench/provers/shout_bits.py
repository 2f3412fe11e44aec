"""ShoutBits: read-only lookups into a public table."""

from __future__ import annotations

from ..reference import shout_bits as reference
from ..reference.columns import ShoutColumns

judge = reference.judge


def program_input(inp):
    from tnsh_torch.protocols.twist_bits import Fr, LookupTable

    tbl = LookupTable([Fr(e) for e in inp.entries])
    for i in inp.index:
        tbl.lookup(i)
    return tbl


def prove(table, pp, device, timer):
    from tnsh_torch.protocols.twist_bits import ShoutBits

    return ShoutBits.prove(table, pp, device, timer)


def to_bytes(proof) -> bytes:
    from tnsh_torch.protocols.twist_bits import ShoutBits

    return ShoutBits.to_bytes(proof)


def columns(inp):
    return ShoutColumns(inp.log_k, inp.entries, inp.index)
