"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and the configuration's sizes, and makes the
cell's inputs from the seed, as plain data that both the program's adapter
and the reference read.

Kinds of mix:

  * ``memory``: a memory trace of 2^log_t cycles over K = 2^log_k cells.
    Cycle i writes ``value_step * i`` to a uniform random cell when
    ``i % write_every == 0`` and reads a uniform random cell otherwise
    (the trace of ``bench.py``, written for ``random.seed(5)``).
  * ``lookup``: a public table of K entries ``entry_step * i +
    entry_offset`` and 2^log_t - ``lookups_short`` lookups of uniform
    random slots (the log of ``benches/bits_bench.py``, written for
    ``random.Random(11)``).

All ``inputs`` of a cell come from one ``random.Random(seed)`` stream, one
after another, so every seed gives the same sizes and mix of operations.
"""

from __future__ import annotations

import random
from array import array
from dataclasses import dataclass
from typing import List, Union


@dataclass
class MemoryInput:
    log_k: int
    is_write: bytes
    addr: array
    value: array


@dataclass
class LookupInput:
    log_k: int
    entries: List[int]
    index: array


Input = Union[MemoryInput, LookupInput]


def memory(rng: random.Random, log_k: int, log_t: int, write_every: int,
           value_step: int) -> MemoryInput:
    k, t = 1 << log_k, 1 << log_t
    flags = bytearray(t)
    addr = array("l", bytes(8 * t))
    value = array("q", bytes(8 * t))
    for i in range(t):
        addr[i] = rng.randrange(k)
        if i % write_every == 0:
            flags[i] = 1
            value[i] = value_step * i
    return MemoryInput(log_k, bytes(flags), addr, value)


def lookup(rng: random.Random, log_k: int, log_t: int, entry_step: int,
           entry_offset: int, lookups_short: int) -> LookupInput:
    k = 1 << log_k
    entries = [entry_step * i + entry_offset for i in range(k)]
    index = array("l", (rng.randrange(k)
                        for _ in range((1 << log_t) - lookups_short)))
    return LookupInput(log_k, entries, index)


def make_inputs(traffic: dict, config: dict, seed: int) -> List[Input]:
    """The cell's ``traffic["inputs"]`` inputs, at the configuration's
    ``log_k`` and the mix's ``log_t``."""
    rng = random.Random(seed)
    log_k, log_t = config["log_k"], traffic["log_t"]
    if traffic["kind"] == "memory":
        return [memory(rng, log_k, log_t, traffic["write_every"],
                       traffic["value_step"])
                for _ in range(traffic["inputs"])]
    if traffic["kind"] == "lookup":
        return [lookup(rng, log_k, log_t, traffic["entry_step"],
                       traffic["entry_offset"], traffic["lookups_short"])
                for _ in range(traffic["inputs"])]
    raise ValueError(f"unknown kind of traffic {traffic['kind']!r}")
