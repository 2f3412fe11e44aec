"""Tiny cells for the CPU tests: K = 2^3, T = 2^6, two inputs."""

import os

from proofbench.harness import Cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

ENV = {"TNSH_NO_NATIVE": None, "TNSH_GC_PAUSE": None,
       "TNSH_BITS_DENSE": None, "TNSH_PROFILE": None}
MEMORY = {"kind": "memory", "log_t": 6, "inputs": 2, "write_every": 3,
          "value_step": 42}
LOOKUP = {"kind": "lookup", "log_t": 6, "inputs": 2, "entry_step": 3,
          "entry_offset": 1, "lookups_short": 1}


def cell(prover: str = "twist_bits", **workload) -> Cell:
    config = {"name": f"{prover}.k3", "prover": prover, "log_k": 3,
              "env": ENV}
    traffic = MEMORY if prover == "twist_bits" else LOOKUP
    return Cell(f"{prover}.tiny", dict({"chips": 1}, **workload), config,
                traffic)
