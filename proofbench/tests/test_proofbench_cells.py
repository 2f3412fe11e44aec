"""The harness is driven by data: a cell added as new files, in a copy of
the folder, runs without an edit to any file that was there; the run loads
no module of jax or of the JAX package; the command exits without a result
where there is no card."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from . import tiny

RUN = """
import json, sys, time
sys.path[0:0] = [{copy!r}]
sys.path.append({root!r})
import torch
torch.set_num_threads(1)
from proofbench import harness
assert harness.BENCH.startswith({copy!r})
out = harness.run_cell(harness.Cell.load("added.t6"), 7, 1.0, False, "cpu",
                       time.perf_counter())
print(json.dumps({{"correct": out["correct"],
                  "forbidden": harness.loaded_forbidden(),
                  "program": "tnsh_torch" in sys.modules}}))
"""


def _digests(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_cell_added_as_files_runs(tmp_path):
    copy = str(tmp_path)
    shutil.copytree(os.path.join(tiny.ROOT, "proofbench"),
                    os.path.join(copy, "proofbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), copy)
    before = _digests(copy)
    bench = os.path.join(copy, "proofbench")
    for kind, name, body in (
            ("configs", "added.k3", dict(
                name="added.k3", prover="shout_bits", log_k=3, env=tiny.ENV)),
            ("traffic", "added_lookup", dict(tiny.LOOKUP, inputs=3)),
            ("workloads", "added.t6", dict(config="added.k3",
                                           traffic="added_lookup",
                                           chips=1))):
        with open(os.path.join(bench, kind, name + ".json"), "w") as f:
            json.dump(body, f)
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(copy=copy, root=tiny.ROOT)],
        capture_output=True, text=True, timeout=600, cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "program": True}
    after = _digests(copy)
    assert {k: after[k] for k in before} == before


def _command(cwd: str):
    return subprocess.run(
        [sys.executable, "proofbench/run.py", "--workload", "twist_bits.t16",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_card_no_result(card_absent):
    out = _command(tiny.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(os.path.join(tiny.ROOT, "proofbench"),
                    os.path.join(str(tmp_path), "proofbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), str(tmp_path))
    out = _command(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
