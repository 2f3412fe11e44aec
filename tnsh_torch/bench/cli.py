"""Benchmark command line.

Counterpart of ``tnsh/bench/cli.py`` (reference
comprehensive_benchmarks.rs:31-296): modes quick / full / dev / custom /
twist-only / shout-only / sound / bits / help, flags ``--min-log-size`` /
``--max-log-size`` / ``--operations`` with the same validation (min <= max,
logs within 2..=20), and exit code 1 on invalid arguments.

Every prover runs on ``--device``, whose default is the config's
``device`` (``tnsh_torch.core.config.from_env``: ``TNSH_DEVICE``, else
``cuda``).  Without a CUDA device the command exits with code 2 unless
the CPU is asked for: it never carries on on the CPU by itself.  With
``TNSH_PROFILE_DIR`` set, the mode runs under ``torch.profiler`` and
writes its Chrome trace there.

    python -m tnsh_torch.bench.cli [MODE] [OPTIONS]
"""

from __future__ import annotations

import sys
from typing import List, Optional

from ..core.config import from_env

_HELP = """\
Twist and Shout Comprehensive Benchmarks (PyTorch / CUDA port)

USAGE:
    python -m tnsh_torch.bench.cli [MODE] [OPTIONS]

MODES:
    quick       Quick benchmark suite (log sizes 4-6, 64 operations)
    full        Full benchmark suite (log sizes 4-8, 256 operations)
    dev         Development benchmark (log sizes 4-5, 32 operations)
    custom      Custom benchmark with explicit options
    twist-only  Benchmark only the Twist protocol
    shout-only  Benchmark only the Shout protocol
    sound       Verifier-enforced TwistSound/ShoutSound (tnsh extension)
    bits        Trapdoor-free TwistBits/ShoutBits (tnsh extension)
    help        Show this help text

OPTIONS:
    --min-log-size <N>   Minimum log2 size (default 4, range 2..=20)
    --max-log-size <N>   Maximum log2 size (default 6, range 2..=20)
    --operations <N>     Number of operations (default 64)
    --device <D>         Device the provers run on (default $TNSH_DEVICE,
                         else cuda; cpu runs the kernels' plain versions)

ENVIRONMENT:
    TNSH_DEVICE          Default of --device
    TNSH_PROFILE_DIR     Write a torch.profiler Chrome trace of the run here
"""

_MODES = ("quick", "full", "dev", "custom", "twist-only", "shout-only",
          "sound", "bits", "help")


def _flag_value(args: List[str], name: str) -> Optional[str]:
    """The word after ``name``, ``""`` when the flag is absent, ``None``
    (with an error printed) when it has no value."""
    if name not in args:
        return ""
    idx = args.index(name)
    if idx + 1 >= len(args):
        print(f"error: {name} requires a value")
        return None
    return args[idx + 1]


def _parse_flag(args: List[str], name: str, default: int) -> Optional[int]:
    raw = _flag_value(args, name)
    if raw is None:
        return None
    if raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        print(f"error: invalid value for {name}: {raw}")
        return None


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    mode = args[0] if args and not args[0].startswith("--") else "quick"

    min_log = _parse_flag(args, "--min-log-size", 4)
    max_log = _parse_flag(args, "--max-log-size", 6)
    operations = _parse_flag(args, "--operations", 64)
    device = _flag_value(args, "--device")
    if None in (min_log, max_log, operations, device):
        return 1
    try:
        cfg = from_env()
    except ValueError as exc:
        print(f"error: {exc}")
        return 1
    device = device or cfg.device

    # validation (reference comprehensive_benchmarks.rs:96-152)
    if min_log > max_log:
        print("error: --min-log-size must be <= --max-log-size")
        return 1
    if not (2 <= min_log <= 20) or not (2 <= max_log <= 20):
        print("error: log sizes must be within 2..=20")
        return 1

    if mode == "help" or "--help" in args or "-h" in args:
        print(_HELP)
        return 0
    if mode not in _MODES:
        print(f"error: unknown mode '{mode}'\n")
        print(_HELP)
        return 1

    import torch

    try:
        dev = torch.device(device)
    except RuntimeError:
        print(f"error: invalid value for --device: {device}")
        return 1
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to run the plain "
              "versions on the CPU", file=sys.stderr)
        return 2

    from ..utils.profiling import trace

    with trace(cfg.profile_dir):
        _run_mode(mode, min_log, max_log, operations, dev)
    return 0


def _run_mode(mode: str, min_log: int, max_log: int, operations: int,
              dev) -> None:
    from .harness import ProtocolBenchmarks

    bench = ProtocolBenchmarks(dev)
    if mode == "quick":
        bench.run_quick_benchmark()
    elif mode == "full":
        bench.run_comprehensive_benchmark()
    elif mode == "dev":
        bench.run_dev_benchmark()
    elif mode == "custom":
        bench.run_comprehensive_benchmark_with_params(min_log, max_log,
                                                      operations)
    elif mode == "twist-only":
        results = bench.benchmark_twist_scaling_range(min_log, max_log)
        bench.print_scaling_results("Twist", results)
    elif mode == "shout-only":
        results = bench.benchmark_shout_scaling_range(min_log, max_log)
        bench.print_scaling_results("Shout", results)
    else:
        _run_sound_modes(mode, min_log, max_log, operations, dev)


def _run_sound_modes(mode: str, min_log: int, max_log: int,
                     operations: int, device) -> None:
    """Time the tnsh extension tiers on ``device``: ``sound`` =
    TwistSound / ShoutSound, ``bits`` = TwistBits / ShoutBits.  Each
    prover runs once untimed at each size before the prove that is timed
    (kernels loaded, set-ups built and cached), and a proof that does not
    verify raises, as the harness's modes do."""
    import random
    import time

    from ..core.params import setup_params
    from ..field.fr import Fr
    from ..protocols.shout import LookupTable
    from ..protocols.twist import MemoryTrace

    if mode == "bits":
        from ..protocols.twist_bits import ShoutBits as SP, TwistBits as TP
        tier = "trapdoor-free bit-column"
    else:
        from ..protocols.sound import ShoutSound as SP, TwistSound as TP
        tier = "verifier-enforced sound"

    print(f"\n=== {tier} protocols "
          f"(K=2^{min_log}..2^{max_log}, {operations} ops) ===")
    print("Protocol | log K | Prove (ms) | Verify (ms) | Valid")
    print("---------|-------|------------|-------------|------")
    pp, vp = setup_params(max(max_log, 3))
    for log in range(min_log, max_log + 1):
        k = 1 << log
        random.seed(log)
        tr = MemoryTrace(k)
        for i in range(operations):
            if i % 3 == 0:
                tr.write(random.randrange(k), Fr(42 * i + 1))
            else:
                tr.read(random.randrange(k))
        table = LookupTable([Fr(i * i + 1) for i in range(k)])
        for _ in range(operations):
            table.lookup(random.randrange(k))
        for name, prove, verify in (
                ("Twist", lambda: TP.prove(tr, pp, device),
                 lambda proof: TP.verify(proof, vp)),
                ("Shout", lambda: SP.prove(table, pp, device),
                 lambda proof: SP.verify(proof, table.entries, vp))):
            prove()
            t0 = time.perf_counter()
            proof = prove()
            t1 = time.perf_counter()
            ok = verify(proof)
            t2 = time.perf_counter()
            print(f"{name:<8} | {log:5d} | {1e3 * (t1 - t0):10.2f} "
                  f"| {1e3 * (t2 - t1):11.2f} | {ok}")
            if not ok:
                raise AssertionError(
                    f"{name} proof verification failed at log K {log}")


if __name__ == "__main__":
    raise SystemExit(main())
