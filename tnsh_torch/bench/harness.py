"""Benchmark harness for Twist and Shout.

Counterpart of ``tnsh/bench/harness.py`` (``ProtocolBenchmarks`` and
``BenchmarkResults``, reference benchmarks.rs:8-370), with the synthetic
workloads the reference publishes:

  * Twist: write if ``i % 3 == 0`` with value 42*i, else read
    ``(i/2) % size``;
  * Shout: the square-number table ``t[i] = i*i`` with round-robin lookups;
  * size-tiered op counts: size/2 (<=64), size/4 (<=512), size/8 (>512);
  * proof-size model: 64 B a commitment + 128 B a round + 64 B an opening;
    memory model 32 B x (table + 3 ops).

A ``ProtocolBenchmarks`` proves on the device it is given.  A prove
returns host values only once its device work is done (each MSM's
finisher waits for the card, each sum-check round reads its evaluations
back), so the clock read after it includes the card's time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Tuple

from ..core.params import setup_params
from ..field.fr import Fr
from ..protocols.shout import LookupTable, Shout
from ..protocols.twist import MemoryTrace, Twist


@dataclass
class BenchmarkResults:
    """Timing and size results (reference benchmarks.rs:8-39); seconds."""

    setup_time: float
    prove_time: float
    verify_time: float
    proof_size: int
    num_operations: int
    memory_usage: int

    def prove_ops_per_second(self) -> float:
        return (self.num_operations / self.prove_time if self.prove_time
                else float("inf"))

    def verify_ops_per_second(self) -> float:
        return (self.num_operations / self.verify_time if self.verify_time
                else float("inf"))

    def total_time(self) -> float:
        return self.setup_time + self.prove_time + self.verify_time


def _tiered_ops(size: int) -> int:
    """Utilization-tiered op counts (reference benchmarks.rs:57-64)."""
    if size <= 64:
        return size // 2
    if size <= 512:
        return size // 4
    return size // 8


class ProtocolBenchmarks:
    """Benchmark suite (reference benchmarks.rs:42-364) on ``device``."""

    def __init__(self, device):
        self.device = device

    # -- Twist -------------------------------------------------------------
    def benchmark_twist_scaling(self) -> List[Tuple[int, BenchmarkResults]]:
        return self.benchmark_twist_scaling_range(4, 8)

    def benchmark_twist_scaling_range(
        self, min_log_size: int, max_log_size: int
    ) -> List[Tuple[int, BenchmarkResults]]:
        results = []
        for log_size in range(min_log_size, max_log_size + 1):
            memory_size = 1 << log_size
            num_operations = _tiered_ops(memory_size)
            print(f"  Testing Twist with memory size: {memory_size} "
                  f"(2^{log_size}), operations: {num_operations}")
            results.append((memory_size, self.benchmark_twist_single(
                log_size, num_operations)))
        return results

    def benchmark_twist_single(self, log_size: int,
                               num_operations: int) -> BenchmarkResults:
        setup_start = time.perf_counter()
        # setup_params is cached (a pure function of log_size); cleared to
        # time a cold setup as the reference does on every call
        setup_params.cache_clear()
        prover_params, verifier_params = setup_params(log_size)
        twist = Twist(prover_params, self.device)
        setup_time = time.perf_counter() - setup_start

        memory_size = 1 << log_size
        trace = MemoryTrace(memory_size)
        for i in range(num_operations):
            if i % 3 == 0:
                trace.write(i % memory_size, Fr(i * 42))
            else:
                trace.read((i // 2) % memory_size)

        prove_start = time.perf_counter()
        proof = twist.prove(trace)
        prove_time = time.perf_counter() - prove_start

        verify_start = time.perf_counter()
        is_valid = twist.verify(proof, verifier_params)
        verify_time = time.perf_counter() - verify_start
        if not is_valid:
            raise AssertionError("Proof verification failed")

        return BenchmarkResults(
            setup_time=setup_time,
            prove_time=prove_time,
            verify_time=verify_time,
            proof_size=self.estimate_twist_proof_size(proof),
            num_operations=len(trace.operations),
            memory_usage=self.estimate_memory_usage(memory_size,
                                                    num_operations),
        )

    # -- Shout -------------------------------------------------------------
    def benchmark_shout_scaling(self) -> List[Tuple[int, BenchmarkResults]]:
        return self.benchmark_shout_scaling_range(4, 8)

    def benchmark_shout_scaling_range(
        self, min_log_size: int, max_log_size: int
    ) -> List[Tuple[int, BenchmarkResults]]:
        results = []
        for log_size in range(min_log_size, max_log_size + 1):
            table_size = 1 << log_size
            num_lookups = _tiered_ops(table_size)
            print(f"  Testing Shout with table size: {table_size} "
                  f"(2^{log_size}), lookups: {num_lookups}")
            results.append((table_size, self.benchmark_shout_single(
                log_size, num_lookups)))
        return results

    def benchmark_shout_single(self, log_size: int,
                               num_lookups: int) -> BenchmarkResults:
        setup_start = time.perf_counter()
        setup_params.cache_clear()
        prover_params, verifier_params = setup_params(log_size)
        shout = Shout(prover_params, self.device)
        setup_time = time.perf_counter() - setup_start

        table_size = 1 << log_size
        table = LookupTable([Fr(i * i) for i in range(table_size)])
        for i in range(num_lookups):
            table.lookup(i % table_size)

        prove_start = time.perf_counter()
        proof = shout.prove(table)
        prove_time = time.perf_counter() - prove_start

        verify_start = time.perf_counter()
        is_valid = shout.verify(proof, verifier_params)
        verify_time = time.perf_counter() - verify_start
        if not is_valid:
            raise AssertionError("Proof verification failed")

        return BenchmarkResults(
            setup_time=setup_time,
            prove_time=prove_time,
            verify_time=verify_time,
            proof_size=self.estimate_shout_proof_size(proof),
            num_operations=len(table.lookups),
            memory_usage=self.estimate_memory_usage(table_size, num_lookups),
        )

    # -- runners -----------------------------------------------------------
    def comparative_benchmark(
        self, log_size: int, num_operations: int
    ) -> Tuple[BenchmarkResults, BenchmarkResults]:
        return (self.benchmark_twist_single(log_size, num_operations),
                self.benchmark_shout_single(log_size, num_operations))

    def run_comprehensive_benchmark(self) -> None:
        self.run_comprehensive_benchmark_with_params(4, 8, 256)

    def run_comprehensive_benchmark_with_params(
        self, min_log_size: int, max_log_size: int, num_ops: int
    ) -> None:
        print("\U0001F680 Twist and Shout Protocol Benchmark Suite")
        print("============================================\n")

        print("\U0001F4CA Twist Protocol Scaling Analysis:")
        twist_results = self.benchmark_twist_scaling_range(min_log_size,
                                                           max_log_size)
        self.print_scaling_results("Twist", twist_results)

        print("\n\U0001F4CA Shout Protocol Scaling Analysis:")
        shout_results = self.benchmark_shout_scaling_range(min_log_size,
                                                           max_log_size)
        self.print_scaling_results("Shout", shout_results)

        compare_log_size = (min_log_size + max_log_size) // 2
        compare_table_size = 1 << compare_log_size
        print(f"\n\U0001F504 Comparative Analysis (Memory/Table Size: "
              f"{compare_table_size}):")
        twist_comp, shout_comp = self.comparative_benchmark(compare_log_size,
                                                            num_ops)
        self.print_comparative_results(twist_comp, shout_comp)

    def run_quick_benchmark(self) -> None:
        self.run_comprehensive_benchmark_with_params(4, 6, 64)

    def run_dev_benchmark(self) -> None:
        self.run_comprehensive_benchmark_with_params(4, 5, 32)

    def run_optimized_benchmark(self, min_log_size: int,
                                max_log_size: int) -> None:
        print("\U0001F680 Optimized Twist and Shout Protocol Benchmark Suite")
        print("======================================================\n")
        for log_size in range(min_log_size, max_log_size + 1):
            table_size = 1 << log_size
            num_operations = max(32, 512 // (1 << (log_size - 4)))
            print(f"\U0001F4CA Protocol Comparison at size {table_size} "
                  f"(2^{log_size}) with {num_operations} operations:")
            twist_result, shout_result = self.comparative_benchmark(
                log_size, num_operations)
            print("Protocol | Prove(ms) | Verify(ms) | Proof(KB) | Ops/sec | "
                  "Memory(KB)")
            print("---------|-----------|------------|-----------|---------|"
                  "----------")
            for name, res in (("Twist", twist_result),
                              ("Shout", shout_result)):
                print(f"{name:<8} | {res.prove_time * 1e3:.2f}      | "
                      f"{res.verify_time * 1e3:.2f}       | "
                      f"{res.proof_size / 1024.0:.2f}      | "
                      f"{res.prove_ops_per_second():.0f}     | "
                      f"{res.memory_usage / 1024.0:.1f}")
            print()

    # -- printing ----------------------------------------------------------
    @staticmethod
    def print_scaling_results(
        protocol: str, results: List[Tuple[int, BenchmarkResults]]
    ) -> None:
        print("Size\t| Setup(ms)\t| Prove(ms)\t| Verify(ms)\t| Proof(KB)\t| "
              "Ops/sec")
        print("--------|---------------|---------------|---------------|"
              "---------------|--------")
        for size, result in results:
            print(f"{size}\t| {result.setup_time * 1e3:.2f}\t\t| "
                  f"{result.prove_time * 1e3:.2f}\t\t| "
                  f"{result.verify_time * 1e3:.2f}\t\t| "
                  f"{result.proof_size / 1024.0:.2f}\t\t| "
                  f"{result.prove_ops_per_second():.0f}")

    @staticmethod
    def print_comparative_results(twist: BenchmarkResults,
                                  shout: BenchmarkResults) -> None:
        print("Protocol | Prove(ms) | Verify(ms) | Proof(KB) | Ops/sec | "
              "Total(ms)")
        print("---------|-----------|------------|-----------|---------|"
              "----------")
        for name, res in (("Twist", twist), ("Shout", shout)):
            print(f"{name:<8} | {res.prove_time * 1e3:.2f}      | "
                  f"{res.verify_time * 1e3:.2f}       | "
                  f"{res.proof_size / 1024.0:.2f}      | "
                  f"{res.prove_ops_per_second():.0f}     | "
                  f"{res.total_time() * 1e3:.2f}")
        prove_ratio = (twist.prove_time or 1e-9) / (shout.prove_time or 1e-9)
        verify_ratio = ((twist.verify_time or 1e-9)
                        / (shout.verify_time or 1e-9))
        print("\n\U0001F4C8 Performance Ratios (Twist/Shout):")
        print(f"Proving: {prove_ratio:.2f}x, Verification: "
              f"{verify_ratio:.2f}x")

    # -- estimators (reference benchmarks.rs:336-363) ----------------------
    @staticmethod
    def estimate_twist_proof_size(proof) -> int:
        commitment_size = 64
        sumcheck_size = len(proof.consistency_proof.round_polynomials) * 128
        opening_size = len(proof.opening_proofs) * 64
        return 2 * commitment_size + sumcheck_size + opening_size

    @staticmethod
    def estimate_shout_proof_size(proof) -> int:
        commitment_size = 64
        sumcheck_size = len(proof.lookup_proof.round_polynomials) * 128
        opening_size = len(proof.opening_proofs) * 64
        return 2 * commitment_size + sumcheck_size + opening_size

    @staticmethod
    def estimate_memory_usage(table_size: int, num_operations: int) -> int:
        field_size = 32
        return table_size * field_size + num_operations * field_size * 3


def benchmark_setup(log_size: int) -> Tuple[int, int]:
    """(prover.max_operations, verifier.max_operations)
    (reference benchmarks.rs:367-370)."""
    prover_params, verifier_params = setup_params(log_size)
    return prover_params.max_operations, verifier_params.max_operations
