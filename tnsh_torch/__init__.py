"""tnsh_torch: the PyTorch and CUDA port of tnsh.

The port mirrors ``tnsh``'s module names; ``tnsh`` stays the reference
every ported function is held to (exact equality of canonical field
elements, group elements and proof bytes).  The port imports ``torch``,
never ``jax`` and nothing of ``tnsh``: the host-only layers (the golden
``Fr``, curve and pairing code, the transcript, commitments, ``proof_io``
and the native C++ engine) are its own copies, under the same file names.

Slice 1 put the sum-check round on the card: Fr Montgomery arithmetic
(``field``), the MLE round kernels (``poly.mle``), the device sum-check
oracles (``iop``) and the TwistBits prover (``protocols.twist_bits``).
Slice 2 put the commitment MSM there: Fq arithmetic, the G1 group law
(``commit.msm_group``), the scheduled Pippenger with its insertion kernel
(``commit.msm_sched``) and the router that sends a prover's MSMs to the
device it names (``commit.kzg``).  The MSM's device side is laid out
for the H100: a plan as wide as the card and a tail of two or three
kernels (``commit.msm_sched``).  Slice 5 added the lookup provers on
the same kernels: ``ShoutBits`` and ``ShoutBitsCommitted``
(``protocols.twist_bits``) with their phase-A oracle
(``iop.bits_oracle.ShoutBitsSparseOracle``) and ``LookupTable``
(``protocols.shout``).  Slice 6 added the lookup half of the
verifier-enforced tier, ``ShoutSound`` (``protocols.sound``), with its
sparse cube oracle (``iop.sparse_oracle``: k rounds on the native engine,
j rounds on the card) and the factorized cube commitments and j-first
openings on the MSM kernels (``commit.mkzg_sparse``).  Slice 7 added its
read-write half, ``TwistSound``: seven commitments in one burst, and a j
phase of 16 tables on the card.  Slice 8 added the parity provers
``Twist`` and ``Shout`` (``protocols.twist``, ``protocols.shout``) with
the univariate KZG (``commit.kzg``: the Lagrange SRS, ``commit_evals`` /
``open_evals``, verification and the vector commitment), whose MSMs of
1024 points or more run on the MSM kernels and whose sound-mode
sum-check runs on the product-round and fold kernels; their ``TWST`` /
``SHOT`` formats, the benchmark harness and command line (``bench``:
``python -m tnsh_torch.bench.cli``) and the profiler trace
(``utils.profiling.trace``).  Every prover takes the device it runs on,
``Twist(pp, "cuda")`` and ``Shout(pp, "cuda")`` too.  Field elements live
as limb-major ``(8, N)`` int32 tensors of 32-bit little-endian limbs in
Montgomery form with R = 2^256 (``field.limbs``).

The public names are those of ``tnsh``'s package root, each loaded from
its module on first use: importing the package loads no prover.
"""

import importlib

__version__ = "0.1.0"

#: public name -> (module, attribute); the same names as tnsh's root
_EXPORTS = {
    "BenchmarkResults": ("bench.harness", "BenchmarkResults"),
    "ProtocolBenchmarks": ("bench.harness", "ProtocolBenchmarks"),
    "benchmark_setup": ("bench.harness", "benchmark_setup"),
    "CommitmentScheme": ("commit.kzg", "CommitmentScheme"),
    "KZGCommitment": ("commit.kzg", "KZGCommitment"),
    "KZGCommitmentValue": ("commit.kzg", "KZGCommitmentValue"),
    "KZGProof": ("commit.kzg", "KZGProof"),
    "KZGVectorCommitment": ("commit.kzg", "KZGVectorCommitment"),
    "VectorCommitmentScheme": ("commit.kzg", "VectorCommitmentScheme"),
    "MLOpeningProof": ("commit.mkzg", "MLOpeningProof"),
    "MultilinearKZG": ("commit.mkzg", "MultilinearKZG"),
    "setup_multilinear_params": ("commit.mkzg", "setup_multilinear_params"),
    "CommitmentParams": ("core.params", "CommitmentParams"),
    "CommitmentVerificationKey": ("core.params",
                                  "CommitmentVerificationKey"),
    "ProverParams": ("core.params", "ProverParams"),
    "VerifierParams": ("core.params", "VerifierParams"),
    "setup_params": ("core.params", "setup_params"),
    "Transcript": ("core.transcript", "Transcript"),
    "CommitmentError": ("errors", "CommitmentError"),
    "InvalidParametersError": ("errors", "InvalidParametersError"),
    "PolynomialError": ("errors", "PolynomialError"),
    "ProofGenerationError": ("errors", "ProofGenerationError"),
    "ProofVerificationError": ("errors", "ProofVerificationError"),
    "SumCheckError": ("errors", "SumCheckError"),
    "TwistAndShoutError": ("errors", "TwistAndShoutError"),
    "Fr": ("field.fr", "Fr"),
    "FieldElement": ("field.fr", "Fr"),
    "G1": ("field.g1", "G1"),
    "G1Element": ("field.g1", "G1"),
    "G2": ("field.g2", "G2"),
    "G2Element": ("field.g2", "G2"),
    "SumCheck": ("iop.sumcheck", "SumCheck"),
    "SumCheckProof": ("iop.sumcheck", "SumCheckProof"),
    "SumCheckVerifier": ("iop.sumcheck", "SumCheckVerifier"),
    "LessThanPolynomial": ("poly.lt", "LessThanPolynomial"),
    "MultilinearExtension": ("poly.mle_host", "MultilinearExtension"),
    "LookupOp": ("protocols.shout", "LookupOp"),
    "LookupTable": ("protocols.shout", "LookupTable"),
    "Shout": ("protocols.shout", "Shout"),
    "ShoutProof": ("protocols.shout", "ShoutProof"),
    "ShoutSound": ("protocols.sound", "ShoutSound"),
    "ShoutSoundProof": ("protocols.sound", "ShoutSoundProof"),
    "TwistSound": ("protocols.sound", "TwistSound"),
    "TwistSoundProof": ("protocols.sound", "TwistSoundProof"),
    "MemoryOp": ("protocols.twist", "MemoryOp"),
    "MemoryOpKind": ("protocols.twist", "MemoryOpKind"),
    "MemoryTrace": ("protocols.twist", "MemoryTrace"),
    "Twist": ("protocols.twist", "Twist"),
    "TwistProof": ("protocols.twist", "TwistProof"),
    "ShoutBits": ("protocols.twist_bits", "ShoutBits"),
    "ShoutBitsCommProof": ("protocols.twist_bits", "ShoutBitsCommProof"),
    "ShoutBitsCommitted": ("protocols.twist_bits", "ShoutBitsCommitted"),
    "ShoutBitsProof": ("protocols.twist_bits", "ShoutBitsProof"),
    "TwistBits": ("protocols.twist_bits", "TwistBits"),
    "TwistBitsProof": ("protocols.twist_bits", "TwistBitsProof"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(f".{module}", __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
