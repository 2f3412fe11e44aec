"""Error taxonomy for the tnsh framework (the port's own copy).

Mirrors the reference error enum ``TwistAndShoutError`` (reference src/lib.rs:59-80)
one-for-one: InvalidParameters, ProofGeneration, ProofVerification, Commitment,
Polynomial, SumCheck.  Each variant becomes a subclass so callers can catch either
the broad base class or a specific failure mode, matching how the Rust `Result<T>`
alias (lib.rs:80) threads a single error enum through every layer.
"""

from __future__ import annotations


class TwistAndShoutError(Exception):
    """Base class for all tnsh protocol errors (reference lib.rs:60)."""


class InvalidParametersError(TwistAndShoutError):
    """Invalid parameters (reference lib.rs:61-62)."""


class ProofGenerationError(TwistAndShoutError):
    """Proof generation failed (reference lib.rs:64-65)."""


class ProofVerificationError(TwistAndShoutError):
    """Proof verification failed (reference lib.rs:67-68)."""


class CommitmentError(TwistAndShoutError):
    """Commitment error (reference lib.rs:70-71)."""


class PolynomialError(TwistAndShoutError):
    """Polynomial operation failed (reference lib.rs:73-74)."""


class SumCheckError(TwistAndShoutError):
    """Sum-check protocol error (reference lib.rs:76-77)."""
