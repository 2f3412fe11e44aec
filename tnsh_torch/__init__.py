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
verifier-enforced tier, ``ShoutSound`` (``protocols.sound``; exported
here), with its sparse cube oracle (``iop.sparse_oracle``: k rounds on the
native engine, j rounds on the card) and the factorized cube commitments
and j-first openings on the MSM kernels (``commit.mkzg_sparse``).  Slice
7 added its read-write half, ``TwistSound`` (exported here): seven
commitments in one burst, and a j phase of 16 tables on the card.  Field
elements live as limb-major ``(8, N)`` int32 tensors of 32-bit
little-endian limbs in Montgomery form with R = 2^256 (``field.limbs``).
"""

__all__ = ["ShoutSound", "TwistSound"]


def __getattr__(name):
    # imported on first use: the package itself loads no prover
    if name in __all__:
        from .protocols import sound

        return getattr(sound, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
