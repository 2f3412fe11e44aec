"""The plain reference that decides ``correct``: a judge of proof bytes.

Written in Python ints alone.  It imports nothing of the program under
test (``tnsh_torch``), of the JAX package or of jax, and takes nothing the
program made: it reads the proof bytes the timed path serialised, and the
inputs the harness generated, and works out again every value it compares.

What it checks of a bit-column proof (``judge`` in ``twist_bits`` and
``shout_bits``):

  * the column commitments: each column is simulated from the input and
    committed again through the SRS trapdoor, which the configuration's
    deterministic PST SRS makes public (``pst.srs_taus``): a commitment is
    ``[col~(tau)]_1``, and the bytes must be equal;
  * the transcript: every Fiat-Shamir challenge is drawn again from the
    proof's own messages (``transcript``);
  * the sum-checks: each round polynomial against the running claim, and
    the final evaluation against the statement's constraint at the
    challenge point;
  * the openings: the claimed column values against the columns' own
    multilinear extensions at the opening points, and each PST opening
    against the verifier's equation, checked in G1 through the trapdoor
    (``C - [v]_1 == sum_i (tau_i - r_i) Q_i``, which holds exactly when
    the pairing check does).
"""
