"""The round-evaluation kernels' share of their roofline in the dense
cell, read as ``round_evals_roofline`` reads it (that metric lists only
the accepted cells), from ``proofbench.roofline.ROUND_PROGRAMS``' rows of
49 and 13 tables at log K = 10, phase A's and phase B's.  The launches
over the cube (49 tables, from 2^24 lanes down) are over 98% of that
work (99.98% of its least time at K = 2^10, T = 2^14); phase B's
13-table launches of 2^14 lanes and below are the rest."""

from proofbench import harness

read = harness.metric_reader("round_evals_roofline").read
