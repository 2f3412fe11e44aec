"""The fold kernel's share of its roofline in the dense cell, read as
``fold_roofline`` reads it (that metric lists only the accepted cells).
The cube's binds (49 tables, from 2^24 lanes down) are 99.9% of that
work's least time at K = 2^10, T = 2^14; phase B's and the openings'
folds of 2^14 lanes and below are the rest."""

from proofbench import harness

read = harness.metric_reader("fold_roofline").read
