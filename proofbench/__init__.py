"""The benchmark of the PyTorch and CUDA port ``tnsh_torch``: run one
cell with ``python3 proofbench/run.py --workload <cell> ...`` (see
README.md)."""
