"""The mesh of the port: ranks of ``torch.distributed`` in place of the
JAX devices of a mesh (``parallel.mesh``)."""
