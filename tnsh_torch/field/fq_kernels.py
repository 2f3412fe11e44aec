"""Fq on the card: the Montgomery product kernel for BN254's base field,
beside its plain PyTorch version.

The kernel is the chain kernel of ``tnsh_torch/csrc/field.cuh`` (the port
of ``tnsh/field/fr_pallas.py`` ``_chain_call``) compiled for Fq in
``tnsh_torch/csrc/msm_kernels.cu``.  The MSM uses it to turn the SRS
bases into Montgomery form on the device (``to_mont``).  Same rules as
``tnsh_torch.field.fr_kernels``: a CPU tensor goes to the plain version
(``fr_ops.fq``), a CUDA tensor to the kernel or the wrapper raises, and
every launch is counted.
"""

from __future__ import annotations

import torch

from . import fr_ops
from .fr_kernels import (
    _on_cuda,
    chain_plain,
    check_chain_args,
    const_planes,
    launch_chain,
)
from .limbs import FQ_SPEC


def mont_mul_chain_plain(x: torch.Tensor, y: torch.Tensor,
                         iters: int) -> torch.Tensor:
    """x * y^iters in Fq, by iterated ``fr_ops.fq.mont_mul``."""
    return chain_plain(fr_ops.fq, x, y, iters)


def mont_mul_chain(x: torch.Tensor, y: torch.Tensor,
                   iters: int) -> torch.Tensor:
    """x * y^iters per lane in Fq; shapes as ``fr_kernels.mont_mul_chain``
    (``iters = 1`` is the elementwise Montgomery product)."""
    check_chain_args(x, y, iters)
    if not _on_cuda(x, y):
        return mont_mul_chain_plain(x, y, iters)
    from .._build import msm_library

    lib = msm_library()
    out = launch_chain(lib.tnsh_fq_chain, lib, x, y, iters,
                       "fq mont_mul_chain")
    mont_mul_chain.launches += 1
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Fq Montgomery product of ``(8, n)`` planes."""
    return mont_mul_chain(a, b, 1)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Canonical Fq limbs -> Montgomery form: one product by R^2 mod q."""
    return mont_mul_chain(a, const_planes(FQ_SPEC.r2_mod_p, a.device), 1)


mont_mul_chain.launches = 0
