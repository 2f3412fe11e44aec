"""MLE evaluation tables on limb planes: the port of ``tnsh.poly.mle_jax``.

Tables are ``(8, N)`` int32 Fr limb planes (Montgomery, 2p-domain; see
``tnsh_torch.field.limbs``), or ``(F, 8, N)`` stacks of them.  Index bit
j of a lane is variable j, little-endian, as in the JAX package.

``mle_jax`` routes its ``*_jit`` entry points to Pallas above a size
gate.  Here one rule replaces that routing, in
``tnsh_torch.field.fr_kernels``: a CPU tensor runs the plain PyTorch
version, a CUDA tensor runs the CUDA kernel, at every size.  Round
challenges are host field elements (they come off the transcript), and
the fold takes them as such.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from ..field.fr import Fr

from ..field import fr_kernels, fr_ops, limbs

Tables = Union[torch.Tensor, Sequence[torch.Tensor]]


def pack_mle(evaluations, device) -> torch.Tensor:
    """Host values (ints, ``Fr``, an ``FrTable`` or LE bytes) -> an
    ``(8, N)`` Montgomery table on ``device``."""
    return limbs.pack(evaluations, device)


def unpack_fr(planes: torch.Tensor) -> List[Fr]:
    """Device -> host canonical field elements."""
    return [Fr(v) for v in limbs.unpack(planes)]


def pack_fr_scalar(x, device) -> torch.Tensor:
    """A single field element as ``(8, 1)`` planes."""
    return limbs.scalar(x, device)


def _stack(tables: Tables) -> torch.Tensor:
    if isinstance(tables, torch.Tensor):
        return tables if tables.dim() == 3 else tables.unsqueeze(0)
    return torch.stack(list(tables))


def fold(table: torch.Tensor, r) -> torch.Tensor:
    """Fix variable 0 to r: out[i] = t[2i] + r * (t[2i+1] - t[2i]).

    Takes one ``(8, N)`` table or an ``(F, 8, N)`` stack (one launch)."""
    if table.dim() == 2:
        return fr_kernels.fold(table.unsqueeze(0), r)[0]
    return fr_kernels.fold(table, r)


def evaluate(table: torch.Tensor, point: Sequence) -> torch.Tensor:
    """Evaluate at a point given as host field elements -> ``(8, 1)``."""
    for r in point:
        table = fold(table, r)
    return table


def sum_tree(table: torch.Tensor) -> torch.Tensor:
    """Exact field sum over all lanes -> ``(8, 1)``."""
    return fr_ops.sum_lanes(table)


def product_round_evals(tables: Tables,
                        scale: torch.Tensor = None) -> torch.Tensor:
    """[g(0), g(1), g(2), g(3)] for a product-of-MLEs round -> ``(8, 4)``.

    g(x) = scale * Σ_pairs Π_f (lo_f + x (hi_f - lo_f))."""
    return fr_kernels.product_round_evals(_stack(tables), scale)


def _coeffs(coeffs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(coeffs), dim=1).contiguous()


def sum_of_products_round_evals(
    tables: Tables,
    coeffs: Sequence[torch.Tensor],
    term_idxs: Tuple[Tuple[int, ...], ...],
) -> torch.Tensor:
    """[g(0..3)] for f = Σ_t coeff_t * Π_{f in term_t} T_f -> ``(8, 4)``."""
    return sum_of_products_round_evals_d(tables, coeffs, term_idxs, 4)


def sum_of_products_round_evals_d(
    tables: Tables,
    coeffs: Sequence[torch.Tensor],
    term_idxs: Tuple[Tuple[int, ...], ...],
    npts: int,
) -> torch.Tensor:
    """[g(0..npts-1)] for a generic-degree sum of products -> ``(8, npts)``."""
    stacked = _stack(tables)
    desc = fr_kernels.terms(term_idxs, stacked.device)
    return fr_kernels.sum_of_products_round_evals(
        stacked, _coeffs(coeffs), desc, npts)


def product_round_step(tables: Tables, r):
    """One full sum-check round for a product oracle: returns
    ([g(0..3)] BEFORE folding, folded tables AFTER binding r)."""
    stacked = _stack(tables)
    evals = fr_kernels.product_round_evals(stacked)
    folded = fr_kernels.fold(stacked, r)
    return evals, list(folded.unbind(0))
