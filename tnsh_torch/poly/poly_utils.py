"""poly_utils: API-parity alias module (reference polynomials.rs:296-371),
the port of ``tnsh.poly.poly_utils``.

The reference exposes ``polynomials::poly_utils::{lagrange_interpolate,
evaluate_polynomial, derivative}``; the implementations live in
``tnsh_torch.poly.interp`` and are re-exported under the reference's module
name.
"""

from .interp import (  # noqa: F401
    derivative,
    evaluate_polynomial,
    interpolate_on_range,
    lagrange_interpolate,
)

__all__ = [
    "derivative",
    "evaluate_polynomial",
    "interpolate_on_range",
    "lagrange_interpolate",
]
