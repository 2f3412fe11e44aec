"""field_utils: API-parity alias module (reference utils.rs:207-269), the
port of ``tnsh.field.field_utils``.

The reference exposes ``utils::field_utils::{inner_product, horner_eval,
powers, vanishing_poly_eval, batch_inverse}``; the implementations live in
``tnsh_torch.field.fr`` and are re-exported here under the reference's
module name.
"""

from .fr import (  # noqa: F401
    batch_inverse,
    horner_eval,
    inner_product,
    powers,
    vanishing_poly_eval,
)

__all__ = [
    "batch_inverse",
    "horner_eval",
    "inner_product",
    "powers",
    "vanishing_poly_eval",
]
