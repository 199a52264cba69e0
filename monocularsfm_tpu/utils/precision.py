"""High-precision small-matrix products.

A float32 matrix product on a GPU may run in TF32 (about three decimal
digits) unless a precision is asked for; for the small precision-critical
products in the estimators/geometry (3x3 pose algebra, normal equations, SVD
re-projections) that rounding is catastrophic — a reduced-precision product
once left the PnP Gauss-Newton polish at ~6 degrees of rotation error where
full f32 reaches 0.03 degrees.  `mm` chains jnp.matmul at
Precision.HIGHEST; the cost is irrelevant at these sizes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


def mm(*ms):
    """Left-to-right matrix product at HIGHEST precision."""
    out = ms[0]
    for m in ms[1:]:
        out = jnp.matmul(out, m, precision=_HIGHEST)
    return out
