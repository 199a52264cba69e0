"""Batched DLT triangulation: two-view and masked n-view.

Reference parity: src/Reconstruction/Triangulator.cpp:87-117 accumulates
A^T A over views and takes the smallest eigenvector of the 4x4 system; the
two-view variant in src/Reconstruction/Initializer.cpp:436-463 stacks the
4x4 DLT directly.  Both are reproduced here as closed-shape batched ops —
thousands of candidate tracks triangulate in one jnp.linalg.eigh over
(..., 4, 4), which XLA maps onto chip-resident batched eigendecomposition.

Rows use the normalized-camera form: for a view with projection P = K[R|t]
and pixel uv, the two DLT rows are  x * P[2] - P[0]  and  y * P[2] - P[1]
with (x, y) the *normalized* image coordinates (pixels pre-multiplied by
K^-1), which keeps the system well-conditioned in float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# DLT conditioning is precision-critical: a reduced-precision contraction
# (TF32 on a GPU keeps ~3 decimal digits) can cost pixels of reprojection
# error on synthetic exact data.  These contractions are tiny (4x4 outputs),
# so full-precision accumulation is free.
_HIGHEST = jax.lax.Precision.HIGHEST


def _normalized_rows(R: jnp.ndarray, t: jnp.ndarray, xn: jnp.ndarray) -> jnp.ndarray:
    """Two DLT rows per view. R: (...,3,3), t: (...,3), xn: (...,2) normalized.

    Returns (..., 2, 4).
    """
    P = jnp.concatenate([R, t[..., None]], axis=-1)  # (..., 3, 4)
    r0 = xn[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = xn[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    return jnp.stack([r0, r1], axis=-2)


def _smallest_eigvec_4x4(A: jnp.ndarray) -> jnp.ndarray:
    """Eigenvector of the smallest eigenvalue of symmetric (..., 4, 4)."""
    # jnp.linalg.eigh returns ascending eigenvalues; column 0 is the smallest.
    _, V = jnp.linalg.eigh(A)
    return V[..., :, 0]


def triangulate_two_view(
    R1: jnp.ndarray,
    t1: jnp.ndarray,
    R2: jnp.ndarray,
    t2: jnp.ndarray,
    xn1: jnp.ndarray,
    xn2: jnp.ndarray,
) -> jnp.ndarray:
    """Two-view DLT. xn1/xn2: (..., 2) normalized coords. Returns X: (..., 3)."""
    rows1 = _normalized_rows(R1, t1, xn1)
    rows2 = _normalized_rows(R2, t2, xn2)
    A = jnp.concatenate([rows1, rows2], axis=-2)  # (..., 4, 4)
    AtA = jnp.einsum("...ki,...kj->...ij", A, A, precision=_HIGHEST)
    h = _smallest_eigvec_4x4(AtA)
    w = h[..., 3:4]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return h[..., :3] / w


def triangulate_n_view(
    R: jnp.ndarray,
    t: jnp.ndarray,
    xn: jnp.ndarray,
    mask: jnp.ndarray,
) -> jnp.ndarray:
    """Masked n-view DLT over a fixed-width view window.

    R: (..., V, 3, 3), t: (..., V, 3), xn: (..., V, 2), mask: (..., V) bool.
    Invalid views contribute zero rows to A^T A (the reference accumulates
    term^T term per view, Triangulator.cpp:98-106 — identical algebra).
    Returns X: (..., 3).
    """
    rows = _normalized_rows(R, t, xn)  # (..., V, 2, 4)
    rows = rows * mask[..., None, None].astype(rows.dtype)
    AtA = jnp.einsum("...vki,...vkj->...ij", rows, rows, precision=_HIGHEST)
    h = _smallest_eigvec_4x4(AtA)
    w = h[..., 3:4]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return h[..., :3] / w
