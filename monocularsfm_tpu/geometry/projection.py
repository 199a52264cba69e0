"""Pinhole projection, reprojection error, cheirality and parallax.

Reference parity: src/Reconstruction/Projection.cpp —
  HasPositiveDepth            (:6-68)
  CalculateReprojectionError  (:73-145)   (two-view variant = mean of both)
  CalculateParallaxAngle      (:149-194)  (law of cosines, degrees, NaN->0,
                                           folded to <= 90 deg)

All functions are pure jnp over trailing axes, so arbitrary batching comes
from broadcasting or vmap.  Poses are world->camera: x_cam = R @ X + t.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12
# Point transforms are (3,3)x(3) contractions — negligible FLOPs but
# precision-critical (sub-pixel reprojection error feeds accept/reject
# thresholds), so force full fp32 products (no TF32).
_HIGHEST = jax.lax.Precision.HIGHEST


def camera_center(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Camera center in world coords: C = -R^T t. R: (...,3,3), t: (...,3)."""
    return -jnp.einsum("...ji,...j->...i", R, t, precision=_HIGHEST)


def transform_to_camera(R: jnp.ndarray, t: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """World points into camera frame. X: (..., 3)."""
    return jnp.einsum("...ij,...j->...i", R, X, precision=_HIGHEST) + t


def has_positive_depth(R: jnp.ndarray, t: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Cheirality mask: depth (z in camera frame) > 0."""
    return transform_to_camera(R, t, X)[..., 2] > 0


def project(K: jnp.ndarray, R: jnp.ndarray, t: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Project world points to pixels. Returns (..., 2).

    Points behind the camera still produce finite coordinates (z clamped away
    from 0); callers combine with has_positive_depth for validity.
    """
    xc = transform_to_camera(R, t, X)
    z = xc[..., 2:3]
    z = jnp.where(jnp.abs(z) < _EPS, jnp.where(z < 0, -_EPS, _EPS), z)
    xn = xc[..., :2] / z
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    u = fx * xn[..., 0] + cx
    v = fy * xn[..., 1] + cy
    return jnp.stack([u, v], axis=-1)


def project_points(K, R, t, X):
    """Alias kept for call-site readability when X is a point batch."""
    return project(K, R, t, X)


def calculate_reprojection_error(
    K: jnp.ndarray, R: jnp.ndarray, t: jnp.ndarray, X: jnp.ndarray, uv: jnp.ndarray
) -> jnp.ndarray:
    """L2 pixel reprojection error. uv: (..., 2) observed -> (...,) error."""
    return jnp.linalg.norm(project(K, R, t, X) - uv, axis=-1)


def calculate_two_view_reprojection_error(K, R1, t1, R2, t2, X, uv1, uv2):
    """Mean of both views' errors (reference Projection.cpp:118-145)."""
    e1 = calculate_reprojection_error(K, R1, t1, X, uv1)
    e2 = calculate_reprojection_error(K, R2, t2, X, uv2)
    return 0.5 * (e1 + e2)


def calculate_parallax_angle_deg(
    C1: jnp.ndarray, C2: jnp.ndarray, X: jnp.ndarray
) -> jnp.ndarray:
    """Triangulation (parallax) angle at X between camera centers C1, C2.

    Law-of-cosines form like the reference (Projection.cpp:149-194): returns
    degrees, NaN/degenerate -> 0, folded to <= 90.
    """
    d1 = jnp.linalg.norm(X - C1, axis=-1)
    d2 = jnp.linalg.norm(X - C2, axis=-1)
    baseline = jnp.linalg.norm(C1 - C2, axis=-1)
    denom = 2.0 * d1 * d2
    cosang = (d1 * d1 + d2 * d2 - baseline * baseline) / jnp.maximum(denom, _EPS)
    cosang = jnp.clip(cosang, -1.0, 1.0)
    ang = jnp.degrees(jnp.arccos(cosang))
    ang = jnp.where(jnp.isfinite(ang), ang, 0.0)
    ang = jnp.where(denom <= _EPS, 0.0, ang)
    return jnp.where(ang > 90.0, 180.0 - ang, ang)
