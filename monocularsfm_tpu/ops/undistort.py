"""Iterative keypoint undistortion (radial-tangential model).

Reference parity: Map load undistorts every keypoint once with
cv::undistortPoints (src/Reconstruction/Map.cpp:45-69, :96-103) so that
downstream geometry (triangulation, BA) is distortion-free.  Model is the
standard OpenCV (k1, k2, p1, p2) radial-tangential.

The inverse distortion has no closed form; like OpenCV we fixed-point
iterate x <- (x_d - tangential(x)) / radial(x), which converges in a handful
of steps for photographic distortion levels.  Batched jnp; also usable under
jit/vmap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def distort(xn: jnp.ndarray, dist: jnp.ndarray) -> jnp.ndarray:
    """Apply (k1, k2, p1, p2) to normalized coords. (..., 2) -> (..., 2)."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([x * radial + dx, y * radial + dy], axis=-1)


@functools.partial(jax.jit, static_argnames=("iterations",))
def undistort_normalized(xd: jnp.ndarray, dist: jnp.ndarray, iterations: int = 8):
    """Invert `distort` by fixed-point iteration. xd: (..., 2) distorted."""
    def body(i, x):
        k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * xx * yy + p2 * (r2 + 2.0 * xx * xx)
        dy = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * xx * yy
        inv = 1.0 / jnp.where(jnp.abs(radial) < 1e-9, 1e-9, radial)
        return jnp.stack(
            [(xd[..., 0] - dx) * inv, (xd[..., 1] - dy) * inv], axis=-1
        )

    return jax.lax.fori_loop(0, iterations, body, xd)


@functools.partial(jax.jit, static_argnames=("iterations",))
def undistort_pixels(uv, K, dist, iterations: int = 8):
    """Pixel -> undistorted pixel (same K for reprojection afterwards).

    Jitted: eager per-op dispatch would compile each tiny op separately."""
    uv = jnp.asarray(uv, jnp.float32)
    K = jnp.asarray(K, jnp.float32)
    dist = jnp.asarray(dist, jnp.float32)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xd = jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)
    xn = undistort_normalized(xd, dist, iterations=iterations)
    return jnp.stack([xn[..., 0] * fx + cx, xn[..., 1] * fy + cy], axis=-1)
