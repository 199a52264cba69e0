"""Batched multi-view triangulation with acceptance tests.

Reference parity: src/Reconstruction/Triangulator.cpp — accumulate the DLT
normal matrix over views and take the smallest eigenvector (:87-117); accept
only if *every* view reprojects under tri_max_error_px (:38-51) and some
camera pair reaches tri_min_angle_deg of parallax (:53-79).

Device design: candidate tracks are padded to a fixed (B, T) window and the
whole batch triangulates + tests in one dispatch — per-track Python loops
never touch the device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from monocularsfm_tpu.config import TriangulatorConfig
from monocularsfm_tpu.geometry.triangulation import triangulate_n_view

_HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass
class TriangulatorStatistics:
    num_tried: int = 0
    num_triangulated: int = 0
    ave_residual: float = float("nan")  # NaN when zero tracks triangulate —
    # reproduces the reference quirk (MapBuilder.cpp:569, SURVEY.md quirks).


@functools.partial(jax.jit, static_argnames=())
def _triangulate_batch(K4, R, t, uv, valid, max_error_px, min_angle_deg):
    """R: (B,T,3,3), t: (B,T,3), uv: (B,T,2) pixels, valid: (B,T).

    Returns (X (B,3), accept (B,), max_err (B,))."""
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    xn = jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)
    X = triangulate_n_view(R, t, xn, valid)  # (B, 3)
    # Reprojection errors in all valid views.
    xc = jnp.einsum("btij,bj->bti", R, X, precision=_HIGHEST) + t
    z = xc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = fx * xc[..., 0] / zs + cx
    v = fy * xc[..., 1] / zs + cy
    err = jnp.sqrt((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2)
    err = jnp.where(valid, err, 0.0)
    err = jnp.where(valid & (z <= 0), 1e9, err)  # cheirality: all views front
    max_err = jnp.max(err, axis=-1)
    all_ok = max_err <= max_error_px

    # Pairwise parallax: some pair of valid views >= min angle.
    Cc = -jnp.einsum("btji,btj->bti", R, t, precision=_HIGHEST)  # centers
    d = X[:, None, :] - Cc                               # (B, T, 3)
    dn = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    cos = jnp.einsum("bti,bsi->bts", dn, dn, precision=_HIGHEST)
    ang = jnp.degrees(jnp.arccos(jnp.clip(cos, -1.0, 1.0)))
    ang = jnp.where(ang > 90.0, 180.0 - ang, ang)
    pair_ok = valid[:, :, None] & valid[:, None, :]
    T = valid.shape[1]
    not_self = ~jnp.eye(T, dtype=bool)[None]
    ang_ok = jnp.any(jnp.where(pair_ok & not_self, ang, 0.0) >= min_angle_deg, axis=(1, 2))

    accept = all_ok & ang_ok & (jnp.sum(valid, axis=-1) >= 2)
    mean_err = jnp.sum(err, axis=-1) / jnp.maximum(jnp.sum(valid, axis=-1), 1)
    return X, accept, mean_err


class Triangulator:
    def __init__(self, K: np.ndarray, config: TriangulatorConfig | None = None,
                 track_width: int = 16, batch_cap: int = 4096):
        self.K = np.asarray(K, np.float64)
        self.cfg = config or TriangulatorConfig()
        self.T = track_width
        self.batch_cap = batch_cap

    def triangulate_tracks(self, tracks, poses):
        """tracks: list of [(image_id, kpt_uv np(2,)), ...] as (ids, uvs).

        `tracks` is a list of lists of (image_id, uv); `poses` maps
        image_id -> (R, t).  Returns (X (n,3), accept (n,), mean_err (n,)).
        """
        n = len(tracks)
        if n == 0:
            return np.zeros((0, 3)), np.zeros(0, bool), np.zeros(0)
        stats_X = np.zeros((n, 3))
        stats_acc = np.zeros(n, bool)
        stats_err = np.zeros(n)
        K4 = jnp.asarray(
            [self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2]], jnp.float32
        )
        for start in range(0, n, self.batch_cap):
            chunk = tracks[start : start + self.batch_cap]
            B = _pad_batch(len(chunk))
            T = self.T
            R = np.tile(np.eye(3, dtype=np.float32), (B, T, 1, 1))
            t = np.zeros((B, T, 3), np.float32)
            uv = np.zeros((B, T, 2), np.float32)
            valid = np.zeros((B, T), bool)
            for b, tr in enumerate(chunk):
                for s, (image_id, uv_s) in enumerate(tr[:T]):
                    Rb, tb = poses[image_id]
                    R[b, s] = Rb
                    t[b, s] = tb
                    uv[b, s] = uv_s
                    valid[b, s] = True
            X, acc, err = _triangulate_batch(
                K4, jnp.asarray(R), jnp.asarray(t), jnp.asarray(uv),
                jnp.asarray(valid),
                jnp.float32(self.cfg.tri_max_error_px),
                jnp.float32(self.cfg.tri_min_angle_deg),
            )
            m = len(chunk)
            stats_X[start : start + m] = np.asarray(X)[:m]
            stats_acc[start : start + m] = np.asarray(acc)[:m]
            stats_err[start : start + m] = np.asarray(err)[:m]
        return stats_X, stats_acc, stats_err


def _pad_batch(n: int, minimum: int = 256) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap
