"""Two-view bootstrap: H/F model selection, pose recovery, initial points.

Reference parity: src/Reconstruction/Initializer.cpp —
  Initialize     (:21-74): RANSAC H (12 px) and F (4 px); F-path if
                 H/F inlier ratio < 0.7 && F inliers >= threshold, else H-path
                 (:54-64)
  F-path         (:306-413): essential re-estimation + recoverPose + per-
                 inlier DLT; accept if positive depth and reproj < 2 px;
                 success if >= 100 inliers, median & mean tri angle >= 4 deg,
                 mean residual <= 2 px
  H-path         (:168-296): decomposeHomographyMat, test all (R, t)
                 candidates, keep best by support
  Statistics + fail_reason (:465-487)

All RANSAC/scoring/triangulation happens on device in fixed shapes; this
module pads the correspondence set to a capacity bucket and interprets the
device outputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from monocularsfm_tpu.config import InitializerConfig
from monocularsfm_tpu.estimators import (
    estimate_fundamental_ransac,
    estimate_essential_ransac,
    estimate_homography_ransac,
    recover_pose_from_essential,
)
from monocularsfm_tpu.estimators.essential import pixels_to_normalized
from monocularsfm_tpu.estimators.homography import decompose_homography
from monocularsfm_tpu.geometry.triangulation import triangulate_two_view


@jax.jit
def _homography_motion(K, H, x1j, x2j, inl):
    """Whole H-path device computation in one jit: Euclidean homography,
    Faugeras decomposition, cheirality triangulation of all 4 candidates.

    One compiled dispatch instead of dozens of eager ops, each of which
    would compile separately and miss the persistent jit cache.
    Returns (xn1, xn2, Rs, ts, Xs, fronts, counts)."""
    Kinv = jnp.linalg.inv(K)
    H_euc = Kinv @ H.astype(jnp.float32) @ K
    Rs, ts, _ = decompose_homography(H_euc)
    xn1 = pixels_to_normalized(K, x1j)
    xn2 = pixels_to_normalized(K, x2j)
    eye = jnp.eye(3, dtype=jnp.float32)
    zero = jnp.zeros((3,), jnp.float32)

    def tri(R, t):
        X = triangulate_two_view(eye, zero, R, t, xn1, xn2)
        z1 = X[..., 2]
        z2 = (jnp.einsum("ij,nj->ni", R, X) + t)[..., 2]
        front = (z1 > 0) & (z2 > 0) & inl
        return X, front

    Xs, fronts = jax.vmap(tri)(Rs, ts)
    counts = jnp.sum(fronts, axis=1)
    return xn1, xn2, Rs, ts, Xs, fronts, counts


@jax.jit
def _normalize_pair(K, x1j, x2j):
    """pixels_to_normalized for both views in one dispatch (F path)."""
    return pixels_to_normalized(K, x1j), pixels_to_normalized(K, x2j)


@dataclasses.dataclass
class InitializerStatistics:
    is_succeed: bool = False
    method: str = ""            # "fundamental" | "homography"
    num_inliers: int = 0
    median_tri_angle: float = 0.0
    ave_tri_angle: float = 0.0
    ave_residual: float = 0.0
    fail_reason: str = "not attempted"


def _pad_cap(n: int, minimum: int = 512) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class Initializer:
    def __init__(self, K: np.ndarray, config: InitializerConfig | None = None):
        self.K = np.asarray(K, np.float64)
        self.cfg = config or InitializerConfig()
        self._key = jax.random.PRNGKey(42)

    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def _adaptive(self, run, sample_size: int, num_valid: int,
                  max_rounds: int | None = None):
        """Re-dispatch identically-shaped hypothesis rounds until the classic
        RANSAC termination bound meets `ransac_confidence` (the adaptive
        iteration count of cv::findHomography/findFundamentalMat, inverted
        into adaptive *continuation* for batch hardware).  Keeps the best
        round by inlier count."""
        from monocularsfm_tpu.estimators import (
            num_ransac_iterations, rounds_to_confidence,
        )

        if max_rounds is None:
            # Reach the reference's 10000-hypothesis ceiling
            # (Initializer.cpp:103-159) — initialization failure is
            # unrecoverable, so the confidence bound is always honored.
            max_rounds = max(
                1, -(-10000 // max(self.cfg.ransac_iterations, 1)))
        out = run(self._next_key())
        rounds = 1
        while rounds < rounds_to_confidence(
            self.cfg.ransac_confidence, int(out["num_inliers"]), num_valid,
            sample_size, self.cfg.ransac_iterations, max_rounds=max_rounds,
        ):
            out2 = run(self._next_key())
            if int(out2["num_inliers"]) > int(out["num_inliers"]):
                out = out2
            rounds += 1
        need = num_ransac_iterations(
            self.cfg.ransac_confidence,
            int(out["num_inliers"]) / max(num_valid, 1), sample_size,
        )
        if need > rounds * self.cfg.ransac_iterations:
            from monocularsfm_tpu.utils.caps import warn_cap

            warn_cap(
                "initializer RANSAC stopped at max_rounds=%d (%d hypotheses) "
                "with the %.4f confidence bound unmet (needs %d)",
                max_rounds, rounds * self.cfg.ransac_iterations,
                self.cfg.ransac_confidence, need,
            )
        return out

    def initialize(self, uv1: np.ndarray, uv2: np.ndarray):
        """Try to bootstrap from correspondences of one image pair.

        Returns (stats, R2, t2, points3d (M,3), inlier_corr_indices (M,))
        with camera 1 at identity; Nones on failure.
        """
        cfg = self.cfg
        stats = InitializerStatistics()
        n = len(uv1)
        if n < 8:
            stats.fail_reason = "too few correspondences"
            return stats, None, None, None, None
        cap = _pad_cap(n)
        x1 = np.zeros((cap, 2), np.float32)
        x2 = np.zeros((cap, 2), np.float32)
        m = np.zeros(cap, bool)
        x1[:n], x2[:n], m[:n] = uv1, uv2, True
        x1j, x2j, mj = jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(m)

        h_out = self._adaptive(
            lambda k: estimate_homography_ransac(
                k, x1j, x2j, mj,
                threshold_px=cfg.rel_pose_homography_error,
                num_hyps=cfg.ransac_iterations,
            ),
            sample_size=4, num_valid=n,
        )
        f_out = self._adaptive(
            lambda k: estimate_fundamental_ransac(
                k, x1j, x2j, mj,
                threshold_px=cfg.rel_pose_essential_error,
                num_hyps=cfg.ransac_iterations,
            ),
            sample_size=8, num_valid=n,
        )
        h_inl = int(h_out["num_inliers"])
        f_inl = int(f_out["num_inliers"])
        # Model selection (Initializer.cpp:54-64).
        use_f = (
            f_inl >= cfg.init_min_num_inliers
            and h_inl / max(f_inl, 1) < cfg.homography_ratio_threshold
        )
        if use_f:
            return self._pose_from_fundamental(stats, x1j, x2j, f_out)
        return self._pose_from_homography(stats, x1j, x2j, h_out, h_inl)

    # -- F path --------------------------------------------------------------
    def _pose_from_fundamental(self, stats, x1j, x2j, f_out):
        cfg = self.cfg
        stats.method = "fundamental"
        K = jnp.asarray(self.K.astype(np.float32))
        xn1, xn2 = _normalize_pair(K, x1j, x2j)
        focal = float(self.K[0, 0])
        # Re-estimate E on the F-inliers (deliberately not E = K^T F K — the
        # reference documents the same choice, Initializer.cpp:306-309).
        e_out = self._adaptive(
            lambda k: estimate_essential_ransac(
                k, xn1, xn2, f_out["inliers"],
                threshold_norm=cfg.rel_pose_essential_error / focal,
                num_hyps=cfg.ransac_iterations,
            ),
            sample_size=8, num_valid=int(f_out["num_inliers"]),
        )
        if int(e_out["num_inliers"]) < 8:
            stats.fail_reason = "essential estimation failed"
            return stats, None, None, None, None
        R, t, X, front = recover_pose_from_essential(
            e_out["E"], xn1, xn2, e_out["inliers"]
        )
        return self._finish(stats, R, t, X, front, xn1, xn2)

    # -- H path --------------------------------------------------------------
    def _pose_from_homography(self, stats, x1j, x2j, h_out, h_inl):
        cfg = self.cfg
        stats.method = "homography"
        if h_inl < cfg.init_min_num_inliers:
            stats.num_inliers = h_inl
            stats.fail_reason = "too few homography inliers"
            return stats, None, None, None, None
        K = jnp.asarray(self.K.astype(np.float32))
        xn1, xn2, Rs, ts, Xs, fronts, counts = _homography_motion(
            K, h_out["H"], x1j, x2j, h_out["inliers"]
        )
        best = int(np.argmax(np.asarray(counts)))
        return self._finish(
            stats, Rs[best], ts[best], Xs[best], fronts[best], xn1, xn2
        )

    # -- shared acceptance ----------------------------------------------------
    def _finish(self, stats, R, t, X, front, xn1, xn2):
        """Per-point accept tests + global success criteria
        (Initializer.cpp:400-413)."""
        cfg = self.cfg
        R_np = np.asarray(R, np.float64)
        t_np = np.asarray(t, np.float64).reshape(3)
        X_np = np.asarray(X, np.float64)
        front_np = np.asarray(front)

        # Reprojection residuals in pixels (both views).
        fx, fy = self.K[0, 0], self.K[1, 1]
        xn1_np = np.asarray(xn1, np.float64)
        xn2_np = np.asarray(xn2, np.float64)
        z1 = X_np[:, 2]
        z1s = np.where(np.abs(z1) < 1e-9, 1e-9, z1)
        p1 = X_np[:, :2] / z1s[:, None]
        xc2 = X_np @ R_np.T + t_np
        z2 = xc2[:, 2]
        z2s = np.where(np.abs(z2) < 1e-9, 1e-9, z2)
        p2 = xc2[:, :2] / z2s[:, None]
        r1 = np.linalg.norm((p1 - xn1_np) * [fx, fy], axis=1)
        r2 = np.linalg.norm((p2 - xn2_np) * [fx, fy], axis=1)
        resid = 0.5 * (r1 + r2)
        ok = front_np & (resid < cfg.init_max_error)

        # Parallax angles.
        C1 = np.zeros(3)
        C2 = -R_np.T @ t_np
        d1 = X_np - C1
        d2 = X_np - C2
        cos = np.sum(d1 * d2, axis=1) / np.maximum(
            np.linalg.norm(d1, axis=1) * np.linalg.norm(d2, axis=1), 1e-12
        )
        ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
        ang = np.where(ang > 90, 180 - ang, ang)

        num_inl = int(ok.sum())
        stats.num_inliers = num_inl
        if num_inl < cfg.init_min_num_inliers:
            stats.fail_reason = "too few triangulated inliers"
            return stats, None, None, None, None
        stats.median_tri_angle = float(np.median(ang[ok]))
        stats.ave_tri_angle = float(np.mean(ang[ok]))
        stats.ave_residual = float(np.mean(resid[ok]))
        if (
            stats.median_tri_angle < cfg.init_min_tri_angle_deg
            or stats.ave_tri_angle < cfg.init_min_tri_angle_deg
        ):
            stats.fail_reason = "insufficient triangulation angle"
            return stats, None, None, None, None
        if stats.ave_residual > cfg.init_max_residual_px:
            stats.fail_reason = "mean residual too large"
            return stats, None, None, None, None
        stats.is_succeed = True
        stats.fail_reason = ""
        idx = np.nonzero(ok)[0]
        return stats, R_np, t_np, X_np[idx], idx
