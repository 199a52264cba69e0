"""Batched 8-point fundamental-matrix estimation with RANSAC.

Reference parity: the reference calls cv::findFundamentalMat (RANSAC, 4 px,
conf 0.9999) in Initializer::FindFundanmental (Initializer.cpp:131-159) and
with 3 px in FeatureUtils::FilterMatches (FeatureUtils.cpp:176-206).

Device design: M hypotheses are solved simultaneously — Hartley
normalisation, the 8x9 nullspace via A^T A + batched eigh (cheaper and more
matmul-friendly than batched SVD of tall A), rank-2 enforcement via batched SVD
of the 3x3 F — then all M x N Sampson residuals in one pass.  A final
least-squares refit on the winner's inliers (masked A^T A, one eigh)
replicates OpenCV's LMedS-polish effect.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from monocularsfm_tpu.estimators.ransac import sample_minimal_sets, score_hypotheses
from monocularsfm_tpu.utils.precision import mm

_HIGHEST = jax.lax.Precision.HIGHEST


def _hartley_normalize(x: jnp.ndarray, mask: jnp.ndarray):
    """Similarity transform sending masked points to mean 0, RMS sqrt(2).

    x: (N, 2), mask: (N,). Returns (x_norm (N,2), T (3,3))."""
    w = mask.astype(x.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(x * w[:, None], axis=0) / n
    d = jnp.sqrt(jnp.sum(jnp.sum((x - mean) ** 2, axis=1) * w) / n)
    s = jnp.sqrt(2.0) / jnp.maximum(d, 1e-12)
    T = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], x.dtype)
    T = T.at[0, 0].set(s).at[1, 1].set(s).at[0, 2].set(-s * mean[0]).at[1, 2].set(-s * mean[1])
    return (x - mean) * s, T


def _eight_point_rows(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """Epipolar constraint rows x2^T F x1 = 0. x1/x2: (..., 2) -> (..., 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = jnp.ones_like(u1)
    return jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=-1
    )


def _solve_nullspace_9(A_rows: jnp.ndarray, weights: jnp.ndarray | None = None):
    """Smallest eigenvector of sum_r w_r a_r a_r^T. A_rows: (..., R, 9)."""
    if weights is not None:
        A_rows = A_rows * weights[..., None]
    AtA = jnp.einsum("...ri,...rj->...ij", A_rows, A_rows, precision=_HIGHEST)
    _, V = jnp.linalg.eigh(AtA)
    return V[..., :, 0]


def _enforce_rank2(F: jnp.ndarray) -> jnp.ndarray:
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[..., 2].set(0.0)
    return mm(U, S[..., :, None] * Vt)


def sampson_distance(F: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """Squared Sampson distance. F: (..., 3, 3), x1/x2: (..., N, 2) -> (..., N)."""
    ones = jnp.ones(x1.shape[:-1] + (1,), x1.dtype)
    x1h = jnp.concatenate([x1, ones], axis=-1)
    x2h = jnp.concatenate([x2, ones], axis=-1)
    Fx1 = jnp.einsum("...ij,...nj->...ni", F, x1h, precision=_HIGHEST)
    Ftx2 = jnp.einsum("...ji,...nj->...ni", F, x2h, precision=_HIGHEST)
    num = jnp.sum(x2h * Fx1, axis=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def _fit_f(x1n, x2n, idx=None, weights=None):
    """Fit F from normalized correspondences (optionally a minimal subset)."""
    if idx is not None:
        x1n = x1n[idx]
        x2n = x2n[idx]
    rows = _eight_point_rows(x1n, x2n)
    f = _solve_nullspace_9(rows, weights)
    F = f.reshape(f.shape[:-1] + (3, 3))
    return _enforce_rank2(F)


@functools.partial(jax.jit, static_argnames=("num_hyps",))
def estimate_fundamental_ransac(
    key: jax.Array,
    x1: jnp.ndarray,
    x2: jnp.ndarray,
    mask: jnp.ndarray,
    threshold_px: float | jnp.ndarray = 4.0,
    num_hyps: int = 2048,
):
    """RANSAC 8-point F. x1/x2: (N, 2) pixels, mask: (N,) validity.

    Returns dict with F (3,3), inliers bool (N,), num_inliers, success.
    Thresholding uses squared Sampson distance against threshold_px^2 —
    OpenCV's reprojection-style threshold semantics.
    """
    x1 = x1.astype(jnp.float32)
    x2 = x2.astype(jnp.float32)
    x1n, T1 = _hartley_normalize(x1, mask)
    x2n, T2 = _hartley_normalize(x2, mask)

    n = x1.shape[0]
    sets = sample_minimal_sets(key, num_hyps, n, 8, mask)
    F_n = jax.vmap(lambda idx: _fit_f(x1n, x2n, idx))(sets)  # (M, 3, 3) normalized frame
    # Denormalise: F = T2^T F_n T1; residuals in pixel units.
    F_px = jnp.einsum("ji,mjk,kl->mil", T2, F_n, T1, precision=_HIGHEST)
    res = sampson_distance(F_px, x1[None], x2[None])  # (M, N)
    thr2 = jnp.asarray(threshold_px) ** 2
    best, inl, counts = score_hypotheses(res, mask, thr2)
    F_best = F_px[best]

    # Local optimisation: two reweighted least-squares refits on the inliers.
    def refit(F, _):
        r = sampson_distance(F[None], x1[None], x2[None])[0]
        w = ((r <= thr2) & mask).astype(jnp.float32)
        Fn = _fit_f(x1n, x2n, weights=w)
        F2 = mm(T2.T, Fn, T1)
        # Keep the refit only if it does not lose inliers.
        c_new = jnp.sum((sampson_distance(F2[None], x1[None], x2[None])[0] <= thr2) & mask)
        c_old = jnp.sum((sampson_distance(F[None], x1[None], x2[None])[0] <= thr2) & mask)
        return jnp.where(c_new >= c_old, F2, F), None

    F_best, _ = jax.lax.scan(refit, F_best, None, length=2)
    res_best = sampson_distance(F_best[None], x1[None], x2[None])[0]
    inliers = (res_best <= thr2) & mask
    num_inl = jnp.sum(inliers)
    # Normalise scale for determinism (F is homogeneous).
    F_best = F_best / jnp.maximum(jnp.linalg.norm(F_best), 1e-12)
    return {
        "F": F_best,
        "inliers": inliers,
        "num_inliers": num_inl,
        "success": num_inl >= 8,
    }


@functools.partial(jax.jit, static_argnames=("num_hyps",))
def estimate_fundamental_ransac_batch(
    key: jax.Array,
    x1: jnp.ndarray,
    x2: jnp.ndarray,
    mask: jnp.ndarray,
    threshold_px: float | jnp.ndarray = 4.0,
    num_hyps: int = 2048,
):
    """F-RANSAC over a slab of pairs in ONE dispatch.

    x1/x2: (B, N, 2) pixels, mask: (B, N).  vmaps the single-pair estimator
    so geometric verification of a whole match batch costs one XLA program
    (the reference loops cv::findFundamentalMat per pair,
    FeatureMatching.cpp:49-60; here the loop is the batch dimension).
    Returns the same dict with a leading B axis on every entry.
    """
    keys = jax.random.split(key, x1.shape[0])
    return jax.vmap(
        lambda k, a, b, m: estimate_fundamental_ransac(
            k, a, b, m, threshold_px=threshold_px, num_hyps=num_hyps
        )
    )(keys, x1, x2, mask)
