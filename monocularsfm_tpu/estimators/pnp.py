"""Batched PnP (absolute pose from 2D-3D matches) with RANSAC + GN polish.

Reference parity: Registrant::Register wraps cv::solvePnPRansac (P3P/AP3P/
EPNP/UPNP — with the EPNP enum quirk dispatching UPNP, Registrant.cpp:52-57),
thresholds >= 15 inliers / 4 px / conf 0.9999 (Registrant.h:22-27), and
Rodrigues conversion of the result (:96-97).

Device design, two minimal solvers behind one RANSAC harness:

* "p6p" — 6-point DLT (linear resection): a 12x12 eigh per hypothesis,
  batches perfectly.
* "epnp" — 5-point EPnP (Lepetit et al. 2009, the solver family the
  reference's cv::solvePnPRansac draws from): barycentric coordinates w.r.t.
  4 control points, 12x12 eigh null space (5 points -> a 2-dimensional null
  space, exactly what the N=1/N=2 beta cases span), betas refined by a
  fixed-iteration Gauss-Newton on the 6 control-point distance constraints,
  pose via Procrustes — every step batched linear algebra.  Each sample
  yields TWO candidate models (both beta cases); scoring over all N points
  picks the winner, so the case selection OpenCV does by reprojection falls
  out of the ordinary RANSAC scoring pass.  The 5-point sample is ~1/w more
  likely to be all-inlier per draw than a 6-point DLT sample at inlier
  ratio w.

The winning hypothesis is polished by a fixed-iteration Gauss-Newton on its
inliers (the role of the iterative refinement inside solvePnPRansac).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from monocularsfm_tpu.estimators.ransac import sample_minimal_sets, score_hypotheses
from monocularsfm_tpu.geometry.rotations import (
    angle_axis_to_matrix,
    matrix_to_angle_axis,
)
from monocularsfm_tpu.utils.precision import mm

_HIGHEST = jax.lax.Precision.HIGHEST


def _p6p_rows(X: jnp.ndarray, xn: jnp.ndarray) -> jnp.ndarray:
    """DLT resection rows. X: (..., 3) world, xn: (..., 2) normalized image.

    Returns (..., 2, 12) rows of A p = 0 with p = vec(P) row-major."""
    u, v = xn[..., 0], xn[..., 1]
    one = jnp.ones_like(u)
    zero = jnp.zeros_like(u)
    Xh = jnp.concatenate([X, one[..., None]], axis=-1)  # (..., 4)
    z4 = jnp.stack([zero] * 4, axis=-1)
    r0 = jnp.concatenate([Xh, z4, -u[..., None] * Xh], axis=-1)
    r1 = jnp.concatenate([z4, Xh, -v[..., None] * Xh], axis=-1)
    return jnp.stack([r0, r1], axis=-2)


def _fit_p6p(X, xn, idx=None, weights=None):
    """Linear resection -> (R (3,3), t (3)). Batched over leading dims of idx."""
    if idx is not None:
        X = X[idx]
        xn = xn[idx]
    rows = _p6p_rows(X, xn).reshape((-1, 12)) if idx is not None else _p6p_rows(X, xn)
    if rows.ndim > 2:
        rows = rows.reshape(rows.shape[:-3] + (-1, 12))
    if weights is not None:
        w = jnp.repeat(weights, 2, axis=-1)
        rows = rows * w[..., None]
    AtA = jnp.einsum("...ri,...rj->...ij", rows, rows, precision=_HIGHEST)
    _, V = jnp.linalg.eigh(AtA)
    p = V[..., :, 0]
    P = p.reshape(p.shape[:-1] + (3, 4))
    M = P[..., :, :3]
    # Procrustes projection of M onto SO(3), recovering scale + sign.
    U, S, Vt = jnp.linalg.svd(M)
    detUV = jnp.linalg.det(mm(U, Vt))
    D = jnp.ones(S.shape, S.dtype).at[..., 2].set(jnp.sign(detUV))
    R = mm(U, D[..., :, None] * Vt)
    scale = jnp.mean(S * D, axis=-1)
    scale = jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    t = P[..., :, 3] / scale[..., None]
    return R, t


def _fit_upnp6(X, uvc, idx=None):
    """Unknown-focal resection from 6 points (the UPNP role of
    cv::solvePnPRansac, Registrant.cpp:52-63).

    uvc: principal-point-centred pixels (u-cx, v-cy).  Solves the DLT for
    M = s*diag(f,f,1)[R|t] and peels the focal off the row norms: with
    row3 = s*R3 (unit R3), s = ||m3|| and f = mean(||m1||,||m2||)/s; the
    rotation is the Procrustes projection of diag(1/f,1/f,1) @ M onto
    SO(3).  Returns (R (3,3), t (3), f scalar), batched over idx's leading
    dims."""
    if idx is not None:
        X = X[idx]
        uvc = uvc[idx]
    rows = _p6p_rows(X, uvc)
    rows = rows.reshape(rows.shape[:-3] + (-1, 12))
    AtA = jnp.einsum("...ri,...rj->...ij", rows, rows, precision=_HIGHEST)
    _, V = jnp.linalg.eigh(AtA)
    p = V[..., :, 0]
    P = p.reshape(p.shape[:-1] + (3, 4))
    M = P[..., :, :3]
    s = jnp.linalg.norm(M[..., 2, :], axis=-1)
    s = jnp.where(s < 1e-12, 1e-12, s)
    f = 0.5 * (
        jnp.linalg.norm(M[..., 0, :], axis=-1)
        + jnp.linalg.norm(M[..., 1, :], axis=-1)
    ) / s
    f = jnp.where(f < 1e-6, 1e-6, f)
    invK = jnp.stack([1.0 / f, 1.0 / f, jnp.ones_like(f)], axis=-1)
    Mn = invK[..., :, None] * M
    U, S, Vt = jnp.linalg.svd(Mn)
    detUV = jnp.linalg.det(mm(U, Vt))
    D = jnp.ones(S.shape, S.dtype).at[..., 2].set(jnp.sign(detUV))
    R = mm(U, D[..., :, None] * Vt)
    scale = jnp.mean(S * D, axis=-1)
    scale = jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    t = invK * P[..., :, 3] / scale[..., None]
    return R, t, f


_CTRL_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _procrustes_pose(Xw: jnp.ndarray, Xc: jnp.ndarray):
    """Rigid R, t with R @ Xw + t ~= Xc (Horn's method). Xw/Xc: (n, 3)."""
    cw = jnp.mean(Xw, axis=0)
    cc = jnp.mean(Xc, axis=0)
    H = jnp.einsum(
        "ni,nj->ij", Xw - cw, Xc - cc, precision=_HIGHEST
    )  # world x camera
    U, _, Vt = jnp.linalg.svd(H)
    D = jnp.diag(
        jnp.array([1.0, 1.0, 1.0], H.dtype)
    ).at[2, 2].set(jnp.sign(jnp.linalg.det(mm(Vt.T, U.T))))
    R = mm(Vt.T, D, U.T)
    t = cc - mm(R, cw)
    return R, t


def _fit_epnp5(X, xn, idx):
    """EPnP on a 5-point sample -> two candidate (R, t) models (beta cases
    N=1 and N=2, each Gauss-Newton-refined on the distance constraints).
    Returns (R (2,3,3), t (2,3))."""
    Xs = X[idx]   # (5, 3)
    xs = xn[idx]  # (5, 2) normalized image coords

    # Control points: centroid + principal directions (planar samples keep a
    # tiny extent along the normal so the barycentric system stays solvable;
    # degenerate samples just produce losing hypotheses).
    c0 = jnp.mean(Xs, axis=0)
    A = Xs - c0
    lam, v = jnp.linalg.eigh(mm(A.T, A))  # ascending
    s = jnp.sqrt(jnp.maximum(lam, 1e-10) / Xs.shape[0])
    ctrl = jnp.concatenate([c0[None], c0[None] + s[:, None] * v.T], axis=0)

    # Barycentric coordinates of the sample points w.r.t. the control points.
    Ch = jnp.concatenate([ctrl.T, jnp.ones((1, 4), Xs.dtype)], axis=0)
    Xh = jnp.concatenate([Xs, jnp.ones((Xs.shape[0], 1), Xs.dtype)], axis=1).T
    Ch = Ch + 1e-10 * jnp.eye(4, dtype=Xs.dtype)
    alphas = jnp.linalg.solve(Ch, Xh).T  # (n pts, 4 ctrl)

    # M x = 0 over camera-frame control-point coordinates x (12,).
    u, w = xs[:, 0], xs[:, 1]
    npts = Xs.shape[0]
    zero = jnp.zeros_like(alphas)
    ru = jnp.stack([alphas, zero, -alphas * u[:, None]], axis=-1).reshape(npts, 12)
    rv = jnp.stack([zero, alphas, -alphas * w[:, None]], axis=-1).reshape(npts, 12)
    M = jnp.concatenate([ru, rv], axis=0)  # (2n, 12)
    _, V = jnp.linalg.eigh(
        jnp.einsum("ri,rj->ij", M, M, precision=_HIGHEST)
    )
    vk = V[:, :2].T.reshape(2, 4, 3)  # two smallest null-space vectors

    # Pairwise control-point distance constraints.
    ii = jnp.array([p[0] for p in _CTRL_PAIRS])
    jj = jnp.array([p[1] for p in _CTRL_PAIRS])
    dw2 = jnp.sum((ctrl[ii] - ctrl[jj]) ** 2, axis=-1)  # (6,)
    dv = vk[:, ii] - vk[:, jj]                           # (2, 6, 3)

    # Case N=1: scale of v1 alone (least squares on distances).
    n1 = jnp.sqrt(jnp.maximum(jnp.sum(dv[0] ** 2, axis=-1), 1e-12))
    beta_c1 = jnp.sum(n1 * jnp.sqrt(dw2)) / jnp.maximum(jnp.sum(n1**2), 1e-12)
    betas1 = jnp.array([beta_c1, 0.0], dw2.dtype)

    # Case N=2: solve [b1^2, b1 b2, b2^2] from the 6 linear constraints.
    d11 = jnp.sum(dv[0] * dv[0], axis=-1)
    d12 = jnp.sum(dv[0] * dv[1], axis=-1)
    d22 = jnp.sum(dv[1] * dv[1], axis=-1)
    L = jnp.stack([d11, 2.0 * d12, d22], axis=-1)  # (6, 3)
    LtL = mm(L.T, L) + 1e-10 * jnp.eye(3, dtype=L.dtype)
    b = jnp.linalg.solve(LtL, mm(L.T, dw2))
    b1 = jnp.sqrt(jnp.abs(b[0]))
    b2 = jnp.sign(b[1]) * jnp.sqrt(jnp.abs(b[2]))
    betas2 = jnp.array([b1, b2], dw2.dtype)

    def gn_refine(betas):
        # Minimise sum_p (||sum_k beta_k dv_k||^2 - dw2_p)^2 over the betas.
        def step(bs, _):
            diff = jnp.einsum("k,kpi->pi", bs, dv)          # (6, 3)
            r = jnp.sum(diff**2, axis=-1) - dw2             # (6,)
            J = 2.0 * jnp.einsum("pi,kpi->pk", diff, dv)    # (6, 2)
            JtJ = mm(J.T, J) + 1e-8 * jnp.eye(2, dtype=J.dtype)
            new = bs - jnp.linalg.solve(JtJ, mm(J.T, r))
            return jnp.where(jnp.all(jnp.isfinite(new)), new, bs), None
        out, _ = jax.lax.scan(step, betas, None, length=5)
        return out

    def pose_from_betas(betas):
        cc = jnp.einsum("k,kij->ij", betas, vk)  # camera-frame ctrl (4, 3)
        pc = mm(alphas, cc)                       # camera-frame sample points
        # EPnP sign convention: points must sit in front of the camera.
        flip = jnp.where(jnp.mean(pc[:, 2]) < 0.0, -1.0, 1.0)
        return _procrustes_pose(Xs, pc * flip)

    R1, t1 = pose_from_betas(gn_refine(betas1))
    R2, t2 = pose_from_betas(gn_refine(betas2))
    return jnp.stack([R1, R2]), jnp.stack([t1, t2])


def _quartic_roots(a3, a2, a1, a0, dk_iters: int = 40,
                   newton_iters: int = 3):
    """All (up to 4) real roots of v^4 + a3 v^3 + a2 v^2 + a1 v + a0.

    Durand-Kerner simultaneous iteration in complex64 — branch-free, batched
    and, unlike an f32 Ferrari factorisation, robust when roots cluster (a
    clustered-root Ferrari loses real roots to cancellation in the resolvent
    split, which silently drops valid P3P poses).  Real roots are polished
    with a few Newton steps on the original quartic.
    Returns (roots (..., 4), valid (..., 4))."""
    c3 = a3.astype(jnp.complex64)
    c2 = a2.astype(jnp.complex64)
    c1 = a1.astype(jnp.complex64)
    c0 = a0.astype(jnp.complex64)

    def poly(z):
        return (((z + c3[..., None]) * z + c2[..., None]) * z
                + c1[..., None]) * z + c0[..., None]

    # Cauchy bound scaled initial ring, rotationally asymmetric (0.4+0.9i).
    bound = 1.0 + jnp.maximum(
        jnp.maximum(jnp.abs(a3), jnp.abs(a2)),
        jnp.maximum(jnp.abs(a1), jnp.abs(a0)),
    )
    seed = jnp.asarray(0.4 + 0.9j, jnp.complex64) ** jnp.arange(1, 5)
    z = bound[..., None].astype(jnp.complex64) * seed

    def dk_body(z, _):
        pz = poly(z)
        diff = z[..., :, None] - z[..., None, :]
        diff = diff + jnp.eye(4, dtype=z.dtype)  # self-diff -> 1
        denom = jnp.prod(diff, axis=-1)
        denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
        return z - pz / denom, None

    z, _ = jax.lax.scan(dk_body, z, None, length=dk_iters)
    real_ok = jnp.abs(z.imag) <= 1e-3 * (1.0 + jnp.abs(z.real))
    roots = z.real

    def newton_body(roots, _):
        f = (((roots + a3[..., None]) * roots + a2[..., None]) * roots
             + a1[..., None]) * roots + a0[..., None]
        df = ((4.0 * roots + 3.0 * a3[..., None]) * roots
              + 2.0 * a2[..., None]) * roots + a1[..., None]
        df = jnp.where(jnp.abs(df) < 1e-12, 1e-12, df)
        return roots - f / df, None

    roots, _ = jax.lax.scan(newton_body, roots, None, length=newton_iters)
    return roots, real_ok & jnp.isfinite(roots)


def _fit_p3p(X, xn, idx):
    """Grunert P3P on a 3-point sample -> up to four candidate (R, t).

    Reference parity: the reference's Registrant enum offers SOLVEPNP_P3P
    (src/Reconstruction/Registrant.cpp:52-57); this is the batched device
    equivalent — closed-form quartic (Haralick et al. 1994 review,
    Grunert 1841 formulation), every branch mask-based, candidates competing
    in the ordinary RANSAC scoring pass (which also supplies the 4th-point
    disambiguation cv::solveP3P leaves to the caller).
    Returns (R (4, 3, 3), t (4, 3)); failed roots yield non-finite poses
    that score zero inliers."""
    Xs = X[idx]                                  # (3, 3)
    xs = xn[idx]                                 # (3, 2)
    f = jnp.concatenate([xs, jnp.ones((3, 1), xs.dtype)], axis=1)
    f = f / jnp.linalg.norm(f, axis=1, keepdims=True)   # unit bearings

    A = jnp.sum((Xs[1] - Xs[2]) ** 2)            # a^2 (opposite P1)
    B = jnp.sum((Xs[0] - Xs[2]) ** 2)            # b^2
    C = jnp.sum((Xs[0] - Xs[1]) ** 2)            # c^2
    # Elementwise sums, NOT jnp.dot: a contraction may run at reduced
    # precision (TF32 on a GPU, bf16 elsewhere) and noisy cosines wreck the
    # quartic.
    p2 = 2.0 * jnp.sum(f[1] * f[2])              # 2 cos(alpha)
    q2 = 2.0 * jnp.sum(f[0] * f[2])              # 2 cos(beta)
    r2 = 2.0 * jnp.sum(f[0] * f[1])              # 2 cos(gamma)

    Bs = jnp.where(jnp.abs(B) < 1e-12, 1e-12, B)
    k = (A - C) / Bs
    m = C / Bs
    # u = N(v)/D(v) with N = (k-1)v^2 - k q v + (k+1), D = r - p v; the
    # second Grunert equation then gives the quartic
    #   N^2 - r N D + D^2 (1 - m - m v^2 + m q v) = 0.
    n2, n1, n0 = k - 1.0, -k * q2, k + 1.0
    d1, d0 = -p2, r2
    e2, e1, e0 = -m, m * q2, 1.0 - m
    # Polynomial products (coefficients by descending degree).
    nn = jnp.stack([n2 * n2, 2 * n2 * n1, 2 * n2 * n0 + n1 * n1,
                    2 * n1 * n0, n0 * n0])                       # N^2, deg 4
    nd = jnp.stack([n2 * d1, n2 * d0 + n1 * d1,
                    n1 * d0 + n0 * d1, n0 * d0])                 # N D, deg 3
    dd = jnp.stack([d1 * d1, 2 * d1 * d0, d0 * d0])              # D^2, deg 2
    dde = jnp.stack([
        dd[0] * e2,
        dd[0] * e1 + dd[1] * e2,
        dd[0] * e0 + dd[1] * e1 + dd[2] * e2,
        dd[1] * e0 + dd[2] * e1,
        dd[2] * e0,
    ])                                                           # deg 4
    c4 = nn[0] + dde[0]
    c3 = nn[1] - r2 * nd[0] + dde[1]
    c2 = nn[2] - r2 * nd[1] + dde[2]
    c1 = nn[3] - r2 * nd[2] + dde[3]
    c0 = nn[4] - r2 * nd[3] + dde[4]
    c4s = jnp.where(jnp.abs(c4) < 1e-12, 1e-12, c4)
    v_roots, v_ok = _quartic_roots(c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s)

    def pose_from_v(v, ok):
        D = r2 - p2 * v
        Ds = jnp.where(jnp.abs(D) < 1e-9, 1e-9, D)
        u = ((k - 1.0) * v * v - k * q2 * v + (k + 1.0)) / Ds
        denom = 1.0 + v * v - q2 * v
        denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
        s1 = jnp.sqrt(jnp.maximum(B / denom, 0.0))
        s = jnp.stack([s1, u * s1, v * s1])
        ok = ok & jnp.all(s > 1e-9)
        pc = s[:, None] * f                       # camera-frame points (3,3)
        R, t = _procrustes_pose(Xs, pc)
        return (jnp.where(ok, R, jnp.full((3, 3), jnp.nan, R.dtype)),
                jnp.where(ok, t, jnp.full((3,), jnp.nan, t.dtype)))

    R4, t4 = jax.vmap(pose_from_v)(v_roots, v_ok)
    return R4, t4


def _reproj_err_px(K, R, t, X, uv):
    xc = jnp.einsum("...ij,...nj->...ni", R, X, precision=_HIGHEST) + t[..., None, :]
    z = xc[..., 2]
    behind = z <= 1e-6
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = K[0, 0] * xc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * xc[..., 1] / zs + K[1, 2]
    err2 = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
    # Points behind the camera are never inliers.
    return jnp.where(behind, 1e18, err2)


@functools.partial(
    jax.jit, static_argnames=("num_hyps", "refine_iters", "method")
)
def estimate_pnp_ransac(
    key: jax.Array,
    K: jnp.ndarray,
    X: jnp.ndarray,
    uv: jnp.ndarray,
    mask: jnp.ndarray,
    threshold_px: float | jnp.ndarray = 4.0,
    num_hyps: int = 4096,
    refine_iters: int = 10,
    method: str = "p6p",
):
    """RANSAC PnP (minimal solver per `method`) + Gauss-Newton polish.

    X: (N, 3) world points; uv: (N, 2) pixels; mask: (N,) validity.
    method: "p6p" (6-point DLT) | "epnp" (5-point EPnP, two beta-case
    models per sample) | "p3p" (3-point Grunert quartic, up to four
    models per sample; the minimal sample maximises the all-inlier
    probability per hypothesis at low inlier ratios).  Returns dict(R, t,
    angle_axis, inliers, num_inliers, success, mean_inlier_error_px).
    """
    X = X.astype(jnp.float32)
    uv = uv.astype(jnp.float32)
    fx, fy = K[0, 0], K[1, 1]
    xn = jnp.stack([(uv[:, 0] - K[0, 2]) / fx, (uv[:, 1] - K[1, 2]) / fy], axis=-1)

    n = X.shape[0]
    thr2 = jnp.asarray(threshold_px) ** 2
    K_eff = K
    if method == "epnp":
        sets = sample_minimal_sets(key, num_hyps, n, 5, mask)
        R, t = jax.vmap(lambda idx: _fit_epnp5(X, xn, idx))(sets)
        R = R.reshape(-1, 3, 3)  # (2*M, 3, 3): both beta cases compete
        t = t.reshape(-1, 3)
    elif method in ("p3p", "ap3p"):
        # AP3P (Ke & Roumeliotis 2017) is an algebraically different route
        # to the same up-to-4 solution set as Grunert's P3P; one batched
        # quartic solver serves both enum values (Registrant.cpp:46-50).
        sets = sample_minimal_sets(key, num_hyps, n, 3, mask)
        R, t = jax.vmap(lambda idx: _fit_p3p(X, xn, idx))(sets)
        R = R.reshape(-1, 3, 3)  # (4*M, 3, 3): all quartic roots compete
        t = t.reshape(-1, 3)
    elif method == "p6p":
        sets = sample_minimal_sets(key, num_hyps, n, 6, mask)
        R, t = jax.vmap(lambda idx: _fit_p6p(X, xn, idx))(sets)  # (M,3,3), (M,3)
    elif method == "upnp":
        # Unknown-focal resection: each hypothesis carries its own focal and
        # is scored with it; the winner's focal replaces K's for the polish.
        # (The reference's EPNP enum *also* dispatches cv::SOLVEPNP_UPNP —
        # Registrant.cpp:52-57 — but OpenCV >= 3.3 internally falls back to
        # EPnP for UPNP, so our "epnp" matches the reference's actual
        # behavior and "upnp" implements what the enum advertises.)
        uvc = jnp.stack([uv[:, 0] - K[0, 2], uv[:, 1] - K[1, 2]], axis=-1)
        sets = sample_minimal_sets(key, num_hyps, n, 6, mask)
        R, t, f_hyp = jax.vmap(lambda idx: _fit_upnp6(X, uvc, idx))(sets)
        xc = jnp.einsum(
            "mij,nj->mni", R, X, precision=_HIGHEST) + t[:, None, :]
        z = xc[..., 2]
        behind = z <= 1e-6
        zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        u = f_hyp[:, None] * xc[..., 0] / zs + K[0, 2]
        v = f_hyp[:, None] * xc[..., 1] / zs + K[1, 2]
        err2 = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
        err2 = jnp.where(behind, 1e18, err2)
        best, inl_best, counts = score_hypotheses(err2, mask, thr2)
        f_best = f_hyp[best]
        K_eff = K.at[0, 0].set(f_best).at[1, 1].set(f_best)
        fx = fy = f_best
    else:
        raise ValueError(f"unknown pnp method {method!r}")
    if method != "upnp":
        err2 = _reproj_err_px(K, R, t, X[None], uv[None])  # (M, N)
        best, inl_best, counts = score_hypotheses(err2, mask, thr2)
    K = K_eff
    R_best, t_best = R[best], t[best]

    # Gauss-Newton polish on the winner's inliers, in angle-axis + t.
    aa0 = matrix_to_angle_axis(R_best)
    params0 = jnp.concatenate([aa0, t_best])

    def residuals(params, w):
        Rp = angle_axis_to_matrix(params[:3])
        xc = jnp.einsum("ij,nj->ni", Rp, X, precision=_HIGHEST) + params[3:]
        z = jnp.where(jnp.abs(xc[:, 2]) < 1e-6, 1e-6, xc[:, 2])
        u = fx * xc[:, 0] / z + K[0, 2]
        v = fy * xc[:, 1] / z + K[1, 2]
        r = jnp.stack([u - uv[:, 0], v - uv[:, 1]], axis=-1) * w[:, None]
        return r.reshape(-1)

    def gn_step(params, _):
        w = (
            (_reproj_err_px(K, angle_axis_to_matrix(params[:3]), params[3:], X, uv) <= thr2)
            & mask
        ).astype(jnp.float32)
        J = jax.jacfwd(residuals)(params, w)  # (2N, 6)
        r = residuals(params, w)
        JtJ = mm(J.T, J)
        Jtr = mm(J.T, r)
        # Levenberg damping keeps the step safe when inlier geometry is thin.
        damp = 1e-6 * jnp.trace(JtJ) / 6.0
        step = jnp.linalg.solve(JtJ + damp * jnp.eye(6, dtype=JtJ.dtype), Jtr)
        new = params - step
        # Accept only non-degenerate steps.
        new = jnp.where(jnp.all(jnp.isfinite(new)), new, params)
        return new, None

    params, _ = jax.lax.scan(gn_step, params0, None, length=refine_iters)
    R_fin = angle_axis_to_matrix(params[:3])
    t_fin = params[3:]
    err2_fin = _reproj_err_px(K, R_fin, t_fin, X, uv)
    inliers = (err2_fin <= thr2) & mask
    num_inl = jnp.sum(inliers)
    # Fall back to the unpolished winner if GN diverged.
    better = num_inl >= jnp.sum(inl_best)
    R_fin = jnp.where(better, R_fin, R_best)
    t_fin = jnp.where(better, t_fin, t_best)
    err2_fin = jnp.where(better, err2_fin, _reproj_err_px(K, R_best, t_best, X, uv))
    inliers = (err2_fin <= thr2) & mask
    num_inl = jnp.sum(inliers)
    mean_err = jnp.sqrt(
        jnp.sum(jnp.where(inliers, err2_fin, 0.0)) / jnp.maximum(num_inl, 1)
    )
    return {
        "R": R_fin,
        "t": t_fin,
        "angle_axis": matrix_to_angle_axis(R_fin),
        "inliers": inliers,
        "num_inliers": num_inl,
        "success": num_inl >= 6,
        "mean_inlier_error_px": mean_err,
        # Estimated focal (== the input K's for calibrated methods; the
        # per-hypothesis estimate for "upnp").
        "focal": K[0, 0],
    }
