"""Levenberg-Marquardt bundle adjustment with Schur complement on device.

Reference parity: src/Optimizer/CeresBundleOptimizer.cpp —
  residual: angle-axis rotate + translate + pinhole f*x/z vs (u-cx, v-cy),
            no distortion (obs pre-undistorted at Map load), :29-53
  solver:   DENSE_SCHUR <= 50 images / SPARSE_SCHUR <= 1000, 100 LM iters,
            tighter tolerances and 2x iters for < 10 images, :262-291
  gauge:    constant poses pinned (:256-260)

Device design decisions (not a Ceres translation):

* Pose increments live in a *left-multiplicative* local frame:
  R <- exp([dw]_x) R, t <- t + dt.  The rotation Jacobian at the origin is
  exactly -[R X]_x — three constants per observation, no trig — which keeps
  the whole Jacobian build closed-form, batched, and well-conditioned.
* Observations are grouped per 3D point and padded to a fixed track width T
  (`[P, T]` layout).  Point blocks (V, g_p) then reduce along T with plain
  sums; camera blocks (U, g_c) use segment_sum over the flattened cam index.
  No dynamic shapes anywhere; padding carries zero weight.
* Tracks longer than T are never truncated: `point_rows` maps observation
  rows to point indices, so one landmark may span several rows.  Point
  blocks then reduce with segment_sum over `point_rows` and per-row math
  gathers Vinv/g_p/dp through the map.  The dense Schur path requires the
  identity mapping (all observations of a point in one row) because its
  one-hot chunk einsum forms cross-observation products row-locally; the
  builder guarantees this by sizing T to the longest track when it selects
  the dense solver (small bundles only, Ceres DENSE_SCHUR <= 50 images).
* The reduced camera system S = U~ - sum_p Y_p W_p^T is built *densely* by a
  chunked one-hot einsum over points — a matmul, not a scatter —
  and solved with a Jacobi-equilibrated Cholesky.  For camera counts beyond
  the dense regime, `solve_mode="pcg"` applies S matrix-free with the
  block-diagonal U~ preconditioner — the ITERATIVE_SCHUR analogue, and the
  piece that shards over a mesh by splitting points (psum reduces the
  camera-side products; see parallel/distributed_ba.py).
* The PCG path (ITERATIVE_SCHUR analogue) has two implementations.  The
  default cached-block path (`pcg_cached`) builds the system ONCE per LM
  iteration in a component-wise chunked pass — every per-observation
  quantity is a plain (T, chunk) f32 array, so no tensor carries small
  trailing dims such as (obs, 2, 6) — and caches the Schur coupling blocks
  W in two flat layouts: point-major (T, 3, 6, P) and camera-sorted
  (3, 6, Opad) with 128-aligned per-camera segments.  Camera/point
  reductions are in-block sums plus exact bounded boundary gathers (no
  scatter, no one-hot, no long-cumsum cancellation); the per-observation
  camera payload travels through one wide row-gather.  These layouts were
  chosen for an accelerator that pads the two minor dims of every array to
  (8, 128); whether they pay on the H100 has not been measured.  Each CG
  matvec is then pure cached reads —
  HBM-bandwidth-bound — and CG exits early on ||r|| <= pcg_rtol * ||rhs||.
  The flash fallback (unsorted point_rows) instead rebuilds closed-form
  Jacobians inside every pass and reduces immediately into compact
  accumulators — correct anywhere, ~40x slower at 1M observations.
* The trust-region loop is a lax.while_loop — classic LM radius control
  (accept if rho > 0, grow/shrink radius as Ceres does), fixed shapes, no
  host round-trips inside the solve.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BundleProblem:
    """Fixed-shape BA problem (the reference's BundleData, SoA edition).

    C = camera capacity, P = point capacity, T = track width,
    Pr = observation-row capacity (= P unless long tracks are split).
    """

    K: jnp.ndarray            # (4,) fx, fy, cx, cy
    R: jnp.ndarray            # (C, 3, 3) world->camera
    t: jnp.ndarray            # (C, 3)
    X: jnp.ndarray            # (P, 3)
    cam_valid: jnp.ndarray    # (C,) bool
    cam_const: jnp.ndarray    # (C,) bool — gauge-pinned poses
    point_valid: jnp.ndarray  # (P,) bool
    obs_cam: jnp.ndarray      # (Pr, T) int32 camera index (0 where invalid)
    obs_uv: jnp.ndarray       # (Pr, T, 2) pixel observations
    obs_valid: jnp.ndarray    # (Pr, T) bool
    # Row -> point index map for tracks longer than T (split across rows).
    # None = identity (every point owns exactly one row) — required by the
    # dense Schur path; the PCG path accepts any mapping.
    point_rows: jnp.ndarray | None = None  # (Pr,) int32 or None


def make_bundle_problem(
    K4, R, t, X, obs_cam, obs_uv, obs_valid, cam_const,
    cam_valid=None, point_valid=None, point_rows=None,
) -> BundleProblem:
    """Assemble a BundleProblem from host arrays (no padding logic here)."""
    P = X.shape[0]
    C = R.shape[0]
    if cam_valid is None:
        cam_valid = np.ones(C, bool)
    if point_valid is None:
        assert point_rows is None, "point_valid required with split rows"
        point_valid = np.asarray(obs_valid).any(axis=1)
    return BundleProblem(
        K=jnp.asarray(K4, jnp.float32),
        R=jnp.asarray(R, jnp.float32),
        t=jnp.asarray(t, jnp.float32),
        X=jnp.asarray(X, jnp.float32),
        cam_valid=jnp.asarray(cam_valid),
        cam_const=jnp.asarray(cam_const),
        point_valid=jnp.asarray(point_valid),
        obs_cam=jnp.asarray(obs_cam, jnp.int32),
        obs_uv=jnp.asarray(obs_uv, jnp.float32),
        obs_valid=jnp.asarray(obs_valid),
        point_rows=(
            None if point_rows is None else jnp.asarray(point_rows, jnp.int32)
        ),
    )


def _skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def _exp_so3(w):
    """Rodrigues exponential, same stable form as geometry.rotations."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)
    theta = jnp.sqrt(theta2 + 1e-12)
    small = theta2[..., 0] < 1e-8
    sinc = jnp.where(small, 1.0 - theta2[..., 0] / 6.0, jnp.sin(theta[..., 0]) / theta[..., 0])
    cosc = jnp.where(small, 0.5 - theta2[..., 0] / 24.0,
                     (1.0 - jnp.cos(theta[..., 0])) / theta2[..., 0])
    Km = _skew(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), Km.shape)
    return eye + sinc[..., None, None] * Km + cosc[..., None, None] * (Km @ Km)


def _residuals(K, R, t, X, obs_cam, obs_uv, w):
    """r: (P, T, 2) weighted residuals; also returns q=(RX) and z for reuse."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    R_obs = R[obs_cam]                       # (P, T, 3, 3)
    t_obs = t[obs_cam]                       # (P, T, 3)
    q = jnp.einsum("ptij,pj->pti", R_obs, X, precision=_HIGHEST)
    p = q + t_obs
    z = p[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = fx * p[..., 0] / zs + cx
    v = fy * p[..., 1] / zs + cy
    r = jnp.stack([u - obs_uv[..., 0], v - obs_uv[..., 1]], axis=-1)
    return r * w[..., None], p, zs, R_obs


def _cost(r):
    return 0.5 * jnp.sum(r * r)


# Single source of the cached-PCG capacity defaults (the bundle_adjust
# validation checks caller-supplied values against these).
_PCG_DEFAULT_MAX_ROWS = 1
_PCG_DEFAULT_MAX_BLOCKS = 16


@functools.partial(
    jax.jit,
    static_argnames=(
        "schur_chunk", "solve_mode", "pcg_iters", "refine_focal",
        "pcg_cached", "pcg_max_rows", "pcg_max_blocks", "pcg_rtol",
    ),
)
def _bundle_adjust_segment(
    prob: BundleProblem,
    max_iterations,
    function_tolerance: float = 1e-6,
    parameter_tolerance: float = 1e-8,
    gradient_tolerance: float = 1e-10,
    initial_radius: float = 1e4,
    schur_chunk: int = 2048,
    solve_mode: str = "dense",
    pcg_iters: int = 100,
    refine_focal: bool = False,
    min_lm_diagonal: float = 1e-6,
    max_lm_diagonal: float = 1e32,
    pcg_cached: bool = False,
    pcg_max_rows: int = _PCG_DEFAULT_MAX_ROWS,
    pcg_max_blocks: int = _PCG_DEFAULT_MAX_BLOCKS,
    pcg_rtol: float = 1e-2,
    init_state=None,
) -> dict[str, Any]:
    """One jitted LM segment (max_iterations is a dynamic operand, so every
    segment of a host-driven solve reuses the same compiled program)."""
    return bundle_adjust_impl(
        prob,
        max_iterations=max_iterations,
        function_tolerance=function_tolerance,
        parameter_tolerance=parameter_tolerance,
        gradient_tolerance=gradient_tolerance,
        initial_radius=initial_radius,
        schur_chunk=schur_chunk,
        solve_mode=solve_mode,
        pcg_iters=pcg_iters,
        refine_focal=refine_focal,
        min_lm_diagonal=min_lm_diagonal,
        max_lm_diagonal=max_lm_diagonal,
        pcg_cached=pcg_cached,
        pcg_max_rows=pcg_max_rows,
        pcg_max_blocks=pcg_max_blocks,
        pcg_rtol=pcg_rtol,
        axis_name=None,
        init_state=init_state,
    )


def _next_pow2(x: int, minimum: int = 1) -> int:
    cap = minimum
    while cap < x:
        cap *= 2
    return cap


def derive_pcg_cached_statics(prob: BundleProblem) -> dict[str, Any]:
    """Host-side shape statics for the cached-W PCG path.

    Returns {} when the problem is ineligible (unsorted point_rows — the
    camera/point segment reductions need contiguous sorted segments; the
    map_state BA bridge always builds sorted rows).  Capacities are pow2
    buckets so recompiles stay logarithmic in problem growth."""
    obs_cam = np.asarray(prob.obs_cam)
    obs_valid = np.asarray(prob.obs_valid)
    C = int(prob.R.shape[0])
    rows = prob.point_rows
    max_rows = 1
    if rows is not None:
        r = np.asarray(rows)
        if np.any(np.diff(r) < 0):
            return {}
        row_real = obs_valid.any(axis=1)
        if row_real.any():
            max_rows = int(np.bincount(r[row_real]).max())
    cams_used = obs_cam[obs_valid]
    max_per_cam = (
        int(np.bincount(cams_used, minlength=C).max()) if cams_used.size else 1
    )
    return {
        "pcg_cached": True,
        "pcg_max_rows": _next_pow2(max_rows),
        "pcg_max_blocks": _next_pow2(-(-max_per_cam // 128)),
    }


def bundle_adjust(
    prob: BundleProblem,
    max_iterations: int = 50,
    dispatch_iters: int | None = None,
    **kwargs,
) -> dict[str, Any]:
    """Single-device LM.

    By default one dispatch runs up to `max_iterations` LM iterations.
    `dispatch_iters` instead caps the LM iterations per dispatch and drives
    the solve from the host in segments; the solver state (poses, points,
    trust radius, LM iteration counter) stays on device between segments
    and the host only reads the convergence flag, so the iterates are the
    same either way."""
    if kwargs.get("solve_mode") == "pcg" and "pcg_cached" not in kwargs:
        kwargs.update(derive_pcg_cached_statics(prob))
    elif kwargs.get("pcg_cached"):
        # Caller-supplied capacities: verify against the problem.  Too-small
        # pcg_max_rows/pcg_max_blocks would silently truncate the bounded
        # rows_to_points/cam_reduce_blocks sums -> wrong gradients.
        need = derive_pcg_cached_statics(prob)
        if not need:
            raise ValueError(
                "pcg_cached=True requires sorted point_rows (see "
                "derive_pcg_cached_statics)")
        for k in ("pcg_max_rows", "pcg_max_blocks"):
            have = kwargs.get(k, {"pcg_max_rows": _PCG_DEFAULT_MAX_ROWS,
                                  "pcg_max_blocks": _PCG_DEFAULT_MAX_BLOCKS}[k])
            if have < need[k]:
                raise ValueError(
                    f"{k}={have} too small for this problem (needs "
                    f">= {need[k]}); pass none to derive automatically")
    if dispatch_iters is None:
        dispatch_iters = max_iterations
    out = _bundle_adjust_segment(
        prob, jnp.asarray(min(dispatch_iters, max_iterations), jnp.int32),
        **kwargs,
    )
    first = out
    while (int(out["iterations"]) < max_iterations
           and not bool(out["converged"])):
        state = (
            out["K"], out["R"], out["t"], out["X"], out["radius"],
            out["cost_final"], out["iterations"], out["converged"],
        )
        limit = min(int(out["iterations"]) + dispatch_iters, max_iterations)
        out = _bundle_adjust_segment(
            prob, jnp.asarray(limit, jnp.int32), init_state=state, **kwargs
        )
    if out is not first:
        out = dict(out)
        out["cost_initial"] = first["cost_initial"]
        out["rmse_initial"] = first["rmse_initial"]
    return out


def bundle_adjust_refine_focal(
    prob: BundleProblem,
    max_iterations: int = 50,
    **kwargs,
) -> dict[str, Any]:
    """Shared-focal bundle adjustment (reference refine_focal_length option,
    CeresBundleOptimizer.cpp:76-121): the two global (fx, fy) columns ride
    inside the dense Schur-reduced camera system, so LM walks the f/Z valley
    jointly with poses and points."""
    return bundle_adjust(
        prob, max_iterations=max_iterations, refine_focal=True, **kwargs
    )


def bundle_adjust_impl(
    prob: BundleProblem,
    max_iterations: int = 50,
    function_tolerance: float = 1e-6,
    parameter_tolerance: float = 1e-8,
    gradient_tolerance: float = 1e-10,
    initial_radius: float = 1e4,
    schur_chunk: int = 2048,
    solve_mode: str = "dense",
    pcg_iters: int = 100,
    refine_focal: bool = False,
    min_lm_diagonal: float = 1e-6,
    max_lm_diagonal: float = 1e32,
    pcg_cached: bool = False,
    pcg_max_rows: int = _PCG_DEFAULT_MAX_ROWS,
    pcg_max_blocks: int = _PCG_DEFAULT_MAX_BLOCKS,
    pcg_rtol: float = 1e-2,
    axis_name: str | None = None,
    init_state=None,
) -> dict[str, Any]:
    """Run LM. Returns dict(R, t, X, cost_initial, cost_final, iterations,
    rmse_initial, rmse_final, num_residuals, radius, converged).

    `max_iterations` may be a traced scalar (dynamic while_loop bound) and
    `init_state` a carried (K, R, t, X, radius, cost, it, done) tuple — the
    two hooks the segmented host driver in `bundle_adjust` uses to split one
    optimisation across many bounded device dispatches.

    With `axis_name` set this function is SPMD over a mesh axis that shards
    the *point* dimension (landmark-sharded distributed BA): cameras and the
    reduced camera system are replicated, every point/observation quantity is
    local, and the camera-side reductions (U, rhs, S, cost, pred) are
    psum-reduced across the mesh — the design in SURVEY.md section 2 plan (d).
    Callers wrap it in shard_map (see parallel/distributed_ba.py).
    """

    def _ps(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    def _pmax(x):
        return jax.lax.pmax(x, axis_name) if axis_name is not None else x

    def _pv(x):
        # Mark a replicated value as device-varying so it can seed loop
        # carries whose bodies mix in sharded data (shard_map vma typing).
        if axis_name is None:
            return x
        try:
            return jax.lax.pcast(x, (axis_name,), to="varying")
        except (AttributeError, TypeError):  # older jax spelling
            return jax.lax.pvary(x, (axis_name,))

    if refine_focal and solve_mode != "dense":
        raise ValueError("refine_focal requires solve_mode='dense'")
    rows = prob.point_rows  # None = identity row->point map (trace-static)
    if rows is not None and solve_mode == "dense":
        raise ValueError(
            "dense Schur requires the identity point_rows map (one row per "
            "point); build the problem unsplit or use solve_mode='pcg'"
        )
    if rows is not None and axis_name is not None:
        raise ValueError("distributed BA requires the identity point_rows map")
    C = prob.R.shape[0]
    P, T = prob.obs_cam.shape      # P = observation-row capacity
    Pn = prob.X.shape[0]           # point capacity (== P when rows is None)

    def seg_pts(x_rows):
        """Reduce a per-row quantity to per-point (identity = no-op)."""
        if rows is None:
            return x_rows
        return jax.ops.segment_sum(x_rows, rows, num_segments=Pn)

    def to_rows(x_pts):
        """Gather a per-point quantity onto observation rows."""
        return x_pts if rows is None else x_pts[rows]

    w = (
        prob.obs_valid
        & to_rows(prob.point_valid)[:, None]
        & prob.cam_valid[prob.obs_cam]
    ).astype(jnp.float32)
    num_res = _ps(jnp.sum(w))
    obs_cam_flat = prob.obs_cam.reshape(-1)

    free_cam = (prob.cam_valid & ~prob.cam_const).astype(jnp.float32)  # (C,)

    def compute_cost(K, R, t, X):
        r, _, _, _ = _residuals(K, R, t, to_rows(X), prob.obs_cam, prob.obs_uv, w)
        return _ps(_cost(r)), r

    def build_system(K, R, t, X):
        """Residuals + all Schur building blocks at the current state."""
        r, p, z, R_obs = _residuals(
            K, R, t, to_rows(X), prob.obs_cam, prob.obs_uv, w
        )
        q = p - t[prob.obs_cam]  # (P, T, 3) rotated-but-untranslated points
        fx, fy = K[0], K[1]
        inv_z = 1.0 / z
        zero = jnp.zeros_like(z)
        Jproj = jnp.stack(
            [
                jnp.stack([fx * inv_z, zero, -fx * p[..., 0] * inv_z * inv_z], axis=-1),
                jnp.stack([zero, fy * inv_z, -fy * p[..., 1] * inv_z * inv_z], axis=-1),
            ],
            axis=-2,
        ) * w[..., None, None]  # (P, T, 2, 3), weighted once — so products
        # J^T J carry w^2? No: weight belongs to the residual definition
        # r_w = w * r, J_w = w * J; with w in {0, 1}, w^2 = w. OK.
        # d p / d (dw, dt): [-[q]_x | I]  (3, 6)
        Jpose = jnp.concatenate(
            [-_skew(q), jnp.broadcast_to(jnp.eye(3, dtype=q.dtype), q.shape + (3,))],
            axis=-1,
        )  # (P, T, 3, 6)
        Jc = jnp.einsum("ptij,ptjk->ptik", Jproj, Jpose, precision=_HIGHEST)  # (P,T,2,6)
        Jp = jnp.einsum("ptij,ptjk->ptik", Jproj, R_obs, precision=_HIGHEST)  # (P,T,2,3)
        # Zero out Jacobian columns of pinned/invalid cameras (gauge fixing).
        Jc = Jc * free_cam[prob.obs_cam][..., None, None]

        # Camera blocks (replicated after the cross-shard reduction).
        U = _ps(jax.ops.segment_sum(
            jnp.einsum("oki,okj->oij", Jc.reshape(-1, 2, 6), Jc.reshape(-1, 2, 6),
                       precision=_HIGHEST),
            obs_cam_flat, num_segments=C,
        ))  # (C, 6, 6)
        g_c = jax.ops.segment_sum(
            -jnp.einsum("oki,ok->oi", Jc.reshape(-1, 2, 6), r.reshape(-1, 2),
                        precision=_HIGHEST),
            obs_cam_flat, num_segments=C,
        )  # (C, 6)
        # Point blocks (segment-reduced over rows when tracks are split).
        V = seg_pts(
            jnp.einsum("ptki,ptkj->pij", Jp, Jp, precision=_HIGHEST)
        )  # (Pn, 3, 3)
        g_p = seg_pts(
            -jnp.einsum("ptki,ptk->pi", Jp, r, precision=_HIGHEST)
        )  # (Pn, 3)
        # Coupling.
        W = jnp.einsum("ptki,ptkj->ptij", Jc, Jp, precision=_HIGHEST)  # (P, T, 6, 3)
        if not refine_focal:
            return r, U, g_c, V, g_p, W, Jc, Jp, None
        # Global shared-focal columns (CeresBundleOptimizer.cpp:76-121):
        # d ru/d fx = xn * w, d rv/d fy = yn * w; off-diagonals zero.
        xn = p[..., 0] * inv_z * w
        yn = p[..., 1] * inv_z * w
        zero2 = jnp.zeros_like(xn)
        Jf = jnp.stack(
            [
                jnp.stack([xn, zero2], axis=-1),
                jnp.stack([zero2, yn], axis=-1),
            ],
            axis=-2,
        )  # (P, T, 2res, 2f)
        U_ff = _ps(jnp.einsum("ptki,ptkj->ij", Jf, Jf, precision=_HIGHEST))
        U_cf = _ps(jax.ops.segment_sum(
            jnp.einsum("oki,okj->oij", Jc.reshape(-1, 2, 6), Jf.reshape(-1, 2, 2),
                       precision=_HIGHEST),
            obs_cam_flat, num_segments=C,
        ))  # (C, 6, 2)
        g_f = _ps(-jnp.einsum("ptki,ptk->i", Jf, r, precision=_HIGHEST))  # (2,)
        Wf_sum = jnp.einsum("ptki,ptkj->pij", Jf, Jp, precision=_HIGHEST)  # (P, 2, 3)
        focal = (Jf, U_ff, U_cf, g_f, Wf_sum)
        return r, U, g_c, V, g_p, W, Jc, Jp, focal

    def inv3x3(M):
        """Batched closed-form 3x3 inverse (adjugate / det)."""
        a = M
        c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
        c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
        c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
        c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
        c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
        c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
        c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
        c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
        c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
        det = jnp.where(jnp.abs(det) < 1e-18, 1e-18, det)
        adj = jnp.stack(
            [
                jnp.stack([c00, c10, c20], axis=-1),
                jnp.stack([c01, c11, c21], axis=-1),
                jnp.stack([c02, c12, c22], axis=-1),
            ],
            axis=-2,
        )
        return adj / det[..., None, None]

    eyeC6 = jnp.eye(6, dtype=jnp.float32)

    def damped_blocks(U, V, lam):
        """Ceres-style diagonal damping with clamped diagonals
        (min/max_lm_diagonal, CeresBundleOptimizer solver options)."""
        dU = jnp.clip(jnp.diagonal(U, axis1=-2, axis2=-1),
                      min_lm_diagonal, max_lm_diagonal)
        dV = jnp.clip(jnp.diagonal(V, axis1=-2, axis2=-1),
                      min_lm_diagonal, max_lm_diagonal)
        U_d = U + lam * dU[..., None] * eyeC6
        V_d = V + lam * dV[..., None] * jnp.eye(3, dtype=jnp.float32)
        # Pinned / invalid cameras get identity blocks -> zero step.
        pin = ~(prob.cam_valid & ~prob.cam_const)
        U_d = jnp.where(pin[:, None, None], eyeC6, U_d)
        # Invalid points likewise.
        V_d = jnp.where(
            prob.point_valid[:, None, None], V_d, jnp.eye(3, dtype=jnp.float32)
        )
        return U_d, V_d

    # Chunk size never exceeds the point capacity (small problems).
    schur_chunk = min(schur_chunk, P)
    num_chunks = (P + schur_chunk - 1) // schur_chunk

    def dense_schur_solve(U_d, Vinv, W, g_c, g_p, focal=None, lam=0.0):
        """Build S and rhs densely (chunked one-hot einsum) and solve.

        With `focal` set, the system is augmented by two global shared-focal
        columns: S_aug = [[S_cc, S_cf], [S_cf^T, S_ff]] — the focal block is
        Schur-reduced against the same point blocks (Wf_sum couples focal to
        every point)."""
        Y = jnp.einsum("ptij,pjk->ptik", W, Vinv, precision=_HIGHEST)  # (P,T,6,3)
        rhs = _ps(g_c - jax.ops.segment_sum(
            jnp.einsum("oij,oj->oi", Y.reshape(-1, 6, 3),
                       jnp.repeat(g_p, T, axis=0).reshape(-1, 3),
                       precision=_HIGHEST),
            obs_cam_flat, num_segments=C,
        ))  # (C, 6)

        # Zero-pad the point axis to a whole number of chunks (zero W/Y rows
        # contribute nothing), then scan chunks — fully static shapes, no
        # clamped dynamic slices.
        pad = num_chunks * schur_chunk - P
        Yp = jnp.pad(Y, ((0, pad), (0, 0), (0, 0), (0, 0)))
        Wp = jnp.pad(W, ((0, pad), (0, 0), (0, 0), (0, 0)))
        camp = jnp.pad(prob.obs_cam, ((0, pad), (0, 0)))
        Yc = Yp.reshape(num_chunks, schur_chunk, T, 6, 3)
        Wc = Wp.reshape(num_chunks, schur_chunk, T, 6, 3)
        cc = camp.reshape(num_chunks, schur_chunk, T)

        def chunk_body(S_acc, inp):
            cam_chunk, Y_chunk, W_chunk = inp
            oh = jax.nn.one_hot(cam_chunk, C, dtype=jnp.float32)  # (pc,T,C)
            Yg = jnp.einsum("ptc,ptij->pcij", oh, Y_chunk, precision=_HIGHEST)
            Wg = jnp.einsum("ptc,ptij->pcij", oh, W_chunk, precision=_HIGHEST)
            S_acc = S_acc - jnp.einsum(
                "pcij,pdkj->cidk", Yg, Wg, precision=_HIGHEST
            ).reshape(C * 6, C * 6)
            return S_acc, None

        S0 = _pv(jnp.zeros((C * 6, C * 6), jnp.float32))
        S, _ = jax.lax.scan(chunk_body, S0, (cc, Yc, Wc))
        S = _ps(S)  # reduce the point-sharded Schur contributions
        # Add U~ on the block diagonal.
        bidx = jnp.arange(C)
        S = S.reshape(C, 6, C, 6)
        S = S.at[bidx, :, bidx, :].add(U_d)
        S = S.reshape(C * 6, C * 6)

        df = None
        if focal is not None:
            Jf, U_ff, U_cf, g_f, Wf_sum = focal
            # Schur-reduce focal against the point blocks.
            VinvWfT = jnp.einsum("pij,pkj->pik", Vinv, Wf_sum,
                                 precision=_HIGHEST)  # (P, 3, 2)
            S_ff = U_ff - _ps(jnp.einsum(
                "pij,pjk->ik", Wf_sum, VinvWfT, precision=_HIGHEST))  # (2, 2)
            # Damp the focal diagonal like every other block.
            dff = jnp.clip(jnp.diagonal(S_ff), min_lm_diagonal, max_lm_diagonal)
            S_ff = S_ff + lam * dff * jnp.eye(2, dtype=jnp.float32)
            # Cam-focal coupling: U_cf - sum_{p, t} Y_pt (Wf_sum_p)^T.
            S_cf = U_cf - _ps(jax.ops.segment_sum(
                jnp.einsum("oij,okj->oik", Y.reshape(-1, 6, 3),
                           jnp.repeat(Wf_sum, T, axis=0).reshape(-1, 2, 3),
                           precision=_HIGHEST),
                obs_cam_flat, num_segments=C,
            ))  # (C, 6, 2)
            rhs_f = g_f - _ps(jnp.einsum(
                "pij,pj->pi", Wf_sum @ Vinv, g_p, precision=_HIGHEST
            ).sum(axis=0))  # (2,)
            S_cf_flat = S_cf.reshape(C * 6, 2)
            S = jnp.block([
                [S, S_cf_flat],
                [S_cf_flat.T, S_ff],
            ])
            rhs = jnp.concatenate([rhs.reshape(-1), rhs_f])
        else:
            rhs = rhs.reshape(-1)

        # Jacobi equilibration keeps the f32 Cholesky healthy.
        d = jnp.sqrt(jnp.clip(jnp.diagonal(S), 1e-12, None))
        dinv = 1.0 / d
        S_eq = S * dinv[:, None] * dinv[None, :]
        rhs_eq = rhs * dinv
        L, low = jax.scipy.linalg.cho_factor(S_eq, lower=True)
        sol = jax.scipy.linalg.cho_solve((L, low), rhs_eq) * dinv
        if focal is not None:
            dc = sol[: C * 6].reshape(C, 6)
            df = sol[C * 6 :]
        else:
            dc = sol.reshape(C, 6)
        return dc, Y, df

    # ---- flash (chunk-remat) machinery for the PCG path --------------------
    # Per-observation Jacobian blocks are rebuilt from (K, R, t, X) inside
    # each lax.scan chunk and reduced immediately — no O-sized (.., 6, 3)
    # tensor ever reaches device memory.
    if solve_mode == "pcg":
        ch = min(schur_chunk, P)
        nchunks = (P + ch - 1) // ch
        rpad = nchunks * ch - P

        def _xs(arr):
            if rpad:
                cfgp = [(0, rpad)] + [(0, 0)] * (arr.ndim - 1)
                arr = jnp.pad(arr, cfgp)
            return arr

        # Chunk xs laid out (nc, T, ch): minor dims (T, ch) tile cleanly.
        cams_x = jnp.transpose(_xs(prob.obs_cam).reshape(nchunks, ch, T), (0, 2, 1))
        u_x = jnp.transpose(
            _xs(prob.obs_uv[..., 0]).reshape(nchunks, ch, T), (0, 2, 1))
        v_x = jnp.transpose(
            _xs(prob.obs_uv[..., 1]).reshape(nchunks, ch, T), (0, 2, 1))
        w_x = jnp.transpose(_xs(w).reshape(nchunks, ch, T), (0, 2, 1))
        prow_full = jnp.arange(P, dtype=jnp.int32) if rows is None else rows
        prow_x = _xs(prow_full).reshape(nchunks, ch)
        xs_all = (cams_x, u_x, v_x, w_x, prow_x)
        eye3 = jnp.eye(3, dtype=jnp.float32)

        def _chunk_geom(K, R, t, X, cams, prow):
            Xr = X[prow]                           # (ch, 3)
            R_o = R[cams]                          # (T, ch, 3, 3)
            q = jnp.einsum("tcij,cj->tci", R_o, Xr, precision=_HIGHEST)
            p = q + t[cams]
            z = p[..., 2]
            zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
            return q, p, zs, R_o

        def _chunk_resid(K, p, zs, uu, vv, ww):
            ru = (K[0] * p[..., 0] / zs + K[2] - uu) * ww
            rv = (K[1] * p[..., 1] / zs + K[3] - vv) * ww
            return jnp.stack([ru, rv], axis=-1)    # (T, ch, 2)

        def _chunk_jacs(K, q, p, zs, R_o, cams, ww):
            inv_z = 1.0 / zs
            zero = jnp.zeros_like(zs)
            Jproj = jnp.stack([
                jnp.stack([K[0] * inv_z, zero,
                           -K[0] * p[..., 0] * inv_z * inv_z], axis=-1),
                jnp.stack([zero, K[1] * inv_z,
                           -K[1] * p[..., 1] * inv_z * inv_z], axis=-1),
            ], axis=-2) * ww[..., None, None]      # (T, ch, 2, 3)
            Jpose = jnp.concatenate(
                [-_skew(q), jnp.broadcast_to(eye3, q.shape + (3,))], axis=-1
            )                                       # (T, ch, 3, 6)
            Jc = jnp.einsum("tcij,tcjk->tcik", Jproj, Jpose, precision=_HIGHEST)
            Jp = jnp.einsum("tcij,tcjk->tcik", Jproj, R_o, precision=_HIGHEST)
            Jc = Jc * free_cam[cams][..., None, None]
            return Jc, Jp

        def _cam_reduce(cams, vals_flat, acc):
            """acc (C, n) += one_hot(cams)^T @ vals — a matmul, not a scatter."""
            oh = jax.nn.one_hot(cams.reshape(-1), C, dtype=jnp.float32)
            return acc + jnp.einsum("oc,on->cn", oh, vals_flat,
                                    precision=_HIGHEST)

        def flash_system(K, R, t, X):
            """One pass: U (C,6,6) psum'd, g_c partial, V, g_p, local cost."""
            def body(carry, xs):
                U, gc, V, gp, cost = carry
                cams, uu, vv, ww, prow = xs
                q, p, zs, R_o = _chunk_geom(K, R, t, X, cams, prow)
                r2 = _chunk_resid(K, p, zs, uu, vv, ww)
                Jc, Jp = _chunk_jacs(K, q, p, zs, R_o, cams, ww)
                JcF = Jc.reshape(-1, 2, 6)
                UU = jnp.einsum("oki,okj->oij", JcF, JcF,
                                precision=_HIGHEST).reshape(-1, 36)
                U = _cam_reduce(cams, UU, U)
                gcc = -jnp.einsum("oki,ok->oi", JcF, r2.reshape(-1, 2),
                                  precision=_HIGHEST)
                gc = _cam_reduce(cams, gcc, gc)
                Vc = jnp.einsum("tcki,tckj->cij", Jp, Jp,
                                precision=_HIGHEST).reshape(-1, 9)
                gpc = -jnp.einsum("tcki,tck->ci", Jp, r2, precision=_HIGHEST)
                V = V.at[prow].add(Vc)
                gp = gp.at[prow].add(gpc)
                return (U, gc, V, gp, cost + _cost(r2)), None

            init = (
                _pv(jnp.zeros((C, 36), jnp.float32)),
                _pv(jnp.zeros((C, 6), jnp.float32)),
                _pv(jnp.zeros((Pn, 9), jnp.float32)),
                _pv(jnp.zeros((Pn, 3), jnp.float32)),
                _pv(jnp.zeros((), jnp.float32)),
            )
            U, gc, V, gp, cost = jax.lax.scan(body, init, xs_all)[0]
            return _ps(U).reshape(C, 6, 6), gc, V.reshape(Pn, 3, 3), gp, cost

        def flash_cost(K, R, t, X):
            def body(cost, xs):
                cams, uu, vv, ww, prow = xs
                _, p, zs, _ = _chunk_geom(K, R, t, X, cams, prow)
                return cost + _cost(_chunk_resid(K, p, zs, uu, vv, ww)), None
            return jax.lax.scan(
                body, _pv(jnp.zeros((), jnp.float32)), xs_all)[0]

        def flash_reproj_sum(K, R, t, X):
            def body(acc, xs):
                cams, uu, vv, ww, prow = xs
                _, p, zs, _ = _chunk_geom(K, R, t, X, cams, prow)
                r2 = _chunk_resid(K, p, zs, uu, vv, ww)
                return acc + jnp.sum(jnp.linalg.norm(r2, axis=-1)), None
            return jax.lax.scan(
                body, _pv(jnp.zeros((), jnp.float32)), xs_all)[0]

        def flash_WT(K, R, t, X, x):
            """(Pn, 3): per-point sum of W^T x_cam = Jp^T (Jc x_cam)."""
            def body(acc, xs):
                cams, uu, vv, ww, prow = xs
                q, p, zs, R_o = _chunk_geom(K, R, t, X, cams, prow)
                Jc, Jp = _chunk_jacs(K, q, p, zs, R_o, cams, ww)
                Jcx = jnp.einsum("tcij,tcj->tci", Jc, x[cams],
                                 precision=_HIGHEST)             # (T, ch, 2)
                Wx = jnp.einsum("tcij,tci->cj", Jp, Jcx,
                                precision=_HIGHEST)              # (ch, 3)
                return acc.at[prow].add(Wx), None
            return jax.lax.scan(
                body, _pv(jnp.zeros((Pn, 3), jnp.float32)), xs_all)[0]

        def flash_Wy(K, R, t, X, y_pts):
            """(C, 6) partial: per-camera sum of W y_p = Jc^T (Jp y_p)."""
            def body(acc, xs):
                cams, uu, vv, ww, prow = xs
                q, p, zs, R_o = _chunk_geom(K, R, t, X, cams, prow)
                Jc, Jp = _chunk_jacs(K, q, p, zs, R_o, cams, ww)
                y = y_pts[prow]                                  # (ch, 3)
                Jpy = jnp.einsum("tcij,cj->tci", Jp, y,
                                 precision=_HIGHEST)             # (T, ch, 2)
                Wy = jnp.einsum("tcij,tci->tcj", Jc, Jpy,
                                precision=_HIGHEST)              # (T, ch, 6)
                return _cam_reduce(cams, Wy.reshape(-1, 6), acc), None
            return jax.lax.scan(
                body, _pv(jnp.zeros((C, 6), jnp.float32)), xs_all)[0]

        def flash_pred(K, R, t, X, dc, dp):
            """Predicted reduction -r.Jdx - 0.5|Jdx|^2 (psum'd)."""
            def body(carry, xs):
                s1, s2 = carry
                cams, uu, vv, ww, prow = xs
                q, p, zs, R_o = _chunk_geom(K, R, t, X, cams, prow)
                r2 = _chunk_resid(K, p, zs, uu, vv, ww)
                Jc, Jp = _chunk_jacs(K, q, p, zs, R_o, cams, ww)
                Jdx = (
                    jnp.einsum("tcij,tcj->tci", Jc, dc[cams], precision=_HIGHEST)
                    + jnp.einsum("tcij,cj->tci", Jp, dp[prow], precision=_HIGHEST)
                )
                return (s1 + jnp.sum(r2 * Jdx), s2 + jnp.sum(Jdx * Jdx)), None
            z0 = _pv(jnp.zeros((), jnp.float32))
            (s1, s2), _ = jax.lax.scan(body, (z0, z0), xs_all)
            return _ps(-s1 - 0.5 * s2)

        def try_step_pcg(K, R, t, X, lam):
            U, g_c, V, g_p, cost_l = flash_system(K, R, t, X)
            cost = _ps(cost_l)
            g_inf = jnp.maximum(
                jnp.max(jnp.abs(_ps(g_c) * free_cam[:, None])),
                _pmax(jnp.max(jnp.abs(g_p * prob.point_valid[:, None]))),
            )
            U_d, V_d = damped_blocks(U, V, lam)
            Vinv = inv3x3(V_d)
            # rhs = g_c - sum_p W_p Vinv_p g_p  (Schur-reduced gradient).
            ygp = jnp.einsum("pij,pj->pi", Vinv, g_p, precision=_HIGHEST)
            rhs = _ps(g_c + flash_Wy(K, R, t, X, -ygp))
            Uinv = jnp.linalg.inv(U_d)

            def S_mul(x):
                Wx = flash_WT(K, R, t, X, x)
                VinvWx = jnp.einsum("pij,pj->pi", Vinv, Wx, precision=_HIGHEST)
                back = _ps(flash_Wy(K, R, t, X, VinvWx))
                Ux = jnp.einsum("cij,cj->ci", U_d, x, precision=_HIGHEST)
                # Ux comes from replicated U_d/x — identical on every shard,
                # so it must NOT be psum'd; only the point-sharded term is.
                return Ux - back

            def prec(z):
                return jnp.einsum("cij,cj->ci", Uinv, z, precision=_HIGHEST)

            r0 = rhs  # S_mul(0) == 0
            z0 = prec(r0)

            def cg_body(carry, _):
                x, r, z, pvec = carry
                Sp = S_mul(pvec)
                rz = jnp.sum(r * z)
                alpha = rz / jnp.maximum(jnp.sum(pvec * Sp), 1e-20)
                x = x + alpha * pvec
                r_new = r - alpha * Sp
                z_new = prec(r_new)
                beta = jnp.sum(r_new * z_new) / jnp.maximum(rz, 1e-20)
                return (x, r_new, z_new, z_new + beta * pvec), None

            (dc, _, _, _), _ = jax.lax.scan(
                cg_body, (jnp.zeros_like(rhs), r0, z0, z0), None,
                length=pcg_iters,
            )
            dc = dc * free_cam[:, None]
            rhs_p = g_p - flash_WT(K, R, t, X, dc)
            dp = jnp.einsum("pij,pj->pi", Vinv, rhs_p, precision=_HIGHEST)
            dp = dp * prob.point_valid[:, None]
            pred = flash_pred(K, R, t, X, dc, dp)
            R_new = _exp_so3(dc[:, :3]) @ R
            t_new = t + dc[:, 3:]
            X_new = X + dp
            new_cost = _ps(flash_cost(K, R_new, t_new, X_new))
            step_sq = jnp.sum(dc * dc) + _ps(jnp.sum(dp * dp))
            return cost, new_cost, pred, K, R_new, t_new, X_new, step_sq, g_inf

        # ---- cached-W PCG (the fast path) --------------------------------
        # The flash path above rebuilds every Jacobian block inside all
        # `pcg_iters` CG matvecs — ~100 observation passes per LM iteration,
        # each paying a 50 MB one-hot materialisation for the camera reduce
        # plus a scatter for the point reduce.  Here the Schur coupling
        # blocks W = Jc^T Jp (18 floats/obs) are built ONCE per LM iteration
        # and cached in two tile-friendly layouts:
        #   * point-major  Wt  (T, 3, 6, Pp)   — minor dims (6, Pp) tile at
        #     1.33x pad; the point reduce is a sum over leading axes plus a
        #     bounded per-point row gather (exact, no big-cumsum cancellation),
        #   * camera-sorted W_cs (3, 6, Opad)  — observations sorted by
        #     camera into 128-aligned per-camera segments, so the camera
        #     reduce is an in-block sum over the minor axis followed by a
        #     bounded per-camera block gather.  No one-hot, no scatter.
        # Each CG matvec is then pure cached reads (~0.5 GB of HBM traffic at
        # 1.2M observations) — HBM-bound at speed-of-light rather than
        # rebuild-bound.  CG also exits early on ||r|| <= pcg_rtol * ||rhs||
        # (Ceres ITERATIVE_SCHUR forcing-sequence analogue).
        if pcg_cached:
            Pp = nchunks * ch              # chunk-padded row capacity
            O = T * Pp                     # flat observation capacity
            Opad = -(-(O + C * 128) // 128) * 128
            NB = Opad // 128
            cams_tp = jnp.transpose(cams_x, (1, 0, 2)).reshape(T, Pp)
            w_tp = jnp.transpose(w_x, (1, 0, 2)).reshape(T, Pp)
            prow_p = prow_x.reshape(Pp)
            if rpad:
                # Keep the row->point map sorted across the chunk padding
                # (padded rows carry zero weight; Pn-1 >= every real value).
                prow_p = jnp.concatenate(
                    [prow_p[:P], jnp.full((rpad,), Pn - 1, jnp.int32)])

            if rows is not None:
                # Sorted rows (the map_state bridge guarantees it; the host
                # driver verifies before enabling this path).
                row_start = jnp.searchsorted(prow_p, jnp.arange(Pn + 1))

            def rows_to_points(arr):
                """(k, Pp) per-row -> (k, Pn) per-point, exact bounded sum."""
                if rows is None:
                    return arr[:, :Pn]
                acc = jnp.zeros((arr.shape[0], Pn), arr.dtype)
                for j in range(pcg_max_rows):
                    idx = row_start[:-1] + j
                    ok = idx < row_start[1:]
                    acc = acc + jnp.where(
                        ok[None, :], arr[:, jnp.minimum(idx, Pp - 1)], 0.0)
                return acc

            # Camera-sorted observation order with 128-aligned per-camera
            # segments (invalid observations sort to a dropped sentinel).
            cam_o = cams_tp.reshape(-1)
            m_o = w_tp.reshape(-1) > 0
            sort_key = jnp.where(m_o, cam_o, C).astype(jnp.int32)
            order_cs = jnp.argsort(sort_key).astype(jnp.int32)
            key_sorted = sort_key[order_cs]
            cam_counts = jnp.bincount(sort_key, length=C + 1)[:C]
            aligned = (((cam_counts + 127) // 128) * 128).astype(jnp.int32)
            zero1 = jnp.zeros(1, jnp.int32)
            pad_start = jnp.concatenate([zero1, jnp.cumsum(aligned)])
            cnt_start = jnp.concatenate(
                [zero1, jnp.cumsum(cam_counts).astype(jnp.int32)])
            kc = jnp.minimum(key_sorted, C - 1)
            pos = jnp.where(
                key_sorted < C,
                pad_start[kc] + (jnp.arange(O, dtype=jnp.int32)
                                 - cnt_start[kc]),
                Opad,
            )
            sel_cs = jnp.zeros(Opad, jnp.int32).at[pos].set(
                order_cs, mode="drop")
            val_cs = jnp.zeros(Opad, jnp.float32).at[pos].set(
                1.0, mode="drop")
            prow_o = jnp.broadcast_to(prow_p[None], (T, Pp)).reshape(-1)
            pt_cs = jnp.take(prow_o, sel_cs)
            cbs = pad_start // 128         # (C+1,) block ranges per camera

            def cam_reduce_blocks(contrib):
                """(k, Opad) camera-sorted -> (C, k), exact bounded sum."""
                kdim = contrib.shape[0]
                bs = contrib.reshape(kdim, NB, 128).sum(-1)   # (k, NB)
                acc = jnp.zeros((kdim, C), contrib.dtype)
                for b in range(pcg_max_blocks):
                    idx = cbs[:-1] + b
                    ok = idx < cbs[1:]
                    acc = acc + jnp.where(
                        ok[None, :], bs[:, jnp.minimum(idx, NB - 1)], 0.0)
                return acc.T

            # Component-wise chunk algebra: every per-observation quantity is
            # a plain (T, ch) f32 array — no (.., 2, 6)/(.., 3, 3) trailing
            # dims, which would need HIGHEST-precision einsums.  The whole
            # Jacobian/block build is exact f32 elementwise math.
            def _pose_table(R, t):
                """(C, 13) row-gatherable per-camera pack: R (9), t (3), free."""
                return jnp.concatenate(
                    [R.reshape(C, 9), t, free_cam[:, None]], axis=1)

            def _comp_geom(tab, X, cams, prow):
                g = jnp.take(tab, cams.reshape(-1), axis=0).reshape(
                    T, ch, 13).transpose(2, 0, 1)          # (13, T, ch)
                Xr = jnp.take(X, prow, axis=0).T           # (3, ch)
                x0, x1, x2 = Xr[0][None], Xr[1][None], Xr[2][None]
                q0 = g[0] * x0 + g[1] * x1 + g[2] * x2
                q1 = g[3] * x0 + g[4] * x1 + g[5] * x2
                q2 = g[6] * x0 + g[7] * x1 + g[8] * x2
                p0, p1, p2 = q0 + g[9], q1 + g[10], q2 + g[11]
                zs = jnp.where(jnp.abs(p2) < 1e-6, 1e-6, p2)
                return g, (q0, q1, q2), (p0, p1), zs

            def _comp_resid(K, p0, p1, zs, uu, vv, ww):
                inv_z = 1.0 / zs
                ru = (K[0] * p0 * inv_z + K[2] - uu) * ww
                rv = (K[1] * p1 * inv_z + K[3] - vv) * ww
                return ru, rv, inv_z

            def build_caches(K, R, t, X):
                """One observation pass -> cost, U, g_c, V9, g_p, Wt, W_cs.

                All per-observation payload destined for the camera side
                (36 U entries + 6 g_c entries + 18 W entries) travels to the
                camera-sorted order through ONE row-gather of a packed
                (O, 60) table: one wide row-gather instead of many narrow
                or minor-axis gathers."""
                tab = _pose_table(R, t)

                def body(cost, xs):
                    cams, uu, vv, ww, prow = xs
                    g, (q0, q1, q2), (p0, p1), zs = _comp_geom(
                        tab, X, cams, prow)
                    ru, rv, inv_z = _comp_resid(K, p0, p1, zs, uu, vv, ww)
                    fc = g[12]
                    a = K[0] * inv_z * ww
                    b = -K[0] * p0 * inv_z * inv_z * ww
                    c = K[1] * inv_z * ww
                    d = -K[1] * p1 * inv_z * inv_z * ww
                    zero = jnp.zeros_like(a)
                    # Jc = Jproj @ [-skew(q) | I], gauge-masked by free_cam.
                    Jc0 = [fc * e for e in (
                        b * q1, a * q2 - b * q0, -a * q1, a, zero, b)]
                    Jc1 = [fc * e for e in (
                        -c * q2 + d * q1, -d * q0, c * q0, zero, c, d)]
                    # Jp = Jproj @ R_obs.
                    Jp0 = [a * g[k] + b * g[6 + k] for k in range(3)]
                    Jp1 = [c * g[3 + k] + d * g[6 + k] for k in range(3)]
                    UU = [Jc0[i] * Jc0[j] + Jc1[i] * Jc1[j]
                          for i in range(6) for j in range(6)]
                    gcc = [-(Jc0[j] * ru + Jc1[j] * rv) for j in range(6)]
                    Wkj = [Jc0[j] * Jp0[k] + Jc1[j] * Jp1[k]
                           for k in range(3) for j in range(6)]
                    pay = jnp.stack(UU + gcc + Wkj, axis=-1).reshape(
                        T * ch, 60)
                    Vc = jnp.stack(
                        [jnp.sum(Jp0[i] * Jp0[j] + Jp1[i] * Jp1[j], axis=0)
                         for i in range(3) for j in range(3)])     # (9, ch)
                    gpc = jnp.stack(
                        [-jnp.sum(Jp0[k] * ru + Jp1[k] * rv, axis=0)
                         for k in range(3)])                       # (3, ch)
                    Wc = jnp.stack(Wkj).reshape(3, 6, T, ch).transpose(
                        2, 0, 1, 3)                                # (T,3,6,ch)
                    cost_c = 0.5 * jnp.sum(ru * ru + rv * rv)
                    return cost + cost_c, (pay, Vc, gpc, Wc)

                cost_l, (pay_ys, V_ys, gp_ys, W_ys) = jax.lax.scan(
                    body, _pv(jnp.zeros((), jnp.float32)), xs_all)
                # (nc, T*ch, 60) -> (T, nc, ch, 60) -> row o = t*Pp + n*ch + c.
                pay_tab = pay_ys.reshape(nchunks, T, ch, 60).transpose(
                    1, 0, 2, 3).reshape(O, 60)
                pay_cs = (jnp.take(pay_tab, sel_cs, axis=0)
                          * val_cs[:, None]).T                     # (60, Opad)
                Ugc = cam_reduce_blocks(pay_cs[:42])               # (C, 42)
                U = _ps(Ugc[:, :36].reshape(C, 6, 6))
                g_c = Ugc[:, 36:]                  # local partial (psum'd at use)
                W_cs = pay_cs[42:].reshape(3, 6, Opad)
                V9 = rows_to_points(
                    V_ys.transpose(1, 0, 2).reshape(9, Pp))        # (9, Pn)
                g_p = rows_to_points(
                    gp_ys.transpose(1, 0, 2).reshape(3, Pp))       # (3, Pn)
                Wt = W_ys.transpose(1, 2, 3, 0, 4).reshape(T, 3, 6, Pp)
                return cost_l, U, g_c, V9, g_p, Wt, W_cs

            # Component-wise cost / reprojection passes (shadow the flash
            # versions for the cached path — same values, ~10x less traffic).
            def flash_cost(K, R, t, X):  # noqa: F811
                tab = _pose_table(R, t)

                def body(cost, xs):
                    cams, uu, vv, ww, prow = xs
                    _, _, (p0, p1), zs = _comp_geom(tab, X, cams, prow)
                    ru, rv, _ = _comp_resid(K, p0, p1, zs, uu, vv, ww)
                    return cost + 0.5 * jnp.sum(ru * ru + rv * rv), None

                return jax.lax.scan(
                    body, _pv(jnp.zeros((), jnp.float32)), xs_all)[0]

            def flash_reproj_sum(K, R, t, X):  # noqa: F811
                tab = _pose_table(R, t)

                def body(acc, xs):
                    cams, uu, vv, ww, prow = xs
                    _, _, (p0, p1), zs = _comp_geom(tab, X, cams, prow)
                    ru, rv, _ = _comp_resid(K, p0, p1, zs, uu, vv, ww)
                    return acc + jnp.sum(jnp.sqrt(ru * ru + rv * rv)), None

                return jax.lax.scan(
                    body, _pv(jnp.zeros((), jnp.float32)), xs_all)[0]

            eye9 = jnp.array([1, 0, 0, 0, 1, 0, 0, 0, 1], jnp.float32)
            pv_mask = prob.point_valid.astype(jnp.float32)

            def damp_V9(V9, lam):
                d0 = jnp.clip(V9[0], min_lm_diagonal, max_lm_diagonal)
                d4 = jnp.clip(V9[4], min_lm_diagonal, max_lm_diagonal)
                d8 = jnp.clip(V9[8], min_lm_diagonal, max_lm_diagonal)
                Vd = jnp.stack([
                    V9[0] + lam * d0, V9[1], V9[2],
                    V9[3], V9[4] + lam * d4, V9[5],
                    V9[6], V9[7], V9[8] + lam * d8,
                ])
                return jnp.where(prob.point_valid[None, :], Vd, eye9[:, None])

            def inv3x3_9(V):
                a00, a01, a02, a10, a11, a12, a20, a21, a22 = V
                c00 = a11 * a22 - a12 * a21
                c01 = a12 * a20 - a10 * a22
                c02 = a10 * a21 - a11 * a20
                c10 = a02 * a21 - a01 * a22
                c11 = a00 * a22 - a02 * a20
                c12 = a01 * a20 - a00 * a21
                c20 = a01 * a12 - a02 * a11
                c21 = a02 * a10 - a00 * a12
                c22 = a00 * a11 - a01 * a10
                det = a00 * c00 + a01 * c01 + a02 * c02
                det = jnp.where(jnp.abs(det) < 1e-18, 1e-18, det)
                return jnp.stack(
                    [c00, c10, c20, c01, c11, c21, c02, c12, c22]) / det

            def mat9_apply(M9, g):
                """(9, Pn) row-major 3x3 blocks applied to (3, Pn)."""
                return jnp.stack([
                    M9[0] * g[0] + M9[1] * g[1] + M9[2] * g[2],
                    M9[3] * g[0] + M9[4] * g[1] + M9[5] * g[2],
                    M9[6] * g[0] + M9[7] * g[1] + M9[8] * g[2],
                ])

            def damp_U(U, lam):
                dU = jnp.clip(jnp.diagonal(U, axis1=-2, axis2=-1),
                              min_lm_diagonal, max_lm_diagonal)
                U_d = U + lam * dU[..., None] * eyeC6
                pin = ~(prob.cam_valid & ~prob.cam_const)
                return jnp.where(pin[:, None, None], eyeC6, U_d)

            cams_flat = cams_tp.reshape(-1)

            def WT_pts(Wt, x):
                """x (C, 6) -> (3, Pn): per-point sum of W^T x_cam.

                The camera->observation broadcast is ONE row-gather from the
                tiny (C, 6) table (tile-row granularity) with the transpose
                to the clean (T, 6, Pp) layout fused into the gather."""
                xg = jnp.take(x, cams_flat, axis=0).reshape(
                    T, Pp, 6).transpose(0, 2, 1)                   # (T, 6, Pp)
                Wx = jnp.einsum("tkjp,tjp->kp", Wt, xg,
                                precision=_HIGHEST)                # (3, Pp)
                return rows_to_points(Wx)

            def Wy_cams(W_cs, y):
                """y (3, Pn) -> (C, 6) local partial of per-camera W y_p."""
                yg = jnp.take(y.T, pt_cs, axis=0).T                # (3, Opad)
                contrib = jnp.einsum("kjo,ko->jo", W_cs, yg,
                                     precision=_HIGHEST)           # (6, Opad)
                return cam_reduce_blocks(contrib)                  # (C, 6)

            def try_step_pcg_cached(K, R, t, X, lam):
                cost_l, U, g_c, V9, g_p, Wt, W_cs = build_caches(K, R, t, X)
                cost = _ps(cost_l)
                g_inf = jnp.maximum(
                    jnp.max(jnp.abs(_ps(g_c) * free_cam[:, None])),
                    _pmax(jnp.max(jnp.abs(g_p * prob.point_valid[None, :]))),
                )
                U_d = damp_U(U, lam)
                Vi = inv3x3_9(damp_V9(V9, lam))
                rhs = _ps(g_c - Wy_cams(W_cs, mat9_apply(Vi, g_p)))
                Uinv = jnp.linalg.inv(U_d)

                def S_mul(x):
                    VWx = mat9_apply(Vi, WT_pts(Wt, x))
                    back = _ps(Wy_cams(W_cs, VWx))
                    Ux = jnp.einsum("cij,cj->ci", U_d, x, precision=_HIGHEST)
                    return Ux - back

                def prec(z):
                    return jnp.einsum("cij,cj->ci", Uinv, z,
                                      precision=_HIGHEST)

                r0 = rhs
                z0 = prec(r0)
                tol2 = (pcg_rtol * pcg_rtol) * jnp.sum(rhs * rhs)

                def cg_cond(cst):
                    _, r, _, _, k, _ = cst
                    return (k < pcg_iters) & (jnp.sum(r * r) > tol2)

                def cg_body(cst):
                    x, r, z, pvec, k, rz = cst
                    Sp = S_mul(pvec)
                    alpha = rz / jnp.maximum(jnp.sum(pvec * Sp), 1e-20)
                    x = x + alpha * pvec
                    r_new = r - alpha * Sp
                    z_new = prec(r_new)
                    rz_new = jnp.sum(r_new * z_new)
                    beta = rz_new / jnp.maximum(rz, 1e-20)
                    return (x, r_new, z_new, z_new + beta * pvec,
                            k + 1, rz_new)

                dc = jax.lax.while_loop(
                    cg_cond, cg_body,
                    (jnp.zeros_like(rhs), r0, z0, z0,
                     jnp.asarray(0, jnp.int32), jnp.sum(r0 * z0)),
                )[0]
                dc = dc * free_cam[:, None]
                rhs_p = g_p - WT_pts(Wt, dc)
                dp3 = mat9_apply(Vi, rhs_p) * pv_mask[None, :]
                dp = dp3.T
                # Predicted reduction from cached blocks (g = -J^T r):
                # pred = g.dx - 0.5 dx^T (J^T J) dx, all undamped.
                s_g = _ps(jnp.sum(g_c * dc)) + _ps(jnp.sum(g_p * dp3))
                s_u = jnp.sum(dc * jnp.einsum("cij,cj->ci", U, dc,
                                              precision=_HIGHEST))
                s_w = _ps(jnp.sum(dc * Wy_cams(W_cs, dp3)))
                s_v = _ps(jnp.sum(dp3 * mat9_apply(V9, dp3)))
                pred = s_g - 0.5 * (s_u + 2.0 * s_w + s_v)
                R_new = _exp_so3(dc[:, :3]) @ R
                t_new = t + dc[:, 3:]
                X_new = X + dp
                new_cost = _ps(flash_cost(K, R_new, t_new, X_new))
                step_sq = jnp.sum(dc * dc) + _ps(jnp.sum(dp * dp))
                return (cost, new_cost, pred, K, R_new, t_new, X_new,
                        step_sq, g_inf)

    def try_step(K, R, t, X, lam):
        r, U, g_c, V, g_p, W, Jc, Jp, focal = build_system(K, R, t, X)
        cost = _ps(_cost(r))  # global cost — must match compute_cost's reduction
        # Gradient-convergence statistic (Ceres gradient_tolerance: stop when
        # the max-norm of the full gradient falls under the threshold).
        g_inf = jnp.maximum(
            jnp.max(jnp.abs(_ps(g_c) * free_cam[:, None])),
            _pmax(jnp.max(jnp.abs(g_p * prob.point_valid[:, None]))),
        )
        U_d, V_d = damped_blocks(U, V, lam)
        Vinv = inv3x3(V_d)
        dc, Y, df = dense_schur_solve(U_d, Vinv, W, g_c, g_p, focal, lam)
        dc = dc * free_cam[:, None]
        # Back-substitute point updates (row partials reduced per point).
        WTdc = seg_pts(
            jnp.einsum("ptij,pti->pj", W, dc[prob.obs_cam], precision=_HIGHEST)
        )
        rhs_p = g_p - WTdc
        if refine_focal:
            Jf, U_ff, U_cf, g_f, Wf_sum = focal
            rhs_p = rhs_p - jnp.einsum("pij,i->pj", Wf_sum, df,
                                       precision=_HIGHEST)
        dp = jnp.einsum("pij,pj->pi", Vinv, rhs_p, precision=_HIGHEST)
        dp = dp * prob.point_valid[:, None]
        # Model (predicted) cost reduction: -g.dx - 0.5 dx^T H dx, computed
        # through J dx at the observation level (cheap, exact).
        Jdx = (
            jnp.einsum("ptij,ptj->pti", Jc, dc[prob.obs_cam], precision=_HIGHEST)
            + jnp.einsum("ptij,pj->pti", Jp, to_rows(dp), precision=_HIGHEST)
        )
        if refine_focal:
            Jdx = Jdx + jnp.einsum("ptij,j->pti", focal[0], df,
                                   precision=_HIGHEST)
        pred = _ps(-jnp.sum(r * Jdx) - 0.5 * jnp.sum(Jdx * Jdx))
        # Apply the step.
        R_new = _exp_so3(dc[:, :3]) @ R
        t_new = t + dc[:, 3:]
        X_new = X + dp
        if refine_focal:
            K_new = K.at[0].add(df[0]).at[1].add(df[1])
        else:
            K_new = K
        new_cost, _ = compute_cost(K_new, R_new, t_new, X_new)
        # dc is replicated (no psum); dp is point-sharded (psum).
        step_sq = jnp.sum(dc * dc) + _ps(jnp.sum(dp * dp))
        if refine_focal:
            step_sq = step_sq + jnp.sum(df * df)
        return cost, new_cost, pred, K_new, R_new, t_new, X_new, step_sq, g_inf

    if solve_mode == "pcg":
        try_step = try_step_pcg_cached if pcg_cached else try_step_pcg
        cost0 = _ps(flash_cost(prob.K, prob.R, prob.t, prob.X))
    else:
        cost0, _ = compute_cost(prob.K, prob.R, prob.t, prob.X)

    def cond(state):
        K, R, t, X, radius, cost, it, done = state
        return (it < max_iterations) & ~done

    def body(state):
        K, R, t, X, radius, cost, it, done = state
        lam = 1.0 / radius
        (cost_cur, new_cost, pred, K_new, R_new, t_new, X_new,
         step_sq, g_inf) = try_step(K, R, t, X, lam)
        rho = (cost_cur - new_cost) / jnp.maximum(pred, 1e-20)
        accept = (rho > 0) & (new_cost < cost_cur) & jnp.isfinite(new_cost)
        # Ceres-style radius update.
        shrink = 1.0 - (2.0 * rho - 1.0) ** 3
        radius_new = jnp.where(
            accept,
            radius / jnp.clip(shrink, 1.0 / 3.0, None),
            radius / 2.0,
        )
        radius_new = jnp.clip(radius_new, 1e-16, 1e16)
        K = jnp.where(accept, K_new, K)
        R = jnp.where(accept, R_new, R)
        t = jnp.where(accept, t_new, t)
        X = jnp.where(accept, X_new, X)
        cost_out = jnp.where(accept, new_cost, cost_cur)
        # Convergence tests (only meaningful on accepted steps).
        f_conv = accept & (
            jnp.abs(cost_cur - new_cost) <= function_tolerance * cost_cur
        )
        x_conv = accept & (jnp.sqrt(step_sq) <= parameter_tolerance)
        g_conv = g_inf <= gradient_tolerance
        stuck = ~accept & (radius_new <= 1e-14)
        return (K, R, t, X, radius_new, cost_out, it + 1,
                f_conv | x_conv | g_conv | stuck)

    if init_state is not None:
        state = init_state
    else:
        state = (
            prob.K, prob.R, prob.t, prob.X,
            jnp.asarray(initial_radius, jnp.float32),
            cost0, jnp.asarray(0, jnp.int32), jnp.asarray(False),
        )
    K, R, t, X, radius, cost, iters, done = jax.lax.while_loop(cond, body, state)
    denom = jnp.maximum(num_res, 1.0)
    # Mean Euclidean reprojection error per observation — the metric the
    # reference reports (Map::PrintStatistics / README "0.33772 px" style).
    if solve_mode == "pcg":
        mean_reproj = _ps(flash_reproj_sum(K, R, t, X)) / denom
    else:
        r_fin, _, _, _ = _residuals(
            K, R, t, to_rows(X), prob.obs_cam, prob.obs_uv, w
        )
        mean_reproj = _ps(jnp.sum(jnp.linalg.norm(r_fin, axis=-1))) / denom

    def _unvary(x):
        # Camera-side outputs are identical on every shard (all shard-varying
        # inputs flowed through deterministic psums), but the vma type still
        # says "varying".  pmean of equal values is the identity and comes
        # back typed replicated — one tiny all-reduce at the very end.
        if axis_name is None:
            return x
        return jax.lax.pmean(x, axis_name)

    def _unvary_exact(x):
        # pmax keeps integer/bool dtypes exact (pmean would true-divide);
        # the segmented driver feeds these back as while_loop carries, so
        # dtype drift would retrace.
        if axis_name is None:
            return x
        if x.dtype == jnp.bool_:
            return jax.lax.pmax(x.astype(jnp.int32), axis_name) > 0
        return jax.lax.pmax(x, axis_name)

    return {
        "R": _unvary(R),
        "t": _unvary(t),
        "X": X,
        "cost_initial": _unvary(cost0),
        "cost_final": _unvary(cost),
        "iterations": _unvary_exact(iters),
        # Per-residual-component RMSE (Ceres convention: 2 components/obs).
        "rmse_initial": _unvary(jnp.sqrt(cost0 / denom)),
        "rmse_final": _unvary(jnp.sqrt(cost / denom)),
        "mean_reproj_error": _unvary(mean_reproj),
        "num_residuals": _unvary(num_res),
        "K": _unvary(K),
        "radius": _unvary(radius),
        "converged": _unvary_exact(done),
    }
