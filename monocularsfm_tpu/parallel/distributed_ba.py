"""Landmark-sharded distributed bundle adjustment.

The SPMD design (SURVEY.md section 2, parallelism plan (d)): each chip owns
a slab of landmarks and their observations; cameras are replicated.  Every
LM iteration each chip computes its residuals, Jacobian blocks, point
(V, g_p) blocks and its *contribution* to the reduced camera system; the
camera-side quantities (U, rhs, Schur S, cost, predicted reduction) are
psum-reduced across the mesh, the replicated dense solve happens identically on
every chip, and point back-substitution is purely local.  One collective-
synchronised lax.while_loop drives the whole optimisation with zero host
round-trips.

The math lives in optim/ba.py (bundle_adjust_impl with axis_name); this
module owns the mesh plumbing: padding the point axis to the mesh size,
sharding specs, and shard_map invocation.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from monocularsfm_tpu.optim.ba import BundleProblem, bundle_adjust_impl


def _pad_points(prob: BundleProblem, multiple: int) -> BundleProblem:
    Pn = prob.X.shape[0]
    target = ((Pn + multiple - 1) // multiple) * multiple
    pad = target - Pn
    if pad == 0:
        return prob
    return BundleProblem(
        K=prob.K,
        R=prob.R,
        t=prob.t,
        X=jnp.pad(prob.X, ((0, pad), (0, 0))),
        cam_valid=prob.cam_valid,
        cam_const=prob.cam_const,
        point_valid=jnp.pad(prob.point_valid, (0, pad)),
        obs_cam=jnp.pad(prob.obs_cam, ((0, pad), (0, 0))),
        obs_uv=jnp.pad(prob.obs_uv, ((0, pad), (0, 0), (0, 0))),
        obs_valid=jnp.pad(prob.obs_valid, ((0, pad), (0, 0))),
    )


def _to_global(arr, spec, mesh: Mesh):
    """Host array -> global jax.Array for a (possibly multi-host) mesh.

    Single-process meshes pass through; with jax.process_count() > 1 every
    input must be a global array whose shards live on the right processes
    (plain numpy would raise), so each process contributes its addressable
    slices via make_array_from_callback.  Every process must hold the SAME
    full host array (the deterministic problem build guarantees it)."""
    if jax.process_count() == 1:
        return arr
    a = np.asarray(arr)
    sh = jax.sharding.NamedSharding(mesh, spec)
    return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])


def distributed_bundle_adjust(
    prob: BundleProblem,
    mesh: Mesh,
    max_iterations: int = 50,
    solve_mode: str = "dense",
    dispatch_iters: int | None = None,
    **kwargs,
):
    """Run LM with the point/observation axis sharded over `mesh`.

    Works on single-host meshes and, after `init_multi_host`, on meshes
    spanning processes over the network — the 1-device / 1-host / N-host
    scaling axis of SURVEY.md section 5.  Returns the same dict as
    bundle_adjust; X is gathered back to full size on single-host meshes
    and stays point-sharded (padded to the mesh size) across processes.

    Like the single-device driver, one dispatch runs the whole solve unless
    `dispatch_iters` caps the LM iterations per dispatch; solver state then
    stays device-resident and sharded between segments.
    """
    from monocularsfm_tpu.optim.ba import derive_pcg_cached_statics

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    orig_P = prob.X.shape[0]
    prob = _pad_points(prob, n_dev)
    if solve_mode == "pcg" and "pcg_cached" not in kwargs:
        # Global stats are safe upper bounds for every point shard (the
        # distributed path requires identity point_rows, so max_rows == 1).
        kwargs.update(derive_pcg_cached_statics(prob))

    pt = P(axis)          # shard axis 0 (points / observations)
    rep = P()             # replicated
    in_specs = BundleProblem(
        K=rep, R=rep, t=rep,
        X=pt,
        cam_valid=rep, cam_const=rep,
        point_valid=pt,
        obs_cam=pt, obs_uv=pt, obs_valid=pt,
    )
    multi_host = jax.process_count() > 1
    if multi_host:
        prob = BundleProblem(
            K=_to_global(prob.K, rep, mesh),
            R=_to_global(prob.R, rep, mesh),
            t=_to_global(prob.t, rep, mesh),
            X=_to_global(prob.X, pt, mesh),
            cam_valid=_to_global(prob.cam_valid, rep, mesh),
            cam_const=_to_global(prob.cam_const, rep, mesh),
            point_valid=_to_global(prob.point_valid, pt, mesh),
            obs_cam=_to_global(prob.obs_cam, pt, mesh),
            obs_uv=_to_global(prob.obs_uv, pt, mesh),
            obs_valid=_to_global(prob.obs_valid, pt, mesh),
        )
    out_specs = {
        "R": rep, "t": rep, "X": pt, "K": rep,
        "cost_initial": rep, "cost_final": rep, "iterations": rep,
        "rmse_initial": rep, "rmse_final": rep, "mean_reproj_error": rep,
        "num_residuals": rep, "radius": rep, "converged": rep,
    }
    state_specs = (rep, rep, rep, pt, rep, rep, rep, rep)

    base = functools.partial(
        bundle_adjust_impl, solve_mode=solve_mode, axis_name=axis, **kwargs
    )
    fn_first = jax.jit(jax.shard_map(
        lambda p, mi: base(p, max_iterations=mi),
        mesh=mesh, in_specs=(in_specs, rep), out_specs=out_specs,
    ))
    fn_cont = jax.jit(jax.shard_map(
        lambda p, mi, st: base(p, max_iterations=mi, init_state=st),
        mesh=mesh, in_specs=(in_specs, rep, state_specs),
        out_specs=out_specs,
    ))

    def _scalar(v):
        a = jnp.asarray(v, jnp.int32)
        return _to_global(a, rep, mesh) if multi_host else a

    if dispatch_iters is None:
        dispatch_iters = max_iterations
    out = fn_first(prob, _scalar(min(dispatch_iters, max_iterations)))
    first = out
    while (int(out["iterations"]) < max_iterations
           and not bool(out["converged"])):
        state = (
            out["K"], out["R"], out["t"], out["X"], out["radius"],
            out["cost_final"], out["iterations"], out["converged"],
        )
        limit = min(int(out["iterations"]) + dispatch_iters, max_iterations)
        out = fn_cont(prob, _scalar(limit), state)
    if out is not first:
        out = dict(out)
        out["cost_initial"] = first["cost_initial"]
        out["rmse_initial"] = first["rmse_initial"]
    if not multi_host:
        out["X"] = out["X"][:orig_P]
    return out
