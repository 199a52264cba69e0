"""Multi-host worker: one process of a jax.distributed CPU cluster.

Spawned by tests/test_multihost.py (one subprocess per simulated host).
Builds the SAME deterministic bundle problem on every process, joins the
cluster via init_multi_host, runs landmark-sharded distributed BA over the
global mesh (collectives cross process boundaries via gloo — the multi-host
stand-in), and prints one JSON result line for the parent to compare with
the single-process solve.
"""

import json
import os
import pathlib
import sys

# Script mode puts tests/ (not the repo root) on sys.path; the package may
# not be pip-installed, so add the repo root explicitly.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    proc_id = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_num_cpu_devices", 2)  # 2 devices per "host"
    except Exception:
        pass

    from monocularsfm_tpu.parallel import (
        distributed_bundle_adjust, init_multi_host, make_mesh,
    )

    pid, pcount = init_multi_host(f"localhost:{port}", nproc, proc_id)
    assert pcount == nproc, (pid, pcount)

    import numpy as np

    prob = _build_problem()
    mesh = make_mesh()  # all GLOBAL devices (2 per process)
    assert mesh.devices.size == 2 * nproc
    out = distributed_bundle_adjust(prob, mesh, max_iterations=25)
    print(json.dumps({
        "proc": pid,
        "num_devices": int(mesh.devices.size),
        "rmse_final": float(np.asarray(out["rmse_final"])),
        "cost_final": float(np.asarray(out["cost_final"])),
        "R0": np.asarray(out["R"])[1].tolist(),
        "t0": np.asarray(out["t"])[1].tolist(),
    }), flush=True)


def _build_problem(T=12, seed=0):
    """Deterministic ring-scene bundle (same recipe as the parent test)."""
    import numpy as np
    import jax.numpy as jnp

    from monocularsfm_tpu.geometry import angle_axis_to_matrix
    from monocularsfm_tpu.optim import make_bundle_problem
    from monocularsfm_tpu.utils.synthetic import camera_ring_scene

    scene = camera_ring_scene(num_cameras=12, num_points=400, noise_px=0.4,
                              seed=3)
    rng = np.random.default_rng(seed)
    Pn = scene.num_points
    obs_cam = np.zeros((Pn, T), np.int32)
    obs_uv = np.zeros((Pn, T, 2), np.float32)
    obs_valid = np.zeros((Pn, T), bool)
    for p in range(Pn):
        cams = np.where(scene.visible[:, p])[0][:T]
        obs_cam[p, : len(cams)] = cams
        obs_uv[p, : len(cams)] = scene.observations[cams, p]
        obs_valid[p, : len(cams)] = True
    aa = rng.normal(scale=0.01, size=(scene.num_cameras, 3))
    R = np.einsum(
        "cij,cjk->cik", np.asarray(angle_axis_to_matrix(jnp.asarray(aa))),
        scene.R,
    )
    t = scene.t + rng.normal(scale=0.02, size=scene.t.shape)
    X = scene.points + rng.normal(scale=0.02, size=scene.points.shape)
    cam_const = np.zeros(scene.num_cameras, bool)
    cam_const[0] = True
    K4 = np.array([scene.K[0, 0], scene.K[1, 1], scene.K[0, 2],
                   scene.K[1, 2]], np.float32)
    return make_bundle_problem(K4, R, t, X, obs_cam, obs_uv, obs_valid,
                               cam_const)


if __name__ == "__main__":
    main()
