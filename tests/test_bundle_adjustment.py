"""Bundle adjustment: convergence on synthetic problems, Ceres-class parity.

The "oracle" is scipy.optimize.least_squares (TRF with exact jacobian
structure ignored — small problems only), standing in for Ceres since the
reference's Ceres is not available in this image.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from monocularsfm_tpu.optim import bundle_adjust, make_bundle_problem
from monocularsfm_tpu.utils.synthetic import camera_ring_scene
from monocularsfm_tpu.geometry import angle_axis_to_matrix


def _build_problem(scene, noise_px=0.0, perturb=0.0, T=12, seed=0, cam_pad=0, pnt_pad=0):
    rng = np.random.default_rng(seed)
    C = scene.num_cameras
    Pn = scene.num_points
    obs_cam = np.zeros((Pn + pnt_pad, T), np.int32)
    obs_uv = np.zeros((Pn + pnt_pad, T, 2), np.float32)
    obs_valid = np.zeros((Pn + pnt_pad, T), bool)
    for p in range(Pn):
        cams = np.where(scene.visible[:, p])[0][:T]
        obs_cam[p, : len(cams)] = cams
        obs_uv[p, : len(cams)] = scene.observations[cams, p]
        obs_valid[p, : len(cams)] = True
    if noise_px:
        obs_uv += rng.normal(scale=noise_px, size=obs_uv.shape).astype(np.float32)

    R = scene.R.copy()
    t = scene.t.copy()
    X = scene.points.copy()
    if perturb:
        aa = rng.normal(scale=perturb * 0.02, size=(C, 3))
        dR = np.asarray(angle_axis_to_matrix(jnp.asarray(aa)))
        R = np.einsum("cij,cjk->cik", dR, R)
        t = t + rng.normal(scale=perturb * 0.05, size=t.shape)
        X = X + rng.normal(scale=perturb * 0.05, size=X.shape)

    cam_const = np.zeros(C + cam_pad, bool)
    cam_const[0] = True  # gauge (reference GlobalBA pins registered_images_[0])
    cam_valid = np.zeros(C + cam_pad, bool)
    cam_valid[:C] = True
    if cam_pad:
        R = np.concatenate([R, np.tile(np.eye(3), (cam_pad, 1, 1))])
        t = np.concatenate([t, np.zeros((cam_pad, 3))])
    K4 = np.array([scene.K[0, 0], scene.K[1, 1], scene.K[0, 2], scene.K[1, 2]], np.float32)
    prob = make_bundle_problem(
        K4, R, t, X if not pnt_pad else np.concatenate([X, np.zeros((pnt_pad, 3))]),
        obs_cam, obs_uv, obs_valid, cam_const, cam_valid=cam_valid,
    )
    return prob


class TestBundleAdjust:
    def test_perturbed_exact_recovers(self, ring_scene):
        prob = _build_problem(ring_scene, noise_px=0.0, perturb=1.0)
        out = bundle_adjust(prob, max_iterations=50)
        assert float(out["rmse_initial"]) > 5.0   # badly perturbed
        assert float(out["rmse_final"]) < 0.05, float(out["rmse_final"])

    def test_noisy_reaches_noise_floor(self, ring_scene):
        prob = _build_problem(ring_scene, noise_px=0.5, perturb=0.5)
        out = bundle_adjust(prob, max_iterations=50)
        # With 0.5 px observation noise the ML residual RMSE ~ 0.5 px * sqrt(
        # dof ratio) — anything <= 0.55 is at the floor.
        assert float(out["rmse_final"]) < 0.55, float(out["rmse_final"])

    def test_constant_camera_pinned(self, ring_scene):
        prob = _build_problem(ring_scene, perturb=1.0)
        out = bundle_adjust(prob, max_iterations=30)
        np.testing.assert_allclose(np.asarray(out["R"])[0], np.asarray(prob.R)[0], atol=1e-7)
        np.testing.assert_allclose(np.asarray(out["t"])[0], np.asarray(prob.t)[0], atol=1e-7)

    def test_padding_invariance(self, ring_scene):
        p1 = _build_problem(ring_scene, perturb=0.5)
        p2 = _build_problem(ring_scene, perturb=0.5, cam_pad=8, pnt_pad=100)
        o1 = bundle_adjust(p1, max_iterations=20)
        o2 = bundle_adjust(p2, max_iterations=20)
        assert abs(float(o1["rmse_final"]) - float(o2["rmse_final"])) < 1e-3

    def test_segmented_dispatch_identical(self, ring_scene):
        """Host-segmented solve (dispatch_iters bounds the LM iterations per
        dispatch) must walk the EXACT same iterate sequence as the
        monolithic while_loop."""
        prob = _build_problem(ring_scene, noise_px=0.3, perturb=0.7)
        for mode, kw in [("dense", {}), ("pcg", {"pcg_iters": 40})]:
            mono = bundle_adjust(prob, max_iterations=21, solve_mode=mode,
                                 dispatch_iters=64, **kw)
            seg = bundle_adjust(prob, max_iterations=21, solve_mode=mode,
                                dispatch_iters=4, **kw)
            assert int(seg["iterations"]) == int(mono["iterations"])
            assert bool(seg["converged"]) == bool(mono["converged"])
            np.testing.assert_allclose(
                float(seg["cost_final"]), float(mono["cost_final"]),
                rtol=1e-6)
            np.testing.assert_allclose(
                np.asarray(seg["X"]), np.asarray(mono["X"]), atol=1e-6)

    def test_pcg_matches_dense(self, ring_scene):
        prob = _build_problem(ring_scene, noise_px=0.3, perturb=0.5)
        dense = bundle_adjust(prob, max_iterations=25, solve_mode="dense")
        pcg = bundle_adjust(prob, max_iterations=25, solve_mode="pcg", pcg_iters=80)
        assert float(pcg["rmse_final"]) < float(dense["rmse_final"]) * 1.05 + 1e-3

    def test_split_rows_match_unsplit(self, ring_scene):
        """Long tracks split across width-4 rows (point_rows map) must give
        the same optimum as the single-row layout — no observation dropped."""
        from monocularsfm_tpu.optim.ba import BundleProblem

        prob = _build_problem(ring_scene, noise_px=0.3, perturb=0.5)
        obs_cam = np.asarray(prob.obs_cam)
        obs_uv = np.asarray(prob.obs_uv)
        obs_valid = np.asarray(prob.obs_valid)
        Ts = 4
        rc, ruv, rv, prows = [], [], [], []
        for p in range(obs_cam.shape[0]):
            idx = np.nonzero(obs_valid[p])[0]
            for s in range(0, max(len(idx), 1), Ts):
                ch = idx[s : s + Ts]
                c = np.zeros(Ts, np.int32)
                u = np.zeros((Ts, 2), np.float32)
                v = np.zeros(Ts, bool)
                c[: len(ch)] = obs_cam[p, ch]
                u[: len(ch)] = obs_uv[p, ch]
                v[: len(ch)] = True if len(ch) else False
                v[len(ch):] = False
                rc.append(c)
                ruv.append(u)
                rv.append(v)
                prows.append(p)
        split = BundleProblem(
            K=prob.K, R=prob.R, t=prob.t, X=prob.X,
            cam_valid=prob.cam_valid, cam_const=prob.cam_const,
            point_valid=prob.point_valid,
            obs_cam=jnp.asarray(np.stack(rc)),
            obs_uv=jnp.asarray(np.stack(ruv)),
            obs_valid=jnp.asarray(np.stack(rv)),
            point_rows=jnp.asarray(np.array(prows, np.int32)),
        )
        ref = bundle_adjust(prob, max_iterations=25, solve_mode="pcg", pcg_iters=80)
        out = bundle_adjust(split, max_iterations=25, solve_mode="pcg", pcg_iters=80)
        assert float(out["num_residuals"]) == float(ref["num_residuals"])
        assert abs(float(out["rmse_final"]) - float(ref["rmse_final"])) < 1e-2
        # Dense Schur must refuse the split layout.
        with pytest.raises(ValueError):
            bundle_adjust(split, max_iterations=2, solve_mode="dense")

    def test_against_scipy_oracle(self):
        # Small problem so the dense scipy solve stays fast.
        scene = camera_ring_scene(num_cameras=5, num_points=80, noise_px=0.8, seed=11)
        prob = _build_problem(scene, noise_px=0.0, perturb=0.8, T=5)
        # note: noise added through scene observations already
        out = bundle_adjust(prob, max_iterations=60)

        from scipy.optimize import least_squares
        from scipy.spatial.transform import Rotation

        C, Pn = scene.num_cameras, scene.num_points
        obs_cam = np.asarray(prob.obs_cam)
        obs_uv = np.asarray(prob.obs_uv)
        obs_valid = np.asarray(prob.obs_valid)
        K = scene.K

        def unpack(x):
            aa = x[: C * 3].reshape(C, 3)
            t = x[C * 3 : C * 6].reshape(C, 3)
            X = x[C * 6 :].reshape(Pn, 3)
            R = Rotation.from_rotvec(aa).as_matrix()
            return R, t, X

        def fun(x):
            R, t, X = unpack(x)
            res = []
            for p in range(Pn):
                for k in range(obs_valid.shape[1]):
                    if not obs_valid[p, k]:
                        continue
                    c = obs_cam[p, k]
                    xc = R[c] @ X[p] + t[c]
                    u = K[0, 0] * xc[0] / xc[2] + K[0, 2]
                    v = K[1, 1] * xc[1] / xc[2] + K[1, 2]
                    res += [u - obs_uv[p, k, 0], v - obs_uv[p, k, 1]]
            return np.array(res)

        aa0 = Rotation.from_matrix(np.asarray(prob.R)).as_rotvec()
        x0 = np.concatenate(
            [aa0.ravel(), np.asarray(prob.t).ravel(), np.asarray(prob.X).ravel()]
        )
        sol = least_squares(fun, x0, method="trf", max_nfev=60)
        oracle_rmse = np.sqrt(np.mean(sol.fun ** 2))
        ours = float(out["rmse_final"])
        # Parity: within 10% of the scipy/Ceres-class optimum (scipy pins no
        # gauge, giving it slightly more freedom).
        assert ours <= oracle_rmse * 1.10 + 1e-3, (ours, oracle_rmse)
