"""SIFT quality: cross-view match consistency, cv2 repeatability, invariances."""

import numpy as np
import pytest
import jax.numpy as jnp

from monocularsfm_tpu.ops.sift import SIFT
from monocularsfm_tpu.ops.matching import match_descriptors_pair, matches_to_pairs
from monocularsfm_tpu.utils.synthetic import render_textured_images


@pytest.fixture(scope="module")
def rendered():
    imgs, K, R, t = render_textured_images(
        num_cameras=3, width=320, height=240, arc_deg=30.0, scene_seed=5
    )
    return imgs, K, R, t


@pytest.fixture(scope="module")
def sift():
    return SIFT(num_features=1500, k_per_octave=1024)


def _match(d1, d2, cap=2048):
    da = np.zeros((cap, 128), np.float32)
    db = np.zeros((cap, 128), np.float32)
    ma = np.zeros(cap, bool)
    mb = np.zeros(cap, bool)
    da[: len(d1)] = d1
    db[: len(d2)] = d2
    ma[: len(d1)] = True
    mb[: len(d2)] = True
    idx = match_descriptors_pair(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
        ratio=0.8, max_distance=0.7, col_tile=256,
    )
    return matches_to_pairs(idx)


class TestSift:
    def test_cross_view_matches_follow_geometry(self, rendered, sift):
        """Matches between two views of the textured plane must satisfy the
        ground-truth homography induced by the plane."""
        imgs, K, R, t = rendered
        kp1, d1 = sift.extract(imgs[0])
        kp2, d2 = sift.extract(imgs[1])
        assert len(kp1) > 300 and len(kp2) > 300
        i, j = _match(d1, d2)
        assert len(i) > 80, f"only {len(i)} matches"
        # Ground-truth homography for plane z=0 (world): H = K (R2 - t2 n^T
        # / d) R1^-1 K^-1 expressed via relative pose of cam1->cam2.
        R12 = R[1] @ R[0].T
        t12 = t[1] - R12 @ t[0]
        # Plane z=0 world in cam-1 frame: n_c = R1 @ [0,0,1], d_c = distance.
        n_w = np.array([0.0, 0.0, 1.0])
        n_c = R[0] @ n_w
        C1 = -R[0].T @ t[0]
        d_c = abs(float(n_w @ C1))  # plane passes through origin
        H = K @ (R12 + np.outer(t12, n_c) / d_c) @ np.linalg.inv(K)
        p1 = np.c_[kp1[i, :2], np.ones(len(i))]
        proj = p1 @ H.T
        proj = proj[:, :2] / proj[:, 2:]
        err = np.linalg.norm(proj - kp2[j, :2], axis=1)
        inlier_frac = (err < 3.0).mean()
        assert inlier_frac > 0.8, f"homography inlier fraction {inlier_frac:.2f}"

    def test_repeatability_vs_opencv(self, rendered, sift):
        cv2 = __import__("cv2")
        imgs, *_ = rendered
        kp, _ = sift.extract(imgs[0])
        cv_kp = cv2.SIFT_create(nfeatures=1500).detect(imgs[0], None)
        cv_xy = np.array([k.pt for k in cv_kp])
        assert len(cv_xy) > 100
        # Fraction of cv2 keypoints that we also detect within 2 px.
        d = np.linalg.norm(cv_xy[:, None, :] - kp[None, :, :2], axis=2)
        repeat = (d.min(axis=1) < 2.0).mean()
        assert repeat > 0.9, f"repeatability vs OpenCV {repeat:.2f}"

    def test_match_count_parity_vs_opencv(self, rendered, sift):
        """End-to-end detector+descriptor quality: cross-view verified match
        counts on the rendered scene must reach OpenCV SIFT's (the metric
        registration rate actually depends on — SURVEY hard part #2)."""
        cv2 = __import__("cv2")
        imgs, *_ = rendered
        kp1, d1 = sift.extract(imgs[0])
        kp2, d2 = sift.extract(imgs[1])
        ours_i, ours_j = _match(d1, d2)

        cv_sift = cv2.SIFT_create(nfeatures=1500)
        ck1, cd1 = cv_sift.detectAndCompute(imgs[0], None)
        ck2, cd2 = cv_sift.detectAndCompute(imgs[1], None)
        # RootSIFT-normalise cv2's descriptors so both go through the SAME
        # matcher with the same thresholds.
        def rootsift(d):
            d = d / np.maximum(np.abs(d).sum(axis=1, keepdims=True), 1e-12)
            return np.sqrt(d).astype(np.float32)
        cv_i, cv_j = _match(rootsift(cd1), rootsift(cd2))
        assert len(ours_i) >= 0.8 * len(cv_i), (
            f"ours {len(ours_i)} matches vs cv2 {len(cv_i)}"
        )

    def test_num_features_cap_by_scale(self, rendered):
        imgs, *_ = rendered
        s_small = SIFT(num_features=200, k_per_octave=1024)
        kp, desc = s_small.extract(imgs[0])
        assert len(kp) == 200 and len(desc) == 200
        # Kept the *largest* scales (reference top-scale policy).
        s_full = SIFT(num_features=5000, k_per_octave=1024)
        kp_full, _ = s_full.extract(imgs[0])
        assert kp[:, 2].min() >= np.percentile(kp_full[:, 2], 70)

    def test_descriptor_rootsift_norms(self, rendered, sift):
        imgs, *_ = rendered
        _, desc = sift.extract(imgs[0])
        # RootSIFT: unit L2 and non-negative (atol covers the f16
        # device->host transfer quantization, ~2e-4 relative).
        np.testing.assert_allclose(np.linalg.norm(desc, axis=1), 1.0,
                                   atol=3e-3)
        assert (desc >= 0).all()


class TestPatchSampling:
    def test_patch_path_matches_gather_path(self, rendered):
        """The patch/matmul formulation computes the same bilinear samples as
        the gather formulation — descriptors and angles must agree to fp
        tolerance for interior keypoints (border handling differs: patch
        zero-pads, gather clamps)."""
        imgs, _, _, _ = rendered
        a = SIFT(num_features=800, k_per_octave=512, sample_mode="gather")
        b = SIFT(num_features=800, k_per_octave=512, sample_mode="patch")
        kps_a, desc_a = a.extract_batch(imgs[:1])
        kps_b, desc_b = b.extract_batch(imgs[:1])
        ka, da = kps_a[0], desc_a[0]
        kb, db_ = kps_b[0], desc_b[0]
        H, W = imgs.shape[1:3]

        # Interior keypoints only: the descriptor grid reaches ~4x the
        # keypoint size in image pixels (1.875 cells x 3 sigma x sqrt2,
        # size ~ 2 sigma), and the patch path's edge-replication differs
        # from the gather path's zeroed border gradients inside that band.
        def interior(kp):
            margin = 4.0 * kp[:, 2] + 6.0
            return ((kp[:, 0] > margin) & (kp[:, 0] < W - margin)
                    & (kp[:, 1] > margin) & (kp[:, 1] < H - margin))

        sel_a = np.nonzero(interior(ka))[0]
        sel_b = np.nonzero(interior(kb))[0]
        # Detection is identical; sampling differences can flip marginal
        # secondary-orientation slots, so pair keypoints by (x, y, angle)
        # and demand the shared set dominates.
        key = lambda kp, i: (round(float(kp[i, 0]), 2),
                             round(float(kp[i, 1]), 2),
                             round(float(kp[i, 3]), 0))
        map_a = {key(ka, i): i for i in sel_a}
        map_b = {key(kb, i): i for i in sel_b}
        common = sorted(set(map_a) & set(map_b))
        assert len(common) >= 0.9 * max(len(sel_a), len(sel_b)), (
            len(common), len(sel_a), len(sel_b))
        ia = np.asarray([map_a[c] for c in common])
        ib = np.asarray([map_b[c] for c in common])
        err = np.abs(da[ia] - db_[ib]).max()
        assert err < 5e-3, err

    def test_patch_sampler_exact_vs_gather_sampler(self):
        """Unit check of the interpolation-matmul sampler against the
        row-gather sampler on random data — identical coords, interior
        samples, must agree to fp tolerance."""
        import jax

        from monocularsfm_tpu.ops import sift as S

        rng = np.random.default_rng(0)
        ssz, hsz, wsz = 3, 96, 128
        vol = rng.normal(size=(ssz, hsz, wsz)).astype(np.float32)
        gauss = jnp.asarray(vol)
        # gather-path pack
        gx = np.zeros_like(vol)
        gx[:, :, 1:-1] = 0.5 * (vol[:, :, 2:] - vol[:, :, :-2])
        gy = np.zeros_like(vol)
        gy[:, 1:-1, :] = 0.5 * (vol[:, 2:, :] - vol[:, :-2, :])
        gxf, gyf = gx.ravel(), gy.ravel()
        shift = lambda v: np.concatenate([v[1:], v[:1]])
        gpack = jnp.asarray(
            np.stack([gxf, shift(gxf), gyf, shift(gyf)], axis=1))

        k = 8
        xk = rng.uniform(34, wsz - 34, size=k).astype(np.float32)
        yk = rng.uniform(34, hsz - 34, size=k).astype(np.float32)
        si = rng.integers(0, ssz, size=k).astype(np.int32)
        off = rng.uniform(-2.5, 2.5, size=(k, 16)).astype(np.float32)
        sx = xk[:, None] + off
        sy = yk[:, None] + off[:, ::-1]

        gx_ref, gy_ref = jax.vmap(
            lambda s, yy, xx: S._bilinear_grads(
                gpack, (ssz, hsz, wsz), s, xx, yy)
        )(si, jnp.asarray(sy), jnp.asarray(sx))

        patches = S._extract_patches(
            gauss, jnp.asarray(si),
            jnp.floor(jnp.asarray(yk)).astype(jnp.int32),
            jnp.floor(jnp.asarray(xk)).astype(jnp.int32))
        g2 = S._patch_gradients(patches)
        loc_x = jnp.asarray(sx - (np.floor(xk) - S._PATCH_C)[:, None])
        loc_y = jnp.asarray(sy - (np.floor(yk) - S._PATCH_C)[:, None])
        gx_p, gy_p = S._sample_patch_grads(g2, loc_y, loc_x)

        np.testing.assert_allclose(
            np.asarray(gx_ref), np.asarray(gx_p), atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(gy_ref), np.asarray(gy_p), atol=1e-5)

    def test_octave_blur_matches_scipy(self):
        """The pyramid's separable blurs vs scipy's Gaussian filter with the
        same sigma and radius and replicated edges (mode="nearest"), in
        float64 on the host."""
        import math

        import jax.numpy as jnp
        from scipy.ndimage import gaussian_filter1d

        from monocularsfm_tpu.ops import sift as S

        rng = np.random.default_rng(0)
        base = rng.random((2, 100, 150), np.float32)
        out = np.asarray(S._build_octave_batched(jnp.asarray(base)))
        assert out.shape == (2, S.N_SCALES + 3, 100, 150)
        np.testing.assert_array_equal(out[:, 0], base)
        k = 2.0 ** (1.0 / S.N_SCALES)
        for c in range(S.N_SCALES + 2):
            sig = math.sqrt((S.SIGMA0 * k ** (c + 1)) ** 2 - S.SIGMA0 ** 2)
            radius = max(int(math.ceil(3.0 * sig)), 1)
            ref = base.astype(np.float64)
            for axis in (1, 2):
                ref = gaussian_filter1d(ref, sig, axis=axis, mode="nearest",
                                        radius=radius)
            assert np.abs(out[:, c + 1] - ref).max() < 1e-5, c
