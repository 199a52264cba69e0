"""Descriptor matcher vs a dense numpy oracle (and cv2.BFMatcher semantics)."""

import numpy as np
import jax.numpy as jnp

from monocularsfm_tpu.ops.matching import (
    match_descriptors_pair,
    match_pairs_batch,
    matches_to_pairs,
)


def _unit(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _numpy_oracle(da, db, ma, mb, ratio, max_distance, cross_check):
    """Dense re-implementation of the exact documented semantics."""
    sims = da @ db.T
    sims[~ma, :] = -np.inf
    sims[:, ~mb] = -np.inf
    out = np.full(len(da), -1, np.int32)

    def top2(row):
        o = np.argsort(-row)
        return o[0], row[o[0]], row[o[1]]

    def dist(s):
        return np.sqrt(max(2 - 2 * s, 0.0))

    col_arg = np.argmax(sims, axis=0)
    for i in range(len(da)):
        if not ma[i] or not np.isfinite(sims[i]).any():
            continue
        j, s1, s2 = top2(sims[i])
        if not (dist(s1) < ratio * dist(s2)):
            continue
        if dist(s1) > max_distance:
            continue
        if cross_check:
            if col_arg[j] != i:
                continue
            colvals = np.sort(sims[:, j])[::-1]
            if not (dist(colvals[0]) < ratio * dist(colvals[1])):
                continue
        out[i] = j
    return out


def _planted_pair(rng, n=256, cap=1024, noise=0.05):
    """Two descriptor sets where set B is a permuted noisy copy of A."""
    da = np.zeros((cap, 128), np.float32)
    db = np.zeros((cap, 128), np.float32)
    ma = np.zeros(cap, bool)
    mb = np.zeros(cap, bool)
    base = _unit(rng, n)
    perm = rng.permutation(n)
    da[:n] = base
    noisy = base[perm] + noise * rng.normal(size=(n, 128)).astype(np.float32)
    db[:n] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
    ma[:n] = True
    mb[:n] = True
    return da, db, ma, mb, perm


class TestMatchPair:
    def test_planted_correspondences_recovered(self, rng):
        da, db, ma, mb, perm = _planted_pair(rng)
        idx = np.asarray(
            match_descriptors_pair(
                jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
                col_tile=256,
            )
        )
        n = len(perm)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        matched = idx[:n] >= 0
        # Random 128-d unit vectors are far apart: nearly all planted matches survive.
        assert matched.mean() > 0.95
        assert np.all(idx[:n][matched] == inv[np.arange(n)[matched]])
        # Padding rows never match.
        assert np.all(idx[n:] == -1)

    def test_matches_numpy_oracle(self, rng):
        for cross in (True, False):
            da, db, ma, mb, _ = _planted_pair(rng, n=200, noise=0.25)
            idx = np.asarray(
                match_descriptors_pair(
                    jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
                    ratio=0.9, max_distance=0.9, cross_check=cross, col_tile=128,
                )
            )
            oracle = _numpy_oracle(da, db, ma, mb, 0.9, 0.9, cross)
            # bf16 matmul can flip matches whose top1/top2 margin is tiny;
            # demand near-exact agreement.
            agree = (idx == oracle).mean()
            assert agree > 0.98, f"agreement {agree} (cross_check={cross})"

    def test_tile_invariance(self, rng):
        da, db, ma, mb, _ = _planted_pair(rng, n=300, noise=0.15)
        outs = [
            np.asarray(
                match_descriptors_pair(
                    jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
                    col_tile=t,
                )
            )
            for t in (128, 512, 1024)
        ]
        assert np.array_equal(outs[0], outs[1]) and np.array_equal(outs[1], outs[2])

    def test_empty_and_all_masked(self, rng):
        cap = 512
        da = np.zeros((cap, 128), np.float32)
        db = np.zeros((cap, 128), np.float32)
        idx = np.asarray(
            match_descriptors_pair(
                jnp.asarray(da), jnp.asarray(db),
                jnp.zeros(cap, bool), jnp.zeros(cap, bool), col_tile=128,
            )
        )
        assert np.all(idx == -1)


class TestBatch:
    def test_batch_matches_single(self, rng):
        cap = 512
        bank = np.zeros((4, cap, 128), np.float32)
        mask = np.zeros((4, cap), bool)
        for i in range(4):
            n = 100 + 30 * i
            bank[i, :n] = _unit(rng, n)
            mask[i, :n] = True
        pairs = np.array([[0, 1], [2, 3], [1, 3]], np.int32)
        out = np.asarray(
            match_pairs_batch(
                jnp.asarray(bank), jnp.asarray(mask), jnp.asarray(pairs), col_tile=128
            )
        )
        for k, (a, b) in enumerate(pairs):
            single = np.asarray(
                match_descriptors_pair(
                    jnp.asarray(bank[a]), jnp.asarray(bank[b]),
                    jnp.asarray(mask[a]), jnp.asarray(mask[b]), col_tile=128,
                )
            )
            np.testing.assert_array_equal(out[k], single)

    def test_matches_to_pairs(self):
        idx = np.array([-1, 5, -1, 2], np.int32)
        i, j = matches_to_pairs(idx)
        np.testing.assert_array_equal(i, [1, 3])
        np.testing.assert_array_equal(j, [5, 2])


class TestAgainstOpenCV:
    def test_ratio_match_agrees_with_bfmatcher(self, rng):
        cv2 = __import__("cv2")
        da, db, ma, mb, _ = _planted_pair(rng, n=400, cap=512, noise=0.2)
        idx = np.asarray(
            match_descriptors_pair(
                jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
                ratio=0.8, max_distance=2.0, cross_check=False, col_tile=128,
            )
        )
        bf = cv2.BFMatcher(cv2.NORM_L2)
        knn = bf.knnMatch(da[:400], db[:400], k=2)
        cv_idx = np.full(512, -1, np.int32)
        for m in knn:
            if len(m) == 2 and m[0].distance < 0.8 * m[1].distance:
                cv_idx[m[0].queryIdx] = m[0].trainIdx
        agree = (idx == cv_idx).mean()
        assert agree > 0.97, f"agreement with cv2: {agree}"


class TestVocabRetrieval:
    def test_kmeans_and_retrieval(self, rng):
        from monocularsfm_tpu.ops.vocab import (
            quantize, retrieve_top_k, tfidf_signatures, train_visual_vocab,
        )
        import jax.numpy as jnp

        # 3 well-separated clusters of unit descriptors.
        centers = _unit(rng, 3)
        desc = np.concatenate([
            c + 0.05 * rng.normal(size=(200, 128)).astype(np.float32)
            for c in centers
        ])
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        vocab = train_visual_vocab(desc, num_words=64, iterations=8)
        assert vocab.shape == (64, 128)
        np.testing.assert_allclose(
            np.linalg.norm(vocab, axis=1), 1.0, atol=1e-5
        )

        # Images drawing from the same cluster retrieve each other.
        def image(cluster, n=100):
            d = centers[cluster] + 0.05 * rng.normal(size=(n, 128)).astype(np.float32)
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            out = np.zeros((128, 128), np.float32)
            m = np.zeros(128, bool)
            out[:n] = d[:128]
            m[:n] = True
            return out, m

        imgs = [image(c) for c in (0, 0, 1, 1, 2, 2)]
        hists = jnp.stack([
            quantize(jnp.asarray(d), jnp.asarray(m), jnp.asarray(vocab), 64)
            for d, m in imgs
        ])
        sig = tfidf_signatures(hists)
        _, nbrs = retrieve_top_k(sig, 1)
        nbrs = np.asarray(nbrs)[:, 0]
        partner = {0: 1, 1: 0, 2: 3, 3: 2, 4: 5, 5: 4}
        for i, j in partner.items():
            assert nbrs[i] == j, (i, nbrs[i])

    def test_vocab_matcher_end_to_end(self, tmp_path, rng):
        """VocabTreeFeatureMatcher finds the same pairs exhaustive matching
        verifies on a small planted collection."""
        from monocularsfm_tpu.database import Database
        from monocularsfm_tpu.config import MatchingConfig
        from monocularsfm_tpu.features.matching import VocabTreeFeatureMatcher

        # 4 images: (0,1) share a scene, (2,3) share a different one.
        scene_a = _unit(rng, 300)
        scene_b = _unit(rng, 300)
        uv = rng.uniform(10, 500, size=(4, 300, 2)).astype(np.float32)
        # Shared geometry for verifiable F: use identical uv in both views
        # (a trivially consistent epipolar configuration).
        db = Database(tmp_path / "v.db")
        ids = []
        for i, base in enumerate([scene_a, scene_a, scene_b, scene_b]):
            d = base + 0.03 * rng.normal(size=base.shape).astype(np.float32)
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            kp = np.concatenate(
                [uv[(i // 2) * 2], np.full((300, 1), 2.0, np.float32),
                 np.zeros((300, 1), np.float32)], axis=1
            )
            iid = db.write_image(f"im{i}.png")
            db.write_keypoints(iid, kp)
            db.write_descriptors(iid, d)
            ids.append(iid)
        db.close()

        cfg = MatchingConfig(
            vocab_num_words=64, vocab_num_neighbors=1,
            min_num_matches_verified=15, ransac_iterations=256,
        )
        m = VocabTreeFeatureMatcher(cfg)
        m.run_matching(str(tmp_path / "v.db"), log=lambda *a: None)

        db = Database(tmp_path / "v.db")
        got = {
            pair for pair, mat in db.read_all_matches().items() if len(mat) > 0
        }
        db.close()
        p = lambda a, b: (min(ids[a], ids[b]), max(ids[a], ids[b]))
        assert p(0, 1) in got
        assert p(2, 3) in got
        assert p(0, 2) not in got and p(1, 3) not in got


def test_match_pairs_batch_pallas_kernel_parity(rng):
    """The fused kernel (the GPU pipeline's matcher; here through the Pallas
    interpreter) must agree with the XLA scan matcher on a bf16 bank, as
    the pipeline uploads it."""
    import jax.numpy as jnp

    from monocularsfm_tpu.ops.matching import match_pairs_batch
    from monocularsfm_tpu.ops.pallas_matching import match_pairs_fused

    cap = 1024  # multiple of both matchers' tile sizes
    base = rng.standard_normal((cap, 128)).astype(np.float32)
    bank = []
    for i in range(3):
        d = base + 0.4 * rng.standard_normal(base.shape).astype(np.float32)
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        bank.append(d)
    bank = jnp.asarray(np.stack(bank), jnp.bfloat16)
    masks = jnp.ones((3, cap), bool)
    pairs = jnp.asarray([[0, 1], [1, 2]], jnp.int32)
    out_xla = np.asarray(match_pairs_batch(bank, masks, pairs, kernel="xla"))
    out_pal = np.asarray(
        match_pairs_fused(bank, masks, pairs, interpret=True))
    np.testing.assert_array_equal(out_xla, out_pal)


def test_opencv_matcher_backend_agrees_with_jax(tmp_path, rng):
    """MatchingConfig.backend="opencv" (the honest CPU-baseline path:
    BFMatcher knn2 + ratio + cross-check + cv2.findFundamentalMat, exactly
    FeatureUtils.cpp:141-206) must verify essentially the same matches as
    the device-batched path on a planted two-view scene."""
    import pytest

    cv2 = pytest.importorskip("cv2")
    from monocularsfm_tpu.database import Database
    from monocularsfm_tpu.config import MatchingConfig
    from monocularsfm_tpu.features.matching import SequentialFeatureMatcher

    n = 300
    base = _unit(rng, n)
    noisy = base + 0.03 * rng.normal(size=base.shape).astype(np.float32)
    noisy /= np.linalg.norm(noisy, axis=1, keepdims=True)
    # Planar scene -> uv2 is a homography of uv1 (consistent epipolar geom).
    uv1 = rng.uniform(20, 600, size=(n, 2)).astype(np.float32)
    uv2 = uv1 * 0.9 + 15.0

    results = {}
    for backend in ("jax", "opencv"):
        path = tmp_path / f"m_{backend}.db"
        db = Database(path)
        for d, uv in ((base, uv1), (noisy, uv2)):
            kp = np.concatenate(
                [uv, np.full((n, 1), 2.0, np.float32),
                 np.zeros((n, 1), np.float32)], axis=1)
            iid = db.write_image(f"im{len(results)}_{d[0,0]:.4f}.png")
            db.write_keypoints(iid, kp)
            db.write_descriptors(iid, d)
        db.close()
        cfg = MatchingConfig(overlap=1, backend=backend,
                             ransac_iterations=512)
        SequentialFeatureMatcher(cfg).run_matching(
            str(path), log=lambda *a: None)
        db = Database(path)
        mats = [m for m in db.read_all_matches().values() if len(m)]
        db.close()
        assert len(mats) == 1, backend
        results[backend] = {tuple(r) for r in mats[0]}

    inter = results["jax"] & results["opencv"]
    # Same semantics, different RANSAC implementations: demand >= 90% overlap.
    assert len(inter) >= 0.9 * max(len(results["jax"]),
                                   len(results["opencv"]))
