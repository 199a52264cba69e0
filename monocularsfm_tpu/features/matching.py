"""Matching stage: pair scheduling on host, batched matching on device.

Reference parity: src/Feature/FeatureMatching.cpp —
  MatchImagePairs pipeline: skip-if-exists -> cross/ratio match -> distance
  filter -> F-RANSAC geometric verification -> WriteMatches (:10-73)
  SequentialFeatureMatcher: each image vs previous `overlap` (:75-100)
  BruteFeatureMatcher: all pairs i>j in batches, optional VisualSFM-style
  preemptive filter on top-100-scale descriptors, keep pair if >= 4 matches
  (:102-178, citing Wu 2013)

Device design: descriptors live in a device-resident bank
(num_images, cap, 128); the host only decides *which* pairs to run; each
dispatch matches a whole slab of pairs (ops/matching.py), then geometric
verification runs as hypothesis-parallel F-RANSAC.  Every scheduling policy
is just a different pair-list generator feeding the same batched kernel.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from monocularsfm_tpu.config import MatchingConfig
from monocularsfm_tpu.database import Database
from monocularsfm_tpu.estimators import estimate_fundamental_ransac_batch
from monocularsfm_tpu.ops.matching import match_pairs_batch, matches_to_pairs


def _pad_pow2(n: int, minimum: int = 1024) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class _MatcherBase:
    def __init__(self, config: MatchingConfig | None = None, parallel=None):
        self.cfg = config or MatchingConfig()
        self.par = parallel  # ParallelConfig | None — pair-sharded dispatch
        self._mesh = None    # lazy; False = resolved unavailable
        self._key = jax.random.PRNGKey(1234)

    def _match_mesh(self):
        """Device mesh for pair-sharded matching (None = single-device)."""
        if self.par is None or not self.par.shard_matching:
            return None
        if self._mesh is None:
            if len(jax.devices()) < 2:
                self._mesh = False
            else:
                from monocularsfm_tpu.parallel import make_mesh

                shape = self.par.mesh_shape
                self._mesh = make_mesh(
                    shape[0] if shape else None, axis_name=self.par.data_axis
                )
        return self._mesh or None

    def _dispatch_match(self, bank, mask, ids, mesh, **kw):
        """One matching dispatch: pair-sharded over the mesh when present
        (each device matches its slab of pairs; ids length must then be a
        multiple of the mesh size), single-device otherwise."""
        if mesh is not None:
            from monocularsfm_tpu.parallel import sharded_match_pairs

            return sharded_match_pairs(bank, mask, np.asarray(ids), mesh, **kw)
        return match_pairs_batch(bank, mask, jnp.asarray(ids, jnp.int32), **kw)

    # -- descriptor bank -----------------------------------------------------
    def _load_bank(self, db: Database, image_ids: list[int]):
        """Device-resident (I, cap, 128) descriptor bank + masks + keypoints."""
        descs = {}
        kps = {}
        cap = 0
        for i in image_ids:
            d = db.read_descriptors(i)
            k = db.read_keypoints(i)
            if d is None or k is None:
                raise KeyError(f"image {i} has no features in the database")
            descs[i] = d
            kps[i] = k
            cap = max(cap, len(d))
        cap = _pad_pow2(cap)
        bank = np.zeros((len(image_ids), cap, 128), np.float32)
        mask = np.zeros((len(image_ids), cap), bool)
        for row, i in enumerate(image_ids):
            n = len(descs[i])
            bank[row, :n] = descs[i]
            mask[row, :n] = True
        if self.cfg.backend == "opencv":
            # The reference's CPU path matches the f32 descriptors on the
            # host; nothing goes to the device.
            return bank, mask, kps, cap
        # Both device matchers cast descriptors to bf16 before the
        # similarity matmul, so a bf16 bank gives the same matches at half
        # the host->device bytes.
        return (jnp.asarray(bank, dtype=jnp.bfloat16), jnp.asarray(mask),
                kps, cap)

    # -- geometric verification ---------------------------------------------
    def _verify_batch(self, uv_pairs: list[tuple[np.ndarray, np.ndarray]]):
        """F-RANSAC inlier masks for a slab of pairs in ONE device dispatch
        (FeatureUtils::FilterMatches semantics; the reference verifies pairs
        one cv::findFundamentalMat call at a time, FeatureMatching.cpp:49-60).

        uv_pairs: [(uv1 (n_i, 2), uv2 (n_i, 2)), ...].  Returns a list of
        bool (n_i,) inlier masks."""
        if not uv_pairs:
            return []
        from monocularsfm_tpu.estimators import rounds_to_confidence

        Bc = _pad_pow2(len(uv_pairs), minimum=min(8, self.cfg.pair_batch))
        cap = _pad_pow2(max(len(a) for a, _ in uv_pairs), minimum=512)
        x1 = np.zeros((Bc, cap, 2), np.float32)
        x2 = np.zeros((Bc, cap, 2), np.float32)
        m = np.zeros((Bc, cap), bool)
        for p, (uv1, uv2) in enumerate(uv_pairs):
            n = len(uv1)
            x1[p, :n], x2[p, :n], m[p, :n] = uv1, uv2, n >= 8
        x1j, x2j, mj = jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(m)

        def run_round():
            self._key, key = jax.random.split(self._key)
            return estimate_fundamental_ransac_batch(
                key, x1j, x2j, mj,
                threshold_px=self.cfg.ransac_threshold_px,
                num_hyps=self.cfg.ransac_iterations,
            )

        # Adaptive continuation to `ransac_confidence` (the conf argument of
        # cv::findFundamentalMat in FeatureUtils::FilterMatches): whenever any
        # pair's best model leaves the 1-(1-w^8)^k bound unmet, re-dispatch
        # the same compiled program with fresh hypotheses and keep the
        # per-pair better model.
        out = run_round()
        inl = np.asarray(out["inliers"])
        counts = inl.sum(axis=1)
        nvalid = m.sum(axis=1)
        rounds = 1
        while rounds < max(
            (
                rounds_to_confidence(
                    self.cfg.ransac_confidence, int(c), int(v), 8,
                    self.cfg.ransac_iterations,
                )
                for c, v in zip(counts[: len(uv_pairs)], nvalid[: len(uv_pairs)])
                if v >= 8
            ),
            default=1,
        ):
            out2 = run_round()
            inl2 = np.asarray(out2["inliers"])
            counts2 = inl2.sum(axis=1)
            better = counts2 > counts
            inl[better] = inl2[better]
            counts = np.maximum(counts, counts2)
            rounds += 1
        return [inl[p, : len(a)] for p, (a, _) in enumerate(uv_pairs)]

    # -- OpenCV CPU backend (the reference's exact match path) ---------------
    def _match_and_verify_pairs_cv2(self, db, bank, mask, kps, image_ids,
                                    pairs, log=print) -> int:
        """Per-pair cv2 BFMatcher knn2 + ratio + cross-check + distance
        filter + cv2.findFundamentalMat — byte-for-byte the reference's CPU
        matching loop (FeatureUtils.cpp:141-206, FeatureMatching.cpp:10-73).
        This is the honest CPU-baseline anchor, not a device path."""
        import cv2

        bank_h = np.asarray(bank, np.float32)  # cv2 only takes CV_32F
        mask_h = np.asarray(mask)
        row_of = {i: r for r, i in enumerate(image_ids)}
        cfg = self.cfg
        matcher = cv2.BFMatcher(cv2.NORM_L2)
        written = 0
        for a, b in pairs:
            if db.exist_matches(a, b):
                continue
            d1 = bank_h[row_of[a]][mask_h[row_of[a]]]
            d2 = bank_h[row_of[b]][mask_h[row_of[b]]]

            def ratio_matches(da, db_):
                out = {}
                if len(da) < 2 or len(db_) < 2:
                    return out
                for m in matcher.knnMatch(da, db_, k=2):
                    if len(m) == 2 and m[0].distance < \
                            cfg.distance_ratio * m[1].distance:
                        out[m[0].queryIdx] = (m[0].trainIdx, m[0].distance)
                return out

            m12 = ratio_matches(d1, d2)
            m21 = ratio_matches(d2, d1)
            # CrossCheck (FeatureUtils.cpp:281-310) + distance filter.
            if cfg.cross_check:
                keep = [
                    (q, t, dd) for q, (t, dd) in m12.items()
                    if m21.get(t, (-1, 0))[0] == q
                ]
            else:
                keep = [(q, t, dd) for q, (t, dd) in m12.items()]
            keep = [(q, t) for q, t, dd in keep if dd <= cfg.max_distance]
            if len(keep) < cfg.min_num_matches_verified:
                db.write_matches(a, b, np.zeros((0, 2), np.int32))
                continue
            i_idx = np.asarray([q for q, _ in keep], np.int32)
            j_idx = np.asarray([t for _, t in keep], np.int32)
            pts1 = kps[a][i_idx, :2].astype(np.float32)
            pts2 = kps[b][j_idx, :2].astype(np.float32)
            _, inl = cv2.findFundamentalMat(
                pts1, pts2, cv2.FM_RANSAC, cfg.ransac_threshold_px,
                cfg.ransac_confidence)
            if inl is None:
                inl = np.zeros(len(pts1), np.uint8)
            inl = inl.ravel().astype(bool)
            m = np.stack([i_idx[inl], j_idx[inl]], axis=1).astype(np.int32)
            if len(m) < cfg.min_num_matches_verified:
                m = np.zeros((0, 2), np.int32)
            db.write_matches(a, b, m)
            written += 1
            log(f"[match] ({a},{b}): {len(i_idx)} raw -> {len(m)} verified")
        return written

    # -- one batched dispatch over a pair slab -------------------------------
    def _match_and_verify_pairs(self, db, bank, mask, kps, image_ids, pairs,
                                log=print) -> int:
        """pairs: list of (image_id_a, image_id_b). Returns #pairs written."""
        if getattr(self.cfg, "backend", "jax") == "opencv":
            return self._match_and_verify_pairs_cv2(
                db, bank, mask, kps, image_ids, pairs, log)
        row_of = {i: r for r, i in enumerate(image_ids)}
        written = 0
        mesh = self._match_mesh()
        # With a mesh each device matches `pair_batch` pairs per dispatch.
        B = self.cfg.pair_batch * (mesh.devices.size if mesh is not None else 1)
        for start in range(0, len(pairs), B):
            chunk = [
                (a, b) for a, b in pairs[start : start + B]
                if not db.exist_matches(a, b)
            ]
            if not chunk:
                continue
            # Pad the chunk to the fixed dispatch width.
            padded = chunk + [chunk[-1]] * (B - len(chunk))
            ids = [[row_of[a], row_of[b]] for a, b in padded]
            idx_b = np.asarray(
                self._dispatch_match(
                    bank, mask, ids, mesh,
                    ratio=self.cfg.distance_ratio,
                    max_distance=self.cfg.max_distance,
                    cross_check=self.cfg.cross_check,
                )
            )
            # Collect the whole chunk's raw matches, then verify them all in
            # ONE batched F-RANSAC dispatch (no per-pair jit dispatches).
            to_verify = []   # (a, b, i_idx, j_idx)
            uv_pairs = []
            for p, (a, b) in enumerate(chunk):
                i_idx, j_idx = matches_to_pairs(idx_b[p])
                if len(i_idx) < self.cfg.min_num_matches_verified:
                    db.write_matches(a, b, np.zeros((0, 2), np.int32))
                    continue
                to_verify.append((a, b, i_idx, j_idx))
                uv_pairs.append((kps[a][i_idx, :2], kps[b][j_idx, :2]))
            for (a, b, i_idx, j_idx), inl in zip(
                to_verify, self._verify_batch(uv_pairs)
            ):
                m = np.stack([i_idx[inl], j_idx[inl]], axis=1).astype(np.int32)
                if len(m) < self.cfg.min_num_matches_verified:
                    m = np.zeros((0, 2), np.int32)
                db.write_matches(a, b, m)
                written += 1
                log(f"[match] ({a},{b}): {len(i_idx)} raw -> {len(m)} verified")
        return written

    # -- preemptive filter (VisualSFM / Wu 2013) -----------------------------
    def _preemptive_keep(self, db, image_ids, pairs, log=print):
        """Match top-scale descriptor subsets; keep pairs with >= threshold
        matches (FeatureMatching.cpp:148-178)."""
        cfg = self.cfg
        sub = {}
        for i in image_ids:
            d = db.read_descriptors(i)
            k = db.read_keypoints(i)
            order = np.argsort(-k[:, 2], kind="stable")[: cfg.preemptive_num_features]
            sub[i] = d[order]
        cap = _pad_pow2(cfg.preemptive_num_features, minimum=128)
        bank = np.zeros((len(image_ids), cap, 128), np.float32)
        mask = np.zeros((len(image_ids), cap), bool)
        row_of = {i: r for r, i in enumerate(image_ids)}
        for i in image_ids:
            n = len(sub[i])
            bank[row_of[i], :n] = sub[i]
            mask[row_of[i], :n] = True
        bank_j, mask_j = jnp.asarray(bank), jnp.asarray(mask)
        kept = []
        # The reference walks brute pairs in host batches of max_pairs_size
        # and preemptively filters each batch (FeatureMatching.cpp:110-142);
        # here that batch is one padded device dispatch.
        B = _pad_pow2(self.cfg.max_pairs_size, minimum=64)
        for start in range(0, len(pairs), B):
            chunk = pairs[start : start + B]
            padded = chunk + [chunk[-1]] * (B - len(chunk))
            ids = jnp.asarray([[row_of[a], row_of[b]] for a, b in padded], jnp.int32)
            idx_b = np.asarray(
                match_pairs_batch(
                    bank_j, mask_j, ids,
                    ratio=cfg.distance_ratio, max_distance=2.0,
                    cross_check=False, col_tile=cap,
                )
            )
            for p, (a, b) in enumerate(chunk):
                if (idx_b[p] >= 0).sum() >= cfg.preemptive_min_num_matches:
                    kept.append((a, b))
        log(f"[match] preemptive filter kept {len(kept)}/{len(pairs)} pairs")
        return kept


class SequentialFeatureMatcher(_MatcherBase):
    """Each image vs its `overlap` predecessors (video-style collections)."""

    def run_matching(self, database_path: str, log=print) -> int:
        db = Database(database_path)
        try:
            image_ids = sorted(db.read_all_images().keys())
            bank, mask, kps, _ = self._load_bank(db, image_ids)
            pairs = [
                (image_ids[i - k], image_ids[i])
                for i in range(len(image_ids))
                for k in range(1, self.cfg.overlap + 1)
                if i - k >= 0
            ]
            return self._match_and_verify_pairs(
                db, bank, mask, kps, image_ids, pairs, log
            )
        finally:
            db.close()


class VocabTreeFeatureMatcher(_MatcherBase):
    """Retrieval-based matching via a visual vocabulary (ops/vocab.py).

    The reference declares this matcher but never implements it
    (include/Feature/FeatureMatching.h:137-141).  Here: train a K-word
    vocabulary on the collection's own descriptors, build TF-IDF image
    signatures, retrieve `num_neighbors` partners per image with one
    similarity matmul, and feed those pairs through the standard
    match-and-verify pipeline.  Complexity drops from O(I^2) full matching
    to O(I * num_neighbors)."""

    def run_matching(self, database_path: str, log=print) -> int:
        from monocularsfm_tpu.ops.vocab import (
            quantize_batch, retrieve_top_k, tfidf_signatures,
            train_visual_vocab,
        )

        cfg = self.cfg
        db = Database(database_path)
        try:
            image_ids = sorted(db.read_all_images().keys())
            bank, mask, kps, cap = self._load_bank(db, image_ids)
            n_desc = int(np.asarray(mask).sum())
            num_words = min(cfg.vocab_num_words, max(64, n_desc // 2))
            flat = np.asarray(bank)[np.asarray(mask)]
            log(f"[match] training {num_words}-word vocab on {len(flat)} descriptors")
            vocab = jnp.asarray(train_visual_vocab(flat, num_words=num_words))
            hists = quantize_batch(bank, mask, vocab, num_words)
            sig = tfidf_signatures(hists)
            k = min(cfg.vocab_num_neighbors, len(image_ids) - 1)
            _, nbrs = retrieve_top_k(sig, k)
            nbrs = np.asarray(nbrs)
            pairs = sorted({
                (min(image_ids[i], image_ids[int(j)]),
                 max(image_ids[i], image_ids[int(j)]))
                for i in range(len(image_ids)) for j in nbrs[i]
            })
            log(f"[match] retrieval kept {len(pairs)} pairs "
                f"(exhaustive would be {len(image_ids)*(len(image_ids)-1)//2})")
            return self._match_and_verify_pairs(
                db, bank, mask, kps, image_ids, pairs, log
            )
        finally:
            db.close()


class BruteFeatureMatcher(_MatcherBase):
    """All pairs i < j, optional preemptive pruning."""

    def run_matching(self, database_path: str, log=print) -> int:
        db = Database(database_path)
        try:
            image_ids = sorted(db.read_all_images().keys())
            pairs = [
                (image_ids[i], image_ids[j])
                for i in range(len(image_ids))
                for j in range(i + 1, len(image_ids))
            ]
            if self.cfg.is_preemptive:
                pairs = self._preemptive_keep(db, image_ids, pairs, log)
            bank, mask, kps, _ = self._load_bank(db, image_ids)
            return self._match_and_verify_pairs(
                db, bank, mask, kps, image_ids, pairs, log
            )
        finally:
            db.close()
