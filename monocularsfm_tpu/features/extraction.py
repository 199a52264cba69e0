"""Feature extraction stage: images -> keypoints/colors/descriptors in SQLite.

Reference parity: src/Feature/FeatureExtraction.cpp —
  glob images (:169-183), downscale to max_image_size (:237-258), SIFT
  detect/compute with top-scale retention (FeatureUtils.cpp:14-96), rescale
  keypoints back to original coords + sample pixel colors (:128-141),
  L1-root normalisation (:143-145), per-image DB transaction + skip-if-
  exists resume (:69-160).

Two backends behind one interface (the reference declares FeatureExtractorGPU
but never implements it, FeatureExtraction.h:62-67 — here both are real):
  - "jax": the XLA SIFT in ops/sift.py (the device path)
  - "opencv": host cv2.SIFT fallback, kept for cross-validation

Images are read through io/images.py: binary PGM/PPM need only numpy,
compressed formats need OpenCV.
"""

from __future__ import annotations

import pathlib

import numpy as np

from monocularsfm_tpu.config import ExtractionConfig
from monocularsfm_tpu.database import Database
from monocularsfm_tpu.io.images import PNM_EXTS, read_image, resize, to_gray

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"} | PNM_EXTS


def list_images(images_path: str) -> list[pathlib.Path]:
    root = pathlib.Path(images_path)
    return sorted(
        p for p in root.iterdir() if p.suffix.lower() in IMAGE_EXTS
    )


def _load_gray_and_color(path):
    bgr = read_image(path)
    return to_gray(bgr), bgr


def _scale_for(max_size: int, h: int, w: int) -> float:
    m = max(h, w)
    return 1.0 if m <= max_size else max_size / m


class FeatureExtractor:
    def __init__(self, config: ExtractionConfig | None = None):
        self.cfg = config or ExtractionConfig()
        self._sift = None

    def _get_sift(self):
        if self._sift is None:
            if self.cfg.backend == "jax":
                from monocularsfm_tpu.ops.sift import SIFT

                self._sift = SIFT(
                    num_features=self.cfg.num_features,
                    normalization=self.cfg.normalization,
                    decay_octave_budget=self.cfg.decay_octave_budget,
                    sample_mode=self.cfg.sample_mode,
                    transfer_dtype=self.cfg.transfer_dtype,
                )
            else:
                import cv2

                self._sift = cv2.SIFT_create(nfeatures=self.cfg.num_features)
        return self._sift

    def extract_one(self, gray: np.ndarray, bgr: np.ndarray | None = None):
        """Returns (keypoints (N, 4) x,y,size,angle in original coords,
        colors (N, 3) uint8 BGR, descriptors (N, 128) float32)."""
        h, w = gray.shape[:2]
        scale = _scale_for(self.cfg.max_image_size, h, w)
        gray_s = (resize(gray, int(w * scale), int(h * scale))
                  if scale != 1.0 else gray)
        sift = self._get_sift()
        if self.cfg.backend == "jax":
            kps, desc = sift.extract(gray_s)
        else:
            cv_kps, desc = sift.detectAndCompute(gray_s, None)
            kps = np.array(
                [[k.pt[0], k.pt[1], k.size, k.angle] for k in cv_kps], np.float32
            ).reshape(-1, 4)
            desc = (
                desc.astype(np.float32)
                if desc is not None
                else np.zeros((0, 128), np.float32)
            )
            # Match reference normalisation for the cv2 backend too.
            if self.cfg.normalization == "l1_root":
                desc = desc / np.maximum(np.abs(desc).sum(1, keepdims=True), 1e-12)
                desc = np.sqrt(desc)
            else:
                desc = desc / np.maximum(
                    np.linalg.norm(desc, axis=1, keepdims=True), 1e-12
                )
        # Rescale keypoints to original image coordinates (reference :128-141).
        if scale != 1.0:
            kps = kps.copy()
            kps[:, :3] /= scale  # x, y and size
        # Sample colors at (rounded) keypoint positions.
        if bgr is not None and len(kps):
            xi = np.clip(np.round(kps[:, 0]).astype(int), 0, w - 1)
            yi = np.clip(np.round(kps[:, 1]).astype(int), 0, h - 1)
            colors = bgr[yi, xi]
        else:
            colors = np.zeros((len(kps), 3), np.uint8)
        return kps, colors.astype(np.uint8), desc

    def run_extraction(self, images_path: str, database_path: str,
                       log=print) -> int:
        """Process a directory into the database; resumes idempotently.

        With the jax backend, same-sized images are processed in batches of
        cfg.batch_size — one device dispatch per octave covers the whole
        batch (image-parallel extraction)."""
        db = Database(database_path)
        count = 0
        try:
            pending = []
            for path in list_images(images_path):
                name = path.name
                if db.exist_image(name):
                    image_id = db.read_image_id(name)
                    if db.exist_keypoints(image_id) and db.exist_descriptors(image_id):
                        continue  # resume: already done
                else:
                    image_id = db.write_image(name)
                pending.append((image_id, name, path))

            if self.cfg.backend != "jax":
                for image_id, name, path in pending:
                    gray, bgr = _load_gray_and_color(path)
                    kps, colors, desc = self.extract_one(gray, bgr)
                    self._write(db, image_id, kps, colors, desc)
                    count += 1
                    log(f"[extract] {name}: {len(kps)} features")
                return count

            # jax backend: group by post-resize shape, dispatch in batches.
            batch, metas = [], []

            def eff_batch_size(h, w):
                """Memory guard: the octave-0 working set is ~23 fp32 planes per
                image at 4x the input pixel count (2x upsample), so cap the
                batch to cfg.batch_pixel_budget upsampled pixels."""
                px = 4 * h * w
                return max(1, min(self.cfg.batch_size,
                                  self.cfg.batch_pixel_budget // px))

            def flush():
                nonlocal count
                if not batch:
                    return
                sift = self._get_sift()
                # Pad partial batches with zero images (dropped below) to
                # eff_batch_size(h, w) — the compiled batch dimension varies
                # per image shape — so each (eff_batch, H, W) compiles once.
                n_real = len(batch)
                h, w = batch[0].shape[:2]
                while len(batch) < eff_batch_size(h, w):
                    batch.append(np.zeros_like(batch[0]))
                kps_list, desc_list = sift.extract_batch(np.stack(batch))
                kps_list, desc_list = kps_list[:n_real], desc_list[:n_real]
                for (image_id, name, bgr, scale, w, h), kps, desc in zip(
                    metas, kps_list, desc_list
                ):
                    if scale != 1.0:
                        kps = kps.copy()
                        kps[:, :3] /= scale
                    if len(kps):
                        xi = np.clip(np.round(kps[:, 0]).astype(int), 0, w - 1)
                        yi = np.clip(np.round(kps[:, 1]).astype(int), 0, h - 1)
                        colors = bgr[yi, xi].astype(np.uint8)
                    else:
                        colors = np.zeros((0, 3), np.uint8)
                    self._write(db, image_id, kps, colors, desc)
                    count += 1
                    log(f"[extract] {name}: {len(kps)} features")
                batch.clear()
                metas.clear()

            for image_id, name, path in pending:
                gray, bgr = _load_gray_and_color(path)
                h, w = gray.shape[:2]
                scale = _scale_for(self.cfg.max_image_size, h, w)
                gray_s = (resize(gray, int(w * scale), int(h * scale))
                          if scale != 1.0 else gray)
                if batch and batch[0].shape != gray_s.shape:
                    flush()
                batch.append(gray_s)
                metas.append((image_id, name, bgr, scale, w, h))
                if len(batch) >= eff_batch_size(*gray_s.shape[:2]):
                    flush()
            flush()
        finally:
            db.close()
        return count

    @staticmethod
    def _write(db, image_id, kps, colors, desc):
        db.begin_transaction()
        db.write_keypoints(image_id, kps)
        db.write_keypoints_color(image_id, colors)
        db.write_descriptors(image_id, desc)
        db.end_transaction()
