"""Full pipeline on rendered images: extract -> match -> reconstruct -> export.

This is the complete user journey (the reference's pipeline.py) with real
pictures: a textured plane rendered from known camera poses, written to disk
as PGM with a JSON config, processed purely through the CLI surface — with
OpenCV and PyYAML made unimportable, so the main path needs only JAX, numpy
and scipy.
"""

import json
import sys

import numpy as np

from monocularsfm_tpu import cli
from monocularsfm_tpu.config import load_yaml
from monocularsfm_tpu.io.images import write_image
from monocularsfm_tpu.utils.synthetic import render_textured_images, similarity_align


def test_pipeline_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "yaml", None)
    W, H, focal = 320, 240, 300.0
    imgs, K, R_gt, t_gt = render_textured_images(
        num_cameras=6, width=W, height=H, focal=focal, arc_deg=50.0, scene_seed=9
    )
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i, im in enumerate(imgs):
        write_image(img_dir / f"frame_{i:04d}.pgm", im)

    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({
        "images_path": str(img_dir),
        "database_path": str(tmp_path / "db.db"),
        "SIFTextractor.max_image_size": 1000,
        "SIFTextractor.num_features": 1200,
        "SIFTmatch.match_type": 1,
        "Camera.fx": focal,
        "Camera.fy": focal,
        "Camera.cx": W / 2,
        "Camera.cy": H / 2,
        "Reconstruction.output_path": str(tmp_path / "out"),
        "extraction": {"batch_size": 2},
    }))
    assert cli.main(["pipeline", str(cfg_path)]) == 0

    out = tmp_path / "out"
    assert (out / "colmap" / "images.txt").exists()
    assert (out / "cloud.ply").exists()
    assert (out / "scene.mvs").exists()

    from monocularsfm_tpu.io.colmap import read_colmap

    model = read_colmap(out / "colmap")
    n_reg = len(model["images"])
    assert n_reg >= 5, f"only {n_reg}/6 images registered"
    assert len(model["points"]) > 150

    # Trajectory parity up to similarity: match by image name -> index.
    est, gt = [], []
    for image_id, im in model["images"].items():
        idx = int(im["name"].split("_")[1].split(".")[0])
        est.append(-im["R"].T @ im["t"])
        gt.append(-R_gt[idx].T @ t_gt[idx])
    est, gt = np.array(est), np.array(gt)
    _, rms = similarity_align(est, gt)
    scale = np.linalg.norm(gt - gt.mean(0), axis=1).mean()
    assert rms / scale < 0.05, f"trajectory error {rms/scale:.4f}"

    # Resume is a no-op second time around (idempotent stages).
    from monocularsfm_tpu.database import Database

    db = Database(tmp_path / "db.db")
    n_before = db.num_matches()
    db.close()
    cfg = load_yaml(cfg_path)
    cli.cmd_extract(cfg, log=lambda *a: None)
    db = Database(tmp_path / "db.db")
    assert db.num_matches() == n_before
    db.close()
