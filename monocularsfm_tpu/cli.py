"""The `sfm` command-line interface.

Reference parity: the reference ships four binaries (sfm/FeatureExtraction,
ComputeMatches, CheckMatches, Reconstruction) chained by pipeline.py via
os.system; here one CLI with subcommands covers the same stages plus export
(SURVEY.md component #21 plan):

    sfm extract     <config.yaml>   images -> features in SQLite
    sfm match       <config.yaml>   features -> verified matches in SQLite
    sfm check-matches <config.yaml> print per-pair match statistics
    sfm reconstruct <config.yaml>   matches -> poses + points + exports
    sfm pipeline    <config.yaml>   all of the above in order

The SQLite database file is the only interface between stages, exactly like
the reference, so any stage can be killed and re-run idempotently.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np


def cmd_extract(cfg, log=print):
    from monocularsfm_tpu.features.extraction import FeatureExtractor

    t0 = time.perf_counter()
    n = FeatureExtractor(cfg.extraction).run_extraction(
        cfg.images_path, cfg.database_path, log=log
    )
    log(f"[extract] processed {n} images in {time.perf_counter()-t0:.1f}s")


def cmd_match(cfg, log=print):
    from monocularsfm_tpu.features.matching import (
        BruteFeatureMatcher,
        SequentialFeatureMatcher,
        VocabTreeFeatureMatcher,
    )

    t0 = time.perf_counter()
    cls = {
        "sequential": SequentialFeatureMatcher,
        "vocab": VocabTreeFeatureMatcher,
    }.get(cfg.matching.match_type, BruteFeatureMatcher)
    n = cls(cfg.matching, parallel=cfg.parallel).run_matching(
        cfg.database_path, log=log
    )
    log(f"[match] wrote {n} pairs in {time.perf_counter()-t0:.1f}s")


def cmd_check_matches(cfg, log=print, render_dir=None):
    from monocularsfm_tpu.database import Database

    db = Database(cfg.database_path)
    try:
        names = db.read_all_images()
        matches = db.read_all_matches()
        log(f"images: {len(names)}  match pairs: {len(matches)}")
        counts = sorted(
            ((len(m), a, b) for (a, b), m in matches.items()), reverse=True
        )
        for cnt, a, b in counts[:50]:
            log(f"  {names.get(a, a)} -- {names.get(b, b)}: {cnt}")
        if render_dir:
            # Headless ShowMatches: render the top pairs to PNGs.
            import cv2

            from monocularsfm_tpu.utils.debug_draw import draw_matches

            out = pathlib.Path(render_dir)
            out.mkdir(parents=True, exist_ok=True)
            root = pathlib.Path(cfg.images_path)
            for cnt, a, b in counts[:20]:
                if cnt == 0:
                    continue
                m = matches[(a, b)]
                k1 = db.read_keypoints(a)
                k2 = db.read_keypoints(b)
                i1 = cv2.imread(str(root / names[a]))
                i2 = cv2.imread(str(root / names[b]))
                if i1 is None or i2 is None:
                    continue
                draw_matches(
                    i1, i2, k1[m[:, 0], :2], k2[m[:, 1], :2],
                    out / f"matches_{a}_{b}.png",
                )
        nonzero = [c for c, _, _ in counts if c > 0]
        if nonzero:
            log(
                f"mean matches/pair: {np.mean(nonzero):.1f}  "
                f"median: {np.median(nonzero):.0f}"
            )
    finally:
        db.close()


def cmd_reconstruct(cfg, log=print):
    from monocularsfm_tpu.database import Database
    from monocularsfm_tpu.reconstruction import MapBuilder

    db = Database(cfg.database_path)
    try:
        names = db.read_all_images()
        keypoints = {}
        colors = {}
        for i in names:
            k = db.read_keypoints(i)
            if k is None:
                continue
            keypoints[i] = k
            c = db.read_keypoints_color(i)
            colors[i] = c if c is not None else np.zeros((len(k), 3), np.uint8)
        matches = {p: m for p, m in db.read_all_matches().items() if len(m)}
    finally:
        db.close()

    builder = MapBuilder(cfg)
    builder._log = log
    builder.setup(matches, keypoints, colors=colors, names=names)
    summary = builder.do_build()
    log(str(summary))

    out = pathlib.Path(cfg.output_path or ".")
    out.mkdir(parents=True, exist_ok=True)
    cmd_export(cfg, builder.map, out, log=log)
    return builder


def cmd_export(cfg, map_obj, out_dir, log=print):
    from monocularsfm_tpu.io import (
        write_colmap,
        write_openmvs,
        write_ply,
        write_ply_binary,
    )

    out = pathlib.Path(out_dir)
    write_colmap(map_obj, out / "colmap")
    write_ply(map_obj, out / "cloud.ply")
    write_ply_binary(map_obj, out / "cloud_binary.ply")
    write_openmvs(
        map_obj, out / "scene.mvs", image_dir=cfg.images_path,
        images_path=cfg.images_path, dist=cfg.camera.dist_coeffs(), log=log,
    )
    log(f"[export] COLMAP/PLY/OpenMVS written to {out}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="sfm", description="Incremental Structure-from-Motion on an accelerator"
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("extract", "match", "check-matches", "reconstruct", "pipeline"):
        p = sub.add_parser(name)
        p.add_argument(
            "config", help="YAML or JSON config (reference-style or nested)")
        if name == "check-matches":
            p.add_argument(
                "--render-dir", default=None,
                help="write side-by-side match PNGs for the top pairs here",
            )
    args = parser.parse_args(argv)

    from monocularsfm_tpu.config import load_yaml

    cfg = load_yaml(args.config)
    if args.command == "extract":
        cmd_extract(cfg)
    elif args.command == "match":
        cmd_match(cfg)
    elif args.command == "check-matches":
        cmd_check_matches(cfg, render_dir=args.render_dir)
    elif args.command == "reconstruct":
        cmd_reconstruct(cfg)
    elif args.command == "pipeline":
        cmd_extract(cfg)
        cmd_match(cfg)
        cmd_reconstruct(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
