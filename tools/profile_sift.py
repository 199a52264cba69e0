"""Per-stage SIFT extraction profile on the current backend.

Times each device stage of SIFT.extract_batch separately; every stage is
timed to the end of its device work (block_until_ready), without copying
its outputs to the host.

Usage: python tools/profile_sift.py [--width 1280 --height 960 --batch 4]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def sync(*arrs):
    jax.block_until_ready(arrs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--modes", default="gather,patch")
    args = ap.parse_args()

    from monocularsfm_tpu.ops import sift as S
    from monocularsfm_tpu.utils.synthetic import render_textured_images

    imgs, _, _, _ = render_textured_images(
        scene_seed=5, num_cameras=args.batch,
        width=args.width, height=args.height)
    print(f"backend={jax.default_backend()} imgs={imgs.shape}", flush=True)

    for mode in args.modes.split(","):
        ex = S.SIFT(sample_mode=mode)
        imgs_j = jnp.asarray(np.asarray(imgs, np.float32) / 255.0)

        for it in range(3):
            t0 = time.perf_counter()
            kps, descs = ex.extract_batch(imgs)
            t1 = time.perf_counter()
            nf = [len(k) for k in kps]
            print(f"[{mode}] extract_batch[{it}]: {t1-t0:.3f}s  feats={nf}",
                  flush=True)

        def run_stages(label):
            t0 = time.perf_counter()
            base = S._base_image_batched(imgs_j, upsample=ex.upsample)
            sync(base)
            t_base = time.perf_counter() - t0
            H0, W0 = base.shape[1:]
            num_octaves = max(
                min(int(np.round(np.log2(min(H0, W0)))) - 3, 8), 1)
            g = base
            per_oct = []
            for o in range(num_octaves):
                row = {}
                t0 = time.perf_counter()
                gauss = S._build_octave_batched(g)
                sync(gauss)
                row["pyr"] = time.perf_counter() - t0
                h, w_ = g.shape[1:]
                if ex.decay_octave_budget:
                    k_oct = max(ex.k_per_octave >> max(0, o - 1), 256)
                else:
                    k_oct = ex.k_per_octave
                k_oct = min(k_oct, S.N_SCALES * h * w_)
                t0 = time.perf_counter()
                det = S._detect_octave_batched(
                    gauss, k_oct, ex.contrast_threshold)
                sync(det)
                row["detect"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                if mode == "patch":
                    out = S._orient_describe_patch_batched(gauss, det)
                else:
                    out = S._orient_describe_batched(gauss, det)
                sync(out)
                row["orient_desc"] = time.perf_counter() - t0
                row["K"] = k_oct
                g = gauss[:, S.N_SCALES, ::2, ::2]
                per_oct.append(row)
                if min(g.shape[1:]) < 16:
                    break
            print(f"--- {mode} / {label} ---", flush=True)
            print(f"base: {t_base*1e3:8.1f} ms")
            tot = {"pyr": 0.0, "detect": 0.0, "orient_desc": 0.0}
            for o, row in enumerate(per_oct):
                print(
                    f"oct{o}: pyr {row['pyr']*1e3:8.1f}  detect "
                    f"{row['detect']*1e3:8.1f}  orient+desc "
                    f"{row['orient_desc']*1e3:8.1f} ms   K={row['K']}",
                    flush=True)
                for k in tot:
                    tot[k] += row[k]
            print(f"SUM : pyr {tot['pyr']*1e3:8.1f}  detect "
                  f"{tot['detect']*1e3:8.1f}  orient+desc "
                  f"{tot['orient_desc']*1e3:8.1f} ms", flush=True)

        run_stages("warmup")
        for r in range(args.reps):
            run_stages(f"rep {r}")


if __name__ == "__main__":
    main()
