#!/usr/bin/env python3
"""Smoke test of the SfM engine on an NVIDIA GPU.

    python chip_smoke.py               # one GPU: phases 0-3
    python chip_smoke.py --four-gpus   # four GPUs: phase 4 only

Everything runs in this one process; the only child is `nvidia-smi`, which
stays off JAX.  Any failed check raises, so the script exits non-zero; it
also refuses to run (exit 2) when JAX finds no GPU.  The last line of
standard output is the JSON verdict

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases:
  0 device: card name and power limit, JAX version, device kind and count,
    the compile-cache directory, whether the native C++ core loaded.
  1 kernel parity on the card at real widths: the fused Triton matcher vs
    the XLA scan matcher (16 pairs at bank capacity 8192 x 128, through
    match_pairs_batch); the SIFT pyramid blur at (4, 1920, 2560) vs a
    float64 host reference; bundle adjustment on the GPU vs the CPU (a
    TF32 leak into geometry shows as a different final RMSE).
  2 kernel timing: median of 25 runs of each matcher form, each run ending
    in block_until_ready.
  3 pipeline: 32 rendered 1280x960 images (the mp128 collection of
    tools/scale_run.py cut to 32 images, its arc cut to 50 degrees so the
    step between cameras stays ~1.6 degrees) written as PGM with a JSON
    config, run through `cli.main(["pipeline", cfg])` and gated against
    the rendered ground truth.
  4 --four-gpus: the phase-3 collection on four GPUs with the default
    parallel config (sharded matching and sharded global BA), then the same
    collection in the same process with sharding off; both pass the phase-3
    gates, registered counts differ by at most one, and the sharded calls'
    outputs live on all four devices.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import jax

REPO = pathlib.Path(__file__).resolve().parent

# Phase-3 collection and its gates.
NUM_IMAGES = 32
WIDTH, HEIGHT = 1280, 960
ARC_DEG = 50.0
NUM_FEATURES = 8024          # -> bank capacity 8192
OVERLAP = 12
MIN_REGISTERED = 30
MAX_MEAN_REPROJ_PX = 1.0
MAX_CENTER_RMS_PCT = 1.0

# Phase-1/2 shapes.
MATCH_IMAGES, MATCH_CAP, MATCH_PAIRS = 32, 8192, 16
BLUR_SHAPE = (4, 1920, 2560)


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)
    log(f"  ok: {msg}")


def median_time(fn, runs=25):
    jax.block_until_ready(fn())
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# -- phase 0 -----------------------------------------------------------------
def phase_device():
    import monocularsfm_tpu
    from monocularsfm_tpu import native

    log("== phase 0: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip())
    devs = jax.devices()
    log(f"jax {jax.__version__}; {devs[0].device_kind} x {len(devs)}")
    log(f"compile cache: {monocularsfm_tpu.compile_cache_dir()}")
    log(f"native C++ core loaded: {native.available()}")


# -- phase 1/2: kernels --------------------------------------------------------
def _match_inputs(num_images, cap, num_pairs, seed=0):
    """Noisy copies of one descriptor set (plenty of matches and near-ties),
    the last 2% of every image masked out."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((cap, 128)).astype(np.float32)
    bank = base + 0.35 * rng.standard_normal(
        (num_images, cap, 128)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    mask = np.ones((num_images, cap), bool)
    mask[:, cap - cap // 50:] = False
    pairs = np.array([[i, (i + 1) % num_images] for i in range(num_pairs)],
                     np.int32)
    return (jax.numpy.asarray(bank, jax.numpy.bfloat16),
            jax.numpy.asarray(mask), jax.numpy.asarray(pairs))


def check_matcher_parity(bank, mask, pairs):
    """The fused kernel against the XLA scan: identical maps except where
    two candidates tie in the bf16-input / f32-accumulated similarity."""
    from monocularsfm_tpu.ops.matching import match_pairs_batch

    ref = np.asarray(match_pairs_batch(bank, mask, pairs, kernel="xla"))
    out = np.asarray(match_pairs_batch(bank, mask, pairs, kernel="triton"))
    agree = float((out == ref).mean())
    log(f"matcher: {pairs.shape[0]} pairs at {bank.shape[1]}x"
        f"{bank.shape[2]}: idx_b agreement {agree:.6f}, "
        f"{(ref >= 0).mean():.4f} of rows matched")
    check(agree >= 0.999, "fused matcher agrees with the XLA scan on "
          ">= 99.9% of idx_b")
    # Every disagreement must be a near-tie: the two candidate columns'
    # similarities (f32 over the bf16 inputs) within 1e-3.
    b = np.asarray(bank.astype(np.float32))
    worst = 0.0
    for p, i in zip(*np.nonzero(out != ref)):
        ia, ib = np.asarray(pairs[p])
        cands = [j for j in (out[p, i], ref[p, i]) if j >= 0]
        if len(cands) == 2:
            sims = b[ib][cands] @ b[ia][i]
            worst = max(worst, float(abs(sims[0] - sims[1])))
    log(f"matcher: largest similarity gap among disagreements {worst:.2e}")
    check(worst <= 1e-3, "every matcher disagreement is a near-tie")


def check_blur_parity(shape):
    """The pyramid's separable blurs on the card vs correlate1d in float64
    on the host, with the same taps and replicated edges."""
    from scipy.ndimage import correlate1d

    from monocularsfm_tpu.ops import sift

    B, H, W = shape
    rng = np.random.default_rng(1)
    # A 1280x960 frame upsampled 2x, as extraction builds octave 0.
    small = rng.random((B, H // 2, W // 2)).astype(np.float32)
    base = jax.vmap(lambda im: jax.image.resize(
        im, (H, W), method="linear"))(jax.numpy.asarray(small))
    out = np.asarray(sift._build_octave_batched(base))
    base_h = np.asarray(base, np.float64)
    err = 0.0
    for c, ker in enumerate(sift._OCT_KER.astype(np.float64)):
        ref = correlate1d(correlate1d(base_h, ker, axis=1, mode="nearest"),
                          ker, axis=2, mode="nearest")
        err = max(err, float(np.abs(out[:, c + 1] - ref).max()))
    log(f"blur: {shape}: max abs error vs float64 host {err:.2e}")
    check(err <= 1e-5, "pyramid blur within 1e-5 of the host reference")
    return base


def check_ba_precision():
    """bundle_adjust on the GPU and on the host CPU in this process."""
    sys.path.insert(0, str(REPO))
    import bench
    from monocularsfm_tpu.optim import bundle_adjust

    prob, nobs = bench._ring_problem(64, 20000, 8)
    gpu = float(bundle_adjust(prob, max_iterations=50)["rmse_final"])
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu = float(bundle_adjust(jax.device_put(prob, cpu_dev),
                                  max_iterations=50)["rmse_final"])
    log(f"BA: 64 cams, {nobs} obs: rmse_final gpu {gpu:.7f} px, "
        f"cpu {cpu:.7f} px")
    check(abs(gpu - cpu) <= 1e-3, "BA final RMSE on GPU within 1e-3 px of CPU")


def phase_kernels():
    from monocularsfm_tpu.ops import sift
    from monocularsfm_tpu.ops.matching import match_pairs_batch

    log("== phase 1: kernel parity at real widths")
    bank, mask, pairs = _match_inputs(MATCH_IMAGES, MATCH_CAP, MATCH_PAIRS)
    check_matcher_parity(bank, mask, pairs)
    base = check_blur_parity(BLUR_SHAPE)
    check_ba_precision()

    log("== phase 2: kernel timing (median of 25, block_until_ready)")
    for kernel in ("triton", "xla"):
        t = median_time(lambda: match_pairs_batch(bank, mask, pairs,
                                                  kernel=kernel))
        log(f"matcher {kernel}: {t * 1e3:.3f} ms per {MATCH_PAIRS} pairs "
            f"at capacity {MATCH_CAP}")
    t = median_time(lambda: sift._build_octave_batched(base))
    log(f"pyramid blur (plain XLA, kept): {t * 1e3:.3f} ms at {BLUR_SHAPE}")


# -- phase 3/4: pipeline -------------------------------------------------------
def render_collection(root: pathlib.Path, seed: int):
    from monocularsfm_tpu.io.images import write_image
    from monocularsfm_tpu.utils.synthetic import render_multiplane_images

    t0 = time.perf_counter()
    images, K, R, t = render_multiplane_images(
        scene_seed=seed, num_cameras=NUM_IMAGES, width=WIDTH, height=HEIGHT,
        arc_deg=ARC_DEG)
    img_dir = root / "images"
    img_dir.mkdir(parents=True)
    for i, im in enumerate(images):
        write_image(img_dir / f"frame{i:04d}.pgm", im)
    log(f"rendered {NUM_IMAGES} images {WIDTH}x{HEIGHT} in "
        f"{time.perf_counter() - t0:.1f} s")
    return K, R, t


def write_config(root: pathlib.Path, name: str, K, parallel=None):
    run = root / name
    cfg = {
        "images_path": str(root / "images"),
        "database_path": str(run / "db.sqlite"),
        "output_path": str(run / "out"),
        "camera": {"fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2],
                   "cy": K[1, 2]},
        "extraction": {"num_features": NUM_FEATURES, "max_image_size": 3200},
        "matching": {"match_type": "sequential", "overlap": OVERLAP},
    }
    if parallel:
        cfg["parallel"] = parallel
    run.mkdir()
    path = run / "config.json"
    path.write_text(json.dumps(cfg, indent=1))
    return path


class _Tee(io.TextIOBase):
    """Copies writes to stdout while keeping them for parsing."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_pipeline(cfg_path: pathlib.Path):
    """cli.main(["pipeline", cfg]) with its output teed; returns the stage
    wall times parsed from the CLI's own log lines."""
    from monocularsfm_tpu import cli

    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = cli.main(["pipeline", str(cfg_path)])
    total = time.perf_counter() - t0
    check(rc == 0, "cli pipeline returned 0")
    text = tee.buf.getvalue()
    times = {
        stage: float(re.search(pat, text).group(1)) for stage, pat in (
            ("extract", r"\[extract\] processed \d+ images in ([\d.]+)s"),
            ("match", r"\[match\] wrote \d+ pairs in ([\d.]+)s"),
        )
    }
    times["reconstruct"] = total - sum(times.values())
    times["total"] = total
    return times


def evaluate(out_dir: pathlib.Path, R_gt, t_gt):
    """Gates from the exported COLMAP model against the rendered truth."""
    from monocularsfm_tpu.io.colmap import read_colmap
    from monocularsfm_tpu.utils.synthetic import similarity_align

    for f in ("colmap/cameras.txt", "colmap/images.txt",
              "colmap/points3D.txt", "cloud.ply", "cloud_binary.ply",
              "scene.mvs"):
        check((out_dir / f).is_file(), f"export {f} present")
    model = read_colmap(out_dir / "colmap")
    images = model["images"]
    fx, fy, cx, cy = model["cameras"][1]["params"][:4]
    # Mean reprojection error over every observation, recomputed here.
    X, Rs, ts, uv = [], [], [], []
    for pt in model["points"].values():
        for img, kpt in pt["track"]:
            X.append(pt["xyz"])
            Rs.append(images[img]["R"])
            ts.append(images[img]["t"])
            uv.append(images[img]["uv"][kpt])
    cam = np.einsum("nij,nj->ni", np.asarray(Rs), np.asarray(X)) + ts
    proj = np.stack([fx * cam[:, 0] / cam[:, 2] + cx,
                     fy * cam[:, 1] / cam[:, 2] + cy], axis=1)
    reproj = float(np.linalg.norm(proj - np.asarray(uv), axis=1).mean())
    # Camera centres after a similarity alignment to the truth.
    est, gt = [], []
    for im in images.values():
        idx = int(re.search(r"(\d+)", im["name"]).group(1))
        est.append(-im["R"].T @ im["t"])
        gt.append(-R_gt[idx].T @ t_gt[idx])
    _, rms = similarity_align(np.asarray(est), np.asarray(gt))
    diag = float(np.linalg.norm(np.ptp(np.asarray(gt), axis=0)))
    res = {"registered": len(images), "points": len(model["points"]),
           "observations": len(uv), "mean_reproj_px": reproj,
           "center_rms_pct": 100.0 * rms / diag}
    log(f"result: {json.dumps(res)}")
    check(res["registered"] >= MIN_REGISTERED,
          f"{res['registered']}/{NUM_IMAGES} registered "
          f"(>= {MIN_REGISTERED})")
    check(reproj <= MAX_MEAN_REPROJ_PX,
          f"mean reprojection {reproj:.4f} px <= {MAX_MEAN_REPROJ_PX}")
    check(res["center_rms_pct"] <= MAX_CENTER_RMS_PCT,
          f"camera-centre RMS {res['center_rms_pct']:.4f}% of the camera "
          f"bounding-box diagonal <= {MAX_CENTER_RMS_PCT}%")
    return res


def peak_bytes():
    return [d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()]


def phase_pipeline(seed: int):
    log("== phase 3: pipeline (cold: compile included)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = pathlib.Path(tmp)
        K, R_gt, t_gt = render_collection(root, seed)
        times = run_pipeline(write_config(root, "run", K))
        log(f"stage wall times (s): {json.dumps(times)}")
        evaluate(root / "run" / "out", R_gt, t_gt)
    log(f"peak device bytes in use: {peak_bytes()}")


def phase_four_gpus(seed: int):
    import monocularsfm_tpu.parallel as par

    log("== phase 4: four GPUs, sharded vs unsharded")
    n = len(jax.devices())
    check(n == 4, f"four devices visible (found {n})")
    # Record where the sharded calls leave their outputs.  The pipeline
    # imports both functions from the package at call time.
    placed = {"ba": [], "match": []}
    dist_ba, shard_match = par.distributed_bundle_adjust, \
        par.sharded_match_pairs

    def ba_probe(*a, **kw):
        out = dist_ba(*a, **kw)
        placed["ba"].append({k: len(out[k].sharding.device_set)
                             for k in ("R", "t", "X")})
        return out

    def match_probe(*a, **kw):
        out = shard_match(*a, **kw)
        placed["match"].append(len(out.sharding.device_set))
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = pathlib.Path(tmp)
        K, R_gt, t_gt = render_collection(root, seed)
        par.distributed_bundle_adjust = ba_probe
        par.sharded_match_pairs = match_probe
        try:
            times = run_pipeline(write_config(root, "sharded", K))
        finally:
            par.distributed_bundle_adjust = dist_ba
            par.sharded_match_pairs = shard_match
        log(f"sharded stage wall times (s): {json.dumps(times)}")
        sharded = evaluate(root / "sharded" / "out", R_gt, t_gt)
        log(f"sharded calls: {len(placed['ba'])} global BA, "
            f"{len(placed['match'])} matching dispatches")
        check(placed["ba"] and placed["match"],
              "the pipeline took the sharded BA and matching paths")
        check(all(v == 4 for d in placed["ba"] for v in d.values()),
              "distributed BA outputs (R, t, X) span all 4 devices")
        check(all(v == 4 for v in placed["match"]),
              "sharded matching outputs span all 4 devices")

        times = run_pipeline(write_config(
            root, "single", K,
            parallel={"shard_ba": False, "shard_matching": False}))
        log(f"unsharded stage wall times (s): {json.dumps(times)}")
        single = evaluate(root / "single" / "out", R_gt, t_gt)
    check(abs(sharded["registered"] - single["registered"]) <= 1,
          "registered counts of the two runs differ by at most 1")
    log(f"peak device bytes in use: {peak_bytes()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-GPU sharded pipeline phase")
    ap.add_argument("--seed", type=int, default=7,
                    help="seed of the rendered collection")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    phase_device()
    if args.four_gpus:
        phase_four_gpus(args.seed)
    else:
        phase_kernels()
        phase_pipeline(args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
