"""Benchmarks for the SfM engine's device hot paths.

Prints exactly ONE JSON line to stdout:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., "extra": {...}}

The headline metric is global-bundle-adjustment LM throughput on a
south-building-scale problem (128 cameras / ~320k observations, dense Schur
— the kernel every reconstruction spends most of its device time in;
reference regime: Ceres DENSE_SCHUR/SPARSE_SCHUR on CPU,
src/Optimizer/CeresBundleOptimizer.cpp:262-276).  `extra` carries the other
hot-loop numbers the reference's pipeline is bounded by:

  * global_ba_pcg_1024cam   — 1024 cams / 200k pts / 1.2M obs through the
                              cached-block PCG path (ITERATIVE_SCHUR
                              analogue), with an explicit FLOP/s estimate.
  * extraction_images_per_sec — SIFT at 1.2 MP (hot loop #1,
                              src/Feature/FeatureExtraction.cpp:59-161),
                              baseline = OpenCV SIFT on the host CPU.
  * matching_pairs_per_sec  — 8192-capacity descriptor pairs through the
                              streaming XLA matcher (hot loop #2,
                              src/Feature/FeatureMatching.cpp:10-73),
                              baseline = OpenCV BFMatcher knn2+ratio+cross.

vs_baseline = speedup over the same solver on the host CPU (Ceres-class
stand-in: identical LM+Schur algorithm, Eigen-backed XLA CPU backend).
Baselines are measured once per machine and cached in
.bench_cpu_baseline.json.  Logs go to stderr.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
CACHE = REPO / ".bench_cpu_baseline.json"

SMOKE = bool(os.environ.get("BENCH_SMOKE"))

CAMS = 128
POINTS = 40000
TRACK = 8
ITERS = 50

PCG_CAMS = 1024
PCG_POINTS = 200_000
PCG_TRACK = 6
PCG_LM_ITERS = 10
PCG_INNER = 50

EXTRACT_W, EXTRACT_H = 1280, 960
EXTRACT_FEATURES = 8024
MATCH_CAP = 8192

if SMOKE:  # tiny shapes so tests/test_bench_contract.py can run e2e on CPU
    CAMS, POINTS, TRACK, ITERS = 8, 1500, 4, 3
    PCG_CAMS, PCG_POINTS, PCG_TRACK, PCG_LM_ITERS, PCG_INNER = 16, 2000, 4, 2, 5
    EXTRACT_W, EXTRACT_H, EXTRACT_FEATURES = 320, 240, 512
    MATCH_CAP = 1024


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _load_cache() -> dict:
    if CACHE.exists():
        try:
            data = json.loads(CACHE.read_text())
            # Round-1/2 format was {"iters_per_sec": v} for the dense metric.
            if "iters_per_sec" in data and "dense" not in data:
                data = {"dense": data["iters_per_sec"]}
            return data
        except Exception:
            return {}
    return {}


def _save_cache(data: dict):
    CACHE.write_text(json.dumps(data))


def _ring_problem(cams, points, track, seed=2):
    sys.path.insert(0, str(REPO))
    from monocularsfm_tpu.optim import make_bundle_problem
    from monocularsfm_tpu.utils.synthetic import camera_ring_scene
    from monocularsfm_tpu.geometry import angle_axis_to_matrix
    import jax.numpy as jnp

    scene = camera_ring_scene(num_cameras=cams, num_points=points,
                              noise_px=0.5, seed=seed)
    rng = np.random.default_rng(0)
    # Vectorised per-point sampling of up to `track` observing cameras:
    # random keys, invisible cameras pushed to +inf, take the smallest keys.
    vis = scene.visible.T  # (P, C)
    keys = rng.random(vis.shape) + np.where(vis, 0.0, 10.0)
    order = np.argpartition(keys, min(track, vis.shape[1] - 1), axis=1)
    obs_cam = order[:, :track].astype(np.int32)
    obs_valid = np.take_along_axis(vis, order[:, :track], axis=1)
    obs_uv = scene.observations[
        obs_cam, np.arange(points)[:, None]
    ].astype(np.float32)
    aa = rng.normal(scale=0.01, size=(cams, 3))
    R = np.einsum(
        "cij,cjk->cik",
        np.asarray(angle_axis_to_matrix(jnp.asarray(aa))), scene.R,
    )
    t = scene.t + rng.normal(scale=0.02, size=(cams, 3))
    X = scene.points + rng.normal(scale=0.02, size=scene.points.shape)
    cam_const = np.zeros(cams, bool)
    cam_const[0] = True
    K4 = np.array(
        [scene.K[0, 0], scene.K[1, 1], scene.K[0, 2], scene.K[1, 2]],
        np.float32,
    )
    prob = make_bundle_problem(K4, R, t, X, obs_cam, obs_uv,
                               obs_valid, cam_const)
    return prob, int(obs_valid.sum())


def measure_dense(iters=ITERS):
    import jax

    from monocularsfm_tpu.optim import bundle_adjust

    prob, nobs = _ring_problem(CAMS, POINTS, TRACK)
    log(f"[dense] backend={jax.default_backend()}: {CAMS} cams, "
        f"{POINTS} points, {nobs} obs")
    out = bundle_adjust(prob, max_iterations=iters)
    jax.block_until_ready(out["cost_final"])
    t0 = time.perf_counter()
    out = bundle_adjust(prob, max_iterations=iters)
    jax.block_until_ready(out["cost_final"])
    dt = time.perf_counter() - t0
    n_it = int(out["iterations"])
    log(f"[dense] {n_it} LM iters in {dt:.3f}s -> {n_it/dt:.2f} iters/s | "
        f"rmse {float(out['rmse_initial']):.3f} -> {float(out['rmse_final']):.4f}")
    return n_it / dt


def measure_pcg(iters=PCG_LM_ITERS):
    import jax

    from monocularsfm_tpu.optim import bundle_adjust

    prob, nobs = _ring_problem(PCG_CAMS, PCG_POINTS, PCG_TRACK, seed=3)
    log(f"[pcg] backend={jax.default_backend()}: {PCG_CAMS} cams, "
        f"{PCG_POINTS} points, {nobs} obs")
    kw = dict(max_iterations=iters, solve_mode="pcg", pcg_iters=PCG_INNER)
    out = bundle_adjust(prob, **kw)
    jax.block_until_ready(out["cost_final"])
    t0 = time.perf_counter()
    out = bundle_adjust(prob, **kw)
    jax.block_until_ready(out["cost_final"])
    dt = time.perf_counter() - t0
    n_it = int(out["iterations"])
    # Rough analytic FLOP estimate per LM iteration (documented, not
    # measured): one system-build pass (~400 flops/obs) plus cached-W CG
    # matvecs (~250 flops/obs each, assuming the full pcg_iters budget —
    # the rtol early exit makes this an upper bound on work done).
    flops_per_iter = nobs * (400 + 250 * PCG_INNER)
    gflops = flops_per_iter * n_it / dt / 1e9
    log(f"[pcg] {n_it} LM iters ({PCG_INNER} CG each) in {dt:.3f}s -> "
        f"{n_it/dt:.3f} iters/s (~{gflops:.0f} GFLOP/s est) | "
        f"rmse {float(out['rmse_initial']):.3f} -> {float(out['rmse_final']):.4f}")
    return n_it / dt, gflops, nobs


def _bench_image(num=4):
    from monocularsfm_tpu.utils.synthetic import render_textured_images

    imgs, _, _, _ = render_textured_images(
        scene_seed=5, num_cameras=num, width=EXTRACT_W, height=EXTRACT_H)
    return imgs


def measure_extraction():
    """Batched extraction images/s — the pipeline path (batch_size=4,
    features/extraction.py)."""
    import jax

    from monocularsfm_tpu.ops.sift import SIFT

    imgs = _bench_image()
    batch = imgs if not SMOKE else imgs[:2]
    sift = SIFT(num_features=EXTRACT_FEATURES)
    kps, _ = sift.extract_batch(batch)  # warm-up / compile
    log(f"[extract] backend={jax.default_backend()} "
        f"{EXTRACT_W}x{EXTRACT_H}: {len(kps[0])} feats")
    reps, t0 = 3, time.perf_counter()
    for _ in range(reps):
        sift.extract_batch(batch)
    dt = time.perf_counter() - t0
    n = reps * len(batch)
    log(f"[extract] {n} images in {dt:.2f}s -> {n/dt:.3f} images/s")
    return n / dt


def measure_extraction_cv2():
    import cv2

    imgs = _bench_image()
    sift = cv2.SIFT_create(nfeatures=EXTRACT_FEATURES)
    sift.detectAndCompute(imgs[0], None)  # warm-up
    reps, t0 = 8, time.perf_counter()
    for r in range(reps):
        sift.detectAndCompute(imgs[r % len(imgs)], None)
    dt = time.perf_counter() - t0
    log(f"[extract-cv2] {reps} images in {dt:.2f}s -> {reps/dt:.3f} images/s")
    return reps / dt


def _match_bank(num=8):
    rng = np.random.default_rng(11)
    base = rng.standard_normal((MATCH_CAP, 128)).astype(np.float32)
    descs = []
    for i in range(num):
        d = base + 0.35 * rng.standard_normal(base.shape).astype(np.float32)
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        descs.append(d)
    return descs


def measure_matching():
    import jax
    import jax.numpy as jnp

    from monocularsfm_tpu.ops.matching import match_descriptors_pair

    descs = [jnp.asarray(d) for d in _match_bank()]
    mask = jnp.ones(MATCH_CAP, bool)
    jax.block_until_ready(
        match_descriptors_pair(descs[0], descs[1], mask, mask))
    reps, t0 = 64, time.perf_counter()
    outs = [
        match_descriptors_pair(
            descs[r % 8], descs[(r + 1) % 8], mask, mask)
        for r in range(reps)
    ]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    log(f"[match] backend={jax.default_backend()} cap={MATCH_CAP}: "
        f"{reps} pairs in {dt:.2f}s -> {reps/dt:.2f} pairs/s")
    return reps / dt


def measure_matching_cv2():
    import cv2

    descs = _match_bank(4)
    bf = cv2.BFMatcher()
    t0 = time.perf_counter()
    reps = 4
    for r in range(reps):
        a, b = descs[r % 4], descs[(r + 1) % 4]
        mab = bf.knnMatch(a, b, k=2)
        mba = bf.knnMatch(b, a, k=2)
        fwd = {m[0].queryIdx: m[0].trainIdx for m in mab
               if len(m) == 2 and m[0].distance < 0.8 * m[1].distance}
        _ = [q for q, t_ in fwd.items()
             for m in [mba[t_]]
             if len(m) == 2 and m[0].distance < 0.8 * m[1].distance
             and m[0].trainIdx == q]
    dt = time.perf_counter() - t0
    log(f"[match-cv2] {reps} pairs in {dt:.2f}s -> {reps/dt:.3f} pairs/s")
    return reps / dt


def run_all():
    results = {}
    results["dense_ips"] = measure_dense()
    results["pcg_ips"], results["pcg_gflops"], results["pcg_obs"] = measure_pcg()
    results["extract_ips"] = measure_extraction()
    results["match_pps"] = measure_matching()
    return results


def cpu_baselines(needed) -> dict:
    """Measure missing CPU baselines in a subprocess; cache them."""
    cache = _load_cache()
    missing = [k for k in needed if k not in cache]
    if missing:
        log(f"measuring cpu baselines {missing} (subprocess)...")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   BENCH_CPU_CHILD=",".join(missing))
        res = subprocess.run(
            [sys.executable, __file__], env=env, capture_output=True,
            text=True, timeout=3600,
        )
        sys.stderr.write(res.stderr[-2000:])
        line = res.stdout.strip().splitlines()[-1]
        cache.update(json.loads(line))
        _save_cache(cache)
    for k in needed:
        log(f"cpu baseline {k}: {cache.get(k)}")
    return cache


def child_main(which: str):
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {}
    for key in which.split(","):
        if key == "dense":
            out["dense"] = measure_dense(iters=20)
        elif key == "pcg":
            out["pcg"] = measure_pcg(iters=3)[0]
        elif key == "extract_cv2":
            out["extract_cv2"] = measure_extraction_cv2()
        elif key == "match_cv2":
            out["match_cv2"] = measure_matching_cv2()
    print(json.dumps(out))


def main():
    child = os.environ.get("BENCH_CPU_CHILD")
    if child:
        child_main(child)
        return
    sys.path.insert(0, str(REPO))
    import monocularsfm_tpu

    log(f"compile cache: {monocularsfm_tpu.compile_cache_dir()}")
    r = run_all()
    if SMOKE:
        base = {}
    else:
        base = cpu_baselines(["dense", "pcg", "extract_cv2", "match_cv2"])

    def ratio(v, b):
        return round(v / b, 3) if b else None

    extra = {
        "global_ba_pcg_1024cam": {
            "iters_per_sec": round(r["pcg_ips"], 4),
            "observations": r["pcg_obs"],
            "est_gflops": round(r["pcg_gflops"], 1),
            "cpu_iters_per_sec": base.get("pcg"),
            "vs_cpu": ratio(r["pcg_ips"], base.get("pcg")),
        },
        "extraction_images_per_sec_1p2mp": {
            "value": round(r["extract_ips"], 4),
            "opencv_cpu": base.get("extract_cv2"),
            "vs_opencv": ratio(r["extract_ips"], base.get("extract_cv2")),
        },
        "matching_pairs_per_sec_8192": {
            "value": round(r["match_pps"], 3),
            "opencv_cpu": base.get("match_cv2"),
            "vs_opencv": ratio(r["match_pps"], base.get("match_cv2")),
        },
    }
    print(json.dumps({
        "metric": "global_ba_lm_iters_per_sec",
        "value": round(r["dense_ips"], 3),
        "unit": "iters/s",
        "vs_baseline": ratio(r["dense_ips"], base.get("dense")),
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
