"""The incremental SfM driver: init -> register -> triangulate -> BA -> filter.

Reference parity: src/Reconstruction/MapBuilder.cpp —
  SetUp          (:41-97): build K, engines, SceneGraph/RegisterGraph/Map
  DoBuild        (:100-243): TryInitialize (best-correspondence pair search,
                 :283-377, :380-443), then the main loop (:144-211):
                 RegisterGraph::GetNextImageIds -> TryRegisterNextImage
                 (:445-513) -> Triangulate (:516-573) -> LocalBA + Filter/
                 Complete/Merge on modified tracks (:576-609, :194-199) or
                 GlobalBA + FilterAllTracks when registered >= 1.07x prev
                 (:185-191, :613-637)
  Summary        (:245-280): per-phase timer table.

The loop itself is host logic; every arrow above dispatches batched device
work through the engines.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from monocularsfm_tpu.config import SfMConfig
from monocularsfm_tpu.optim import bundle_adjust
from monocularsfm_tpu.reconstruction.initializer import Initializer
from monocularsfm_tpu.reconstruction.map_state import Map
from monocularsfm_tpu.reconstruction.register_graph import RegisterGraph
from monocularsfm_tpu.reconstruction.registrant import Registrant
from monocularsfm_tpu.reconstruction.scene_graph import SceneGraph
from monocularsfm_tpu.reconstruction.triangulator import Triangulator
from monocularsfm_tpu.utils.timer import Timer


@dataclasses.dataclass
class BuildSummary:
    num_registered: int = 0
    num_points3D: int = 0
    num_observations: int = 0
    mean_reprojection_error: float = 0.0
    mean_track_length: float = 0.0
    timers: dict = dataclasses.field(default_factory=dict)

    def __str__(self):
        lines = [
            f"registered images      : {self.num_registered}",
            f"3D points              : {self.num_points3D}",
            f"observations           : {self.num_observations}",
            f"mean track length      : {self.mean_track_length:.3f}",
            f"mean reprojection error: {self.mean_reprojection_error:.5f} px",
        ]
        lines += [f"  {name:<20s}: {t:8.3f} s" for name, t in self.timers.items()]
        return "\n".join(lines)


class MapBuilder:
    def __init__(self, config: SfMConfig):
        self.cfg = config
        self.K = config.camera.K()
        self.map = Map(self.K, config.camera.dist_coeffs())
        self.scene_graph = SceneGraph()
        self.register_graph: RegisterGraph | None = None
        self.initializer = Initializer(self.K, config.initializer)
        self.registrant = Registrant(self.K, config.registrant)
        self.triangulator = Triangulator(self.K, config.triangulator)
        self.timers = {
            name: Timer(name)
            for name in ("setup", "initialize", "register", "triangulate",
                         "local_ba", "global_ba", "filter", "filter_pass",
                         "complete_pass", "merge_pass", "total")
        }
        self._last_global_ba_count = 0
        self._mesh = None  # lazy device mesh for sharded BA (False = unavailable)
        self._log = print
        # Optional structured metrics stream (SURVEY.md section 5 plan:
        # "metrics to stdout + optional jsonl").
        self._metrics_fh = None
        # Async visualization (reference refreshes every 6 images,
        # MapBuilder.cpp:172-182; ours snapshots PLY + HTML viewer).
        self.viz = None
        if config.map_builder.is_visualization:
            from monocularsfm_tpu.viz import AsyncVisualization

            out = config.output_path or "."
            self.viz = AsyncVisualization(f"{out}/viz", every_n_updates=6).start()

    # -- setup ---------------------------------------------------------------
    def setup(self, matches: dict, keypoints: dict, colors: dict | None = None,
              names: dict | None = None):
        """matches: {(id1, id2): (N,2) int}, keypoints: {id: (N,>=2) float}.

        (The CLI layer feeds these from the SQLite database; tests feed them
        directly.)"""
        with self.timers["setup"]:
            num_kpts = {i: len(k) for i, k in keypoints.items()}
            self.scene_graph.load(
                matches, num_kpts, min_num_matches=self.cfg.map_builder.min_num_matches
            )
            self.register_graph = RegisterGraph.from_edges(
                self.scene_graph.edges(),
                max_trials=self.cfg.map_builder.registration_trials_max,
            )
            for i, kps in keypoints.items():
                name = names.get(i, f"image{i}") if names else f"image{i}"
                col = colors.get(i) if colors else None
                self.map.load_image(i, name, np.asarray(kps), col)
            self.map.attach_scene_graph(self.scene_graph)

    # -- init pair search ----------------------------------------------------
    def _find_init_pairs(self, max_trials: int):
        """Candidate init pairs: images by total correspondence count, then
        partners by pairwise match count (FindFirst/SecondInitialImage,
        MapBuilder.cpp:283-377)."""
        pair_count = self.scene_graph.edges()
        # Adjacency built once — rescanning the edge dict per candidate image
        # is O(images x pairs), noticeable at NEU scale (~880k pairs).
        partners_of: dict[int, list] = {}
        for (a, b), cnt in pair_count.items():
            assert a != b, f"self-pair ({a},{a}) in scene graph edges"
            partners_of.setdefault(a, []).append((cnt, b))
            partners_of.setdefault(b, []).append((cnt, a))
        first_order = sorted(
            self.scene_graph.image_ids,
            key=lambda i: -self.scene_graph.num_correspondences(i)
            if self.scene_graph.has_image(i) else 0,
        )
        tried = 0
        for first in first_order:
            partners = sorted(partners_of.get(first, ()), reverse=True)
            for cnt, second in partners:
                if tried >= max_trials:
                    return
                tried += 1
                yield first, second

    def try_initialize(self) -> bool:
        with self.timers["initialize"]:
            for id1, id2 in self._find_init_pairs(self.cfg.map_builder.max_num_init_trials):
                pairs, uv1, uv2 = self.map.get_2d2d_between(id1, id2)
                if len(pairs) < self.cfg.initializer.init_min_num_inliers:
                    continue
                stats, R2, t2, X, inl_idx = self.initializer.initialize(uv1, uv2)
                if not stats.is_succeed:
                    self._log(
                        f"[init] pair ({id1},{id2}) failed: {stats.fail_reason}"
                    )
                    continue
                self.map.add_image_pose(id1, np.eye(3), np.zeros(3))
                self.map.add_image_pose(id2, R2, t2)
                self.register_graph.set_registered(id1)
                self.register_graph.set_registered(id2)
                for row, xyz in zip(inl_idx, X):
                    k1, k2 = int(pairs[row, 0]), int(pairs[row, 1])
                    im1, im2 = self.map.images[id1], self.map.images[id2]
                    if im1.point3D[k1] >= 0 or im2.point3D[k2] >= 0:
                        continue
                    self.map.add_point3d(xyz, [(id1, k1), (id2, k2)])
                self._log(
                    f"[init] pair ({id1},{id2}) via {stats.method}: "
                    f"{stats.num_inliers} inliers, "
                    f"tri angle med {stats.median_tri_angle:.1f} deg, "
                    f"residual {stats.ave_residual:.2f} px"
                )
                return True
        return False

    # -- registration --------------------------------------------------------
    def try_register(self, image_id: int) -> bool:
        with self.timers["register"]:
            kpt_idx, pids, uv, xyz = self.map.get_2d3d(image_id)
            stats, R, t, inl = self.registrant.register(xyz, uv)
            if not stats.is_succeed:
                return False
            self.map.add_image_pose(image_id, R, t)
            self.register_graph.set_registered(image_id)
            im = self.map.images[image_id]
            # Points this image already observes (through any keypoint) —
            # O(kps) once from the keypoint back-pointers instead of
            # rebuilding the track list per inlier (O(track x inliers)).
            seen = set(im.point3D[im.point3D >= 0].tolist())
            for j in np.nonzero(inl)[0]:
                k, pid = int(kpt_idx[j]), int(pids[j])
                if im.point3D[k] < 0 and self.map._alive[pid] and (
                    pid not in seen
                ):
                    self.map.add_observation(pid, image_id, k)
                    seen.add(pid)
            self._log(
                f"[register] image {image_id}: {stats.num_inliers}/"
                f"{stats.num_point2D_3D_correspondences} inliers, "
                f"residual {stats.ave_residual:.2f} px"
            )
            self._metric(
                "register", image_id=int(image_id),
                inliers=stats.num_inliers,
                residual_px=round(stats.ave_residual, 4),
            )
        return True

    def triangulate_new(self, image_id: int) -> int:
        with self.timers["triangulate"]:
            cand = self.map.get_triangulation_tracks(
                image_id, max_track=self.triangulator.T
            )
            if not cand:
                return 0
            poses = {
                i: (self.map.images[i].R, self.map.images[i].t)
                for i in self.map.registered_ids
            }
            tracks_uv = [
                [(i, self.map.images[i].uv[k]) for i, k in tr] for _, tr in cand
            ]
            X, acc, _ = self.triangulator.triangulate_tracks(tracks_uv, poses)
            added = 0
            for (k, tr), xyz, ok in zip(cand, X, acc):
                if not ok:
                    continue
                # Guards: keypoints may have been claimed by a merge above.
                if any(self.map.images[i].point3D[kk] >= 0 for i, kk in tr):
                    continue
                self.map.add_point3d(xyz, tr)
                added += 1
            return added

    # -- bundle adjustment ----------------------------------------------------
    def _ba_mesh(self):
        """Device mesh for landmark-sharded BA (None when sharding is off or
        only one device is visible).  Built lazily, once."""
        if not self.cfg.parallel.shard_ba:
            return None
        if self._mesh is None:
            import jax

            if len(jax.devices()) < 2:
                self._mesh = False
            else:
                from monocularsfm_tpu.parallel import make_mesh

                shape = self.cfg.parallel.mesh_shape
                self._mesh = make_mesh(
                    shape[0] if shape else None,
                    axis_name=self.cfg.parallel.data_axis,
                )
        return self._mesh or None

    def local_ba(self, image_id: int):
        with self.timers["local_ba"]:
            prob, image_ids, pids = self.map.get_local_ba_data(
                image_id, window=self.cfg.map_builder.local_ba_window
            )
            # The reference runs the same 100-iteration optimizer for local
            # and global bundles (MapBuilder.cpp:576-609); function_tolerance
            # exits early on converged local windows.
            bcfg = self.cfg.bundle
            kwargs = {}
            if prob.obs_cam.size > bcfg.dense_max_obs:
                # Same capacity gate as global_ba: a top-5 covisible window
                # over dense match graphs can hold >131k points (and the
                # unsplit track width buckets to pow2(longest track)), so
                # the dense path's padded per-observation blocks exceed
                # device memory.
                # Rebuild the window split (tight track_width rows) and
                # route to the flat PCG path.
                prob, image_ids, pids = self.map.get_local_ba_data(
                    image_id, window=self.cfg.map_builder.local_ba_window,
                    allow_split=True, track_width=bcfg.track_width,
                )
                kwargs = dict(solve_mode="pcg", pcg_iters=bcfg.pcg_iterations)
            out = bundle_adjust(
                prob,
                max_iterations=bcfg.max_iterations,
                function_tolerance=bcfg.function_tolerance,
                parameter_tolerance=bcfg.parameter_tolerance,
                gradient_tolerance=bcfg.gradient_tolerance,
                initial_radius=bcfg.initial_trust_radius,
                min_lm_diagonal=bcfg.min_lm_diagonal,
                max_lm_diagonal=bcfg.max_lm_diagonal,
                **kwargs,
            )
            self.map.update_from_ba(out, image_ids, pids)
            return out

    def global_ba(self):
        with self.timers["global_ba"]:
            bcfg = self.cfg.bundle
            n_imgs = len(self.map.registered_ids)
            # Solver policy (CeresBundleOptimizer.cpp:262-276): dense Schur
            # for small bundles, matrix-free PCG (ITERATIVE_SCHUR analogue)
            # beyond dense_max_images.  Also capacity-gated: the dense path
            # materialises small per-observation blocks, and its unsplit
            # track width buckets to pow2(longest track) — dense cv2 match
            # graphs at 40 images reached 65k points x T=64 = 4.2M padded
            # rows.  The gate (bundle.dense_max_obs) was sized on a 16 GB
            # accelerator whose layouts padded those blocks ~21-85x; it has
            # not been derived for the H100.  The estimate below mirrors the
            # bridge's exact bucketing (pow2(points) x pow2(max track length)).
            from monocularsfm_tpu.reconstruction.map_state import (
                pow2_bucket as _pow2,
            )

            if self.map._node_p3d is not None:
                _, opid = self.map._obs_table()
                n_pts = len(np.unique(opid)) if len(opid) else 1
                max_len = (int(np.bincount(opid).max())
                           if len(opid) else 2)
            else:
                n_pts = max(self.map.num_points3D, 1)
                max_len = n_imgs
            est_cap = _pow2(n_pts, 256) * _pow2(max(max_len, 2), 8)
            dense = (n_imgs <= bcfg.dense_max_images
                     and est_cap <= bcfg.dense_max_obs)
            mesh = self._ba_mesh()
            # Landmark-sharded distributed BA needs one row per point, so
            # tracks split across rows only on the single-device PCG path.
            split = (not dense) and mesh is None
            prob, image_ids, pids = self.map.get_global_ba_data(
                track_width=bcfg.track_width, allow_split=split
            )
            # < 10 images: tighter tolerances, 2x iterations
            # (CeresBundleOptimizer.cpp:279-291).
            small = len(image_ids) < bcfg.min_images_tight
            kwargs = dict(
                max_iterations=(
                    2 * bcfg.max_iterations if small else bcfg.max_iterations
                ),
                function_tolerance=(
                    bcfg.function_tolerance * 1e-2 if small
                    else bcfg.function_tolerance
                ),
                parameter_tolerance=bcfg.parameter_tolerance,
                gradient_tolerance=bcfg.gradient_tolerance,
                initial_radius=bcfg.initial_trust_radius,
                min_lm_diagonal=bcfg.min_lm_diagonal,
                max_lm_diagonal=bcfg.max_lm_diagonal,
                solve_mode="dense" if dense else "pcg",
                pcg_iters=bcfg.pcg_iterations,
            )
            # Shared-focal columns ride the dense Schur system
            # (CeresBundleOptimizer.cpp:76-121, refine_focal_length option);
            # the PCG path has no focal columns — warn rather than silently
            # dropping the knob at scale.
            if self.cfg.bundle.refine_focal_length:
                if dense:
                    kwargs["refine_focal"] = True
                else:
                    from monocularsfm_tpu.utils.caps import warn_cap

                    warn_cap(
                        "refine_focal_length requested but bundle has %d "
                        "images (> dense_max_images=%d): the PCG path has "
                        "no shared-focal columns; keeping K fixed", n_imgs,
                        bcfg.dense_max_images,
                    )
            # MONOSFM_DUMP_BA=path snapshots every global-BA problem to host
            # numpy BEFORE the solve: a device fault during the solve makes
            # the device arrays unreachable, so a post-mortem fetch cannot
            # work.
            dump = os.environ.get("MONOSFM_DUMP_BA")
            if dump:
                arrs = {
                    f.name: np.asarray(getattr(prob, f.name))
                    for f in dataclasses.fields(prob)
                    if getattr(prob, f.name) is not None
                }
                np.savez(dump, **arrs, _kwargs=json.dumps(
                    {k: v for k, v in kwargs.items()
                     if isinstance(v, (int, float, str, bool))}))
            if mesh is not None:
                from monocularsfm_tpu.parallel import distributed_bundle_adjust

                out = distributed_bundle_adjust(prob, mesh, **kwargs)
            else:
                out = bundle_adjust(prob, **kwargs)
            self.map.update_from_ba(out, image_ids, pids)
            self._last_global_ba_count = len(self.map.registered_ids)
            self._metric(
                "global_ba", cams=len(image_ids),
                iters=int(out["iterations"]),
                rmse=round(float(out["rmse_final"]), 5),
                solver="dense" if dense else "pcg",
                sharded=mesh is not None,
            )
            return out

    def maintain_tracks(self, point_ids):
        mb = self.cfg.map_builder
        with self.timers["filter"]:
            with self.timers["filter_pass"]:
                self.map.filter_points(
                    point_ids, mb.filter_max_error_px,
                    mb.filter_min_tri_angle_deg
                )
            def _alive(ids):
                arr = np.asarray(list(ids), np.int64).reshape(-1)
                return arr[self.map._alive[arr]] if len(arr) else arr

            with self.timers["complete_pass"]:
                self.map.complete_points(
                    _alive(point_ids),
                    mb.complete_max_error_px, mb.complete_max_transitivity,
                )
            with self.timers["merge_pass"]:
                self.map.merge_points(
                    _alive(point_ids),
                    mb.merge_max_error_px,
                )

    # -- main loop ------------------------------------------------------------
    def do_build(self) -> BuildSummary:
        if self.cfg.map_builder.profile_dir:
            import contextlib
            import jax

            ctx = jax.profiler.trace(self.cfg.map_builder.profile_dir)
        else:
            import contextlib

            ctx = contextlib.nullcontext()
        with ctx:
            return self._do_build()

    def _do_build(self) -> BuildSummary:
        with self.timers["total"]:
            if len(self.map.registered_ids) >= 2:
                self._log("[build] map already initialized (resume)")
            elif not self.try_initialize():
                self._log("[build] initialization failed")
                return self.summary()
            else:
                self.global_ba()
                self.maintain_tracks(self.map.point_ids())

            while True:
                candidates = self.register_graph.get_next_image_ids()
                if not candidates:
                    break
                progressed = False
                for image_id in candidates:
                    self.register_graph.add_trial(image_id)
                    if not self.try_register(image_id):
                        continue
                    progressed = True
                    self.triangulate_new(image_id)
                    if self.viz is not None:
                        self.viz.update(self.map)
                    self._maybe_snapshot()
                    n_reg = len(self.map.registered_ids)
                    if n_reg >= self.cfg.map_builder.global_ba_ratio * max(
                        self._last_global_ba_count, 2
                    ):
                        self.global_ba()
                        self.maintain_tracks(self.map.point_ids())
                    else:
                        self.local_ba(image_id)
                        self.maintain_tracks(sorted(self.map.modified_point3D_ids))
                    break  # re-rank candidates after every success
                if not progressed:
                    break
            # Final global BA if the map moved since the last one.
            if len(self.map.registered_ids) != self._last_global_ba_count:
                self.global_ba()
                self.maintain_tracks(self.map.point_ids())
        if self.viz is not None:
            self.viz._count = 0
            self.viz.every = 1
            self.viz.update(self.map)  # final frame
            self.viz.close()
        return self.summary()

    def enable_metrics(self, path):
        """Write one JSON line per event (register/ba/...) to `path`."""
        self._metrics_fh = open(path, "a")
        return self

    def _metric(self, event: str, **fields):
        if self._metrics_fh is None:
            return
        import json
        import time as _time

        rec = {"t": round(_time.time(), 3), "event": event,
               "num_registered": len(self.map.registered_ids),
               "num_points": self.map.num_points3D, **fields}
        self._metrics_fh.write(json.dumps(rec) + "\n")
        self._metrics_fh.flush()

    def _maybe_snapshot(self):
        every = self.cfg.map_builder.snapshot_every_registrations
        if not every:
            return
        n = len(self.map.registered_ids)
        if n % every:
            return
        from monocularsfm_tpu.io.colmap import write_colmap

        out = self.cfg.map_builder.snapshot_dir or (
            (self.cfg.output_path or ".") + "/snapshot"
        )
        write_colmap(self.map, out)
        self._log(f"[snapshot] {n} images -> {out}")

    def resume_from(self, model_dir):
        """Resume reconstruction from a COLMAP snapshot: restore poses,
        points and track back-pointers into the already-setup() builder and
        rewire the register scheduler.  The reference writes this format but
        can never read it back (SURVEY.md section 5)."""
        from monocularsfm_tpu.io.colmap import read_colmap

        model = read_colmap(model_dir)
        for image_id, im in model["images"].items():
            if image_id not in self.map.images:
                continue
            self.map.add_image_pose(image_id, im["R"], im["t"])
            self.register_graph.set_registered(image_id)
        for pid, pt in sorted(model["points"].items()):
            track = [
                (i, k) for i, k in pt["track"]
                if i in self.map.images and self.map.images[i].point3D[k] < 0
            ]
            if len(track) >= 2:
                self.map.add_point3d(pt["xyz"], track)
        self.map.modified_point3D_ids.clear()
        self._last_global_ba_count = len(self.map.registered_ids)
        self._log(
            f"[resume] {len(self.map.registered_ids)} images, "
            f"{self.map.num_points3D} points restored"
        )

    def summary(self) -> BuildSummary:
        st = self.map.statistics()
        return BuildSummary(
            num_registered=st.num_registered_images,
            num_points3D=st.num_points3D,
            num_observations=st.num_observations,
            mean_reprojection_error=st.mean_reprojection_error,
            mean_track_length=st.mean_track_length,
            timers={k: t.elapsed for k, t in self.timers.items()},
        )
