"""Export round trips: COLMAP text (write+read+resume), PLY, OpenMVS binary."""

import numpy as np
import pytest

from monocularsfm_tpu.reconstruction.map_state import Map
from monocularsfm_tpu.io.colmap import write_colmap, read_colmap, map_from_colmap
from monocularsfm_tpu.io.ply import write_ply, write_ply_binary, read_ply
from monocularsfm_tpu.io.openmvs import write_openmvs, read_openmvs_summary


@pytest.fixture
def small_map(ring_scene):
    s = ring_scene
    m = Map(s.K)
    n_img, n_pts = 4, 60
    for i in range(n_img):
        m.load_image(i, f"img_{i:04d}.jpg", s.observations[i][:200],
                     colors=np.full((200, 3), [10, 20, 30], np.uint8))
        m.add_image_pose(i, s.R[i], s.t[i])
    for p in range(n_pts):
        if all(s.visible[i, p] for i in range(n_img)):
            m.add_point3d(s.points[p], [(i, p) for i in range(n_img)])
    return m


class TestColmap:
    def test_round_trip(self, small_map, tmp_path):
        write_colmap(small_map, tmp_path, width=1024, height=768)
        model = read_colmap(tmp_path)
        assert model["cameras"][1]["model"] == "PINHOLE"
        assert len(model["images"]) == 4
        assert len(model["points"]) == small_map.num_points3D
        # Pose round trip.
        for i, im in model["images"].items():
            np.testing.assert_allclose(im["R"], small_map.images[i].R, atol=1e-5)
            np.testing.assert_allclose(im["t"], small_map.images[i].t, atol=1e-6)
        # Track round trip + 2D->3D backpointers.
        for pid, pt in model["points"].items():
            assert set(pt["track"]) == set(small_map.track(pid))

    def test_resume_from_checkpoint(self, small_map, tmp_path):
        write_colmap(small_map, tmp_path, width=1024, height=768)
        restored = map_from_colmap(tmp_path)
        assert restored.num_points3D == small_map.num_points3D
        assert len(restored.registered_ids) == 4
        restored.debug_check()
        st_a = small_map.statistics()
        st_b = restored.statistics()
        assert abs(st_a.mean_reprojection_error - st_b.mean_reprojection_error) < 1e-4


class TestPly:
    def test_ascii_and_binary(self, small_map, tmp_path):
        write_ply(small_map, tmp_path / "a.ply")
        write_ply_binary(small_map, tmp_path / "b.ply")
        xa, ca = read_ply(tmp_path / "a.ply")
        xb, cb = read_ply(tmp_path / "b.ply")
        assert len(xa) == small_map.num_points3D
        np.testing.assert_allclose(xa, xb, atol=1e-5)
        np.testing.assert_array_equal(ca, cb)
        # BGR -> RGB flip happened.
        assert tuple(ca[0]) == (30, 20, 10)


class TestOpenMVS:
    def test_writer_structure(self, small_map, tmp_path):
        p = tmp_path / "scene.mvs"
        write_openmvs(small_map, p, width=1024, height=768, image_dir="imgs")
        info = read_openmvs_summary(p)
        assert info["version"] == 2
        assert info["platforms"] == 1
        assert info["images"] == 4
        assert info["vertices"] == small_map.num_points3D
        raw = p.read_bytes()
        assert raw[:4] == b"MVSI"

    def test_unregistered_images_get_no_id(self, ring_scene, tmp_path):
        """Reference lists EVERY image; unregistered ones carry poseID=NO_ID
        (Map.cpp:1521-1543)."""
        s = ring_scene
        m = Map(s.K)
        for i in range(5):
            m.load_image(i, f"img_{i:04d}.jpg", s.observations[i][:100])
        for i in range(3):  # register only 3 of 5
            m.add_image_pose(i, s.R[i], s.t[i])
        for p in range(40):
            if all(s.visible[i, p] for i in range(3)):
                m.add_point3d(s.points[p], [(i, p) for i in range(3)])
        out = tmp_path / "scene.mvs"
        write_openmvs(m, out, width=1024, height=768)
        info = read_openmvs_summary(out)
        assert info["images"] == 5
        assert info["posed_images"] == 3

    @pytest.mark.parametrize("ext", [".ppm", ".jpg"])
    def test_undistorted_image_dump(self, small_map, tmp_path, ext):
        """Dumped images are remapped through the distortion model
        (Map.cpp:1490-1519): a known distorted pattern must land back at its
        undistorted pixel position.  PPM goes through numpy alone, JPEG
        through OpenCV."""
        if ext == ".jpg":
            pytest.importorskip("cv2")
        from monocularsfm_tpu.io.images import read_image, write_image
        from monocularsfm_tpu.io.openmvs import _undistort_maps

        w, h = 320, 240
        K = np.asarray(small_map.K, float)  # the writer remaps with map_obj.K
        dist = np.array([-0.25, 0.05, 0.0, 0.0])
        # Render a white dot AT the distorted location of target pixel (220, 160).
        mapx, mapy = _undistort_maps(K, dist, w, h)
        tx, ty = 220, 160
        sx, sy = int(round(mapx[ty, tx])), int(round(mapy[ty, tx]))
        for im in small_map.images.values():
            im.name = im.name.replace(".jpg", ext)
        src_dir = tmp_path / "photos"
        src_dir.mkdir()
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.zeros((h, w, 3), np.uint8)
        img[(xx - sx) ** 2 + (yy - sy) ** 2 <= 16] = 255
        for i in range(4):
            write_image(src_dir / f"img_{i:04d}{ext}", img)
        out = tmp_path / "scene.mvs"
        write_openmvs(small_map, out, width=w, height=h,
                      images_path=str(src_dir), dist=dist)
        info = read_openmvs_summary(out)
        assert all(n.startswith("undistorted_images/") for n in info["image_names"])
        und = read_image(tmp_path / "undistorted_images" / f"img_0000{ext}")
        assert und.shape == (h, w, 3)
        # The dot moved to the undistorted target position.
        yy, xx = np.where(und[:, :, 0] > 128)
        assert len(xx) > 0
        assert abs(xx.mean() - tx) < 2.0 and abs(yy.mean() - ty) < 2.0
        # And is no longer at the distorted source position.
        assert np.hypot(xx.mean() - sx, yy.mean() - sy) > 3.0
