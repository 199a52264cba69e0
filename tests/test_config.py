"""Config tree: defaults mirror the reference Parameters structs; YAML load."""

import pathlib
import textwrap

import pytest

from monocularsfm_tpu import config as cfg_mod


def test_defaults_match_reference():
    cfg = cfg_mod.SfMConfig()
    # MapBuilder.h:29-63
    assert cfg.map_builder.min_num_matches == 10
    assert cfg.map_builder.max_num_init_trials == 100
    assert abs(cfg.map_builder.global_ba_ratio - 1.07) < 1e-9
    assert cfg.map_builder.filter_max_error_px == 4.0
    assert cfg.map_builder.filter_min_tri_angle_deg == 1.5
    # Initializer.h:16-32
    assert cfg.initializer.init_min_num_inliers == 100
    assert cfg.initializer.init_min_tri_angle_deg == 4.0
    assert cfg.initializer.homography_ratio_threshold == 0.7
    # Registrant.h:20-28
    assert cfg.registrant.abs_pose_min_num_inliers == 15
    assert cfg.registrant.abs_pose_max_error_px == 4.0
    # Triangulator.h:13-17
    assert cfg.triangulator.tri_max_error_px == 2.0
    assert cfg.triangulator.tri_min_angle_deg == 1.5
    # FeatureExtraction defaults (sfm/FeatureExtraction.cpp:34-42)
    assert cfg.extraction.max_image_size == 3200
    assert cfg.extraction.num_features == 8024
    # Matching (FeatureMatching.h:28-37)
    assert cfg.matching.distance_ratio == 0.8
    assert cfg.matching.max_distance == 0.7
    assert cfg.matching.overlap == 3
    # BA (CeresBundleOptimizer.h:17-23 / .cpp:262-291)
    assert cfg.bundle.max_iterations == 100
    assert not cfg.bundle.refine_focal_length


def test_load_reference_style_yaml(tmp_path):
    y = textwrap.dedent(
        """
        images_path: /data/imgs
        database_path: /data/db.db
        SIFTextractor.max_image_size: 2000
        SIFTextractor.num_features: 4096
        SIFTextractor.normalization: 0
        SIFTmatch.match_type: 1
        SIFTmatch.distance_ratio: 0.75
        Camera.fx: 2559.68
        Camera.fy: 2559.68
        Camera.cx: 1536.0
        Camera.cy: 1152.0
        Camera.k1: -0.0204997
        Reconstrction.output_path: /out
        Reconstruction.is_visualization: 0
        """
    )
    p = tmp_path / "c.yaml"
    p.write_text(y)
    cfg = cfg_mod.load_yaml(p)
    assert cfg.images_path == "/data/imgs"
    assert cfg.extraction.max_image_size == 2000
    assert cfg.extraction.num_features == 4096
    assert cfg.extraction.normalization == "l1_root"
    assert cfg.matching.match_type == "brute"
    assert cfg.matching.distance_ratio == 0.75
    assert cfg.camera.fx == 2559.68
    assert cfg.camera.k1 == -0.0204997
    assert cfg.output_path == "/out"  # reference typo key accepted
    assert cfg.map_builder.is_visualization is False
    K = cfg.camera.K()
    assert K[0, 0] == 2559.68 and K[1, 2] == 1152.0


def test_nested_yaml(tmp_path):
    p = tmp_path / "n.yaml"
    p.write_text("bundle:\n  max_iterations: 50\nmatching:\n  overlap: 5\n")
    cfg = cfg_mod.load_yaml(p)
    assert cfg.bundle.max_iterations == 50
    assert cfg.matching.overlap == 5


def test_reference_nested_camera_keys(tmp_path):
    # The actual reference configs nest intrinsics one level deeper
    # (config/south-building.yaml:28-37: "Reconstruction.Camera.fx").
    p = tmp_path / "r.yaml"
    p.write_text(
        "Reconstruction.Camera.fx: 2559.68\n"
        "Reconstruction.Camera.cy: 1152.0\n"
        "Reconstruction.Camera.k1: -0.02\n"
    )
    cfg = cfg_mod.load_yaml(p)
    assert cfg.camera.fx == 2559.68
    assert cfg.camera.cy == 1152.0
    assert cfg.camera.k1 == -0.02


def test_shipped_example_configs_load():
    import pathlib

    cfg_dir = pathlib.Path(cfg_mod.__file__).resolve().parent.parent / "config"
    seen = 0
    for path in sorted(cfg_dir.glob("*.yaml")):
        cfg = cfg_mod.load_yaml(path)
        assert cfg.camera.fx > 0, path.name
        seen += 1
    assert seen >= 4


def test_package_defaults_f32_matmul_precision():
    """A reduced-precision default for float32 matmuls (TF32 on a GPU)
    degrades registration residuals through the matmuls inside jnp.linalg
    decompositions, which per-op Precision.HIGHEST annotations cannot
    reach.  The package import must pin the f32 default
    (monocularsfm_tpu/__init__.py); deliberate bf16 fast paths cast their
    operands explicitly."""
    import jax

    import monocularsfm_tpu  # noqa: F401

    assert jax.config.jax_default_matmul_precision == "float32"


def test_json_config_loads_like_its_yaml_twin(tmp_path, monkeypatch):
    """Every shipped YAML config, converted to JSON, loads to the same tree
    through the stdlib json path, with PyYAML unavailable."""
    import json
    import sys

    yaml = pytest.importorskip("yaml")
    cfg_dir = pathlib.Path(cfg_mod.__file__).resolve().parent.parent / "config"
    twins = []
    for path in sorted(cfg_dir.glob("*.yaml")):
        with open(path) as f:
            raw = yaml.safe_load(f)
        twin = tmp_path / (path.stem + ".json")
        twin.write_text(json.dumps(raw))
        twins.append((cfg_mod.load_yaml(path), twin))
    monkeypatch.setitem(sys.modules, "yaml", None)
    for want, twin in twins:
        assert cfg_mod.load_yaml(twin) == want, twin.name
    assert len(twins) >= 4
