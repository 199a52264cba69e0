"""Image I/O without OpenCV (PGM/PPM, resize) and the synthetic renderer."""

import sys

import numpy as np
import pytest

from monocularsfm_tpu.io.images import read_image, resize, to_gray, write_image
from monocularsfm_tpu.utils.synthetic import render_textured_images


@pytest.mark.parametrize("ext,channels", [(".pgm", 1), (".ppm", 3),
                                          (".ppm", 1)])
def test_pnm_round_trip(tmp_path, rng, ext, channels, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # numpy alone
    shape = (37, 53) if channels == 1 else (37, 53, 3)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = tmp_path / f"im{ext}"
    write_image(path, img)
    back = read_image(path)
    assert back.shape == (37, 53, 3) and back.dtype == np.uint8
    if channels == 1:
        for c in range(3):
            np.testing.assert_array_equal(back[..., c], img)
        np.testing.assert_array_equal(to_gray(back), img)
    else:
        np.testing.assert_array_equal(back, img)
        # PPM stores RGB: the file's first pixel is the BGR input reversed.
        raw = path.read_bytes()
        assert raw[-img.size:-img.size + 3] == img[0, 0, ::-1].tobytes()


def test_compressed_format_without_cv2_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="PGM/PPM"):
        read_image(tmp_path / "photo.jpg")


def test_gray_and_resize_match_opencv(rng):
    cv2 = pytest.importorskip("cv2")
    bgr = rng.integers(0, 256, size=(97, 131, 3), dtype=np.uint8)
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    assert np.abs(to_gray(bgr).astype(int) - gray).max() <= 1
    for w, h in ((64, 48), (200, 150), (131, 50)):
        ours = resize(gray, w, h).astype(int)
        theirs = cv2.resize(gray, (w, h)).astype(int)
        assert ours.shape == theirs.shape == (h, w)
        assert np.abs(ours - theirs).max() <= 1, (w, h)


def test_renderer_without_cv2(monkeypatch):
    """The textures are scipy Gaussian-filtered noise with or without
    OpenCV installed (the renderer once fell back to white noise, which
    SIFT cannot reconstruct from)."""
    kw = dict(num_cameras=2, width=96, height=72, focal=90.0,
              texture_res=300)
    with_cv2 = render_textured_images(**kw)[0]
    monkeypatch.setitem(sys.modules, "cv2", None)
    without = render_textured_images(**kw)[0]
    np.testing.assert_array_equal(with_cv2, without)
    # Smooth, not white noise: neighbouring pixels differ by a few levels.
    step = np.abs(np.diff(without.astype(int), axis=2)).mean()
    assert step < 30, step  # uniform noise would give ~85
