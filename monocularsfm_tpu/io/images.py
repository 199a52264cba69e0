"""Image files: binary PGM/PPM in numpy, other formats through OpenCV.

The engine's own path reads and writes 8-bit binary Netpbm (P5 gray, P6
colour) with numpy alone, so it runs where OpenCV is not installed.
Compressed formats (PNG, JPEG, TIFF, ...) need OpenCV, which is imported
only for them.  Colour arrays use OpenCV's BGR channel order throughout the
engine; PPM files store RGB and are converted on the way in and out.
"""

from __future__ import annotations

import pathlib

import numpy as np

PNM_EXTS = {".pgm", ".ppm"}


def _cv2(path):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"reading or writing {pathlib.Path(path).name} needs OpenCV "
            f"(cv2), which is not installed; convert the images to binary "
            f"PGM/PPM ({', '.join(sorted(PNM_EXTS))}), which need only numpy"
        ) from e
    return cv2


def _pnm_tokens(data: bytes, count: int):
    """The first `count` header tokens of a Netpbm file (comments skipped)
    and the offset of the byte after the single whitespace that ends the
    header."""
    tokens, pos = [], 0
    while len(tokens) < count:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("truncated Netpbm header")
        tokens.append(data[start:pos])
    return tokens, pos + 1


def _read_pnm(path) -> np.ndarray:
    """(H, W) uint8 for P5, (H, W, 3) uint8 RGB for P6."""
    data = pathlib.Path(path).read_bytes()
    (magic, w, h, maxval), off = _pnm_tokens(data, 4)
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"{path}: not a binary PGM/PPM (magic {magic!r})")
    if int(maxval) != 255:
        raise ValueError(f"{path}: only 8-bit Netpbm is supported "
                         f"(maxval {int(maxval)})")
    shape = (int(h), int(w)) if magic == b"P5" else (int(h), int(w), 3)
    n = int(np.prod(shape))
    if len(data) - off < n:
        raise ValueError(f"{path}: truncated pixel data")
    return np.frombuffer(data, np.uint8, count=n, offset=off).reshape(shape)


def _write_pnm(path, img: np.ndarray) -> None:
    """(H, W) uint8 -> P5, (H, W, 3) uint8 RGB -> P6."""
    img = np.ascontiguousarray(img, np.uint8)
    magic = b"P5" if img.ndim == 2 else b"P6"
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def read_image(path) -> np.ndarray:
    """(H, W, 3) uint8 BGR image; gray files are replicated to 3 channels."""
    if pathlib.Path(path).suffix.lower() in PNM_EXTS:
        img = _read_pnm(path)
        return (np.repeat(img[..., None], 3, axis=2) if img.ndim == 2
                else img[..., ::-1].copy())
    cv2 = _cv2(path)
    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if bgr is None:
        raise IOError(f"cannot read image {path}")
    return bgr


def write_image(path, img: np.ndarray) -> None:
    """Write (H, W) gray or (H, W, 3) BGR uint8.  A .pgm file stores gray
    (colour is converted with to_gray); a .ppm file stores colour (gray is
    replicated)."""
    img = np.asarray(img, np.uint8)
    suffix = pathlib.Path(path).suffix.lower()
    if suffix == ".pgm":
        _write_pnm(path, img if img.ndim == 2 else to_gray(img))
    elif suffix == ".ppm":
        rgb = (np.repeat(img[..., None], 3, axis=2) if img.ndim == 2
               else img[..., ::-1])
        _write_pnm(path, rgb)
    else:
        cv2 = _cv2(path)
        if not cv2.imwrite(str(path), img):
            raise IOError(f"cannot write image {path}")


def to_gray(bgr: np.ndarray) -> np.ndarray:
    """BGR uint8 -> gray uint8 with the ITU-R BT.601 weights that OpenCV's
    COLOR_BGR2GRAY uses."""
    f = bgr.astype(np.float32)
    g = 0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]
    return np.clip(np.rint(g), 0, 255).astype(np.uint8)


def resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bilinear resize of a uint8 image to (height, width), with OpenCV's
    INTER_LINEAR pixel-centre convention (no anti-aliasing)."""
    h, w = img.shape[:2]

    def taps(n_out, n_in):
        x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        x = np.clip(x, 0.0, n_in - 1)
        x0 = np.floor(x).astype(np.int64)
        x1 = np.minimum(x0 + 1, n_in - 1)
        return x0, x1, (x - x0).astype(np.float32)

    y0, y1, fy = taps(height, h)
    x0, x1, fx = taps(width, w)
    f = img.astype(np.float32)
    fy = fy.reshape((-1,) + (1,) * (img.ndim - 1))
    rows = f[y0] * (1.0 - fy) + f[y1] * fy
    fx = fx.reshape((1, -1) + (1,) * (img.ndim - 2))
    out = rows[:, x0] * (1.0 - fx) + rows[:, x1] * fx
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
