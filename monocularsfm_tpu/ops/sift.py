"""SIFT feature extraction as batched XLA computations.

Reference parity: the reference delegates to cv::SIFT (detect + compute,
src/Feature/FeatureUtils.cpp:14-36) with max_image_size-downscaling, top-
scale keypoint retention and L1-root normalisation
(src/Feature/FeatureExtraction.cpp:51-163, FeatureUtils.cpp:38-96, :260-281).

Device design (not a translation of OpenCV's scalar code):

* Gaussian pyramid: separable 1-D blurs per octave as shifted-slice
  multiply-adds, every scale blurred directly from the octave base
  (sigma0=1.6, 3 scales/octave), optional initial 2x upsample like OpenCV's
  firstOctave=-1.
* DoG extrema: one 3x3x3 max/min reduce_window over the whole DoG stack —
  the 26-neighbour test for every pixel of every scale at once; candidates
  are selected with a single top_k over |response| (fixed K per octave).
* Sub-pixel refinement: batched 3x3x3 neighbourhood gather + closed-form
  3x3 solve (quadratic fit), contrast and edge (Hessian-ratio) rejection —
  all masked, no per-keypoint loops.
* Orientation: fixed 16x16 sample grid scaled by keypoint sigma, bilinear
  gradient sampling, 36-bin histogram via one-hot einsum, circular
  smoothing, primary + secondary (>= 0.8 peak) orientations.
* Descriptor: fixed 16x16 rotation-aligned sample grid over the 4x4 cell
  array; spatial bilinear weights are *constants* (precomputed [256, 16]
  matrix — a matmul), only the 8-way orientation soft-assignment is
  data-dependent.  Clip at 0.2, renormalise; L1-root or L2 output.

Everything per-octave is jit-compiled for that octave's static shape.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST

# Env knob, read ONCE at import (it selects traced programs — reading at
# trace time would silently ignore changes after a shape's first compile,
# and the persistent XLA cache could bake the stale choice across runs):
# MONOSFM_SAMPLE_PRECISION: interpolation-matmul precision
# (default|high|highest).
_SAMPLE_PRECISION = os.environ.get("MONOSFM_SAMPLE_PRECISION", "highest")

# OpenCV-compatible constants.
N_SCALES = 3              # nOctaveLayers
SIGMA0 = 1.6
CONTRAST_THRESHOLD = 0.04
EDGE_THRESHOLD = 10.0
INIT_SIGMA = 0.5          # assumed blur of the input image
ORI_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_PEAK_RATIO = 0.8
DESC_WIDTH = 4            # 4x4 cells
DESC_BINS = 8
DESC_SCL_FCTR = 3.0       # cell size = 3 * sigma
DESC_MAG_THR = 0.2


def gaussian_kernel1d(sigma: float) -> np.ndarray:
    radius = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _taps(x: jnp.ndarray, kernel: np.ndarray, axis: int, n: int):
    """sum_t kernel[t] * x[t:t+n] along `axis` (zero taps skipped)."""
    out = None
    for t, k in enumerate(kernel):
        if k == 0.0:
            continue
        term = float(k) * jax.lax.slice_in_dim(x, t, t + n, axis=axis)
        out = term if out is None else out + term
    return out


def _blur_stack(base_b: jnp.ndarray, kernels: np.ndarray) -> jnp.ndarray:
    """(B, H, W) f32 -> (B, C, H, W): channel c is the separable blur of
    the base with kernels[c] (numpy (C, T), T odd) along both axes, edges
    replicated (cv::BORDER_REPLICATE).

    Shifted-slice multiply-adds rather than a convolution: XLA fuses each
    axis into one memory-bound pass, in exact f32 arithmetic (no reduced-
    precision matmul unit is involved)."""
    B, H, W = base_b.shape
    C, T = kernels.shape
    r = (T - 1) // 2
    x = jnp.pad(base_b, ((0, 0), (r, r), (0, 0)), mode="edge")
    v = jnp.stack([_taps(x, kernels[c], 1, H) for c in range(C)], axis=1)
    v = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (r, r)), mode="edge")
    return jnp.stack([_taps(v[:, c], kernels[c], 2, W) for c in range(C)],
                     axis=1)


def _octave_sigmas():
    """Per-scale incremental blur sigmas within an octave (OpenCV schedule)."""
    k = 2.0 ** (1.0 / N_SCALES)
    sig = [SIGMA0]
    incr = []
    for i in range(1, N_SCALES + 3):
        sig_prev = SIGMA0 * (k ** (i - 1))
        sig_total = sig_prev * k
        incr.append(math.sqrt(sig_total ** 2 - sig_prev ** 2))
        sig.append(sig_total)
    return sig, incr


@functools.partial(jax.jit, static_argnames=("upsample",))
def _base_image_batched(imgs: jnp.ndarray, upsample: bool = True):
    """(B, H, W) grayscale [0,1] -> octave-0 bases at sigma0 (optionally 2x
    upsampled first)."""
    if upsample:
        H, W = imgs.shape[1:]
        imgs = jax.vmap(lambda im: jax.image.resize(
            im, (2 * H, 2 * W), method="linear"))(imgs)
        sigma_diff = math.sqrt(max(SIGMA0 ** 2 - 4.0 * INIT_SIGMA ** 2, 0.01))
    else:
        sigma_diff = math.sqrt(max(SIGMA0 ** 2 - INIT_SIGMA ** 2, 0.01))
    return _blur_stack(imgs, gaussian_kernel1d(sigma_diff)[None])[:, 0]


def _octave_base_kernels():
    """Per-scale direct-from-base blur kernels, padded to a common radius.

    All S+2 scales are blurred directly from the base with composed sigmas
    (Gaussian semigroup: identical math to OpenCV's incremental schedule,
    up to kernel truncation), so one pass per axis yields every scale.
    Returns (C, T) float32 with C = N_SCALES + 2 rows."""
    k = 2.0 ** (1.0 / N_SCALES)
    kers = []
    for i in range(1, N_SCALES + 3):
        sig_total = SIGMA0 * (k ** i)
        sig = math.sqrt(max(sig_total ** 2 - SIGMA0 ** 2, 1e-8))
        kers.append(gaussian_kernel1d(sig))
    rmax = max((len(kk) - 1) // 2 for kk in kers)
    K = np.zeros((len(kers), 2 * rmax + 1), np.float32)
    for c, kk in enumerate(kers):
        r = (len(kk) - 1) // 2
        K[c, rmax - r:rmax + r + 1] = kk
    return K


_OCT_KER = _octave_base_kernels()


def _bilinear_vol(vol_flat: jnp.ndarray, shape, si: jnp.ndarray,
                  x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample scale `si` of a flattened (S, H, W) volume.

    Folding the scale index into one flat gather keeps the per-keypoint
    cost at 4 scalar loads per sample; the naive `vol[si]` inside a vmap
    instead lowers to a per-keypoint dynamic-slice of the whole image,
    which XLA may materialise as a (num_kpts, H, W) tensor — O(100 GB) at
    real image sizes.  Out-of-range coords are clamped.
    """
    S, H, W = shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    base = si * (H * W) + y0 * W + x0
    v00 = vol_flat[base]
    v01 = vol_flat[base + 1]
    v10 = vol_flat[base + W]
    v11 = vol_flat[base + W + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _bilinear_grads(gpack: jnp.ndarray, shape, si: jnp.ndarray,
                    x: jnp.ndarray, y: jnp.ndarray):
    """Bilinear-sample BOTH gradient components at scale `si`.

    gpack: (S*H*W, 4) rows [gx[i], gx[i+1], gy[i], gy[i+1]].  Two
    row-gathers per sample (rows base and base+W) fetch all eight values a
    bilinear gradient sample needs, instead of eight scalar gathers.
    Returns (gx_s, gy_s)."""
    S, H, W = shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    base = si * (H * W) + y0 * W + x0
    r0 = jnp.take(gpack, base, axis=0)       # (..., 4)
    r1 = jnp.take(gpack, base + W, axis=0)
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    gx_s = (r0[..., 0] * w00 + r0[..., 1] * w01
            + r1[..., 0] * w10 + r1[..., 1] * w11)
    gy_s = (r0[..., 2] * w00 + r0[..., 3] * w01
            + r1[..., 2] * w10 + r1[..., 3] * w11)
    return gx_s, gy_s


# Precomputed descriptor-grid constants (module-level, shared by all jits).
def _desc_grid_constants():
    """16x16 sample grid in cell units + constant spatial bilinear weights.

    Samples sit at cell coordinates c in [-2, 2] (cell centres at
    -1.5, -0.5, 0.5, 1.5).  Returns (offsets (256, 2), spatial_w (256, 16),
    gauss_w (256,))."""
    lin = (np.arange(16) - 7.5) / 4.0  # in cell units, [-1.875, 1.875]
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    off = np.stack([gx.ravel(), gy.ravel()], axis=1)  # (256, 2) cell units
    centers = np.array([-1.5, -0.5, 0.5, 1.5])
    wx = np.maximum(0.0, 1.0 - np.abs(off[:, 0:1] - centers[None, :]))  # (256,4)
    wy = np.maximum(0.0, 1.0 - np.abs(off[:, 1:2] - centers[None, :]))
    spatial = (wy[:, :, None] * wx[:, None, :]).reshape(256, 16)
    gauss = np.exp(-(off[:, 0] ** 2 + off[:, 1] ** 2) / (2 * (DESC_WIDTH / 2) ** 2))
    return (
        off.astype(np.float32),
        spatial.astype(np.float32),
        gauss.astype(np.float32),
    )


_DESC_OFF, _DESC_SPATIAL_W, _DESC_GAUSS_W = _desc_grid_constants()

# Orientation sampling grid: 16x16 covering radius 4.5 * 1.5 * sigma.
_ORI_LIN = ((np.arange(16) - 7.5) / 7.5).astype(np.float32)  # [-1, 1]
_ORI_GY, _ORI_GX = np.meshgrid(_ORI_LIN, _ORI_LIN, indexing="ij")
_ORI_OFF = np.stack([_ORI_GX.ravel(), _ORI_GY.ravel()], axis=1)  # (256, 2)
_ORI_GAUSS = np.exp(
    -(_ORI_OFF[:, 0] ** 2 + _ORI_OFF[:, 1] ** 2) / (2 * (2.0 / 3.0) ** 2)
).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("K",))
def _detect_octave(gauss: jnp.ndarray, K: int, contrast_thr: float = CONTRAST_THRESHOLD):
    """Find up to K refined extrema in one octave.

    gauss: (N_SCALES+3, H, W).  Returns dict of (K,)-shaped arrays:
    x, y (octave pixel coords, subpixel), scale (continuous scale index),
    sigma_octave (blur sigma in octave units), response, valid.
    """
    S, H, W = gauss.shape
    dog = gauss[1:] - gauss[:-1]  # (N_SCALES+2, H, W)

    # 26-neighbour extremum test as a 2-D spatial window + an elementwise
    # max/min over the three scale slices, which keeps every intermediate
    # in the DoG stack's own (scale, H, W) layout.
    big = 1e9
    pool_max = jax.lax.reduce_window(
        dog, -big, jax.lax.max, (1, 3, 3), (1, 1, 1), "SAME"
    )
    pool_min = jax.lax.reduce_window(
        dog, big, jax.lax.min, (1, 3, 3), (1, 1, 1), "SAME"
    )
    maxp = jnp.maximum(jnp.maximum(pool_max[:-2], pool_max[1:-1]),
                       pool_max[2:])
    minp = jnp.minimum(jnp.minimum(pool_min[:-2], pool_min[1:-1]),
                       pool_min[2:])
    center = dog[1:-1]  # scales 1..N_SCALES
    prelim_thr = 0.5 * contrast_thr / N_SCALES
    is_ext = ((center >= maxp) | (center <= minp)) & (jnp.abs(center) > prelim_thr)
    # Exclude the image border (need room for refinement + sampling).
    b = 5
    ys = jax.lax.broadcasted_iota(jnp.int32, center.shape, 1)
    xs = jax.lax.broadcasted_iota(jnp.int32, center.shape, 2)
    inside = (ys >= b) & (ys < H - b) & (xs >= b) & (xs < W - b)
    resp = jnp.where(is_ext & inside, jnp.abs(center), 0.0)

    flat = resp.reshape(-1)
    vals, idx = jax.lax.top_k(flat[None], K)
    vals, idx = vals[0], idx[0]
    scale_i = idx // (H * W) + 1            # dog scale index 1..N_SCALES
    rem = idx % (H * W)
    yi = rem // W
    xi = rem % W
    cand_valid = vals > 0

    # --- sub-pixel refinement: gather 3x3x3 neighbourhoods --------------------
    def neighborhood(s, y, x):
        return jax.lax.dynamic_slice(dog, (s - 1, y - 1, x - 1), (3, 3, 3))

    cube = jax.vmap(neighborhood)(scale_i, yi, xi)  # (K, 3, 3, 3)
    # Derivatives (finite differences), axes: 0=s, 1=y, 2=x.
    ds = 0.5 * (cube[:, 2, 1, 1] - cube[:, 0, 1, 1])
    dy = 0.5 * (cube[:, 1, 2, 1] - cube[:, 1, 0, 1])
    dx = 0.5 * (cube[:, 1, 1, 2] - cube[:, 1, 1, 0])
    c = cube[:, 1, 1, 1]
    dss = cube[:, 2, 1, 1] + cube[:, 0, 1, 1] - 2 * c
    dyy = cube[:, 1, 2, 1] + cube[:, 1, 0, 1] - 2 * c
    dxx = cube[:, 1, 1, 2] + cube[:, 1, 1, 0] - 2 * c
    dsy = 0.25 * (cube[:, 2, 2, 1] - cube[:, 2, 0, 1] - cube[:, 0, 2, 1] + cube[:, 0, 0, 1])
    dsx = 0.25 * (cube[:, 2, 1, 2] - cube[:, 2, 1, 0] - cube[:, 0, 1, 2] + cube[:, 0, 1, 0])
    dyx = 0.25 * (cube[:, 1, 2, 2] - cube[:, 1, 2, 0] - cube[:, 1, 0, 2] + cube[:, 1, 0, 0])
    Hm = jnp.stack(
        [
            jnp.stack([dss, dsy, dsx], axis=-1),
            jnp.stack([dsy, dyy, dyx], axis=-1),
            jnp.stack([dsx, dyx, dxx], axis=-1),
        ],
        axis=-2,
    )  # (K, 3, 3)
    g = jnp.stack([ds, dy, dx], axis=-1)
    # Damped closed-form (adjugate) solve: a batched LU from
    # jnp.linalg.solve costs far more than elementwise 3x3 Cramer; damping
    # keeps singular Hessians harmless (those get rejected).
    A = Hm + jnp.eye(3, dtype=jnp.float32) * 1e-6
    c00 = A[:, 1, 1] * A[:, 2, 2] - A[:, 1, 2] * A[:, 2, 1]
    c01 = A[:, 1, 2] * A[:, 2, 0] - A[:, 1, 0] * A[:, 2, 2]
    c02 = A[:, 1, 0] * A[:, 2, 1] - A[:, 1, 1] * A[:, 2, 0]
    det3 = A[:, 0, 0] * c00 + A[:, 0, 1] * c01 + A[:, 0, 2] * c02
    det3 = jnp.where(jnp.abs(det3) < 1e-18, 1e-18, det3)
    c10 = A[:, 0, 2] * A[:, 2, 1] - A[:, 0, 1] * A[:, 2, 2]
    c11 = A[:, 0, 0] * A[:, 2, 2] - A[:, 0, 2] * A[:, 2, 0]
    c12 = A[:, 0, 1] * A[:, 2, 0] - A[:, 0, 0] * A[:, 2, 1]
    c20 = A[:, 0, 1] * A[:, 1, 2] - A[:, 0, 2] * A[:, 1, 1]
    c21 = A[:, 0, 2] * A[:, 1, 0] - A[:, 0, 0] * A[:, 1, 2]
    c22 = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    adj = jnp.stack([
        jnp.stack([c00, c10, c20], axis=-1),
        jnp.stack([c01, c11, c21], axis=-1),
        jnp.stack([c02, c12, c22], axis=-1),
    ], axis=-2)
    off = -jnp.einsum("kij,kj->ki", adj, g) / det3[:, None]  # (K, 3) s,y,x
    off_ok = jnp.all(jnp.abs(off) < 1.5, axis=-1)
    # Refined contrast (OpenCV test: |D_hat| * N >= contrastThreshold).
    d_hat = c + 0.5 * jnp.sum(g * off, axis=-1)
    contrast_ok = jnp.abs(d_hat) * N_SCALES >= contrast_thr
    # Edge response on the 2x2 spatial Hessian.
    tr = dyy + dxx
    det = dyy * dxx - dyx * dyx
    r = EDGE_THRESHOLD
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) * (r + 1) * det)

    valid = cand_valid & off_ok & contrast_ok & edge_ok
    scale_f = scale_i.astype(jnp.float32) + off[:, 0]
    y_f = yi.astype(jnp.float32) + off[:, 1]
    x_f = xi.astype(jnp.float32) + off[:, 2]
    sigma_octave = SIGMA0 * (2.0 ** ((scale_f - 1.0) / N_SCALES))
    return {
        "x": x_f,
        "y": y_f,
        "scale_i": jnp.clip(scale_i, 1, N_SCALES),
        "scale": scale_f,
        "sigma_octave": sigma_octave,
        "response": jnp.abs(d_hat),
        "valid": valid,
    }


# --- patch-based sampling (the matmul formulation) -------------------------
#
# The gather formulation below costs ~1000 scattered row-gathers per keypoint
# (256 orientation + 2x256 descriptor samples x 2 rows each).  The patch
# formulation replaces them with dense linear algebra: ONE 66x66
# dynamic-slice per keypoint (66 contiguous row fetches), then every
# bilinear sample becomes a separable interpolation *matmul* over the patch
# — weights relu(1 - |pos - iota|) have exactly the two nonzeros of
# bilinear interpolation, so the result is the same math on the matrix
# units instead of scattered loads.  Which of the two is faster on the H100
# has not been measured.

_PATCH = 64          # gradient patch side; covers max desc radius ~29 px
_PATCH_C = 31.0      # keypoint integer pixel sits at this patch index


@jax.jit
def _extract_patches(gauss: jnp.ndarray, scale_i: jnp.ndarray,
                     yi: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Per-keypoint (P+2, P+2) gauss slices at each keypoint's scale.

    yi, xi: int32 (K,) floor pixel coords.  Edge-replicated beyond the
    image: zero-padding would manufacture a step edge at the border whose
    fake gradients (~0.5 * I(edge)) dominate orientation histograms for
    every keypoint within ~patch/2 of the border; replication gives zero
    gradient beyond the edge, matching the gather path's clamp semantics."""
    S, H, W = gauss.shape
    pad = _PATCH // 2 + 2
    gp = jnp.pad(gauss, ((0, 0), (pad, pad), (pad, pad)), mode="edge")

    def one(si, y0, x0):
        return jax.lax.dynamic_slice(
            gp,
            (si, y0 - int(_PATCH_C) - 1 + pad, x0 - int(_PATCH_C) - 1 + pad),
            (1, _PATCH + 2, _PATCH + 2),
        )[0]

    return jax.vmap(one)(scale_i, yi, xi)


def _patch_gradients(patches: jnp.ndarray) -> jnp.ndarray:
    """(K, P+2, P+2) gauss slices -> (K, 2, P, P) [gx, gy] central diffs."""
    gx = 0.5 * (patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2])
    gy = 0.5 * (patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1])
    return jnp.stack([gx, gy], axis=1)


def _sample_precision():
    """Precision of the interpolation matmuls (module knob, see header).
    The package pins float32 matmuls globally; interpolation weights are in
    [0,1] with two nonzeros and gradients are O(1e-1), so a reduced-
    precision product (TF32 or bf16) trades ~0.4% sample noise (below the
    descriptor's own f16 transfer quantization after normalisation) for
    matmul throughput."""
    return {
        "default": jax.lax.Precision.DEFAULT,
        "high": jax.lax.Precision.HIGH,
    }.get(_SAMPLE_PRECISION, _HIGHEST)


def _sample_patch_grads(g2: jnp.ndarray, sy: jnp.ndarray, sx: jnp.ndarray):
    """Bilinear gradient samples as separable interpolation matmuls.

    g2: (K, 2, P, P); sy/sx: (K, N) sample coords in gradient-patch units.
    Returns (gxs, gys): (K, N).  Samples outside [0, P-1] get weight 0."""
    P = g2.shape[-1]
    prec = _sample_precision()
    iota = jnp.arange(P, dtype=jnp.float32)
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(sy[..., None] - iota))  # (K, N, P)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(sx[..., None] - iota))
    t = jnp.einsum("kni,kcij->kcnj", wy, g2, precision=prec)
    out = jnp.einsum("kcnj,knj->kcn", t, wx, precision=prec)
    return out[:, 0], out[:, 1]


@functools.partial(jax.jit, static_argnames=("chunk",))
def _orient_and_describe_patch(gauss: jnp.ndarray, det: dict,
                               chunk: int = 512):
    """Patch/matmul variant of _orient_and_describe — same outputs.

    Keypoints are processed in `chunk`-sized slabs (lax.map) so the
    (chunk, 2, 512, P) interpolation intermediates stay ~100 MB instead of
    gigabytes at K=4096."""
    K = det["x"].shape[0]
    keys = ("x", "y", "sigma_octave", "scale_i")
    if K <= chunk:
        return _orient_describe_patch_body(
            gauss, {k: det[k] for k in keys})
    nc = -(-K // chunk)
    padK = nc * chunk

    def pad(v):
        return jnp.pad(v, (0, padK - K)).reshape(nc, chunk)

    det_c = {k: pad(det[k]) for k in keys}
    angles, avalid, d = jax.lax.map(
        lambda dc: _orient_describe_patch_body(gauss, dc), det_c)
    return (
        angles.reshape(padK, 2)[:K],
        avalid.reshape(padK, 2)[:K],
        d.reshape(padK, 2, 128)[:K],
    )


def _orient_describe_patch_body(gauss: jnp.ndarray, det: dict):
    """One keypoint slab of the patch/matmul formulation.

    Exact same sample grids, histogram, and descriptor assembly as the
    gather path; only the bilinear gradient sampling machinery differs
    (interpolation matmuls over per-keypoint patches instead of scattered
    row-gathers)."""
    x, y = det["x"], det["y"]
    sig = det["sigma_octave"]
    scale_i = det["scale_i"]
    K = x.shape[0]

    xi = jnp.floor(x).astype(jnp.int32)
    yi = jnp.floor(y).astype(jnp.int32)
    fx = x - xi
    fy = y - yi
    patches = _extract_patches(gauss, scale_i, yi, xi)
    g2 = _patch_gradients(patches)
    # Keypoint subpixel position in gradient-patch coords.
    cx = _PATCH_C + fx
    cy = _PATCH_C + fy

    # --- orientation ---------------------------------------------------------
    ori_off = jnp.asarray(_ORI_OFF)
    ori_gw = jnp.asarray(_ORI_GAUSS)
    radius = (4.5 * ORI_SIG_FCTR * sig)[:, None]          # (K, 1)
    sx_o = cx[:, None] + ori_off[None, :, 0] * radius      # (K, 256)
    sy_o = cy[:, None] + ori_off[None, :, 1] * radius
    gxs, gys = _sample_patch_grads(g2, sy_o, sx_o)
    mag = jnp.sqrt(gxs * gxs + gys * gys)
    ang = jnp.arctan2(gys, gxs)
    binf = (ang + jnp.pi) / (2 * jnp.pi) * ORI_BINS
    b0 = jnp.floor(binf).astype(jnp.int32) % ORI_BINS
    frac = binf - jnp.floor(binf)
    w = mag * ori_gw[None, :]
    oh0 = jax.nn.one_hot(b0, ORI_BINS, dtype=jnp.float32)
    oh1 = jax.nn.one_hot((b0 + 1) % ORI_BINS, ORI_BINS, dtype=jnp.float32)
    hist = jnp.einsum("knb,kn->kb", oh0, w * (1 - frac), precision=_HIGHEST) \
        + jnp.einsum("knb,kn->kb", oh1, w * frac, precision=_HIGHEST)

    def smooth(h):
        return (
            jnp.roll(h, 2, axis=-1) + 4 * jnp.roll(h, 1, axis=-1) + 6 * h
            + 4 * jnp.roll(h, -1, axis=-1) + jnp.roll(h, -2, axis=-1)
        ) / 16.0

    hist = smooth(smooth(hist))
    peak = jnp.max(hist, axis=-1)

    def interp_angle(h, b):
        l = h[(b - 1) % ORI_BINS]
        cme = h[b]
        rr = h[(b + 1) % ORI_BINS]
        denom = l - 2 * cme + rr
        off_b = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (l - rr) / denom, 0.0)
        bin_pos = (b.astype(jnp.float32) + off_b) % ORI_BINS
        return bin_pos / ORI_BINS * 2 * jnp.pi - jnp.pi

    def peaks(h, pk):
        b1 = jnp.argmax(h)
        a1 = interp_angle(h, b1)
        is_localmax = (h >= jnp.roll(h, 1)) & (h >= jnp.roll(h, -1))
        mask2 = is_localmax & (jnp.arange(ORI_BINS) != b1)
        h2 = jnp.where(mask2, h, -1.0)
        b2 = jnp.argmax(h2)
        a2 = interp_angle(h, b2)
        v2 = h2[b2] >= ORI_PEAK_RATIO * pk
        return jnp.stack([a1, a2]), jnp.stack([pk > 0, v2])

    angles, avalid = jax.vmap(peaks)(hist, peak)           # (K, 2), (K, 2)

    # --- descriptors (both orientation slots at once) ------------------------
    desc_off = jnp.asarray(_DESC_OFF)                      # (256, 2)
    spatial_w = jnp.asarray(_DESC_SPATIAL_W)               # (256, 16)
    gauss_w = jnp.asarray(_DESC_GAUSS_W)                   # (256,)
    cell = (DESC_SCL_FCTR * sig)[:, None, None]            # (K, 1, 1)
    ca = jnp.cos(angles)[..., None]                        # (K, 2, 1)
    sa = jnp.sin(angles)[..., None]
    ox = desc_off[None, None, :, 0] * cell                 # (K, 2, 256)
    oy = desc_off[None, None, :, 1] * cell
    sx_d = (cx[:, None, None] + ca * ox - sa * oy).reshape(K, -1)  # (K, 512)
    sy_d = (cy[:, None, None] + sa * ox + ca * oy).reshape(K, -1)
    gxs_d, gys_d = _sample_patch_grads(g2, sy_d, sx_d)     # (K, 512)
    gxs_d = gxs_d.reshape(K, 2, 256)
    gys_d = gys_d.reshape(K, 2, 256)
    mag_d = jnp.sqrt(gxs_d ** 2 + gys_d ** 2) * gauss_w[None, None, :]
    ang_d = jnp.arctan2(gys_d, gxs_d) - angles[..., None]
    binf_d = jnp.mod((ang_d / (2 * jnp.pi)) * DESC_BINS, DESC_BINS)
    b0_d = jnp.floor(binf_d).astype(jnp.int32) % DESC_BINS
    frac_d = binf_d - jnp.floor(binf_d)
    oh0_d = jax.nn.one_hot(b0_d, DESC_BINS, dtype=jnp.float32) \
        * (1 - frac_d)[..., None]
    oh1_d = jax.nn.one_hot((b0_d + 1) % DESC_BINS, DESC_BINS,
                           dtype=jnp.float32) * frac_d[..., None]
    ori_contrib = (oh0_d + oh1_d) * mag_d[..., None]       # (K, 2, 256, 8)
    d = jnp.einsum("sc,kasb->kacb", spatial_w, ori_contrib,
                   precision=_HIGHEST)                     # (K, 2, 16, 8)
    d = d.reshape(K, 2, 128)
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    d = jnp.minimum(d, DESC_MAG_THR)
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    return angles, avalid, d


@jax.jit
def _orient_and_describe(gauss: jnp.ndarray, det: dict):
    """Orientation histograms + descriptors for one octave's candidates.

    gauss: (N_SCALES+3, H, W); det: output of _detect_octave.
    Returns (angles (K, 2), angle_valid (K, 2), desc (K, 2, 128)) — up to
    two orientations (primary, secondary peak) per keypoint.
    """
    S, H, W = gauss.shape
    # Gradients of every scale once.  Packed as a row-gatherable
    # (S*H*W, 4) table [gx[i], gx[i+1], gy[i], gy[i+1]]: one bilinear
    # sample then needs TWO row-gathers (rows base and base+W) instead of
    # eight scalar gathers.
    gx = jnp.zeros_like(gauss)
    gx = gx.at[:, :, 1:-1].set(0.5 * (gauss[:, :, 2:] - gauss[:, :, :-2]))
    gy = jnp.zeros_like(gauss)
    gy = gy.at[:, 1:-1, :].set(0.5 * (gauss[:, 2:, :] - gauss[:, :-2, :]))
    gx_flat = gx.reshape(-1)
    gy_flat = gy.reshape(-1)
    shift = lambda v: jnp.concatenate([v[1:], v[:1]])
    gpack = jnp.stack(
        [gx_flat, shift(gx_flat), gy_flat, shift(gy_flat)], axis=1)
    vol_shape = (S, H, W)

    x = det["x"]
    y = det["y"]
    sig = det["sigma_octave"]
    scale_i = det["scale_i"]

    ori_off = jnp.asarray(_ORI_OFF)        # (256, 2) in [-1, 1]
    ori_gw = jnp.asarray(_ORI_GAUSS)       # (256,)

    def per_kpt_orientation(xk, yk, sk, si):
        radius = 4.5 * ORI_SIG_FCTR * sk
        sx = xk + ori_off[:, 0] * radius
        sy = yk + ori_off[:, 1] * radius
        gxs, gys = _bilinear_grads(gpack, vol_shape, si, sx, sy)
        mag = jnp.sqrt(gxs * gxs + gys * gys)
        ang = jnp.arctan2(gys, gxs)  # (-pi, pi]
        binf = (ang + jnp.pi) / (2 * jnp.pi) * ORI_BINS
        b0 = jnp.floor(binf).astype(jnp.int32) % ORI_BINS
        frac = binf - jnp.floor(binf)
        w = mag * ori_gw
        hist = (
            jax.ops.segment_sum(w * (1 - frac), b0, num_segments=ORI_BINS)
            + jax.ops.segment_sum(w * frac, (b0 + 1) % ORI_BINS, num_segments=ORI_BINS)
        )
        # Circular smoothing [1 4 6 4 1] / 16, twice.
        def smooth(h):
            return (
                jnp.roll(h, 2) + 4 * jnp.roll(h, 1) + 6 * h
                + 4 * jnp.roll(h, -1) + jnp.roll(h, -2)
            ) / 16.0

        hist = smooth(smooth(hist))
        peak = jnp.max(hist)
        # Primary peak with parabolic interpolation.
        def interp_angle(b):
            l = hist[(b - 1) % ORI_BINS]
            cme = hist[b]
            rr = hist[(b + 1) % ORI_BINS]
            denom = l - 2 * cme + rr
            off_b = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (l - rr) / denom, 0.0)
            bin_pos = (b.astype(jnp.float32) + off_b) % ORI_BINS
            return bin_pos / ORI_BINS * 2 * jnp.pi - jnp.pi

        b1 = jnp.argmax(hist)
        a1 = interp_angle(b1)
        # Secondary: best local max >= ratio * peak, excluding the primary bin.
        is_localmax = (hist >= jnp.roll(hist, 1)) & (hist >= jnp.roll(hist, -1))
        mask2 = is_localmax & (jnp.arange(ORI_BINS) != b1)
        h2 = jnp.where(mask2, hist, -1.0)
        b2 = jnp.argmax(h2)
        a2 = interp_angle(b2)
        v2 = h2[b2] >= ORI_PEAK_RATIO * peak
        return jnp.stack([a1, a2]), jnp.stack([peak > 0, v2])

    angles, avalid = jax.vmap(per_kpt_orientation)(x, y, sig, scale_i)

    desc_off = jnp.asarray(_DESC_OFF)          # (256, 2) cell units
    spatial_w = jnp.asarray(_DESC_SPATIAL_W)   # (256, 16)
    gauss_w = jnp.asarray(_DESC_GAUSS_W)       # (256,)

    def per_kpt_descriptor(xk, yk, sk, si, angle):
        cell = DESC_SCL_FCTR * sk  # pixels per descriptor cell
        ca = jnp.cos(angle)
        sa = jnp.sin(angle)
        # Rotated sample positions.
        ox = desc_off[:, 0] * cell
        oy = desc_off[:, 1] * cell
        sx = xk + ca * ox - sa * oy
        sy = yk + sa * ox + ca * oy
        gxs, gys = _bilinear_grads(gpack, vol_shape, si, sx, sy)
        mag = jnp.sqrt(gxs * gxs + gys * gys) * gauss_w
        ang = jnp.arctan2(gys, gxs) - angle
        binf = (ang / (2 * jnp.pi)) * DESC_BINS
        binf = jnp.mod(binf, DESC_BINS)
        b0 = jnp.floor(binf).astype(jnp.int32) % DESC_BINS
        frac = binf - jnp.floor(binf)
        # Orientation soft-assign -> (256, 8).
        oh0 = jax.nn.one_hot(b0, DESC_BINS, dtype=jnp.float32) * (1 - frac)[:, None]
        oh1 = jax.nn.one_hot((b0 + 1) % DESC_BINS, DESC_BINS, dtype=jnp.float32) * frac[:, None]
        ori_contrib = (oh0 + oh1) * mag[:, None]
        # Spatial bilinear (constant weights) x orientation: (16, 8).
        d = jnp.einsum("sc,sb->cb", spatial_w, ori_contrib, precision=_HIGHEST)
        d = d.reshape(-1)  # 128
        # Normalise, clip, renormalise (standard SIFT illumination model).
        d = d / jnp.maximum(jnp.linalg.norm(d), 1e-12)
        d = jnp.minimum(d, DESC_MAG_THR)
        d = d / jnp.maximum(jnp.linalg.norm(d), 1e-12)
        return d

    def both(xk, yk, sk, si, ang2):
        return jax.vmap(lambda a: per_kpt_descriptor(xk, yk, sk, si, a))(ang2)

    desc = jax.vmap(both)(x, y, sig, scale_i, angles)  # (K, 2, 128)
    return angles, avalid, desc


@functools.partial(jax.jit, static_argnames=("K",))
def _detect_octave_batched(gauss_b, K, contrast_thr):
    """vmapped extrema detection: gauss_b (B, S, H, W)."""
    return jax.vmap(lambda g: _detect_octave(g, K, contrast_thr))(gauss_b)


@jax.jit
def _orient_describe_batched(gauss_b, det_b):
    return jax.vmap(_orient_and_describe)(gauss_b, det_b)


@jax.jit
def _orient_describe_patch_batched(gauss_b, det_b):
    # Sequential over images (lax.map, not vmap): batching the chunked
    # interpolation matmuls would multiply their ~100 MB intermediates by B.
    return jax.lax.map(
        lambda gd: _orient_and_describe_patch(gd[0], gd[1]),
        (gauss_b, det_b),
    )


@functools.partial(
    jax.jit,
    static_argnames=("num_octaves", "k_sched", "first_octave", "sample_mode",
                     "num_features", "normalization", "transfer_dtype",
                     "upsample"))
def _extract_all(imgs, num_octaves: int, k_sched: tuple,
                 contrast_thr: float, first_octave: int, sample_mode: str,
                 num_features: int, normalization: str, transfer_dtype: str,
                 upsample: bool):
    """The ENTIRE batched extraction as one device program: base image, all
    octaves (pyramid/detect/orient/describe), cross-octave top-feature
    selection.  One dispatch + one small device->host transfer per batch."""
    # uint8 images cross host->device raw (4x fewer bytes than f32);
    # normalise on device.
    if imgs.dtype == jnp.uint8:
        imgs = imgs.astype(jnp.float32) / 255.0
    g = _base_image_batched(imgs, upsample=upsample)
    oct_kp, oct_desc, oct_valid = [], [], []
    for o in range(num_octaves):
        kp_o, desc_o, val_o, g = _octave_pipeline_body(
            g, k_sched[o], contrast_thr, 2.0 ** (o + first_octave),
            sample_mode)
        g = jax.lax.optimization_barrier(g)
        oct_kp.append(kp_o)
        oct_desc.append(desc_o)
        oct_valid.append(val_o)
    kp_all = jnp.concatenate(oct_kp, axis=1)
    desc_all = jnp.concatenate(oct_desc, axis=1)
    val_all = jnp.concatenate(oct_valid, axis=1)
    return _select_top_features(
        kp_all, desc_all, val_all, num_features, normalization,
        transfer_dtype=transfer_dtype)


def _octave_pipeline_body(g_b, K: int, contrast_thr: float,
                          octave_scale: float, sample_mode: str):
    """One octave: pyramid build + extrema detect + orientation/descriptor
    + flatten, returning the next octave's base.  Traced inside the one
    program of _extract_all, so an octave costs no dispatch of its own."""
    gauss = _build_octave_batched(g_b)
    # The barrier keeps XLA from propagating the keypoint-stage layout
    # preferences into the dense detect stage (a layout change on the whole
    # DoG stack once cost a 25-40x memory expansion at 5 MP on another
    # backend; not re-measured on the GPU).
    gauss = jax.lax.optimization_barrier(gauss)
    det = jax.vmap(lambda g: _detect_octave(g, K, contrast_thr))(gauss)
    det = jax.lax.optimization_barrier(det)
    if sample_mode == "patch":
        angles, avalid, desc = _orient_describe_patch_batched(gauss, det)
    else:
        angles, avalid, desc = _orient_describe_batched(gauss, det)
    kp, desc_o, val = _collect_octave(det, angles, avalid, desc, octave_scale)
    g_next = gauss[:, N_SCALES, ::2, ::2]
    return kp, desc_o, val, g_next


@jax.jit
def _build_octave_batched(base_b):
    """(B, H, W) octave bases -> (B, S+3, H, W) gaussian stacks: the base
    itself, then every scale blurred directly from it (composed sigmas)."""
    return jnp.concatenate(
        [base_b[:, None], _blur_stack(base_b, _OCT_KER)], axis=1)


@jax.jit
def _collect_octave(det, angles, avalid, desc, octave_scale):
    """Flatten one octave's detections into original-image coordinates —
    stays on device; both orientation slots become independent rows.

    Returns (kp (B, K*2, 4) [x, y, size, angle_deg], desc (B, K*2, 128),
    valid (B, K*2))."""
    x = det["x"] * octave_scale                       # (B, K)
    y = det["y"] * octave_scale
    size = det["sigma_octave"] * octave_scale * 2.0   # size ~ 2*sigma
    ang_deg = jnp.degrees(angles)                     # (B, K, 2)
    B, K = x.shape
    kp = jnp.stack(
        [
            jnp.broadcast_to(x[..., None], (B, K, 2)),
            jnp.broadcast_to(y[..., None], (B, K, 2)),
            jnp.broadcast_to(size[..., None], (B, K, 2)),
            ang_deg,
        ],
        axis=-1,
    )                                                  # (B, K, 2, 4)
    valid = det["valid"][..., None] & avalid           # (B, K, 2)
    return (
        kp.reshape(B, K * 2, 4),
        desc.reshape(B, K * 2, 128),
        valid.reshape(B, K * 2),
    )


@functools.partial(
    jax.jit,
    static_argnames=("num_features", "normalization", "transfer_dtype"))
def _select_top_features(kp, desc, valid, num_features: int,
                         normalization: str,
                         transfer_dtype: str = "float32"):
    """Cross-octave top-`num_features` by keypoint size, ON DEVICE (the
    reference's ExtractTopScaleKeyPoints policy, FeatureUtils.cpp:38-96),
    followed by the output normalisation — so the whole extraction makes
    exactly one device->host transfer per batch."""
    score = jnp.where(valid, kp[..., 2], -1.0)
    n = min(num_features, score.shape[1])
    vals, idx = jax.lax.top_k(score, n)                     # (B, n)
    kp_s = jnp.take_along_axis(kp, idx[..., None], axis=1)
    desc_s = jnp.take_along_axis(desc, idx[..., None], axis=1)
    val_s = vals > 0.0
    if normalization == "l1_root":
        # RootSIFT: L1-normalise then sqrt -> unit L2 (FeatureUtils.cpp:260-270).
        desc_s = desc_s / jnp.maximum(
            jnp.sum(jnp.abs(desc_s), axis=-1, keepdims=True), 1e-12
        )
        desc_s = jnp.sqrt(desc_s)
    else:  # l2
        desc_s = desc_s / jnp.maximum(
            jnp.linalg.norm(desc_s, axis=-1, keepdims=True), 1e-12
        )
    if transfer_dtype == "float16":
        desc_s = desc_s.astype(jnp.float16)
    return kp_s, desc_s, val_s


class SIFT:
    """Host orchestration: octave loop + final keypoint selection.

    extract() returns (keypoints (N, 4): x, y, size, angle_deg in *original
    image* coordinates, descriptors (N, 128) float32, both already truncated
    to at most `num_features` by descending size — the reference's
    ExtractTopScaleKeyPoints policy, FeatureUtils.cpp:38-96).
    """

    def __init__(self, num_features: int = 8024, k_per_octave: int = 4096,
                 upsample: bool = True, normalization: str = "l1_root",
                 contrast_threshold: float = CONTRAST_THRESHOLD,
                 decay_octave_budget: bool = True,
                 sample_mode: str = "patch",
                 transfer_dtype: str = "float16"):
        self.num_features = num_features
        self.k_per_octave = k_per_octave
        self.upsample = upsample
        self.normalization = normalization
        self.contrast_threshold = contrast_threshold
        # "patch": per-keypoint patches + interpolation matmuls (the
        # default); "gather": scattered row-gathers (the former
        # formulation, kept for A/B and for exact parity with old outputs).
        self.sample_mode = sample_mode
        # Device->host dtype for descriptors ("float16" halves the transfer;
        # host upcasts back to f32).
        self.transfer_dtype = transfer_dtype
        # Halve the candidate budget per octave past the second (perf lever:
        # the orientation/descriptor gather cost scales with the budget and
        # real images concentrate surviving features in the first octaves).
        # decay_octave_budget=False restores the keep-all-then-select-top
        # policy for coarse-scale-dominated scenes.
        self.decay_octave_budget = decay_octave_budget

    def extract(self, image: np.ndarray):
        """image: (H, W) uint8 or float in [0, 255]."""
        kps, descs = self.extract_batch(np.asarray(image)[None])
        return kps[0], descs[0]

    def extract_batch(self, images: np.ndarray):
        """images: (B, H, W) same-sized batch — one device dispatch per
        octave covers the whole batch (image-parallel extraction, SURVEY.md
        parallelism plan (a)).

        Returns (list of (Ni, 4) keypoints, list of (Ni, 128) descriptors).
        """
        B = images.shape[0]
        images = np.asarray(images)
        if images.dtype == np.uint8:
            imgs = jnp.asarray(images)          # raw bytes up; /255 on device
        else:
            imgs = jnp.asarray(images.astype(np.float32) / 255.0)
        first_octave = -1 if self.upsample else 0
        H0, W0 = imgs.shape[1:]
        if self.upsample:
            H0, W0 = 2 * H0, 2 * W0
        num_octaves = int(np.round(np.log2(min(H0, W0)))) - 3
        num_octaves = max(min(num_octaves, 8), 1)

        # Static per-octave candidate budget schedule.  The budget decays
        # past the second octave (real images put the overwhelming majority
        # of surviving features in the first two octaves, and per-slot
        # orientation/descriptor sampling cost scales with the budget);
        # decay_octave_budget=False restores keep-all-then-select-top.
        k_sched = []
        h, w_ = H0, W0
        for o in range(num_octaves):
            if self.decay_octave_budget:
                k_oct = max(self.k_per_octave >> max(0, o - 1), 256)
            else:
                k_oct = self.k_per_octave
            k_sched.append(min(k_oct, N_SCALES * h * w_))
            h, w_ = (h + 1) // 2, (w_ + 1) // 2  # ::2 slicing keeps ceil
            if min(h, w_) < 16:
                num_octaves = o + 1
                break

        # The ENTIRE extraction runs as one jitted program: one dispatch,
        # one device->host transfer per batch.
        kp_s, desc_s, val_s = _extract_all(
            imgs, num_octaves, tuple(k_sched), self.contrast_threshold,
            first_octave, self.sample_mode, self.num_features,
            self.normalization, self.transfer_dtype, self.upsample,
        )
        # Descriptors cross device->host as f16 by default (half the bytes;
        # ~2e-4 relative error, far below descriptor noise).
        kp_h = np.asarray(kp_s, np.float32)
        desc_h = np.asarray(desc_s).astype(np.float32)
        val_h = np.asarray(val_s)

        out_kp, out_desc = [], []
        for b in range(B):
            keep = val_h[b]
            out_kp.append(kp_h[b][keep])
            out_desc.append(desc_h[b][keep])
        return out_kp, out_desc
