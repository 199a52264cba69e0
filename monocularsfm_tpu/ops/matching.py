"""Descriptor matching: tiled similarity matmul + ratio + cross-check.

Reference parity: src/Feature/FeatureUtils.cpp —
  ComputeMatches        (:141-157)  BF knn-2 + Lowe ratio 0.8
  ComputeCrossMatches   (:160-174)  ratio both directions + mutual CrossCheck
  FilterMatchesByDistance (:208-218) absolute L2 distance <= 0.7

Design: descriptors are unit-L2 (RootSIFT), so L2 distance is
dist = sqrt(2 - 2*sim) and knn search becomes one [N, N] similarity matmul
(bf16 operands, f32 accumulation).  Instead of materialising the full
matrix (8192^2 fp32 = 256 MB per pair), we stream column tiles of B with
lax.scan, flash-attention style,
keeping only running top-2 statistics per A row and per B column (the
B-column top-2 falls out for free because every tile holds complete columns).
Arrays are fixed-capacity with validity masks — no dynamic shapes anywhere.

Output format is an index map `idx_b: int32[N_A]` (INVALID = -1 where no
match survived), which keeps shapes static; hosts convert to (i, j) pair
lists with one np.nonzero.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG = -1e30


def _merge_top2(v1, i1, v2, n1, n2, idx1, idx2):
    """Merge two (top1, top2) statistic sets per row.

    v1/i1/n1: running top1 val, top1 idx, top2 val.
    v2/idx... incoming tile top1 val, top1 idx, top2 val (n2).
    Returns merged (top1_val, top1_idx, top2_val).
    """
    take_new = v2 > v1
    new_top1 = jnp.where(take_new, v2, v1)
    new_top1_idx = jnp.where(take_new, idx2, idx1)
    # The new top2 is the best of: loser of the top1 duel, both old/new top2.
    loser = jnp.where(take_new, v1, v2)
    new_top2 = jnp.maximum(loser, jnp.maximum(n1, n2))
    return new_top1, new_top1_idx, new_top2


def _tile_top2(sims, base_idx):
    """Per-row top-2 within a tile. sims: (N, T) -> (top1, idx, top2)."""
    top1 = jnp.max(sims, axis=1)
    arg = jnp.argmax(sims, axis=1)
    cols = jax.lax.broadcasted_iota(jnp.int32, sims.shape, 1)
    masked = jnp.where(cols == arg[:, None], NEG, sims)
    top2 = jnp.max(masked, axis=1)
    return top1, (base_idx + arg).astype(jnp.int32), top2


@functools.partial(
    jax.jit,
    static_argnames=("ratio", "max_distance", "cross_check", "col_tile"),
)
def match_descriptors_pair(
    desc_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    mask_a: jnp.ndarray,
    mask_b: jnp.ndarray,
    ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
    col_tile: int = 1024,
) -> jnp.ndarray:
    """Match descriptors A->B. Returns idx_b: int32[N_A], -1 where unmatched.

    desc_a: (N_A, D) float, unit-L2 rows (padding rows are all-zero).
    mask_a/mask_b: bool validity.
    """
    n_a, d = desc_a.shape
    n_b = desc_b.shape[0]
    assert n_b % col_tile == 0, "capacity must be a multiple of col_tile"
    num_tiles = n_b // col_tile

    a = desc_a.astype(jnp.bfloat16)
    b = desc_b.astype(jnp.bfloat16)
    b_tiles = b.reshape(num_tiles, col_tile, d)
    maskb_tiles = mask_b.reshape(num_tiles, col_tile)

    # Derive the carry init from the input so it inherits the input's
    # device-varying type under shard_map (fresh constants would be typed
    # replicated and trip the scan vma check).
    zrow = jnp.zeros_like(a[:, 0], dtype=jnp.float32)
    init = (
        zrow + NEG,                         # row top1
        zrow.astype(jnp.int32),             # row top1 idx
        zrow + NEG,                         # row top2
    )

    def body(carry, inp):
        tile_i, b_tile, mb = inp
        t1, i1, t2 = carry
        sims = jax.lax.dot_general(
            a, b_tile,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # (N_A, T)
        sims = jnp.where(mb[None, :], sims, NEG)
        sims = jnp.where(mask_a[:, None], sims, NEG)
        tt1, ti1, tt2 = _tile_top2(sims, tile_i * col_tile)
        carry = _merge_top2(t1, i1, tt1, t2, tt2, i1, ti1)
        # Column-direction top-2 within the tile (columns are complete: all of
        # A is resident), emitted per tile for the reverse ratio/cross check.
        c1 = jnp.max(sims, axis=0)
        carg = jnp.argmax(sims, axis=0).astype(jnp.int32)
        rows = jax.lax.broadcasted_iota(jnp.int32, sims.shape, 0)
        c2 = jnp.max(jnp.where(rows == carg[None, :], NEG, sims), axis=0)
        return carry, (c1, carg, c2)

    (t1, i1, t2), (col1, colarg, col2) = jax.lax.scan(
        body,
        init,
        (jnp.arange(num_tiles, dtype=jnp.int32), b_tiles, maskb_tiles),
    )
    return decide_matches(
        t1, i1, t2, col1.reshape(n_b), colarg.reshape(n_b), col2.reshape(n_b),
        mask_a, ratio=ratio, max_distance=max_distance,
        cross_check=cross_check,
    )


def decide_matches(t1, i1, t2, col1, colarg, col2, mask_a, *, ratio: float,
                   max_distance: float, cross_check: bool):
    """Ratio, distance and cross-check decision from the six top-2
    statistics (row top1/argmax/top2 over B, column top1/argmax/top2 over
    A), shared by the scan matcher and the fused kernel."""
    n_a = t1.shape[0]
    n_b = col1.shape[0]

    def dist(sim):
        return jnp.sqrt(jnp.maximum(2.0 - 2.0 * sim, 0.0))

    d1, d2 = dist(t1), dist(t2)
    ok = mask_a & (t1 > NEG / 2)
    # Lowe ratio, forward direction (FeatureUtils.cpp:148-153).
    ok &= d1 < ratio * d2
    # Absolute distance filter (FeatureUtils.cpp:208-218).
    ok &= d1 <= max_distance
    if cross_check:
        j = jnp.clip(i1, 0, n_b - 1)
        # Mutual best (CrossCheck, FeatureUtils.cpp:281-310) ...
        ok &= colarg[j] == jnp.arange(n_a, dtype=jnp.int32)
        # ... and reverse-direction ratio (ComputeCrossMatches runs the ratio
        # test from both sides before intersecting).
        ok &= dist(col1[j]) < ratio * dist(col2[j])
    return jnp.where(ok, i1, -1).astype(jnp.int32)


# Batched variant: one dispatch matches a slab of pairs. Gathers the per-image
# descriptor slabs from a device-resident bank — the scheduling (which pairs)
# stays on host, the O(pairs * N^2 * D) math stays on the device.
@functools.partial(
    jax.jit,
    static_argnames=(
        "ratio", "max_distance", "cross_check", "col_tile", "kernel"),
)
def match_pairs_batch(
    desc_bank: jnp.ndarray,   # (num_images, N, D)
    mask_bank: jnp.ndarray,   # (num_images, N)
    pair_ids: jnp.ndarray,    # (P, 2) int32 image indices into the bank
    ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
    col_tile: int = 1024,
    kernel: str = "auto",
) -> jnp.ndarray:
    """Returns idx_b: int32 (P, N) match map per pair.

    kernel: "xla" (lax.scan over column tiles; runs on every backend),
    "triton" (the fused tile kernel of ops/pallas_matching.py; GPU only,
    raises on any other backend), or "auto" (triton on a GPU, xla
    elsewhere)."""
    backend = jax.default_backend()
    if kernel == "auto":
        kernel = "triton" if backend == "gpu" else "xla"
    if kernel == "triton":
        if backend != "gpu":
            raise ValueError(
                f"kernel='triton' needs a GPU backend, not {backend!r}")
        from monocularsfm_tpu.ops.pallas_matching import match_pairs_fused

        return match_pairs_fused(
            desc_bank, mask_bank, pair_ids, ratio=ratio,
            max_distance=max_distance, cross_check=cross_check)
    if kernel != "xla":
        raise ValueError(f"unknown matching kernel {kernel!r}")

    def one(pair):
        ia, ib = pair[0], pair[1]
        return match_descriptors_pair(
            desc_bank[ia], desc_bank[ib], mask_bank[ia], mask_bank[ib],
            ratio=ratio, max_distance=max_distance,
            cross_check=cross_check, col_tile=col_tile,
        )

    return jax.vmap(one)(pair_ids)


def matches_to_pairs(idx_b) -> "tuple":
    """Host-side: index map -> (i, j) int32 arrays of matched keypoint ids."""
    import numpy as np

    idx_b = np.asarray(idx_b)
    i = np.nonzero(idx_b >= 0)[0].astype(np.int32)
    return i, idx_b[i].astype(np.int32)
