"""Fused descriptor-matching kernel for NVIDIA GPUs (Pallas, Triton route).

The XLA matcher in ops/matching.py writes every (N_A, col_tile) f32
similarity tile to device memory and reads it back for the max, the argmax
and the runner-up of both directions.  Here one block computes one
(row_tile, col_tile) bf16 tile product, keeps it in registers, and writes
only that tile's row- and column-direction top-2 partials.  Blocks carry
nothing from one to another, so they may run in any order; a small jnp
epilogue merges the partials across tiles and applies the shared
ratio/distance/cross-check decision of ops/matching.py.

The pair index is the outer grid axis: each block loads its own pair's image
rows from `pair_ids`, so one launch matches a whole slab of pairs out of the
device-resident descriptor bank.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from monocularsfm_tpu.ops.matching import NEG, decide_matches

# Tile and launch shape: the fastest of eleven (row, col, warps, stages)
# settings timed on an H100 at 16 pairs x 8192 x 128, together with
# (256, 64, 4, 1), which is within run-to-run spread of it but would not
# divide the 128-row preemptive bank.
ROW_TILE = 128
COL_TILE = 64
NUM_WARPS = 4
NUM_STAGES = 1


def _match_tile_kernel(pair_ref, bank_ref, mask_ref,
                       rt1_ref, ri1_ref, rt2_ref, ct1_ref, ci1_ref, ct2_ref):
    p = pl.program_id(0)
    r = pl.program_id(1)
    c = pl.program_id(2)
    tr = rt1_ref.shape[-1]
    tc = ct1_ref.shape[-1]
    ia = pair_ref[p, 0]
    ib = pair_ref[p, 1]
    a = bank_ref[ia, pl.ds(r * tr, tr), :]
    b = bank_ref[ib, pl.ds(c * tc, tc), :]
    ma = mask_ref[ia, pl.ds(r * tr, tr)] != 0
    mb = mask_ref[ib, pl.ds(c * tc, tc)] != 0
    sims = jax.lax.dot_general(
        a, b, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (tr, tc), bf16 products accumulated in f32
    sims = jnp.where(ma[:, None] & mb[None, :], sims, NEG)

    # Row direction: top-2 over this tile's columns (global column ids).
    t1 = jnp.max(sims, axis=1)
    arg = jnp.argmax(sims, axis=1).astype(jnp.int32)
    cols = jax.lax.broadcasted_iota(jnp.int32, sims.shape, 1)
    rt1_ref[...] = t1
    ri1_ref[...] = arg + c * tc
    rt2_ref[...] = jnp.max(jnp.where(cols == arg[:, None], NEG, sims), axis=1)

    # Column direction: top-2 over this tile's rows (global row ids).
    ct1 = jnp.max(sims, axis=0)
    carg = jnp.argmax(sims, axis=0).astype(jnp.int32)
    rows = jax.lax.broadcasted_iota(jnp.int32, sims.shape, 0)
    ct1_ref[...] = ct1
    ci1_ref[...] = carg + r * tr
    ct2_ref[...] = jnp.max(jnp.where(rows == carg[None, :], NEG, sims), axis=0)


def _merge_partials(t1p, i1p, t2p):
    """Merge per-tile top-2 partials along axis 0: (G, N) -> 3 x (N,).
    Ties keep the first tile, i.e. the smallest index, like the scan."""
    g = jnp.argmax(t1p, axis=0)
    t1 = jnp.take_along_axis(t1p, g[None], axis=0)[0]
    i1 = jnp.take_along_axis(i1p, g[None], axis=0)[0]
    # Runner-up: the winning tile contributes its top2, every other tile
    # its top1.
    tile_ids = jnp.arange(t1p.shape[0], dtype=jnp.int32)[:, None]
    t2 = jnp.max(jnp.where(tile_ids == g[None, :], t2p, t1p), axis=0)
    return t1, i1, t2


@functools.partial(
    jax.jit,
    static_argnames=("ratio", "max_distance", "cross_check", "interpret"),
)
def match_pairs_fused(
    desc_bank, mask_bank, pair_ids,
    ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
    interpret: bool = False,
):
    """Same contract as ops.matching.match_pairs_batch: (I, N, D) bank,
    (I, N) masks, (P, 2) image-row pairs -> int32 (P, N) idx_b maps.

    N must be a multiple of both tiles and D a power of two (Triton loads
    power-of-two blocks).  `interpret=True` runs the kernel through the
    Pallas interpreter (CPU tests)."""
    _, n, d = desc_bank.shape
    row_tile, col_tile = ROW_TILE, COL_TILE
    if n % row_tile or n % col_tile:
        raise ValueError(f"capacity {n} is not a multiple of the tiles "
                         f"({row_tile}, {col_tile})")
    if d & (d - 1):
        raise ValueError(f"descriptor width {d} is not a power of two")
    P = pair_ids.shape[0]
    nr, nc = n // row_tile, n // col_tile
    row_spec = pl.BlockSpec((None, None, row_tile), lambda p, r, c: (p, c, r))
    col_spec = pl.BlockSpec((None, None, col_tile), lambda p, r, c: (p, r, c))
    row_shape = (P, nc, n)
    col_shape = (P, nr, n)
    rt1, ri1, rt2, ct1, ci1, ct2 = pl.pallas_call(
        _match_tile_kernel,
        grid=(P, nr, nc),
        out_specs=(row_spec, row_spec, row_spec, col_spec, col_spec, col_spec),
        out_shape=(
            jax.ShapeDtypeStruct(row_shape, jnp.float32),
            jax.ShapeDtypeStruct(row_shape, jnp.int32),
            jax.ShapeDtypeStruct(row_shape, jnp.float32),
            jax.ShapeDtypeStruct(col_shape, jnp.float32),
            jax.ShapeDtypeStruct(col_shape, jnp.int32),
            jax.ShapeDtypeStruct(col_shape, jnp.float32),
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name="match_tile_top2",
    )(
        pair_ids.astype(jnp.int32),
        desc_bank.astype(jnp.bfloat16),
        mask_bank.astype(jnp.int32),
    )
    merge = jax.vmap(_merge_partials)
    t1, i1, t2 = merge(rt1, ri1, rt2)
    col1, colarg, col2 = merge(ct1, ci1, ct2)
    mask_a = mask_bank[pair_ids[:, 0]]
    return jax.vmap(functools.partial(
        decide_matches, ratio=ratio, max_distance=max_distance,
        cross_check=cross_check,
    ))(t1, i1, t2, col1, colarg, col2, mask_a)
