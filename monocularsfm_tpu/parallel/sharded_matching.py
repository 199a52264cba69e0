"""Pair-parallel descriptor matching over a device mesh.

Parallelism plan (b) from SURVEY.md section 2: the pair list shards across
chips while the descriptor bank is replicated (collections whose banks
exceed one device's memory rotate bank shards around a device ring instead — the
SfM analogue of ring attention; see ring_bank_matching below for the
single-host formulation).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from monocularsfm_tpu.ops.matching import match_descriptors_pair, match_pairs_batch


def sharded_match_pairs(
    desc_bank: jnp.ndarray,
    mask_bank: jnp.ndarray,
    pair_ids: np.ndarray,
    mesh: Mesh,
    ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
    col_tile: int = 1024,
):
    """Match a list of image pairs, pair list sharded over the mesh.

    pair_ids: (Np, 2) int32.  Pads the pair list to a multiple of the mesh
    size (duplicate last pair; caller slices).  Returns (Np, N) index maps.
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    n_pairs = len(pair_ids)
    target = ((n_pairs + n_dev - 1) // n_dev) * n_dev
    if target != n_pairs:
        pair_ids = np.concatenate(
            [pair_ids, np.repeat(pair_ids[-1:], target - n_pairs, axis=0)]
        )
    pair_ids = jnp.asarray(pair_ids, jnp.int32)

    fn = jax.jit(
        jax.shard_map(
            functools.partial(
                match_pairs_batch,
                ratio=ratio, max_distance=max_distance,
                cross_check=cross_check, col_tile=col_tile,
            ),
            mesh=mesh,
            in_specs=(P(), P(), P(axis)),
            out_specs=P(axis),
            # The fused Pallas matcher declares plain output shapes, which
            # shard_map's varying-axes check cannot type.
            check_vma=False,
        )
    )
    out = fn(desc_bank, mask_bank, pair_ids)
    return out[:n_pairs]


def ring_all_pairs_matching(
    desc_bank: np.ndarray,
    mask_bank: np.ndarray,
    mesh: Mesh,
    ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
    col_tile: int = 1024,
    max_matches: int = 1024,
):
    """All-pairs matching with the descriptor bank SHARDED over the mesh —
    the ring-attention analogue for SfM (SURVEY.md section 5: "rotate
    descriptor shards around the device ring").

    Each device keeps only I/n_dev images resident; at ring step k it matches
    its resident queries against the bank shard that arrived via ppermute
    (k hops around the ring), then forwards that shard to its neighbour.
    Per-device memory stays O(2 * I/n_dev * N * D) regardless of collection size.

    Matches are COMPACTED ON DEVICE to (max_matches, 2) (i, j) index pairs
    per image pair and streamed to the host one ring step at a time, so
    neither HBM nor host memory ever holds an (I, I, N) map — host memory is
    O(I^2/n_dev * max_matches) per step, and the returned dict is
    O(sum of actual match counts).

    With cross_check=True matches are mutual, so each unordered pair needs
    only one direction and floor(n/2)+1 ring steps; returns
    {(a, b): (m, 2) int32} with a < b.  Without cross-check all n steps run
    and the dict maps ORDERED (query, bank) pairs, a != b.

    desc_bank: (I, N, D) float32, I divisible by mesh size.
    """
    axis = mesh.axis_names[0]
    n = mesh.devices.size
    I, N, D = desc_bank.shape
    assert I % n == 0, "pad the image list to a multiple of the mesh size"
    i_loc = I // n
    steps = (n // 2 + 1) if cross_check else n
    fwd = [(i, (i + 1) % n) for i in range(n)]
    K = min(max_matches, N)

    def compact(m):
        """(N,) match map -> ((K, 2) (i, j) rows -1-padded i-ascending,
        true match count before the K cap)."""
        valid = m >= 0
        iota = jnp.arange(N, dtype=jnp.int32)
        # Valid entries rank highest (and keep ascending-i order among
        # themselves); one top_k replaces a full argsort.
        score = jnp.where(valid, 2 * N - iota, N - iota)
        _, order = jax.lax.top_k(score, K)
        ok = valid[order]
        rows = jnp.stack(
            [jnp.where(ok, order, -1), jnp.where(ok, m[order], -1)], axis=-1
        )
        return rows, jnp.sum(valid, dtype=jnp.int32)

    def one_step(desc, mask, rd, rm):
        """Match resident queries vs the arrived shard; forward the shard."""
        def one_query(qd, qm):
            def one_bank(bd, bm):
                return compact(match_descriptors_pair(
                    qd, bd, qm, bm,
                    ratio=ratio, max_distance=max_distance,
                    cross_check=cross_check, col_tile=col_tile,
                ))

            return jax.vmap(one_bank)(rd, rm)

        out, counts = jax.vmap(one_query)(desc, mask)  # (i_loc, i_loc, K, 2)
        rd = jax.lax.ppermute(rd, axis, fwd)
        rm = jax.lax.ppermute(rm, axis, fwd)
        return rd, rm, out, counts

    fn = jax.jit(
        jax.shard_map(
            one_step, mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(axis), P(axis)),
        )
    )

    desc = jnp.asarray(desc_bank, jnp.bfloat16)  # halves ring traffic; the
    # matmul runs in bf16 anyway (ops/matching.py casts internally).
    mask = jnp.asarray(mask_bank)
    rd, rm = desc, mask
    result: dict[tuple[int, int], np.ndarray] = {}
    truncated_pairs = 0
    dropped_matches = 0
    for k in range(steps):
        rd, rm, out, counts = fn(desc, mask, rd, rm)
        o = np.asarray(out)  # (I, i_loc, K, 2); row q matched shard (d-k)%n
        cnt = np.asarray(counts)
        over = cnt > K
        if over.any():
            # Only count real pairs once (diagonal shards / second visits
            # are deduped below, but the cap warning is a conservative sum).
            truncated_pairs += int(over.sum())
            dropped_matches += int((cnt[over] - K).sum())
        # Vectorised extraction: global ids of every valid (q, b, slot).
        qg, bl, slot = np.nonzero(o[..., 0] >= 0)
        src = (qg // i_loc - k) % n
        bg = src * i_loc + bl
        if cross_check:
            # Each unordered pair once: emit a < b (swap columns when the
            # mutual map arrived as (b -> a)); skip diagonals and the
            # second visit of a pair (n even, k == n/2).
            keep = qg != bg
            qk, bk = qg[keep], bg[keep]
            ij = o[qg[keep], bl[keep], slot[keep]]
            swap = qk > bk
            a = np.where(swap, bk, qk)
            b = np.where(swap, qk, bk)
            ij = np.where(swap[:, None], ij[:, ::-1], ij)
        else:
            keep = qg != bg
            a, b = qg[keep], bg[keep]
            ij = o[qg[keep], bl[keep], slot[keep]]
        if not len(a):
            continue
        pair_key = a.astype(np.int64) * I + b
        # A pair can be produced twice within one step (k = 0 matches a
        # shard against itself; even n meets its antipode both ways at
        # k = n/2).  Mutual matches make the copies identical rows — dedup
        # on (pair, i).
        comp = pair_key * np.int64(N + 1) + ij[:, 0]
        order = np.argsort(comp, kind="stable")
        comp, pair_key, ij = comp[order], pair_key[order], ij[order]
        fresh = np.ones(len(comp), bool)
        fresh[1:] = comp[1:] != comp[:-1]
        pair_key, ij = pair_key[fresh], ij[fresh]
        uniq, starts = np.unique(pair_key, return_index=True)
        for u, s, e in zip(
            uniq, starts, np.append(starts[1:], len(pair_key))
        ):
            key = (int(u // I), int(u % I))
            if key not in result:  # first visit wins (pair met in 2 steps)
                result[key] = ij[s:e]
    if truncated_pairs:
        from monocularsfm_tpu.utils.caps import warn_cap

        warn_cap(
            "ring matcher: %d pair dispatches exceeded max_matches=%d "
            "(%d matches dropped) — raise max_matches for dense pairs",
            truncated_pairs, K, dropped_matches,
        )
    return result


def ring_bank_matching(
    desc_a: jnp.ndarray,
    bank_b: jnp.ndarray,
    mask_a: jnp.ndarray,
    mask_bank_b: jnp.ndarray,
    mesh: Mesh,
    ratio: float = 0.8,
    max_distance: float = 0.7,
):
    """One query image vs a *sharded* descriptor bank (bank > device memory).

    Each device holds a shard of candidate images' descriptors; the query
    descriptors are replicated.  Every device matches the query against its
    local shard; results gather back.  This is the building block the
    ring-pipelined all-pairs schedule composes (rotation of bank shards via
    ppermute happens at the slab-scheduling level).

    bank_b: (I_shard_total, N, D) sharded on axis 0 over the mesh.
    Returns (I_shard_total, N_query) index maps of query->candidate matches.
    """
    axis = mesh.axis_names[0]

    def local(da, bank, ma, mbank):
        def one(b_desc, b_mask):
            return match_descriptors_pair(
                da, b_desc, ma, b_mask,
                ratio=ratio, max_distance=max_distance,
                col_tile=min(1024, bank.shape[1]),
            )

        return jax.vmap(one)(bank, mbank)

    fn = jax.jit(
        jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(), P(axis), P(), P(axis)),
            out_specs=P(axis),
        )
    )
    return fn(desc_a, bank_b, mask_a, mask_bank_b)
