"""Fused Triton-route matcher (interpret mode on CPU, compiled on a GPU) vs
the XLA scan matcher."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from monocularsfm_tpu.ops.matching import match_pairs_batch
from monocularsfm_tpu.ops.pallas_matching import match_pairs_fused
from tests.test_matching import _planted_pair


def _bank(rng, noise=0.05):
    """Three images: a planted pair (0, 1) plus a partly masked third."""
    da, db, ma, mb, _ = _planted_pair(rng, n=300, cap=512, noise=noise)
    dc = rng.normal(size=da.shape).astype(np.float32)
    dc /= np.linalg.norm(dc, axis=1, keepdims=True)
    mc = np.arange(len(dc)) < 200
    bank = jnp.asarray(np.stack([da, db, dc]))
    mask = jnp.asarray(np.stack([ma, mb, mc]))
    pairs = jnp.asarray([[0, 1], [1, 2], [2, 0]], jnp.int32)
    return bank, mask, pairs


@pytest.mark.parametrize("cross", [True, False])
def test_pallas_matches_scan(rng, cross):
    bank, mask, pairs = _bank(rng)
    kw = dict(ratio=0.85, max_distance=0.9, cross_check=cross)
    ref = np.asarray(match_pairs_batch(bank, mask, pairs, kernel="xla",
                                       col_tile=256, **kw))
    out = np.asarray(match_pairs_fused(bank, mask, pairs, interpret=True,
                                       **kw))
    np.testing.assert_array_equal(out, ref)
    assert (ref[0] >= 0).sum() > 250  # the planted pair really matches


def test_pallas_under_shard_map(rng, monkeypatch):
    """Pair-sharded over a mesh through parallel.sharded_match_pairs (as
    features/matching.py dispatches it on a multi-GPU host), the kernel
    gives the single-device maps."""
    import monocularsfm_tpu.parallel.sharded_matching as sm
    from monocularsfm_tpu.parallel import make_mesh

    bank, mask, _ = _bank(rng)
    pairs = np.asarray([[0, 1], [1, 2], [2, 0], [1, 0], [0, 2]], np.int32)
    fused = functools.partial(match_pairs_fused, interpret=True)
    monkeypatch.setattr(sm, "match_pairs_batch",
                        lambda *a, col_tile, **kw: fused(*a, **kw))
    out = sm.sharded_match_pairs(bank, mask, pairs, make_mesh(4))
    assert len(out.sharding.device_set) == 4
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(fused(bank, mask, jnp.asarray(pairs))))


def test_pallas_all_masked():
    cap = 256
    z = jnp.zeros((2, cap, 128), jnp.float32)
    out = np.asarray(match_pairs_fused(
        z, jnp.zeros((2, cap), bool), jnp.asarray([[0, 1]], jnp.int32),
        interpret=True))
    assert out.shape == (1, cap) and np.all(out == -1)


def test_pallas_rejects_bad_shapes():
    bank = jnp.zeros((2, 192, 128), jnp.float32)
    mask = jnp.ones((2, 192), bool)
    pairs = jnp.asarray([[0, 1]], jnp.int32)
    with pytest.raises(ValueError, match="multiple of the tiles"):
        match_pairs_fused(bank, mask, pairs, interpret=True)
    with pytest.raises(ValueError, match="power of two"):
        match_pairs_fused(jnp.zeros((2, 256, 96)), jnp.ones((2, 256), bool),
                          pairs, interpret=True)


def test_match_pairs_batch_kernel_choice_on_cpu(rng):
    """Off the GPU, "auto" runs the scan and "triton" raises: the kernel
    never silently falls back to the Pallas interpreter."""
    bank, mask, pairs = _bank(rng)
    assert jax.default_backend() == "cpu"
    auto = np.asarray(match_pairs_batch(bank, mask, pairs, col_tile=256))
    xla = np.asarray(match_pairs_batch(bank, mask, pairs, kernel="xla",
                                       col_tile=256))
    np.testing.assert_array_equal(auto, xla)
    with pytest.raises(ValueError, match="needs a GPU"):
        match_pairs_batch(bank, mask, pairs, kernel="triton")
    with pytest.raises(ValueError, match="unknown matching kernel"):
        match_pairs_batch(bank, mask, pairs, kernel="pallas")


@pytest.mark.gpu
def test_fused_kernel_compiled_on_gpu(gpu):
    """The compiled kernel at the pipeline's width (capacity 8192) agrees
    with the XLA scan on >= 99.9% of idx_b."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((8192, 128)).astype(np.float32)
    bank = base + 0.35 * rng.standard_normal((4, 8192, 128)).astype(
        np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    with jax.default_device(gpu):
        bank = jnp.asarray(bank, jnp.bfloat16)
        mask = jnp.ones((4, 8192), bool)
        pairs = jnp.asarray([[0, 1], [2, 3]], jnp.int32)
        ref = np.asarray(match_pairs_batch(bank, mask, pairs, kernel="xla"))
        out = np.asarray(match_pairs_batch(bank, mask, pairs,
                                           kernel="triton"))
    assert (out == ref).mean() >= 0.999
