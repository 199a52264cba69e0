"""Visual-vocabulary retrieval: k-means training + TF-IDF scoring by matmul.

Reference parity: `VocaburaryTreeFeatureMatcher` is declared but never
implemented in the reference (include/Feature/FeatureMatching.h:137-141;
config comment "2 for vacabulary tree match(not support now)") — this module
supplies the missing capability.

Device design: the hierarchical *tree* in classic vocab-tree matching
(Nister & Stewenius 2006) exists to make nearest-word search logarithmic on a
CPU.  On an accelerator, exact nearest-centroid assignment over a flat vocabulary of
K words is a single (N, 128) x (128, K) matmul followed by an argmax — both
faster and more accurate than approximate tree descent (no quantization error
from greedy path choices).  So:

* training: mini-batch Lloyd k-means, all-pairs distances via one matmul per
  iteration (descriptors are unit-L2 RootSIFT, so argmax similarity =
  argmin L2 distance);
* image signatures: TF-IDF-weighted bag-of-words vectors, L2-normalised —
  built with one segment_sum per image;
* retrieval: pairwise image similarity = (I, K) x (K, I) matmul; top-k
  partners per image feed the standard match-and-verify pipeline.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("num_words", "iterations"))
def _kmeans_fit(desc: jnp.ndarray, init_idx: jnp.ndarray,
                num_words: int, iterations: int = 10) -> jnp.ndarray:
    """Lloyd k-means on unit-L2 descriptors. desc: (N, D) -> (K, D) centroids.

    Empty clusters keep their previous centroid (standard fallback)."""

    centroids = desc[init_idx]  # (K, D)

    def step(c, _):
        sims = jnp.dot(desc, c.T, preferred_element_type=jnp.float32)  # (N, K)
        assign = jnp.argmax(sims, axis=1)
        sums = jax.ops.segment_sum(desc, assign, num_segments=num_words)
        counts = jax.ops.segment_sum(
            jnp.ones((desc.shape[0],), jnp.float32), assign,
            num_segments=num_words,
        )
        new = sums / jnp.maximum(counts[:, None], 1.0)
        new = jnp.where(counts[:, None] > 0, new, c)
        # Re-normalise: words live on the unit sphere like the descriptors.
        new = new / jnp.maximum(
            jnp.linalg.norm(new, axis=1, keepdims=True), 1e-12
        )
        return new, None

    centroids, _ = jax.lax.scan(step, centroids, None, length=iterations)
    return centroids


def train_visual_vocab(descriptors: np.ndarray, num_words: int = 4096,
                       iterations: int = 10, max_train: int = 262144,
                       seed: int = 0) -> np.ndarray:
    """Train a K-word visual vocabulary from (N, 128) unit-L2 descriptors."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, np.float32)
    if len(desc) > max_train:
        desc = desc[rng.choice(len(desc), max_train, replace=False)]
    if len(desc) < num_words:
        raise ValueError(
            f"need >= {num_words} training descriptors, got {len(desc)}"
        )
    init = rng.choice(len(desc), num_words, replace=False).astype(np.int32)
    return np.asarray(
        _kmeans_fit(jnp.asarray(desc), jnp.asarray(init), num_words,
                    iterations)
    )


@functools.partial(jax.jit, static_argnames=("num_words",))
def quantize(desc: jnp.ndarray, mask: jnp.ndarray,
             vocab: jnp.ndarray, num_words: int) -> jnp.ndarray:
    """Hard-assign descriptors to words -> word-count histogram (num_words,)."""
    sims = jnp.dot(desc, vocab.T, preferred_element_type=jnp.float32)
    assign = jnp.argmax(sims, axis=1)
    return jax.ops.segment_sum(
        mask.astype(jnp.float32), assign, num_segments=num_words
    )


@functools.partial(jax.jit, static_argnames=("num_words",))
def quantize_batch(bank: jnp.ndarray, mask: jnp.ndarray,
                   vocab: jnp.ndarray, num_words: int) -> jnp.ndarray:
    """Word histograms for a whole image bank (I, N, D) in ONE dispatch
    (the per-image Python loop of quantize calls walled at 1000+ images)."""
    return jax.vmap(
        lambda d, m: quantize(d, m, vocab, num_words)
    )(bank, mask)


@jax.jit
def tfidf_signatures(histograms: jnp.ndarray) -> jnp.ndarray:
    """TF-IDF weight + L2-normalise per-image word histograms (I, K)."""
    num_images = histograms.shape[0]
    df = jnp.sum(histograms > 0, axis=0)  # document frequency per word
    # Smoothed idf (+1 floor): with a small vocabulary every word can appear
    # in every image, and raw log(N/df) would zero out ALL signatures.
    idf = jnp.log((1.0 + num_images) / (1.0 + df)) + 1.0
    sig = histograms * idf[None, :]
    return sig / jnp.maximum(
        jnp.linalg.norm(sig, axis=1, keepdims=True), 1e-12
    )


@functools.partial(jax.jit, static_argnames=("num_neighbors",))
def retrieve_top_k(signatures: jnp.ndarray, num_neighbors: int):
    """Top-k most similar images per image (self excluded).

    Returns (scores (I, k), indices (I, k))."""
    sims = jnp.dot(
        signatures, signatures.T, preferred_element_type=jnp.float32
    )
    sims = sims - 2.0 * jnp.eye(sims.shape[0], dtype=sims.dtype)  # exclude self
    return jax.lax.top_k(sims, num_neighbors)
