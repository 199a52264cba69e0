"""monocularsfm_tpu — an incremental Structure-from-Motion engine for an
accelerator (JAX/XLA, with a Pallas kernel for NVIDIA GPUs).

A from-scratch JAX/XLA re-design of the capabilities of
nebula-beta/MonocularSfM (COLMAP-style incremental SfM):

    extract SIFT -> match -> geometric verification -> incremental
    reconstruction (init / PnP-register / triangulate / bundle-adjust)
    -> export point cloud + poses.

Design stance (see SURVEY.md section 7): the host orchestrates the inherently
sequential incremental loop; the device executes all O(N*D), O(pairs),
O(points), O(residuals) math as batched, fixed-shape, masked computations.
State is struct-of-arrays with capacity padding, because XLA wants static
shapes while the incremental loop constantly grows and shrinks sets.
"""

__version__ = "0.1.0"

import pathlib as _pathlib

import jax as _jax

# A float32 matrix product on a GPU may run in TF32 (about three decimal
# digits) unless a precision is asked for.  Geometry code is full of small
# contractions for which that rounding is catastrophic (pose polish,
# eigh/svd/solve internals), and explicit Precision.HIGHEST annotations
# cannot reach the matmuls inside jnp.linalg decompositions.  So the whole
# package defaults to full float32 products; the deliberate bf16 fast paths
# (the descriptor matmuls of ops/matching and ops/pallas_matching) cast
# their operands to bf16 explicitly, which this default does not upcast.
_jax.config.update("jax_default_matmul_precision", "float32")


def compile_cache_dir() -> str:
    """Directory of JAX's persistent compilation cache, set up if needed.

    `JAX_COMPILATION_CACHE_DIR`, when set, wins: JAX reads it itself and
    nothing is set here (likewise a directory set in code before this
    call).  Otherwise the cache lives at `<checkout>/.jax_cache`, a fixed
    path, so every process of this checkout finds what earlier ones
    compiled."""
    if _jax.config.jax_compilation_cache_dir is None:
        _jax.config.update(
            "jax_compilation_cache_dir",
            str(_pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"),
        )
    return _jax.config.jax_compilation_cache_dir


compile_cache_dir()

from monocularsfm_tpu import types  # noqa: F401
