"""Multi-chip scale-out: mesh construction, sharded matching, distributed BA.

The reference is single-process with zero parallelism (SURVEY.md section 5);
this layer is a new design axis: JAX collectives inside shard_map across a
jax.sharding.Mesh (NVLink between the GPUs of one host); jax.distributed
for multi-host.
"""

from monocularsfm_tpu.parallel.mesh import init_multi_host, make_mesh
from monocularsfm_tpu.parallel.distributed_ba import distributed_bundle_adjust
from monocularsfm_tpu.parallel.sharded_matching import (
    ring_all_pairs_matching,
    sharded_match_pairs,
)

__all__ = [
    "make_mesh",
    "init_multi_host",
    "distributed_bundle_adjust",
    "sharded_match_pairs",
    "ring_all_pairs_matching",
]
