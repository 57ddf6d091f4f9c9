"""Multi-chip / multi-host execution.

NEW relative to the reference (which is single-process single-GPU; SURVEY.md
section 2.3): channels and time-blocks shard over a 2D
jax.sharding.Mesh('channel', 'time'). Overlap-save needs only the previous
taps-1 *input* samples per time shard, so time parallelism is exact — each
shard fetches its halo from its left neighbor with one jax.lax.ppermute of
halo_in input-rate samples per step (NVLink between the cards of one
host).
"""

from totton_tpu.parallel.mesh import make_mesh
from totton_tpu.parallel.sharded import (
    ShardedUpsampler,
    make_sharded_step,
    sharded_upsample,
)
from totton_tpu.parallel.distributed import initialize_distributed

__all__ = [
    "make_mesh",
    "ShardedUpsampler",
    "make_sharded_step",
    "sharded_upsample",
    "initialize_distributed",
]
