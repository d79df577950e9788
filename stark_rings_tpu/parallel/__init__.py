"""Multi-chip distribution layer.

The reference is a single-process library (its only parallelism is a rayon
feature, SURVEY.md §2.5); this package is the multi-device scale-out story:
`jax.sharding.Mesh` + `shard_map`, with the NTT stage exchange as a single
`all_to_all` (four-step/Bailey decomposition) and reductions as `psum`
collectives (NCCL between GPUs)."""

from .linalg import ShardedMatVec, ShardedSparseMatVec
from .mesh import make_mesh
from .mle import ShardedMLE
from .model import ShardedModelMul
from .ntt import ShardedNTT

__all__ = ["make_mesh", "ShardedNTT", "ShardedMLE", "ShardedMatVec",
           "ShardedSparseMatVec", "ShardedModelMul"]
