"""Execution over ranks: the device mesh (`parallel/mesh.py`: `make_mesh`,
`shard_problem`, `OBS_AXIS`), whose point-aligned shards every driver
solves, the shards themselves (`parallel/spmd.py`) and the covisibility
diagnostics of a camera partition. The JAX package's `partition_problem`
is left out (`parallel/partition.py` says why)."""

from bundleadjustment_jl_tpu_torch.parallel.mesh import (  # noqa: F401
    OBS_AXIS, make_mesh, shard_problem)
from bundleadjustment_jl_tpu_torch.parallel.partition import (  # noqa: F401
    greedy_camera_partition, partition_stats)
from bundleadjustment_jl_tpu_torch.parallel.spmd import (  # noqa: F401
    MeshShard, SpmdProblem, shard_problem_kminor)
