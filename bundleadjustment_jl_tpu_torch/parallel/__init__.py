"""Execution over ranks: the device mesh (`parallel/mesh.py`: `make_mesh`,
`shard_problem`, `OBS_AXIS`), whose shards every driver solves, the shards
themselves (`parallel/spmd.py`: point-aligned, or camera groups of a
partitioned problem) and the camera partition (`parallel/partition.py`:
`partition_problem` and its diagnostics)."""

from bundleadjustment_jl_tpu_torch.parallel.mesh import (  # noqa: F401
    OBS_AXIS, make_mesh, shard_problem)
from bundleadjustment_jl_tpu_torch.parallel.partition import (  # noqa: F401
    greedy_camera_partition, partition_problem, partition_stats)
from bundleadjustment_jl_tpu_torch.parallel.spmd import (  # noqa: F401
    GroupProblem, MeshShard, SpmdProblem, shard_problem_kminor)
