"""Multi-process execution: point-aligned row shards for the spmd solve
(`solver/lm_spmd.py`) and the covisibility diagnostics of a camera
partition. The JAX package's GSPMD mesh (`parallel/mesh.py`: `make_mesh`,
`shard_problem`, `OBS_AXIS`) is not ported."""

from bundleadjustment_jl_tpu_torch.parallel.partition import (  # noqa: F401
    greedy_camera_partition, partition_stats)
from bundleadjustment_jl_tpu_torch.parallel.spmd import (  # noqa: F401
    SpmdProblem, shard_problem_kminor)
