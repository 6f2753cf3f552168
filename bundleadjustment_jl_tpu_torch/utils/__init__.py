"""Checkpoints (the JAX package's format) and profiling."""

from bundleadjustment_jl_tpu_torch.utils.checkpoint import (  # noqa: F401
    CheckpointManager, latest_checkpoint, load_checkpoint, save_checkpoint)
from bundleadjustment_jl_tpu_torch.utils.profiling import (  # noqa: F401
    COUNTERS, host_read, reset_counters, span, trace)
