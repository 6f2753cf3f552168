"""Levenberg-Marquardt drivers: the host-stepped `lm.py` and the one-shot
and chunked drivers of `lm_jit.py`, each of which also solves a mesh
shard over ranks (`parallel/mesh.py`), and the spmd forms in
`lm_spmd.py`."""

from bundleadjustment_jl_tpu_torch.solver.lm import (  # noqa: F401
    LMOptions, LMResult, levenberg_marquardt)
from bundleadjustment_jl_tpu_torch.solver.lm_spmd import (  # noqa: F401
    levenberg_marquardt_spmd, levenberg_marquardt_spmd_chunked)
