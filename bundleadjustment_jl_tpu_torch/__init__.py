"""PyTorch/CUDA port of the bundle-adjustment engine `bundleadjustment_jl_tpu`.

The JAX package stays the reference; this package mirrors its layout
(`models/`, `io/`, `ops/`, `solver/`) and ports the f32 Schur-PCG
Levenberg-Marquardt main path. Its four hot kernels are CUDA C++ for
Hopper (`csrc/`), built with nvcc at first use (`ops/_cuda.py`). CUDA
float32 tensors run through them; CPU tensors run through their plain
PyTorch versions. It imports torch and numpy, never jax.
"""

from bundleadjustment_jl_tpu_torch.io import load_fixture, read_bal, synthetic_bal  # noqa: F401
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem  # noqa: F401
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (  # noqa: F401
    STATUS_NAMES, LMJitResult, levenberg_marquardt_jit)
