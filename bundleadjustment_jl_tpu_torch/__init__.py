"""PyTorch/CUDA port of the bundle-adjustment engine `bundleadjustment_jl_tpu`.

The JAX package stays the reference; this package mirrors its layout
(`models/`, `io/`, `ops/`, `solver/`, `utils/`) and ports the
Levenberg-Marquardt solver (host-stepped, one-shot and chunked drivers with
checkpoints; PCG, power-series, dense and CGLS steps; each driver also over
the ranks of a device mesh, `parallel/mesh.py`) on the JAX package's
four kernel routes, with W stored in float32, bfloat16 or float16
(`facto_dtype`) and a bfloat16 or float16 working dtype; the precision
cascade, problem suites and campaign runner (`benchmark/`), the native BAL
parser and writer, the CLI (``python -m bundleadjustment_jl_tpu_torch``)
and the tools that time its kernels on a card (`mv_sweep.py`,
`kernel_profile.py`, `tile_sweep.py`, `route_profile.py`, their shared
pieces in `bench.py`); the port's benchmark is `perfbench/run.py` at the
repository root. Its kernels, one for each
TPU kernel of the JAX package, are CUDA C++ for Hopper (`csrc/`), built
with nvcc at first use (`ops/_cuda.py`). Problems are built on the card
unless the caller asks for the CPU; CUDA tensors run through the kernels,
CPU tensors through their plain PyTorch versions. It imports torch and
numpy, never jax.
"""

__version__ = "0.1.0"

from bundleadjustment_jl_tpu_torch.io import load_fixture, read_bal, synthetic_bal  # noqa: F401
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem  # noqa: F401
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (  # noqa: F401
    STATUS_NAMES, LMJitResult, levenberg_marquardt_jit,
    levenberg_marquardt_jit_chunked)
