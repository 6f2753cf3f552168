"""Levenberg-Marquardt drivers: the host-stepped `lm.py` and the
one-shot and chunked drivers of `lm_jit.py`."""

from bundleadjustment_jl_tpu_torch.solver.lm import (  # noqa: F401
    LMOptions, LMResult, levenberg_marquardt)
