"""Mixed-precision solves (PyTorch port of
`bundleadjustment_jl_tpu/benchmark/precision.py`): the precision cascade
and the within-solve low-precision W storage.

1. :func:`precision_cascade`: solve wholly in a cheap low working dtype
   first, then warm-start each higher one from the previous solution. A
   low stage (bfloat16 or float16, not the last) stops on relative
   objective progress (:data:`LOW_STAGE_TOLS`): bfloat16's eps-derived
   defaults are met at once (eps^(1/3) ~ 0.2 makes ``first_order`` fire
   after one iteration). The final stage takes the caller's tolerances.
   On the card a bfloat16 stage runs the kernel route with W stored in
   bfloat16; a float64 stage runs the plain route (`ops/normal.py`).
2. :func:`facto_solve`: one solve in the problem's working dtype with W
   stored in ``facto_dtype`` (`solver/lm_jit.py:maybe_cast_facto`).

Each stage ends with a host read of its objective, the barrier its time
stops at.
"""

from __future__ import annotations

import time
from typing import List, Sequence

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem, torch_dtype
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    STATUS_NAMES, LMJitResult, levenberg_marquardt_jit)

DEFAULT_STAGES = ("bfloat16", "float32")
# A low stage stops on objective progress (0.1 % an iteration), not on the
# eps-derived first-order and step tests; the final stage applies the
# caller's tolerances.
LOW_STAGE_TOLS = dict(atol=0.0, rtol=1e-3, satol=0.0, srtol=0.0,
                      oatol=0.0, ortol=1e-3)
LOW_DTYPES = ("bfloat16", "float16")


def facto_bytes(problem: BAProblem, facto_dtype=None, work_dtype=None) -> int:
    """Bytes of the W blocks, the storage ``facto_dtype`` shrinks (27
    values a row; the diagonal blocks keep the working dtype). One PCG
    matvec reads about twice this."""
    wd = torch_dtype(work_dtype or problem.dtype)
    fd = torch_dtype(facto_dtype) if facto_dtype is not None else wd
    return fd.itemsize * 27 * problem.nobs_pad


def _row(stage: str, res: LMJitResult, elapsed: float) -> dict:
    return {
        "stage": stage,
        "status": STATUS_NAMES[int(res.status)],
        "objective": float(res.objective),
        "iterations": int(res.iterations),
        "neval_residual": res.neval_residual,
        "neval_jac": res.neval_jac,
        "elapsed_s": elapsed,
        "dual_feas": float(res.dual_feas),
    }


def precision_cascade(problem: BAProblem,
                      stages: Sequence[str] = DEFAULT_STAGES,
                      max_iters: int = 100, pcg_max_iters: int = 100,
                      **lm_kwargs) -> List[dict]:
    """Run the warm-started cascade; one stats row per stage (the JAX
    package's keys). A stage in :data:`LOW_DTYPES` that is not the last
    takes :data:`LOW_STAGE_TOLS` over ``lm_kwargs``; the last takes
    ``lm_kwargs`` as they are, and its row holds the final ``cams`` and
    ``points``."""
    cams, points = problem.cams, problem.points
    rows: List[dict] = []
    for i, stage in enumerate(stages):
        dtype = torch_dtype(stage)
        kwargs = dict(lm_kwargs)
        if i < len(stages) - 1 and stage in LOW_DTYPES:
            kwargs.update(LOW_STAGE_TOLS)
        t0 = time.perf_counter()
        res = levenberg_marquardt_jit(
            problem.astype(dtype), cams=cams.to(dtype),
            points=points.to(dtype), max_iters=max_iters,
            pcg_max_iters=pcg_max_iters, **kwargs)
        row = _row(stage, res, time.perf_counter() - t0)
        row["facto_bytes"] = facto_bytes(problem, work_dtype=dtype)
        rows.append(row)
        cams, points = res.cams, res.points
    rows[-1]["cams"] = cams
    rows[-1]["points"] = points
    return rows


def facto_solve(problem: BAProblem, facto_dtype="bfloat16",
                max_iters: int = 100, pcg_max_iters: int = 100,
                **lm_kwargs) -> dict:
    """One solve in the problem's working dtype with W stored in
    ``facto_dtype``; a stats row with the W bytes and those of a W in the
    working dtype."""
    fd = torch_dtype(facto_dtype)
    t0 = time.perf_counter()
    res = levenberg_marquardt_jit(
        problem, max_iters=max_iters, pcg_max_iters=pcg_max_iters,
        facto_dtype=fd, **lm_kwargs)
    row = _row(f"{str(problem.dtype)[6:]}+{str(fd)[6:]}facto", res,
               time.perf_counter() - t0)
    row["facto_bytes"] = facto_bytes(problem, facto_dtype=fd)
    row["facto_bytes_full"] = facto_bytes(problem)
    return row
