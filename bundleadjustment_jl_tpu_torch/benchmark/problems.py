"""Benchmark problem suites (PyTorch port of
`bundleadjustment_jl_tpu/benchmark/problems.py`): the BAL problems read
from a local directory, and synthetic stand-ins at the exact (ncams,
npnts, nobs) of each BAL problem, which need no data. Nothing is
downloaded.
"""

from __future__ import annotations

import math
import os
from typing import Iterator, Tuple

import numpy as np
import torch

from bundleadjustment_jl_tpu_torch.io.bal import read_bal
from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem

# (family, ncams, npnts, nobs) of the reference's benchmark set (names
# after BAL's "problem-<ncams>-<npnts>-pre"), ordered by nobs.
BAL_SIZES = [
    ("LadyBug", 49, 7776, 31843),
    ("LadyBug", 73, 11032, 46122),
    ("LadyBug", 138, 19878, 85217),
    ("LadyBug", 318, 41628, 179919),
    ("Trafalgar", 257, 65132, 225911),
    ("LadyBug", 460, 56811, 241877),
    ("LadyBug", 646, 73584, 327297),
    ("LadyBug", 810, 88814, 393775),
    ("LadyBug", 1031, 110968, 500265),
    ("Dubrovnik", 202, 132796, 751652),
    ("Dubrovnik", 356, 226730, 1255268),
    ("Venice", 427, 310384, 1699145),
    ("Venice", 1350, 894716, 4517126),
    ("Venice", 1778, 993923, 5001946),
    ("Final", 13682, 4456117, 28987644),
]


def _bucket(n: int, grid=(1.0, 1.25, 1.5, 1.75)) -> int:
    """Round up to the next value of the grid {2^k g} (at most 25%
    waste)."""
    if n <= 1:
        return 1
    k = int(math.floor(math.log2(n)))
    for kk in (k, k + 1):
        for g in grid:
            v = int(round(2 ** kk * g))
            if v >= n:
                return v
    return 2 ** (k + 2)


def pad_problem(problem: BAProblem, ncams_to: int | None = None,
                npnts_to: int | None = None,
                nobs_pad_to: int | None = None) -> BAProblem:
    """The problem padded in all three dimensions with zero weight, as the
    JAX package pads it to share compiled programs. Padded cameras and
    points copy row 0 but have no observations, so their gradients and
    blocks are zero and their steps too: the solution is unchanged, and of
    the stopping tests only ``small_step``'s ``||x||`` sees the padding."""
    ncams_to = max(ncams_to or 0, problem.ncams)
    npnts_to = max(npnts_to or 0, problem.npnts)
    nobs_pad_to = max(nobs_pad_to or 0, problem.nobs_pad)
    if (ncams_to, npnts_to, nobs_pad_to) == (
            problem.ncams, problem.npnts, problem.nobs_pad):
        return problem
    n = problem.nobs
    cams = problem.cams.double().cpu().numpy()
    points = problem.points.double().cpu().numpy()
    cams_p = np.concatenate(
        [cams, np.tile(cams[:1], (ncams_to - cams.shape[0], 1))])
    points_p = np.concatenate(
        [points, np.tile(points[:1], (npnts_to - points.shape[0], 1))])
    return BAProblem.from_arrays(
        cams_p, points_p, problem.cam_idx[:n].cpu().numpy(),
        problem.pnt_idx[:n].cpu().numpy(),
        problem.pt2d[:n].double().cpu().numpy(), dtype=problem.dtype,
        pad_obs_to=nobs_pad_to, name=problem.name,
        device=problem.cams.device)


def pad_to_buckets(problem: BAProblem) -> BAProblem:
    """Pad all three dimensions to the shared-shape grid (:func:`_bucket`)."""
    return pad_problem(problem, _bucket(problem.ncams),
                       _bucket(problem.npnts),
                       _bucket(max(problem.nobs_pad, 1024)))


def synthetic_suite(max_nobs: int | None = None, dtype=torch.float64,
                    noise_px: float = 1.0, perturb: float = 2e-2,
                    pad_obs_to: int = 512, device="cuda",
                    ) -> Iterator[Tuple[str, BAProblem]]:
    """Synthetic problems at the BAL sizes of at most ``max_nobs``
    observations, the JAX suite's (same seeds, same arrays)."""
    for family, ncams, npnts, nobs in BAL_SIZES:
        if max_nobs is not None and nobs > max_nobs:
            continue
        obs_per_pnt = max(2, round(nobs / npnts))
        name = f"{family}-{ncams}-{npnts}-synth"
        problem, _ = synthetic_bal(
            ncams=ncams, npnts=npnts, obs_per_pnt=obs_per_pnt,
            noise_px=noise_px, perturb=perturb, dtype=dtype,
            pad_obs_to=pad_obs_to, seed=ncams, name=name, device=device)
        yield name, problem


def bal_suite(data_dir: str, dtype=torch.float64, pad_obs_to: int = 512,
              device="cuda") -> Iterator[Tuple[str, BAProblem]]:
    """Every BAL file (``problem*.txt`` / ``.txt.bz2``) under the local
    directory ``data_dir``, by family subdirectory as the reference lays
    them out; named ``<subdirectory>/<file>``."""
    for root, _, files in sorted(os.walk(data_dir)):
        for f in sorted(files):
            if f.endswith((".txt", ".txt.bz2")) and "problem" in f:
                path = os.path.join(root, f)
                yield os.path.basename(root) + "/" + f, read_bal(
                    path, dtype=dtype, pad_obs_to=pad_obs_to, device=device)
