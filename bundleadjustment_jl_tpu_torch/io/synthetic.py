"""Synthetic BAL-style problem generator (PyTorch port of
`bundleadjustment_jl_tpu/io/synthetic.py`).

The generator is numpy and makes the same ``numpy.random.default_rng``
calls in the same order as the JAX package's, so one seed gives
bit-identical arrays in both packages; only the container differs.
With ``noise_px=0`` and ``perturb=0`` the state is the global optimum.
"""

from __future__ import annotations

import numpy as np
import torch

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem


def _cross_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise 3D cross product (``np.cross`` is slow on large rows)."""
    out = np.empty_like(a)
    out[:, 0] = a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1]
    out[:, 1] = a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2]
    out[:, 2] = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    return out


def _project_np(cams: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Vectorized numpy projection (host-side, float64)."""
    r = cams[:, 0:3]
    t = cams[:, 3:6]
    k1, k2, f = cams[:, 6], cams[:, 7], cams[:, 8]
    theta = np.sqrt(np.einsum("ij,ij->i", r, r))[:, None]
    theta = np.maximum(theta, 1e-30)
    k = r / theta
    c = np.cos(theta)
    s = np.sin(theta)
    kdX = np.sum(k * points, axis=1, keepdims=True)
    p1 = c * points + s * _cross_rows(k, points) + (1 - c) * kdX * k + t
    p2 = -p1[:, 0:2] / p1[:, 2:3]
    n2 = np.sum(p2 * p2, axis=1)
    rho = 1.0 + k1 * n2 + k2 * n2 * n2
    return (f * rho)[:, None] * p2


def synthetic_bal(ncams: int = 16, npnts: int = 256, obs_per_pnt: int = 4,
                  noise_px: float = 0.5, perturb: float = 1e-3,
                  seed: int = 0, dtype=torch.float64, pad_obs_to: int = 128,
                  name: str | None = None,
                  cam_window: int | float | None = None,
                  device="cpu") -> tuple[BAProblem, dict]:
    """Generate a synthetic BA problem -> ``(problem, truth)``; ``truth``
    holds the ground-truth ``cams``/``points`` (numpy) and the objective
    at the truth. Arguments as in the JAX package, plus ``device``."""
    rng = np.random.default_rng(seed)
    obs_per_pnt = min(obs_per_pnt, ncams)

    points = rng.normal(size=(npnts, 3)) * np.array([1.0, 1.0, 0.3])

    depth = 6.0
    cams = np.zeros((ncams, 9))
    cams[:, 0:3] = rng.normal(scale=0.05, size=(ncams, 3))        # rodrigues
    cams[:, 3:5] = rng.normal(scale=0.3, size=(ncams, 2))         # tx, ty
    cams[:, 5] = -depth + rng.normal(scale=0.3, size=ncams)       # tz
    cams[:, 6] = rng.normal(scale=1e-7, size=ncams)               # k1
    cams[:, 7] = rng.normal(scale=1e-13, size=ncams)              # k2
    cams[:, 8] = 400.0 + rng.normal(scale=20.0, size=ncams)       # f

    # Each point seen by `obs_per_pnt` distinct cameras; camera p is forced
    # into point p's set for the first ncams points (coverage).
    pnt_idx = np.repeat(np.arange(npnts), obs_per_pnt)
    k = obs_per_pnt
    if cam_window is not None:
        w = int(round(cam_window * ncams)) if cam_window < 1 \
            else int(cam_window)
        w = min(max(w, k), ncams)
        anchors = ((np.arange(npnts) * ncams) // max(npnts, 1)
                   + rng.integers(0, max(w // 2, 1), size=npnts))
        cam_rows = np.empty((npnts, k), dtype=np.int64)
        step = max(1, (1 << 25) // w)
        for lo in range(0, npnts, step):
            hi = min(lo + step, npnts)
            offs = np.argsort(rng.random((hi - lo, w)), axis=1)[:, :k]
            cam_rows[lo:hi] = (anchors[lo:hi, None] + offs) % ncams
    elif k > ncams // 2 or ncams <= 8:
        cam_rows = np.empty((npnts, k), dtype=np.int64)
        for p in range(npnts):
            cam_rows[p] = rng.choice(ncams, size=k, replace=False)
    else:
        cam_rows = rng.integers(0, ncams, size=(npnts, k))
        while True:
            s = np.sort(cam_rows, axis=1)
            dup = (s[:, 1:] == s[:, :-1]).any(axis=1)
            if not dup.any():
                break
            cam_rows[dup] = rng.integers(0, ncams, size=(int(dup.sum()), k))
    n_forced = min(ncams, npnts)
    cam_rows[:n_forced, 0] = np.arange(n_forced)
    head = cam_rows[:n_forced]
    s = np.sort(head, axis=1)
    dup = (s[:, 1:] == s[:, :-1]).any(axis=1)
    for ri in np.flatnonzero(dup):
        pool = np.delete(np.arange(ncams), cam_rows[ri, 0])
        cam_rows[ri, 1:] = rng.choice(pool, size=k - 1, replace=False)
    cam_idx = cam_rows.reshape(-1)

    cams_obs = np.take(cams, cam_idx, axis=0)
    pnts_obs = np.take(points, pnt_idx, axis=0)
    proj = _project_np(cams_obs, pnts_obs)
    del cams_obs, pnts_obs
    noise = rng.normal(scale=noise_px, size=proj.shape)
    pt2d = proj + noise

    cams0 = cams.copy()
    cams0[:, 0:6] += rng.normal(scale=perturb, size=(ncams, 6))
    cams0[:, 8] *= 1.0 + rng.normal(scale=perturb, size=ncams)
    points0 = points + rng.normal(scale=perturb, size=points.shape)

    if name is None:
        name = f"synthetic-{ncams}-{npnts}"
    problem = BAProblem.from_arrays(cams0, points0, cam_idx, pnt_idx, pt2d,
                                    dtype=dtype, pad_obs_to=pad_obs_to,
                                    name=name, device=device)
    truth = {
        "cams": cams,
        "points": points,
        "objective": 0.5 * float(np.sum(noise ** 2)),
    }
    return problem, truth
