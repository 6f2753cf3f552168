"""Covisibility diagnostics of a camera partition (PyTorch port of
`greedy_camera_partition` and `partition_stats` in
`bundleadjustment_jl_tpu/parallel/partition.py`; host-side numpy).

A greedy balanced partition (LPT bin packing on per-camera observation
counts) assigns each camera to one of ``n_parts`` parts, and
:func:`partition_stats` reports the parts' balance and how many extra
parts each point is seen from.

The JAX package's `partition_problem` is left out. It reorders the rows
into camera groups, each group one equal chunk of the GSPMD mesh, and
records the new order in the problem's ``pnt_perm``. The port's problem
has no ``pnt_perm``: its rows are always point-sorted, which its kernels
need (each point's rows contiguous), and its mesh shards are point-aligned
ranges of those rows (`parallel/mesh.py`, `parallel/spmd.py`), so a
camera-grouped order has no shard to serve.
"""

from __future__ import annotations

import numpy as np

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem


def greedy_camera_partition(cam_idx: np.ndarray, ncams: int,
                            n_parts: int) -> np.ndarray:
    """Assign cameras to parts, balancing total observation counts:
    cameras by observation count, descending, each placed on the currently
    lightest part. Returns ``part_of_cam`` (ncams,) int32."""
    counts = np.bincount(cam_idx, minlength=ncams)
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(n_parts, dtype=np.int64)
    part_of_cam = np.zeros(ncams, dtype=np.int32)
    for c in order:
        p = int(np.argmin(load))
        part_of_cam[c] = p
        load[p] += counts[c]
    return part_of_cam


def partition_stats(problem: BAProblem, part_of_cam: np.ndarray,
                    n_parts: int) -> dict:
    """Balance and locality of a partition: the parts' row counts, their
    imbalance (largest over mean) and the mean number of extra parts each
    point is seen from (0: every point local to one part)."""
    n = problem.nobs
    cam_idx = problem.cam_idx[:n].cpu().numpy()
    pnt_idx = problem.pnt_idx[:n].cpu().numpy()
    part_of_obs = part_of_cam[cam_idx]
    sizes = np.bincount(part_of_obs, minlength=n_parts)
    pnt_parts = {}
    cut = 0
    seen = set()
    for p, q in zip(pnt_idx.tolist(), part_of_obs.tolist()):
        prev = pnt_parts.setdefault(p, q)
        if prev != q and (p, q) not in seen:
            cut += 1
            seen.add((p, q))
    return {
        "sizes": sizes.tolist(),
        "imbalance": float(sizes.max() / max(sizes.mean(), 1.0)),
        "avg_extra_parts_per_point": cut / max(len(pnt_parts), 1),
    }
