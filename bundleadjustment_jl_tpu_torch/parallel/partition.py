"""Covisibility-aware partition of the observation rows (PyTorch port of
`bundleadjustment_jl_tpu/parallel/partition.py`; host-side numpy, once at
load time).

A greedy balanced partition (LPT bin packing on per-camera observation
counts) assigns each camera to one of ``n_parts`` parts
(:func:`greedy_camera_partition`). :func:`partition_problem` reorders the
rows into those camera groups, each padded to one equal chunk, so that
``shard_problem`` over ``n_parts`` ranks (`parallel/mesh.py`) gives every
rank exactly one camera group: each camera's rows on one rank, a point's
rows over the ranks that see it. The rows are then not point-sorted; the
problem's ``pnt_perm`` lists them in point order, and it solves on the
plain route (`ops/normal.py:solve_stages`), as the JAX package's solves
it on XLA. :func:`partition_stats` reports the parts' balance and how many
extra parts each point is seen from.
"""

from __future__ import annotations

import numpy as np

from bundleadjustment_jl_tpu_torch.models.problem import (
    BAProblem, host_array as _host, make_starts)


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


def row_order(cam_idx: np.ndarray, pnt_idx: np.ndarray, ncams: int,
              npnts: int):
    """``(pnt_perm, pnt_starts, cam_perm, cam_starts)`` of rows in any
    order (int32): each permutation the stable argsort of the ids, each
    starts array the segments of its order (padding rows of id 0 sort into
    segment 0)."""
    total = cam_idx.shape[0]
    pnt_perm = np.argsort(pnt_idx, kind="stable").astype(np.int32)
    cam_perm = np.argsort(cam_idx, kind="stable").astype(np.int32)
    return (pnt_perm, make_starts(np.take(pnt_idx, pnt_perm), npnts, total),
            cam_perm, make_starts(np.take(cam_idx, cam_perm), ncams, total))


def partition_problem(problem: BAProblem, n_parts: int,
                      ) -> tuple[BAProblem, np.ndarray]:
    """Reorder and re-pad ``problem`` (the constructors' layout: its
    ``nobs`` true rows first) so that equal row chunks align with camera
    groups, as the JAX ``partition_problem`` does. Returns
    ``(partitioned, part_of_cam)``.

    The new problem has ``nobs_pad = n_parts * chunk``, ``chunk`` the
    largest part's row count rounded up to a multiple of 8. Part ``p``'s
    rows fill chunk ``p`` in their old order, then zero-weight padding
    rows (camera 0, point 0, ``pt2d`` 0). ``pnt_perm`` lists the rows in
    point order, ``pnt_starts`` delimits its segments, ``cam_perm`` and
    ``cam_starts`` the camera order's. The state is copied; the problem
    lives on ``problem``'s device, in its dtype, named
    ``<name>-part<n_parts>``."""
    n = problem.nobs
    cam_idx = problem.cam_idx[:n].cpu().numpy()
    pnt_idx = problem.pnt_idx[:n].cpu().numpy()
    pt2d = _host(problem.pt2d[:n])
    w = _host(problem.w[:n])

    part_of_cam = greedy_camera_partition(cam_idx, problem.ncams, n_parts)
    part_of_obs = part_of_cam[cam_idx]
    order = np.argsort(part_of_obs, kind="stable")
    sizes = np.bincount(part_of_obs, minlength=n_parts)
    chunk = int(-(-sizes.max() // 8) * 8)

    total = n_parts * chunk
    ci = np.zeros(total, dtype=np.int32)
    pi = np.zeros(total, dtype=np.int32)
    xy = np.zeros((total, 2), dtype=pt2d.dtype)
    ww = np.zeros(total, dtype=w.dtype)
    start = 0
    for p in range(n_parts):
        rows = order[start:start + sizes[p]]
        dst = p * chunk
        ci[dst:dst + sizes[p]] = np.take(cam_idx, rows)
        pi[dst:dst + sizes[p]] = np.take(pnt_idx, rows)
        xy[dst:dst + sizes[p]] = np.take(pt2d, rows, axis=0)
        ww[dst:dst + sizes[p]] = np.take(w, rows)
        start += sizes[p]

    pnt_perm, pnt_starts, cam_perm, cam_starts = row_order(
        ci, pi, problem.ncams, problem.npnts)
    out = BAProblem.from_numpy(
        dict(cams=_host(problem.cams), points=_host(problem.points),
             cam_idx=ci, pnt_idx=pi, pt2d=xy, w=ww, pnt_starts=pnt_starts,
             cam_perm=cam_perm, cam_starts=cam_starts, pnt_perm=pnt_perm,
             nobs=n, name=f"{problem.name}-part{n_parts}"),
        device=problem.cams.device, dtype=problem.dtype)
    return out, part_of_cam


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
