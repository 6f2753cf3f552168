"""Point-aligned row shards for the multi-process solve (PyTorch port of
`bundleadjustment_jl_tpu/parallel/spmd.py`).

The points are split into contiguous ranges, one a rank, chosen so that
each range owns a near-equal number of rows (the JAX package's greedy rule,
so the bounds are the same). The rows are point-sorted, so each rank's rows
are one contiguous block and every point's rows live on one rank: the
point-direction sums (Hpp, g_p, the back-substitution) are exactly
rank-local. The cameras are replicated; the camera-direction sums are
per-rank partials that `ops/spmdctx.py` all-reduces.

Each shard is a local :class:`BAProblem` built by
``BAProblem.from_arrays`` with global camera ids and local point ids
(:meth:`SpmdProblem.local`); a rank solves it as a :class:`MeshShard`
(:meth:`SpmdProblem.rank_shard`), which carries the process group, the
rank and the :class:`SpmdProblem` (the global sizes and point bounds), and
which every driver takes as it takes a problem. Unlike the JAX package, no
shard is padded to a common row count (a multiple of 128 there: a Pallas
lane rule; the port's kernels take any padding): each shard holds its own
rows, and the global problem's padding rows stay at the end of the last
shard, so a one-shard problem is the problem itself. The points are padded
to a common count only where the ranks gather them
(:meth:`SpmdProblem.global_points`).

A partitioned problem (`parallel/partition.py:partition_problem`, rows in
camera groups with ``pnt_perm``) is split the JAX package's way instead:
:class:`GroupProblem` gives rank ``r`` the equal row chunk ``r``, its
camera group when the ranks are as many as the parts. Every rank holds
every camera and point, and the ids stay global; each camera's rows sit on
one rank, but a point's rows span the ranks that see it, so the point sums
are per-rank partials as well. Its shards carry ``layout = "cameras"``,
on which `ops/spmdctx.py` all-reduces the point sums too.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from bundleadjustment_jl_tpu_torch.models.problem import (
    HALF_DTYPES, BAProblem, host_array as _host)
from bundleadjustment_jl_tpu_torch.parallel.partition import row_order


class _Shards:
    """What both kinds of split share: each rank's shard as a problem on
    its device, built once (``shards``), and as the :class:`MeshShard` a
    rank solves. A subclass has ``ndev``, ``device_type``, ``shards``,
    :attr:`LAYOUT` and ``_build(rank, device)``."""
    LAYOUT = "points"

    def device(self, rank: int) -> torch.device:
        """The device of shard ``rank``: ``cuda:LOCAL_RANK`` (the current
        device without the variable) when the global problem lived on a
        card, else the CPU."""
        if self.device_type != "cuda":
            return torch.device("cpu")
        local = os.environ.get("LOCAL_RANK")
        return torch.device("cuda", int(local) if local is not None
                            else torch.cuda.current_device())

    def local(self, rank: int, device=None) -> BAProblem:
        """Shard ``rank`` as a problem of its own on ``device`` (default
        :meth:`device`); built once a rank and device (``shards``)."""
        dev = torch.device(self.device(rank) if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (rank, str(dev))
        if key not in self.shards:
            self.shards[key] = self._build(rank, dev)
        return self.shards[key]

    def rank_shard(self, group: Optional[dist.ProcessGroup] = None,
                   device=None) -> "MeshShard":
        """This rank's shard of a solve over ``group`` (default: the world
        group), on ``device`` (default :meth:`device`): the :meth:`local`
        problem with the group, its rank, this split and its layout.
        Raises unless ``group`` is initialized, has ``ndev`` ranks and its
        backend serves the device (NCCL for a card, gloo for the CPU)."""
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("a solve over ranks needs a torch.distributed "
                               "process group (init_process_group)")
        group = dist.group.WORLD if group is None else group
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        if world != self.ndev:
            raise ValueError(f"{type(self).__name__} has {self.ndev} shards "
                             f"but the group has {world} ranks: split the "
                             f"problem into {world}")
        lp = self.local(rank, device)
        backend = str(dist.get_backend(group))
        need = "nccl" if lp.cams.is_cuda else "gloo"
        if need not in backend:
            raise ValueError(f"a shard on {lp.cams.device} needs a {need} "
                             f"group, this one is {backend}")
        return MeshShard(**{f.name: getattr(lp, f.name)
                            for f in dataclasses.fields(BAProblem)},
                         spmd=self, group=group, rank=rank,
                         layout=self.LAYOUT)


@dataclasses.dataclass
class SpmdProblem(_Shards):
    """A problem split into ``ndev`` point-aligned shards, kept as the
    global problem's host arrays and the shards' bounds."""
    cams: np.ndarray            # (ncams, 9) replicated
    points: np.ndarray          # (npnts, 3) global
    cam_idx: np.ndarray         # (nobs_pad,) global camera ids
    pnt_idx: np.ndarray         # (nobs_pad,) global point ids
    pt2d: np.ndarray            # (nobs_pad, 2)
    point_offsets: np.ndarray   # (D,) global id of each shard's first point
    npnts_loc: np.ndarray       # (D,) points of each shard
    nobs_loc: np.ndarray        # (D,) true rows of each shard
    row_offsets: np.ndarray     # (D,) first row of each shard
    nobs: int                   # global true rows
    nobs_pad: int               # global padded rows
    dtype: torch.dtype
    device_type: str            # where the global problem lived
    name: str = "ba"
    # The shards built by :meth:`local`, by (rank, device): a solve reuses
    # its shard and the shard's launch plans (`BAProblem.plans`).
    shards: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def ndev(self) -> int:
        return len(self.npnts_loc)

    @property
    def ncams(self) -> int:
        return self.cams.shape[0]

    @property
    def npnts(self) -> int:
        return self.points.shape[0]

    def rows(self, rank: int) -> int:
        """Shard ``rank``'s row count: its true rows, plus the global
        padding rows on the last shard."""
        extra = self.nobs_pad - self.nobs if rank == self.ndev - 1 else 0
        return int(self.nobs_loc[rank]) + extra

    def _build(self, rank: int, device: torch.device) -> BAProblem:
        p0 = int(self.point_offsets[rank])
        p1 = p0 + int(self.npnts_loc[rank])
        r0 = int(self.row_offsets[rank])
        r1 = r0 + int(self.nobs_loc[rank])
        return BAProblem.from_arrays(
            self.cams, self.points[p0:p1], self.cam_idx[r0:r1],
            self.pnt_idx[r0:r1] - p0, self.pt2d[r0:r1], dtype=self.dtype,
            pad_obs_to=max(self.rows(rank), 1),
            name=f"{self.name}/shard{rank}", device=device)

    def split_points(self, points_global: torch.Tensor,
                     rank: int) -> torch.Tensor:
        """The rows of ``points_global`` (npnts, 3) that shard ``rank``
        owns: the inverse of :meth:`global_points`."""
        p0 = int(self.point_offsets[rank])
        return points_global.reshape(self.npnts, 3)[
            p0:p0 + int(self.npnts_loc[rank])]

    def join_points(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global (npnts, 3) points from every shard's points (each
        (npnts_loc[d], 3) or longer; the rows past it are dropped)."""
        return torch.cat([p[:int(n)] for p, n in zip(parts, self.npnts_loc)])

    def global_points(self, points_local: torch.Tensor,
                      group: Optional[dist.ProcessGroup] = None
                      ) -> torch.Tensor:
        """The global (npnts, 3) points from each rank's local points: an
        all-gather over ``group`` of the points padded to the largest
        shard's count (in float32 for a 2-byte dtype, exact), then
        unpadded. Every rank of the group must call it. One shard needs no
        group."""
        if self.ndev == 1:
            return points_local
        if group is None:
            raise ValueError(f"{self.ndev} shards: gathering the points "
                             "needs their process group")
        dt = points_local.dtype
        pad = torch.zeros((int(self.npnts_loc.max()), 3),
                          dtype=torch.float32 if dt in HALF_DTYPES else dt,
                          device=points_local.device)
        pad[:points_local.shape[0]] = points_local
        parts = [torch.empty_like(pad) for _ in range(self.ndev)]
        dist.all_gather(parts, pad, group=group)
        return self.join_points(parts).to(dt)


@dataclasses.dataclass
class GroupProblem(_Shards):
    """A problem split into ``ndev`` equal row chunks, the JAX package's
    mesh layout of a partitioned problem (`parallel/partition.py`): shard
    ``r`` holds rows ``[r * chunk, (r + 1) * chunk)`` with their global
    ids, ``pnt_perm`` and the other orders of its own rows, and every
    camera and point."""
    LAYOUT = "cameras"
    cams: np.ndarray            # (ncams, 9) replicated
    points: np.ndarray          # (npnts, 3) replicated
    cam_idx: np.ndarray         # (nobs_pad,) global camera ids
    pnt_idx: np.ndarray         # (nobs_pad,) global point ids
    pt2d: np.ndarray            # (nobs_pad, 2)
    w: np.ndarray               # (nobs_pad,)
    ndev: int
    nobs: int                   # global true rows
    dtype: torch.dtype
    device_type: str            # where the global problem lived
    name: str = "ba"
    shards: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def ncams(self) -> int:
        return self.cams.shape[0]

    @property
    def npnts(self) -> int:
        return self.points.shape[0]

    @property
    def nobs_pad(self) -> int:
        return self.cam_idx.shape[0]

    @property
    def chunk(self) -> int:
        return self.nobs_pad // self.ndev

    def _build(self, rank: int, device: torch.device) -> BAProblem:
        rows = slice(rank * self.chunk, (rank + 1) * self.chunk)
        ci, pi, w = self.cam_idx[rows], self.pnt_idx[rows], self.w[rows]
        pnt_perm, pnt_starts, cam_perm, cam_starts = row_order(
            ci, pi, self.ncams, self.npnts)
        return BAProblem.from_numpy(
            dict(cams=self.cams, points=self.points, cam_idx=ci,
                 pnt_idx=pi, pt2d=self.pt2d[rows], w=w,
                 pnt_starts=pnt_starts, cam_perm=cam_perm,
                 cam_starts=cam_starts, pnt_perm=pnt_perm,
                 nobs=int(np.count_nonzero(w)),
                 name=f"{self.name}/shard{rank}"),
            device=device, dtype=self.dtype)

    def split_points(self, points_global: torch.Tensor,
                     rank: int) -> torch.Tensor:
        """The points shard ``rank`` holds: all of them."""
        return points_global.reshape(self.npnts, 3)

    def global_points(self, points_local: torch.Tensor,
                      group: Optional[dist.ProcessGroup] = None
                      ) -> torch.Tensor:
        """The global points: every rank holds them already."""
        return points_local


def group_shards(problem: BAProblem, ndev: int) -> GroupProblem:
    """Split ``problem`` into ``ndev`` equal row chunks with every camera
    and point on each (:class:`GroupProblem`). Meant for a partitioned
    problem (``partition_problem(problem, ndev)``), whose chunks are its
    camera groups; raises unless ``nobs_pad`` divides by ``ndev``."""
    if problem.nobs_pad % ndev:
        raise ValueError(f"nobs_pad={problem.nobs_pad} not divisible by "
                         f"{ndev} ranks")
    return GroupProblem(
        cams=_host(problem.cams), points=_host(problem.points),
        cam_idx=problem.cam_idx.cpu().numpy(),
        pnt_idx=problem.pnt_idx.cpu().numpy(), pt2d=_host(problem.pt2d),
        w=_host(problem.w), ndev=ndev, nobs=problem.nobs,
        dtype=problem.dtype, device_type=problem.cams.device.type,
        name=problem.name)


@dataclasses.dataclass
class MeshShard(BAProblem):
    """One rank's shard of a problem, which the drivers
    (`solver/lm_jit.py`, `solver/lm.py`) take as they take a
    :class:`BAProblem` and solve over ``group``
    (:meth:`SpmdProblem.rank_shard`, :meth:`GroupProblem.rank_shard`).
    ``spmd`` holds the global sizes and the split. ``layout`` names it:

    - ``"points"`` (:class:`SpmdProblem`): the rank's rows and points,
      global camera ids, local point ids; every point's rows on its rank;
    - ``"cameras"`` (:class:`GroupProblem`): the rank's chunk of a
      partitioned problem's rows, global ids, every camera and point; a
      point's rows span ranks (`ops/spmdctx.py` sums its rows there)."""
    spmd: Optional[_Shards] = None
    group: Optional[dist.ProcessGroup] = None
    rank: int = 0
    layout: str = "points"


def shard_problem_kminor(problem: BAProblem, ndev: int) -> SpmdProblem:
    """Split ``problem`` (point-sorted, as every constructor builds it)
    into ``ndev`` point-aligned shards with near-equal row counts, by the
    JAX package's greedy rule: shard ``d`` starts at the first point whose
    cumulative row count reaches ``d * nobs / ndev``, each shard keeping
    at least one point."""
    nobs, npnts = problem.nobs, problem.npnts
    if npnts < ndev:
        raise ValueError(f"npnts={npnts} < ndev={ndev}")
    if problem.pnt_perm is not None:
        raise ValueError("a partitioned problem (pnt_perm) is not "
                         "point-sorted: shard it in camera groups "
                         "(parallel/mesh.py:shard_problem, group_shards)")
    pi = problem.pnt_idx.cpu().numpy()
    w = _host(problem.w)
    if np.any(np.diff(pi[:nobs]) < 0):
        raise ValueError("rows are not point-sorted (need the "
                         "from_arrays layout)")
    if not (np.all(w[:nobs] == 1.0) and np.all(w[nobs:] == 0.0)):
        raise ValueError("the shards are built by from_arrays, whose rows "
                         "weigh 1 (and its padding 0)")
    cum = np.cumsum(np.bincount(pi[:nobs], minlength=npnts))
    bounds = [0]
    for d in range(1, ndev):
        p = int(np.searchsorted(cum, d * nobs / ndev))
        bounds.append(min(max(p, bounds[-1] + 1), npnts - (ndev - d)))
    bounds.append(npnts)
    row_bounds = [0] + [int(cum[b - 1]) for b in bounds[1:]]
    return SpmdProblem(
        cams=_host(problem.cams), points=_host(problem.points),
        cam_idx=problem.cam_idx.cpu().numpy(), pnt_idx=pi,
        pt2d=_host(problem.pt2d),
        point_offsets=np.asarray(bounds[:-1], np.int64),
        npnts_loc=np.diff(bounds).astype(np.int64),
        nobs_loc=np.diff(row_bounds).astype(np.int64),
        row_offsets=np.asarray(row_bounds[:-1], np.int64),
        nobs=nobs, nobs_pad=problem.nobs_pad, dtype=problem.dtype,
        device_type=problem.cams.device.type, name=problem.name)
