"""The device mesh of a solve over ranks (PyTorch port of
`bundleadjustment_jl_tpu/parallel/mesh.py`): :func:`make_mesh` and
:func:`shard_problem`.

The JAX package shards the observation arrays over a 1-D mesh in equal
contiguous chunks, replicates the state, and lets XLA place the
all-reduces (GSPMD). Equal chunks split a point's rows across devices,
and the port's fused kernels need each point's rows on one rank (K1's
point pass, K3's point-to-camera matvec, K2's W C W', K5's and K6's point
walks). So the port's mesh shards are point-aligned
(`parallel/spmd.py:shard_problem_kminor`, the JAX spmd driver's greedy
point bounds):

- a rank is a process with one device (a card over NCCL, or the CPU over
  gloo), and the mesh spans the ranks of the world group;
- the cameras are replicated; the rows and the points are rank-local;
- every camera-space sum, and the point part of every scalar the host
  reads, is all-reduced by the one set of hooks in `ops/spmdctx.py`,
  which the drivers switch on for a shard (`solver/lm_jit.py`,
  `solver/lm.py`).

A partitioned problem (`parallel/partition.py:partition_problem`, with
``pnt_perm``) is sharded as the JAX package shards it: rank ``r`` gets the
equal row chunk ``r``, its camera group, and every camera and point
(`parallel/spmd.py:GroupProblem`). A point's rows then span ranks, so the
hooks all-reduce the point sums as well, and the point parts of the
scalars are replicated (``layout = "cameras"``). It solves on the plain
route, as the JAX package solves it on XLA.

A shard (:class:`~bundleadjustment_jl_tpu_torch.parallel.spmd.MeshShard`)
is a :class:`BAProblem` that carries its process group, its layout, the
global sizes and the split, so every driver and step solver takes it as
it takes a problem; each rank gets the same result, with the global
points.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.parallel.spmd import (
    MeshShard, group_shards, shard_problem_kminor)

OBS_AXIS = "obs"


def make_mesh(n_devices: Optional[int] = None,
              devices: Union[None, str, Sequence] = None,
              axis_name: str = OBS_AXIS) -> DeviceMesh:
    """A 1-D mesh over the ranks of the world group, named ``axis_name``.

    A rank is a process, so the mesh holds every rank: ``n_devices``
    (default: the world size) must equal the world size. ``devices`` is the
    device type, ``"cuda"`` (the default: a card a rank, NCCL) or
    ``"cpu"`` (gloo), or a sequence of one device a rank, all of one type.
    The process group must be initialized first (``init_process_group``,
    or ``torchrun``'s environment with ``init_method="env://"``)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process "
                           "group: call init_process_group first")
    world = dist.get_world_size()
    if devices is None or isinstance(devices, str):
        kind = devices or "cuda"
    else:
        kinds = {torch.device(d).type for d in devices}
        if len(kinds) != 1 or len(devices) != world:
            raise ValueError(f"devices: one device a rank, all of one type, "
                             f"for the {world} ranks; got {list(devices)}")
        kind = kinds.pop()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh({n}): the mesh size must equal the "
                         f"world size {world} (a rank a device): start "
                         f"{n} processes (torchrun --nproc-per-node {n}) "
                         f"or ask for make_mesh({world})")
    need = {"cuda": "nccl", "cpu": "gloo"}.get(kind)
    if need is None:
        raise ValueError(f"devices: 'cuda' or 'cpu', not {kind!r}")
    backend = str(dist.get_backend())
    if need not in backend:
        raise ValueError(f"a {kind} mesh needs a {need} process group, this "
                         f"one is {backend}")
    return init_device_mesh(kind, (n,), mesh_dim_names=(axis_name,))


def shard_problem(problem: BAProblem, mesh: DeviceMesh,
                  axis_name: str = OBS_AXIS) -> MeshShard:
    """This rank's shard of ``problem`` on ``mesh``, on the mesh's device
    (``cuda:LOCAL_RANK`` or the CPU). Every rank calls it with the same
    problem.

    ``nobs_pad`` must divide by the mesh size, as in the JAX package
    (``ValueError`` otherwise, so both packages refuse the same inputs).
    A point-sorted problem's shards are not cut in equal chunks: each
    holds its points' rows, and the global padding rows stay on the last
    shard. A partitioned problem's (``pnt_perm``) are the equal chunks, its
    camera groups. A one-rank shard is the problem itself, padding rows
    included."""
    if mesh.ndim != 1 or axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"shard_problem needs a 1-D mesh named "
                         f"{axis_name!r}, got {mesh}")
    n = mesh.size()
    if problem.nobs_pad % n != 0:
        raise ValueError(
            f"nobs_pad={problem.nobs_pad} not divisible by mesh size {n}; "
            f"rebuild the problem with pad_obs_to a multiple of {n}")
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    split = (shard_problem_kminor(problem, n) if problem.pnt_perm is None
             else group_shards(problem, n))
    return split.rank_shard(mesh.get_group(axis_name), device)
