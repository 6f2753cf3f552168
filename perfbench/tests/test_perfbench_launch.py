"""The launcher of a cell over more than one chip: two ranks under gloo on
the CPU."""

from __future__ import annotations

import pytest

from perfbench import launch


def _allreduce(rank, world, base):
    import torch
    import torch.distributed as dist
    t = torch.tensor([float(base + rank)])
    dist.all_reduce(t)
    return (rank, world, float(t))


def _fail(rank, world):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def _loads_jax(rank, world):
    import sys
    import types
    if rank == 1:
        sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
    return rank


def _loads_a_longer_name(rank, world):
    import sys
    import types
    sys.modules["jaxtyping_like"] = types.ModuleType("jaxtyping_like")
    return rank


def test_two_ranks_under_gloo():
    out = launch.spawn(2, _allreduce, (10,), backend="gloo", timeout=120)
    assert out == [(0, 2, 21.0), (1, 2, 21.0)]


def test_a_failing_rank_raises():
    with pytest.raises(RuntimeError, match="rank one fails"):
        launch.spawn(2, _fail, backend="gloo", timeout=120)


def test_a_rank_that_loads_jax_raises():
    """Each rank's modules are checked once its work is done, by whole
    top-level names: ``jax.numpy`` counts as ``jax``, a longer name that
    only begins with it does not."""
    with pytest.raises(RuntimeError, match=r"rank 1:\n.*\['jax'\]"):
        launch.spawn(2, _loads_jax, backend="gloo", timeout=120)
    assert launch.spawn(2, _loads_a_longer_name, backend="gloo",
                        timeout=120) == [0, 1]
