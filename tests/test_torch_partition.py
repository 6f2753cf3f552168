"""The port's camera-partitioned layout (`parallel/partition.py:
partition_problem`, `BAProblem.pnt_perm`, the plain route it takes, and its
camera-group mesh shards) on the CPU, against the JAX package's on problems
built from the same seed.

The bars:

- **partition_problem**: every array of the JAX function's result, its
  ``nobs_pad`` and ``part_of_cam``, exactly, for 2, 4 and 8 parts; the
  JAX tests' checks (`tests/test_partition.py`): balance under 1.5, the
  objective within rel 1e-12 of the unpartitioned problem's, each chunk's
  true rows in its own camera group.
- **Solve** (float64): the JAX one-shot driver on the JAX partitioned
  problem, in its scatter and ``SORTED_MODE`` forms: the same status and
  iterations, the objective within rel 1e-9; and within rel 1e-6 of the
  port's unpartitioned solve (`tests/test_partition.py`'s bar).
- **Route**: a partitioned problem takes the plain route in every dtype;
  a solve with the kernel wrappers made to raise never reaches one, and
  every launch plan refuses the problem.
- **Camera-group shards**: one gloo rank (in this process) bit-identical
  to the same call without a mesh, for every driver and step solver; two
  gloo ranks (``python -c WORKER`` processes) bit-identical to each other
  and, in float64, within rel 1e-6 of the solve without a mesh and of the
  JAX package's GSPMD solve of the partitioned problem on two of the
  conftest's virtual devices, with the same status and iterations.
"""

import inspect
import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bundleadjustment_jl_tpu.io.synthetic import (
    synthetic_bal as jax_synthetic)
from bundleadjustment_jl_tpu.ops import segsum
from bundleadjustment_jl_tpu.ops.residuals import (
    objective as jax_objective)
from bundleadjustment_jl_tpu.parallel import mesh as jax_mesh
from bundleadjustment_jl_tpu.parallel import (
    partition as jax_partition)
from bundleadjustment_jl_tpu.solver import lm as jax_lm
from bundleadjustment_jl_tpu.solver import lm_jit as jax_lm_jit
from bundleadjustment_jl_tpu_torch.io import synthetic_bal
from bundleadjustment_jl_tpu_torch.models.problem import (
    HALF_DTYPES, BAProblem)
from bundleadjustment_jl_tpu_torch.ops import normal, plans
from bundleadjustment_jl_tpu_torch.ops.residuals import (
    objective)
from bundleadjustment_jl_tpu_torch.parallel import (
    GroupProblem, MeshShard, greedy_camera_partition, make_mesh,
    partition_problem, partition_stats, shard_problem, shard_problem_kminor)
from bundleadjustment_jl_tpu_torch.solver import (
    LMOptions, levenberg_marquardt, levenberg_marquardt_spmd)
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    STATUS_NAMES, levenberg_marquardt_jit, levenberg_marquardt_jit_chunked)

ROOT = Path(__file__).resolve().parents[1]
# tests/test_partition.py's problem
PROBLEM = dict(ncams=16, npnts=120, obs_per_pnt=4, noise_px=0.3,
               perturb=2e-3, seed=80)
FIELDS = ("cams", "points", "cam_idx", "pnt_idx", "pt2d", "w", "pnt_starts",
          "cam_perm", "cam_starts", "pnt_perm")
OPTS = dict(max_iters=30, pcg_max_iters=60, lam0_mode="diag", satol=0.0,
            srtol=0.0, atol=0.0, oatol=0.0, rtol=1e-6, ortol=1e-7)
# (driver, step solver)
CASES = [("jit", "pcg"), ("jit", "power"), ("jit", "dense"), ("jit", "cgls"),
         ("chunked", "pcg"), ("host", "pcg"), ("host", "cgls")]
KEYS = [f"{d}-{s}" for d, s in CASES]
CHUNK = 3
TIMEOUT_S = 120


def run_case(problem, driver, solver, opts):
    """One solve of ``problem`` (a problem or a mesh shard) by ``driver``
    with step ``solver``, as a dict of plain values."""
    if driver == "host":
        r = levenberg_marquardt(problem, LMOptions(solver=solver, **opts))
        hist = [[row[k] for k in ("obj", "gnorm", "lam", "cg_iters")]
                for row in r.history]
        status = r.status
    else:
        use = {} if solver == "pcg" else {f"use_{solver}": True}
        if driver == "chunked":
            r = levenberg_marquardt_jit_chunked(problem, chunk_iters=CHUNK,
                                                **opts, **use)
        else:
            r = levenberg_marquardt_jit(problem, **opts, **use)
        n = r.iterations
        hist = np.stack([r.hist_obj[:n].astype(float),
                         r.hist_gnorm[:n].astype(float),
                         r.hist_lam[:n].astype(float),
                         r.hist_cg[:n].astype(float)], 1).tolist()
        status = STATUS_NAMES[r.status]
    return dict(status=status, iterations=int(r.iterations),
                objective=float(r.objective), hist=hist,
                cams=r.cams.double().ravel().tolist(),
                points=r.points.double().ravel().tolist())


# One rank of the two-rank runs: `python -c WORKER addr rank spec`. Prints
# one JSON line: every case's result and the rank's shard.
WORKER = r"""
import json, sys
from datetime import timedelta
import torch
torch.set_num_threads(1)

import numpy as np
import torch.distributed as dist
from bundleadjustment_jl_tpu_torch.io import synthetic_bal
from bundleadjustment_jl_tpu_torch.parallel import (
    make_mesh, partition_problem, shard_problem)
from bundleadjustment_jl_tpu_torch.solver import LMOptions, levenberg_marquardt
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    STATUS_NAMES, levenberg_marquardt_jit, levenberg_marquardt_jit_chunked)
""" + inspect.getsource(run_case) + r"""
addr, rank, spec = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
CHUNK = spec["chunk"]
dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=2,
                        timeout=timedelta(seconds=60))
q, _ = partition_problem(synthetic_bal(device="cpu", **spec["problem"])[0], 2)
shard = shard_problem(q, make_mesh(2, "cpu"))
out = {f"{d}-{s}": run_case(shard, d, s, spec["opts"])
       for d, s in spec["cases"]}
out["shard"] = dict(layout=shard.layout, rank=shard.rank, nobs=shard.nobs,
                    nobs_pad=shard.nobs_pad, npnts=shard.npnts,
                    cam_idx=shard.cam_idx.tolist(), w=shard.w.tolist())
dist.destroy_process_group()
print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_problem():
    return jax_synthetic(**PROBLEM)[0]


def to_port(jp) -> BAProblem:
    return BAProblem.from_numpy(
        {**{k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS},
         "name": jp.name}, device="cpu")


@pytest.fixture(scope="module")
def unsharded():
    """The port's solves without a mesh: each case on the problem and on
    its 2-part partition."""
    p = synthetic_bal(device="cpu", **PROBLEM)[0]
    q, _ = partition_problem(p, 2)
    return ({k: run_case(p, *k.split("-"), OPTS) for k in KEYS},
            {k: run_case(q, *k.split("-"), OPTS) for k in KEYS})


@pytest.fixture(scope="module")
def runs():
    """Both ranks' results of the two-rank runs and the JAX GSPMD solves of
    the partitioned problem on two devices, made in this process while the
    ranks run."""
    addr = f"tcp://127.0.0.1:{_free_port()}"
    spec = json.dumps(dict(problem=PROBLEM, opts=OPTS, cases=CASES,
                           chunk=CHUNK))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, addr, str(rank), spec], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        jq, _ = jax_partition.partition_problem(jax_problem(), 2)
        sharded = jax_mesh.shard_problem(jq, jax_mesh.make_mesh(2))
        ref = {}
        for key in KEYS:
            driver, solver = key.split("-")
            if driver == "host":
                r = jax_lm.levenberg_marquardt(sharded, jax_lm.LMOptions(
                    solver=solver, **OPTS))
                ref[key] = (r.status, int(r.iterations), float(r.objective))
            elif driver == "jit":
                use = {} if solver == "pcg" else {f"use_{solver}": True}
                r = jax_lm_jit.levenberg_marquardt_jit(sharded, **OPTS, **use)
                ref[key] = (jax_lm_jit.STATUS_NAMES[int(r.status)],
                            int(r.iterations), float(r.objective))
        ref["chunked-pcg"] = ref["jit-pcg"]
        outs = []
        for proc in procs:
            out, err = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, err[-4000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs, ref


@pytest.fixture
def one_rank():
    """A gloo process group of one rank in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def meets(got, ref, rel):
    status, iterations, objective = ref
    assert got["status"] == status
    assert got["iterations"] == iterations
    assert got["objective"] == pytest.approx(objective, rel=rel)


# ------------------------------------------------------------ partition
@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_partition_problem_matches_jax(n_parts):
    jp = jax_problem()
    jq, jpart = jax_partition.partition_problem(jp, n_parts)
    tq, tpart = partition_problem(to_port(jp), n_parts)
    np.testing.assert_array_equal(tpart, jpart)
    assert tpart.dtype == jpart.dtype
    for k in FIELDS:
        got, want = getattr(tq, k), np.asarray(getattr(jq, k))
        assert got.dtype == (torch.int32 if want.dtype == np.int32
                             else torch.float64), k
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    assert (tq.nobs, tq.nobs_pad, tq.name) == (jq.nobs, jq.nobs_pad, jq.name)
    assert tq.nobs_pad % (8 * n_parts) == 0
    # a JAX partitioned problem crosses over with its pnt_perm, and the
    # copies a solve makes keep it
    back = to_port(jq)
    for k in FIELDS:
        assert torch.equal(getattr(back, k), getattr(tq, k)), k
    for copy in (tq.astype(torch.float32), tq.with_state(tq.cams, tq.points)):
        assert copy.pnt_perm is tq.pnt_perm and copy.plans is tq.plans


def test_greedy_partition_balances():
    p = synthetic_bal(device="cpu", **PROBLEM)[0]
    part = greedy_camera_partition(p.cam_idx[:p.nobs].numpy(), p.ncams, 4)
    assert part.shape == (p.ncams,) and set(part) == {0, 1, 2, 3}
    assert partition_stats(p, part, 4)["imbalance"] < 1.5


def test_partitioned_problem_is_equivalent():
    p = synthetic_bal(device="cpu", **PROBLEM)[0]
    q, part = partition_problem(p, 8)
    assert q.nobs == p.nobs and q.nobs_pad % 8 == 0
    assert float(objective(q)) == pytest.approx(float(objective(p)),
                                                rel=1e-12)
    assert float(objective(q)) == pytest.approx(
        float(jax_objective(jax_partition.partition_problem(
            jax_problem(), 8)[0])), rel=1e-12)
    chunk = q.nobs_pad // 8
    ci, w = q.cam_idx.numpy(), q.w.numpy()
    for s in range(8):
        rows = slice(s * chunk, (s + 1) * chunk)
        assert all(part[c] == s for c in np.unique(ci[rows][w[rows] > 0]))


@pytest.mark.parametrize("sorted_mode", [False, True],
                         ids=["scatter", "sorted"])
def test_partitioned_solve_matches_jax(monkeypatch, sorted_mode):
    """A float64 partitioned solve makes the JAX solve's decisions on its
    partitioned problem, in the scatter and SORTED_MODE forms."""
    monkeypatch.setattr(segsum, "SORTED_MODE", sorted_mode)
    jq, _ = jax_partition.partition_problem(jax_problem(), 4)
    ref = jax_lm_jit.levenberg_marquardt_jit(jq, max_iters=30)
    tq, _ = partition_problem(to_port(jax_problem()), 4)
    got = levenberg_marquardt_jit(tq, max_iters=30)
    assert got.status == int(ref.status)
    assert got.iterations == int(ref.iterations)
    assert got.naccepts == int(ref.naccepts)
    assert got.objective == pytest.approx(float(ref.objective), rel=1e-9)
    one = levenberg_marquardt_jit(to_port(jax_problem()), max_iters=30)
    assert got.objective == pytest.approx(one.objective, rel=1e-6)


# ------------------------------------------------------------ route
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16",
                                   "float16"])
def test_partitioned_problem_takes_the_plain_route(monkeypatch, dtype):
    """PALLAS_MODE on (the default): the unpartitioned float32 problem
    takes the kernels, its partition the plain twins in every dtype; a
    solve of it reaches no kernel wrapper, and every plan refuses it."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called on the plain route")

    assert normal.PALLAS_MODE
    p = synthetic_bal(device="cpu", **PROBLEM)[0].astype(dtype)
    q, _ = partition_problem(p, 4)
    assert q.dtype == p.dtype and q.pnt_perm is not None
    assert normal.plain_route(q.dtype, q)
    if q.dtype not in HALF_DTYPES:
        assert normal.solve_stages(q.dtype, q) is normal.PLAIN
    if dtype == "float32":
        assert normal.solve_stages(p.dtype, p) is normal.KERNELS
    monkeypatch.setattr(normal, "KERNELS",
                        normal.Stages(*[refuse] * len(normal.Stages._fields)))
    opts = dict(max_iters=3, lam0_mode="diag", satol=0.0, srtol=0.0,
                atol=0.0, oatol=0.0, ortol=0.0)
    r = levenberg_marquardt_jit(q, **opts)
    assert r.iterations == 3 and np.isfinite(r.objective)
    h = levenberg_marquardt(q, LMOptions(**opts))
    # the host driver's decisions are those of the unpartitioned problem
    # on the plain route (in float16 its gradient norm overflows at once)
    monkeypatch.setattr(normal, "PALLAS_MODE", False)
    ref = levenberg_marquardt(p, LMOptions(**opts))
    assert (h.status, h.iterations) == (ref.status, ref.iterations)
    for build in (plans.tile_plan, plans.point_blocks, plans.cam_col_plan,
                  plans.wcw_col_plan, plans.cam_row_plan, plans.cam_pnt,
                  plans.cam_obs):
        with pytest.raises(ValueError, match="pnt_perm"):
            build(q)
    assert not any(isinstance(k, str) or k[0] != "rows" for k in q.plans)


def test_point_aligned_shards_refuse_a_partitioned_problem(one_rank):
    q, _ = partition_problem(synthetic_bal(device="cpu", **PROBLEM)[0], 2)
    with pytest.raises(ValueError, match="pnt_perm"):
        shard_problem_kminor(q, 1)
    groups = shard_problem(q, make_mesh(devices="cpu")).spmd
    with pytest.raises(ValueError, match="point-aligned shards"):
        levenberg_marquardt_spmd(groups)


# ------------------------------------------------------------ one rank
def test_one_rank_camera_group_shard_is_the_problem(one_rank):
    q, _ = partition_problem(synthetic_bal(device="cpu", **PROBLEM)[0], 4)
    shard = shard_problem(q, make_mesh(devices="cpu"))
    assert isinstance(shard, MeshShard) and shard.layout == "cameras"
    assert isinstance(shard.spmd, GroupProblem)
    assert (shard.spmd.ndev, shard.spmd.nobs_pad, shard.spmd.nobs) == (
        1, q.nobs_pad, q.nobs)
    for k in FIELDS:
        assert torch.equal(getattr(shard, k), getattr(q, k)), k
    assert (shard.nobs, shard.group, shard.rank) == (q.nobs, one_rank, 0)


@pytest.mark.parametrize("key", KEYS)
def test_one_rank_bit_identical_to_no_mesh(one_rank, unsharded, key):
    q, _ = partition_problem(synthetic_bal(device="cpu", **PROBLEM)[0], 2)
    shard = shard_problem(q, make_mesh(devices="cpu"))
    got = run_case(shard, *key.split("-"), OPTS)
    assert got == unsharded[1][key]
    assert got["iterations"] > 2


def test_one_rank_bfloat16_bit_identical_to_no_mesh(one_rank):
    """A 2-byte working dtype on camera groups: the point sums all-reduce
    in float32 before the rounding, so one rank is the solve without a
    mesh bit for bit."""
    q, _ = partition_problem(
        synthetic_bal(device="cpu", **PROBLEM)[0].astype("bfloat16"), 2)
    opts = dict(max_iters=8, lam0_mode="diag", satol=0.0, srtol=0.0,
                atol=0.0, oatol=0.0, ortol=0.0)
    got = run_case(shard_problem(q, make_mesh(devices="cpu")), "jit", "pcg",
                   opts)
    assert got == run_case(q, "jit", "pcg", opts)
    assert got["iterations"] > 2


# ------------------------------------------------------------ two ranks
@pytest.mark.parametrize("key", KEYS)
def test_two_ranks_match_each_other_no_mesh_and_jax(runs, unsharded, key):
    outs, ref = runs
    a, b = outs[0][key], outs[1][key]
    assert a == b                                # every value, bit for bit
    meets(a, ref[key], 1e-6)
    for one in (unsharded[1][key], unsharded[0][key]):
        meets(a, (one["status"], one["iterations"], one["objective"]), 1e-6)
    np.testing.assert_allclose(a["points"], unsharded[1][key]["points"],
                               rtol=1e-4, atol=1e-6)


def test_two_ranks_hold_their_camera_groups(runs):
    """Rank r holds the equal row chunk r, its camera group: every camera
    of its true rows is in its part, every point on every rank."""
    outs, _ = runs
    q, part = partition_problem(synthetic_bal(device="cpu", **PROBLEM)[0], 2)
    chunk = q.nobs_pad // 2
    for r, out in enumerate(outs):
        sh = out["shard"]
        assert (sh["layout"], sh["rank"], sh["nobs_pad"], sh["npnts"]) == (
            "cameras", r, chunk, PROBLEM["npnts"])
        real = np.asarray(sh["w"]) > 0
        assert sh["nobs"] == real.sum()
        assert set(part[np.asarray(sh["cam_idx"])[real]]) == {r}
        np.testing.assert_array_equal(
            sh["cam_idx"], q.cam_idx[r * chunk:(r + 1) * chunk].numpy())
    assert outs[0]["shard"]["nobs"] + outs[1]["shard"]["nobs"] == q.nobs
