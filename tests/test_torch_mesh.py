"""The port's mesh path (`parallel/mesh.py`: `make_mesh`, `shard_problem`;
the mesh shard through `solver/lm_jit.py`'s one-shot and chunked drivers
and `solver/lm.py`'s host driver, with every step solver) on the CPU over
gloo, against the same calls without a mesh and against the JAX package's
GSPMD mesh path on problems built from the same seed.

The cases: the one-shot driver with each step solver (pcg, power, dense,
cgls), the chunked driver with pcg, and the host driver with pcg and cgls,
each in float64 and float32. The bars:

- **One rank** (a gloo group in this process): every case bit-identical
  to the same call on the problem without a mesh (status, iterations,
  objective, cams, points, histories); the one-rank shard is the problem
  itself, padding rows included.
- **Two gloo processes**: both ranks bit-identical; the chunked driver
  with a checkpoint, stopped and resumed, bit-identical to the one-shot
  mesh solve from the resumed iteration on.
- **Against the JAX mesh path** (``levenberg_marquardt_jit`` or
  ``lm.levenberg_marquardt`` of ``shard_problem(p, make_mesh(2))`` on two
  of the conftest's virtual CPU devices, its XLA path) and against the
  port's own one-device solve: the same status, and in float64 the same
  iterations with the objective within rel 1e-6 (the JAX bar,
  `tests/test_parallel.py:54-63`). In float32 the same status and
  iterations with the objective within rel 1e-5: the JAX package's own
  float32 bar between its one- and two-device solves
  (`tests/test_multihost.py:83-87`, "f32 reduction orders differ"). On
  these problems the JAX mesh and one-device float32 solves differ by up
  to 1.8e-6 (power, cgls), and near the floor, where float32 steps are
  rounding noise, by up to 1e-3 (dense); so float32 stops at a first-order
  gradient 1e-4 of the initial one, and float64 runs to the floor.
- The problem of `tests/multihost_worker.py` (6 cameras, 64 points,
  float32, padded to 64, 10 iterations, ``lam0_mode="diag"``) on two ranks
  against the JAX solve on two devices, by that test's bar.
"""

import inspect
import json
import os
import socket
import subprocess
import sys
import textwrap
from datetime import timedelta
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.parallel import mesh as jax_mesh
from bundleadjustment_jl_tpu.solver import lm as jax_lm
from bundleadjustment_jl_tpu.solver import lm_jit as jax_lm_jit
from bundleadjustment_jl_tpu_torch.io import synthetic_bal
from bundleadjustment_jl_tpu_torch.parallel import (
    OBS_AXIS, MeshShard, make_mesh, shard_problem)
from bundleadjustment_jl_tpu_torch.solver import (
    LMOptions, levenberg_marquardt)
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    STATUS_NAMES, levenberg_marquardt_jit, levenberg_marquardt_jit_chunked)

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PROBLEM = dict(ncams=8, npnts=64, obs_per_pnt=4, noise_px=0.3, perturb=2e-2,
               seed=21, pad_obs_to=128)
_BASE = dict(max_iters=30, pcg_max_iters=60, lam0_mode="diag", satol=0.0,
             srtol=0.0, atol=0.0, oatol=0.0)
OPTS = {"float64": dict(_BASE, rtol=1e-6, ortol=1e-7),
        "float32": dict(_BASE, rtol=1e-4, ortol=1e-3)}
REL = {"float64": 1e-6, "float32": 1e-5}
# (driver, step solver)
CASES = [("jit", "pcg"), ("jit", "power"), ("jit", "dense"), ("jit", "cgls"),
         ("chunked", "pcg"), ("host", "pcg"), ("host", "cgls")]
DTYPES = ("float64", "float32")
KEYS = [f"{d}-{s}-{dt}" for dt in DTYPES for d, s in CASES]
CHUNK = 3
# tests/multihost_worker.py's problem and solve
MULTIHOST = dict(ncams=6, npnts=64, obs_per_pnt=3, noise_px=0.5, perturb=1e-2,
                 seed=7, pad_obs_to=64)
MULTIHOST_OPTS = dict(max_iters=10, lam0_mode="diag")
TIMEOUT_S = 120


def run_case(problem, driver, solver, opts, **chunked):
    """One solve of ``problem`` (a problem or a mesh shard) by ``driver``
    ("jit", "chunked" or "host") with step ``solver``, as a dict of plain
    values: status name, iterations, objective, cams, points and the
    per-iteration record."""
    if driver == "host":
        r = levenberg_marquardt(problem, LMOptions(solver=solver, **opts))
        hist = [[row[k] for k in ("obj", "gnorm", "lam", "cg_iters")]
                for row in r.history]
        status = r.status
    else:
        use = {} if solver == "pcg" else {f"use_{solver}": True}
        if driver == "chunked":
            r = levenberg_marquardt_jit_chunked(
                problem, chunk_iters=CHUNK, **chunked, **opts, **use)
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


# One rank of the two-rank runs: `python -c WORKER addr rank tmpdir spec`.
# Prints one JSON line with every case's result.
WORKER = r"""
import json, sys
from datetime import timedelta
import numpy as np
import torch.distributed as dist
from bundleadjustment_jl_tpu_torch.io import synthetic_bal
from bundleadjustment_jl_tpu_torch.parallel import make_mesh, shard_problem
from bundleadjustment_jl_tpu_torch.solver import LMOptions, levenberg_marquardt
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    STATUS_NAMES, levenberg_marquardt_jit, levenberg_marquardt_jit_chunked)
""" + textwrap.dedent(inspect.getsource(run_case)) + r"""
addr, rank, tmp, spec = sys.argv[1], int(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4])
CHUNK = spec["chunk"]
dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=2,
                        timeout=timedelta(seconds=60))
mesh = make_mesh(2, "cpu")
out, shards = {}, {}
for dt in spec["dtypes"]:
    shard = shards[dt] = shard_problem(synthetic_bal(
        dtype=dt, device="cpu", **spec["problem"])[0], mesh)
    for driver, solver in spec["cases"]:
        out[f"{driver}-{solver}-{dt}"] = run_case(shard, driver, solver,
                                                  spec["opts"][dt])
shard, opts = shards["float64"], spec["opts"]["float64"]
part = run_case(shard, "chunked", "pcg", dict(opts, max_iters=2 * CHUNK),
                checkpoint_dir=tmp)
out["resumed"] = run_case(shard, "chunked", "pcg", opts, checkpoint_dir=tmp,
                          resume=True)
out["part_iterations"] = part["iterations"]
mh = synthetic_bal(dtype="float32", device="cpu", **spec["multihost"])[0]
out["multihost"] = run_case(shard_problem(mh, mesh), "jit", "pcg",
                            spec["multihost_opts"])
odd = synthetic_bal(dtype="float32", device="cpu", **spec["odd"])[0]
try:
    shard_problem(odd, mesh)
    out["odd"] = None
except ValueError as err:
    out["odd"] = str(err)
out["ranks"] = [mesh.size(), shard.rank, shard.npnts, shard.spmd.npnts]
dist.destroy_process_group()
print(json.dumps(out))
"""
# 21 rows padded to 21: not divisible by a mesh of 2.
ODD = dict(ncams=4, npnts=7, obs_per_pnt=3, seed=22, pad_obs_to=1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_problem(dtype, **kw):
    return synthetic_bal(dtype=dtype, device="cpu", **{**PROBLEM, **kw})[0]


def jax_reference(key, mesh):
    """The JAX mesh path's solve of case ``key`` on ``mesh``: the one-shot
    driver (the chunked case's too) or the host driver."""
    driver, solver, dt = key.split("-")
    jp, _ = jax_synthetic(dtype=getattr(jnp, dt), **PROBLEM)
    sharded = jax_mesh.shard_problem(jp, mesh)
    opts = OPTS[dt]
    if driver == "host":
        r = jax_lm.levenberg_marquardt(sharded, jax_lm.LMOptions(
            solver=solver, **opts))
        return r.status, int(r.iterations), float(r.objective)
    use = {} if solver == "pcg" else {f"use_{solver}": True}
    r = jax_lm_jit.levenberg_marquardt_jit(sharded, **opts, **use)
    return (jax_lm_jit.STATUS_NAMES[int(r.status)], int(r.iterations),
            float(r.objective))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_ckpt")


@pytest.fixture(scope="module")
def runs(ckpt_dir):
    """Both ranks' results of the two-rank runs (WORKER, each rank a
    process over gloo) and the JAX mesh path's, solved in this process
    while the ranks run."""
    addr = f"tcp://127.0.0.1:{_free_port()}"
    spec = json.dumps(dict(problem=PROBLEM, opts=OPTS, cases=CASES,
                           dtypes=DTYPES, chunk=CHUNK, multihost=MULTIHOST,
                           multihost_opts=MULTIHOST_OPTS, odd=ODD))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, addr, str(rank), str(ckpt_dir), spec],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    try:
        mesh = jax_mesh.make_mesh(2)
        ref = {k: jax_reference(k, mesh) for k in KEYS
               if not k.startswith("chunked")}
        for dt in DTYPES:
            ref[f"chunked-pcg-{dt}"] = ref[f"jit-pcg-{dt}"]
        mp, _ = jax_synthetic(dtype=jnp.float32, **MULTIHOST)
        r = jax_lm_jit.levenberg_marquardt_jit(
            jax_mesh.shard_problem(mp, mesh), **MULTIHOST_OPTS)
        ref["multihost"] = (jax_lm_jit.STATUS_NAMES[int(r.status)],
                            int(r.iterations), float(r.objective))
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


def meets(got, ref, dt):
    """``got`` (a result dict) meets ``ref`` ((status, iterations,
    objective)) by the bar of dtype ``dt`` (the module docstring)."""
    status, iterations, objective = ref
    assert got["status"] == status
    assert got["iterations"] == iterations
    assert got["objective"] == pytest.approx(objective, rel=REL[dt])


def same(got, ref, start=0):
    """``got`` bit-identical to ``ref``, its record from ``start`` on."""
    assert {k: v for k, v in got.items() if k != "hist"} == \
        {k: v for k, v in ref.items() if k != "hist"}
    assert got["hist"][start:] == ref["hist"][start:]


# ------------------------------------------------------------ one rank
def test_make_mesh_and_shard_carry_the_group(one_rank):
    mesh = make_mesh(devices="cpu")
    assert (mesh.size(), mesh.device_type, mesh.mesh_dim_names) == (
        1, "cpu", (OBS_AXIS,))
    assert make_mesh(1, ["cpu"]).size() == 1
    problem = port_problem("float32", pad_obs_to=96)
    shard = shard_problem(problem, mesh)
    assert isinstance(shard, MeshShard)
    assert shard.group is one_rank and shard.rank == 0
    sp = shard.spmd
    assert (sp.ncams, sp.npnts, sp.nobs, sp.nobs_pad, sp.ndev) == (
        problem.ncams, problem.npnts, problem.nobs, problem.nobs_pad, 1)
    assert sp.point_offsets.tolist() == [0]
    assert sp.npnts_loc.tolist() == [problem.npnts]
    # the one-rank shard is the problem itself, padding rows included
    assert problem.nobs_pad > problem.nobs
    for k in ("cams", "points", "cam_idx", "pnt_idx", "pt2d", "w",
              "pnt_starts", "cam_perm", "cam_starts"):
        assert torch.equal(getattr(shard, k), getattr(problem, k)), k
    assert (shard.nobs, shard.name) == (problem.nobs, f"{problem.name}/shard0")


@pytest.mark.parametrize("args,error,match", [
    ((2,), ValueError, "must equal the world size 1"),
    ((None, "cuda"), ValueError, "needs a nccl process group"),
    ((None, ["cpu", "cpu"]), ValueError, "one device a rank"),
], ids=["n_not_world", "cuda_over_gloo", "devices_not_world"])
def test_make_mesh_refusals(one_rank, args, error, match):
    with pytest.raises(error, match=match):
        make_mesh(*args)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(devices="cpu")


@pytest.mark.parametrize("key", KEYS)
def test_one_rank_bit_identical_to_no_mesh(one_rank, key):
    driver, solver, dt = key.split("-")
    problem = port_problem(dt)
    shard = shard_problem(problem, make_mesh(devices="cpu"))
    got = run_case(shard, driver, solver, OPTS[dt])
    same(got, run_case(problem, driver, solver, OPTS[dt]))
    assert got["iterations"] > 2


# ------------------------------------------------------------ two ranks
@pytest.mark.parametrize("key", KEYS)
def test_two_ranks_match_each_other_jax_and_one_device(runs, key):
    outs, ref = runs
    a, b = outs[0][key], outs[1][key]
    assert a == b                                # every value, bit for bit
    dt = key.split("-")[2]
    meets(a, ref[key], dt)
    driver, solver, _ = key.split("-")
    one = run_case(port_problem(dt), driver, solver, OPTS[dt])
    meets(a, (one["status"], one["iterations"], one["objective"]), dt)
    np.testing.assert_allclose(a["points"], one["points"], rtol=1e-3,
                               atol=1e-3)


def test_two_ranks_chunked_resume_bit_identical(runs):
    outs, _ = runs
    for out in outs:
        assert out["part_iterations"] == 2 * CHUNK
        same(out["resumed"], out["chunked-pcg-float64"], start=2 * CHUNK)
    assert outs[0]["resumed"] == outs[1]["resumed"]
    assert outs[0]["ranks"] == [2, 0, outs[0]["ranks"][2], PROBLEM["npnts"]]
    assert outs[1]["ranks"][1] == 1
    assert outs[0]["ranks"][2] + outs[1]["ranks"][2] == PROBLEM["npnts"]


def test_two_ranks_multihost_problem(runs):
    """`tests/multihost_worker.py`'s problem and solve on two ranks against
    the JAX mesh path on two devices, by `tests/test_multihost.py`'s bar:
    the same iterations and status, the objective within rel 1e-5."""
    outs, ref = runs
    assert outs[0]["multihost"] == outs[1]["multihost"]
    meets(outs[0]["multihost"], ref["multihost"], "float32")


def test_two_ranks_refuse_indivisible_padding(runs):
    """The counterpart of `tests/test_parallel.py:66-72`: both packages
    refuse ``nobs_pad`` not divisible by the mesh size."""
    outs, _ = runs
    jp, _ = jax_synthetic(dtype=jnp.float32, **ODD)
    assert jp.nobs_pad % 2 == 1
    with pytest.raises(ValueError, match="not divisible by mesh size 2"):
        jax_mesh.shard_problem(jp, jax_mesh.make_mesh(2))
    for out in outs:
        assert "nobs_pad=21 not divisible by mesh size 2" in out["odd"]
