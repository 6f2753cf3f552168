"""The port's multi-process driver (`solver/lm_spmd.py`, `parallel/spmd.py`,
`ops/spmdctx.py`) on the CPU over gloo, against its one-shot driver and
the JAX package's spmd driver, on problems built from the same seed.

The bars:

- **Shards**: the JAX `shard_problem_kminor`'s point bounds, local point
  and row counts, and every array on the true rows. The padding differs
  on purpose: JAX pads every shard to a common row count, a multiple of
  128 (a Pallas lane rule); the port pads no shard, and the global
  problem's padding rows stay at the end of the last shard, so a
  one-shard problem is the problem itself.
- **One rank** (a gloo group in this process): bit-identical to the
  one-shot driver (status, iterations, histories, objective, cams,
  points), on routes A and C, in float32 and float64.
- **Two gloo processes**: both ranks' results and histories bit-identical;
  against the port's one-shot driver on routes A, C, B1 and B2 (forced
  through `normal.FORCE_ROUTE`) the JAX test's bar
  (`tests/test_spmd.py:57-80`): the same status and iterations, the
  objective within rel 1e-4 in float32; in float64 the same decisions
  (each step accepted or rejected alike, the same CG steps, every lambda
  row within rel 1e-12) with the objective within rel 1e-9. The camera
  sums are reassociated across the ranks, nothing else.
- **Against the JAX spmd driver** at two devices (the conftest's virtual
  CPU devices, its Pallas kernels in interpret mode): the JAX test's bar.
- **Chunked**: bit-identical to the one-shot spmd solve; a run stopped
  with a checkpoint and resumed is bit-identical to it from the resumed
  iteration on.
- **float64**: the JAX driver refuses it with its Pallas kernels on; the
  port solves it on the plain stages under the same all-reduces
  (:func:`test_float64_runs_the_plain_stages`).
"""

import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.ops import pallas_schur
from bundleadjustment_jl_tpu.parallel import partition as jax_partition
from bundleadjustment_jl_tpu.parallel.spmd import (
    shard_problem_kminor as jax_shard)
from bundleadjustment_jl_tpu.solver.lm_jit import STATUS_NAMES as JAX_NAMES
from bundleadjustment_jl_tpu.solver.lm_spmd import (
    levenberg_marquardt_spmd as jax_spmd)
from bundleadjustment_jl_tpu_torch.io import synthetic_bal
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
from bundleadjustment_jl_tpu_torch.ops import normal, plans, spmdctx
from bundleadjustment_jl_tpu_torch.parallel import (
    greedy_camera_partition, partition_stats, shard_problem_kminor)
from bundleadjustment_jl_tpu_torch.solver import (
    levenberg_marquardt_spmd, levenberg_marquardt_spmd_chunked)
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    STATUS_NAMES, levenberg_marquardt_jit)

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# The JAX tests/test_spmd.py problem and options.
PROBLEM = dict(ncams=11, npnts=400, obs_per_pnt=4, seed=3, perturb=2e-2,
               noise_px=1.0)
OPTS = dict(max_iters=25, pcg_max_iters=60, lam0_mode="diag", satol=0.0,
            srtol=0.0, atol=0.0, rtol=1e-5, oatol=0.0, ortol=1e-4)
HISTORIES = ("hist_obj", "hist_gnorm", "hist_lam", "hist_cg")
# The two-rank cases: (route, dtype) solves, the chunked one, and a rank
# whose gates pick another route.
ROUTE_CASES = [("fused", "float32"), ("sorted", "float32"),
               ("scatter_split", "float32"), ("sorted_relin", "float32"),
               ("fused", "float64")]
TIMEOUT_S = 120

# One rank of the two-rank runs: `python -c WORKER addr rank tmpdir`. Prints
# one JSON line with each case's result.
WORKER = r"""
import json, sys
from datetime import timedelta
import torch.distributed as dist
from bundleadjustment_jl_tpu_torch.io import synthetic_bal
from bundleadjustment_jl_tpu_torch.ops import normal
from bundleadjustment_jl_tpu_torch.parallel import shard_problem_kminor
from bundleadjustment_jl_tpu_torch.solver import (
    levenberg_marquardt_spmd, levenberg_marquardt_spmd_chunked)

addr, rank, tmp, spec = sys.argv[1], int(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=2,
                        timeout=timedelta(seconds=60))
opts = spec["opts"]


def problem(dtype):
    return synthetic_bal(dtype=dtype, device="cpu", **spec["problem"])[0]


def row(r):
    return dict(status=r.status, iterations=r.iterations,
                objective=r.objective, naccepts=r.naccepts,
                cams=r.cams.double().ravel().tolist(),
                points=r.points.double().ravel().tolist(),
                **{k: getattr(r, k).astype(float).tolist() for k in (
                    "hist_obj", "hist_gnorm", "hist_lam", "hist_cg")})


def forced(route):
    for k, v in normal.FORCE_ROUTE[route].items():
        setattr(normal, k, v)


defaults = {k: getattr(normal, k) for k in (
    "CAM_SCATTER", "GATHER_TABLE_MAX_CAMS", "CAM_SCATTER_MAX_CAMS",
    "GATHER_DIRECT_MAX_BYTES")}
out = {}
for route, dtype in spec["routes"]:
    forced(route)
    sp = shard_problem_kminor(problem(dtype), 2)
    out[f"{route}/{dtype}"] = row(levenberg_marquardt_spmd(sp, **opts))
    for k, v in defaults.items():
        setattr(normal, k, v)
sp = shard_problem_kminor(problem("float32"), 2)
one = levenberg_marquardt_spmd(sp, **opts)
chk = levenberg_marquardt_spmd_chunked(sp, chunk_iters=3, **opts)
part = levenberg_marquardt_spmd_chunked(
    sp, chunk_iters=3, checkpoint_dir=tmp, **dict(opts, max_iters=6))
resumed = levenberg_marquardt_spmd_chunked(
    sp, chunk_iters=3, checkpoint_dir=tmp, resume=True, **opts)
out["one"], out["chunked"] = row(one), row(chk)
out["part"], out["resumed"] = row(part), row(resumed)
if rank == 1:
    normal.CAM_SCATTER = False
try:
    levenberg_marquardt_spmd(sp, **opts)
    out["mismatch"] = None
except RuntimeError as err:
    out["mismatch"] = str(err)
dist.destroy_process_group()
print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("spmd_ckpt")


@pytest.fixture(scope="module")
def two_ranks(ckpt_dir, tmp_path_factory):
    """Both ranks' results of the two-rank runs (WORKER), each rank a
    process on the CPU over gloo. Each rank's output goes to a file, so
    that no rank waits on a pipe that this process reads only after the
    other rank's."""
    tmp = str(ckpt_dir)
    out_dir = tmp_path_factory.mktemp("spmd_out")
    addr = f"tcp://127.0.0.1:{_free_port()}"
    spec = json.dumps(dict(problem=PROBLEM, opts=OPTS, routes=ROUTE_CASES))
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    files = [open(out_dir / f"rank{rank}.json", "w+") for rank in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, addr, str(rank), tmp, spec], cwd=ROOT,
        env=env, stdout=files[rank], stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for proc, out in zip(procs, files):
            _, err = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, err[-4000:]
            out.seek(0)
            outs.append(json.loads(out.read().strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        for out in files:
            out.close()
    return outs


@pytest.fixture
def one_rank():
    """A gloo process group of one rank in this process."""
    timeout = timedelta(seconds=60)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timeout)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.fixture
def force(monkeypatch):
    def force_route(route):
        for k, v in normal.FORCE_ROUTE[route].items():
            monkeypatch.setattr(normal, k, v)
    return force_route


def port_problem(dtype="float32", **kw):
    return synthetic_bal(dtype=dtype, device="cpu", **{**PROBLEM, **kw})[0]


def assert_same(got, ref, start=0):
    """``got`` bit-identical to ``ref`` (tensors or the workers' lists)."""
    assert (got["status"], got["iterations"], got["objective"]) == (
        ref["status"], ref["iterations"], ref["objective"])
    n = ref["iterations"]
    for k in HISTORIES:
        np.testing.assert_array_equal(np.asarray(got[k])[start:n],
                                      np.asarray(ref[k])[start:n])
    for k in ("cams", "points"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(ref[k]))


def as_row(res) -> dict:
    return dict(status=res.status, iterations=res.iterations,
                objective=res.objective,
                cams=res.cams.double().ravel().numpy(),
                points=res.points.double().ravel().numpy(),
                **{k: getattr(res, k) for k in HISTORIES})


# ------------------------------------------------------------------ shards
@pytest.mark.parametrize("ndev", [2, 3, 4])
def test_shards_match_jax(ndev):
    jp, _ = jax_synthetic(dtype=jnp.float32, **PROBLEM)
    tp = port_problem()
    ref = jax_shard(jp, ndev)
    sp = shard_problem_kminor(tp, ndev)
    np.testing.assert_array_equal(sp.point_offsets, ref.point_offsets)
    np.testing.assert_array_equal(sp.npnts_loc, ref.npnts_loc)
    np.testing.assert_array_equal(sp.nobs_loc, ref.nobs_loc)
    assert (sp.npnts, sp.nobs, sp.ndev) == (ref.npnts, ref.nobs, ndev)
    arrs = ref.arrays
    np.testing.assert_array_equal(sp.cams, np.asarray(arrs.cams))
    for d in range(ndev):
        lp = sp.local(d, "cpu")
        n, npl = int(sp.nobs_loc[d]), int(sp.npnts_loc[d])
        assert lp.nobs == n and lp.npnts == npl and lp.ncams == tp.ncams
        # padding: none but the global problem's, on the last shard
        assert lp.nobs_pad == n + (tp.nobs_pad - tp.nobs
                                   if d == ndev - 1 else 0)
        for k in ("cam_idx", "pnt_idx", "pt2d", "w"):
            np.testing.assert_array_equal(getattr(lp, k)[:n].numpy(),
                                          np.asarray(getattr(arrs, k)[d])[:n])
        np.testing.assert_array_equal(lp.points.numpy(),
                                      np.asarray(arrs.points[d])[:npl])
        np.testing.assert_array_equal(lp.pnt_starts[:npl].numpy(),
                                      np.asarray(arrs.pnt_starts[d])[:npl])
        # the camera order of the true rows, and each camera's start
        perm = lp.cam_perm.numpy()
        jperm = np.asarray(arrs.cam_perm[d])
        np.testing.assert_array_equal(perm[perm < n], jperm[jperm < n])
        np.testing.assert_array_equal(
            lp.cam_starts[:tp.ncams].numpy(),
            np.asarray(arrs.cam_starts[d])[:tp.ncams])
        assert lp is sp.local(d, "cpu")         # built once


def test_points_split_and_join_round_trip():
    tp = port_problem()
    sp = shard_problem_kminor(tp, 3)
    parts = [sp.split_points(tp.points, d) for d in range(3)]
    assert [len(p) for p in parts] == sp.npnts_loc.tolist()
    assert torch.equal(sp.join_points(parts), tp.points)
    one = shard_problem_kminor(tp, 1)
    assert torch.equal(one.global_points(tp.points), tp.points)
    with pytest.raises(ValueError, match="process group"):
        sp.global_points(parts[0])


def test_shard_refusals():
    tp = port_problem(npnts=3, obs_per_pnt=2)
    with pytest.raises(ValueError, match="npnts=3 < ndev=4"):
        shard_problem_kminor(tp, 4)
    tp.w[0] = 0.5
    with pytest.raises(ValueError, match="weigh 1"):
        shard_problem_kminor(tp, 2)


# ------------------------------------------------------------- one rank
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("route", ["fused", "sorted"])
def test_one_rank_bit_identical_to_one_shot(one_rank, force, route, dtype):
    force(route)
    tp = port_problem(dtype, pad_obs_to=512)
    ref = levenberg_marquardt_jit(tp, **OPTS)
    got = levenberg_marquardt_spmd(shard_problem_kminor(tp, 1), one_rank,
                                   **OPTS)
    assert spmdctx.GROUP is None               # restored after the solve
    assert got.naccepts == ref.naccepts
    assert_same(as_row(got), as_row(ref))
    assert got.iterations > 5


def test_one_rank_b1_past_shared_memory_takes_the_wcw_walk(one_rank, force,
                                                          monkeypatch):
    """Route B1 with the camera sums past shared memory
    (``plans.SMEM_BUDGET`` 0): the rank re-derives W for W C W' | W t
    (``cam_relin_wcw_rhs``) in place of reading it, and the spmd solve is
    bit-identical to the one-shot one, which is bit-identical to the solve
    that reads W (``fused_schur.relin_wcw_rhs`` off)."""
    force("scatter_split")
    tp = port_problem("float32", pad_obs_to=512)
    monkeypatch.setattr(plans, "SMEM_BUDGET", 0)
    with monkeypatch.context() as m:
        m.setattr(fs, "relin_wcw_rhs", lambda *args: False)
        ref = levenberg_marquardt_jit(tp, **OPTS)
    calls = []
    walk = normal.KERNELS.cam_relin_wcw_rhs

    def spy(*args, **kwargs):
        calls.append(1)
        return walk(*args, **kwargs)
    monkeypatch.setattr(normal, "KERNELS",
                        normal.KERNELS._replace(cam_relin_wcw_rhs=spy))
    one = levenberg_marquardt_jit(tp, **OPTS)
    n = len(calls)
    assert n == one.iterations > 5
    got = levenberg_marquardt_spmd(shard_problem_kminor(tp, 1), one_rank,
                                   **OPTS)
    assert len(calls) == 2 * n
    assert_same(as_row(one), as_row(ref))
    assert_same(as_row(got), as_row(one))


def test_float64_runs_the_plain_stages(one_rank, monkeypatch):
    """Stands for the JAX `tests/test_spmd.py::test_spmd_rejects_float64`.
    The JAX driver refuses float64 with its Pallas kernels on (they
    accumulate in float32). The port departs from it on purpose: a float64
    solve takes the plain stages (`normal.solve_stages`, as every driver
    of the port does), whose camera sums carry the same all-reduces, and
    it makes the one-shot solve bit for bit here, both drivers with the
    kernels switched on."""
    jp, _ = jax_synthetic(ncams=4, npnts=30, obs_per_pnt=3, seed=1,
                          dtype=jnp.float64)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("obs",))
    old = pallas_schur.PALLAS_MODE
    try:
        pallas_schur.set_mode(True)
        with pytest.raises(ValueError, match="float64"):
            jax_spmd(jax_shard(jp, 2), mesh, max_iters=2)
    finally:
        pallas_schur.set_mode(old)
    monkeypatch.setattr(normal, "PALLAS_MODE", True)
    tp = port_problem("float64")
    got = levenberg_marquardt_spmd(shard_problem_kminor(tp, 1), **OPTS)
    ref = levenberg_marquardt_jit(tp, **OPTS)
    assert got.cams.dtype == torch.float64
    assert_same(as_row(got), as_row(ref))


def test_chunked_one_rank_max_time_and_callback(one_rank, tmp_path):
    sp = shard_problem_kminor(port_problem(), 1)
    seen = []
    res = levenberg_marquardt_spmd_chunked(sp, chunk_iters=4,
                                           callback=seen.append, **OPTS)
    assert [row["iter"] for row in seen][-1] == res.iterations
    assert seen[-1]["status"] == STATUS_NAMES[res.status]
    late = levenberg_marquardt_spmd_chunked(sp, max_time=0.0, **OPTS)
    assert (STATUS_NAMES[late.status], late.iterations) == ("max_time", 0)


def test_spmd_refusals(one_rank):
    sp = shard_problem_kminor(port_problem(), 1)
    with pytest.raises(ValueError, match="PCG steps only"):
        levenberg_marquardt_spmd(sp, use_dense=True, **OPTS)
    with pytest.raises(TypeError, match="unknown options"):
        levenberg_marquardt_spmd(sp, mesh=2)
    two = shard_problem_kminor(port_problem(), 2)
    with pytest.raises(ValueError, match="2 shards but the group has 1"):
        levenberg_marquardt_spmd(two, **OPTS)


def test_spmd_needs_a_process_group():
    assert not dist.is_initialized()
    sp = shard_problem_kminor(port_problem(), 1)
    with pytest.raises(RuntimeError, match="process group"):
        levenberg_marquardt_spmd(sp, **OPTS)


def test_spmd_hooks_are_identity_at_one_rank(one_rank):
    """The hooks copy and return; in a 2-byte dtype they reduce in
    float32 and round back, exactly at one rank."""
    x = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    assert spmdctx.psum(x) is x                 # no group: x itself
    with spmdctx.using(one_rank):
        for fn in (spmdctx.psum, spmdctx.pmax):
            y = fn(x)
            assert y is not x and y.dtype == x.dtype and torch.equal(y, x)
        t = normal.stages_for(normal.PLAIN, torch.bfloat16)
        assert isinstance(t, normal._HalfSpmdStages)
        assert normal.stages_for(t, torch.bfloat16) is t
    # a 2-byte table made outside the solve has no all-reduce to take
    half = normal.stages_for(normal.PLAIN, torch.bfloat16)
    with spmdctx.using(one_rank), pytest.raises(ValueError, match="2-byte"):
        normal.stages_for(half, torch.bfloat16)


# ------------------------------------------------------------ two ranks
@pytest.mark.parametrize("route,dtype", ROUTE_CASES,
                         ids=[f"{r}-{d}" for r, d in ROUTE_CASES])
def test_two_ranks_match_each_other_and_one_shot(two_ranks, force, route,
                                                 dtype):
    key = f"{route}/{dtype}"
    a, b = two_ranks[0][key], two_ranks[1][key]
    assert a == b                        # every value, bit for bit
    force(route)
    ref = levenberg_marquardt_jit(port_problem(dtype), **OPTS)
    assert (a["status"], a["iterations"]) == (ref.status, ref.iterations)
    assert a["iterations"] > 5
    if dtype == "float64":
        # The same decisions: each step accepted (lambda falls) or not
        # alike, the same CG steps; lambda_0 is 1e-3 max diag(H), whose
        # camera sums are reassociated, so the rows agree to rounding.
        n = ref.iterations
        lam = np.asarray(a["hist_lam"][:n])
        np.testing.assert_array_equal(np.diff(lam) < 0,
                                      np.diff(ref.hist_lam[:n]) < 0)
        np.testing.assert_allclose(lam, ref.hist_lam[:n], rtol=1e-12)
        np.testing.assert_array_equal(a["hist_cg"], ref.hist_cg)
        assert a["naccepts"] == ref.naccepts
        assert a["objective"] == pytest.approx(ref.objective, rel=1e-9)
    else:
        assert a["objective"] == pytest.approx(ref.objective, rel=1e-4)
    np.testing.assert_allclose(a["cams"], ref.cams.double().ravel(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(a["points"], ref.points.double().ravel(),
                               rtol=1e-3, atol=1e-3)


def test_two_ranks_chunked_and_resumed(two_ranks, ckpt_dir):
    for out in two_ranks:
        assert_same(out["chunked"], out["one"])
        assert out["part"]["iterations"] == 6
        assert_same(out["resumed"], out["one"], start=6)
    assert two_ranks[0]["resumed"] == two_ranks[1]["resumed"]
    # rank 0 wrote the JAX format: the JAX package reads the cameras and
    # the global points of the last step of the run stopped at 6
    from bundleadjustment_jl_tpu.utils.checkpoint import (
        latest_checkpoint, load_checkpoint)
    ck = load_checkpoint(latest_checkpoint(str(ckpt_dir)))
    assert int(ck["iteration"]) == two_ranks[0]["resumed"]["iterations"]
    np.testing.assert_array_equal(
        np.asarray(ck["points"], np.float64).ravel(),
        two_ranks[0]["resumed"]["points"])


def test_two_ranks_refuse_a_route_mismatch(two_ranks):
    """A rank whose gates pick another route raises on every rank before
    the solve's first collective, where it would hang the others."""
    for out in two_ranks:
        assert out["mismatch"] is not None
        assert "the ranks' solves differ" in out["mismatch"]


def test_two_ranks_match_the_jax_spmd_driver(two_ranks):
    """The JAX spmd driver on two of the conftest's virtual CPU devices
    with its Pallas kernels (interpret mode, camera scatter: route A),
    by the JAX test's bar."""
    jp, _ = jax_synthetic(dtype=jnp.float32, **PROBLEM)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("obs",))
    old = (pallas_schur.PALLAS_MODE, pallas_schur.INTERPRET,
           pallas_schur.CAM_SCATTER)
    try:
        pallas_schur.set_mode(True)
        pallas_schur.INTERPRET = True
        pallas_schur.CAM_SCATTER = True
        ref = jax_spmd(jax_shard(jp, 2, mesh=mesh), mesh, **OPTS)
    finally:
        (pallas_schur.PALLAS_MODE, pallas_schur.INTERPRET,
         pallas_schur.CAM_SCATTER) = old
    got = two_ranks[0]["fused/float32"]
    assert STATUS_NAMES[got["status"]] == JAX_NAMES[int(ref.status)]
    assert got["iterations"] == int(ref.iterations)
    robj = float(ref.objective)
    assert abs(got["objective"] - robj) <= 1e-4 * max(1.0, robj)
    np.testing.assert_allclose(got["cams"],
                               np.asarray(ref.cams).astype(float).ravel(),
                               rtol=1e-3, atol=1e-3)


# ------------------------------------------------------------ partition
@pytest.mark.parametrize("n_parts", [2, 4])
def test_partition_matches_jax(n_parts):
    jp, _ = jax_synthetic(ncams=16, npnts=120, obs_per_pnt=4, noise_px=0.3,
                          perturb=2e-3, seed=80)
    tp = BAProblem.from_numpy({k: np.asarray(getattr(jp, k))
                               for k in BAProblem.FIELDS}, device="cpu")
    ci = np.asarray(jp.cam_idx[:jp.nobs])
    part = greedy_camera_partition(ci, tp.ncams, n_parts)
    ref = jax_partition.greedy_camera_partition(ci, jp.ncams, n_parts)
    np.testing.assert_array_equal(part, ref)
    assert part.dtype == np.int32
    assert partition_stats(tp, part, n_parts) == \
        jax_partition.partition_stats(jp, ref, n_parts)
    assert partition_stats(tp, part, n_parts)["imbalance"] < 1.5
