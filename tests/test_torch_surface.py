"""The port's surface against the JAX package, on the CPU: the native BAL
reader and ``write_bal``, the AD Jacobian cross-check, the problem suites,
the campaign runner, the CLI and the profiler's trace.

Bars:

- IO: the native parser's arrays equal the numpy reader's and the JAX
  reader's exactly (both parse the same text with strtod); a file written
  by one package reads back in the other to the same arrays (``%.16e``
  round-trips float64 exactly).
- Jacobian: ``jacfwd`` blocks equal the port's analytic chain and the JAX
  ``jacobian_blocks_ad`` to rel 1e-10 of the largest entry (float64;
  forward-mode AD and the closed form sum in other orders).
- Suites, padding, tables, stats files and profiles: equal to the JAX
  package's on the same inputs (the same seeds give the same arrays).
- CLI: ``--json`` has the JAX CLI's keys, status and iterations, and its
  objective to rel 1e-6 (float64 on the CPU, the JAX CLI's default there).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu import cli as jax_cli
from bundleadjustment_jl_tpu.benchmark import problems as jax_problems
from bundleadjustment_jl_tpu.benchmark import runner as jax_runner
from bundleadjustment_jl_tpu.io.bal import read_bal as jax_read_bal
from bundleadjustment_jl_tpu.io.bal import write_bal as jax_write_bal
from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.ops.jacobian import (
    jacobian_blocks_ad as jax_jacobian_ad)
from bundleadjustment_jl_tpu_torch import cli
from bundleadjustment_jl_tpu_torch.benchmark import problems, runner
from bundleadjustment_jl_tpu_torch.io import bal, native
from bundleadjustment_jl_tpu_torch.io.bal import read_bal, write_bal
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops.chain import linearize
from bundleadjustment_jl_tpu_torch.ops.jacobian import jacobian_blocks_ad
from bundleadjustment_jl_tpu_torch.solver import LMOptions, levenberg_marquardt
from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    STATUS_NAMES, levenberg_marquardt_jit, levenberg_marquardt_jit_chunked)
from bundleadjustment_jl_tpu_torch.utils.profiling import trace

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

FIXTURE = "tests/fixtures/problem-24-800-pre.txt.bz2"
FIELDS = ("cams", "points", "cam_idx", "pnt_idx", "pt2d", "w", "pnt_starts",
          "cam_perm", "cam_starts")


def to_port(jp):
    return BAProblem.from_numpy(
        {**{k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS},
         "name": jp.name}, device="cpu")


def assert_same_problem(tp, jp):
    assert (tp.ncams, tp.npnts, tp.nobs, tp.nobs_pad, tp.name) == (
        jp.ncams, jp.npnts, jp.nobs, jp.nobs_pad, jp.name)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).cpu().numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


# ---------------------------------------------------------------- IO
def test_native_reader_equals_numpy_and_jax_readers():
    assert native.NATIVE_BZ2
    raw_native = native.parse_bal_native(FIXTURE)
    raw_numpy = bal._read_raw(FIXTURE)
    for a, b in zip(raw_native, raw_numpy):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert native.library_path().exists()
    assert native.library_path().parent == native.BUILD_DIR
    assert_same_problem(read_bal(FIXTURE, device="cpu"),
                        jax_read_bal(FIXTURE))
    # f32 and the dtype names
    p32 = read_bal(FIXTURE, dtype="float32", device="cpu")
    assert p32.dtype == torch.float32
    np.testing.assert_array_equal(
        p32.cams.numpy(), np.asarray(jax_read_bal(FIXTURE,
                                                  dtype=np.float32).cams))


@pytest.mark.parametrize("suffix", [".txt", ".txt.bz2"])
def test_write_bal_round_trips_between_packages(tmp_path, suffix):
    jp, _ = jax_synthetic(ncams=5, npnts=30, obs_per_pnt=3, seed=3)
    tp = to_port(jp)
    port_file = str(tmp_path / f"port{suffix}")
    jax_file = str(tmp_path / f"jax{suffix}")
    write_bal(port_file, tp)
    jax_write_bal(jax_file, jp)
    if suffix == ".txt":
        assert open(port_file).read() == open(jax_file).read()
    for path in (port_file, jax_file):
        back = read_bal(path, pad_obs_to=128, name=jp.name, device="cpu")
        assert_same_problem(back, jp)
        assert_same_problem(to_port(jax_read_bal(path, name=jp.name)), jp)


# ---------------------------------------------------------------- Jacobian
def test_jacfwd_blocks_match_the_chain_and_jax():
    jp, _ = jax_synthetic(ncams=6, npnts=40, obs_per_pnt=3, perturb=1e-2,
                          seed=4)
    tp = to_port(jp)
    tp.cams[0, :3] = 0.0          # the small-angle branch
    jcams = jnp.asarray(tp.cams.numpy())
    ad = jacobian_blocks_ad(tp)
    chain = linearize(tp.cams[tp.cam_idx.long()],
                      tp.points[tp.pnt_idx.long()], tp.pt2d, tp.w)[1:]
    ref = jax_jacobian_ad(jp, cams=jcams)
    for a, c, r in zip(ad, chain, ref):
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-10 * scale)
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=0,
                                   atol=1e-10 * scale)
    assert ad[0].shape == (tp.nobs_pad, 2, 9)
    assert ad[1].shape == (tp.nobs_pad, 2, 3)


# ---------------------------------------------------------------- suites
def test_synthetic_suite_names_sizes_and_arrays():
    got = list(problems.synthetic_suite(max_nobs=50_000, device="cpu"))
    ref = list(jax_problems.synthetic_suite(max_nobs=50_000))
    assert [n for n, _ in got] == [n for n, _ in ref] == [
        "LadyBug-49-7776-synth", "LadyBug-73-11032-synth"]
    for (_, tp), (_, jp) in zip(got, ref):
        assert_same_problem(tp, jp)
    assert problems.BAL_SIZES == jax_problems.BAL_SIZES


def test_bucket_and_padding_match_jax():
    for n in (1, 3, 77, 100, 1024, 1025, 5000, 123456):
        assert problems._bucket(n) == jax_problems._bucket(n)
    jp, _ = jax_synthetic(ncams=9, npnts=130, obs_per_pnt=4, noise_px=0.5,
                          perturb=1e-2, seed=5)
    tp = to_port(jp)
    padded = problems.pad_problem(tp, ncams_to=16, npnts_to=200,
                                  nobs_pad_to=1024)
    assert_same_problem(padded, jax_problems.pad_problem(
        jp, ncams_to=16, npnts_to=200, nobs_pad_to=1024))
    assert_same_problem(problems.pad_to_buckets(tp),
                        jax_problems.pad_to_buckets(jp))
    assert problems.pad_problem(tp) is tp
    # Padding keeps the solution (the JAX tests/test_padding.py bar).
    kw = dict(max_iters=40, satol=0.0, srtol=0.0)
    r1 = levenberg_marquardt_jit(tp, **kw)
    r2 = levenberg_marquardt_jit(padded, **kw)
    assert r2.iterations == r1.iterations
    assert r2.objective == pytest.approx(r1.objective, rel=1e-9)
    assert torch.equal(r2.cams[tp.ncams:], padded.cams[tp.ncams:])


def test_bal_suite_reads_a_local_directory(tmp_path):
    d = tmp_path / "LadyBug"
    d.mkdir()
    jp, _ = jax_synthetic(ncams=4, npnts=20, obs_per_pnt=3, seed=6)
    jax_write_bal(str(d / "problem-4-20-pre.txt"), jp)
    (d / "notes.txt").write_text("not a problem")
    got = list(problems.bal_suite(str(tmp_path), device="cpu"))
    ref = list(jax_problems.bal_suite(str(tmp_path)))
    assert [n for n, _ in got] == [n for n, _ in ref] == [
        "LadyBug/problem-4-20-pre.txt"]
    assert_same_problem(got[0][1], ref[0][1])


# ---------------------------------------------------------------- runner
def _tiny(seed):
    jp, _ = jax_synthetic(ncams=5, npnts=30, obs_per_pnt=3, noise_px=0.3,
                          perturb=2e-3, seed=seed)
    return f"tiny-{seed}", to_port(jp)


def test_campaign_tables_stats_and_profiles(tmp_path):
    solvers = {
        "lm_pcg": lambda p: levenberg_marquardt(
            p, LMOptions(solver="pcg", max_iters=40)),
        # (the chunked driver times itself: the one-shot's time is NaN)
        "jit_pcg": lambda p: levenberg_marquardt_jit_chunked(p,
                                                             max_iters=40),
    }
    rows = runner.run_campaign(solvers, [_tiny(31), _tiny(32)],
                               logger=lambda s: None)
    assert len(rows) == 4
    assert [r["status"] for r in rows] == ["small_obj_change"] * 2 + [
        "max_iter"] * 2
    for host, jit in (rows[:2], rows[2:]):     # the drivers agree
        for k in ("status", "iterations", "neval_residual", "neval_jac"):
            assert host[k] == jit[k]
    assert all(set(r) == set(runner.COLUMNS) for r in rows)
    assert runner.COLUMNS == jax_runner.COLUMNS
    assert runner.SOLVED_STATUSES == jax_runner.SOLVED_STATUSES
    assert runner.markdown_table(rows) == jax_runner.markdown_table(rows)
    assert runner.latex_table(rows) == jax_runner.latex_table(rows)
    assert runner.markdown_table(rows).count("\n") == len(rows) + 1
    path = str(tmp_path / "stats.jsonl")
    runner.save_stats(rows, path)
    assert runner.load_stats(path) == jax_runner.load_stats(path) == rows
    jax_path = str(tmp_path / "jax.jsonl")
    jax_runner.save_stats(rows, jax_path)
    assert open(path).read() == open(jax_path).read()
    for cost in ("elapsed_s", "neval_residual", "neval_jac"):
        taus, prof = runner.performance_profile(rows, cost)
        jtaus, jprof = jax_runner.performance_profile(rows, cost)
        np.testing.assert_array_equal(taus, jtaus)
        assert prof.keys() == jprof.keys()
        for k in prof:
            np.testing.assert_array_equal(prof[k], jprof[k])
    assert runner.performance_profile([]) is None


def test_campaign_records_exceptions():
    def boom(problem):
        raise RuntimeError("synthetic failure")

    def too_big(problem):
        raise MemoryError("gate")

    rows = runner.run_campaign({"bad": boom, "big": too_big},
                               [_tiny(31)], logger=lambda s: None)
    assert [r["status"] for r in rows] == ["exception", "capability"]
    assert rows[0]["error"] == "RuntimeError('synthetic failure')"
    ref = jax_runner.run_campaign({"bad": boom, "big": too_big},
                                  [_tiny(31)], logger=lambda s: None)
    for r, j in zip(rows, ref):
        assert set(r) == set(j)
        assert {k: v for k, v in r.items() if k != "elapsed_s"} == {
            k: v for k, v in j.items() if k != "elapsed_s"}


# ---------------------------------------------------------------- CLI
def _json_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("args", [
    ["synthetic:ncams=5,npnts=40,obs_per_pnt=3,seed=3", "--max-iters", "40"],
    ["synthetic:ncams=5,npnts=40,obs_per_pnt=4,seed=3", "--driver", "host",
     "--solver", "dense", "--max-iters", "60"],
    [FIXTURE, "--max-iters", "20"],
])
def test_cli_json_matches_jax_cli(capsys, args):
    rc = cli.main(args + ["--json", "--device", "cpu"])
    got = _json_line(capsys)
    jrc = jax_cli.main(args + ["--json"])
    ref = _json_line(capsys)
    assert rc == jrc
    assert set(got) == set(ref)
    for k in ("problem", "status", "iterations", "solver", "driver",
              "dtype"):
        assert got[k] == ref[k], k
    assert got["backend"] == "cpu"
    assert got["objective"] == pytest.approx(ref["objective"], rel=1e-6)


def test_cli_saves_and_reads_back(tmp_path, capsys):
    out = str(tmp_path / "refined.txt.bz2")
    rc = cli.main([FIXTURE, "--max-iters", "10", "--json", "--device", "cpu",
                   "--save", out, "--verbose"])
    text = capsys.readouterr().out
    stats = json.loads(text.strip().splitlines()[-2])
    assert f"# wrote {out}" in text and "iter" in text
    refined = read_bal(out, device="cpu")
    start = read_bal(FIXTURE, device="cpu")
    assert (refined.ncams, refined.npnts, refined.nobs) == (
        start.ncams, start.npnts, start.nobs)
    res = levenberg_marquardt_jit(start, max_iters=10)
    assert torch.equal(refined.cams, res.cams)
    assert rc == (0 if stats["status"] in cli.SOLVED else 1)


def test_cli_dtype_defaults_and_half(capsys):
    cli.main(["synthetic:ncams=5,npnts=40,obs_per_pnt=3,seed=3", "--device",
              "cpu", "--dtype", "bf16", "--max-iters", "5", "--json"])
    assert _json_line(capsys)["dtype"] == "bf16"
    args = cli.build_parser().parse_args(["x"])
    assert args.device == "cuda" and args.dtype is None
    assert args.pallas and args.cam_scatter
    assert not cli.build_parser().parse_args(["x", "--no-pallas"]).pallas


# ------------------------------------------------------- multi-device CLI
SPMD_ARGS = ["synthetic:ncams=5,npnts=40,obs_per_pnt=3,seed=3", "--device",
             "cpu", "--max-iters", "40", "--json"]


def test_cli_spmd_runs_in_a_one_rank_group(capsys):
    """``--driver spmd`` without torchrun makes a one-rank group (a
    localhost store), solves as the one-shot driver does, bit for bit,
    and takes the group down after."""
    import torch.distributed as dist
    cli.main([*SPMD_ARGS, "--driver", "jit"])
    ref = _json_line(capsys)
    assert cli.main([*SPMD_ARGS, "--driver", "spmd", "--mesh", "1"]) == 0
    got = _json_line(capsys)
    assert (got["driver"], got["ranks"]) == ("spmd", 1)
    for k in ("status", "objective", "iterations", "dual_feas"):
        assert got[k] == ref[k], k
    assert not dist.is_initialized()


def test_cli_spmd_checkpoints_run_the_chunked_driver(tmp_path, capsys):
    ck = tmp_path / "ck"
    cli.main([*SPMD_ARGS, "--driver", "spmd", "--checkpoint-dir", str(ck),
              "--chunk-iters", "4"])
    got = _json_line(capsys)
    assert got["driver"] == "spmd" and list(ck.glob("step-*.npz"))
    cli.main([*SPMD_ARGS, "--driver", "jit"])
    assert got["objective"] == _json_line(capsys)["objective"]


@pytest.mark.parametrize("args,error,match", [
    (["--driver", "spmd", "--mesh", "2"], ValueError,
     "--mesh 2 must equal the world size 1"),
    (["--driver", "jit", "--mesh", "2"], ValueError,
     "must equal the world size 1"),
    (["--driver", "spmd", "--solver", "dense"], ValueError,
     "PCG steps only"),
], ids=["mesh_not_world", "jit_mesh_not_world", "spmd_dense"])
def test_cli_multi_device_refusals(args, error, match):
    import torch.distributed as dist
    with pytest.raises(error, match=match):
        cli.main([*SPMD_ARGS, *args])
    assert not dist.is_initialized()


@pytest.mark.parametrize("args", [
    ["--mesh", "1"], ["--driver", "chunked", "--mesh", "4"],
    ["--driver", "host", "--mesh", "1"],
    ["--driver", "host", "--solver", "cgls", "--mesh", "1"],
    ["--solver", "dense", "--mesh", "1"]],
    ids=["mesh_without_spmd", "mesh_chunked", "mesh_host", "mesh_host_cgls",
         "mesh_dense"])
def test_cli_mesh_runs_like_no_mesh(args, capsys):
    """``--mesh N`` with the host, one-shot and chunked drivers makes a
    one-rank group, solves the mesh shard with any step solver and prints
    the stats of the run without a mesh; ``--mesh`` other than the world
    size raises (``chunked --mesh 4`` here, at world 1)."""
    import torch.distributed as dist
    if args[-1] != "1":
        with pytest.raises(ValueError, match="must equal the world size 1"):
            cli.main([*SPMD_ARGS, *args])
        args = [*args[:-1], "1"]
    assert cli.main([*SPMD_ARGS, *args]) == 0
    got = _json_line(capsys)
    assert not dist.is_initialized()
    cli.main([*SPMD_ARGS, *args[:-2]])
    ref = _json_line(capsys)
    assert got.keys() == ref.keys()
    for k in ref.keys() - {"elapsed_s"}:
        assert got[k] == ref[k], k


def test_cli_multihost_reads_the_env(monkeypatch, capsys):
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     RANK="0", WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    assert cli.main([*SPMD_ARGS, "--driver", "spmd", "--multihost"]) == 0
    assert _json_line(capsys)["ranks"] == 1
    assert not dist.is_initialized()


@pytest.mark.parametrize("driver", ["jit", "chunked", "host"])
def test_cli_multihost_meshes_every_driver(driver, monkeypatch, capsys):
    """``--multihost`` without ``--mesh`` and without spmd: the group from
    the environment, the mesh over the world (one rank here), the stats of
    the run without it."""
    import socket

    import torch.distributed as dist
    cli.main([*SPMD_ARGS, "--driver", driver])
    ref = _json_line(capsys)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     RANK="0", WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    assert cli.main([*SPMD_ARGS, "--driver", driver, "--multihost"]) == 0
    got = _json_line(capsys)
    assert not dist.is_initialized()
    for k in ("status", "objective", "iterations", "dual_feas", "driver"):
        assert got[k] == ref[k], k


def test_cli_spmd_under_torchrun_env_two_ranks(tmp_path):
    """Two CLI processes with torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT): one gloo group, rank 0 prints the line;
    the solve makes the one-shot driver's decisions."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(cli.__file__).resolve().parents[1])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bundleadjustment_jl_tpu_torch", *SPMD_ARGS,
         "--driver", "spmd", "--mesh", "2"], cwd=root,
        env=dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 OMP_NUM_THREADS="2", PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err[-3000:]
            outs.append(out.strip())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    assert outs[1] == ""                            # rank 1 prints nothing
    got = json.loads(outs[0].splitlines()[-1])
    assert got["ranks"] == 2
    args = cli.build_parser().parse_args(SPMD_ARGS)
    ref = levenberg_marquardt_jit(synthetic_bal(
        device="cpu", **cli._parse_synthetic(args.problem))[0], max_iters=40)
    assert got["status"] == STATUS_NAMES[ref.status]
    assert got["iterations"] == ref.iterations
    assert got["objective"] == pytest.approx(ref.objective, rel=1e-9)


def test_cli_platform_is_the_device_option():
    """The JAX CLI's ``--platform`` names the port's ``--device``."""
    parse = cli.build_parser().parse_args
    assert parse(["x", "--platform", "cpu"]).device == "cpu"
    assert parse(["x", "--platform", "cuda"]).device == "cuda"
    assert jax_cli.build_parser().parse_args(
        ["x", "--platform", "cpu"]).platform == "cpu"


# ---------------------------------------------------------------- profiling
def test_trace_holds_the_solve_spans(tmp_path):
    """``trace()`` writes a Chrome trace that holds a solve's ``ba.*``
    spans beside the operators."""
    prob, _ = synthetic_bal(ncams=6, npnts=40, obs_per_pnt=3, seed=2,
                            device="cpu")
    with trace(str(tmp_path / "trace")) as prof:
        res = levenberg_marquardt_jit(prob, max_iters=20)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())[
        "traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("ba.solve") == 1
    assert names.count("ba.linearize") == res.naccepts + 1
    for stage in ("ba.reduce", "ba.pcg", "ba.backsub", "ba.trial"):
        assert names.count(stage) == res.iterations > 0
    assert any(e.key == "ba.pcg" for e in prof.key_averages())
