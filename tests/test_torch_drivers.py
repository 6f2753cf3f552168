"""The port's chunked and host-stepped drivers and its checkpoints against
the JAX package's, on the CPU, in float64 on the JAX XLA path.

- ``levenberg_marquardt_jit_chunked``: at ``chunk_iters`` 1, 3 and 25 the
  JAX chunked driver's status, iterations, accepts and CG steps,
  objective to rel 1e-9; bit-identical to the port's one-shot solve;
  ``max_time=0`` stops with status ``max_time`` after 0 iterations; a
  resumed run equals the uninterrupted one bit for bit; a checkpoint the
  port writes, resumed by the JAX driver, gives the JAX solve, and the
  reverse; the callback's rows are the JAX driver's; an unknown option
  raises ``TypeError``; W stored in bfloat16 or float16 ends within the
  JAX ``tests/test_lm_chunked.py`` bound (rel 2e-2) of the float32 solve.
- ``levenberg_marquardt`` (the host-stepped driver) with each ``solver``
  and lambda strategy, ``lam0_mode="diag"``, ``pcg_warm`` and
  ``max_iters=1``: the JAX host driver's status, iterations and evaluation
  counts and, row for row, its ``iter``, ``accepted`` and ``cg_iters``;
  the objective to rel 1e-9 at the end. The rows' values are held to what
  the step's conditioning allows: the two packages sum in other orders,
  and at small lambda the step solve amplifies that (S's condition number
  reaches ~1e11 here, which a dense Cholesky passes on in full). For
  ``pcg``, ``cgls`` and ``power``: obj to 1e-9 and ``||J'r||`` to 1e-8 of
  the first row's, lambda to rel 1e-6 (Nielsen's update carries rho's
  error), rho (a ratio near 1) to 1e-6 absolute; for ``dense``: 1e-7,
  1e-6, 1e-5 and 1e-5 (measured: 3e-9, 3e-8, 7e-7 and 7e-7).
- Resuming the host driver from a checkpoint the port wrote gives the JAX
  host driver's resumed solve.

The host driver's launch counts are checked in ``test_torch_solvers.py``.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.solver.lm import LMOptions as JaxOptions
from bundleadjustment_jl_tpu.solver.lm import (
    levenberg_marquardt as jax_host)
from bundleadjustment_jl_tpu.solver.lm_jit import (
    levenberg_marquardt_jit_chunked as jax_chunked)
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.solver import (
    LMOptions, LMResult, levenberg_marquardt)
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    MAX_ITER, MAX_TIME, STATUS_NAMES, levenberg_marquardt_jit,
    levenberg_marquardt_jit_chunked)

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

P9 = dict(ncams=8, npnts=60, obs_per_pnt=3, noise_px=0.4, perturb=2e-3,
          seed=9)
P10 = dict(ncams=6, npnts=40, obs_per_pnt=3, noise_px=0.3, perturb=2e-3,
           seed=10)
P12 = dict(ncams=6, npnts=40, obs_per_pnt=3, perturb=5e-2, seed=12)
ZERO_TOLS = dict(atol=0.0, rtol=0.0, restol=0.0, satol=0.0, srtol=0.0,
                 oatol=0.0, ortol=0.0)
OPTS = dict(max_iters=60, pcg_max_iters=200)
# The JAX tests/test_lm_chunked.py problem and facto_dtype options.
FACTO_PROBLEM = dict(ncams=8, npnts=120, obs_per_pnt=4, noise_px=0.5,
                     perturb=1e-2, seed=3)
FACTO_OPTS = dict(max_iters=60, lam0_mode="diag", satol=0.0, srtol=0.0,
                  atol=0.0, rtol=1e-5, oatol=0.0, ortol=1e-4)
# Row tolerances of the host driver's history (module docstring): obj and
# gnorm against the first row's, lam relative, rho absolute.
ROW_TOL = {"iterative": dict(obj=1e-9, gnorm=1e-8, lam=1e-6, rho=1e-6),
           "dense": dict(obj=1e-7, gnorm=1e-6, lam=1e-5, rho=1e-5)}


def to_port(jp):
    return BAProblem.from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS},
        device="cpu")


@pytest.fixture(scope="module")
def p9():
    jp, _ = jax_synthetic(**P9)
    return jp, to_port(jp)


def same_decisions(got, ref):
    """The port's LMJitResult against the JAX one: status, iterations,
    accepts and CG steps equal, objective to rel 1e-9."""
    n = int(ref.iterations)
    assert got.status == int(ref.status)
    assert got.iterations == n and got.naccepts == int(ref.naccepts)
    np.testing.assert_array_equal(got.hist_cg[:n],
                                  np.asarray(ref.hist_cg)[:n])
    assert got.objective == pytest.approx(float(ref.objective), rel=1e-9)


def bit_identical(a, b):
    assert (a.status, a.iterations, a.naccepts) == (
        b.status, b.iterations, b.naccepts)
    assert a.objective == b.objective and a.dual_feas == b.dual_feas
    for k in ("hist_obj", "hist_gnorm", "hist_lam", "hist_cg"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert torch.equal(a.cams, b.cams) and torch.equal(a.points, b.points)


# ------------------------------------------------------------ chunked
@pytest.mark.parametrize("chunk_iters", [1, 3, 25])
def test_chunked_matches_jax_chunked(p9, chunk_iters):
    jp, tp = p9
    ref = jax_chunked(jp, chunk_iters=chunk_iters, **OPTS)
    got = levenberg_marquardt_jit_chunked(tp, chunk_iters=chunk_iters,
                                          **OPTS)
    same_decisions(got, ref)
    assert np.isfinite(got.elapsed_time) and got.elapsed_time > 0


def test_chunked_equals_one_shot(p9):
    _, tp = p9
    one = levenberg_marquardt_jit(tp, **OPTS)
    bit_identical(levenberg_marquardt_jit_chunked(tp, chunk_iters=3, **OPTS),
                  one)
    assert np.isnan(one.elapsed_time)


def test_max_time_zero_stops_before_the_first_chunk(p9):
    _, tp = p9
    res = levenberg_marquardt_jit_chunked(tp, chunk_iters=5, max_time=0.0,
                                          **OPTS)
    assert res.status == MAX_TIME and res.iterations == 0
    assert res.status_name() == "max_time"


def test_resume_continues_exactly(p9, tmp_path):
    _, tp = p9
    full = levenberg_marquardt_jit_chunked(tp, chunk_iters=5, **OPTS)
    d = str(tmp_path / "ckpt")
    part = levenberg_marquardt_jit_chunked(
        tp, chunk_iters=5, checkpoint_dir=d, stop_after_chunks=1, **OPTS)
    assert part.iterations == 5 and part.status == MAX_ITER
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step-5.npz"]
    res = levenberg_marquardt_jit_chunked(tp, chunk_iters=5,
                                          checkpoint_dir=d, resume=True,
                                          **OPTS)
    assert (res.status, res.iterations) == (full.status, full.iterations)
    assert res.objective == full.objective
    assert torch.equal(res.cams, full.cams)
    assert torch.equal(res.points, full.points)
    n = full.iterations
    for k in ("hist_obj", "hist_gnorm", "hist_lam", "hist_cg"):
        np.testing.assert_array_equal(getattr(res, k)[5:n],
                                      getattr(full, k)[5:n])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_between_packages(p9, tmp_path, writer):
    """A checkpoint written by one package's chunked driver, resumed by the
    other's, gives that package's uninterrupted solve."""
    jp, tp = p9
    d = str(tmp_path / "ckpt")
    write = levenberg_marquardt_jit_chunked if writer == "port" else \
        jax_chunked
    write(tp if writer == "port" else jp, chunk_iters=4, checkpoint_dir=d,
          stop_after_chunks=1, **OPTS)
    if writer == "port":
        full = jax_chunked(jp, chunk_iters=4, **OPTS)
        res = jax_chunked(jp, chunk_iters=4, checkpoint_dir=d, resume=True,
                          **OPTS)
        assert int(res.status) == int(full.status)
        assert int(res.iterations) == int(full.iterations)
        assert float(res.objective) == pytest.approx(float(full.objective),
                                                     rel=1e-9)
    else:
        full = levenberg_marquardt_jit_chunked(tp, chunk_iters=4, **OPTS)
        res = levenberg_marquardt_jit_chunked(
            tp, chunk_iters=4, checkpoint_dir=d, resume=True, **OPTS)
        assert (res.status, res.iterations) == (full.status,
                                                full.iterations)
        assert res.objective == pytest.approx(full.objective, rel=1e-9)


def test_callback_rows_match_jax(p9):
    jp, tp = p9
    ref, got = [], []
    jax_chunked(jp, chunk_iters=4, callback=ref.append, **OPTS)
    levenberg_marquardt_jit_chunked(tp, chunk_iters=4, callback=got.append,
                                    **OPTS)
    assert len(got) == len(ref) > 1
    for g, r in zip(got, ref):
        assert set(g) == set(r) == {"iter", "obj", "gnorm", "lam", "status",
                                    "elapsed"}
        assert (g["iter"], g["status"]) == (r["iter"], r["status"])
        assert g["obj"] == pytest.approx(r["obj"], rel=1e-9)
        assert g["lam"] == pytest.approx(r["lam"], rel=1e-9)
    assert got[-1]["status"] in STATUS_NAMES.values()


def test_unknown_option_raises(p9):
    _, tp = p9
    with pytest.raises(TypeError, match="bogus_option"):
        levenberg_marquardt_jit_chunked(tp, bogus_option=1)


@pytest.mark.parametrize("facto", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_chunked_facto_dtype_converges_near_f32(facto):
    jp, _ = jax_synthetic(**FACTO_PROBLEM, dtype=jnp.float32)
    tp = to_port(jp)
    base = levenberg_marquardt_jit(tp, **FACTO_OPTS)
    mixed = levenberg_marquardt_jit_chunked(tp, chunk_iters=7,
                                            facto_dtype=facto, **FACTO_OPTS)
    assert mixed.status_name() != "exception"
    assert mixed.objective == pytest.approx(base.objective, rel=2e-2)


# --------------------------------------------------------------- host
def same_history(got: LMResult, ref, solver):
    assert got.status == ref.status and got.iterations == ref.iterations
    assert (got.neval_residual, got.neval_jac) == (ref.neval_residual,
                                                   ref.neval_jac)
    assert got.objective == pytest.approx(ref.objective, rel=1e-9)
    assert len(got.history) == len(ref.history)
    tol = ROW_TOL["dense" if solver == "dense" else "iterative"]
    obj0, gnorm0 = ref.history[0]["obj"], ref.history[0]["gnorm"]
    for g, r in zip(got.history, ref.history):
        assert set(g) == set(r)
        assert (g["iter"], g["accepted"], g["cg_iters"]) == (
            r["iter"], r["accepted"], r["cg_iters"])
        assert abs(g["obj"] - r["obj"]) <= tol["obj"] * obj0
        assert abs(g["gnorm"] - r["gnorm"]) <= tol["gnorm"] * gnorm0
        assert g["lam"] == pytest.approx(r["lam"], rel=tol["lam"])
        if np.isfinite(r["rho"]):
            assert abs(g["rho"] - r["rho"]) <= tol["rho"]


@pytest.mark.parametrize("strategy", [
    dict(), dict(lam_strategy="nielsen"), dict(linesearch=True)],
    ids=["ref", "nielsen", "linesearch"])
@pytest.mark.parametrize("solver", ["pcg", "dense", "cgls", "power"])
def test_host_driver_matches_jax(p9, solver, strategy):
    jp, tp = p9
    opts = dict(solver=solver, **OPTS, **strategy)
    rows = []
    ref = jax_host(jp, JaxOptions(**opts))
    got = levenberg_marquardt(tp, LMOptions(**opts), callback=rows.append)
    same_history(got, ref, solver)
    assert rows == got.history and got.solved()
    assert np.isnan(got.rmse_px)


@pytest.mark.parametrize("problem_kw, opts", [
    (P10, dict(max_iters=40, lam0_mode="diag")),
    (P9, dict(max_iters=60, pcg_max_iters=200, pcg_warm=True)),
    (P12, dict(max_iters=1, **ZERO_TOLS)),
], ids=["diag", "pcg_warm", "max_iter"])
def test_host_driver_options_match_jax(problem_kw, opts):
    jp, _ = jax_synthetic(**problem_kw)
    ref = jax_host(jp, JaxOptions(**opts))
    got = levenberg_marquardt(to_port(jp), LMOptions(**opts))
    same_history(got, ref, "pcg")
    if opts["max_iters"] == 1:
        assert got.status == "max_iter" and got.iterations == 1


def test_host_driver_verbose_log(p9, capsys):
    _, tp = p9
    res = levenberg_marquardt(tp, LMOptions(max_iters=3, verbose=True))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split()[:2] == ["iter", "obj"]
    assert len(lines) == 1 + len(res.history) == 4


def test_host_resume_matches_jax(p9, tmp_path):
    """The host driver resumed from a checkpoint the port wrote makes the
    JAX host driver's resumed solve (both restore cams, points, lambda
    and the iteration; the first-order threshold is taken anew)."""
    jp, tp = p9
    d = tmp_path / "port"
    levenberg_marquardt(tp, LMOptions(max_iters=5, checkpoint_dir=str(d),
                                      checkpoint_every=1))
    assert (d / "step-5.npz").exists()
    shutil.copytree(d, tmp_path / "jax")
    opts = dict(OPTS, resume=True)
    got = levenberg_marquardt(tp, LMOptions(checkpoint_dir=str(d), **opts))
    ref = jax_host(jp, JaxOptions(checkpoint_dir=str(tmp_path / "jax"),
                                  **opts))
    assert got.history[0]["iter"] == 5
    same_history(got, ref, "pcg")
