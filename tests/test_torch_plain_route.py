"""The solver's plain-route decision and the members of the port's problem
and result types, against the JAX package, on the CPU.

- The decision (`ops/normal.py:solve_stages`) equals the JAX package's
  `pallas_schur.problem_ok` on float32 and float64; at a padding that is
  not a multiple of 128 the port keeps its kernels (the 128 rule is a TPU
  lane constraint; the port's kernels take any padding).
- A float64 solve runs the plain route: it reaches no kernel wrapper and
  makes the JAX XLA solve's decisions (same status, iterations, accepts
  and CG steps), objective to rel 1e-10.
- ``BAProblem``'s ``nvar``, ``nequ``, ``dtype``, ``astype``, ``state``,
  ``with_state``, ``flatten_state`` and ``unflatten_state`` and
  ``LMJitResult``'s ``neval_jac``, ``neval_residual`` and
  ``elapsed_time`` equal the JAX objects' on the same problem and solve
  (the float arrays exactly: both hold the same numbers).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.models.problem import BAProblem as JaxProblem
from bundleadjustment_jl_tpu.ops import pallas_schur
from bundleadjustment_jl_tpu.solver.lm_jit import (
    levenberg_marquardt_jit as jax_lm)
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import normal, plans
from bundleadjustment_jl_tpu_torch.solver.lm_jit import levenberg_marquardt_jit

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

P10 = dict(ncams=6, npnts=40, obs_per_pnt=3, noise_px=0.3, perturb=2e-3,
           seed=10)


def to_port(jp):
    return BAProblem.from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS},
        device="cpu")


def small_jax_problem(dtype, pad_obs_to):
    rng = np.random.default_rng(0)
    pnt = np.repeat(np.arange(30), 3)
    cam = rng.integers(0, 5, size=pnt.size)
    return JaxProblem.from_arrays(
        rng.standard_normal((5, 9)), rng.standard_normal((30, 3)), cam, pnt,
        rng.standard_normal((pnt.size, 2)), dtype=dtype,
        pad_obs_to=pad_obs_to)


@pytest.mark.parametrize("dtype, pad", [
    (np.float32, 128), (np.float64, 128), (np.float32, 100)],
    ids=["f32", "f64", "pad100"])
def test_solve_stages_against_jax_problem_ok(dtype, pad):
    jp = small_jax_problem(dtype, pad)
    tp = to_port(jp)
    jax_kernels = bool(pallas_schur.problem_ok(jp, dtype))
    assert jax_kernels == (dtype == np.float32 and pad == 128)
    # The same choice but at pad100, where only the JAX package's lane rule
    # says no.
    want = normal.KERNELS if dtype == np.float32 else normal.PLAIN
    assert normal.solve_stages(tp.dtype) is want
    assert normal.solve_stages(dtype) is want


def test_pallas_mode_off_takes_the_plain_route(monkeypatch):
    assert normal.solve_stages(torch.float32) is normal.KERNELS
    monkeypatch.setattr(normal, "PALLAS_MODE", False)
    assert normal.solve_stages(torch.float32) is normal.PLAIN


def test_stage_tables_pair_each_wrapper_with_its_plain_twin():
    """The two tables hold distinct callables field by field, each plain
    twin in the wrapper's module."""
    for name, kernel, plain in zip(normal.Stages._fields, normal.KERNELS,
                                   normal.PLAIN):
        assert kernel.__name__ == name and plain is not kernel
        assert plain.__name__.endswith("_plain")
        assert plain.__module__ == kernel.__module__


@pytest.mark.parametrize("route", normal.ROUTES)
def test_f64_solve_runs_the_plain_route(monkeypatch, route):
    """A float64 solve on each route's gates reaches no kernel wrapper and
    makes the JAX XLA solve's decisions."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called on the plain route")

    monkeypatch.setattr(normal, "KERNELS",
                        normal.Stages(*[refuse] * len(normal.Stages._fields)))
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    jp, _ = jax_synthetic(**P10)
    opts = dict(max_iters=40, lam0_mode="diag")
    ref = jax_lm(jp, **opts)
    tp = to_port(jp)
    assert normal.kernel_route(tp) == route
    assert normal.solve_stages(tp.dtype) is normal.PLAIN
    got = levenberg_marquardt_jit(tp, **opts)
    assert got.status == int(ref.status)
    assert got.iterations == int(ref.iterations)
    assert got.naccepts == int(ref.naccepts)
    np.testing.assert_array_equal(got.hist_cg, np.asarray(ref.hist_cg))
    assert got.objective == pytest.approx(float(ref.objective), rel=1e-10)


@pytest.fixture(scope="module")
def pair():
    jp, _ = jax_synthetic(**P10)
    return jp, to_port(jp)


def test_problem_members_match_jax(pair):
    jp, tp = pair
    assert tp.nvar == jp.nvar and tp.nequ == jp.nequ
    assert np.dtype(str(tp.dtype)[6:]) == np.dtype(jp.dtype)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64,
                                                   jnp.float64)):
        t32, j32 = tp.astype(dt), jp.astype(jdt)
        assert t32.dtype == dt and np.dtype(str(dt)[6:]) == np.dtype(
            j32.dtype)
        for k in ("cams", "points", "pt2d", "w", "cam_idx", "pnt_idx",
                  "pnt_starts", "cam_perm", "cam_starts"):
            np.testing.assert_array_equal(getattr(t32, k).numpy(),
                                          np.asarray(getattr(j32, k)))
    for a, b in zip(tp.state(), jp.state()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = tp.flatten_state()
    np.testing.assert_array_equal(x.numpy(), np.asarray(jp.flatten_state()))
    cams, points = tp.unflatten_state(2.0 * x)
    jc, jpts = jp.unflatten_state(2.0 * jp.flatten_state())
    np.testing.assert_array_equal(cams.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(points.numpy(), np.asarray(jpts))
    moved = tp.with_state(cams, points)
    jmoved = jp.with_state(jc, jpts)
    np.testing.assert_array_equal(moved.flatten_state().numpy(),
                                  np.asarray(jmoved.flatten_state()))
    assert moved.nobs == jmoved.nobs and moved.cam_idx is tp.cam_idx


def test_result_members_match_jax(pair):
    jp, tp = pair
    opts = dict(max_iters=40, lam0_mode="diag")
    ref, got = jax_lm(jp, **opts), levenberg_marquardt_jit(tp, **opts)
    assert got.neval_jac == ref.neval_jac == int(ref.naccepts) + 1
    assert got.neval_residual == ref.neval_residual
    assert math.isnan(got.elapsed_time) and math.isnan(ref.elapsed_time)


def test_astype_and_with_state_share_plans():
    """The copies keep the index arrays, so they share the launch plans; a
    problem built with new indices starts with none."""
    tp = to_port(small_jax_problem(np.float32, 128))
    blocks = plans.point_blocks(tp)
    for copy in (tp.astype(torch.float64), tp.with_state(tp.cams, tp.points)):
        assert copy.plans is tp.plans
        assert plans.point_blocks(copy) is blocks
    fresh = BAProblem.from_arrays(
        tp.cams.numpy(), tp.points.numpy(), tp.cam_idx[:tp.nobs].numpy(),
        tp.pnt_idx[:tp.nobs].numpy(), tp.pt2d[:tp.nobs].numpy(),
        dtype=torch.float32, device="cpu")
    assert fresh.plans == {}
