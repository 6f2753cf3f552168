"""The port's CGLS, power-series and dense step solvers against the JAX
package's, on the CPU.

- The pieces, in float64 to rel 1e-10 on the same blocks: ``j_matvec`` /
  ``jt_matvec`` (and their adjointness), ``cgls_solve``, ``power_series``
  on the reduced system, ``assemble_dense_schur`` (against the JAX
  function and against ``schur_matvec`` applied to unit vectors) and
  ``solve_dense``; ``solve_dense`` gives NaN, not an exception, on an S
  that is not positive definite; ``check_dense_feasible`` raises above
  ``DENSE_MAX_BYTES`` (the plain route's estimate; the kernel route's
  admits Venice-1778).
- ``levenberg_marquardt_jit`` with ``use_power`` / ``use_dense`` /
  ``use_cgls`` against the JAX driver on its XLA path: float64, the same
  status, iterations, accepts and CG steps, objective to rel 1e-9; float32
  (JAX Pallas off), the same status and iterations, objective to rel 1e-5.
  A float32 dense solve is held over its first six iterations: near
  convergence, at small lambda, S's condition number passes 1e7 and the
  float32 Cholesky steps (accepted or rejected) follow rounding in either
  package.
- Launch counts: with ``normal.KERNELS`` replaced by counting plain twins,
  each solver on each route calls each stage as often as
  ``lm_jit.expected_launches`` says, and through the host driver (with
  its sequential line search) as ``lm.expected_host_launches`` says.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.ops import cgls as jax_cgls
from bundleadjustment_jl_tpu.ops import pallas_schur
from bundleadjustment_jl_tpu.ops import schur as jax_schur
from bundleadjustment_jl_tpu.ops.normal import assemble_blocks as jax_assemble
from bundleadjustment_jl_tpu.ops.pcg import (
    block_jacobi_apply as jax_bj_apply,
    block_jacobi_inverse as jax_bj_inverse, power_series as jax_power_series)
from bundleadjustment_jl_tpu.solver.lm_jit import (
    levenberg_marquardt_jit as jax_lm)
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import _cuda, normal, schur
from bundleadjustment_jl_tpu_torch.ops.cgls import (
    cgls_solve, j_matvec, jt_matvec)
from bundleadjustment_jl_tpu_torch.ops.normal import assemble_blocks
from bundleadjustment_jl_tpu_torch.ops.pcg import (
    block_jacobi_apply, block_jacobi_inverse, power_series)
from bundleadjustment_jl_tpu_torch.solver import lm, lm_jit
from bundleadjustment_jl_tpu_torch.solver.lm_jit import levenberg_marquardt_jit

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

P10 = dict(ncams=6, npnts=40, obs_per_pnt=3, noise_px=0.3, perturb=2e-3,
           seed=10)
# The float32 problem (noise and perturbation as bench.py's) and options
# (bench.py's stopping tolerances).
P5 = dict(ncams=8, npnts=120, obs_per_pnt=4, noise_px=1.0, perturb=2e-2,
          seed=5)
F32_OPTS = dict(max_iters=40, pcg_max_iters=100, lam0_mode="diag",
                satol=0.0, srtol=0.0, atol=0.0, rtol=1e-5, oatol=0.0,
                ortol=1e-4)
NO_STOPS = dict(atol=0.0, rtol=0.0, restol=0.0, satol=0.0, srtol=0.0,
                oatol=0.0, ortol=0.0)
LAM = 1e-2
SOLVER_OPTS = {"power": dict(use_power=True), "dense": dict(use_dense=True),
               "cgls": dict(use_cgls=True)}
# Each stage of `normal.Stages` and its launch counter (`_cuda.LAUNCHES`).
COUNTER = dict(
    assemble_scatter="assemble", linearize_w_kminor="linearize",
    jtj_pnt_reduce="seg_prod_pnt12", jtj_cam_reduce="seg_prod_cam90",
    cam_relin_cam90="cam_relin_cam90", linearize_w_only="linearize_w_only",
    cam_reduce_wcw_rhs="cam_reduce", cam_relin_wcw_rhs="cam_relin_wcw_rhs",
    matvec_cam_scatter="matvec",
    cam_reduce_w_op="cam_reduce_w_op", cam_reduce_wcw="cam_reduce_wcw81",
    wcw_cam_reduce="seg_prod_wcw81", wtv_point_reduce="seg_block_point",
    wt_cam_reduce="seg_block_camera", objective_scatter="objective",
    point_inv_rhs="point_inv", point_quad="point_quad",
    dense_schur="dense_pairs")


def to_port(jp):
    return BAProblem.from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS},
        device="cpu")


def close(got, ref, rtol=1e-10):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def pair():
    """(JAX problem, its blocks; port problem, its blocks with JR_t), f64."""
    jp, _ = jax_synthetic(**P10)
    tp = to_port(jp)
    return (jp, jax_assemble(jp), tp,
            assemble_blocks(tp, stages=normal.PLAIN, with_jr=True))


def test_j_and_jt_match_jax_and_are_adjoint(pair):
    jp, jb, tp, tb = pair
    rng = np.random.default_rng(0)
    dc = rng.normal(size=(tp.ncams, 9))
    dp = rng.normal(size=(tp.npnts, 3))
    s = rng.normal(size=(tp.nobs_pad, 2))
    Jd = j_matvec(tp, tb, torch.from_numpy(dc), torch.from_numpy(dp))
    close(Jd, jax_cgls.j_matvec(jp, jb, jnp.asarray(dc), jnp.asarray(dp)))
    vc, vp = jt_matvec(tp, tb, torch.from_numpy(s))
    rc, rp = jax_cgls.jt_matvec(jp, jb, jnp.asarray(s))
    close(vc, rc)
    close(vp, rp)
    lhs = float(torch.sum(Jd * torch.from_numpy(s)))
    rhs = float(torch.sum(vc * torch.from_numpy(dc))
                + torch.sum(vp * torch.from_numpy(dp)))
    assert lhs == pytest.approx(rhs, rel=1e-10)


@pytest.mark.parametrize("rtol, max_iters", [(1e-2, 200), (1e-4, 500)],
                         ids=["forcing", "tight"])
def test_cgls_solve_matches_jax(pair, rtol, max_iters):
    jp, jb, tp, tb = pair
    ref = jax_cgls.cgls_solve(jp, jb, jnp.asarray(LAM), rtol=rtol,
                              max_iters=max_iters)
    got = cgls_solve(tp, tb, LAM, rtol, max_iters=max_iters)
    assert got.iters == int(ref.iters)
    close(got.dc, ref.dc)
    close(got.dp, ref.dp)
    assert float(got.rel_grad) == pytest.approx(float(ref.rel_grad),
                                                rel=1e-6)


def test_power_series_matches_jax(pair):
    jp, jb, tp, tb = pair
    jsys = jax_schur.reduce_system(jp, jb, LAM)
    jM = jax_bj_inverse(jsys.Hcc_l)
    ref = jax_power_series(
        lambda v: jax_schur.schur_matvec(jsys, v), jsys.b,
        lambda v: jnp.einsum("cab,cb->ca", jsys.Hcc_l, v),
        lambda v: jax_bj_apply(jM, v), rtol=1e-3,
        max_terms=200)
    sys = schur.reduce_system(tp, tb, LAM)
    M = block_jacobi_inverse(sys.Hcc_l)
    got = power_series(
        lambda v: schur.schur_matvec(sys, v), sys.b,
        lambda v: torch.einsum("cab,cb->ca", sys.Hcc_l, v),
        lambda v: block_jacobi_apply(M, v), rtol=1e-3, max_terms=200)
    assert got.iters == int(ref.iters) and 1 < got.iters < 200
    close(got.x, ref.x)
    assert float(got.rel_res) == pytest.approx(float(ref.rel_res),
                                               rel=1e-6)


@pytest.mark.parametrize("facto", [None, torch.bfloat16, torch.float16],
                         ids=["f64", "bf16", "f16"])
def test_assemble_dense_schur_matches_jax_and_matvec(pair, facto):
    """S against the JAX function on the same stored W (``facto``: W
    stored narrow as the solver stores it, a float16 W as ``s W`` with the
    system's ``Hpp_inv`` hatted), both rounding S to W's storage dtype:
    to rel 1e-10 in float64, else within two ulps of the storage dtype
    (the two float32 sums round to neighbours), the entries past float16's
    range infinite in both. In float64, also against ``schur_matvec`` of
    the unit vectors."""
    jp, jb, tp, tb = pair
    blocks = lm_jit.maybe_cast_facto(tb, facto)
    sys = schur.reduce_system(tp, blocks, LAM)
    S = schur.assemble_dense_schur(sys)
    assert S.dtype == (facto or torch.float64)
    jW = jnp.asarray(blocks.W_t.T.double().numpy()).reshape(-1)
    if facto is not None:
        jW = jW.astype({torch.bfloat16: jnp.bfloat16,
                        torch.float16: jnp.float16}[facto])
    jsys = jax_schur.reduce_system(jp, jb, LAM)._replace(
        W_f=jW, Hpp_inv_f=jnp.asarray(sys.Hpp_inv_f.numpy()))
    ref = np.asarray(jax_schur.assemble_dense_schur(jsys).astype(
        jnp.float64))
    got = S.double().numpy()
    if facto is None:
        close(got, ref)
        cols = [schur.schur_matvec(sys, e.reshape(-1, 9)).reshape(-1)
                for e in torch.eye(9 * tp.ncams, dtype=torch.float64)]
        close(S, torch.stack(cols, dim=1))
        return
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], ref[~fin])
    ulp = 2.0 * float(torch.finfo(facto).eps)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=ulp,
                               atol=ulp * np.abs(ref[fin]).max())


def test_solve_dense_matches_jax(pair):
    jp, jb, tp, tb = pair
    ref = jax_schur.solve_dense(jax_schur.reduce_system(jp, jb, LAM))
    close(schur.solve_dense(schur.reduce_system(tp, tb, LAM)), ref,
          rtol=1e-9)


def test_solve_dense_nan_on_indefinite_system(pair):
    """An S that is not positive definite gives a NaN step (the JAX
    package's cho_factor does), no exception."""
    _, _, tp, tb = pair
    sys = schur.reduce_system(tp, tb, LAM)
    sys = sys._replace(Hcc_l_f=-sys.Hcc_l_f)
    dc = schur.solve_dense(sys)
    assert dc.shape == (tp.ncams, 9) and torch.isnan(dc).all()


def test_check_dense_feasible_raises_above_the_cap(monkeypatch, pair):
    _, _, tp, tb = pair
    need = schur.dense_schur_bytes(tp.ncams, tp.npnts, tp.nobs_pad, 8)
    schur.check_dense_feasible(tp.ncams, tp.npnts, tp.nobs_pad, 8)
    monkeypatch.setattr(schur, "DENSE_MAX_BYTES", need - 1)
    with pytest.raises(MemoryError, match="DENSE_MAX_BYTES"):
        schur.solve_dense(schur.reduce_system(tp, tb, LAM))
    with pytest.raises(MemoryError):
        levenberg_marquardt_jit(tp, use_dense=True)
    # At the card's cap: Dubrovnik-356's sizes fit the plain route's two
    # targets, Venice-1778's do not; the kernel route's S by camera pairs
    # (15,102,831 at Venice-1778) fits.
    monkeypatch.undo()
    schur.check_dense_feasible(356, 226730, 1360384)
    with pytest.raises(MemoryError):
        schur.check_dense_feasible(1778, 993923, 5001946)
    schur.check_dense_feasible(1778, 993923, 5001946, npairs=15102831)


@pytest.mark.parametrize("solver", ["power", "dense", "cgls"])
@pytest.mark.parametrize("opts", [
    dict(max_iters=40, pcg_max_iters=200),
    dict(max_iters=40, pcg_max_iters=200, lam_strategy="nielsen"),
], ids=["ref", "nielsen"])
def test_solver_f64_matches_jax_xla(solver, opts):
    jp, _ = jax_synthetic(**P10)
    opts = dict(opts, **SOLVER_OPTS[solver])
    ref = jax_lm(jp, **opts)
    got = levenberg_marquardt_jit(to_port(jp), **opts)
    n = int(ref.iterations)
    assert got.status == int(ref.status)
    assert got.iterations == n and got.naccepts == int(ref.naccepts)
    np.testing.assert_array_equal(got.hist_cg, np.asarray(ref.hist_cg))
    assert got.objective == pytest.approx(float(ref.objective), rel=1e-9)


@pytest.mark.parametrize("solver", ["power", "dense", "cgls"])
def test_solver_f32_matches_jax_xla(solver):
    jp, _ = jax_synthetic(**P5, dtype=jnp.float32)
    opts = dict(F32_OPTS, **SOLVER_OPTS[solver])
    if solver == "dense":
        opts["max_iters"] = 6
    old = pallas_schur.PALLAS_MODE
    try:
        pallas_schur.set_mode(False)
        ref = jax_lm(jp, **opts)
    finally:
        pallas_schur.set_mode(old)
    got = levenberg_marquardt_jit(to_port(jp), **opts)
    assert got.status == int(ref.status)
    assert got.iterations == int(ref.iterations)
    assert got.naccepts == int(ref.naccepts)
    robj = float(ref.objective)
    assert abs(got.objective - robj) <= 1e-5 * robj


def counting_stages(counts):
    """``normal.KERNELS`` with each stage its plain twin, counting calls
    under its launch counter."""
    def wrap(field, fn):
        def call(*args, **kwargs):
            counts[COUNTER[field]] += 1
            return fn(*args, **kwargs)
        return call
    return normal.Stages(*[wrap(f, fn) for f, fn in
                           zip(normal.Stages._fields, normal.PLAIN)])


@pytest.mark.parametrize("solver", ["pcg", "power", "dense", "cgls"])
@pytest.mark.parametrize("route", normal.ROUTES)
def test_launches_per_solver_and_route(monkeypatch, route, solver):
    counts = dict.fromkeys(_cuda.LAUNCHES, 0)
    monkeypatch.setattr(normal, "KERNELS", counting_stages(counts))
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    jp, _ = jax_synthetic(**P10, dtype=jnp.float32)
    res = levenberg_marquardt_jit(to_port(jp), max_iters=4, **NO_STOPS,
                                  **SOLVER_OPTS.get(solver, {}))
    assert res.iterations == 4 and res.naccepts > 0
    expect = dict.fromkeys(counts, 0)
    expect.update(lm_jit.expected_launches(
        route, res.iterations, res.naccepts, int(res.hist_cg.sum()),
        solver))
    assert counts == expect


@pytest.mark.parametrize("solver", ["pcg", "power", "dense", "cgls"])
@pytest.mark.parametrize("route", normal.ROUTES)
def test_host_launches_per_solver_and_route(monkeypatch, route, solver):
    counts = dict.fromkeys(_cuda.LAUNCHES, 0)
    monkeypatch.setattr(normal, "KERNELS", counting_stages(counts))
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    jp, _ = jax_synthetic(**P10, dtype=jnp.float32)
    res = lm.levenberg_marquardt(to_port(jp), lm.LMOptions(
        solver=solver, max_iters=4, linesearch=True, **NO_STOPS))
    assert res.iterations == 4 and res.neval_jac > 1
    expect = dict.fromkeys(counts, 0)
    expect.update(lm.expected_host_launches(route, res, solver))
    assert counts == expect
