"""The port's Levenberg-Marquardt driver and PCG against the JAX package's
``levenberg_marquardt_jit``, on the CPU.

- f64: the JAX XLA route (Pallas off) on the ``tests/test_lm_jit.py``
  problems — same status, iterations, accepts and CG steps per
  iteration, objective to rel 1e-9.
- f32: the JAX fused camera-scatter route in Pallas interpret mode on the
  ``tests/test_cam_scatter.py`` problem — same status and iterations,
  objective to rel 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.ops import pallas_schur
from bundleadjustment_jl_tpu.solver.lm_jit import (
    levenberg_marquardt_jit as jax_lm)
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops.pcg import (
    block_jacobi_apply, block_jacobi_inverse, pcg)
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    MAX_ITER, levenberg_marquardt_jit)

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)


def to_port(jp):
    return BAProblem.from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS},
        device="cpu")


P9 = dict(ncams=8, npnts=60, obs_per_pnt=3, noise_px=0.4, perturb=2e-3,
          seed=9)
P10 = dict(ncams=6, npnts=40, obs_per_pnt=3, noise_px=0.3, perturb=2e-3,
           seed=10)
P12 = dict(ncams=6, npnts=40, obs_per_pnt=3, perturb=5e-2, seed=12)
P13 = dict(ncams=6, npnts=40, obs_per_pnt=3, noise_px=0.3, perturb=5e-3,
           seed=13)
ZERO_TOLS = dict(atol=0.0, rtol=0.0, restol=0.0, satol=0.0, srtol=0.0,
                 oatol=0.0, ortol=0.0)


@pytest.mark.parametrize("problem_kw, opts", [
    (P9, dict(max_iters=60, pcg_max_iters=200)),
    (P10, dict(max_iters=40, lam0_mode="diag")),
    (P10, dict(max_iters=40, lam_strategy="nielsen")),
    (P13, dict(max_iters=60, linesearch=True)),
    (P9, dict(max_iters=60, pcg_max_iters=200, pcg_warm=True)),
    (P12, dict(max_iters=1, **ZERO_TOLS)),
], ids=["ref", "diag", "nielsen", "linesearch", "pcg_warm", "max_iter"])
def test_solver_f64_matches_jax_xla(problem_kw, opts):
    jp, _ = jax_synthetic(**problem_kw)
    ref = jax_lm(jp, **opts)
    got = levenberg_marquardt_jit(to_port(jp), **opts)
    n = int(ref.iterations)
    assert got.status == int(ref.status)
    assert got.iterations == n and got.naccepts == int(ref.naccepts)
    np.testing.assert_array_equal(got.hist_cg, np.asarray(ref.hist_cg))
    assert got.objective == pytest.approx(float(ref.objective), rel=1e-9)
    np.testing.assert_allclose(got.hist_obj[:n], np.asarray(ref.hist_obj)[:n],
                               rtol=1e-9)
    np.testing.assert_allclose(got.hist_lam[:n], np.asarray(ref.hist_lam)[:n],
                               rtol=1e-9)
    np.testing.assert_allclose(got.cams.numpy(), np.asarray(ref.cams),
                               rtol=1e-6, atol=1e-9)
    if opts["max_iters"] == 1:
        assert got.status == MAX_ITER


def test_solver_f32_matches_jax_pallas_cam_scatter():
    jp, _ = jax_synthetic(ncams=8, npnts=256, obs_per_pnt=4, seed=5,
                          dtype=jnp.float32, noise_px=1.0, perturb=2e-2,
                          pad_obs_to=1024)
    opts = dict(max_iters=15, pcg_max_iters=60, lam0_mode="diag")
    old = (pallas_schur.PALLAS_MODE, pallas_schur.INTERPRET,
           pallas_schur.CAM_SCATTER)
    try:
        pallas_schur.set_mode(True)
        pallas_schur.INTERPRET = True
        pallas_schur.CAM_SCATTER = True
        ref = jax_lm(jp, **opts)
    finally:
        (pallas_schur.PALLAS_MODE, pallas_schur.INTERPRET,
         pallas_schur.CAM_SCATTER) = old
    got = levenberg_marquardt_jit(to_port(jp), **opts)
    assert got.status == int(ref.status)
    assert got.iterations == int(ref.iterations)
    robj = float(ref.objective)
    assert abs(got.objective - robj) <= 1e-5 * max(1.0, robj)


def test_block_jacobi_inverse_nan_on_non_spd_block():
    """A non-SPD block yields NaN (no exception), so the driver can reject
    the step; SPD blocks get their exact inverse."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((3, 9, 9))
    blocks = torch.from_numpy(A @ A.transpose(0, 2, 1) + 9 * np.eye(9))
    blocks[1] = -blocks[1]
    Minv = block_jacobi_inverse(blocks)
    assert torch.isnan(Minv[1]).all()
    for c in (0, 2):
        torch.testing.assert_close(Minv[c], torch.linalg.inv(blocks[c]))


def test_pcg_solves_spd_system():
    rng = np.random.default_rng(2)
    n = 4
    A = rng.standard_normal((n * 9, n * 9))
    S = torch.from_numpy(A @ A.T + n * 9 * np.eye(n * 9))
    b = torch.from_numpy(rng.standard_normal((n, 9)))
    Minv = block_jacobi_inverse(torch.stack(
        [S[9 * c:9 * c + 9, 9 * c:9 * c + 9] for c in range(n)]))
    res = pcg(lambda v: (S @ v.reshape(-1)).reshape(n, 9), b,
              lambda v: block_jacobi_apply(Minv, v), rtol=1e-12,
              max_iters=200)
    x = torch.linalg.solve(S, b.reshape(-1)).reshape(n, 9)
    torch.testing.assert_close(res.x, x, rtol=1e-9, atol=1e-9)
    assert 0 < res.iters <= n * 9 and float(res.rel_res) <= 1e-12
