"""The JAX package's public names in the port: each sub-package's exports,
and the entry points that are thin wrappers over the port's own code,
against the JAX functions on the CPU, on inputs made from a numpy seed.

Bars: float64 to rel 1e-12 of the output's scale (the same formulas, in
another order), float32 to rel 1e-5 (float32 rounding of the same
formulas); the predicted reduction, which the port takes from the Schur
blocks where JAX multiplies out J, to rel 1e-10 and 1e-4.
"""

import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.models import camera as jax_camera
from bundleadjustment_jl_tpu.ops import jacobian as jax_jacobian
from bundleadjustment_jl_tpu.ops import normal as jax_normal
from bundleadjustment_jl_tpu.ops import schur as jax_schur
from bundleadjustment_jl_tpu.parallel import partition as jax_partition
from bundleadjustment_jl_tpu_torch.models import camera
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import jacobian, normal, schur
from bundleadjustment_jl_tpu_torch.parallel import partition_problem

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

# The pcg modules by name: each package's `ops` exports its function `pcg`.
jax_pcg = importlib.import_module("bundleadjustment_jl_tpu.ops.pcg")
pcg = importlib.import_module("bundleadjustment_jl_tpu_torch.ops.pcg")

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = "bundleadjustment_jl_tpu"
PORT_PKG = "bundleadjustment_jl_tpu_torch"
DTYPES = {"float64": (jnp.float64, torch.float64, 1e-12),
          "float32": (jnp.float32, torch.float32, 1e-5)}
PROBLEM = dict(ncams=6, npnts=60, obs_per_pnt=3, seed=5, noise_px=1.0,
               perturb=2e-2)
# JAX names the port leaves out on purpose, by sub-package: the port marks
# a solve's phases with spans under the profiler (`utils/profiling.py`)
# in place of wall-clock phase timers, which synchronize each phase and so
# change what they time.
NOT_PORTED = {"utils": {"PhaseTimers"}}


def _exports(init: Path) -> set:
    """The names a package ``__init__.py`` binds at its top level (its
    imports, definitions and assignments), but private ones."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_") or n == "__version__"}


def _jax_packages():
    base = ROOT / JAX_PKG
    return [""] + sorted(p.parent.name for p in base.glob("*/__init__.py"))


@pytest.mark.parametrize("sub", _jax_packages(), ids=lambda s: s or "top")
def test_port_exports_a_superset_of_jax(sub):
    jax_init = ROOT / JAX_PKG / sub / "__init__.py"
    want = _exports(jax_init)
    port = importlib.import_module(PORT_PKG + ("." + sub if sub else ""))
    missing = {n for n in want if not hasattr(port, n)}
    dropped = NOT_PORTED.get(sub, set())
    assert dropped <= want
    assert missing == dropped, f"{PORT_PKG}.{sub} lacks {sorted(missing)}"


def _close(got, ref, rel):
    ref = np.asarray(ref).astype(np.float64)
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-300))


def _problems(dtype):
    jdt, tdt, rel = DTYPES[dtype]
    jp, _ = jax_synthetic(dtype=jdt, **PROBLEM)
    tp = BAProblem.from_numpy({k: np.asarray(getattr(jp, k))
                               for k in BAProblem.FIELDS}, device="cpu")
    return jp, tp, rel


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_residuals_and_jacobian_match_jax(dtype):
    jp, tp, rel = _problems(dtype)
    got = jacobian.residuals_and_jacobian(tp)
    ref = jax_jacobian.residuals_and_jacobian(jp)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        _close(g, r, rel)
    # rj_raw on raw arrays, rj_gathered on the gathered rows
    args = [np.array(getattr(jp, k)) for k in (
        "cams", "points", "cam_idx", "pnt_idx", "pt2d", "w")]
    raw = jacobian.rj_raw(*map(torch.as_tensor, args))
    for g, r in zip(raw, jax_jacobian.rj_raw(*map(jnp.asarray, args))):
        _close(g, r, rel)
    c, X = args[0][args[2]], args[1][args[3]]
    gat = jacobian.rj_gathered(*map(torch.as_tensor, (c, X, *args[4:])))
    for g, r in zip(gat, jax_jacobian.rj_gathered(
            *map(jnp.asarray, (c, X, *args[4:])))):
        _close(g, r, rel)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_inv3x3_matches_jax(dtype):
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(7)
    A = rng.standard_normal((40, 3, 3))
    M = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3)
    M[3] = 0.0                                  # singular: the fallback
    M[4, 1, 1] = np.inf                         # not finite: the fallback
    M = M.astype(np.dtype(jdt))
    got = normal.inv3x3(torch.as_tensor(M))
    ref = np.asarray(jax_normal.inv3x3(jnp.asarray(M)))
    assert got.shape == M.shape and got.dtype == tdt
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
    ok = np.ones(len(M), bool)
    ok[[3, 4]] = False
    _close(got[ok], ref[ok], rel * 10)          # conditioning of the blocks
    np.testing.assert_array_equal(got[~ok].double().numpy(),
                                  ref[~ok].astype(np.float64))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_cholesky_and_solve_match_jax(dtype):
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(8)
    A = rng.standard_normal((5, 9, 9))
    S = (A @ A.transpose(0, 2, 1) + np.eye(9)).astype(np.dtype(jdt))
    v = rng.standard_normal((5, 9)).astype(np.dtype(jdt))
    L = pcg.block_cholesky(torch.as_tensor(S))
    jL = jax_pcg.block_cholesky(jnp.asarray(S))
    _close(L, jL, rel)
    x = pcg.block_cho_solve(L, torch.as_tensor(v))
    _close(x, jax_pcg.block_cho_solve(jL, jnp.asarray(v)), rel * 100)
    assert x.dtype == tdt
    # the inverse of block_jacobi_inverse applies as the factor's solve
    _close(pcg.block_jacobi_apply(pcg.block_jacobi_inverse(
        torch.as_tensor(S)), torch.as_tensor(v)), np.asarray(x), rel * 100)
    # not SPD: NaN in the factor's lower triangle, as JAX's; and a NaN
    # inverse, whose step the LM drivers reject
    bad = S.copy()
    bad[2] = -np.eye(9)
    Lb = pcg.block_cholesky(torch.as_tensor(bad))
    np.testing.assert_array_equal(
        Lb.isnan().numpy(), np.isnan(jax_pcg.block_cholesky(jnp.asarray(bad))))
    assert bool(Lb[2].isnan().any()) and not bool(Lb[1].isnan().any())
    inv = pcg.block_jacobi_inverse(torch.as_tensor(bad))
    assert bool(inv[2].isnan().all()) and not bool(inv[1].isnan().any())


def test_block_cholesky_factors_half_in_float32():
    S = torch.eye(9).repeat(2, 1, 1).to(torch.bfloat16) * 4
    L = pcg.block_cholesky(S)
    assert L.dtype == torch.float32
    assert pcg.block_cho_solve(L, torch.ones(2, 9, dtype=torch.bfloat16)
                               ).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("route", normal.ROUTES)
def test_predicted_reduction_matches_jax(monkeypatch, route, dtype):
    jp, tp, rel = _problems(dtype)
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    rng = np.random.default_rng(9)
    dc = 1e-3 * rng.standard_normal((tp.ncams, 9))
    dp = 1e-2 * rng.standard_normal((tp.npnts, 3))
    jb = jax_normal.assemble_blocks(jp, with_jr=True)
    ref = float(jax_schur.predicted_reduction(
        jp, jb, jnp.asarray(dc, jp.cams.dtype), jnp.asarray(dp,
                                                            jp.cams.dtype)))
    tb = normal.assemble_blocks(tp, route=route, stages=normal.PLAIN)
    assert tb.route == route
    got = schur.predicted_reduction(
        tp, tb, torch.as_tensor(dc, dtype=tp.dtype),
        torch.as_tensor(dp, dtype=tp.dtype))
    assert got.dtype == tp.dtype
    assert float(got) == pytest.approx(
        ref, rel={"float64": 1e-10, "float32": 1e-4}[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_project_p1_matches_jax(dtype):
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(10)
    cams = rng.standard_normal((30, 9)).astype(np.dtype(jdt))
    cams[0, :3] = 0.0                           # the small-angle form
    X = rng.standard_normal((30, 3)).astype(np.dtype(jdt))
    got = camera.project_p1(torch.as_tensor(cams), torch.as_tensor(X))
    ref = jax.vmap(jax_camera.project_p1)(jnp.asarray(cams), jnp.asarray(X))
    assert got.shape == (30, 3)
    _close(got, ref, rel)
    # project is the rest of the chain on P1
    p1 = got[1]
    np.testing.assert_allclose(
        camera.project(torch.as_tensor(cams[1]), torch.as_tensor(X[1])),
        jax_camera.project(jnp.asarray(cams[1]), jnp.asarray(X[1])),
        rtol=rel * 10)
    assert torch.isfinite(p1).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_partition_problem_matches_jax(dtype):
    """`parallel.partition_problem` against the JAX function at an odd part
    count: every array, ``part_of_cam``, the sizes and the name."""
    jp, tp, _ = _problems(dtype)
    jq, jpart = jax_partition.partition_problem(jp, 3)
    tq, tpart = partition_problem(tp, 3)
    np.testing.assert_array_equal(tpart, jpart)
    for k in BAProblem.FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(tq, k).numpy(),
                                      np.asarray(getattr(jq, k)), err_msg=k)
    assert tq.dtype == tp.dtype
    assert (tq.nobs, tq.nobs_pad, tq.ncams, tq.npnts) == (
        jq.nobs, jq.nobs_pad, jq.ncams, jq.npnts)
    assert tq.name == f"{tp.name}-part3"
