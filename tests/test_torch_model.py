"""The PyTorch port's problem model, IO, camera model and linearization
chain against the JAX package, on the CPU.

Both packages build problems from the same numpy seeds; the port takes
the JAX problem's arrays through ``BAProblem.from_numpy``.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.ops.jacobian import residuals_and_jacobian
from bundleadjustment_jl_tpu.ops.residuals import residuals as jax_residuals
from bundleadjustment_jl_tpu_torch.io.bal import (
    FIXTURE_TRUE_RESIDUALS, load_fixture)
from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops.chain import linearize, project_residual
from bundleadjustment_jl_tpu_torch.ops.residuals import objective, residuals

ROOT = Path(__file__).resolve().parents[1]
LAYOUT = ("cams", "points", "cam_idx", "pnt_idx", "pt2d", "w", "pnt_starts",
          "cam_perm", "cam_starts")


def to_port(jp, **override):
    fields = {k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS}
    fields.update(override)
    return BAProblem.from_numpy(fields, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(ncams=8, npnts=60, obs_per_pnt=3, seed=9),
    dict(ncams=20, npnts=300, obs_per_pnt=4, seed=3, noise_px=1.0),
    dict(ncams=30, npnts=200, obs_per_pnt=5, seed=4, cam_window=0.3,
         pad_obs_to=512),
    dict(ncams=9, npnts=300, obs_per_pnt=4, seed=11, dtype=np.float32,
         perturb=2e-2),
])
def test_synthetic_bal_identical_to_jax(kw):
    """Same seed -> bit-identical arrays and the same sorted, padded
    layout in both packages."""
    jp, jtruth = jax_synthetic(**kw)
    tp, truth = synthetic_bal(**kw, device="cpu")
    for k in LAYOUT:
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)
    assert (tp.nobs, tp.nobs_pad, tp.name) == (jp.nobs, jp.nobs_pad, jp.name)
    np.testing.assert_array_equal(truth["cams"], jtruth["cams"])
    np.testing.assert_array_equal(truth["points"], jtruth["points"])
    assert truth["objective"] == jtruth["objective"]
    # the layout contract: point-sorted rows, padding rows last with the
    # largest ids and zero weight, camera order through cam_perm
    pi = tp.pnt_idx.numpy()
    assert np.all(np.diff(pi) >= 0)
    assert tp.nobs_pad % kw.get("pad_obs_to", 128) == 0
    assert np.all(tp.w.numpy()[tp.nobs:] == 0)
    assert np.all(tp.cam_idx.numpy()[tp.nobs:] == tp.ncams - 1)
    assert np.all(pi[tp.nobs:] == tp.npnts - 1)
    ci_sorted = tp.cam_idx.numpy()[tp.cam_perm.numpy()]
    starts = tp.cam_starts.numpy()
    for c in range(tp.ncams):
        assert np.all(ci_sorted[starts[c]:starts[c + 1]] == c)


def test_from_numpy_carries_jax_problem():
    jp, _ = jax_synthetic(ncams=6, npnts=40, obs_per_pnt=3, seed=10)
    tp = to_port(jp)
    assert tp.cams.dtype == torch.float64 and tp.cam_idx.dtype == torch.int32
    for k in LAYOUT:
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)
    t32 = BAProblem.from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS},
        dtype=torch.float32, device="cpu")
    assert t32.cams.dtype == torch.float32 and t32.w.dtype == torch.float32


def test_read_bal_matches_jax(tmp_path):
    """The numpy BAL reader reorders (r, t, f, k1, k2) -> (r, t, k1, k2, f)
    and lays the problem out as the JAX reader does."""
    from bundleadjustment_jl_tpu.io.bal import read_bal as jax_read_bal
    from bundleadjustment_jl_tpu.io.bal import write_bal
    from bundleadjustment_jl_tpu_torch.io.bal import read_bal
    jp, _ = jax_synthetic(ncams=5, npnts=30, obs_per_pnt=3, seed=2)
    path = str(tmp_path / "problem-5-30-pre.txt.bz2")
    write_bal(path, jp)
    ref, got = jax_read_bal(path), read_bal(path, device="cpu")
    for k in LAYOUT:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    np.testing.assert_allclose(got.cams.numpy(), np.asarray(jp.cams),
                               rtol=1e-15)
    assert got.name == ref.name == "problem-5-30-pre"


def test_fixture_golden_residuals():
    r = residuals(load_fixture(device="cpu")).numpy()
    np.testing.assert_allclose(r[0], [-9.0202263, 11.2639583], atol=1e-7)
    np.testing.assert_allclose(r[:5], FIXTURE_TRUE_RESIDUALS, atol=1e-7)
    assert np.all(r[5:] == 0.0)


def _edge_problem():
    """A JAX f64 problem with a theta = 0 camera, a theta^2 < 1e-24 camera
    and one observation exactly on its camera's plane (z = 0)."""
    jp, _ = jax_synthetic(ncams=7, npnts=50, obs_per_pnt=3, seed=21,
                          noise_px=0.5, perturb=1e-2)
    cams = np.array(jp.cams)
    points = np.array(jp.points)
    cams[0, 0:3] = 0.0                    # R = I exactly (Taylor branch)
    cams[1, 0:3] = [1e-13, -2e-13, 0.0]   # theta^2 = 5e-26
    k = int(np.flatnonzero(np.asarray(jp.cam_idx)[:jp.nobs] == 0)[0])
    p = int(np.asarray(jp.pnt_idx)[k])
    points[p, 2] = -cams[0, 5]            # p1.z = X.z + t.z = 0
    jp = jp.with_state(jnp.asarray(cams), jnp.asarray(points))
    return jp, k


def test_residuals_and_chain_match_jax_f64():
    jp, k_zero = _edge_problem()
    tp = to_port(jp)
    r_ref, Jc_ref, Jp_ref = (np.asarray(a) for a in residuals_and_jacobian(jp))
    assert np.all(r_ref[k_zero] == 0) and np.all(Jc_ref[k_zero] == 0)

    np.testing.assert_allclose(residuals(tp).numpy(),
                               np.asarray(jax_residuals(jp)), atol=1e-10)
    ci, pi = tp.cam_idx.long(), tp.pnt_idx.long()
    c, X = tp.cams[ci], tp.points[pi]
    r, Jc, Jp = (a.numpy() for a in linearize(c, X, tp.pt2d, tp.w))
    np.testing.assert_allclose(r, r_ref, atol=1e-10)
    np.testing.assert_allclose(Jc, Jc_ref, atol=1e-10)
    np.testing.assert_allclose(Jp, Jp_ref, atol=1e-10)
    np.testing.assert_allclose(project_residual(c, X, tp.pt2d, tp.w).numpy(),
                               r_ref, atol=1e-10)
    assert np.all(r[k_zero] == 0) and np.all(Jc[k_zero] == 0) \
        and np.all(Jp[k_zero] == 0)
    assert float(objective(tp)) == pytest.approx(
        0.5 * float(np.sum(r_ref ** 2)), rel=1e-12)


def test_import_never_loads_jax():
    """Importing every module of the port pulls in neither jax nor the
    JAX package."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys
        for name in list(sys.modules):
            if name.split(".")[0] in ("jax", "jaxlib",
                                      "bundleadjustment_jl_tpu"):
                del sys.modules[name]

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "jaxlib",
                                          "bundleadjustment_jl_tpu"):
                    raise ImportError("the port imported " + name)
                return None

        sys.meta_path.insert(0, Block())
        import bundleadjustment_jl_tpu_torch as pkg
        names = []
        for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(mod.name)
            names.append(mod.name)
        print(" ".join(names))
        print("jax" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, loaded = out.stdout.strip().splitlines()
    assert loaded == "False"
    # the measurement path's modules are among those imported
    for mod in ("bench", "mv_sweep", "tile_sweep", "kernel_profile",
                "utils.timing", "ops.stream_probe", "ops.plans", "cli",
                "benchmark.precision", "benchmark.runner", "io.native",
                "ops.jacobian", "utils.profiling"):
        assert f"bundleadjustment_jl_tpu_torch.{mod}" in names.split(), mod


@pytest.mark.parametrize("fn", [
    "io.synthetic.synthetic_bal", "io.bal.read_bal", "io.bal.load_fixture",
    "models.problem.BAProblem.from_arrays",
    "models.problem.BAProblem.from_numpy"])
def test_problem_constructors_default_to_the_card(fn):
    """Every entry point that builds a problem puts it on the card unless
    the caller asks for the CPU."""
    import importlib
    import inspect
    mod, _, attr = fn.rpartition(".")
    if mod.endswith("BAProblem"):
        obj = getattr(importlib.import_module(
            "bundleadjustment_jl_tpu_torch." + mod.rpartition(".")[0]),
            "BAProblem")
    else:
        obj = importlib.import_module("bundleadjustment_jl_tpu_torch." + mod)
    default = inspect.signature(getattr(obj, attr)).parameters["device"]
    assert default.default == "cuda"
