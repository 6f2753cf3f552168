"""The port's four kernel modules against the JAX package, on the CPU.

On the CPU each wrapper runs its plain PyTorch version, which is what the
CUDA kernels are checked against on the card. Each plain version is held
twice to the JAX package:

- in f32 against the Pallas kernel it replaces, in interpret mode on the
  fused camera-scatter route, to the reassociation tolerance of
  ``tests/test_cam_scatter.py`` (rtol 1e-4, atol 1e-3; for the assembly's
  large-valued outputs atol 1e-5 of the largest entry, see ``close32``);
- in f64 against the XLA formulation (Pallas off), to rel 1e-10.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.ops import pallas_assemble, pallas_schur
from bundleadjustment_jl_tpu.ops.normal import assemble_blocks as jax_assemble
from bundleadjustment_jl_tpu.ops.pallas_schur import pad_rows, tile_bounds
from bundleadjustment_jl_tpu.ops.residuals import objective as jax_objective
from bundleadjustment_jl_tpu.ops.schur import (
    back_substitute, quad_form, reduce_system, schur_diag_blocks)
from bundleadjustment_jl_tpu.ops.schur import schur_matvec as jax_matvec
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import _cuda
from bundleadjustment_jl_tpu_torch.ops.fused_assemble import (
    assemble_scatter, objective_scatter)
from bundleadjustment_jl_tpu_torch.ops.fused_schur import (
    cam_reduce_wcw_rhs, matvec_cam_scatter)
from bundleadjustment_jl_tpu_torch.ops.normal import assemble_blocks
from bundleadjustment_jl_tpu_torch.ops.schur import (
    back_substitute_quad, reduce_and_diag, schur_matvec)

F32_TOL = dict(rtol=1e-4, atol=1e-3)


def close32(got, ref):
    """rtol 1e-4 with atol 1e-3, or 1e-5 of the largest entry where the
    entries run past 1e2: the two packages' f32 chains round differently
    (sin/cos, contraction), ~1e-7 of the scale on cancelling entries."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(
        got, ref, rtol=1e-4, atol=max(1e-3, 1e-5 * np.abs(ref).max()))


def to_port(jp):
    return BAProblem.from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS})


def close64(got, ref):
    """rel 1e-10 against the largest reference entry."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


@contextlib.contextmanager
def pallas_interpret():
    """The JAX package's fused camera-scatter route, interpreted on the CPU
    (flags restored afterwards, as its own tests do)."""
    old = (pallas_schur.PALLAS_MODE, pallas_schur.INTERPRET,
           pallas_schur.CAM_SCATTER)
    try:
        pallas_schur.set_mode(True)
        pallas_schur.INTERPRET = True
        pallas_schur.CAM_SCATTER = True
        yield
    finally:
        (pallas_schur.PALLAS_MODE, pallas_schur.INTERPRET,
         pallas_schur.CAM_SCATTER) = old


@pytest.fixture(scope="module")
def prob32():
    jp, _ = jax_synthetic(ncams=9, npnts=300, obs_per_pnt=4, seed=11,
                          dtype=jnp.float32, noise_px=1.0, perturb=2e-2,
                          pad_obs_to=1280)
    return jp, to_port(jp)


@pytest.fixture(scope="module")
def prob64():
    jp, _ = jax_synthetic(ncams=7, npnts=120, obs_per_pnt=4, seed=12,
                          noise_px=1.0, perturb=2e-2)
    return jp, to_port(jp)


@pytest.fixture(scope="module")
def operands32(prob32):
    """Shared per-point operands: SPD symmetric C ~ Hpp_inv, t, g_p, v."""
    jp, tp = prob32
    rng = np.random.default_rng(0)
    A = rng.standard_normal((jp.npnts, 3, 3)).astype(np.float32)
    C = (A @ np.swapaxes(A, 1, 2) * 1e-3
         + 1e-3 * np.eye(3, dtype=np.float32)).reshape(-1)
    t = rng.standard_normal((jp.npnts, 3)).astype(np.float32)
    gp = rng.standard_normal(jp.npnts * 3).astype(np.float32)
    v = rng.standard_normal((jp.ncams, 9)).astype(np.float32)
    with pallas_interpret():
        blocks = jax_assemble(jp, with_jr=False, kminor=True)
    return dict(W_t=np.asarray(blocks.W_t), C=C, t=t, gp=gp, v=v)


# ---------------------------------------------------------------- K1
def test_assemble_f32_matches_pallas(prob32):
    jp, tp = prob32
    with pallas_interpret():
        ref = jax_assemble(jp, with_jr=False, kminor=True)
    W_t, hp12, hc90, obj = assemble_scatter(tp, tp.cams, tp.points)
    close32(W_t, np.asarray(ref.W_t)[:27])
    close32(hp12[:, :9].reshape(-1), ref.Hpp_f)
    close32(hp12[:, 9:].reshape(-1), ref.g_p_f)
    close32(hc90[:, :81].reshape(-1), ref.Hcc_f)
    close32(hc90[:, 81:].reshape(-1), ref.g_c_f)
    assert float(obj) == pytest.approx(float(ref.obj), rel=1e-5)


def test_assemble_f64_matches_xla(prob64):
    jp, tp = prob64
    ref = jax_assemble(jp, with_jr=False)
    got = assemble_blocks(tp)
    close64(got.W_t.T.reshape(-1), ref.W_f)
    for name in ("g_c_f", "g_p_f", "Hcc_f", "Hpp_f"):
        close64(getattr(got, name), getattr(ref, name))
    assert float(got.obj) == pytest.approx(float(ref.obj), rel=1e-12)


# ---------------------------------------------------------------- K2
def test_cam_reduce_f32_matches_pallas(prob32, operands32):
    jp, tp = prob32
    o = operands32
    h6 = o["C"].reshape(-1, 9)[:, [0, 1, 2, 4, 5, 8]]
    op16 = pad_rows(jnp.asarray(np.concatenate([h6.T, o["t"].T])), 16)
    with pallas_interpret():
        ref = pallas_schur.cam_scatter_reduce(
            jnp.asarray(o["W_t"]), jp.cam_idx,
            tile_bounds(jp.pnt_starts, jp.npnts), jp.ncams, d_out=90,
            prod=pallas_schur._prod_wcw_rhs, idx_row=jp.pnt_idx,
            op_t=op16)
    got = cam_reduce_wcw_rhs(torch.from_numpy(o["W_t"][:27].copy()), tp,
                             torch.from_numpy(o["C"]),
                             torch.from_numpy(o["t"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_cam_reduce_f64_matches_xla(prob64):
    jp, tp = prob64
    lam = 0.37
    sys_ref = reduce_system(jp, jax_assemble(jp, with_jr=False), lam)
    sys, Sd = reduce_and_diag(tp, assemble_blocks(tp), lam)
    close64(sys.b_f, sys_ref.b_f)
    close64(Sd, schur_diag_blocks(sys_ref))
    close64(sys.Hpp_inv_f, sys_ref.Hpp_inv_f)


# ---------------------------------------------------------------- K3
@pytest.mark.parametrize("form", ["matvec", "back_substitution"])
def test_matvec_f32_matches_pallas(prob32, operands32, form):
    jp, tp = prob32
    o = operands32
    kw = {} if form == "matvec" else dict(sign=-1.0, with_dp=True)
    with pallas_interpret():
        ref = pallas_schur.matvec_cam_scatter(
            jnp.asarray(o["W_t"]), jnp.asarray(o["v"]), jp.cam_idx,
            jp.pnt_idx, jnp.asarray(o["C"]),
            tile_bounds(jp.pnt_starts, jp.npnts), jp.ncams, jp.npnts,
            gp_f=None if form == "matvec" else jnp.asarray(o["gp"]), **kw)
    got = matvec_cam_scatter(
        torch.from_numpy(o["W_t"][:27].copy()), torch.from_numpy(o["v"]), tp,
        torch.from_numpy(o["C"]),
        gp_f=None if form == "matvec" else torch.from_numpy(o["gp"]), **kw)
    if form == "matvec":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   **F32_TOL)
        np.testing.assert_allclose(
            got[1].numpy(), np.asarray(ref[1])[:3, :jp.npnts].T,
            rtol=1e-4, atol=1e-5)


def test_matvec_and_back_substitution_f64_match_xla(prob64):
    jp, tp = prob64
    lam = 0.37
    jblocks = jax_assemble(jp, with_jr=False)
    sys_ref = reduce_system(jp, jblocks, lam)
    blocks = assemble_blocks(tp)
    sys, _ = reduce_and_diag(tp, blocks, lam)
    rng = np.random.default_rng(3)
    v = rng.standard_normal((jp.ncams, 9))
    close64(schur_matvec(sys, torch.from_numpy(v)),
            jax_matvec(sys_ref, jnp.asarray(v)))
    dc = 1e-2 * v
    dp_ref = back_substitute(sys_ref, jnp.asarray(dc))
    dp, Jd2 = back_substitute_quad(tp, blocks, sys, torch.from_numpy(dc))
    close64(dp, dp_ref)
    assert float(Jd2) == pytest.approx(
        float(quad_form(jp, jblocks, jnp.asarray(dc), dp_ref)), rel=1e-10)


# ---------------------------------------------------------------- K4
def _trial_states(jp, dtype):
    rng = np.random.default_rng(9)
    dc = (rng.standard_normal((jp.ncams, 9)) * 1e-2).astype(dtype)
    dp = (rng.standard_normal((jp.npnts, 3)) * 1e-2).astype(dtype)
    scales = np.asarray([1.0, 0.5, 0.25], dtype)
    cams_all = np.asarray(jp.cams)[None] + scales[:, None, None] * dc[None]
    pts_all = np.asarray(jp.points)[None] + scales[:, None, None] * dp[None]
    return cams_all, pts_all, dc, dp, scales


def test_objective_f32_matches_pallas(prob32):
    jp, tp = prob32
    cams_all, _, _, dp, scales = _trial_states(jp, np.float32)
    C = pallas_schur._chunk_rows(jp.nobs_pad)
    width = -(-(jp.npnts + C + 256) // 128) * 128
    with pallas_interpret():
        ref = pallas_assemble.objective_scatter(
            pallas_assemble.pack_pw(jp),
            pallas_assemble.stack_trial_points(
                jp.points, jnp.asarray(dp), jnp.asarray(scales), width),
            jnp.asarray(cams_all),
            pallas_assemble.trial_point_offsets(jp.pnt_idx, jp.nobs_pad,
                                                width, C))
    pts_all = (tp.points[None] + torch.from_numpy(scales)[:, None, None]
               * torch.from_numpy(dp)[None])
    got = objective_scatter(tp, torch.from_numpy(cams_all), pts_all)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_objective_f64_matches_xla(prob64):
    jp, tp = prob64
    cams_all, pts_all, _, _, _ = _trial_states(jp, np.float64)
    got = objective_scatter(tp, torch.from_numpy(cams_all),
                            torch.from_numpy(pts_all))
    ref = [float(jax_objective(jp, jnp.asarray(c), jnp.asarray(p)))
           for c, p in zip(cams_all, pts_all)]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10)


# ---------------------------------------------------------------- routing
def test_cpu_tensors_take_the_plain_route(prob64):
    """A CPU solve step launches no kernel and never loads the library."""
    _, tp = prob64
    _cuda.reset_launches()
    assemble_scatter(tp, tp.cams, tp.points)
    assert not any(_cuda.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.require(tp.cams, "cams", torch.float32)


def test_loader_raises_without_nvcc(tmp_path, monkeypatch):
    """No nvcc -> the loader raises; it never returns a stub."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_cuda, "NVCC_DEFAULT", tmp_path / "nvcc")
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    _cuda.lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _cuda.lib()
    finally:
        _cuda.lib.cache_clear()
    assert not list((tmp_path / "build").rglob("*.so"))
