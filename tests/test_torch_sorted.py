"""The port's camera-sorted route (``normal.CAM_SCATTER = False``) against
the JAX package's, on the CPU.

On the CPU each wrapper runs its plain PyTorch version, which is what the
CUDA kernels (K7 linearization, K6 segment products, K5 segment block
sums) are checked against on the card.

- f32: the JAX route with ``--pallas`` and camera scatter off, its Pallas
  kernels in interpret mode (flags restored afterwards, as
  ``tests/test_pallas.py`` does), each module fed the same inputs; the
  tolerances of ``tests/test_torch_kernels.py`` (rtol 1e-4, atol 1e-3 or
  1e-5 of the largest entry). The whole solve: same status and
  iterations, objective to rel 1e-5.
- f64: the whole solve against the JAX XLA route (Pallas off): same
  status, iterations, accepts and CG steps, objective to rel 1e-9.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.ops import pallas_linearize, pallas_schur
from bundleadjustment_jl_tpu.ops import schur as jax_schur
from bundleadjustment_jl_tpu.ops.normal import assemble_blocks as jax_assemble
from bundleadjustment_jl_tpu.ops.pallas_schur import gather_k_minor, pad_rows
from bundleadjustment_jl_tpu.solver.lm_jit import (
    levenberg_marquardt_jit as jax_lm)
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import normal, schur
from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
from bundleadjustment_jl_tpu_torch.ops.linearize import linearize_w_kminor
from bundleadjustment_jl_tpu_torch.ops.normal import (
    GNBlocks, assemble_blocks)
from bundleadjustment_jl_tpu_torch.solver.lm_jit import levenberg_marquardt_jit

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

LAM = 0.37


def to_port(jp):
    return BAProblem.from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS},
        device="cpu")


def close32(got, ref):
    """rtol 1e-4 with atol 1e-3, or 1e-5 of the largest entry where the
    entries run past 1e2 (f32 sums taken in another order)."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(
        got, ref, rtol=1e-4, atol=max(1e-3, 1e-5 * np.abs(ref).max()))


def tt(x):
    return torch.from_numpy(np.array(x))


@contextlib.contextmanager
def jax_sorted_route():
    """The JAX package's ``--pallas`` route with camera scatter off, its
    kernels interpreted on the CPU."""
    old = (pallas_schur.PALLAS_MODE, pallas_schur.INTERPRET,
           pallas_schur.CAM_SCATTER)
    try:
        pallas_schur.set_mode(True)
        pallas_schur.INTERPRET = True
        pallas_schur.CAM_SCATTER = False
        yield
    finally:
        (pallas_schur.PALLAS_MODE, pallas_schur.INTERPRET,
         pallas_schur.CAM_SCATTER) = old


@contextlib.contextmanager
def port_sorted_route():
    old = normal.CAM_SCATTER
    try:
        normal.CAM_SCATTER = False
        yield
    finally:
        normal.CAM_SCATTER = old


@pytest.fixture(scope="module")
def prob32():
    jp, _ = jax_synthetic(ncams=9, npnts=300, obs_per_pnt=4, seed=11,
                          dtype=jnp.float32, noise_px=1.0, perturb=2e-2,
                          pad_obs_to=1280)
    return jp, to_port(jp)


@pytest.fixture(scope="module")
def jax32(prob32):
    """The JAX route's linearization and blocks, plus per-point operands
    (SPD symmetric C ~ Hpp_inv, t, g_p) and a camera vector v."""
    jp, _ = prob32
    cxw = pallas_linearize.pack_operands(jp.cams, jp.points, jp.cam_idx,
                                         jp.pnt_idx, jp.pt2d, jp.w)
    with jax_sorted_route():
        JR_t, W_t = pallas_linearize.linearize_w_kminor(cxw)
        blocks = jax_assemble(jp, with_jr=False, kminor=True)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((jp.npnts, 3, 3)).astype(np.float32)
    C = (A @ np.swapaxes(A, 1, 2) * 1e-3
         + 1e-3 * np.eye(3, dtype=np.float32)).reshape(-1)
    return dict(JR_t=np.asarray(JR_t), W_t=np.asarray(W_t), blocks=blocks,
                C=C, t=rng.standard_normal((jp.npnts, 3)).astype(np.float32),
                gp=rng.standard_normal(jp.npnts * 3).astype(np.float32),
                v=rng.standard_normal((jp.ncams, 9)).astype(np.float32))


def cam_sorted(jp):
    perm = jp.cam_perm
    return perm, jp.cam_idx[perm], jp.pnt_idx[perm]


# ---------------------------------------------------------------- K7
def test_linearize_f32_matches_pallas(prob32, jax32):
    jp, tp = prob32
    JR_t, W_t = linearize_w_kminor(tp, tp.cams, tp.points)
    close32(JR_t, jax32["JR_t"][:26])
    close32(W_t, jax32["W_t"][:27])
    assert not JR_t[:, jp.nobs:].any() and not W_t[:, jp.nobs:].any()


# ---------------------------------------------------------------- K6
@pytest.mark.parametrize("product", ["pnt12", "cam90", "wcw81"])
def test_seg_prod_reduce_f32_matches_pallas(prob32, jax32, product):
    jp, tp = prob32
    perm, ci_cs, pi_cs = cam_sorted(jp)
    JR = jnp.asarray(jax32["JR_t"])
    W_cam = jax32["blocks"].W_cam_t
    tperm = tp.cam_perm.long()
    with jax_sorted_route():
        if product == "pnt12":
            ref = pallas_schur.jtj_pnt_reduce(JR, jp.pnt_idx, jp.pnt_starts,
                                              jp.npnts)
            got = sr.jtj_pnt_reduce(tt(JR[:26]), tp)
        elif product == "cam90":
            ref = pallas_schur.jtj_cam_reduce(JR[:, perm], ci_cs,
                                              jp.cam_starts, jp.ncams)
            got = sr.jtj_cam_reduce(tt(JR[:26])[:, tperm], tp)
        else:
            c6 = pallas_schur.hpp_inv_sym6_t(jnp.asarray(jax32["C"]), pi_cs)
            ref = pallas_schur.wcw_cam_reduce(W_cam, c6, ci_cs,
                                              jp.cam_starts, jp.ncams)
            got = sr.wcw_cam_reduce(tt(W_cam[:27]), tp, tt(jax32["C"]))
    close32(got, ref)


# ---------------------------------------------------------------- K5
@pytest.mark.parametrize("form", ["point", "point_fold", "point_fold_add",
                                  "camera"])
def test_seg_block_reduce_f32_matches_pallas(prob32, jax32, form):
    jp, tp = prob32
    _, ci_cs, pi_cs = cam_sorted(jp)
    b = jax32["blocks"]
    C, gp, v, t = (jax32[k] for k in ("C", "gp", "v", "t"))
    fold = dict(point=False, point_fold=True, point_fold_add=True)
    with jax_sorted_route():
        if form == "camera":
            ref = pallas_schur.wt_cam_reduce(
                b.W_cam_t, gather_k_minor(pad_rows(jnp.asarray(t).T, 8),
                                          pi_cs),
                ci_cs, jp.cam_starts, jp.ncams)
            got = sr.wt_cam_reduce(tt(b.W_cam_t[:27]), tt(t), tp)
        else:
            kw = (dict(add_gp=jnp.asarray(gp), sign=-1.0)
                  if form == "point_fold_add" else {})
            ref = pallas_schur.wtv_point_reduce(
                b.W_t, jnp.asarray(v), jp.pnt_idx, jp.cam_idx,
                jp.pnt_starts, jp.npnts,
                hpp_inv_f=jnp.asarray(C) if fold[form] else None, **kw)
            got = sr.wtv_point_reduce(
                tt(b.W_t[:27]), tt(v), tp,
                hpp_inv_f=tt(C) if fold[form] else None,
                add_f=tt(gp) if "add_gp" in kw else None,
                sign=kw.get("sign", 1.0))
    close32(got, ref)


# ---------------------------------------------------------------- assembly
def test_assemble_sorted_f32_matches_pallas(prob32, jax32):
    _, tp = prob32
    ref = jax32["blocks"]
    got = assemble_blocks(tp, route="sorted")
    for name in ("g_c_f", "g_p_f", "Hcc_f", "Hpp_f"):
        close32(getattr(got, name), getattr(ref, name))
    close32(got.W_t, np.asarray(ref.W_t)[:27])
    close32(got.W_cam_t, np.asarray(ref.W_cam_t)[:27])
    assert float(got.obj) == pytest.approx(float(ref.obj), rel=1e-5)


# ---------------------------------------------------------------- Schur
@pytest.mark.parametrize("piece", ["reduce_system", "schur_diag_blocks",
                                   "schur_matvec", "back_substitute",
                                   "quad_form"])
def test_schur_pieces_f32_match_pallas(prob32, jax32, piece):
    """Each route-C Schur piece, fed the JAX route's own blocks."""
    jp, tp = prob32
    jb = jax32["blocks"]
    blocks = GNBlocks(g_c_f=tt(jb.g_c_f), g_p_f=tt(jb.g_p_f),
                      Hcc_f=tt(jb.Hcc_f), Hpp_f=tt(jb.Hpp_f),
                      obj=tt(jb.obj), W_t=tt(jb.W_t[:27]),
                      W_cam_t=tt(jb.W_cam_t[:27]), route="sorted")
    dc = 1e-2 * jax32["v"]
    with jax_sorted_route():
        sys_ref = jax_schur.reduce_system(jp, jb, LAM)
        sys = schur.reduce_system(tp, blocks, LAM)
        if piece == "reduce_system":
            close32(sys.b_f, sys_ref.b_f)
            close32(sys.Hpp_inv_f, sys_ref.Hpp_inv_f)
        elif piece == "schur_diag_blocks":
            close32(schur.schur_diag_blocks(sys),
                    jax_schur.schur_diag_blocks(sys_ref))
        elif piece == "schur_matvec":
            close32(schur.schur_matvec(sys, tt(jax32["v"])),
                    jax_schur.schur_matvec(sys_ref,
                                           jnp.asarray(jax32["v"])))
        else:
            dp_ref = jax_schur.back_substitute(sys_ref, jnp.asarray(dc))
            if piece == "back_substitute":
                close32(schur.back_substitute(sys, tt(dc)), dp_ref)
            else:
                got = schur.quad_form(tp, blocks, tt(dc), tt(dp_ref))
                ref = jax_schur.quad_form(jp, jb, jnp.asarray(dc), dp_ref)
                assert float(got) == pytest.approx(float(ref), rel=1e-4)


# ---------------------------------------------------------------- solves
P9 = dict(ncams=8, npnts=60, obs_per_pnt=3, noise_px=0.4, perturb=2e-3,
          seed=9)
P10 = dict(ncams=6, npnts=40, obs_per_pnt=3, noise_px=0.3, perturb=2e-3,
           seed=10)
NO_STOPS = dict(atol=0.0, rtol=0.0, restol=0.0, satol=0.0, srtol=0.0,
                oatol=0.0, ortol=0.0)


# Kernels (fields of `normal.Stages`) of each route.
FUSED_SITES = ["assemble_scatter", "cam_reduce_wcw_rhs", "matvec_cam_scatter"]
SORTED_SITES = ["linearize_w_kminor", "jtj_pnt_reduce", "jtj_cam_reduce",
                "wcw_cam_reduce", "wtv_point_reduce", "wt_cam_reduce"]


@pytest.mark.parametrize("cam_scatter", [True, False],
                         ids=["fused", "sorted"])
def test_route_switch_keeps_one_route_per_solve(monkeypatch, cam_scatter):
    """``normal.CAM_SCATTER`` picks the route for the whole solve: the
    other route's kernel call sites are never reached."""
    def refuse(*args, **kwargs):
        raise AssertionError("the other route was called")

    monkeypatch.setattr(normal, "KERNELS", normal.KERNELS._replace(
        **dict.fromkeys(SORTED_SITES if cam_scatter else FUSED_SITES,
                        refuse)))
    monkeypatch.setattr(normal, "CAM_SCATTER", cam_scatter)
    # float32 (a float64 solve takes the plain route and reaches no
    # site), no stopping tolerance, so all three iterations run.
    jp, _ = jax_synthetic(**P10, dtype=jnp.float32)
    res = levenberg_marquardt_jit(to_port(jp), max_iters=3, **NO_STOPS)
    assert res.iterations == 3 and res.naccepts > 0


def test_solver_f32_matches_jax_pallas_sorted():
    jp, _ = jax_synthetic(ncams=8, npnts=256, obs_per_pnt=4, seed=5,
                          dtype=jnp.float32, noise_px=1.0, perturb=2e-2,
                          pad_obs_to=1024)
    opts = dict(max_iters=15, pcg_max_iters=60, lam0_mode="diag")
    with jax_sorted_route():
        ref = jax_lm(jp, **opts)
    with port_sorted_route():
        got = levenberg_marquardt_jit(to_port(jp), **opts)
    assert got.status == int(ref.status)
    assert got.iterations == int(ref.iterations)
    robj = float(ref.objective)
    assert abs(got.objective - robj) <= 1e-5 * max(1.0, robj)


@pytest.mark.parametrize("problem_kw, opts", [
    (P9, dict(max_iters=60, pcg_max_iters=200)),
    (P10, dict(max_iters=40, lam0_mode="diag")),
], ids=["P9", "P10"])
def test_solver_f64_sorted_matches_jax_xla(problem_kw, opts):
    jp, _ = jax_synthetic(**problem_kw)
    ref = jax_lm(jp, **opts)
    with port_sorted_route():
        got = levenberg_marquardt_jit(to_port(jp), **opts)
    n = int(ref.iterations)
    assert got.status == int(ref.status)
    assert got.iterations == n and got.naccepts == int(ref.naccepts)
    np.testing.assert_array_equal(got.hist_cg, np.asarray(ref.hist_cg))
    assert got.objective == pytest.approx(float(ref.objective), rel=1e-9)
