"""The port's CUDA kernels on a card, and ``chip_smoke.py``'s refusal
without one.

This file imports neither jax nor the JAX package, so the card tests run
on a GPU machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider \\
        -o addopts="" --noconftest

Without a card they skip (the ``cuda`` marker), and the chip_smoke test
checks that the script refuses to run.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu_torch.kernel_profile import trial_states
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import _cuda
from bundleadjustment_jl_tpu_torch.ops import dense_schur as ds
from bundleadjustment_jl_tpu_torch.ops import fused_assemble as fa
from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
from bundleadjustment_jl_tpu_torch.ops import linearize as lz
from bundleadjustment_jl_tpu_torch.ops import normal, plans
from bundleadjustment_jl_tpu_torch.ops import point_block as pb
from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
from bundleadjustment_jl_tpu_torch.ops.normal import ROUTES, inv3x3_damped_flat
from bundleadjustment_jl_tpu_torch.solver import lm, lm_jit
from bundleadjustment_jl_tpu_torch.solver.lm_jit import levenberg_marquardt_jit

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def close(got, ref, rtol=1e-4, afrac=1e-4):
    """|got - ref| <= rtol |ref| + afrac max|ref|: f32 sums taken in
    another order (the plain version's index_add_ is itself unordered),
    with cancelling entries judged against the output's scale."""
    torch.testing.assert_close(got, ref, rtol=rtol,
                               atol=afrac * float(ref.abs().max()))


@pytest.fixture
def card_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return synthetic_bal(ncams=12, npnts=900, obs_per_pnt=4, seed=3,
                         noise_px=1.0, perturb=2e-2, dtype=torch.float32,
                         pad_obs_to=512, device="cuda")[0]


@pytest.mark.cuda
def test_kernels_match_plain_on_card(card_problem):
    p = card_problem
    out = fa.assemble_scatter(p, p.cams, p.points)
    ref = fa._assemble_plain(p, p.cams, p.points)
    for a, b in zip(out, ref):
        close(a, b, afrac=1e-5)
    W_t, hp12 = out[0], out[1]
    hpp_inv = inv3x3_damped_flat(hp12[:, :9].reshape(-1), 10.0)
    t = hp12[:, 9:].contiguous()
    close(fs.cam_reduce_wcw_rhs(W_t, p, hpp_inv, t),
          fs._cam_reduce_wcw_rhs_plain(W_t, p, hpp_inv, t))
    v = torch.ones((p.ncams, 9), device="cuda")
    gp = t.reshape(-1)
    got = fs.matvec_cam_scatter(W_t, v, p, hpp_inv, gp_f=gp, sign=-1.0,
                                with_dp=True)
    want = fs._matvec_plain(W_t, v, p, hpp_inv, gp, -1.0)
    for a, b in zip(got, want):
        close(a, b)
    cams_all = p.cams[None].contiguous()
    pts_all = p.points[None].contiguous()
    torch.testing.assert_close(fa.objective_scatter(p, cams_all, pts_all),
                               fa._objective_plain(p, cams_all, pts_all),
                               rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_chain_edge_cases_on_card(card_problem):
    """theta = 0 and theta^2 < 1e-24 cameras (Taylor branch) and a row on
    its camera's plane (z = 0, zeroed) give the plain version's values."""
    p = card_problem
    cams, points = p.cams.clone(), p.points.clone()
    cams[0, 0:3] = 0.0
    cams[1, 0:3] = torch.tensor([1e-13, -2e-13, 0.0])
    k = int(torch.nonzero(p.cam_idx[:p.nobs] == 0)[0])
    points[int(p.pnt_idx[k]), 2] = -cams[0, 5]
    out = fa.assemble_scatter(p, cams, points)
    ref = fa._assemble_plain(p, cams, points)
    for a, b in zip(out, ref):
        close(a, b, afrac=1e-5)
    assert bool((out[0][:, k] == 0).all())
    torch.testing.assert_close(
        fa.objective_scatter(p, cams[None].contiguous(),
                             points[None].contiguous()),
        fa._objective_plain(p, cams[None], points[None]),
        rtol=1e-5, atol=0.0)


@pytest.fixture
def empty_camera_problem(card_problem):
    """``card_problem`` with a camera 0 that no observation sees."""
    p, m = card_problem, card_problem.nobs
    return BAProblem.from_arrays(
        torch.cat([p.cams[:1], p.cams]).cpu().numpy(), p.points.cpu().numpy(),
        p.cam_idx[:m].cpu().numpy() + 1, p.pnt_idx[:m].cpu().numpy(),
        p.pt2d[:m].cpu().numpy(), dtype=torch.float32, pad_obs_to=512,
        device="cuda")


def sorted_operands(p):
    """Camera-sorted route operands at the problem's state: JR, W and their
    camera-sorted copies, a damped Hpp_inv, g_p and a camera vector."""
    JR_t, W_t = lz.linearize_w_kminor(p, p.cams, p.points)
    perm = p.cam_perm.long()
    hp12 = sr.jtj_pnt_reduce(JR_t, p)
    return dict(JR_t=JR_t, W_t=W_t, JR_cam_t=JR_t[:, perm],
                W_cam_t=W_t[:, perm],
                hpp_inv=inv3x3_damped_flat(hp12[:, :9].reshape(-1), 10.0),
                gp=hp12[:, 9:].reshape(-1).contiguous(),
                v=torch.ones((p.ncams, 9), device="cuda"))


@pytest.mark.cuda
def test_sorted_kernels_match_plain_on_card(card_problem):
    """K7, K6 (three products) and K5 (both directions, each point form)
    against their plain versions."""
    p = card_problem
    got = lz.linearize_w_kminor(p, p.cams, p.points)
    for a, b in zip(got, lz._linearize_plain(p, p.cams, p.points)):
        close(a, b, afrac=1e-5)
    o = sorted_operands(p)
    close(sr.jtj_pnt_reduce(o["JR_t"], p), sr._jtj_pnt_plain(o["JR_t"], p),
          afrac=1e-5)
    close(sr.jtj_cam_reduce(o["JR_cam_t"], p),
          sr._jtj_cam_plain(o["JR_cam_t"], p), afrac=1e-5)
    close(sr.wcw_cam_reduce(o["W_cam_t"], p, o["hpp_inv"]),
          sr._wcw_cam_plain(o["W_cam_t"], p, o["hpp_inv"]))
    for kw in ({}, dict(hpp_inv_f=o["hpp_inv"]),
               dict(hpp_inv_f=o["hpp_inv"], add_f=o["gp"], sign=-1.0)):
        close(sr.wtv_point_reduce(o["W_t"], o["v"], p, **kw),
              sr._wtv_point_plain(o["W_t"], o["v"], p, **kw))
    t = o["gp"].reshape(-1, 3)
    close(sr.wt_cam_reduce(o["W_cam_t"], t, p),
          sr._wt_cam_plain(o["W_cam_t"], t, p))


def split_kernel_calls(p, o):
    """K2's four products and K8, each as (kernel call, plain call), on
    the operands of :func:`sorted_operands`."""
    t = o["gp"].reshape(-1, 3)
    return {
        "cam_reduce_w_op": (lambda: fs.cam_reduce_w_op(o["W_t"], p, t),
                            lambda: fs._cam_reduce_w_op_plain(o["W_t"], p, t)),
        "cam_reduce_wcw81": (
            lambda: fs.cam_reduce_wcw(o["W_t"], p, o["hpp_inv"]),
            lambda: fs._cam_reduce_wcw_plain(o["W_t"], p, o["hpp_inv"])),
        "cam_reduce_cam90": (
            lambda: fs.cam_reduce_cam90(o["JR_t"], p),
            lambda: fs._cam_reduce_cam90_plain(o["JR_t"], p)),
        "cam_reduce": (
            lambda: fs.cam_reduce_wcw_rhs(o["W_t"], p, o["hpp_inv"], t),
            lambda: fs._cam_reduce_wcw_rhs_plain(o["W_t"], p, o["hpp_inv"],
                                                 t)),
        "linearize_w_only": (
            lambda: lz.linearize_w_only(p, p.cams, p.points),
            lambda: lz._linearize_w_only_plain(p, p.cams, p.points)),
    }


@pytest.mark.cuda
def test_split_kernels_match_plain_on_card(card_problem):
    """K2's four products and K8 against their plain versions, each
    launching once; K8 against K7's W in camera order."""
    p = card_problem
    o = sorted_operands(p)
    for key, (kernel, plain) in split_kernel_calls(p, o).items():
        _cuda.reset_launches()
        got = kernel()
        assert _cuda.LAUNCHES[key] == 1
        close(got, plain(), afrac=1e-5 if key == "linearize_w_only" else 1e-4)
    close(lz.linearize_w_only(p, p.cams, p.points), o["W_cam_t"], afrac=1e-5)


@pytest.mark.cuda
def test_camera_without_rows_gives_exact_zeros_on_card(empty_camera_problem):
    p = empty_camera_problem
    assert int(p.cam_starts[1] - p.cam_starts[0]) == 0
    o = sorted_operands(p)
    outs = [sr.jtj_cam_reduce(o["JR_cam_t"], p),
            sr.wcw_cam_reduce(o["W_cam_t"], p, o["hpp_inv"]),
            sr.wt_cam_reduce(o["W_cam_t"], o["gp"].reshape(-1, 3), p)]
    outs += [kernel() for key, (kernel, _) in split_kernel_calls(p, o).items()
             if key.startswith("cam_reduce")]
    for out in outs:
        assert not out[0].any() and out[1:].abs().max() > 0


@pytest.mark.cuda
def test_cuda_float64_raises(card_problem):
    p = card_problem
    with pytest.raises(TypeError, match="float64"):
        fa.assemble_scatter(p, p.cams.double(), p.points.double())


@pytest.mark.cuda
def test_cuda_float64_raises_on_sorted_wrappers(card_problem):
    p = card_problem
    o = {k: x.double() for k, x in sorted_operands(p).items()}
    calls = [
        lambda: lz.linearize_w_kminor(p, p.cams.double(), p.points.double()),
        lambda: sr.jtj_pnt_reduce(o["JR_t"], p),
        lambda: sr.jtj_cam_reduce(o["JR_cam_t"], p),
        lambda: sr.wcw_cam_reduce(o["W_cam_t"], p, o["hpp_inv"]),
        lambda: sr.wtv_point_reduce(o["W_t"], o["v"], p),
        lambda: sr.wt_cam_reduce(o["W_cam_t"], o["gp"].reshape(-1, 3), p)]
    for call in calls:
        with pytest.raises(TypeError, match="float64"):
            call()


@pytest.mark.cuda
def test_cuda_float64_raises_on_split_wrappers(card_problem):
    p = card_problem
    o = {k: x.double() for k, x in sorted_operands(p).items()}
    calls = [
        lambda: lz.linearize_w_only(p, p.cams.double(), p.points.double()),
        lambda: fs.cam_reduce_w_op(o["W_t"], p, o["gp"].reshape(-1, 3)),
        lambda: fs.cam_reduce_wcw(o["W_t"], p, o["hpp_inv"]),
        lambda: fs.cam_reduce_cam90(o["JR_t"], p)]
    for call in calls:
        with pytest.raises(TypeError, match="float64"):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_solve_on_card_runs_every_kernel(card_problem, monkeypatch, route):
    """Each route launches its kernels as often as the solve's record
    implies (``lm_jit.expected_launches``), and none of the other
    routes'; every W kernel takes a float32 W."""
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    assert normal.kernel_route(card_problem) == route
    _cuda.reset_launches()
    res = levenberg_marquardt_jit(card_problem, max_iters=30,
                                  lam0_mode="diag")
    assert res.status_name() in ("first_order", "small_obj_change")
    it = res.iterations
    expect = dict.fromkeys(_cuda.LAUNCHES, 0)
    expect.update(lm_jit.expected_launches(route, it, res.naccepts,
                                           int(res.hist_cg[:it].sum())))
    assert dict(_cuda.LAUNCHES) == expect
    assert dict(_cuda.W_LAUNCHES) == lm_jit.expected_w_launches(expect, None)


@pytest.mark.cuda
def test_linesearch_solve_on_card_matches_the_plain_route(card_problem,
                                                          monkeypatch):
    """A route-A solve with the line search (S = 1 + ls_max = 5 trial
    states a K4 launch) launches K4 once per iteration and makes the plain
    route's decisions: the same status, iterations within one."""
    for k, v in normal.FORCE_ROUTE["fused"].items():
        monkeypatch.setattr(normal, k, v)
    opts = dict(max_iters=30, lam0_mode="diag", linesearch=True)
    _cuda.reset_launches()
    res = levenberg_marquardt_jit(card_problem, **opts)
    it = res.iterations
    expect = dict.fromkeys(_cuda.LAUNCHES, 0)
    expect.update(lm_jit.expected_launches("fused", it, res.naccepts,
                                           int(res.hist_cg[:it].sum())))
    assert dict(_cuda.LAUNCHES) == expect
    monkeypatch.setattr(normal, "PALLAS_MODE", False)
    _cuda.reset_launches()
    plain = levenberg_marquardt_jit(card_problem, **opts)
    assert not any(_cuda.LAUNCHES.values())
    assert res.status_name() == plain.status_name()
    assert abs(res.iterations - plain.iterations) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_f32_solve_at_any_padding_runs_the_kernels(monkeypatch, route):
    """A float32 problem padded to 8 rows (its row count no multiple of
    128, where the JAX package keeps XLA) solves on its route's kernels,
    launched as often as ``lm_jit.expected_launches`` says: the port's
    kernels take any padding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = synthetic_bal(ncams=12, npnts=900, obs_per_pnt=4, seed=3,
                      noise_px=1.0, perturb=2e-2, dtype=torch.float32,
                      pad_obs_to=8, device="cuda")[0]
    assert p.nobs_pad % 128 != 0
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    _cuda.reset_launches()
    res = levenberg_marquardt_jit(p, max_iters=30, lam0_mode="diag")
    assert res.status_name() in ("first_order", "small_obj_change")
    it = res.iterations
    expect = dict.fromkeys(_cuda.LAUNCHES, 0)
    expect.update(lm_jit.expected_launches(route, it, res.naccepts,
                                           int(res.hist_cg[:it].sum())))
    assert dict(_cuda.LAUNCHES) == expect


@pytest.mark.cuda
def test_default_f64_solve_on_card_takes_the_plain_route():
    """The default problem (float64, on the card) solves on the plain route
    with no kernel launched, and makes the CPU float64 solve's decisions:
    the same status and iterations, objective within rel 1e-9 (the plain
    twins' index_add_ sums with atomics on the card, so not bit for
    bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kw = dict(ncams=12, npnts=900, obs_per_pnt=4, seed=3, noise_px=1.0,
              perturb=2e-2)
    card = synthetic_bal(**kw)[0]
    assert card.dtype == torch.float64 and card.cams.is_cuda
    assert normal.solve_stages(card.dtype) is normal.PLAIN
    opts = dict(max_iters=30, lam0_mode="diag")
    _cuda.reset_launches()
    got = levenberg_marquardt_jit(card, **opts)
    assert not any(_cuda.LAUNCHES.values()), dict(_cuda.LAUNCHES)
    assert got.cams.is_cuda
    ref = levenberg_marquardt_jit(synthetic_bal(**kw, device="cpu")[0],
                                  **opts)
    assert got.status == ref.status and got.iterations == ref.iterations
    assert got.objective == pytest.approx(ref.objective, rel=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_partitioned_solve_on_card_takes_the_plain_route(dtype):
    """A partitioned problem (camera groups, ``pnt_perm``) on the card
    launches no kernel in either dtype. In float64 it makes the CPU
    solve's decisions (the same status and iterations, objective within
    rel 1e-9); in float32 the unpartitioned kernel-route solve's (status,
    iterations within one, objective within rel 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bundleadjustment_jl_tpu_torch.parallel import partition_problem
    kw = dict(ncams=12, npnts=900, obs_per_pnt=4, seed=3, noise_px=1.0,
              perturb=2e-2, dtype=dtype)
    opts = dict(max_iters=30, lam0_mode="diag")
    card, _ = partition_problem(synthetic_bal(**kw)[0], 4)
    assert card.cams.is_cuda and card.pnt_perm is not None
    assert normal.solve_stages(card.dtype, card) is normal.PLAIN
    _cuda.reset_launches()
    got = levenberg_marquardt_jit(card, **opts)
    assert not any(_cuda.LAUNCHES.values()), dict(_cuda.LAUNCHES)
    if dtype == "float64":
        ref = levenberg_marquardt_jit(partition_problem(
            synthetic_bal(**kw, device="cpu")[0], 4)[0], **opts)
        assert (got.status, got.iterations) == (ref.status, ref.iterations)
        assert got.objective == pytest.approx(ref.objective, rel=1e-9)
    else:
        ref = levenberg_marquardt_jit(synthetic_bal(**kw)[0], **opts)
        assert any(_cuda.LAUNCHES.values())
        assert got.status == ref.status
        assert abs(got.iterations - ref.iterations) <= 1
        assert got.objective == pytest.approx(ref.objective, rel=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4099, 1 << 16], ids=["scalar", "float4"])
def test_stream_probe_matches_plain_on_card(n):
    """K9 with 0-2 small rows, on rows whose length is and is not a
    multiple of four floats, against its plain version; one launch each."""
    from bundleadjustment_jl_tpu_torch.ops import stream_probe as sp
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    big = torch.rand((32, n), generator=gen, device="cuda")
    small = [torch.rand((n,), generator=gen, device="cuda") for _ in range(2)]
    for nsmall in (0, 1, 2):
        _cuda.reset_launches()
        got = sp.stream_probe(big, *small[:nsmall])
        assert _cuda.LAUNCHES["stream_probe"] == 1
        torch.testing.assert_close(
            got, sp._stream_probe_plain(big, *small[:nsmall]), rtol=1e-5,
            atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_narrow_w_kernels_match_plain_on_card(card_problem, dtype):
    """Every kernel that reads W, given W in ``dtype``, against its plain
    version (which widens the same stored W); every writer's W to one ulp
    of ``dtype`` plus 1e-6 of the largest entry (the two float32 W differ
    there on cancelling entries before rounding). Each launches its own
    instantiation: no float32 copy of W is made for it."""
    p = card_problem
    o = sorted_operands(p)
    W = lm_jit.narrow_w(o["W_t"], dtype)
    W_cam = W[:, p.cam_perm.long()].contiguous()
    t = o["gp"].reshape(-1, 3)
    readers = [
        (lambda: fs.cam_reduce_wcw_rhs(W, p, o["hpp_inv"], t),
         lambda: fs._cam_reduce_wcw_rhs_plain(W, p, o["hpp_inv"], t)),
        (lambda: fs.cam_reduce_w_op(W, p, t),
         lambda: fs._cam_reduce_w_op_plain(W, p, t)),
        (lambda: fs.cam_reduce_wcw(W, p, o["hpp_inv"]),
         lambda: fs._cam_reduce_wcw_plain(W, p, o["hpp_inv"])),
        (lambda: fs.matvec_cam_scatter(W, o["v"], p, o["hpp_inv"]),
         lambda: fs._matvec_plain(W, o["v"], p, o["hpp_inv"], None, 1.0)[0]),
        (lambda: sr.wtv_point_reduce(W, o["v"], p, hpp_inv_f=o["hpp_inv"]),
         lambda: sr._wtv_point_plain(W, o["v"], p, o["hpp_inv"])),
        (lambda: sr.wt_cam_reduce(W_cam, t, p),
         lambda: sr._wt_cam_plain(W_cam, t, p)),
        (lambda: sr.wcw_cam_reduce(W_cam, p, o["hpp_inv"]),
         lambda: sr._wcw_cam_plain(W_cam, p, o["hpp_inv"]))]
    for kernel, plain in readers:
        close(kernel(), plain())
    eps = torch.finfo(dtype).eps
    writers = [
        (lambda: fa.assemble_scatter(p, p.cams, p.points, dtype)[0],
         lambda: fa._assemble_plain(p, p.cams, p.points, dtype)[0]),
        (lambda: lz.linearize_w_kminor(p, p.cams, p.points, dtype)[1],
         lambda: lz._linearize_plain(p, p.cams, p.points, dtype)[1]),
        (lambda: lz.linearize_w_only(p, p.cams, p.points, dtype),
         lambda: lz._linearize_w_only_plain(p, p.cams, p.points, dtype))]
    for kernel, plain in writers:
        got, ref = kernel(), plain()
        assert got.dtype == ref.dtype == dtype
        fin = torch.isfinite(ref)
        assert torch.equal(fin, torch.isfinite(got))
        ref32 = ref[fin].float()
        torch.testing.assert_close(got[fin].float(), ref32, rtol=eps,
                                   atol=1e-6 * float(ref32.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("route", ROUTES)
def test_facto_solve_on_card_runs_every_kernel(card_problem, monkeypatch,
                                               route, dtype):
    """A solve with W stored in ``dtype`` launches its route's kernels as
    often as its record implies, each W reader on a W stored in ``dtype``
    (the writers on the dtype the assembly writes: bfloat16, or float32
    before float16's range scale), and converges as the float32 solve
    does."""
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    opts = dict(max_iters=30, lam0_mode="diag")
    base = levenberg_marquardt_jit(card_problem, **opts)
    _cuda.reset_launches()
    res = levenberg_marquardt_jit(card_problem, facto_dtype=dtype, **opts)
    assert res.status_name() in ("first_order", "small_obj_change")
    assert res.objective == pytest.approx(base.objective, rel=2e-2)
    it = res.iterations
    expect = dict.fromkeys(_cuda.LAUNCHES, 0)
    expect.update(lm_jit.expected_launches(route, it, res.naccepts,
                                           int(res.hist_cg[:it].sum()),
                                           facto_dtype=dtype))
    assert dict(_cuda.LAUNCHES) == expect
    w_expect = lm_jit.expected_w_launches(expect, dtype)
    assert dict(_cuda.W_LAUNCHES) == w_expect and w_expect[dtype] > 0


def edge_problem(case):
    """Shapes at the edges of K2's and K1's tiles, K5's, K6 pnt12's and
    K1's point ranges, K5's camera-direction column ranges and K4's row
    blocks (on the card): one camera holding every real row; more cameras
    (700) than a K2 tile has rows (512), each of a few rows; a point with
    more rows (2000) than a K5 chunk (1536), points without rows, and a
    padding tail (to 8192 rows) longer than one, on the last point; a
    camera with more rows (~9000) than several column ranges (2048);
    cameras without rows, and a row count (1203) no multiple of 4 (the
    scalar paths of the 16 B loads)."""
    rng = np.random.default_rng(7)
    pad = 512
    if case == "one_camera":
        ncams, npnts = 3, 300
        pnt = np.repeat(np.arange(npnts), 4)
        cam = np.ones_like(pnt)
    elif case == "many_cameras":
        ncams, npnts = 700, 400
        pnt = np.repeat(np.arange(npnts), 5)
        cam = rng.integers(0, ncams, size=pnt.size)
    elif case == "long_camera":
        ncams, npnts = 20, 3000
        pnt = np.repeat(np.arange(npnts), 4)
        cam = np.where(rng.random(pnt.size) < 0.75, 0,
                       rng.integers(1, ncams, size=pnt.size))
    elif case == "empty_cameras_ragged":
        ncams, npnts, pad = 50, 401, 1
        pnt = np.repeat(np.arange(npnts), 3)
        cam = rng.integers(10, ncams, size=pnt.size)
    else:
        ncams, npnts, pad = 50, 200, 8192
        seen = np.arange(1, npnts)
        pnt = np.concatenate([np.zeros(2000, int),
                              np.repeat(seen[seen % 7 != 0], 3)])
        cam = rng.integers(0, ncams, size=pnt.size)
    return BAProblem.from_arrays(
        rng.standard_normal((ncams, 9)), rng.standard_normal((npnts, 3)),
        cam, pnt, rng.standard_normal((pnt.size, 2)), dtype=torch.float32,
        pad_obs_to=pad, device="cuda")


def k1_state(p):
    """Cameras 10 units from the points (depths 5-15, focal 500), so the
    chain's values stay in range, and points near the origin."""
    gen = torch.Generator(device="cuda").manual_seed(9)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    cams = torch.cat([0.1 * rand(p.ncams, 3), rand(p.ncams, 2),
                      rand(p.ncams, 1) - 10.0, 1e-3 * rand(p.ncams, 2),
                      torch.full((p.ncams, 1), 500.0, device="cuda")], 1)
    return cams.contiguous(), rand(p.npnts, 3)


def edge_operands(p, dtype):
    """Random W (stored in ``dtype``), JR, an SPD Hpp_inv, point and
    camera vectors for :func:`edge_problem`'s problem, and a state
    (:func:`k1_state`)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    n, npt = p.nobs_pad, p.npnts

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    A = rand(npt, 3, 3)
    return dict(W=lm_jit.narrow_w(rand(27, n), dtype) if dtype != torch.float32
                else rand(27, n), JR=rand(26, n),
                hpp_inv=(A @ A.transpose(1, 2) + torch.eye(3, device="cuda"))
                .reshape(-1).contiguous(), t=rand(npt, 3),
                gp=rand(npt * 3), v=rand(p.ncams, 9), state=k1_state(p))


# The forms of redesigned_calls that write W (compared by close_stored).
W_WRITER_FORMS = ("linearize_w_only",)


def close_stored(got, want):
    """A writer's W against its plain version's, both in the storage
    dtype: one ulp of it plus 1e-6 of the largest entry (the two float32 W
    differ there before rounding)."""
    assert got.dtype == want.dtype
    ref32 = want.float()
    torch.testing.assert_close(got.float(), ref32,
                               rtol=torch.finfo(got.dtype).eps,
                               atol=1e-6 * float(ref32.abs().max()))


def redesigned_calls(p, o):
    """K2's four forms, K5's point direction in its three forms and its
    camera direction, K3 in its two, K6's W C W' and K8 (writing W in the
    dtype of ``o["W"]`` at ``o["state"]``), and, with a float32 W, K2's
    cam90, K6's point product and K4 at 1, 5 and 9 trial states, each as
    (kernel call, plain call)."""
    W, hp, t, gp, v = o["W"], o["hpp_inv"], o["t"], o["gp"], o["v"]
    W_cam = W[:, p.cam_perm.long()].contiguous()
    cams, points = o["state"]
    calls = {
        "seg_block_camera": (lambda: sr.wt_cam_reduce(W_cam, t, p),
                             lambda: sr._wt_cam_plain(W_cam, t, p)),
        "seg_prod_wcw81": (lambda: sr.wcw_cam_reduce(W_cam, p, hp),
                           lambda: sr._wcw_cam_plain(W_cam, p, hp)),
        "linearize_w_only": (
            lambda: lz.linearize_w_only(p, cams, points, W.dtype),
            lambda: lz._linearize_w_only_plain(p, cams, points, W.dtype)),
        "cam_reduce_w_op": (lambda: fs.cam_reduce_w_op(W, p, t),
                            lambda: fs._cam_reduce_w_op_plain(W, p, t)),
        "cam_reduce_wcw81": (lambda: fs.cam_reduce_wcw(W, p, hp),
                             lambda: fs._cam_reduce_wcw_plain(W, p, hp)),
        "cam_reduce": (lambda: fs.cam_reduce_wcw_rhs(W, p, hp, t),
                       lambda: fs._cam_reduce_wcw_rhs_plain(W, p, hp, t)),
        "matvec": (lambda: fs.matvec_cam_scatter(W, v, p, hp),
                   lambda: fs._matvec_plain(W, v, p, hp, None, 1.0)[0]),
        "matvec_dp": (
            lambda: fs.matvec_cam_scatter(W, v, p, hp, gp_f=gp, sign=-1.0,
                                          with_dp=True),
            lambda: fs._matvec_plain(W, v, p, hp, gp, -1.0)),
    }
    for form, kw in (("", {}), ("_fold", dict(hpp_inv_f=hp)),
                     ("_fold_add_sign", dict(hpp_inv_f=hp, add_f=gp,
                                             sign=-1.0))):
        calls["seg_block_point" + form] = (
            lambda kw=kw: sr.wtv_point_reduce(W, v, p, **kw),
            lambda kw=kw: sr._wtv_point_plain(W, v, p, **kw))
    if W.dtype == torch.float32:
        calls["cam_reduce_cam90"] = (
            lambda: fs.cam_reduce_cam90(o["JR"], p),
            lambda: fs._cam_reduce_cam90_plain(o["JR"], p))
        calls["seg_prod_pnt12"] = (lambda: sr.jtj_pnt_reduce(o["JR"], p),
                                   lambda: sr._jtj_pnt_plain(o["JR"], p))
        for S in (1, 5, 9):
            c, x = trial_states(cams, points, S, seed=10)
            calls[f"objective_S{S}"] = (
                lambda c=c, x=x: fa.objective_scatter(p, c, x),
                lambda c=c, x=x: fa._objective_plain(p, c, x))
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", ["one_camera", "many_cameras",
                                  "long_point", "long_camera",
                                  "empty_cameras_ragged"])
def test_redesigned_kernels_at_edge_shapes_on_card(case, dtype):
    """K2's tiled camera reduce (each form), K5's point ranges (each form)
    and column ranges, K3, K6's W C W' column ranges, and K8 and K1
    writing W in ``dtype`` against their plain versions at
    :func:`edge_problem`'s shapes, W in ``dtype``; with a float32 W also
    K6's point product in point ranges and K4 at S = 1, 5 and 9 trial
    states; a second launch gives bit-identical output (fixed-order sums,
    no atomics). The writers' W to one ulp of ``dtype`` plus 1e-6 of its
    largest entry (:func:`close_stored`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = edge_problem(case)
    o = edge_operands(p, dtype)
    for key, (kernel, plain) in redesigned_calls(p, o).items():
        got, again = kernel(), kernel()
        want = plain()
        pairs = (zip(got, want, again) if isinstance(got, tuple)
                 else [(got, want, again)])
        for g, w, a in pairs:
            (close_stored if key in W_WRITER_FORMS else close)(g, w)
            assert torch.equal(g, a), key
    cams, points = o["state"]
    got = fa.assemble_scatter(p, cams, points, dtype)
    again = fa.assemble_scatter(p, cams, points, dtype)
    want = fa._assemble_plain(p, cams, points, dtype)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert got[0].dtype == want[0].dtype == dtype
    close_stored(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        close(g.reshape(-1), w.reshape(-1), afrac=1e-5)
    if case == "long_point":
        seg = p.pnt_starts[1:] - p.pnt_starts[:-1]
        assert int(seg[0]) == 2000 and int(seg[-1]) > 1536
        assert int((seg == 0).sum()) == 28
    if case == "many_cameras":
        assert p.ncams > plans.TILE_ROWS
    if case == "long_camera":
        seg = p.cam_starts[1:] - p.cam_starts[:-1]
        assert int(seg[0]) > 4 * plans.CAM_BLOCK_COLS
    if case == "empty_cameras_ragged":
        assert p.nobs_pad % 4 != 0 and int(p.cam_starts[10]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("budget", ["card", "past_smem"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["one_camera", "many_cameras",
                                  "long_point", "empty_cameras_ragged"])
def test_camera_pass_paths_at_edge_shapes_on_card(monkeypatch, case, dtype,
                                                  budget):
    """K2's four forms and K3 on each path against their plain versions at
    :func:`edge_problem`'s shapes, W in ``dtype``: the card's budget (at
    these sizes, the camera sums in shared memory but for the 45- and
    54-sum forms at 700 cameras), or none (``plans.SMEM_BUDGET`` 0): per-run sums for W
    op and K3, records for the other forms. A second launch gives
    bit-identical output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = edge_problem(case)
    o = edge_operands(p, dtype)
    calls = redesigned_calls(p, o)
    code = _cuda.W_CODES[dtype]
    forms = {"cam_reduce_w_op": "w_op", "cam_reduce_wcw81": "wcw",
             "cam_reduce": "wcw_rhs", "cam_reduce_cam90": "cam90",
             "matvec": "matvec", "matvec_dp": "matvec"}
    if budget == "past_smem":
        monkeypatch.setattr(plans, "SMEM_BUDGET", 0)
    for key, form in forms.items():
        if key not in calls:
            continue
        k = fs.FORMS[form][1]
        path = fs.cam_path(form, p, 0 if form == "cam90" else code)
        if budget == "past_smem":
            assert path[0] == ("runs" if k == 9 else "records"), (key, path)
        elif case == "one_camera":
            assert path[0] == "smem", (key, path)
        kernel, plain = calls[key]
        got, again = kernel(), kernel()
        want = plain()
        pairs = (zip(got, want, again) if isinstance(got, tuple)
                 else [(got, want, again)])
        for g, w, a in pairs:
            close(g, w)
            assert torch.equal(g, a), (key, path)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_camera", "many_cameras",
                                  "long_point", "long_camera",
                                  "empty_cameras_ragged"])
def test_cam_relin_cam90_is_the_records_path_on_card(monkeypatch, case):
    """K2 cam90 re-derived in camera order (``cam_relin_cam90``) at
    :func:`edge_problem`'s shapes and state: bit for bit K2 cam90 over
    K7's JR on its records path (``plans.SMEM_BUDGET`` 0), a second launch
    bit-identical, its plain twin within K2 cam90's tolerance, a camera
    without rows exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = edge_problem(case)
    cams, points = edge_operands(p, torch.float32)["state"]
    JR_t = lz.linearize_w_kminor(p, cams, points)[0]
    got = fs.cam_relin_cam90(p, cams, points)
    again = fs.cam_relin_cam90(p, cams, points)
    monkeypatch.setattr(plans, "SMEM_BUDGET", 0)
    assert fs.cam_path("cam90", p, 0)[0] == "records"
    assert torch.equal(got, fs.cam_reduce_cam90(JR_t, p))
    assert torch.equal(got, again)
    close(got, fs._cam_relin_cam90_plain(p, cams, points), afrac=1e-3)
    empty = (p.cam_starts[1:] == p.cam_starts[:-1]).nonzero().ravel()
    assert bool((got[empty] == 0).all())
    with pytest.raises(TypeError):
        fs.cam_relin_cam90(p, cams.double(), points.double())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["scatter_split", "sorted_relin"])
def test_solve_past_shared_memory_launches_the_walk_on_card(
        card_problem, monkeypatch, route):
    """B1 and B2 launch ``cam_relin_cam90`` for ``[Hcc | g_c]`` as
    ``expected_launches`` says, and make the decisions of a solve whose
    stage sums them by K2 cam90 over K7's JR in shared memory (its sums
    fit at 12 cameras: another order), its objective within 1e-5."""
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    assert fs.cam_path("cam90", card_problem, 0)[0] == "smem"
    k2 = normal.KERNELS._replace(cam_relin_cam90=lambda p, c, x: (
        fs.cam_reduce_cam90(lz.linearize_w_kminor(p, c, x)[0], p)))
    with monkeypatch.context() as m:
        m.setattr(normal, "KERNELS", k2)
        ref = levenberg_marquardt_jit(card_problem, max_iters=30,
                                      lam0_mode="diag")
    _cuda.reset_launches()
    res = levenberg_marquardt_jit(card_problem, max_iters=30,
                                  lam0_mode="diag")
    it = res.iterations
    expect = dict.fromkeys(_cuda.LAUNCHES, 0)
    expect.update(lm_jit.expected_launches(route, it, res.naccepts,
                                           int(res.hist_cg[:it].sum())))
    assert dict(_cuda.LAUNCHES) == expect
    assert (res.status, res.iterations) == (ref.status, ref.iterations)
    assert abs(res.objective - ref.objective) <= 1e-5 * ref.objective


def stored_w(p, cams, points, dtype):
    """``(W_t, w_scale)`` at (cams, points) as a float32 solve stores W in
    ``dtype`` (`lm_jit.maybe_cast_facto`): K7's float32 W, bfloat16 as K7
    writes it, float16 as its range scale times K7's float32 W."""
    if dtype == torch.bfloat16:
        return lz.linearize_w_kminor(p, cams, points, dtype)[1], None
    W = lz.linearize_w_kminor(p, cams, points)[1]
    if dtype == torch.float16:
        s = lm_jit.f16_scale(W)
        return (W * s).to(dtype), s
    return W, None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", ["one_camera", "many_cameras",
                                  "long_point", "long_camera",
                                  "empty_cameras_ragged"])
def test_cam_relin_wcw_rhs_is_the_records_path_on_card(monkeypatch, case,
                                                       dtype):
    """K2 W C W' | W t re-derived in camera order (``cam_relin_wcw_rhs``)
    at :func:`edge_problem`'s shapes and state, W stored in ``dtype`` as
    a float32 solve stores it: bit for bit K2 W C W' | W t over that W on
    its records path (``plans.SMEM_BUDGET`` 0), a second launch
    bit-identical, its plain twin within K2's tolerance, a camera without
    rows exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = edge_problem(case)
    ops = edge_operands(p, torch.float32)
    cams, points = ops["state"]
    hpp, t = ops["hpp_inv"], ops["t"]
    W, s = stored_w(p, cams, points, dtype)

    def walk():
        return fs.cam_relin_wcw_rhs(p, cams, points, hpp, t, dtype, s)
    got, again = walk(), walk()
    monkeypatch.setattr(plans, "SMEM_BUDGET", 0)
    assert fs.cam_path("wcw_rhs", p, _cuda.W_CODES[dtype])[0] == "records"
    assert fs.relin_wcw_rhs(dtype, torch.float32)
    assert torch.equal(got, fs.cam_reduce_wcw_rhs(W, p, hpp, t))
    assert torch.equal(got, again)
    close(got, fs._cam_relin_wcw_rhs_plain(p, cams, points, hpp, t, dtype,
                                           s), afrac=1e-3)
    empty = (p.cam_starts[1:] == p.cam_starts[:-1]).nonzero().ravel()
    assert bool((got[empty] == 0).all())


B1_WALK_CASES = [(torch.float32, None), (torch.float32, torch.bfloat16),
                 (torch.float32, torch.float16), (torch.bfloat16, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("work,facto", B1_WALK_CASES,
                         ids=[f"{str(w)[6:]}-{str(f)[6:]}"
                              for w, f in B1_WALK_CASES])
def test_b1_solve_past_shared_memory_launches_the_wcw_walk_on_card(
        card_problem, monkeypatch, work, facto):
    """Route B1 past shared memory (``plans.SMEM_BUDGET`` 0) launches
    ``cam_relin_wcw_rhs`` once an iteration, as ``expected_launches``
    says, and solves bit for bit as the solve that reads W on K2's records
    path (``fused_schur.relin_wcw_rhs`` off): a float32 solve with W in
    float32, bfloat16 and float16, and a bfloat16 solve (the cascade's low
    stage, its tolerances), whose stage table widens the walk's operands
    as it widens K2's."""
    from bundleadjustment_jl_tpu_torch.benchmark.precision import (
        LOW_STAGE_TOLS)
    for k, v in normal.FORCE_ROUTE["scatter_split"].items():
        monkeypatch.setattr(normal, k, v)
    monkeypatch.setattr(plans, "SMEM_BUDGET", 0)
    p = card_problem.astype(work)
    opts = dict(max_iters=30, lam0_mode="diag", facto_dtype=facto)
    if work == torch.bfloat16:
        opts.update(LOW_STAGE_TOLS)
    with monkeypatch.context() as m:
        m.setattr(fs, "relin_wcw_rhs", lambda *args: False)
        ref = levenberg_marquardt_jit(p, **opts)
    _cuda.reset_launches()
    res = levenberg_marquardt_jit(p, **opts)
    it = res.iterations
    expect = dict.fromkeys(_cuda.LAUNCHES, 0)
    expect.update(lm_jit.expected_launches(
        "scatter_split", it, res.naccepts, int(res.hist_cg[:it].sum()),
        facto_dtype=facto, work_dtype=work))
    assert expect["cam_relin_wcw_rhs"] == it > 0
    assert dict(_cuda.LAUNCHES) == expect
    assert dict(_cuda.W_LAUNCHES) == lm_jit.expected_w_launches(
        expect, facto, work)
    assert res.cams.dtype == work
    assert (res.status, res.iterations, res.naccepts) == (
        ref.status, ref.iterations, ref.naccepts)
    assert res.objective == ref.objective
    assert torch.equal(res.cams, ref.cams)
    assert torch.equal(res.points, ref.points)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["power", "dense", "cgls"])
@pytest.mark.parametrize("route", ["fused", "sorted"])
def test_step_solvers_on_card(card_problem, monkeypatch, route, solver):
    """Each step solver on routes A and C, through the one-shot and the
    host-stepped driver: launches as ``lm_jit.expected_launches`` and
    ``lm.expected_host_launches`` say, a solved status, the objective
    within 1% of the route's PCG solve."""
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    opts = dict(max_iters=30, lam0_mode="diag")
    pcg = levenberg_marquardt_jit(card_problem, **opts)
    _cuda.reset_launches()
    res = levenberg_marquardt_jit(card_problem, **{f"use_{solver}": True},
                                  **opts)
    it = res.iterations
    expect = dict.fromkeys(_cuda.LAUNCHES, 0)
    expect.update(lm_jit.expected_launches(
        route, it, res.naccepts, int(res.hist_cg[:it].sum()), solver))
    assert dict(_cuda.LAUNCHES) == expect
    assert res.status_name() in ("first_order", "small_residual",
                                 "small_step", "small_obj_change")
    assert res.objective == pytest.approx(pcg.objective, rel=1e-2)
    _cuda.reset_launches()
    host = lm.levenberg_marquardt(card_problem,
                                  lm.LMOptions(solver=solver, **opts))
    expect = dict.fromkeys(_cuda.LAUNCHES, 0)
    expect.update(lm.expected_host_launches(route, host, solver))
    assert dict(_cuda.LAUNCHES) == expect
    assert host.solved() and host.cams.is_cuda
    assert host.objective == pytest.approx(pcg.objective, rel=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "sorted"])
def test_chunked_bit_identical_to_one_shot_on_card(card_problem,
                                                   monkeypatch, route):
    """The chunked driver (``chunk_iters=3``) on the card makes the
    one-shot solve bit for bit (fixed-order kernels, no atomics), with its
    launches."""
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    opts = dict(max_iters=30, lam0_mode="diag")
    one = levenberg_marquardt_jit(card_problem, **opts)
    _cuda.reset_launches()
    chk = lm_jit.levenberg_marquardt_jit_chunked(card_problem, chunk_iters=3,
                                                 **opts)
    it = chk.iterations
    expect = dict.fromkeys(_cuda.LAUNCHES, 0)
    expect.update(lm_jit.expected_launches(route, it, chk.naccepts,
                                           int(chk.hist_cg[:it].sum())))
    assert dict(_cuda.LAUNCHES) == expect
    assert (chk.status, chk.iterations, chk.objective) == (
        one.status, one.iterations, one.objective)
    for k in ("hist_obj", "hist_gnorm", "hist_lam", "hist_cg"):
        np.testing.assert_array_equal(getattr(chk, k), getattr(one, k))
    assert torch.equal(chk.cams, one.cams)
    assert torch.equal(chk.points, one.points)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "sorted"])
def test_bf16_working_dtype_on_card_runs_the_kernels(card_problem,
                                                     monkeypatch, route):
    """A solve in a bfloat16 working dtype (the cascade's low stage, its
    tolerances) launches the route's kernels with W written and read in
    bfloat16, and makes the plain route's decisions to the cascade's bar
    (the JAX package's spread between its two XLA precision settings: the
    same status, iterations within 2, objective within 5%)."""
    from bundleadjustment_jl_tpu_torch.benchmark.precision import (
        LOW_STAGE_TOLS)
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    p = card_problem.astype("bfloat16")
    opts = dict(max_iters=40, lam0_mode="diag", **LOW_STAGE_TOLS)
    _cuda.reset_launches()
    res = levenberg_marquardt_jit(p, **opts)
    it = res.iterations
    expect = dict.fromkeys(_cuda.LAUNCHES, 0)
    expect.update(lm_jit.expected_launches(route, it, res.naccepts,
                                           int(res.hist_cg[:it].sum())))
    assert dict(_cuda.LAUNCHES) == expect
    w_expect = lm_jit.expected_w_launches(expect, None, torch.bfloat16)
    assert dict(_cuda.W_LAUNCHES) == w_expect and w_expect[
        torch.bfloat16] > 0
    assert res.cams.dtype == torch.bfloat16 and res.cams.is_cuda
    monkeypatch.setattr(normal, "PALLAS_MODE", False)
    _cuda.reset_launches()
    plain = levenberg_marquardt_jit(p, **opts)
    assert not any(_cuda.LAUNCHES.values())
    assert res.status_name() == plain.status_name() != "exception"
    assert abs(res.iterations - plain.iterations) <= 2
    assert res.objective == pytest.approx(plain.objective, rel=0.05)


POINT_LAM = 0.37


def point_operands(p, edges):
    """The point blocks of ``p``'s assembly (``edges``: then one block for
    each fallback of the damped inverse at POINT_LAM: det 0 once damped, a
    det that overflows, a NaN and an inf diagonal, 904 points in all: a
    ragged last block), and its g_p and a random dp, on the card."""
    hp12 = fa.assemble_scatter(p, p.cams, p.points)[1]
    H, g = hp12[:, :9], hp12[:, 9:12]
    if edges:
        e = torch.zeros((4, 3, 3), device="cuda")
        e[0] = -POINT_LAM * torch.eye(3)
        e[1] = 1e30 * torch.ones((3, 3)) + torch.eye(3)
        e[2] = torch.diag(torch.tensor([float("nan"), 1.0, 2.0]))
        e[3] = torch.diag(torch.tensor([float("inf"), -5.0, 2.0]))
        H = torch.cat([H, e.reshape(4, 9)])
        g = torch.cat([g, torch.ones((4, 3), device="cuda")])
    gen = torch.Generator(device="cuda").manual_seed(9)
    dp = torch.randn(g.shape, generator=gen, device="cuda")
    return H.reshape(-1).contiguous(), g.reshape(-1).contiguous(), dp


def offset_copy(x, k):
    """``x`` as a view ``k`` floats into a larger buffer (not 16-byte
    aligned for odd ``k``): the kernels' scalar staging."""
    buf = torch.empty(x.numel() + k, dtype=x.dtype, device=x.device)
    buf[k:] = x.reshape(-1)
    return buf[k:].view(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["aligned", "offset"])
@pytest.mark.parametrize("scale", [None, 16.0], ids=["no_scale", "scale16"])
@pytest.mark.parametrize("lam", [POINT_LAM, 0.0])
def test_point_inv_matches_its_twin_on_card(card_problem, lam, scale,
                                            layout):
    """The damped inverse (hatted with a float16 W's scale) equal to the
    plain twin's on the card bit for bit, every fallback included, and
    Hpp_inv g_p within 2e-6 of |Hpp_inv| |g_p|; a repeat bit-identical."""
    H, g, _ = point_operands(card_problem, edges=True)
    if layout == "offset":
        H, g = offset_copy(H, 1), offset_copy(g, 1)
    s = None if scale is None else torch.tensor(scale, dtype=torch.float16,
                                                device="cuda")
    _cuda.reset_launches()
    inv, t = pb.point_inv_rhs(H, g, lam, s)
    assert _cuda.LAUNCHES["point_inv"] == 1
    ref_inv, ref_t = pb._point_inv_rhs_plain(H, g, lam, s)
    assert torch.equal(inv, ref_inv)
    assert bool(torch.isfinite(inv).all())
    g_h = g if s is None else g * s
    bound = torch.einsum("pab,pb->pa", ref_inv.abs().reshape(-1, 3, 3),
                         g_h.abs().reshape(-1, 3))
    assert bool(((t - ref_t).abs() <= 2e-6 * bound).all())
    again = pb.point_inv_rhs(H, g, lam, s)
    assert torch.equal(again[0], inv) and torch.equal(again[1], t)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["aligned", "offset"])
def test_point_quad_matches_its_twin_on_card(card_problem, layout):
    """dp' Hpp dp within 1e-5 of the sum of |terms| of the twin's, the
    same bits on every call."""
    H, _, dp = point_operands(card_problem, edges=False)
    if layout == "offset":
        H, dp = offset_copy(H, 1), offset_copy(dp, 3)
    _cuda.reset_launches()
    q = pb.point_quad(H, dp)
    assert _cuda.LAUNCHES["point_quad"] == 1 and q.shape == ()
    terms = dp * torch.einsum("pab,pb->pa", H.reshape(-1, 3, 3), dp)
    assert abs(float(q) - float(pb._point_quad_plain(H, dp))) <= (
        1e-5 * float(terms.abs().sum()))
    for _ in range(3):
        assert torch.equal(pb.point_quad(H, dp), q)


@pytest.mark.cuda
def test_point_blocks_in_a_2_byte_working_dtype_on_card(card_problem):
    """Through a bfloat16 solve's stage table: the inverse equal to the
    plain table's (both round the same float32 inverse), the product and
    the quadratic term within one bfloat16 ulp plus the float32
    tolerances."""
    H, g, dp = point_operands(card_problem, edges=False)
    bf = torch.bfloat16
    H, g, dp = H.to(bf), g.to(bf), dp.to(bf)
    kern = normal.stages_for(normal.KERNELS, bf)
    plain = normal.stages_for(normal.PLAIN, bf)
    inv, t = kern.point_inv_rhs(H, g, POINT_LAM, None)
    ref_inv, ref_t = plain.point_inv_rhs(H, g, POINT_LAM, None)
    assert inv.dtype == t.dtype == bf and torch.equal(inv, ref_inv)
    bound = torch.einsum("pab,pb->pa", ref_inv.float().abs().reshape(-1, 3, 3),
                         g.float().abs().reshape(-1, 3))
    diff = (t.float() - ref_t.float()).abs()
    assert bool((diff <= 2.0 ** -7 * ref_t.float().abs()
                 + 2e-6 * bound).all())
    q, ref_q = kern.point_quad(H, dp), plain.point_quad(H, dp)
    assert q.dtype == bf
    assert abs(float(q) - float(ref_q)) <= 2.0 ** -7 * abs(float(ref_q)) + (
        1e-5 * float((dp.float() * torch.einsum(
            "pab,pb->pa", H.float().reshape(-1, 3, 3), dp.float())).abs()
            .sum()))


@pytest.mark.cuda
def test_point_blocks_refuse_cuda_float64(card_problem):
    H, g, dp = (x.double() for x in point_operands(card_problem, False))
    with pytest.raises(TypeError, match="float64"):
        pb.point_inv_rhs(H, g, POINT_LAM)
    with pytest.raises(TypeError, match="float64"):
        pb.point_quad(H, dp)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "scatter_split"])
def test_solve_launches_the_point_blocks_once_an_iteration(card_problem,
                                                           monkeypatch,
                                                           route):
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    _cuda.reset_launches()
    res = levenberg_marquardt_jit(card_problem, max_iters=30,
                                  lam0_mode="diag")
    expect = lm_jit.expected_launches(route, res.iterations, res.naccepts,
                                      int(res.hist_cg[:res.iterations].sum()))
    assert res.iterations > 0
    for key in ("point_inv", "point_quad"):
        assert _cuda.LAUNCHES[key] == expect[key] == res.iterations


@pytest.mark.cuda
def test_native_parser_builds_into_the_package_build_dir():
    """The BAL parser's .so is built from the shared csrc/bal_parser.cpp
    into the package's _build/ and parses the fixture as the numpy reader
    does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bundleadjustment_jl_tpu_torch.io import bal, native
    so = native.build()
    assert so.parent == ROOT / "bundleadjustment_jl_tpu_torch" / "_build"
    assert native.SOURCE == ROOT / "csrc" / "bal_parser.cpp"
    fixture = str(ROOT / "tests" / "fixtures" / "problem-24-800-pre.txt.bz2")
    for a, b in zip(native.parse_bal_native(fixture), bal._read_raw(fixture)):
        np.testing.assert_array_equal(a, b)
    assert bal.read_bal(fixture).cams.is_cuda


@pytest.mark.cuda
def test_spmd_one_nccl_rank_bit_identical_to_one_shot_on_card():
    """The spmd driver on an NCCL group of one rank at the Dubrovnik-356
    shape (route A) makes the one-shot solve bit for bit (an all-reduce
    over one rank is the identity), with the one-shot's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from datetime import timedelta

    import torch.distributed as dist

    from bundleadjustment_jl_tpu_torch import bench
    from bundleadjustment_jl_tpu_torch.parallel import shard_problem_kminor
    from bundleadjustment_jl_tpu_torch.solver import levenberg_marquardt_spmd

    problem = bench.make_problem("dubrovnik356", 0)
    one = levenberg_marquardt_jit(problem, **bench.SOLVE_OPTS)
    sp = shard_problem_kminor(problem, 1)
    timeout = timedelta(seconds=60)
    dist.init_process_group(
        "nccl", store=dist.TCPStore("localhost", 0, 1, True, timeout=timeout),
        rank=0, world_size=1, timeout=timeout)
    try:
        _cuda.reset_launches()
        res = levenberg_marquardt_spmd(sp, **bench.SOLVE_OPTS)
        counts = dict(_cuda.LAUNCHES)
    finally:
        dist.destroy_process_group()
    it = res.iterations
    expect = dict.fromkeys(_cuda.LAUNCHES, 0)
    expect.update(lm_jit.expected_launches("fused", it, res.naccepts,
                                           int(res.hist_cg[:it].sum())))
    assert counts == expect
    assert (res.status, res.iterations, res.objective, res.naccepts) == (
        one.status, one.iterations, one.objective, one.naccepts)
    for k in ("hist_obj", "hist_gnorm", "hist_lam", "hist_cg"):
        np.testing.assert_array_equal(getattr(res, k), getattr(one, k))
    assert torch.equal(res.cams, one.cams)
    assert torch.equal(res.points, one.points)


def dense_operands(p, dtype):
    """(W_t stored in ``dtype`` as a solve stores it, Hpp_inv, Hcc_l) of
    ``p``'s assembly at lambda 0.5."""
    blocks = normal.assemble_blocks(p)
    if dtype is not None:
        blocks = lm_jit.maybe_cast_facto(blocks, dtype)
    inv, _ = pb.point_inv_rhs(blocks.Hpp_f, blocks.g_p_f, 0.5,
                              blocks.w_scale)
    hcc = normal.damp(blocks.Hcc, 0.5).reshape(-1).contiguous()
    return blocks.W_t, inv, hcc


def duplicate_rows_problem():
    """The card problem's arrays with point 0 seen twice by its first
    camera and point 5 three times by one camera."""
    p = synthetic_bal(ncams=12, npnts=900, obs_per_pnt=4, seed=3,
                      noise_px=1.0, perturb=2e-2, device="cpu")[0]
    n = p.nobs
    cam, pnt = p.cam_idx[:n].numpy(), p.pnt_idx[:n].numpy()
    xy = p.pt2d[:n].numpy()
    rows = [int(np.flatnonzero(pnt == q)[0]) for q in (0, 5, 5)]
    return BAProblem.from_arrays(
        p.cams.numpy(), p.points.numpy(), np.concatenate([cam, cam[rows]]),
        np.concatenate([pnt, pnt[rows]]),
        np.concatenate([xy, xy[rows] + 0.5]), dtype=torch.float32,
        pad_obs_to=512, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [2, 1024])
@pytest.mark.parametrize("hcc", [True, False], ids=["hcc", "part"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_dense_pairs_match_their_twin_on_card(monkeypatch, dtype, hcc,
                                              chunk):
    """S by the pair kernel within float32 rounding of its plain twin's
    (the same pair blocks, summed by atomics on the card), its off-diagonal
    blocks the transposes of each other bit for bit, every entry finite,
    one launch a call, repeats bit-identical. With 2 pairs a chunk the
    merge pass writes every block, with 1024 none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(plans, "PAIR_CHUNK", chunk)
    p = duplicate_rows_problem()
    W, inv, hcc_l = dense_operands(p, dtype)
    hcc_l = hcc_l if hcc else None
    _cuda.reset_launches()
    S = ds.dense_schur(W, p, inv, hcc_l)
    assert _cuda.LAUNCHES["dense_pairs"] == 1
    assert S.dtype == torch.float32 and S.shape == (9 * p.ncams,) * 2
    plan = plans.pair_plan(p)
    assert plan.nmulti == (p.ncams * (p.ncams + 1) // 2 if chunk == 2
                           else 0)
    ref = ds._dense_pairs_plain(W, p, inv, hcc_l)
    assert bool(torch.isfinite(S).all())
    close(S, ref, rtol=1e-5, afrac=1e-6)
    nc = p.ncams
    off = ~torch.eye(nc, dtype=torch.bool, device="cuda").repeat_interleave(
        9, 0).repeat_interleave(9, 1)
    assert torch.equal(S[off], S.T[off])
    for _ in range(2):
        assert torch.equal(ds.dense_schur(W, p, inv, hcc_l), S)


@pytest.mark.cuda
def test_dense_pairs_refuse_cuda_float64(card_problem):
    W, inv, hcc = dense_operands(card_problem, None)
    with pytest.raises(TypeError, match="float64"):
        ds.dense_schur(W.double(), card_problem, inv, hcc)


@pytest.mark.cuda
def test_dense_solve_on_card_makes_the_plain_routes_decisions(
        card_problem, monkeypatch):
    """A float32 dense solve on route A through the pair kernel (launches
    as ``expected_launches`` says, one ``dense_pairs`` an iteration) and
    the same solve on the plain route (the two targets): the same status
    and iterations over six iterations, objectives within 1e-5."""
    opts = dict(max_iters=6, lam0_mode="diag", atol=0.0, rtol=0.0,
                satol=0.0, srtol=0.0, oatol=0.0, ortol=0.0)
    _cuda.reset_launches()
    res = levenberg_marquardt_jit(card_problem, use_dense=True, **opts)
    expect = dict.fromkeys(_cuda.LAUNCHES, 0)
    expect.update(lm_jit.expected_launches(
        "fused", res.iterations, res.naccepts, 0, "dense"))
    assert dict(_cuda.LAUNCHES) == expect and expect["dense_pairs"] == 6
    monkeypatch.setattr(normal, "PALLAS_MODE", False)
    plain = levenberg_marquardt_jit(card_problem, use_dense=True, **opts)
    assert (res.status, res.iterations, res.naccepts) == (
        plain.status, plain.iterations, plain.naccepts)
    assert res.objective == pytest.approx(plain.objective, rel=1e-5)


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    """Without CUDA, or without the checkout beside it, chip_smoke.py exits
    non-zero and prints no result."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: chip_smoke.py would run")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
