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

import pytest
import torch

from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu_torch.ops import _cuda
from bundleadjustment_jl_tpu_torch.ops import fused_assemble as fa
from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
from bundleadjustment_jl_tpu_torch.ops.normal import inv3x3_damped_flat
from bundleadjustment_jl_tpu_torch.solver.lm_jit import levenberg_marquardt_jit

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


@pytest.mark.cuda
def test_cuda_float64_raises(card_problem):
    p = card_problem
    with pytest.raises(TypeError, match="float64"):
        fa.assemble_scatter(p, p.cams.double(), p.points.double())


@pytest.mark.cuda
def test_solve_on_card_runs_every_kernel(card_problem):
    _cuda.reset_launches()
    res = levenberg_marquardt_jit(card_problem, max_iters=30,
                                  lam0_mode="diag")
    it = res.iterations
    assert res.status_name() in ("first_order", "small_obj_change")
    assert _cuda.LAUNCHES == {
        "assemble": 1 + res.naccepts, "cam_reduce": it,
        "matvec": int(res.hist_cg[:it].sum()) + 2 * it, "objective": it}


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
