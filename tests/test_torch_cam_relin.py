"""K2 cam90 re-derived in camera order (the stage ``cam_relin_cam90``,
`ops/fused_schur.py`), on the CPU.

- Its plain twin is K2 cam90's plain twin over the plain K7's ``JR_t``,
  bit for bit, in float32 and float64, on a problem with padding rows
  (w = 0), a row on its camera's plane (z = 0), a camera without rows
  (exact zeros) and a theta = 0 camera; in float64 within 1e-10 of the
  sums over the Jacobian by forward-mode AD. Through a bfloat16 solve's
  stage table (operands widened, the output rounded) it equals K2 cam90's
  stage over that table's K7 ``JR_t``, bit for bit.
- ``assemble_blocks`` (a spy table) takes the stage on routes B1 and B2
  whatever K2 cam90's shared budget (``plans.SMEM_BUDGET`` 0 or ample),
  and on route A for CGLS (which assembles as B1), never on routes A and
  C otherwise; the blocks are the same bit for bit.
- ``lm_jit.expected_launches`` puts ``cam_relin_cam90``, and never K2
  cam90 over JR, in the assembly of B1, B2 and CGLS on A; a float32
  solve on B1 and B2 makes those launches (the plain twins counted) and
  ``expected_host_reads`` of them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu_torch.io import synthetic_bal
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import _cuda, normal, plans
from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
from bundleadjustment_jl_tpu_torch.ops import linearize as lz
from bundleadjustment_jl_tpu_torch.ops.jacobian import jacobian_blocks_ad
from bundleadjustment_jl_tpu_torch.solver import lm_jit
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    expected_host_reads, expected_launches, levenberg_marquardt_jit)
from bundleadjustment_jl_tpu_torch.utils import profiling

torch.set_num_threads(1)

# An ample budget: every camera's sums fit beside the stages.
AMPLE = 1 << 40


def edge_problem(dtype):
    """A synthetic problem (float64 host arrays) rebuilt with a camera 0
    that no row sees, camera 1 at theta = 0 with the point of one of its
    rows moved onto its plane (z = 0), and rows padded to 64."""
    p = synthetic_bal(ncams=9, npnts=150, obs_per_pnt=4, noise_px=0.5,
                      seed=5, device="cpu")[0]
    m = p.nobs
    cams = torch.cat([p.cams[:1], p.cams]).numpy().copy()
    points = p.points.numpy().copy()
    cam_idx = p.cam_idx[:m].numpy() + 1
    cams[1, 0:3] = 0.0
    k = int(np.flatnonzero(cam_idx == 1)[0])
    points[int(p.pnt_idx[k]), 2] = -cams[1, 5]
    return BAProblem.from_arrays(cams, points, cam_idx, p.pnt_idx[:m].numpy(),
                                 p.pt2d[:m].numpy(), dtype=dtype,
                                 pad_obs_to=64, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_twin_is_k2_cam90_over_the_plain_k7_jr(dtype):
    p = edge_problem(dtype)
    assert p.nobs_pad > p.nobs and bool((p.w[p.nobs:] == 0).all())
    JR_t = lz._linearize_plain(p, p.cams, p.points)[0]
    on_plane = (p.w != 0) & (JR_t == 0).all(0)
    assert int(on_plane.sum()) == 1
    assert int(p.cam_idx[on_plane]) == 1
    want = fs._cam_reduce_cam90_plain(JR_t, p)
    got = fs._cam_relin_cam90_plain(p, p.cams, p.points)
    assert got.dtype == dtype and got.shape == (p.ncams, 90)
    assert torch.equal(got, want)
    assert torch.equal(normal.KERNELS.cam_relin_cam90(p, p.cams, p.points),
                       want)
    assert bool((got[0] == 0).all()) and bool((got[1:] != 0).any(1).all())
    if dtype == torch.float64:
        r = JR_t[lz.R0:lz.R0 + 2].T
        Jc, _ = jacobian_blocks_ad(p)
        rows = torch.cat([torch.einsum("nia,nid->nad", Jc, Jc).reshape(-1, 81),
                          torch.einsum("nia,ni->na", Jc, r)], dim=1)
        ad = torch.zeros_like(got).index_add_(0, p.cam_idx.long(), rows)
        torch.testing.assert_close(got, ad, rtol=1e-10, atol=1e-10)


def test_bf16_stage_widens_as_k2_cam90s():
    p = edge_problem(torch.float64).astype(torch.bfloat16)
    st = normal.stages_for(normal.KERNELS, torch.bfloat16)
    got = st.cam_relin_cam90(p, p.cams, p.points)
    JR_t, _ = st.linearize_w_kminor(p, p.cams, p.points, torch.bfloat16)
    assert JR_t.dtype == torch.float32
    want = fs._cam_reduce_cam90_plain(JR_t, p).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(got, fs._cam_relin_cam90_plain(
        p, p.cams.float(), p.points.float()).to(torch.bfloat16))


def spy_table(calls):
    """``normal.KERNELS`` with the camera walk noting its calls."""
    fn = normal.KERNELS.cam_relin_cam90

    def call(*args, **kwargs):
        calls.append("cam_relin_cam90")
        return fn(*args, **kwargs)
    return normal.KERNELS._replace(cam_relin_cam90=call)


@pytest.fixture(scope="module")
def prob32():
    return synthetic_bal(ncams=12, npnts=300, obs_per_pnt=4, noise_px=1.0,
                         perturb=2e-2, seed=2, dtype=torch.float32,
                         pad_obs_to=128, device="cpu")[0]


@pytest.mark.parametrize("route", normal.ROUTES)
@pytest.mark.parametrize("budget", [0, AMPLE])
def test_assembly_takes_the_walk_past_shared_memory(monkeypatch, prob32,
                                                    route, budget):
    calls = []
    ref = normal.assemble_blocks(prob32, route=route)
    monkeypatch.setattr(plans, "SMEM_BUDGET", budget)
    got = normal.assemble_blocks(prob32, route=route,
                                 stages=spy_table(calls))
    split = route in ("scatter_split", "sorted_relin")
    assert calls == (["cam_relin_cam90"] if split else [])
    for a, b in zip(got, ref):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_cgls_assembly_on_a_takes_the_walk(prob32):
    """CGLS keeps K7's JR, so route A assembles as B1: the walk's sums,
    bit for bit K2 cam90's over that JR."""
    calls = []
    blocks = normal.assemble_blocks(prob32, route="fused", with_jr=True,
                                    stages=spy_table(calls))
    assert calls == ["cam_relin_cam90"] and blocks.route == "scatter_split"
    want = fs._cam_reduce_cam90_plain(blocks.JR_t, prob32)
    assert torch.equal(blocks.Hcc_f, want[:, :81].reshape(-1))
    assert torch.equal(blocks.g_c_f, want[:, 81:].reshape(-1))


@pytest.mark.parametrize("solver", ["pcg", "power", "dense", "cgls"])
@pytest.mark.parametrize("route", normal.ROUTES)
def test_expected_launches_swap_k2_cam90(route, solver):
    got = expected_launches(route, 7, 5, 30, solver)
    asm = "scatter_split" if solver == "cgls" and route == "fused" else route
    split = asm in ("scatter_split", "sorted_relin")
    assert "cam_reduce_cam90" not in got
    assert got.get("cam_relin_cam90", 0) == (6 if split else 0)
    assert got.get("linearize", 0) == (0 if asm == "fused" else 6)


def counting_stages(counts):
    """``normal.KERNELS`` with each stage its plain twin, counting its calls
    under the launch key of its wrapper (``_cuda.LAUNCHES``)."""
    keys = {"assemble_scatter": "assemble", "linearize_w_kminor": "linearize",
            "jtj_pnt_reduce": "seg_prod_pnt12",
            "jtj_cam_reduce": "seg_prod_cam90",
            "cam_reduce_wcw_rhs": "cam_reduce",
            "matvec_cam_scatter": "matvec",
            "cam_reduce_wcw": "cam_reduce_wcw81",
            "wcw_cam_reduce": "seg_prod_wcw81",
            "wtv_point_reduce": "seg_block_point",
            "wt_cam_reduce": "seg_block_camera",
            "objective_scatter": "objective", "point_inv_rhs": "point_inv",
            "point_quad": "point_quad", "dense_schur": "dense_pairs"}

    def wrap(field, fn):
        def call(*args, **kwargs):
            counts[keys.get(field, field)] += 1
            return fn(*args, **kwargs)
        return call
    return normal.Stages(*[wrap(f, fn) for f, fn in
                           zip(normal.Stages._fields, normal.PLAIN)])


@pytest.mark.parametrize("route", ["scatter_split", "sorted_relin"])
def test_solve_past_shared_memory_launches_the_walk(monkeypatch, prob32,
                                                    route):
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    opts = dict(max_iters=8, pcg_max_iters=200, lam0_mode="diag")
    ref = levenberg_marquardt_jit(dataclasses.replace(prob32, plans={}),
                                  **opts)
    counts = dict.fromkeys(_cuda.LAUNCHES, 0)
    monkeypatch.setattr(normal, "KERNELS", counting_stages(counts))
    profiling.reset_counters()
    res = levenberg_marquardt_jit(dataclasses.replace(prob32, plans={}),
                                  **opts)
    it = int(res.iterations)
    assert it >= 2 and res.naccepts > 0
    expect = dict.fromkeys(counts, 0)
    expect.update(lm_jit.expected_launches(
        route, it, res.naccepts, int(res.hist_cg[:it].sum())))
    assert counts == expect
    assert profiling.COUNTERS["host_reads"] == expected_host_reads(
        it, int(res.naccepts), res.hist_cg, 200)
    assert (res.status, res.iterations, res.naccepts) == (
        ref.status, ref.iterations, ref.naccepts)
    assert res.objective == ref.objective
    assert torch.equal(res.cams, ref.cams)
