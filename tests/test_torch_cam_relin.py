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
from bundleadjustment_jl_tpu_torch.ops import schur
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


# ---------------------------------------------------------------------------
# K2 W C W' | W t re-derived in camera order (the stage
# ``cam_relin_wcw_rhs``): route B1's reduction.
#
# - Its plain twin is K2 W C W' | W t's plain twin over the W the solve
#   stores (the plain K7's, through ``maybe_cast_facto``), bit for bit, in
#   float32 and float64 working dtypes, W stored as it is, in bfloat16 and
#   (float32) in float16 with its range scale; through a bfloat16 solve's
#   stage table it equals K2's stage over that table's K7 W.
# - ``reduce_and_diag`` (a spy table) takes it on route B1 whatever the
#   shared-memory budget: not on route A, not from blocks without their
#   state, not for a float16 W of a 2-byte solve or a float64 W, not on a
#   partitioned problem; the system and the diagonal blocks are the same
#   bit for bit.
# - ``expected_launches`` swaps ``cam_reduce`` for ``cam_relin_wcw_rhs``
#   on B1's PCG step where W's storage takes the walk, and nothing else; a
#   solve on B1 at budget 0 makes those launches and the decisions, bit
#   for bit, of one that reads W.


def solve_blocks(p, route="scatter_split", facto=None, stages=None):
    """``assemble_blocks`` as a solve runs it, W stored by ``facto``."""
    blocks = normal.assemble_blocks(p, route=route, stages=stages,
                                    w_dtype=lm_jit.w_assemble_dtype(facto))
    return lm_jit.maybe_cast_facto(blocks, facto)


def point_space(blocks, lam=1e-2):
    Hpp_inv_f, t = blocks.stages.point_inv_rhs(blocks.Hpp_f, blocks.g_p_f,
                                               lam, blocks.w_scale)
    return Hpp_inv_f, t


WCW_CASES = [(torch.float32, None), (torch.float32, torch.bfloat16),
             (torch.float32, torch.float16), (torch.float64, None),
             (torch.float64, torch.bfloat16)]


@pytest.mark.parametrize("dtype,facto", WCW_CASES,
                         ids=[f"{str(d)[6:]}-{str(f)[6:]}" for d, f in
                              WCW_CASES])
def test_wcw_rhs_twin_is_k2_over_the_plain_k7_w(dtype, facto):
    p = edge_problem(dtype)
    blocks = solve_blocks(p, facto=facto)
    assert blocks.W_t.dtype == (facto or dtype)
    assert (blocks.w_scale is not None) == (facto == torch.float16)
    hpp, t = point_space(blocks)
    want = fs._cam_reduce_wcw_rhs_plain(blocks.W_t, p, hpp, t)
    args = (p, blocks.cams, blocks.points, hpp, t, blocks.W_t.dtype,
            blocks.w_scale)
    got = fs._cam_relin_wcw_rhs_plain(*args)
    assert got.shape == (p.ncams, 90) and torch.equal(got, want)
    assert torch.equal(normal.KERNELS.cam_relin_wcw_rhs(*args), want)
    assert bool((got[0] == 0).all())


def test_wcw_rhs_bf16_stage_widens_as_k2s():
    p = edge_problem(torch.float64).astype(torch.bfloat16)
    st = normal.stages_for(normal.KERNELS, torch.bfloat16)
    blocks = normal.assemble_blocks(p, route="scatter_split", stages=st)
    assert blocks.W_t.dtype == torch.bfloat16
    hpp, t = point_space(blocks)
    want = st.cam_reduce_wcw_rhs(blocks.W_t, p, hpp, t)
    got = st.cam_relin_wcw_rhs(p, blocks.cams, blocks.points, hpp, t,
                               torch.bfloat16, None)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def wcw_spy_table(calls, table=None):
    """``table`` (``normal.KERNELS``) with both W C W' | W t stages noting
    their calls."""
    table = normal.KERNELS if table is None else table

    def spy(name):
        fn = getattr(table, name)

        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call
    return table._replace(**{k: spy(k) for k in (
        "cam_reduce_wcw_rhs", "cam_relin_wcw_rhs")})


DISPATCH_CASES = [("scatter_split", 0, torch.float32, None),
                  ("scatter_split", AMPLE, torch.float32, None),
                  ("scatter_split", 0, torch.float32, torch.bfloat16),
                  ("scatter_split", 0, torch.float32, torch.float16),
                  ("scatter_split", 0, torch.bfloat16, None),
                  ("scatter_split", 0, torch.bfloat16, torch.float16),
                  ("scatter_split", 0, torch.float64, None),
                  ("fused", 0, torch.float32, None),
                  ("fused", AMPLE, torch.float32, None)]


@pytest.mark.parametrize(
    "route,budget,dtype,facto", DISPATCH_CASES,
    ids=[f"{r}-{'ample' if b else 0}-{str(d)[6:]}-{str(f)[6:]}"
         for r, b, d, f in DISPATCH_CASES])
def test_reduce_takes_the_walk_past_shared_memory(monkeypatch, route, budget,
                                                  dtype, facto):
    """The walk on B1 at any shared-memory budget, where the stored W is
    what it rounds: a float16 W in a float32 solve (K7's float32 W scaled
    by a power of two, rounded once), not in a 2-byte one (rounded twice),
    and no float64 W (the plain route, no kernel storage)."""
    p = edge_problem(torch.float64).astype(dtype)
    st = normal.stages_for(normal.KERNELS, dtype)
    ref_blocks = solve_blocks(p, route, facto, st)
    ref = schur.reduce_and_diag(p, ref_blocks, 1e-2)
    monkeypatch.setattr(plans, "SMEM_BUDGET", budget)
    calls = []
    st = normal.stages_for(wcw_spy_table(calls), dtype)
    blocks = solve_blocks(p, route, facto, st)
    got = schur.reduce_and_diag(p, blocks, 1e-2)
    walk = (route == "scatter_split" and dtype != torch.float64
            and not (facto == torch.float16 and dtype != torch.float32))
    assert calls == ["cam_relin_wcw_rhs" if walk else "cam_reduce_wcw_rhs"]
    assert schur._relin_wcw_rhs(p, blocks) == walk
    for a, b in zip((*got[0], got[1]), (*ref[0], ref[1])):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    # Blocks without their state (made otherwise) read W.
    calls.clear()
    schur.reduce_and_diag(p, blocks._replace(cams=None, points=None), 1e-2)
    assert calls == ["cam_reduce_wcw_rhs"]


def test_partitioned_problem_keeps_w(monkeypatch):
    """A problem in camera groups (``pnt_perm``) has no camera-order rows
    (``plans.cam_obs`` refuses it): the W C W' | W t sum reads W."""
    from bundleadjustment_jl_tpu_torch.parallel import partition_problem
    monkeypatch.setattr(plans, "SMEM_BUDGET", 0)
    p = edge_problem(torch.float32)
    pp = partition_problem(p, 2)[0]
    assert pp.pnt_perm is not None
    with pytest.raises(ValueError, match="pnt_perm"):
        plans.cam_obs(pp)
    calls = []
    table = wcw_spy_table(calls, normal.solve_stages(torch.float32, pp))
    blocks = solve_blocks(pp, stages=table)
    assert not schur._relin_wcw_rhs(pp, blocks)
    schur.reduce_and_diag(pp, blocks, 1e-2)
    assert calls == ["cam_reduce_wcw_rhs"]
    assert schur._relin_wcw_rhs(p, solve_blocks(p))


@pytest.mark.parametrize("solver", ["pcg", "power", "dense", "cgls"])
@pytest.mark.parametrize("route", normal.ROUTES)
def test_expected_launches_swap_k2_wcw_rhs(route, solver):
    """The walk for W in float32 and bfloat16 and a float16 W of a float32
    solve; K2 over W for a float16 W of a 2-byte solve and a float64 W."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    off = expected_launches(route, 7, 5, 30, solver, None, torch.float64)
    assert expected_launches(route, 7, 5, 30, solver, f16, bf16) == off
    assert "cam_relin_wcw_rhs" not in off
    for facto, work in ((None, f32), (bf16, f32), (f16, f32), (None, bf16)):
        on = expected_launches(route, 7, 5, 30, solver, facto, work)
        if route == "scatter_split" and solver == "pcg":
            assert on.pop("cam_relin_wcw_rhs") == 7
            assert "cam_reduce" not in on
            on["cam_reduce"] = 7
        assert on == off


def test_solve_past_shared_memory_launches_the_wcw_walk(monkeypatch,
                                                        prob32):
    """A B1 solve at budget 0: ``cam_relin_wcw_rhs`` once an iteration in
    place of ``cam_reduce`` (the plain twins counted), and the decisions
    and state, bit for bit, of the solve that reads W
    (``fused_schur.relin_wcw_rhs`` off)."""
    for k, v in normal.FORCE_ROUTE["scatter_split"].items():
        monkeypatch.setattr(normal, k, v)
    opts = dict(max_iters=8, pcg_max_iters=200, lam0_mode="diag",
                **{k: 0.0 for k in ("atol", "rtol", "satol", "srtol",
                                    "oatol", "ortol")})
    with monkeypatch.context() as m:
        m.setattr(fs, "relin_wcw_rhs", lambda *args: False)
        ref = levenberg_marquardt_jit(
            dataclasses.replace(prob32, plans={}), **opts)
    counts = dict.fromkeys(_cuda.LAUNCHES, 0)
    monkeypatch.setattr(normal, "KERNELS", counting_stages(counts))
    monkeypatch.setattr(plans, "SMEM_BUDGET", 0)
    res = levenberg_marquardt_jit(dataclasses.replace(prob32, plans={}),
                                  **opts)
    it = int(res.iterations)
    assert it >= 4 and res.naccepts > 0
    expect = dict.fromkeys(counts, 0)
    expect.update(lm_jit.expected_launches(
        "scatter_split", it, res.naccepts, int(res.hist_cg[:it].sum())))
    assert counts["cam_relin_wcw_rhs"] == it and counts["cam_reduce"] == 0
    assert counts == expect
    assert (res.status, res.iterations, res.naccepts) == (
        ref.status, ref.iterations, ref.naccepts)
    assert res.objective == ref.objective
    assert torch.equal(res.cams, ref.cams)
    assert torch.equal(res.points, ref.points)
