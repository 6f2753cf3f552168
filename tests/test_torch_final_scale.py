"""The port's Final-scale routes against the JAX package's, on the CPU.

Route B1 (``"scatter_split"``: camera scatter above
``GATHER_TABLE_MAX_CAMS`` cameras) and route B2 (``"sorted_relin"``: camera
scatter off, more rows than ``GATHER_DIRECT_MAX_BYTES`` allows) appear only
at Final-scale sizes with the default gates. Both packages are put on them
at a tiny size the way the JAX package's own tests do it, by lowering a
gate: B1 with camera scatter on and ``GATHER_TABLE_MAX_CAMS = 4``, B2 with
camera scatter off, ``GATHER_DIRECT_MAX_BYTES = 0`` (and, on the JAX side,
``GATHER_CHUNK = 512``).

On the CPU each wrapper runs its plain PyTorch version, which is what the
CUDA kernels (K2's four products, K8) are checked against on the card.

- f32: the JAX route with its Pallas kernels in interpret mode (flags
  restored and jit caches cleared afterwards, as ``tests/test_pallas.py``
  does; the gates are read at trace time and are not in the cache key),
  each module fed the same inputs; rtol 1e-4, atol 1e-3 or 1e-5 of the
  largest entry (f32 sums taken in another order). The whole solve: same
  status and iterations, objective to rel 1e-5.
- f64: the whole solve against the JAX XLA route (Pallas off): same
  status, iterations, accepts and CG steps, objective to rel 1e-9.
"""

import contextlib
import functools
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.ops import (
    pallas_assemble, pallas_linearize, pallas_schur)
from bundleadjustment_jl_tpu.ops import schur as jax_schur
from bundleadjustment_jl_tpu.ops.normal import assemble_blocks as jax_assemble
from bundleadjustment_jl_tpu.ops.pallas_schur import (
    cam_scatter_reduce, pad_rows, tile_bounds)
from bundleadjustment_jl_tpu.solver import lm_jit as jax_lm_jit
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
from bundleadjustment_jl_tpu_torch.ops import normal, schur
from bundleadjustment_jl_tpu_torch.ops.linearize import (
    linearize_w_kminor, linearize_w_only)
from bundleadjustment_jl_tpu_torch.ops.normal import (
    GNBlocks, assemble_blocks, kernel_route)
from bundleadjustment_jl_tpu_torch.solver.lm_jit import levenberg_marquardt_jit

ROOT = Path(__file__).resolve().parents[1]
LAM = 0.37
B_ROUTES = ["scatter_split", "sorted_relin"]

# Gate settings: attributes set alike on the JAX `pallas_schur` and the
# port's `ops/normal.py` (the port's gates carry the JAX names and values), keyed
# by the route they select (the port's FORCE_ROUTE) unless named below.
GATES = dict(
    normal.FORCE_ROUTE,
    scatter_cap_sorted=dict(CAM_SCATTER=True, CAM_SCATTER_MAX_CAMS=4),
    scatter_cap_relin=dict(CAM_SCATTER=True, CAM_SCATTER_MAX_CAMS=4,
                           GATHER_DIRECT_MAX_BYTES=0))
SETTING_ROUTE = dict({r: r for r in GATES}, scatter_cap_sorted="sorted",
                     scatter_cap_relin="sorted_relin")
# The chunk of the JAX package's huge-n gathers (a TPU layout knob, as in
# tests/test_pallas.py); the port has none.
JAX_ONLY = {"sorted_relin": dict(GATHER_CHUNK=512)}


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


def _clear_jax_caches():
    jax_lm_jit._lm_init.clear_cache()
    jax_lm_jit._lm_run.clear_cache()


@contextlib.contextmanager
def jax_route(setting):
    """The JAX package under gate ``setting`` (a key of GATES), its kernels
    interpreted on the CPU; every flag restored and the solver's jit
    caches cleared on both sides."""
    flags = dict(GATES[setting], **JAX_ONLY.get(setting, {}))
    names = ["PALLAS_MODE", "INTERPRET", *flags]
    old = {k: getattr(pallas_schur, k) for k in names}
    _clear_jax_caches()
    try:
        pallas_schur.set_mode(True)
        pallas_schur.INTERPRET = True
        for k, v in flags.items():
            setattr(pallas_schur, k, v)
        yield
    finally:
        for k, v in old.items():
            setattr(pallas_schur, k, v)
        _clear_jax_caches()


@contextlib.contextmanager
def port_route(setting):
    flags = GATES[setting]
    old = {k: getattr(normal, k) for k in flags}
    try:
        for k, v in flags.items():
            setattr(normal, k, v)
        yield
    finally:
        for k, v in old.items():
            setattr(normal, k, v)


@contextlib.contextmanager
def jax_route_taken():
    """Yields a list that, on exit, holds the route the JAX package ran in
    the block, read from the kernels it called (at trace time, under jit):
    K1 only on A, K8 only on B2, K6 over a camera-sorted JR only on C, and
    on B1 none of those three but K2."""
    sites = [(pallas_assemble, "assemble_scatter", "fused"),
             (pallas_linearize, "linearize_w_only", "sorted_relin"),
             (pallas_schur, "jtj_cam_reduce", "sorted"),
             (pallas_schur, "cam_scatter_reduce", "scatter_split")]
    called, taken = set(), []

    def record(fn, route):
        def call(*args, **kwargs):
            called.add(route)
            return fn(*args, **kwargs)
        return call

    saved = [getattr(mod, attr) for mod, attr, _ in sites]
    try:
        for mod, attr, route in sites:
            setattr(mod, attr, record(getattr(mod, attr), route))
        yield taken
    finally:
        for (mod, attr, _), fn in zip(sites, saved):
            setattr(mod, attr, fn)
    taken.append(next((r for _, _, r in sites if r in called), None))


@pytest.fixture(scope="module")
def prob32():
    jp, _ = jax_synthetic(ncams=9, npnts=300, obs_per_pnt=4, seed=11,
                          dtype=jnp.float32, noise_px=1.0, perturb=2e-2,
                          pad_obs_to=1280)
    return jp, to_port(jp)


@pytest.fixture(scope="module")
def operands(prob32):
    """A random W (zero on the padding rows), per-point operands (SPD
    symmetric C ~ Hpp_inv, a 3-vector op) and the JAX linearization."""
    jp, _ = prob32
    rng = np.random.default_rng(0)
    W = rng.standard_normal((27, jp.nobs_pad)).astype(np.float32)
    W[:, jp.nobs:] = 0.0
    A = rng.standard_normal((jp.npnts, 3, 3)).astype(np.float32)
    C = (A @ np.swapaxes(A, 1, 2) + 3.0 * np.eye(3, dtype=np.float32))
    cxw = pallas_linearize.pack_operands(jp.cams, jp.points, jp.cam_idx,
                                         jp.pnt_idx, jp.pt2d, jp.w)
    JR_t, W_lin = pallas_linearize.linearize_w_kminor(cxw, interpret=True)
    return dict(W=W, C=C.reshape(-1),
                op=rng.standard_normal((jp.npnts, 3)).astype(np.float32),
                JR_t=np.asarray(JR_t), W_lin=np.asarray(W_lin))


# ---------------------------------------------------------------- K2
@pytest.mark.parametrize("product", ["w_op", "wcw", "cam90"])
def test_cam_reduce_products_f32_match_pallas(prob32, operands, product):
    """K2's three new products (plain twins) against
    `cam_scatter_reduce` with `_prod_w_op`, `_prod_wcw`, `_prod_cam90`."""
    jp, tp = prob32
    W_t = jnp.asarray(pad_rows(jnp.asarray(operands["W"]), 32))
    bounds = tile_bounds(jp.pnt_starts, jp.npnts)
    kw = dict(idx_row=jp.pnt_idx, interpret=True)
    if product == "w_op":
        op = operands["op"]
        ref = cam_scatter_reduce(
            W_t, jp.cam_idx, bounds, jp.ncams, d_out=9,
            prod=pallas_schur._prod_w_op, op_t=pad_rows(jnp.asarray(op).T, 8),
            **kw)
        got = fs.cam_reduce_w_op(tt(operands["W"]), tp, tt(op))
    elif product == "wcw":
        C = jnp.asarray(operands["C"])
        h6 = C.reshape(-1, 9)[:, jnp.array([0, 1, 2, 4, 5, 8])]
        ref = cam_scatter_reduce(
            W_t, jp.cam_idx, bounds, jp.ncams, d_out=81,
            prod=pallas_schur._prod_wcw, op_t=pad_rows(h6.T, 8), **kw)
        got = fs.cam_reduce_wcw(tt(operands["W"]), tp, tt(operands["C"]))
    else:
        JR = operands["JR_t"]
        ref = cam_scatter_reduce(
            jnp.asarray(JR), jp.cam_idx, bounds, jp.ncams, d_out=90,
            prod=pallas_schur._prod_cam90, interpret=True)
        got = fs.cam_reduce_cam90(tt(JR[:26]), tp)
    close32(got, ref)


@pytest.mark.parametrize("product", ["w_op", "wcw", "cam90", "wcw_rhs"])
def test_cam_reduce_camera_without_rows_is_zero(prob32, product):
    """A camera no row sees gets exact zeros from every K2 product."""
    jp, _ = prob32
    m = jp.nobs
    p = BAProblem.from_arrays(
        np.concatenate([np.asarray(jp.cams[:1]), np.asarray(jp.cams)]),
        np.asarray(jp.points), np.asarray(jp.cam_idx[:m]) + 1,
        np.asarray(jp.pnt_idx[:m]), np.asarray(jp.pt2d[:m]),
        dtype=torch.float32, pad_obs_to=128, device="cpu")
    JR_t, W_t = linearize_w_kminor(p, p.cams, p.points)
    C = torch.eye(3).repeat(p.npnts, 1, 1).reshape(-1)
    t = torch.ones((p.npnts, 3))
    out = {"w_op": lambda: fs.cam_reduce_w_op(W_t, p, t),
           "wcw": lambda: fs.cam_reduce_wcw(W_t, p, C),
           "cam90": lambda: fs.cam_reduce_cam90(JR_t, p),
           "wcw_rhs": lambda: fs.cam_reduce_wcw_rhs(W_t, p, C, t)}[product]()
    assert int(p.cam_starts[1] - p.cam_starts[0]) == 0
    assert not out[0].any() and out[1:].abs().max() > 0


# ---------------------------------------------------------------- K8
def test_linearize_w_only_f32_matches_pallas(prob32, operands):
    """K8's plain twin against `linearize_w_only` on camera-sorted packed
    operands, and against K7's W permuted into the camera order."""
    jp, tp = prob32
    perm = jp.cam_perm
    cxw_cs = pallas_linearize.pack_operands(
        jp.cams, jp.points, jp.cam_idx[perm], jp.pnt_idx[perm],
        jp.pt2d[perm], jp.w[perm])
    ref = pallas_linearize.linearize_w_only(cxw_cs, interpret=True)
    got = linearize_w_only(tp, tp.cams, tp.points)
    close32(got, np.asarray(ref)[:27])
    close32(got, linearize_w_kminor(tp, tp.cams, tp.points)[1][
        :, tp.cam_perm.long()])
    close32(got, operands["W_lin"][:27][:, np.asarray(perm)])


# ---------------------------------------------------------------- assembly
@pytest.mark.parametrize("route", B_ROUTES)
def test_assemble_f32_matches_pallas(prob32, route):
    jp, tp = prob32
    with jax_route(route):
        ref = jax_assemble(jp, with_jr=False, kminor=True)
    got = assemble_blocks(tp, route=route)
    assert got.route == route
    for name in ("g_c_f", "g_p_f", "Hcc_f", "Hpp_f"):
        close32(getattr(got, name), getattr(ref, name))
    close32(got.W_t, np.asarray(ref.W_t)[:27])
    assert float(got.obj) == pytest.approx(float(ref.obj), rel=1e-5)
    if route == "scatter_split":
        assert ref.W_cam_t is None and got.W_cam_t is None
    else:
        close32(got.W_cam_t, np.asarray(ref.W_cam_t)[:27])


# ---------------------------------------------------------------- Schur
@pytest.fixture(scope="module")
def b1_blocks(prob32):
    jp, _ = prob32
    with jax_route("scatter_split"):
        jb = jax_assemble(jp, with_jr=False, kminor=True)
    blocks = GNBlocks(g_c_f=tt(jb.g_c_f), g_p_f=tt(jb.g_p_f),
                      Hcc_f=tt(jb.Hcc_f), Hpp_f=tt(jb.Hpp_f), obj=tt(jb.obj),
                      W_t=tt(jb.W_t[:27]), route="scatter_split")
    return jb, blocks


@pytest.mark.parametrize("piece", [
    "reduce_system", "schur_diag_blocks", "schur_matvec", "back_substitute",
    "quad_form", "reduce_and_diag", "back_substitute_quad"])
def test_schur_pieces_b1_f32_match_pallas(prob32, b1_blocks, piece):
    """Each route-B1 Schur piece, fed the JAX route's own blocks."""
    jp, tp = prob32
    jb, blocks = b1_blocks
    rng = np.random.default_rng(4)
    v = rng.standard_normal((jp.ncams, 9)).astype(np.float32)
    dc = 1e-2 * v
    with jax_route("scatter_split"):
        sys_ref = jax_schur.reduce_system(jp, jb, LAM)
        sys = schur.reduce_system(tp, blocks, LAM)
        assert sys.route == "scatter_split" and sys.W_cam_t is None
        if piece == "reduce_system":
            close32(sys.b_f, sys_ref.b_f)
            close32(sys.Hpp_inv_f, sys_ref.Hpp_inv_f)
        elif piece == "schur_diag_blocks":
            close32(schur.schur_diag_blocks(sys),
                    jax_schur.schur_diag_blocks(sys_ref))
        elif piece == "schur_matvec":
            close32(schur.schur_matvec(sys, tt(v)),
                    jax_schur.schur_matvec(sys_ref, jnp.asarray(v)))
        elif piece == "reduce_and_diag":
            sys2, Sd = schur.reduce_and_diag(tp, blocks, LAM)
            sys2_ref, Sd_ref = jax_schur.reduce_and_diag(jp, jb, LAM)
            close32(sys2.b_f, sys2_ref.b_f)
            close32(Sd, Sd_ref)
        elif piece == "back_substitute_quad":
            dp, Jd2 = schur.back_substitute_quad(tp, blocks, sys, tt(dc))
            dp_ref, Jd2_ref = jax_schur.back_substitute_quad(
                jp, jb, sys_ref, jnp.asarray(dc))
            close32(dp, dp_ref)
            assert float(Jd2) == pytest.approx(float(Jd2_ref), rel=1e-4)
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
F64_CASES = {"P9": (P9, dict(max_iters=60, pcg_max_iters=200)),
             "P10": (P10, dict(max_iters=40, lam0_mode="diag"))}


@pytest.mark.parametrize("route", B_ROUTES)
def test_solver_f32_matches_jax_pallas(route):
    jp, _ = jax_synthetic(ncams=8, npnts=256, obs_per_pnt=4, seed=5,
                          dtype=jnp.float32, noise_px=1.0, perturb=2e-2,
                          pad_obs_to=1024)
    opts = dict(max_iters=15, pcg_max_iters=60, lam0_mode="diag")
    with jax_route(route), jax_route_taken() as taken:
        ref = jax_lm_jit.levenberg_marquardt_jit(jp, **opts)
    assert taken == [route]
    with port_route(route):
        tp = to_port(jp)
        assert kernel_route(tp) == route
        got = levenberg_marquardt_jit(tp, **opts)
    assert got.status == int(ref.status)
    assert got.iterations == int(ref.iterations)
    robj = float(ref.objective)
    assert abs(got.objective - robj) <= 1e-5 * max(1.0, robj)


@functools.cache
def _jax_xla_solve(case):
    problem_kw, opts = F64_CASES[case]
    jp, _ = jax_synthetic(**problem_kw)
    return jp, jax_lm_jit.levenberg_marquardt_jit(jp, **opts)


@pytest.mark.parametrize("route", B_ROUTES)
@pytest.mark.parametrize("case", list(F64_CASES))
def test_solver_f64_matches_jax_xla(case, route):
    jp, ref = _jax_xla_solve(case)
    with port_route(route):
        tp = to_port(jp)
        assert kernel_route(tp) == route
        got = levenberg_marquardt_jit(tp, **F64_CASES[case][1])
    n = int(ref.iterations)
    assert got.status == int(ref.status)
    assert got.iterations == n and got.naccepts == int(ref.naccepts)
    np.testing.assert_array_equal(got.hist_cg, np.asarray(ref.hist_cg))
    assert got.objective == pytest.approx(float(ref.objective), rel=1e-9)


# ---------------------------------------------------------------- routes
@pytest.mark.parametrize("setting", list(GATES))
def test_kernel_route_matches_jax(prob32, setting):
    """`kernel_route` picks the route the JAX package's assembly runs at
    each gate setting."""
    jp, tp = prob32
    with jax_route(setting), jax_route_taken() as taken:
        # Traced, not run: the kernels the assembly calls are its route.
        ref = jax.eval_shape(
            lambda: jax_assemble(jp, with_jr=False, kminor=True))
    want = taken[0]
    assert (ref.W_cam_t is None) == (want in ("fused", "scatter_split"))
    with port_route(setting):
        assert kernel_route(tp) == want
    assert want == SETTING_ROUTE[setting]


@pytest.mark.parametrize("ncams, nobs_pad, cam_scatter, route", [
    (49, 31_232, True, "fused"),             # LadyBug-49
    (49, 31_232, False, "sorted"),
    (356, 1_360_384, True, "fused"),         # Dubrovnik-356
    (356, 1_360_384, False, "sorted"),
    (4585, 9_272_320, True, "scatter_split"),   # Final-4585
    (4585, 9_272_320, False, "sorted_relin"),
    (13682, 31_145_728, True, "scatter_split"),  # Final-13682
    (20000, 1_360_384, True, "sorted"),      # above CAM_SCATTER_MAX_CAMS
])
def test_default_gates_pick_the_jax_route(monkeypatch, ncams, nobs_pad,
                                          cam_scatter, route):
    """With the JAX values of the gates, the problems the port measures
    stay on routes A and C, and Final-scale sizes take route B."""
    monkeypatch.setattr(normal, "CAM_SCATTER", cam_scatter)
    shape = types.SimpleNamespace(ncams=ncams, nobs_pad=nobs_pad)
    assert kernel_route(shape) == route


# Each kernel a solve calls (a field of `normal.Stages`) and the routes
# that reach it.
# `cam_reduce_wcw` (K2 W C W') serves `schur_diag_blocks` without a
# camera-sorted W, which no solve calls: route B1's diagonal comes from
# `cam_reduce_wcw_rhs`, as in the JAX driver.
ALL = set(normal.ROUTES)
SPLIT = {"sorted", "scatter_split", "sorted_relin"}
SITES = {
    "assemble_scatter": {"fused"},
    "linearize_w_kminor": SPLIT,
    "jtj_pnt_reduce": SPLIT,
    "jtj_cam_reduce": {"sorted"},
    "cam_reduce_cam90": {"scatter_split", "sorted_relin"},
    "linearize_w_only": {"sorted_relin"},
    "cam_reduce_wcw_rhs": {"fused", "scatter_split"},
    "matvec_cam_scatter": {"fused"},
    "cam_reduce_w_op": {"scatter_split"},
    "cam_reduce_wcw": set(),
    "wcw_cam_reduce": {"sorted", "sorted_relin"},
    "wtv_point_reduce": SPLIT,
    "wt_cam_reduce": {"sorted", "sorted_relin"},
    "objective_scatter": ALL,
}


@pytest.mark.parametrize("route", normal.ROUTES)
def test_route_keeps_its_call_sites_for_a_whole_solve(monkeypatch, route):
    """The route `kernel_route` picks serves the whole solve: every call
    site of that route is reached, no other route's is."""
    calls = dict.fromkeys(SITES, 0)

    def wrap(site, fn):
        def call(*args, **kwargs):
            if route not in SITES[site]:
                raise AssertionError(f"{site} is not on route {route}")
            calls[site] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(normal, "KERNELS", normal.KERNELS._replace(**{
        site: wrap(site, getattr(normal.KERNELS, site)) for site in SITES}))
    for k, v in GATES[route].items():
        monkeypatch.setattr(normal, k, v)
    # float32 (a float64 solve takes the plain route and reaches no
    # site), no stopping tolerance, so all three iterations run.
    jp, _ = jax_synthetic(**P10, dtype=jnp.float32)
    res = levenberg_marquardt_jit(to_port(jp), max_iters=3, **NO_STOPS)
    assert res.iterations == 3 and res.naccepts > 0
    assert {s for s, n in calls.items() if n} == {
        s for s, routes in SITES.items() if route in routes}


# ---------------------------------------------------------------- messages
def _queue_a_titles() -> set:
    text = (ROOT / "ROADMAP.md").read_text()
    queue = text[text.index("### A."):text.index("### B.")]
    return set(re.findall(r"^\d+\. \*\*(.+?)\*\*", queue, re.M))


@pytest.mark.parametrize("option", ["driver_spmd", "mesh", "multihost"])
def test_unsupported_options_name_a_roadmap_item(option):
    """Each option the port lacks (the CLI's multi-device options) names, by
    its title, an item that exists in ROADMAP.md's queue A."""
    from bundleadjustment_jl_tpu_torch.cli import main
    args = {"driver_spmd": ["--driver", "spmd"], "mesh": ["--mesh", "4"],
            "multihost": ["--multihost"]}[option]
    with pytest.raises(NotImplementedError) as err:
        main(["synthetic:ncams=5,npnts=40", "--device", "cpu", *args])
    title = re.search(r"\(ROADMAP\.md, queue A: (.+)\)$", str(err.value))
    assert title is not None, str(err.value)
    assert title.group(1) in _queue_a_titles()
