"""The port's narrow W storage (``facto_dtype``) and its measurement path
against the JAX package, on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch version (W widened
first), which is what the CUDA kernels' bfloat16 / float16 instantiations
are checked against on the card.

- ``maybe_cast_facto`` against the JAX solver's ``_maybe_cast_facto`` on
  the same float32 W: the same power-of-two scale, the stored W
  bit-identical.
- The assembly with W written in bfloat16 (and float16 through the cast)
  on all four kernel routes against the JAX route in Pallas interpret
  mode: blocks to the tolerances of ``tests/test_torch_final_scale.py``;
  W to one ulp of the storage dtype, since an f32 W that differs in its
  last bit between the two packages' chains may round the other way.
- The hatted Schur pieces, fed the JAX route's own narrow blocks, to the
  f32 tolerances; whole solves with ``facto_dtype`` against
  ``levenberg_marquardt_jit`` of the JAX package: same status and
  iterations, objective to rel 1e-3.
- The stream probe's plain version against numpy, ``kernel_bytes``
  against values counted by hand, ``kernel_profile.kernel_sums`` over a
  hand-written trace, and the measurement entry points refusing to run
  without a card.

Routes are forced on both sides as ``tests/test_torch_final_scale.py``
does: A and C by camera scatter on and off, B1 and B2 by
``normal.FORCE_ROUTE`` (and ``GATHER_CHUNK = 512`` on the JAX side).
"""

import contextlib
import functools
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.ops import pallas_schur
from bundleadjustment_jl_tpu.ops import schur as jax_schur
from bundleadjustment_jl_tpu.ops.normal import GNBlocks as JaxBlocks
from bundleadjustment_jl_tpu.ops.normal import assemble_blocks as jax_assemble
from bundleadjustment_jl_tpu.solver import lm_jit as jax_lm_jit
from bundleadjustment_jl_tpu_torch import bench, kernel_profile, mv_sweep
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import normal, schur
from bundleadjustment_jl_tpu_torch.ops.normal import (
    ROUTES, GNBlocks, assemble_blocks)
from bundleadjustment_jl_tpu_torch.ops.stream_probe import (
    _stream_probe_plain, stream_probe)
from bundleadjustment_jl_tpu_torch.solver import lm_jit
from bundleadjustment_jl_tpu_torch.utils.timing import timed

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

LAM = 0.37
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}
# Gate settings, set alike on the JAX `pallas_schur` and the port's
# `ops/normal.py`, that put a small problem on each route.
SETTINGS = {"fused": dict(CAM_SCATTER=True), "sorted": dict(CAM_SCATTER=False),
            "scatter_split": normal.FORCE_ROUTE["scatter_split"],
            "sorted_relin": normal.FORCE_ROUTE["sorted_relin"]}
JAX_ONLY = {"sorted_relin": dict(GATHER_CHUNK=512)}
PROBLEM = dict(ncams=8, npnts=256, obs_per_pnt=4, seed=5, dtype=jnp.float32,
               noise_px=1.0, perturb=2e-2, pad_obs_to=1024)
# bench.py's tolerances with a looser objective-change stop, so that the
# narrow-W solves stop (small_obj_change) while the two packages' CG
# trajectories still agree step for step; at bench.py's ortol = 1e-4 this
# small problem runs on into the noise floor of a 2-byte W, where any
# last-bit difference reorders the late decisions (the JAX package's own
# routes then disagree among themselves).
SOLVE = dict(max_iters=30, pcg_max_iters=60, lam0_mode="diag", satol=0.0,
             srtol=0.0, atol=0.0, rtol=1e-5, oatol=0.0, ortol=3e-3)


def to_port(jp):
    return BAProblem.from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS},
        device="cpu")


def tt(x):
    """A JAX array as a torch tensor, bfloat16 included (through its bits)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def close32(got, ref):
    """rtol 1e-4 with atol 1e-3, or 1e-5 of the largest entry where the
    entries run past 1e2 (f32 sums taken in another order)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(
        got, ref, rtol=1e-4, atol=max(1e-3, 1e-5 * np.abs(ref).max()))


def close_ulp(got: torch.Tensor, ref, dtype: torch.dtype):
    """Within one ulp of the storage dtype (eps relative), or 1e-5 of the
    largest entry for entries that cancel."""
    got = got.float().numpy()
    ref = np.asarray(tt(ref).float())
    np.testing.assert_allclose(got, ref, rtol=torch.finfo(dtype).eps,
                               atol=1e-5 * np.abs(ref).max())


@contextlib.contextmanager
def on_route(route):
    """Both packages on ``route``: the JAX package's kernels interpreted on
    the CPU; every flag restored and the JAX solver's jit caches cleared."""
    flags = SETTINGS[route]
    jax_flags = dict(flags, **JAX_ONLY.get(route, {}))
    old_jax = {k: getattr(pallas_schur, k)
               for k in ("PALLAS_MODE", "INTERPRET", *jax_flags)}
    old_port = {k: getattr(normal, k) for k in flags}
    jax_lm_jit._lm_init.clear_cache()
    jax_lm_jit._lm_run.clear_cache()
    try:
        pallas_schur.set_mode(True)
        pallas_schur.INTERPRET = True
        for k, v in jax_flags.items():
            setattr(pallas_schur, k, v)
        for k, v in flags.items():
            setattr(normal, k, v)
        yield
    finally:
        for k, v in old_jax.items():
            setattr(pallas_schur, k, v)
        for k, v in old_port.items():
            setattr(normal, k, v)
        jax_lm_jit._lm_init.clear_cache()
        jax_lm_jit._lm_run.clear_cache()


@pytest.fixture(scope="module")
def prob32():
    jp, _ = jax_synthetic(**PROBLEM)
    return jp, to_port(jp)


@functools.cache
def jax_narrow_blocks(route, dt):
    """The JAX solver's assembly and cast on ``route`` (called inside
    :func:`on_route`), once per route and dtype."""
    jdt = DTYPES[dt][1]
    jp, _ = jax_synthetic(**PROBLEM)
    return jax_lm_jit._maybe_cast_facto(
        jax_assemble(jp, with_jr=False, kminor=True,
                     w_dtype=jax_lm_jit._w_assemble_dtype(jdt)), jdt)


# ---------------------------------------------------------------- the cast
@pytest.mark.parametrize("dt", list(DTYPES))
def test_maybe_cast_facto_matches_jax(dt):
    """The same f32 W, cast by both solvers: the same scale (float16: a
    power of two putting max|W| near 2^14; bfloat16: none) and bit-identical
    stored W, W_cam_t alike."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(7)
    n = 1024
    W = (3e5 * rng.standard_normal((27, n))).astype(np.float32)
    perm = rng.permutation(n)
    W32 = np.zeros((32, n), np.float32)
    W32[:27] = W
    z = jnp.zeros((9,), jnp.float32)
    jb = JaxBlocks(g_c_f=z, g_p_f=z, Hcc_f=z, Hpp_f=z, W_f=None, obj=z[0],
                   W_t=jnp.asarray(W32), W_cam_t=jnp.asarray(W32[:, perm]))
    ref = jax_lm_jit._maybe_cast_facto(jb, jdt)
    zt = torch.zeros(9)
    tb = GNBlocks(g_c_f=zt, g_p_f=zt, Hcc_f=zt, Hpp_f=zt, obj=zt[0],
                  W_t=torch.from_numpy(W),
                  W_cam_t=torch.from_numpy(W[:, perm]),
                  route="sorted")
    got = lm_jit.maybe_cast_facto(tb, tdt)
    assert got.W_t.dtype == got.W_cam_t.dtype == tdt
    np.testing.assert_array_equal(bits(got.W_t), bits(tt(ref.W_t[:27])))
    np.testing.assert_array_equal(bits(got.W_cam_t),
                                  bits(tt(ref.W_cam_t[:27])))
    if dt == "bf16":
        assert ref.w_scale is None and got.w_scale is None
    else:
        s = float(got.w_scale)
        assert s == float(ref.w_scale) and s == 2.0 ** round(np.log2(s))
        assert 2.0 ** 13 <= s * np.abs(W).max() < 2.0 ** 14 * 1.0001


def test_f16_storage_survives_w_overflow():
    """Focal and observations scaled by 16 (an exact transformation of the
    problem): max|W| ~ f^2 passes float16's 65504, so a raw cast would give
    inf. The power-of-two scale keeps the stored W finite and within f16
    accuracy, and the f16 solve converges with its own f32 solve (the
    problem and checks of ``tests/test_lm_chunked.py`` for the JAX
    solver)."""
    jp, _ = jax_synthetic(ncams=8, npnts=120, obs_per_pnt=4, noise_px=0.5,
                          perturb=1e-2, seed=3, dtype=jnp.float32)
    p = to_port(jp)
    p.cams[:, 8] *= 16.0
    p.pt2d *= 16.0
    blocks = assemble_blocks(p)
    assert float(blocks.W_t.abs().max()) > 65504.0      # a raw cast infs
    cast = lm_jit.maybe_cast_facto(blocks, torch.float16)
    assert bool(torch.isfinite(cast.W_t.float()).all())
    s = float(cast.w_scale)
    assert s < 1.0 and s == 2.0 ** round(np.log2(s))
    np.testing.assert_allclose(cast.W_t.float().numpy() / s,
                               blocks.W_t.numpy(), rtol=2e-3, atol=1e-3)
    kw = dict(max_iters=60, lam0_mode="diag", satol=0.0, srtol=0.0,
              atol=0.0, rtol=1e-5, oatol=0.0, ortol=1e-4)
    base = lm_jit.levenberg_marquardt_jit(p, **kw)
    mixed = lm_jit.levenberg_marquardt_jit(p, facto_dtype=torch.float16,
                                           **kw)
    assert mixed.status_name() != "exception"
    assert np.isfinite(mixed.objective)
    assert mixed.objective == pytest.approx(base.objective, rel=2e-2)


# ---------------------------------------------------------------- assembly
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("route", ROUTES)
def test_assemble_narrow_w_matches_pallas(prob32, route, dt):
    """Assembly plus cast on each route, as both solvers run it: bfloat16
    W written by the assembly kernels, float16 written in f32 and cast with
    its range scale."""
    tdt = DTYPES[dt][0]
    jp, tp = prob32
    with on_route(route):
        ref = jax_narrow_blocks(route, dt)
        written = assemble_blocks(tp, route=route,
                                  w_dtype=lm_jit.w_assemble_dtype(tdt))
        got = lm_jit.maybe_cast_facto(written, tdt)
    assert normal.kernel_route(tp) == "fused"       # gates restored
    assert written.W_t.dtype == (tdt if dt == "bf16" else torch.float32)
    for name in ("g_c_f", "g_p_f", "Hcc_f", "Hpp_f"):
        close32(getattr(got, name), getattr(ref, name))
    assert float(got.obj) == pytest.approx(float(ref.obj), rel=1e-5)
    assert got.W_t.dtype == tdt
    close_ulp(got.W_t, ref.W_t[:27], tdt)
    if ref.W_cam_t is None:
        assert got.W_cam_t is None
    else:
        assert got.W_cam_t.dtype == tdt
        close_ulp(got.W_cam_t, ref.W_cam_t[:27], tdt)
    if dt == "bf16":
        assert got.w_scale is None and ref.w_scale is None
    else:
        assert float(got.w_scale) == float(ref.w_scale)


# ---------------------------------------------------------------- Schur
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("route", ROUTES)
def test_schur_pieces_narrow_w_match_pallas(prob32, route, dt):
    """The Schur pieces of the solver's loop on each route, fed the JAX
    route's own narrow blocks: the hatted point space (float16) and the
    bfloat16 roundings of the per-row operands."""
    jp, tp = prob32
    rng = np.random.default_rng(4)
    v = rng.standard_normal((jp.ncams, 9)).astype(np.float32)
    dc = 1e-2 * v
    with on_route(route):
        jb = jax_narrow_blocks(route, dt)
        blocks = GNBlocks(
            g_c_f=tt(jb.g_c_f), g_p_f=tt(jb.g_p_f), Hcc_f=tt(jb.Hcc_f),
            Hpp_f=tt(jb.Hpp_f), obj=tt(jb.obj), W_t=tt(jb.W_t[:27]),
            W_cam_t=None if jb.W_cam_t is None else tt(jb.W_cam_t[:27]),
            route=route,
            w_scale=None if jb.w_scale is None else tt(jb.w_scale))
        sys_ref, Sd_ref = jax_schur.reduce_and_diag(jp, jb, LAM)
        sys, Sd = schur.reduce_and_diag(tp, blocks, LAM)
        close32(sys.b_f, sys_ref.b_f)
        close32(sys.Hpp_inv_f, sys_ref.Hpp_inv_f)
        close32(Sd, Sd_ref)
        close32(schur.schur_matvec(sys, torch.from_numpy(v)),
                jax_schur.schur_matvec(sys_ref, jnp.asarray(v)))
        dp, Jd2 = schur.back_substitute_quad(tp, blocks, sys,
                                             torch.from_numpy(dc))
        dp_ref, Jd2_ref = jax_schur.back_substitute_quad(
            jp, jb, sys_ref, jnp.asarray(dc))
    close32(dp, dp_ref)
    assert float(Jd2) == pytest.approx(float(Jd2_ref), rel=1e-4)


# ---------------------------------------------------------------- solves
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("route", ROUTES)
def test_solver_narrow_w_matches_jax_pallas(prob32, route, dt):
    tdt, jdt = DTYPES[dt]
    jp, tp = prob32
    with on_route(route):
        assert normal.kernel_route(tp) == route
        ref = jax_lm_jit.levenberg_marquardt_jit(jp, facto_dtype=jdt,
                                                 **SOLVE)
        got = lm_jit.levenberg_marquardt_jit(tp, facto_dtype=tdt, **SOLVE)
    assert got.status == int(ref.status)
    assert got.iterations == int(ref.iterations)
    robj = float(ref.objective)
    assert abs(got.objective - robj) <= 1e-3 * max(1.0, robj)


@pytest.mark.parametrize("dt", [None, "bf16", "f16"])
def test_expected_w_launches_by_storage(dt):
    """The W storage a solve's kernels see: the writers write bfloat16 W
    raw and float16 W in float32 (scaled and cast after); every reader
    reads the storage dtype."""
    from bundleadjustment_jl_tpu_torch.ops import _cuda
    facto = DTYPES[dt][0] if dt else None
    launches = lm_jit.expected_launches("sorted_relin", 9, 8, 40)
    counts = dict.fromkeys(_cuda.LAUNCHES, 0) | launches
    writes = counts["linearize"] + counts["linearize_w_only"]    # K7, K8
    reads = sum(counts[k] for k in _cuda.W_READERS)
    want = {torch.float32: 0, torch.bfloat16: 0, torch.float16: 0}
    want[torch.bfloat16 if dt == "bf16" else torch.float32] += writes
    want[facto or torch.float32] += reads
    assert lm_jit.expected_w_launches(counts, facto) == want
    # K6 wcw81 per iteration, K5 point and camera per CG step plus 2 and 3
    # per iteration; K7 and K8 at init and per accept
    assert reads == 9 + (40 + 2 * 9) + (40 + 3 * 9) and writes == 2 * 9


def test_facto_dtype_rejects_other_dtypes(prob32):
    with pytest.raises(TypeError, match="facto_dtype"):
        lm_jit.levenberg_marquardt_jit(prob32[1], facto_dtype=torch.float64)


# ---------------------------------------------------------------- K9
@pytest.mark.parametrize("nsmall", [0, 1, 2])
def test_stream_probe_plain_matches_numpy(nsmall):
    rng = np.random.default_rng(nsmall)
    n = 3000
    big = rng.random((32, n), dtype=np.float32)
    small = [rng.random((1, n), dtype=np.float32) for _ in range(nsmall)]
    want = big.astype(np.float64).sum(1) + sum(
        float(s.astype(np.float64).sum()) for s in small)
    args = [torch.from_numpy(big)] + [torch.from_numpy(s) for s in small]
    got = stream_probe(*args)
    assert got.shape == (32,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(got.numpy(),
                                  _stream_probe_plain(*args).numpy())


def test_stream_probe_takes_at_most_two_small_rows():
    with pytest.raises(ValueError, match="two"):
        stream_probe(torch.zeros((32, 8)), *[torch.zeros(8)] * 3)


# ---------------------------------------------------------------- bounds
DUB = types.SimpleNamespace(nobs_pad=1_360_384, ncams=356, npnts=226_730)


@pytest.mark.parametrize("name, w_itemsize, kw, want", [
    # W 27 n w; cam_idx, pnt_idx, cam_perm; pnt_starts; cam_starts;
    # v (ncams, 9); Hpp_inv (npnts, 9); out (ncams, 9) — all 4 B values
    ("matvec", 4, {}, 27 * 1_360_384 * 4 + 3 * 1_360_384 * 4
     + 226_731 * 4 + 357 * 4 + 356 * 9 * 4 + 226_730 * 9 * 4
     + 356 * 9 * 4),
    ("matvec", 2, {}, 27 * 1_360_384 * 2 + 3 * 1_360_384 * 4
     + 226_731 * 4 + 357 * 4 + 356 * 9 * 4 + 226_730 * 9 * 4
     + 356 * 9 * 4),
    # W_cam; t (npnts, 3); pnt_idx and cam_perm; cam_starts; out (ncams, 9)
    ("seg_block_camera", 2, {}, 27 * 1_360_384 * 2 + 226_730 * 3 * 4
     + 2 * 1_360_384 * 4 + 357 * 4 + 356 * 9 * 4),
    # JR's Jp and r planes (8); pnt_starts; out (npnts, 12)
    ("seg_prod_pnt12", 4, {}, 8 * 1_360_384 * 4 + 226_731 * 4
     + 226_730 * 12 * 4),
    # (32 + 2) rows of n floats in, 32 floats out
    ("stream_probe", 4, dict(nsmall=2), 34 * 1_360_384 * 4 + 32 * 4),
    # pt2d, w, cam_idx, pnt_idx once; per scale the cameras, the points and
    # the objective
    ("objective", 4, {}, 5 * 1_360_384 * 4
     + (356 * 9 + 226_730 * 3) * 4 + 4),
    ("objective", 4, dict(scales=5), 5 * 1_360_384 * 4
     + 5 * ((356 * 9 + 226_730 * 3) * 4 + 4)),
    # Hpp and g_p in, Hpp_inv and Hpp_inv g_p out (npnts blocks of 9 and 3)
    ("point_inv", 4, {}, 2 * 226_730 * (9 + 3) * 4),
    # Hpp and dp in, one float out
    ("point_quad", 4, {}, 226_730 * (9 + 3) * 4 + 4),
])
def test_kernel_bytes_counted_by_hand(name, w_itemsize, kw, want):
    assert bench.kernel_bytes(name, DUB, w_itemsize, **kw) == want
    ms, by = bench.bound_ms(name, DUB, w_itemsize, **kw)
    assert by == "bytes"
    assert ms == pytest.approx(want / 3.35e12 * 1e3, rel=1e-12)


def test_every_kernel_form_has_a_bound():
    """Each launch counter of `ops/_cuda.py` has its least bytes and
    operations, and no form is bound by its arithmetic on this card but
    K2's camera walks: cam90's reads 16 B for the chain's 265 (Jc and r)
    and the product's 216 operations a row, W C W' | W t's 16 B for the
    chain's 300, W's 81 and the product's 459."""
    from bundleadjustment_jl_tpu_torch.ops import _cuda
    for name in _cuda.LAUNCHES:
        assert bench.kernel_bytes(name, DUB) > 0
        assert bench.bound_ms(name, DUB)[1] == (
            "operations" if name in ("cam_relin_cam90", "cam_relin_wcw_rhs")
            else "bytes")


# A Chrome trace as torch.profiler exports it: the kernel events of two
# kernels and a host op; durations in us.
TRACE_EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 0.0, "dur": 1500.0},
    {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 1600.0, "dur": 250.0},
    {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 2000.0, "dur": 500.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0,
     "dur": 9000.0},
]


@pytest.mark.parametrize("kernels", [True, False])
def test_kernel_sums_reads_the_kernel_events(tmp_path, kernels):
    """``kernel_profile.kernel_sums`` sums each kernel's ms and launches
    and skips the host op; a trace with no kernel event raises
    ``ValueError``, on which ``device_ms`` takes its window again."""
    events = TRACE_EVENTS if kernels else TRACE_EVENTS[3:]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    if not kernels:
        with pytest.raises(ValueError):
            kernel_profile.kernel_sums(path)
        return
    got = kernel_profile.kernel_sums(path)
    assert got == {"k_a": {"ms": 2.0, "launches": 2},
                   "k_b": {"ms": 0.25, "launches": 1}}
    assert list(got) == ["k_a", "k_b"]


# ---------------------------------------------------------------- no card
@pytest.mark.parametrize("entry", ["kernel_profile", "mv_sweep", "timed"])
def test_measurements_refuse_without_a_card(entry):
    """The measurement entry points raise without a card; none falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the measurement would run")
    call = {"kernel_profile": lambda: kernel_profile.device_ms(
                lambda: None, "no_card"),
            "mv_sweep": mv_sweep.sweep,
            "timed": lambda: timed(torch.sum, (torch.ones(4),))}[entry]
    with pytest.raises((RuntimeError, ValueError)):
        call()
