"""The port's half working dtypes and `benchmark/precision.py` against the
JAX package, on the CPU, on problems built from the same seed.

The bars, by stage:

- **bfloat16 against the JAX Pallas route** (interpret mode, route A with
  camera scatter, the port's default route): the route whose casts the
  port follows. Each kernel takes float32 operands and its result is
  rounded to bfloat16 outside it (`ops/normal.py:stages_for`). The JAX
  side runs in a subprocess with XLA's ``--xla_allow_excess_precision=
  false``, which rounds each bfloat16 operation as the JAX code writes
  it. XLA's default keeps excess precision inside a fusion instead. The
  driver's trial states ``cams + s dc`` are then made in float32 and never
  rounded, while the state it accepts is rounded. On the low-stage problem
  below, the JAX default run accepts a step whose rounded state has a
  higher objective than the state before it, so small_obj_change fires
  early (:func:`test_bf16_stage_pallas_low_stage` reads both runs). The
  bars:
  - one linearization, one reduction with its Schur diagonal, one Schur
    matvec and one back-substitution: each value within one bfloat16
    unit of JAX's, and all but 1% of them equal;
  - the bfloat16 stage on the JAX three-stage test's problem: same
    status, iterations within 2, objective within 5% (about the spread
    of the JAX XLA stage between XLA's two precision settings), and the
    first five steps' decisions (each lambda) equal.
    A stage computed in float32 misses this bar (the test shows it);
  - on the low-stage problem: the same status, objective and first five
    decisions, but not the iterations. Both packages reach the same
    bfloat16 floor (55.5) and then walk on it. Near the floor a step is
    accepted only when its trial objective is a whole bfloat16 unit
    (0.25) lower. The stage ends when an accepted step fails to lower the
    rounded objective, or when lambda has grown past the predicted-
    reduction stop. The walk's length follows the rounding of sums made
    in other orders (the test reads it).
- **bfloat16 against the JAX XLA path**: its status, and a state at least
  as good (its objective in float64 within 1.05 of the JAX stage's), but
  still on the bfloat16 floor, more than 5% above the float32 stage's
  end. The XLA path rounds each projection to bfloat16 before it
  subtracts the observation (a bfloat16 unit is 2 px at 300-500 px), so
  it stalls on a floor of rounding error (18 iterations, 94.0).
- **float16** (the JAX ``tests/test_benchmark.py`` problem of
  ``test_low_stage_does_real_iterations``): the JAX decisions, same
  status, iterations within 2, objective within 5%. The stage makes no
  step. max|Hcc| and ||J'r|| overflow float16, so lambda_0 is inf, and as
  in the JAX driver no NaN step is fatal because 1e20 rounds to inf.
- **a stage after a bfloat16 one** starts from the port's bfloat16
  state, and the JAX solve of the same stage from that state is the
  reference: same status, iterations within 1, every history row's
  objective within rel 1e-5 in float32, and the final objective too,
  except after a last step taken at lambda below 1e-5. There the damped
  camera system's condition is ~1e11 and the float32 step follows the
  sums' order. The three-stage cascade's middle stage on the JAX test's
  seed (40) takes its last step at lambda ~1e-6: rel 2e-4 there. On seed
  43 it ends first_order at lambda ~0.05, and its final objective holds
  to 1e-5. A float64 stage holds to rel 1e-9.
- The JAX quality bars of ``tests/test_benchmark.py``: a bfloat16 stage
  does at least 3 iterations and halves the start objective, and the final
  stage is within 1.05 of a straight solve.
- ``facto_solve`` is ``levenberg_marquardt_jit`` with ``facto_dtype``
  (bit for bit), with the JAX row's stage name and W bytes, and within the
  JAX test's 1.10 of the float32 solve.
- The host driver in bfloat16: the JAX host driver's status and
  iterations, and a state at least as good (within 1.05), still on the
  bfloat16 floor.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.benchmark.precision import (
    _LOW_STAGE_TOLS as JAX_LOW_TOLS)
from bundleadjustment_jl_tpu.benchmark.precision import (
    facto_bytes as jax_facto_bytes)
from bundleadjustment_jl_tpu.benchmark.precision import (
    facto_solve as jax_facto_solve)
from bundleadjustment_jl_tpu.benchmark.precision import (
    precision_cascade as jax_cascade)
from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.ops.residuals import objective as jax_objective
from bundleadjustment_jl_tpu.solver.lm import LMOptions as JaxOptions
from bundleadjustment_jl_tpu.solver.lm import levenberg_marquardt as jax_host
from bundleadjustment_jl_tpu.solver.lm_jit import STATUS_NAMES as JAX_NAMES
from bundleadjustment_jl_tpu.solver.lm_jit import (
    levenberg_marquardt_jit as jax_lm)
from bundleadjustment_jl_tpu_torch.benchmark.precision import (
    DEFAULT_STAGES, LOW_STAGE_TOLS, facto_bytes, facto_solve,
    precision_cascade)
from bundleadjustment_jl_tpu_torch.io import synthetic_bal
from bundleadjustment_jl_tpu_torch.models.problem import (
    BAProblem, host_dtype, np_dtype, torch_dtype)
from bundleadjustment_jl_tpu_torch.ops import normal
from bundleadjustment_jl_tpu_torch.ops.schur import (
    back_substitute_quad, reduce_and_diag, schur_matvec)
from bundleadjustment_jl_tpu_torch.solver import LMOptions, levenberg_marquardt
from bundleadjustment_jl_tpu_torch.solver import lm_jit
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    levenberg_marquardt_jit, levenberg_marquardt_jit_chunked)

# The JAX tests/test_benchmark.py problems and options.
LOW_STAGE = dict(ncams=8, npnts=80, obs_per_pnt=4, noise_px=0.5,
                 perturb=3e-2, seed=41)
LOW_OPTS = dict(max_iters=50, satol=0.0, srtol=0.0, lam0_mode="diag")
THREE_STAGE = dict(ncams=8, npnts=60, obs_per_pnt=3, noise_px=0.3,
                   perturb=1e-2, seed=40)
THREE_OPTS = dict(max_iters=40, satol=0.0, srtol=0.0, lam0_mode="diag")
FACTO = dict(ncams=8, npnts=80, obs_per_pnt=4, noise_px=0.5, perturb=1e-2,
             seed=42)
FACTO_OPTS = dict(max_iters=60, lam0_mode="diag", satol=0.0, srtol=0.0,
                  atol=0.0, rtol=1e-5, oatol=0.0, ortol=1e-4)
# The float32 bar: the one the port's float32 solves meet against JAX.
F32_REL = 1e-5
# The bfloat16 stage of a cascade run with LOW_OPTS, as a one-shot solve.
BF16_OPTS = dict(max_iters=50, lam0_mode="diag", pcg_max_iters=100,
                 **LOW_STAGE_TOLS)
ROOT = Path(__file__).resolve().parents[1]

# The JAX side of the Pallas-route tests, run as `python -c` with the spec
# (JSON) as its argument: bfloat16 solves on the Pallas route (interpret
# mode, camera scatter on: the port's route A) and, given "blocks", one
# linearization, reduction, Schur matvec and back-substitution at the
# problem's start. Prints one JSON line.
_JAX_PALLAS = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu.ops import pallas_schur
from bundleadjustment_jl_tpu.ops.normal import assemble_blocks
from bundleadjustment_jl_tpu.ops.schur import (
    back_substitute_quad, reduce_and_diag, schur_matvec)
from bundleadjustment_jl_tpu.solver.lm_jit import (
    STATUS_NAMES, levenberg_marquardt_jit)

spec = json.loads(sys.argv[1])
pallas_schur.set_mode(True)
pallas_schur.INTERPRET = True
pallas_schur.CAM_SCATTER = True


def f(x):
    return np.asarray(x).astype(np.float64).ravel().tolist()


out = {"solves": []}
for prob, opts in spec["solves"]:
    jp, _ = synthetic_bal(**prob)
    r = levenberg_marquardt_jit(jp.astype("bfloat16"), **opts)
    n = int(r.iterations)
    out["solves"].append(dict(
        status=STATUS_NAMES[int(r.status)], iterations=n,
        objective=float(r.objective), hist_obj=f(r.hist_obj[:n]),
        hist_lam=f(r.hist_lam[:n])))
if "blocks" in spec:
    jp, _ = synthetic_bal(**spec["blocks"])
    p = jp.astype("bfloat16")
    b = assemble_blocks(p, with_jr=False, kminor=True)
    sys_, Sd = reduce_and_diag(p, b, jnp.asarray(spec["lam"], jnp.bfloat16))
    v = jnp.asarray(np.asarray(spec["v"]), jnp.bfloat16).reshape(-1, 9)
    dp, Jd2 = back_substitute_quad(p, b, sys_, v)
    out["blocks"] = dict(
        obj=f(b.obj), g_c=f(b.g_c_f), g_p=f(b.g_p_f), Hcc=f(b.Hcc_f),
        Hpp=f(b.Hpp_f), W=f(b.W_t[:27, :p.nobs]), b=f(sys_.b_f), Sd=f(Sd),
        Sv=f(schur_matvec(sys_, v)), dp=f(dp), Jd2=f(Jd2))
print(json.dumps(out))
"""
# The operands of the blockwise check: a lambda and a camera vector.
BLOCK_LAM = 5.0
BLOCK_V = np.random.default_rng(0).standard_normal(THREE_STAGE["ncams"] * 9)
ROUNDED = "--xla_allow_excess_precision=false"
# name: (XLA flags, spec). Each runs ~20-40 s, mostly interpret-mode
# compiles, so all start with the module's first test.
JAX_PALLAS_RUNS = {
    "three": (ROUNDED, dict(solves=[[THREE_STAGE, BF16_OPTS]],
                            blocks=THREE_STAGE, lam=BLOCK_LAM,
                            v=BLOCK_V.tolist())),
    "low": (ROUNDED, dict(solves=[[LOW_STAGE, BF16_OPTS]])),
    "low_default": ("", dict(solves=[[LOW_STAGE, BF16_OPTS]])),
}


class _Runs:
    """The JAX Pallas-route subprocesses, read on first use."""

    def __init__(self):
        self.procs = {
            name: subprocess.Popen(
                [sys.executable, "-c", _JAX_PALLAS, json.dumps(spec)],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=dict(os.environ, XLA_FLAGS=flags,
                                    JAX_PLATFORMS="cpu"))
            for name, (flags, spec) in JAX_PALLAS_RUNS.items()}
        self.out = {}

    def __getitem__(self, name):
        if name not in self.out:
            stdout, stderr = self.procs[name].communicate(timeout=600)
            assert self.procs[name].returncode == 0, stderr[-4000:]
            self.out[name] = json.loads(stdout.strip().splitlines()[-1])
        return self.out[name]

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def jax_pallas():
    runs = _Runs()
    yield runs
    runs.close()


def to_port(jp):
    return BAProblem.from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS},
        device="cpu")


def f64_objective(jp, cams, points) -> float:
    """The float64 objective at a state of the port or of JAX (any dtype)."""
    def np64(x):
        if isinstance(x, torch.Tensor):
            return x.double().numpy()
        return np.asarray(x).astype(np.float64)
    return float(jax_objective(jp, jnp.asarray(np64(cams)),
                               jnp.asarray(np64(points))))


def jax_stage(jp, stage, cams, points, **opts):
    """The JAX one-shot solve of one cascade stage from a port state:
    status, iterations, objective and the history's objectives."""
    res = jax_lm(jp.astype(stage),
                 cams=jnp.asarray(cams.double().numpy()).astype(stage),
                 points=jnp.asarray(points.double().numpy()).astype(stage),
                 pcg_max_iters=100, **opts)
    n = int(res.iterations)
    return (JAX_NAMES[int(res.status)], n, float(res.objective),
            np.asarray(res.hist_obj[:n]).astype(np.float64))


@pytest.fixture(scope="module")
def low_stage():
    jp, _ = jax_synthetic(**LOW_STAGE)
    return jp, to_port(jp)


def test_dtype_names_and_astype_round_as_jax(low_stage):
    jp, tp = low_stage
    for name, dt in (("bfloat16", torch.bfloat16), ("float16", torch.float16),
                     ("float32", torch.float32), ("float64", torch.float64)):
        assert torch_dtype(name) is dt and torch_dtype(dt) is dt
        assert torch_dtype(jnp.dtype(name)) is dt
        ja, ta = jp.astype(name), tp.astype(name)
        assert ta.dtype == dt and ta.plans is tp.plans
        for f in ("cams", "points", "pt2d", "w"):
            np.testing.assert_array_equal(
                getattr(ta, f).double().numpy(),
                np.asarray(getattr(ja, f)).astype(np.float64))
        # The constructors take the names too, with the JAX rounding.
        js_, _ = jax_synthetic(dtype=jnp.dtype(name), **LOW_STAGE)
        ts_, _ = synthetic_bal(dtype=name, device="cpu", **LOW_STAGE)
        for f in ("cams", "points", "pt2d"):
            np.testing.assert_array_equal(
                getattr(ts_, f).double().numpy(),
                np.asarray(getattr(js_, f)).astype(np.float64))
    assert np_dtype("float16") == np.float16
    assert host_dtype("bfloat16") == np.float32
    with pytest.raises(TypeError, match="bfloat16"):
        np_dtype(torch.bfloat16)
    with pytest.raises(TypeError):
        torch_dtype("int32")


def test_cascade_bf16_f32_matches_jax(low_stage):
    jp, tp = low_stage
    got = precision_cascade(tp, **LOW_OPTS)
    assert [r["stage"] for r in got] == list(DEFAULT_STAGES) == [
        "bfloat16", "float32"]
    bf16, f32 = got
    # The bf16 stage alone (its tolerances asked for: it is the last stage
    # there), in both packages: its status and its state in float64.
    low = precision_cascade(tp, stages=("bfloat16",),
                            **{**LOW_OPTS, **LOW_STAGE_TOLS})[0]
    assert low["objective"] == bf16["objective"]
    ref = jax_cascade(jp, stages=("bfloat16",),
                      **{**LOW_OPTS, **JAX_LOW_TOLS})[0]
    assert set(low) == set(ref) and set(bf16) == set(ref) - {"cams",
                                                            "points"}
    assert bf16["status"] == ref["status"]
    port_f64 = f64_objective(jp, low["cams"], low["points"])
    assert port_f64 <= 1.05 * f64_objective(jp, ref["cams"], ref["points"])
    # The JAX XLA bf16 objective of the port's state reads its rounding
    # floor, far above the state's float64 objective (module docstring).
    jax_reading = float(jax_objective(
        jp.astype("bfloat16"),
        jnp.asarray(low["cams"].float().numpy()).astype("bfloat16"),
        jnp.asarray(low["points"].float().numpy()).astype("bfloat16")))
    assert jax_reading > 1.5 * port_f64
    assert low["objective"] == pytest.approx(port_f64, rel=0.05)
    assert bf16["facto_bytes"] == ref["facto_bytes"] == 2 * 27 * tp.nobs_pad
    # ... and on the bfloat16 floor: a stage computed in float32 would end
    # near the float32 stage's objective.
    assert port_f64 > 1.05 * f64_objective(jp, f32["cams"], f32["points"])
    # The JAX quality bars.
    start = f64_objective(jp, tp.cams.float(), tp.points.float())
    assert bf16["iterations"] >= 3
    assert bf16["objective"] < 0.5 * start
    assert f32["objective"] <= bf16["objective"] * 1.05
    # The f32 stage against the JAX solve from the same start.
    status, iters, obj, _ = jax_stage(jp, "float32", low["cams"],
                                      low["points"], **LOW_OPTS)
    assert f32["status"] == status
    assert abs(f32["iterations"] - iters) <= 1
    assert f32["objective"] == pytest.approx(obj, rel=F32_REL)
    assert f32["cams"].dtype == torch.float32
    assert f32["facto_bytes"] == 4 * 27 * tp.nobs_pad


@pytest.mark.parametrize("seed", [THREE_STAGE["seed"], 43])
def test_cascade_bf16_f32_f64_matches_jax(seed):
    jp, _ = jax_synthetic(**{**THREE_STAGE, "seed": seed})
    tp = to_port(jp)
    stages = ("bfloat16", "float32", "float64")
    got = precision_cascade(tp, stages=stages, **THREE_OPTS)
    assert [r["stage"] for r in got] == list(stages)
    straight = levenberg_marquardt_jit(tp, max_iters=60, lam0_mode="diag")
    assert got[-1]["objective"] <= straight.objective * 1.05
    assert got[-1]["cams"].dtype == torch.float64
    assert got[0]["iterations"] >= 3
    # Each stage after the first against the JAX solve from the port's
    # state before it (module docstring: the bars and the lambda rule).
    for i, (stage, rel) in enumerate((("float32", F32_REL),
                                      ("float64", 1e-9)), 1):
        # (a one-stage bfloat16 cascade takes the low-stage tolerances only
        # when asked: its stage is the last)
        low = LOW_STAGE_TOLS if i == 1 else {}
        prev = precision_cascade(tp, stages=stages[:i],
                                 **{**THREE_OPTS, **low})[-1]
        status, iters, obj, rows = jax_stage(jp, stage, prev["cams"],
                                             prev["points"], **THREE_OPTS)
        mine = levenberg_marquardt_jit(
            tp.astype(stage), cams=prev["cams"].to(torch_dtype(stage)),
            points=prev["points"].to(torch_dtype(stage)), pcg_max_iters=100,
            **THREE_OPTS)
        assert (lm_jit.STATUS_NAMES[mine.status], mine.iterations,
                mine.objective) == (got[i]["status"], got[i]["iterations"],
                                    got[i]["objective"])
        assert got[i]["status"] == status
        assert abs(got[i]["iterations"] - iters) <= 1
        k = min(iters, mine.iterations)
        np.testing.assert_allclose(mine.hist_obj[:k], rows[:k], rtol=rel)
        last_lam = float(mine.hist_lam[mine.iterations - 1])
        final_rel = 2e-4 if stage == "float32" and last_lam < 1e-5 else rel
        print(f"seed {seed}, {stage} stage: port {got[i]['status']} "
              f"{got[i]['iterations']}, JAX {status} {iters}; last lambda "
              f"{last_lam:.3g}; final objective rel "
              f"{abs(got[i]['objective'] - obj) / obj:.3g}")
        assert got[i]["objective"] == pytest.approx(obj, rel=final_rel)


def test_cascade_f16_reproduces_jax(low_stage):
    jp, tp = low_stage
    stages = ("float16", "float32")
    ref = jax_cascade(jp, stages=stages, **LOW_OPTS)
    got = precision_cascade(tp, stages=stages, **LOW_OPTS)
    for r, g in zip(ref, got):
        assert g["status"] == r["status"]
    f16, rf16 = got[0], ref[0]
    assert f16["status"] == "max_iter"
    assert abs(f16["iterations"] - rf16["iterations"]) <= 2
    assert f16["objective"] == pytest.approx(rf16["objective"], rel=0.05)
    assert f16["neval_jac"] == rf16["neval_jac"] == 1   # no accepted step
    assert f16["dual_feas"] == rf16["dual_feas"] == float("inf")
    f32, rf32 = got[1], ref[1]
    assert abs(f32["iterations"] - rf32["iterations"]) <= 1
    assert f32["objective"] == pytest.approx(rf32["objective"], rel=F32_REL)


def test_facto_solve_and_bytes_match_jax():
    jp, _ = jax_synthetic(dtype=jnp.float32, **FACTO)
    tp = to_port(jp)
    base = levenberg_marquardt_jit(tp, **FACTO_OPTS)
    for name, dt in (("bfloat16", torch.bfloat16), ("float16", torch.float16)):
        row = facto_solve(tp, name, **FACTO_OPTS)
        ref = jax_facto_solve(jp, name, **FACTO_OPTS)
        assert set(row) == set(ref)
        assert row["stage"] == ref["stage"] == f"float32+{name}facto"
        assert row["facto_bytes"] == ref["facto_bytes"]
        assert row["facto_bytes_full"] == ref["facto_bytes_full"]
        assert row["facto_bytes"] * 2 == row["facto_bytes_full"]
        assert row["facto_bytes"] == jax_facto_bytes(jp, facto_dtype=name)
        direct = levenberg_marquardt_jit(tp, facto_dtype=dt, max_iters=60,
                                         pcg_max_iters=100, **{
                                             k: v for k, v in
                                             FACTO_OPTS.items()
                                             if k != "max_iters"})
        assert row["status"] == lm_jit.STATUS_NAMES[direct.status]
        assert row["iterations"] == direct.iterations
        assert row["objective"] == direct.objective
        assert row["status"] in ("first_order", "small_obj_change",
                                 "small_residual", "small_step")
        assert row["objective"] <= base.objective * 1.10
        assert ref["objective"] <= base.objective * 1.10
    for dt, size in (("bfloat16", 2), ("float16", 2), ("float32", 4),
                     ("float64", 8)):
        assert facto_bytes(tp, work_dtype=dt) == size * 27 * tp.nobs_pad
        assert facto_bytes(tp, work_dtype=dt) == jax_facto_bytes(
            jp, work_dtype=dt)
    assert facto_bytes(tp) == 4 * 27 * tp.nobs_pad


def test_host_driver_bf16_matches_jax(low_stage):
    jp, tp = low_stage
    opts = dict(max_iters=50, lam0_mode="diag", **JAX_LOW_TOLS)
    ref = jax_host(jp.astype("bfloat16"), JaxOptions(**opts))
    got = levenberg_marquardt(tp.astype("bfloat16"), LMOptions(**opts))
    assert got.status == ref.status
    assert abs(got.iterations - ref.iterations) <= 2
    assert got.cams.dtype == torch.bfloat16
    port_f64 = f64_objective(jp, got.cams, got.points)
    assert port_f64 <= 1.05 * f64_objective(jp, ref.cams, ref.points)
    # On the bfloat16 floor, above where a float32 solve ends.
    f32 = levenberg_marquardt(tp.astype("float32"), LMOptions(**opts))
    assert port_f64 > 1.05 * f64_objective(jp, f32.cams, f32.points)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("route", ["fused", "sorted"])
def test_half_working_dtype_on_every_driver(low_stage, monkeypatch, dt,
                                            route):
    """The one-shot, chunked and host drivers take a 2-byte working dtype;
    W is stored in it, and every stage (the kernel wrappers' table, which
    on the CPU runs the plain twins) gets float32 vectors: the kernels'
    operand contract, which the twins do not check, so a wrapper that
    checks it stands in for each."""
    _, tp = low_stage
    for k, v in normal.FORCE_ROUTE[route].items():
        monkeypatch.setattr(normal, k, v)
    bad, w_seen = [], set()

    def checked(fn):
        def call(*args, **kwargs):
            # W (a W reader's first argument) in its storage dtype; every
            # other float operand in float32.
            for i, a in enumerate(list(args) + list(kwargs.values())):
                if isinstance(a, torch.Tensor) and a.is_floating_point():
                    if i == 0 and a.dtype == dt:
                        w_seen.add(fn.__name__)
                    elif a.dtype != torch.float32:
                        bad.append((fn.__name__, i, a.dtype))
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(normal, "KERNELS", normal.Stages(
        *(checked(f) for f in normal.KERNELS)))
    p = tp.astype(dt)
    opts = dict(max_iters=6, lam0_mode="diag", **LOW_STAGE_TOLS)
    one = levenberg_marquardt_jit(p, **opts)
    chunked = levenberg_marquardt_jit_chunked(p, chunk_iters=2, **opts)
    assert (chunked.status, chunked.iterations, chunked.objective) == (
        one.status, one.iterations, one.objective)
    assert torch.equal(chunked.cams, one.cams)
    assert one.cams.dtype == dt and one.hist_obj.dtype == np.float32
    host = levenberg_marquardt(p, LMOptions(**opts))
    assert host.cams.dtype == dt
    assert not bad
    assert w_seen     # the W readers read W in the working dtype
    blocks = normal.assemble_blocks(p, route=normal.kernel_route(p),
                                    stages=normal.PLAIN)
    assert blocks.W_t.dtype == dt and blocks.Hcc_f.dtype == dt
    assert normal.kernel_route(p) == route


def _bf16_units(got: torch.Tensor, ref) -> np.ndarray:
    """|got - ref| in bfloat16 units (ulps) of the larger magnitude."""
    a = got.double().numpy().ravel()
    r = np.asarray(ref)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(r)),
                     np.finfo(np.float32).tiny)
    return np.abs(a - r) / np.exp2(np.floor(np.log2(mag)) - 7)


def test_bf16_blocks_match_jax_pallas(jax_pallas):
    """One bfloat16 linearization (K1), reduction with the exact Schur
    diagonal (K2), Schur matvec (K3) and back-substitution with the
    quadratic form (K3) at the start of the three-stage problem: in
    bfloat16, each value within one bfloat16 unit of the JAX Pallas
    route's, and all but 1% of them equal (a float32 sum in another order
    may round to the neighbouring unit)."""
    ref = jax_pallas["three"]["blocks"]
    jp, _ = jax_synthetic(**THREE_STAGE)
    p = to_port(jp).astype("bfloat16")
    b = normal.assemble_blocks(p, route="fused",
                               stages=normal.solve_stages(p.dtype))
    sys_, Sd = reduce_and_diag(p, b, BLOCK_LAM)
    v = torch.tensor(BLOCK_V, dtype=torch.float32).to(
        torch.bfloat16).reshape(-1, 9)
    dp, Jd2 = back_substitute_quad(p, b, sys_, v)
    got = dict(obj=b.obj, g_c=b.g_c_f, g_p=b.g_p_f, Hcc=b.Hcc_f,
               Hpp=b.Hpp_f, W=b.W_t[:, :p.nobs], b=sys_.b_f, Sd=Sd,
               Sv=schur_matvec(sys_, v), dp=dp, Jd2=Jd2)
    assert set(got) == set(ref)
    for name, t in got.items():
        units = _bf16_units(t, ref[name])
        assert t.dtype == torch.bfloat16, name
        assert units.max() <= 1.0, name
        assert np.mean(units == 0) >= 0.99, name


def test_bf16_stage_makes_jax_pallas_decisions(jax_pallas):
    """The cascade's bfloat16 stage on the three-stage problem against the
    JAX Pallas route: same status, iterations within 2, objective within
    5%, and the first five decisions (lambda rows) equal; a stage computed
    in float32 misses the bar."""
    ref = jax_pallas["three"]["solves"][0]
    jp, _ = jax_synthetic(**THREE_STAGE)
    tp = to_port(jp)
    got = levenberg_marquardt_jit(tp.astype("bfloat16"), **BF16_OPTS)
    row = precision_cascade(tp, **LOW_OPTS)[0]
    assert (row["status"], row["iterations"], row["objective"]) == (
        lm_jit.STATUS_NAMES[got.status], got.iterations, got.objective)
    print(f"bfloat16 stage, three-stage problem: port {row['status']} "
          f"{got.iterations} {got.objective}; JAX Pallas, rounded "
          f"{ref['status']} {ref['iterations']} {ref['objective']}")
    assert row["status"] == ref["status"]
    assert abs(got.iterations - ref["iterations"]) <= 2
    assert got.objective == pytest.approx(ref["objective"], rel=0.05)
    np.testing.assert_array_equal(got.hist_lam[:5].astype(np.float64),
                                  ref["hist_lam"][:5])
    np.testing.assert_allclose(got.hist_obj[:5], ref["hist_obj"][:5],
                               rtol=0.05)
    f32 = levenberg_marquardt_jit(tp.astype("float32"), **BF16_OPTS)
    assert f32.objective < 0.95 * ref["objective"]


def test_bf16_stage_pallas_low_stage(jax_pallas):
    """The low-stage problem's bfloat16 stage against the JAX Pallas route:
    status, objective within 5% and the first five decisions; the walk on
    the floor is not held (module docstring). With XLA's default flags the
    JAX run accepts a step whose rounded state has a higher objective than
    the state before it (its final objective above its last history row)
    and stops early."""
    ref = jax_pallas["low"]["solves"][0]
    default = jax_pallas["low_default"]["solves"][0]
    jp, _ = jax_synthetic(**LOW_STAGE)
    got = levenberg_marquardt_jit(to_port(jp).astype("bfloat16"),
                                  **BF16_OPTS)
    print(f"bfloat16 stage, low-stage problem: port "
          f"{lm_jit.STATUS_NAMES[got.status]} {got.iterations} "
          f"{got.objective}; JAX Pallas, rounded {ref['status']} "
          f"{ref['iterations']} {ref['objective']}; JAX Pallas, XLA "
          f"default {default['status']} {default['iterations']} "
          f"{default['objective']} (last row {default['hist_obj'][-1]})")
    assert lm_jit.STATUS_NAMES[got.status] == ref["status"]
    assert got.objective == pytest.approx(ref["objective"], rel=0.05)
    np.testing.assert_array_equal(got.hist_lam[:5].astype(np.float64),
                                  ref["hist_lam"][:5])
    np.testing.assert_allclose(got.hist_obj[:5], ref["hist_obj"][:5],
                               rtol=0.05)
    assert default["status"] == "small_obj_change"
    assert default["objective"] > default["hist_obj"][-1]
    assert not math.isclose(default["objective"], ref["objective"],
                            rel_tol=0.05)
