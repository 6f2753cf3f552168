"""The capacity and first-order runs (`bundleadjustment_jl_tpu_torch/capacity.py`)
against the JAX package's, on the CPU at small sizes.

- The recipes: ``capacity.recipe`` at a small size gives the JAX
  ``synthetic_bal``'s arrays with the same arguments, bit for bit.
- ``final13682``'s options on route B1 (both packages put there by lowering
  ``GATHER_TABLE_MAX_CAMS`` to 4, as ``tests/test_torch_final_scale.py``
  does; the JAX kernels in Pallas interpret mode; flags restored and jit
  caches cleared afterwards) through both chunked drivers: float32 W, the
  same status and iterations, objective to rel 1e-5 (f32 sums in another
  order); bfloat16 W, the same status, iterations within two (the bf16
  bar of ROADMAP.md §C), objective within 5%.
- The first-order options stop on ``first_order`` in both packages (the
  JAX XLA route against the port's plain twins) through each first-order
  run's driver, in float64: the same iterations and accepts, objective to
  rel 1e-9. At a size the CPU solves in seconds, ``rtol`` 1e-6 of the
  first gradient norm sits on the float32 gradient floor, where both
  packages' decisions scatter: at ncams 30 / 40 / 60 (npnts 2,000 /
  4,000 / 8,000) the JAX chunked driver ends exception / small_obj_change
  / max_iter and its one-shot driver first_order / first_order /
  exception, so a float32 run says nothing about the port there; in
  float64 each ends first_order.
- The module's lines: every field, from ``--device cpu`` runs over a tiny
  run list, in the test process and, with jax and the JAX package blocked
  from import, in a subprocess; without a card its default device raises.
- A chunked solve's checkpoint at Final-13682's state size round-trips.
"""

import contextlib
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.ops import pallas_schur
from bundleadjustment_jl_tpu.solver import lm_jit as jax_lm_jit
from bundleadjustment_jl_tpu_torch import capacity
from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import normal
from bundleadjustment_jl_tpu_torch.solver import lm_jit

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# The lines' fields (capacity.py's docstring).
FIELDS = {"problem", "run", "device", "nobs", "nobs_pad", "nvar", "gen_s",
          "plan_build_s", "solve_s", "first_solve_s", "warmup", "iters",
          "status", "objective", "rmse_px", "expected_obj", "expected_rmse",
          "naccepts", "cg_matvecs", "dual_feas", "gnorm0", "gnorm_min",
          "facto_dtype", "route", "driver", "chunk_iters", "max_iters",
          "launches", "w_launches", "peak_gb", "card", "record", "misses"}
# Tiny stand-ins for the runs' problems, with their observations a point.
TINY = {name: (family, 10 + i, 150, opp)
        for i, (name, (family, _, _, opp)) in enumerate(
            capacity.SIZES.items())}
# Route B1 at a tiny size: camera scatter on, above GATHER_TABLE_MAX_CAMS.
B1_GATES = dict(CAM_SCATTER=True, GATHER_TABLE_MAX_CAMS=4)


def to_port(jp):
    return BAProblem.from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS},
        device="cpu")


def _clear_jax_caches():
    jax_lm_jit._lm_init.clear_cache()
    jax_lm_jit._lm_run.clear_cache()


@contextlib.contextmanager
def b1_route(pallas):
    """Both packages on route B1 (``pallas``: the JAX kernels in interpret
    mode, else the JAX XLA route); every flag restored and the JAX
    solver's jit caches cleared (the gates are read at trace time)."""
    names = ["PALLAS_MODE", "INTERPRET", *B1_GATES]
    old_jax = {k: getattr(pallas_schur, k) for k in names}
    old_port = {k: getattr(normal, k) for k in B1_GATES}
    _clear_jax_caches()
    try:
        pallas_schur.set_mode(pallas)
        pallas_schur.INTERPRET = True
        for k, v in B1_GATES.items():
            setattr(pallas_schur, k, v)
            setattr(normal, k, v)
        yield
    finally:
        for k, v in old_jax.items():
            setattr(pallas_schur, k, v)
        for k, v in old_port.items():
            setattr(normal, k, v)
        _clear_jax_caches()


def jax_solve(jp, spec):
    facto = None if spec.facto_dtype is None else getattr(
        jnp, spec.facto_dtype)
    if spec.chunk_iters is None:
        return jax_lm_jit.levenberg_marquardt_jit(
            jp, max_iters=spec.max_iters, facto_dtype=facto, **spec.opts)
    return jax_lm_jit.levenberg_marquardt_jit_chunked(
        jp, max_iters=spec.max_iters, chunk_iters=spec.chunk_iters,
        max_time=capacity.MAX_TIME, facto_dtype=facto, **spec.opts)


# ---------------------------------------------------------------- recipes
@pytest.mark.parametrize("name", list(capacity.SIZES))
def test_recipe_gives_the_jax_arrays(name):
    """Each problem's recipe at ncams 40, npnts 3000 (its observations a
    point) gives the JAX generator's problem bit for bit."""
    opp = capacity.SIZES[name][3]
    kw = capacity.recipe(40, 3000, opp)
    assert kw["seed"] == 40
    jp, _ = jax_synthetic(**kw, dtype=jnp.float32)
    tp, _ = synthetic_bal(**kw, dtype=torch.float32, device="cpu")
    for k in BAProblem.FIELDS:
        ref = getattr(jp, k)
        if ref is None:
            assert getattr(tp, k) is None
            continue
        got = getattr(tp, k)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=k)


# ------------------------------------------------------- final13682 on B1
@pytest.mark.parametrize("facto", [None, "bfloat16"])
def test_final13682_options_on_b1_match_jax_pallas(facto):
    """``final13682``'s chunked run, W in float32 and in bfloat16, against
    the JAX chunked driver with the same options on route B1."""
    spec = capacity.RUNS["final13682"]._replace(facto_dtype=facto)
    jp, _ = jax_synthetic(**capacity.recipe(12, 300, 7), dtype=jnp.float32)
    with b1_route(pallas=True):
        ref = jax_solve(jp, spec)
        tp = to_port(jp)
        assert normal.kernel_route(tp) == "scatter_split"
        got = capacity.solve(tp, spec)
    robj = float(ref.objective)
    assert got.status == int(ref.status)
    if facto is None:
        assert got.iterations == int(ref.iterations)
        assert abs(got.objective - robj) <= 1e-5 * robj
    else:
        assert abs(got.iterations - int(ref.iterations)) <= 2
        assert abs(got.objective - robj) <= 0.05 * robj


# ----------------------------------------------------------- first order
@pytest.mark.parametrize("name", list(capacity.FIRST_ORDER))
def test_first_order_options_stop_on_first_order(name):
    """Each first-order run's driver and options, float64 (W too), at
    ncams 30, npnts 2,000: both packages stop on first_order with the same
    iterations and accepts."""
    spec = capacity.FIRST_ORDER[name]._replace(facto_dtype=None)
    opp = capacity.SIZES[spec.problem][3]
    jp, _ = jax_synthetic(**capacity.recipe(30, 2000, opp),
                          dtype=jnp.float64)
    ref = jax_solve(jp, spec)
    got = capacity.solve(to_port(jp), spec)
    assert jax_lm_jit.STATUS_NAMES[int(ref.status)] == "first_order"
    assert got.status_name() == "first_order"
    assert (got.iterations, got.naccepts) == (int(ref.iterations),
                                              int(ref.naccepts))
    assert got.objective == pytest.approx(float(ref.objective), rel=1e-9)


# ----------------------------------------------------------- the module
@pytest.mark.parametrize("name", list(capacity.RUNS))
def test_run_line_has_every_field(name, monkeypatch, capsys):
    """``main(["--device", "cpu", "--only", name])`` over tiny problems
    prints one line with every field, the run's options and no launch
    (the CPU runs the plain twins)."""
    monkeypatch.setattr(capacity, "SIZES", TINY)
    spec = capacity.RUNS[name]
    capacity.main(["--device", "cpu", "--only", name])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == FIELDS
    family, ncams, npnts, opp = TINY[spec.problem]
    assert line["problem"] == f"{family}-{ncams}-{npnts}"
    assert (line["run"], line["device"]) == (name, "cpu")
    assert line["nobs"] == npnts * opp and line["nobs_pad"] % 512 == 0
    assert line["nvar"] == 9 * ncams + 3 * npnts
    assert line["expected_rmse"] == pytest.approx(
        (1 - line["nvar"] / (2 * line["nobs"])) ** 0.5)
    assert line["rmse_px"] == pytest.approx(
        (line["objective"] / line["nobs"]) ** 0.5)
    assert (line["chunk_iters"], line["max_iters"], line["facto_dtype"]) \
        == (spec.chunk_iters, spec.max_iters, spec.facto_dtype)
    assert line["route"] == normal.kernel_route(
        capacity.make(spec.problem, "cpu")[0])
    assert line["launches"] == {} and line["w_launches"] == {}
    assert line["warmup"] is True and line["peak_gb"] is None
    assert line["record"]["status"] == spec.record[0]
    assert 0 < line["iters"] <= spec.max_iters
    assert line["cg_matvecs"] > 0 and np.isfinite(line["objective"])


def test_module_imports_no_jax_and_runs_on_the_cpu(tmp_path):
    """In a process where jax and the JAX package cannot be imported, the
    module's CPU run over a tiny problem prints its line and appends it to
    ``--out``."""
    out = tmp_path / "lines.jsonl"
    code = textwrap.dedent(f"""
        import importlib.abc, sys
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
        import torch
        torch.set_num_threads(1)
        from bundleadjustment_jl_tpu_torch import capacity
        capacity.SIZES = {TINY!r}
        rc = capacity.main(["--device", "cpu", "--only", "venice1778",
                            "--out", {str(out)!r}])
        print("jax" in sys.modules, rc)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    *printed, tail = proc.stdout.strip().splitlines()
    assert tail.split()[0] == "False"
    assert printed == out.read_text().strip().splitlines()
    assert set(json.loads(printed[0])) == FIELDS


def test_module_refuses_without_a_card():
    """The default device is the card: without one the module raises and
    does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the runs would start")
    with pytest.raises(RuntimeError):
        capacity.main(["--only", "venice1778"])


def test_runs_keep_the_jax_scripts_options():
    """The runs' drivers and options are the JAX scripts' (module
    docstring), each at the route its problem's default gates pick."""
    cap, fo = capacity.CAPACITY, capacity.FIRST_ORDER
    assert [(r.chunk_iters, r.max_iters, r.facto_dtype)
            for r in cap.values()] == [(3, 30, None), (3, 30, None),
                                       (1, 10, "bfloat16")]
    assert [(r.chunk_iters, r.max_iters, r.facto_dtype)
            for r in fo.values()] == [(1, 40, "bfloat16"), (None, 100, None)]
    for spec in capacity.RUNS.values():
        _, ncams, npnts, opp = capacity.SIZES[spec.problem]
        shape = type("Shape", (), dict(ncams=ncams,
                                       nobs_pad=-(-npnts * opp // 512) * 512))
        assert normal.kernel_route(shape) == spec.route
        assert set(spec.opts) <= set(lm_jit._OPTIONS)


def test_timed_solve_without_room_keeps_the_first_solve(monkeypatch, capsys):
    """Where the timed solve finds no room beside what the warm-up left
    (``torch.cuda.OutOfMemoryError``), the run says so and its line holds
    the first solve: ``warmup`` false, ``solve_s`` the first solve's."""
    monkeypatch.setattr(capacity, "SIZES", TINY)
    timed, calls = capacity._timed, []

    def no_room_second(problem, spec, device):
        calls.append(device)
        if len(calls) == 2:
            raise torch.cuda.OutOfMemoryError("no room")
        return timed(problem, spec, device)
    monkeypatch.setattr(capacity, "_timed", no_room_second)
    line = capacity.run("venice1778", "cpu")
    assert len(calls) == 2
    assert line["warmup"] is False
    assert line["solve_s"] == line["first_solve_s"] > 0
    assert line["iters"] > 0 and line["status"] != "running"
    assert "no room beside what the warm-up left" in capsys.readouterr().err


def test_checkpoint_holds_a_final13682_state(tmp_path):
    """A chunked solve's checkpoint at Final-13682's state size (13,682
    cameras, 4,456,117 points: 13.5 M variables, 54 MB of float32) is
    written atomically, kept by the rotation and read back bit for bit."""
    from bundleadjustment_jl_tpu_torch.utils.checkpoint import (
        CheckpointManager, latest_checkpoint)
    _, ncams, npnts, _ = capacity.SIZES["final13682"]
    gen = torch.Generator().manual_seed(0)
    cams = torch.rand((ncams, 9), generator=gen)
    points = torch.rand((npnts, 3), generator=gen)
    ckpt = CheckpointManager(str(tmp_path), every=1, keep=1)
    for it in (1, 2):
        ckpt.maybe_save(it, cams, points, lam=1e-3 * it,
                        meta={"objective": 24445596.0, "gtol": 62.96})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step-2.npz"]
    assert latest_checkpoint(str(tmp_path)).endswith("step-2.npz")
    back = ckpt.restore_latest()
    np.testing.assert_array_equal(back["cams"], cams.numpy())
    np.testing.assert_array_equal(back["points"], points.numpy())
    assert (back["iteration"], back["lam"]) == (2, 2e-3)
    assert back["meta"]["gtol"] == 62.96
