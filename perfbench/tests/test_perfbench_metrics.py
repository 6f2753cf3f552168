"""The window's rate, the peak and the set-up, and the trace's busy time, idle share and
breakdown, from made-up solves and a made-up trace."""

from __future__ import annotations

import types

import pytest

from perfbench import spec, trace


def _ctx(seconds, window_s, red=None):
    solves = [dict(seconds=s, iterations=9, naccepts=8, cg=40, status=4)
              for s in seconds]
    return types.SimpleNamespace(
        cfg=dict(ncams=2, npnts=3, nobs=6, pad_obs_to=8),
        w_itemsize=4, run=dict(solves=solves, window_s=window_s,
                               trace=red, peak_bytes=3 << 30, setup_s=7.5))


def test_window_rate_peak_and_setup():
    times = [0.1] * 190 + [0.2] * 10
    ctx = _ctx(times, 21.0)
    # the window's length over its solves, not the mean of their times
    assert spec.load_reader("solve_s")(ctx) == pytest.approx(21.0 / 200)
    assert spec.load_reader("peak_gib")(ctx) == 3.0
    assert spec.load_reader("setup_s")(ctx) == 7.5
    assert spec.load_reader("solve_s")(_ctx([], 1.0)) is None


def _ev(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_idle_from_overlapping_kernels():
    events = [
        _ev(trace.WINDOW, 0, 100, "user_annotation"),
        _ev("aten::item", 55, 20, "cpu_op"),
        _ev("aten::_local_scalar_dense", 60, 10, "cpu_op"),
        _ev("void ba_matvec_kernel<float>(int)", 10, 30, "kernel"),
        _ev("gemv", 20, 30, "kernel"),          # overlaps: union 10..50
        _ev("Memcpy DtoH", 80, 5, "gpu_memcpy"),
        _ev("late", 120, 10, "kernel"),         # outside the window
    ]
    red = trace.reduce_events(events)
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["busy_s"] == pytest.approx(45e-6)
    # gaps 0..10, 50..80, 85..100; 50..80's middle 65 is inside the scalar
    # read (the innermost host op)
    assert red["idle"]["aten::_local_scalar_dense"] == pytest.approx(30e-6)
    assert sum(red["idle"].values()) == pytest.approx(55e-6)
    assert red["ops"]["gemv"][0] == pytest.approx(30e-6)
    assert "late" not in red["ops"]
    ctx = _ctx([0.1, 0.1], 0.2, red)
    idle = spec.load_reader("device_idle_share")(ctx)
    assert idle == pytest.approx(55.0)
    assert spec.load_reader("ba_kernel_ms")(ctx) == pytest.approx(
        1e3 * 30e-6 / 2)
    assert spec.load_reader("torch_ops_ms")(ctx) == pytest.approx(
        1e3 * 35e-6 / 2)
    bd = trace.breakdown(red)
    assert bd["device_ops"][0][0] in ("gemv",
                                      "void ba_matvec_kernel<float>(int)")
    assert len(bd["idle_gaps"]) <= trace.TOP
    assert spec.load_reader("kernel_roofline")(ctx) > 0


def test_readers_find_nothing_without_a_trace():
    ctx = _ctx([0.1], 0.1)
    for name in ("ba_kernel_ms", "torch_ops_ms", "kernel_roofline",
                 "device_idle_share"):
        assert spec.load_reader(name)(ctx) is None


def test_kernel_base():
    assert trace.kernel_base("void ba_cam_pass_kernel<1, 9>(BaIn, int)") \
        == "ba_cam_pass_kernel"
    assert trace.kernel_base("ba_objective_kernel(float const*)") \
        == "ba_objective_kernel"
    assert trace.kernel_base(
        "void at::native::vectorized_elementwise_kernel<4>(int)") \
        == "vectorized_elementwise_kernel"
    # as the card's trace names them
    assert trace.kernel_base(
        "void (anonymous namespace)::ba_matvec_kernel<float, 0>(BaRows<float>"
        ", BaTilePlan, float const*, int, ") == "ba_matvec_kernel"
    assert trace.kernel_base(
        "(anonymous namespace)::ba_assemble_camera_kernel(float const*, int "
        "const*)") == "ba_assemble_camera_kernel"
    assert trace.kernel_base(
        "std::enable_if<true, void>::type internal::gemvx::kernel<int, int, "
        "float, true, 5, false, cublasGemvParamsEx<int, cublas") == "kernel"


# A reduction by span of two traced solves, in seconds (`perfbench/spans.py`).
SPANS = {"device": {"ba.linearize": 0.010, "ba.reduce": 0.004,
                    "ba.pcg": 0.020, "ba.dense.assemble": 0.003,
                    "ba.dense.factor": 0.050, "ba.backsub": 0.006,
                    "ba.trial": 0.002, "ba.plan": 0.001, "ba.solve": 0.0005},
         "idle": {"ba.pcg": 0.008, "ba.dense.factor": 0.001,
                  "ba.solve": 0.003, "ba.plan": 0.0002, "outside": 0.001},
         "plan_s": 0.012}
# Each reader's ms (or reads, or calls) a solve on SPANS, 2 solves.
BY_HAND = {"linearize_ms": 5.0, "reduce_ms": 2.0, "cg_ms": 36.5,
           "backsub_ms": 3.0, "trial_ms": 1.0, "plan_ms": 6.0,
           "cg_idle_ms": 4.5, "lm_idle_ms": 1.5, "host_reads": 62.0,
           "alloc_calls": 5.0}


def _traced(spans=SPANS, reads=(60, 64), alloc={"device_calls": 10,
                                                 "retries": 0}):
    ctx = _ctx([0.1, 0.1], 0.2)
    for s, n in zip(ctx.run["solves"], reads):
        s["host_reads"] = n
    ctx.run.update(spans=spans, alloc=alloc)
    return ctx


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_stage_and_count_readers(name):
    read = spec.load_reader(name)
    assert read(_traced()) == pytest.approx(BY_HAND[name])
    # nothing to read: no trace, no counter, no allocator count
    assert read(_traced(spans=None, reads=(), alloc=None)) is None
    assert read(_ctx([0.1], 0.1)) is None


def test_span_readers_need_their_span():
    bare = dict(SPANS, device={}, idle={}, plan_s=0.0)
    for name in ("linearize_ms", "cg_ms", "plan_ms", "cg_idle_ms",
                 "lm_idle_ms"):
        assert spec.load_reader(name)(_traced(spans=bare)) is None


def test_dense_factor_roofline():
    """One factorization and two triangular solves an iteration (9 in each
    of the 2 solves) over the device time in ``ba.dense.factor``."""
    from perfbench import factor_yardstick
    ctx = _traced()
    read = spec.load_reader("dense_factor_roofline")
    least = 18 * factor_yardstick.step_least_s(ctx.cfg)
    assert read(ctx) == pytest.approx(100.0 * least / 0.050)
    assert read(_traced(spans=None)) is None
    assert read(_traced(spans=dict(SPANS, device={}))) is None
