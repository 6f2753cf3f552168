"""The reference against the port's CPU route, on a tiny float64
problem: the same decisions and, to rounding, the same objective."""

from __future__ import annotations

import math

import torch

from perfbench import gen
from perfbench.reference import Reference

OPTS = dict(max_iters=100, pcg_max_iters=100, lam0_mode="diag", satol=0.0,
            srtol=0.0, atol=0.0, rtol=1e-5, oatol=0.0, ortol=1e-4)
CFG = dict(ncams=10, npnts=200, nobs=800, dtype="float64",
           noise_px=1.0, perturb=2e-2)


def _port_solve(d, cfg, facto=None):
    from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
        levenberg_marquardt_jit)
    c0, p0 = d["starts"][0]
    problem = BAProblem.from_arrays(
        c0.numpy(), p0.numpy(), d["cam_idx"].numpy(), d["pnt_idx"].numpy(),
        d["pt2d"].numpy(), dtype=torch.float64, pad_obs_to=16, device="cpu")
    return levenberg_marquardt_jit(problem, facto_dtype=facto, **OPTS)


def test_reference_follows_the_port_in_float64():
    for seed in (1, 2):
        d = gen.make(CFG, 1, seed, "cpu")
        port = _port_solve(d, CFG)
        ref = Reference(d["cam_idx"], d["pnt_idx"], d["pt2d"],
                        CFG["ncams"], CFG["npnts"], work_dtype=torch.float64)
        r = ref.solve(*d["starts"][0], OPTS)
        it = port.iterations
        assert (r.iterations, r.status, r.naccepts) == (
            it, int(port.status), port.naccepts)
        assert r.hist_cg == [int(v) for v in port.hist_cg[:it]]
        assert math.isclose(r.objective, port.objective, rel_tol=1e-9)
        for a, b in zip(r.hist_obj, port.hist_obj[:it]):
            assert math.isclose(a, float(b), rel_tol=1e-9)
        assert torch.allclose(r.cams, port.cams, rtol=1e-7, atol=1e-9)
        assert math.isclose(ref.objective(port.cams, port.points),
                            port.objective, rel_tol=1e-12)


def test_reference_with_narrow_w_keeps_the_narrow_rules():
    d = gen.make(CFG, 1, 4, "cpu")
    port = _port_solve(d, CFG, facto=torch.bfloat16)
    ref = Reference(d["cam_idx"], d["pnt_idx"], d["pt2d"], CFG["ncams"],
                    CFG["npnts"], w_dtype=torch.bfloat16,
                    work_dtype=torch.float64)
    r = ref.solve(*d["starts"][0], OPTS)
    assert r.status == int(port.status)
    assert abs(r.iterations - port.iterations) <= 1
    assert math.isclose(r.objective, port.objective, rel_tol=1e-6)
