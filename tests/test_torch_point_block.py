"""The Schur elimination's point-block stages (`ops/point_block.py`) on the
CPU.

- Every stage table (``KERNELS``, ``PLAIN``, ``GROUPS``) has the two
  fields, ``point_inv_rhs`` and ``point_quad``.
- Through the solve's stage table (float32, float64, and bfloat16 through
  its 2-byte wrapping), with and without a float16 W's range scale, the
  stages give bit for bit what the Schur glue computed before them:
  ``inv3x3_damped_flat``, the hat ``Hpp_inv / s^2``, ``s g_p``, an einsum
  for ``Hpp_inv g_p``, and ``sum(dp * einsum(Hpp, dp))``, on blocks that
  hit each fallback (det not above 8 tiny, a non-finite det, a non-finite
  diagonal).
- The float64 damped inverse equals the JAX package's on those blocks.
- ``reduce_and_diag``, ``reduce_system`` and ``back_substitute_quad`` take
  the inverse and the point term from the stage table (a spy table) on
  each route.
- ``lm_jit.expected_launches`` gives ``point_inv`` and ``point_quad`` once
  per iteration to the Schur steps on every route, and none to CGLS.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.ops.normal import (
    inv3x3_damped_flat as jax_inv3x3_damped_flat)
from bundleadjustment_jl_tpu_torch.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu_torch.ops import normal, schur
from bundleadjustment_jl_tpu_torch.ops import point_block as pb
from bundleadjustment_jl_tpu_torch.solver import lm_jit

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

FIELDS = ("point_inv_rhs", "point_quad")
LAM = 0.37


def blocks(dtype, n=203, seed=0):
    """(npnts*9,) point blocks, ``n`` of them SPD and random, then one
    block for each fallback of the damped inverse at ``LAM``; g and dp
    (npnts, 3)."""
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((n, 4, 3))
    H = np.einsum("pka,pkb->pab", J, J) * rng.uniform(0.1, 50.0, (n, 1, 1))
    edge = np.zeros((4, 3, 3))
    edge[0] = -LAM * np.eye(3)                   # det 0 once damped
    edge[1] = 1e30 * np.ones((3, 3)) + np.eye(3)  # det overflows to inf
    edge[2] = np.diag([np.nan, 1.0, 2.0])        # non-finite diagonal
    edge[3] = np.diag([np.inf, -5.0, 2.0])       # and a negative one
    H = np.concatenate([H, edge]).reshape(-1)
    g = rng.standard_normal((n + 4, 3))
    dp = rng.standard_normal((n + 4, 3))
    return (torch.tensor(H, dtype=dtype), torch.tensor(g, dtype=dtype),
            torch.tensor(dp, dtype=dtype))


def before(Hpp_f, g_p_f, dp, lam, w_scale):
    """The Schur glue's point-block work as it was written before the
    stages: ``(Hpp_inv hatted, Hpp_inv g_p hatted, dp' Hpp dp)``, each in
    the working dtype."""
    inv = pb.inv3x3_damped_flat(Hpp_f, lam)
    g = g_p_f
    if w_scale is not None:
        inv, g = inv / torch.square(w_scale), g_p_f * w_scale
    t = torch.einsum("pab,pb->pa", inv.reshape(-1, 3, 3), g.reshape(-1, 3))
    q = torch.sum(dp * torch.einsum("pab,pb->pa", Hpp_f.reshape(-1, 3, 3),
                                    dp))
    return inv, t, q


@pytest.mark.parametrize("field", FIELDS)
def test_every_stage_table_has_the_point_blocks(field):
    assert getattr(normal.KERNELS, field) is getattr(pb, field)
    assert getattr(normal.PLAIN, field) is getattr(pb, f"_{field}_plain")
    assert getattr(normal.GROUPS, field) is getattr(normal.PLAIN, field)


@pytest.mark.parametrize("scale", [None, 16.0, 512.0],
                         ids=["no_scale", "scale16", "scale512"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("table", ["KERNELS", "PLAIN"])
def test_stages_give_the_glue_before_them_bit_for_bit(table, dtype, scale):
    """512 squares past float16's range (inf), as the scale's own dtype
    computes it: kept as it was."""
    Hpp_f, g, dp = blocks(dtype)
    s = None if scale is None else torch.tensor(scale, dtype=torch.float16)
    st = normal.stages_for(getattr(normal, table), dtype)
    inv, t = st.point_inv_rhs(Hpp_f, g.reshape(-1), LAM, s)
    q = st.point_quad(Hpp_f, dp)
    ref_inv, ref_t, ref_q = before(Hpp_f, g.reshape(-1), dp, LAM, s)
    for got, ref in ((inv, ref_inv), (t, ref_t), (q, ref_q)):
        assert got.dtype == ref.dtype == dtype
        assert got.shape == ref.shape
        assert torch.equal(got.isnan(), ref.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))


def test_damped_inverse_matches_jax_at_each_fallback():
    Hpp_f, _, _ = blocks(torch.float64)
    got = pb.inv3x3_damped_flat(Hpp_f, LAM)
    ref = np.asarray(jax_inv3x3_damped_flat(jnp.asarray(Hpp_f.numpy()), LAM))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=0.0)
    fallback = got.reshape(-1, 9)[-4:]
    assert bool(torch.isfinite(fallback).all())
    assert bool((fallback[:, [1, 2, 3, 5, 6, 7]] == 0).all())


def spy_table(calls):
    """``normal.PLAIN`` with its two point-block stages recording their
    calls by name."""
    def spy(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call
    return normal.PLAIN._replace(
        **{f: spy(f, getattr(normal.PLAIN, f)) for f in FIELDS})


@pytest.mark.parametrize("piece", ["reduce_and_diag", "reduce_system",
                                   "back_substitute_quad"])
@pytest.mark.parametrize("route", ["fused", "scatter_split", "sorted"])
def test_schur_glue_calls_the_point_block_stages(route, piece):
    p = synthetic_bal(ncams=5, npnts=60, obs_per_pnt=3, seed=4,
                      perturb=1e-2, dtype=torch.float32, device="cpu")[0]
    calls = []
    b = normal.assemble_blocks(p, route=route, stages=spy_table(calls))
    plain = b._replace(stages=normal.PLAIN)
    lam = 1e-2
    if piece == "back_substitute_quad":
        dc = 1e-3 * torch.ones((p.ncams, 9))
        sys = schur.reduce_system(p, b, lam)
        del calls[:]
        dp, q = schur.back_substitute_quad(p, b, sys, dc)
        ref_dp, ref_q = schur.back_substitute_quad(
            p, plain, schur.reduce_system(p, plain, lam), dc)
        assert calls == ["point_quad"]
        assert torch.equal(dp, ref_dp) and torch.equal(q, ref_q)
        return
    out = getattr(schur, piece)(p, b, lam)
    ref = getattr(schur, piece)(p, plain, lam)
    assert calls == ["point_inv_rhs"]
    sys, ref_sys = (out[0], ref[0]) if piece == "reduce_and_diag" else (
        out, ref)
    assert torch.equal(sys.Hpp_inv_f, ref_sys.Hpp_inv_f)
    assert torch.equal(sys.b_f, ref_sys.b_f)


@pytest.mark.parametrize("solver", lm_jit.SOLVERS)
@pytest.mark.parametrize("route", normal.ROUTES)
def test_expected_launches_of_the_point_blocks(route, solver):
    got = lm_jit.expected_launches(route, 7, 5, 30, solver)
    want = 0 if solver == "cgls" else 7
    assert got.get("point_inv", 0) == want
    assert got.get("point_quad", 0) == want
