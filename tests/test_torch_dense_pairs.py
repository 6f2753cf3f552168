"""The dense Schur step's assembly by camera pairs, on the CPU.

- The pair plan (`ops/plans.py:PairPlan`): every point's pairs of true
  rows ``k <= l`` once, ``sum_p n_p (n_p + 1) / 2`` of them (the padding
  rows left out), oriented ``cam_i >= cam_j``, sorted by their block of S's
  lower triangle in point order within it; every block of the lower
  triangle has chunks of at most the chunk size, and the blocks of several
  chunks their partial slots in order. The problem holds a point seen
  twice by one camera.
- The kernel's walk over the plan (``csrc/dense_pairs.cu``: each chunk's
  pairs in order, a block of one chunk stored at once, the slots of the
  others summed by the merge pass), emulated in float64, writes every
  entry of S once and equals the plain twin.
- The plain twin (`ops/dense_schur.py:_dense_pairs_plain`) equals the JAX
  formulation that the plain route keeps (two targets and a matmul): to
  rel 1e-12 in float64, to float32's rounding in float32; with ``Hcc_l``
  on the diagonal or without (a mesh shard's part, summed before it), and
  the latter plus ``Hcc_l`` equals the former bit for bit.
- The port's dense LM solve (float64, the plain route) against
  `perfbench/reference_dense.py`: the same status, iterations and
  accepts, objective to rel 1e-10; a float32 solve on the kernel route (its
  wrapper's plain twin on the CPU) makes the plain route's decisions.
- The gate follows the route: the plain route's estimate refuses
  Venice-1778's sizes, the kernel route's admits them; a cap between the
  two estimates lets a kernel-route solve run and refuses a plain one.
- The spans ``ba.dense.assemble`` and ``ba.dense.factor``, one each an
  iteration inside ``ba.pcg``, and the host reads of a dense solve:
  ``expected_host_reads(..., "dense")`` plus the pair plan's two.
"""

import dataclasses
import json
import math
from collections import Counter

import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu_torch.io import synthetic_bal
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import normal, plans, schur
from bundleadjustment_jl_tpu_torch.ops import dense_schur as ds
from bundleadjustment_jl_tpu_torch.solver.lm_jit import (
    expected_host_reads, levenberg_marquardt_jit)
from bundleadjustment_jl_tpu_torch.utils import profiling
from perfbench.reference_dense import Reference

torch.set_num_threads(1)

LAM = 1e-2
VENICE = dict(ncams=1778, npnts=993923, nobs=5001946)
VENICE_PAIRS = 15102831


def with_duplicates(dtype=torch.float64, seed=3):
    """A small problem whose point 0 is seen twice by its first camera and
    point 5 three times by one camera, padded past its rows."""
    p, _ = synthetic_bal(ncams=7, npnts=60, obs_per_pnt=4, noise_px=0.3,
                         perturb=2e-3, seed=seed, device="cpu")
    n = p.nobs
    cam, pnt = p.cam_idx[:n].numpy(), p.pnt_idx[:n].numpy()
    xy = p.pt2d[:n].numpy()
    extra = [0, 5, 5]
    rows = [int(np.flatnonzero(pnt == q)[0]) for q in extra]
    cam = np.concatenate([cam, cam[rows]])
    pnt = np.concatenate([pnt, pnt[rows]])
    xy = np.concatenate([xy, xy[rows] + 0.5])
    return BAProblem.from_arrays(p.cams.numpy(), p.points.numpy(), cam, pnt,
                                 xy, dtype=dtype, pad_obs_to=64,
                                 device="cpu")


@pytest.fixture(scope="module")
def dup():
    return with_duplicates()


def system(problem, stages=normal.PLAIN):
    blocks = normal.assemble_blocks(problem, stages=stages)
    return schur.reduce_system(problem, blocks, LAM)


@pytest.mark.parametrize("chunk", [1, 3, plans.PAIR_CHUNK])
def test_pair_plan_lists_each_points_pairs(dup, chunk):
    p = dup
    assert p.nobs_pad > p.nobs
    plan = plans.build_pair_plan(p, plans.count_pairs(p), chunk)
    n = p.nobs
    pnt, cam = p.pnt_idx.long(), p.cam_idx.long()
    counts = torch.bincount(pnt[:n], minlength=p.npnts)
    assert plan.npairs == int(torch.sum(counts * (counts + 1) // 2))
    i, j = plan.pair_i.long(), plan.pair_j.long()
    assert bool((i < n).all() and (j < n).all())
    assert torch.equal(pnt[i], pnt[j]) and bool((cam[i] >= cam[j]).all())
    got = sorted(zip(torch.minimum(i, j).tolist(),
                     torch.maximum(i, j).tolist()))
    want = sorted((k, l) for q in range(p.npnts)
                  for k in range(n) if pnt[k] == q
                  for l in range(k, n) if pnt[l] == q)
    assert got == want
    blk = cam[i] * (cam[i] + 1) // 2 + cam[j]
    key = blk * (n * n) + pnt[i] * n + torch.minimum(i, j)
    assert bool((blk[1:] >= blk[:-1]).all())
    # Within a block, pairs by point, then by their first row.
    assert bool((key[1:] >= key[:-1]).all())
    nblk = p.ncams * (p.ncams + 1) // 2
    starts = plan.chunk_starts.long()
    assert int(starts[0]) == 0 and int(starts[-1]) == plan.npairs
    sizes = starts[1:] - starts[:-1]
    assert bool((sizes >= 0).all() and (sizes <= chunk).all())
    cb = plan.chunk_block.long()
    assert torch.equal(torch.unique(cb), torch.arange(nblk))
    assert bool((cb[1:] >= cb[:-1]).all())
    for c in range(plan.nchunks):
        s, e = int(starts[c]), int(starts[c + 1])
        assert bool((blk[s:e] == cb[c]).all())
    per = torch.bincount(cb, minlength=nblk)
    assert torch.equal(plan.multi_block.long(),
                       torch.nonzero(per > 1).flatten())
    slot = plan.chunk_slot.long()
    multi = per[cb] > 1
    assert bool((slot[~multi] == -1).all())
    assert torch.equal(slot[multi], torch.arange(int(multi.sum())))
    assert plan.nslots == int(multi.sum())
    ms = plan.multi_slots.long()
    assert torch.equal(ms[1:] - ms[:-1], per[plan.multi_block.long()])
    if chunk == 1:
        assert plan.nmulti > 0


def block_of(b):
    ci = int((math.isqrt(8 * b + 1) - 1) // 2)
    return ci, b - ci * (ci + 1) // 2


def kernel_walk(W_t, problem, Hpp_inv_f, hcc_l_f, plan):
    """``csrc/dense_pairs.cu``'s walk over ``plan`` in float64, and how
    often each entry of S was written."""
    nc = problem.ncams
    W = W_t.double().T.reshape(-1, 9, 3)
    H = Hpp_inv_f.double().reshape(-1, 3, 3)
    hcc = None if hcc_l_f is None else hcc_l_f.double().reshape(nc, 9, 9)
    pnt = problem.pnt_idx.long()
    S = torch.full((9 * nc, 9 * nc), float("nan"), dtype=torch.float64)
    hits = torch.zeros((9 * nc, 9 * nc), dtype=torch.long)
    part = torch.zeros((plan.nslots, 9, 9), dtype=torch.float64)

    def store(b, M):
        ci, cj = block_of(b)
        lo, hi = slice(9 * ci, 9 * ci + 9), slice(9 * cj, 9 * cj + 9)
        if ci != cj:
            S[hi, lo] = -M.T
            hits[hi, lo] += 1
        S[lo, hi] = hcc[ci] - M if ci == cj and hcc is not None else -M
        hits[lo, hi] += 1

    starts = plan.chunk_starts.tolist()
    for c, b in enumerate(plan.chunk_block.tolist()):
        ci, cj = block_of(b)
        M = torch.zeros((9, 9), dtype=torch.float64)
        for q in range(starts[c], starts[c + 1]):
            i, j = int(plan.pair_i[q]), int(plan.pair_j[q])
            h = H[pnt[i]]
            M += (W[i] @ h) @ W[j].T
            if ci == cj and i != j:
                M += (W[j] @ h) @ W[i].T
        slot = int(plan.chunk_slot[c])
        if slot >= 0:
            part[slot] = M
        else:
            store(b, M)
    ms = plan.multi_slots.tolist()
    for m, b in enumerate(plan.multi_block.tolist()):
        M = torch.zeros((9, 9), dtype=torch.float64)
        for s in range(ms[m], ms[m + 1]):
            M += part[s]
        store(b, M)
    return S, hits


@pytest.mark.parametrize("chunk", [1, 3, plans.PAIR_CHUNK])
def test_kernel_walk_writes_once_and_equals_the_twin(dup, chunk):
    sys = system(dup)
    plan = plans.build_pair_plan(dup, plans.count_pairs(dup), chunk)
    S, hits = kernel_walk(sys.W_t, dup, sys.Hpp_inv_f, sys.Hcc_l_f, plan)
    assert bool((hits == 1).all())
    twin = ds._dense_pairs_plain(sys.W_t, dup, sys.Hpp_inv_f, sys.Hcc_l_f)
    np.testing.assert_allclose(S.numpy(), twin.numpy(), rtol=1e-12,
                               atol=1e-12 * float(twin.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("with_hcc", [True, False], ids=["hcc", "part"])
def test_pair_twin_equals_the_targets(dtype, with_hcc):
    p = with_duplicates(dtype, seed=11)
    sys = system(p)
    hcc = sys.Hcc_l_f if with_hcc else None
    got = ds._dense_pairs_plain(sys.W_t, p, sys.Hpp_inv_f, hcc)
    ref = ds._dense_schur_plain(sys.W_t, p, sys.Hpp_inv_f, hcc)
    assert got.dtype == dtype and got.shape == (9 * p.ncams, 9 * p.ncams)
    rtol = 1e-12 if dtype == torch.float64 else 8 * torch.finfo(dtype).eps
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol,
                               atol=rtol * scale)
    if not with_hcc:
        whole = ds._dense_pairs_plain(sys.W_t, p, sys.Hpp_inv_f,
                                      sys.Hcc_l_f)
        ds._add_diag(got, sys.Hcc_l_f)
        assert torch.equal(got, whole)


@pytest.mark.parametrize("seed,opts", [
    (5, dict(max_iters=40, lam0_mode="diag")),
    (8, dict(max_iters=40, lam0_mode="diag", rtol=1e-10, ortol=1e-12)),
], ids=["stops", "tight"])
def test_dense_solve_matches_reference_dense(seed, opts):
    p, _ = synthetic_bal(ncams=8, npnts=120, obs_per_pnt=4, noise_px=1.0,
                         perturb=2e-2, seed=seed, device="cpu")
    n = p.nobs
    ref = Reference(p.cam_idx[:n], p.pnt_idx[:n], p.pt2d[:n], p.ncams,
                    p.npnts, dtype=torch.float64, work_dtype=torch.float64)
    want = ref.solve(p.cams, p.points, opts)
    got = levenberg_marquardt_jit(p, use_dense=True, **opts)
    assert want.iterations > 3
    assert (got.status, got.iterations, got.naccepts) == (
        want.status, want.iterations, want.naccepts)
    assert got.objective == pytest.approx(want.objective, rel=1e-10)
    assert list(got.hist_cg[:got.iterations]) == [0] * got.iterations


def test_f32_kernel_route_makes_the_plain_routes_decisions(monkeypatch):
    p = with_duplicates(torch.float64, seed=7).astype(torch.float32)
    opts = dict(max_iters=8, lam0_mode="diag", atol=0.0, rtol=0.0,
                satol=0.0, srtol=0.0, oatol=0.0, ortol=0.0)
    calls = Counter()
    twin = ds._dense_pairs_plain

    def counted(*args, **kwargs):
        calls["pairs"] += 1
        return twin(*args, **kwargs)
    monkeypatch.setattr(ds, "_dense_pairs_plain", counted)
    kern = levenberg_marquardt_jit(dataclasses.replace(p, plans={}),
                                   use_dense=True, **opts)
    assert calls["pairs"] == kern.iterations == 8
    monkeypatch.setattr(normal, "PALLAS_MODE", False)
    plain = levenberg_marquardt_jit(dataclasses.replace(p, plans={}),
                                    use_dense=True, **opts)
    assert calls["pairs"] == 8
    assert (kern.status, kern.naccepts) == (plain.status, plain.naccepts)
    assert kern.objective == pytest.approx(plain.objective, rel=1e-5)


def test_dense_gate_follows_the_route(monkeypatch, dup):
    with pytest.raises(MemoryError, match="plain route"):
        schur.check_dense_feasible(**VENICE)
    schur.check_dense_feasible(**VENICE, npairs=VENICE_PAIRS)
    kern = schur.dense_schur_bytes(**VENICE, npairs=VENICE_PAIRS)
    assert 2 * (9 * 1778) ** 2 * 4 < kern < 6 << 30
    assert schur.dense_pair_count(dup, torch.float64) is None
    p32 = synthetic_bal(ncams=10, npnts=2000, obs_per_pnt=4, seed=2,
                        dtype=torch.float32, device="cpu")[0]
    npairs = schur.dense_pair_count(p32, torch.float32)
    assert npairs == plans.pair_count(p32)
    args = (p32.ncams, p32.npnts, p32.nobs_pad, 4)
    lo = schur.dense_schur_bytes(*args, npairs=npairs)
    hi = schur.dense_schur_bytes(*args)
    assert lo < hi
    monkeypatch.setattr(schur, "DENSE_MAX_BYTES", (lo + hi) // 2)
    res = levenberg_marquardt_jit(p32, use_dense=True, max_iters=3)
    assert res.iterations >= 1 and np.isfinite(res.objective)
    monkeypatch.setattr(normal, "PALLAS_MODE", False)
    with pytest.raises(MemoryError, match="plain route"):
        levenberg_marquardt_jit(p32, use_dense=True, max_iters=3)


def test_dense_spans_and_host_reads(tmp_path):
    p = synthetic_bal(ncams=8, npnts=120, obs_per_pnt=4, noise_px=1.0,
                      perturb=2e-2, seed=5, dtype=torch.float32,
                      device="cpu")[0]
    path = tmp_path / "trace.json"
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = levenberg_marquardt_jit(p, use_dense=True, max_iters=6,
                                      atol=0.0, rtol=0.0, satol=0.0,
                                      srtol=0.0, oatol=0.0, ortol=0.0)
    reads = profiling.COUNTERS["host_reads"]
    prof.export_chrome_trace(str(path))
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in
             json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("ba.")]
    it = int(res.iterations)
    assert it == 6
    counts = Counter(n for _, _, n in spans)
    assert counts["ba.dense.assemble"] == counts["ba.dense.factor"] == it
    assert counts["ba.pcg"] == it and counts["ba.plan.pairs"] == 2
    pcg = [sp for sp in spans if sp[2] == "ba.pcg"]
    for s, e, name in spans:
        if name.startswith("ba.dense."):
            assert any(a <= s and e <= b for a, b, _ in pcg)
    assert reads == expected_host_reads(it, int(res.naccepts), res.hist_cg,
                                        100, "dense") + 2
