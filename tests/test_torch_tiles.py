"""The launch plans of the row-reduction kernels
(`bundleadjustment_jl_tpu_torch/ops/plans.py`), on the CPU: K2's camera
direction (tiles), K5's point direction, K6's point product and K1's point
pass (point ranges), K5's camera direction and K6's W C W' (column
ranges), K8's camera-order row copies; K1's camera pass, a block per
camera; and K4's blocks of rows a scale.

The CUDA kernels (``csrc/cam_prod.cuh``, ``csrc/wtv_point.cuh``,
``csrc/seg_block_reduce.cu``, ``csrc/seg_prod_reduce.cu``,
``csrc/linearize.cu``, ``csrc/assemble.cu``, ``csrc/objective.cu``) run
only on a card; here each plan is checked for the properties the kernels
rely on, and the kernels' walks are written out in torch ops over the plan
(the same reads, in the same roles) and held to the JAX package's kernels
(`cam_scatter_reduce`, `wt_cam_reduce`, `wcw_cam_reduce`, `jtj_pnt_reduce`,
`linearize_w_only`, `assemble_scatter`, `objective_scatter`; Pallas
interpret mode, as its own tests run them) and to the port's plain twins.
Small tiles, ranges and chunks, so every edge is hit.

Tolerances: f32 against the JAX kernel, rtol 1e-4 with atol 1e-5 of the
largest entry (f32 sums in another order; K1 against the JAX assembly:
`tests/test_torch_kernels.py`'s, which allows the two packages' f32 chains
to round differently); f64 against the f64 plain twin, rtol 1e-12 (the same
sums in another order); f64 against the JAX kernel's f32 output, the f32
tolerance.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal as jax_synthetic
from bundleadjustment_jl_tpu.ops import (
    pallas_assemble, pallas_linearize, pallas_schur)
from bundleadjustment_jl_tpu.ops.normal import assemble_blocks as jax_assemble
from bundleadjustment_jl_tpu.ops.pallas_schur import (
    cam_scatter_reduce, gather_k_minor, pad_rows, tile_bounds)
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem
from bundleadjustment_jl_tpu_torch.ops import chain
from bundleadjustment_jl_tpu_torch.ops import fused_assemble as fa
from bundleadjustment_jl_tpu_torch.ops import fused_schur as fs
from bundleadjustment_jl_tpu_torch.ops import linearize as lz
from bundleadjustment_jl_tpu_torch.ops import plans
from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
from bundleadjustment_jl_tpu_torch.ops.chain import linearize

# One intra-op thread: xdist runs test files side by side, one worker a
# core or so, and torch's default pool (a thread a core in every worker)
# oversubscribes the cores.
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "bundleadjustment_jl_tpu_torch" \
    / "csrc"


def problem_of(cam_idx, pnt_idx, ncams, npnts, pad_obs_to=8):
    """A CPU float32 problem with the given observations (state random)."""
    rng = np.random.default_rng(0)
    m = len(cam_idx)
    return BAProblem.from_arrays(
        rng.standard_normal((ncams, 9)), rng.standard_normal((npnts, 3)),
        np.asarray(cam_idx), np.asarray(pnt_idx),
        rng.standard_normal((m, 2)), dtype=torch.float32,
        pad_obs_to=pad_obs_to, device="cpu")


def random_problem(seed, ncams, npnts, obs, pad_obs_to=8):
    rng = np.random.default_rng(seed)
    pnt = np.repeat(np.arange(npnts), obs)
    cam = rng.integers(0, ncams, size=pnt.size)
    return problem_of(cam, pnt, ncams, npnts, pad_obs_to)


# Observation layouts, each with the edge it puts in front of the plan.
CASES = {
    "random": lambda: random_problem(1, ncams=7, npnts=40, obs=3),
    # cameras 0, 3 and 5 see nothing
    "empty_cameras": lambda: problem_of(
        [1, 2, 4, 6, 1, 6, 2, 4, 6, 1], [0, 0, 1, 1, 2, 3, 3, 4, 5, 5], 7, 6),
    # nobs_pad = 13, not a multiple of the tile
    "ragged_tail": lambda: random_problem(2, ncams=4, npnts=6, obs=2,
                                          pad_obs_to=13),
    # camera 1's rows all lie in tile 0; camera 0 sees every point, so its
    # rows spread over every tile
    "one_tile_and_many": lambda: problem_of(
        [0, 1, 0, 1, 0] + [0, 2] * 20,
        [0, 0, 1, 1, 2] + list(np.repeat(np.arange(3, 23), 2)), 3, 23),
    # one camera holds every row (no padding)
    "one_camera": lambda: problem_of([1] * 32, list(np.arange(32) // 4), 3,
                                     8),
    # a point of 21 rows (cut into three tiles) among points of 1-3 rows,
    # points without rows, and 10 rows of padding on the last point
    "long_point": lambda: problem_of(
        list(np.arange(31) % 5), [0, 0, 1] + [3] * 21 + [4, 4, 6, 7, 7, 7, 8],
        5, 9, pad_obs_to=41),
}
R = 8
SHORT = 2


def runs_of(plan, lo=0, hi=None):
    """(camera, tile, rows) of each run of tiles [lo, hi), read as the
    kernels read the plan: a tile's runs at tile_run_starts, each run's
    end in the tile's stretch of tile_rows, its rows as offsets from the
    tile's first row."""
    tb, trs = plan.tile_bounds.tolist(), plan.tile_run_starts.tolist()
    ends, rows = plan.run_ends.tolist(), plan.tile_rows.tolist()
    cams = plan.run_cam.tolist()
    out = []
    for t in range(lo, plan.ntiles if hi is None else hi):
        q = 0
        for s in range(trs[t], trs[t + 1]):
            out.append((cams[s], t, [tb[t] + r for r in
                                     rows[tb[t] + q:tb[t] + ends[s]]]))
            q = ends[s]
    return out


@pytest.mark.parametrize("case", CASES)
def test_tile_plan_runs_partition_cam_perm(case):
    """Every row lies in exactly one run; a run is one camera's rows of one
    tile, in row order; a tile has one run a camera, in camera order;
    taken camera by camera (tiles in order), the runs' rows are cam_perm;
    no run is empty."""
    p = CASES[case]()
    plan = plans.build_tile_plan(p, rows=R, short=SHORT)
    runs = runs_of(plan)
    cam, tb = p.cam_idx.tolist(), plan.tile_bounds.tolist()
    assert plan.nruns == len(runs)
    for c, t, rows in runs:
        assert rows and rows == sorted(rows)
        assert all(cam[r] == c and tb[t] <= r < tb[t + 1] for r in rows)
    assert sorted(r for _, _, rows in runs for r in rows) \
        == list(range(p.nobs_pad))
    per_tile = {}
    for c, t, _ in runs:
        per_tile.setdefault(t, []).append(c)
    assert all(cs == sorted(set(cs)) for cs in per_tile.values())
    by_cam = sorted(runs, key=lambda run: (run[0], run[1]))
    assert [r for _, _, rows in by_cam for r in rows] == p.cam_perm.tolist()
    with_rows = {c for c, _, _ in runs}
    if case == "empty_cameras":
        assert sorted(set(range(p.ncams)) - with_rows) == [0, 3, 5]
    if case == "one_tile_and_many":
        assert {t for c, t, _ in runs if c == 1} == {0}
        assert sum(c == 0 for c, _, _ in runs) == plan.ntiles > 4
    if case == "one_camera":
        assert plan.nruns == plan.ntiles


@pytest.mark.parametrize("short", [1, SHORT, R // 2])
@pytest.mark.parametrize("case", CASES)
def test_tile_plan_tile_order(case, short):
    """The tiles cover the rows in order, each of at most C rows; a bound
    lies at a point's start, but inside a point of more than C rows, which
    is cut every C rows from its start; a point of more than ``short`` rows
    has tiles of its own; each tile's stretch of tile_rows is a permutation
    of its offsets; tile t owns the points from its first row's point to
    the next tile's (all points, one owner each)."""
    p = CASES[case]()
    plan = plans.build_tile_plan(p, rows=R, short=short)
    n, ps = p.nobs_pad, p.pnt_starts.tolist()
    pidx, tb = p.pnt_idx.tolist(), plan.tile_bounds.tolist()
    assert tb[0] == 0 and tb[-1] == n
    assert all(0 < b - a <= R for a, b in zip(tb, tb[1:]))
    rows = plan.tile_rows.tolist()
    for t in range(plan.ntiles):
        assert sorted(rows[tb[t]:tb[t + 1]]) == list(range(tb[t + 1] - tb[t]))
    for b in tb[1:-1]:
        q = pidx[b]
        seg = ps[q + 1] - ps[q]
        assert b == ps[q] or (seg > R and (b - ps[q]) % R == 0)
    for q in range(p.npnts):
        if ps[q + 1] - ps[q] > short:
            assert ps[q] in tb and ps[q + 1] in tb
    tp = plan.tile_pnts.tolist()
    assert tp[0] == 0 and tp[-1] == p.npnts
    assert tp == sorted(tp)
    assert all(tp[t] == pidx[tb[t]] for t in range(1, plan.ntiles))
    if case == "long_point":
        assert max(ps[q + 1] - ps[q] for q in range(p.npnts)) > 2 * R
        assert n - ps[-2] > R      # the padding tail, on the last point
    if case == "random" and short == 1:
        # points of 3 rows, each its own tile: no tile holds two
        assert plan.ntiles == p.npnts


@pytest.mark.parametrize("case", CASES)
def test_visits_walk_every_tile(case):
    """K3's visits: a tile outside a point of more than C rows once (point
    and camera pass; a block may start there); the tiles of such a point
    twice, every point pass before every camera pass, a block starting only
    at the first; so a point's t is formed (by the tile that owns it)
    before any camera pass reads it."""
    p = CASES[case]()
    plan = plans.build_tile_plan(p, rows=R, short=SHORT)
    ps, pidx = p.pnt_starts.tolist(), p.pnt_idx.tolist()
    tb, tp = plan.tile_bounds.tolist(), plan.tile_pnts.tolist()
    codes = plan.visits.tolist()
    count = {}
    formed = set()
    for i, code in enumerate(codes):
        t, flags = code >> 3, code & 7
        count[t, flags & 3] = count.get((t, flags & 3), 0) + 1
        grouped = ps[pidx[tb[t]] + 1] - ps[pidx[tb[t]]] > R
        if not grouped:
            assert flags == plans.VISIT_POINT | plans.VISIT_CAMERA \
                | plans.VISIT_START
        elif flags & plans.VISIT_START:
            assert flags == plans.VISIT_POINT | plans.VISIT_START
            assert tb[t] == ps[pidx[tb[t]]]
        if flags & plans.VISIT_POINT:
            formed.update(range(tp[t], tp[t + 1]))
        if flags & plans.VISIT_CAMERA:
            assert {pidx[r] for r in range(tb[t], tb[t + 1])} <= formed
    assert formed == set(range(p.npnts))
    assert all(count.get((t, 3), 0) + count.get((t, 1), 0) == 1
               for t in range(plan.ntiles))
    assert len(codes) == plan.ntiles + sum(
        c for (_, f), c in count.items() if f == plans.VISIT_CAMERA)
    if case == "long_point":
        assert any(f == plans.VISIT_CAMERA for _, f in count)


def test_cam_pass_path_picks_by_budget(monkeypatch):
    """Shared accumulators while the (ncams, K) floats fit beside the
    stages in the block's budget (a 9-sum form's only when they leave room
    for a second block on an SM or the per-run sums would not); past it,
    per-run sums for a 9-sum form, records (no blocks) for a 45- or 54-sum
    form. The blocks: CAM_BLOCKS times the blocks an SM holds (its shared
    memory, 1 KB a block reserved, at most BLOCKS_PER_SM). SMEM_BUDGET,
    when set, takes the card's limit's place."""
    G = plans.CAM_BLOCKS
    monkeypatch.setattr(plans, "SM_SMEM", 100_000)
    monkeypatch.setattr(plans, "BLOCKS_PER_SM", {9: 4})
    runs = plans.TILE_ROWS * 36    # a tile's run sums
    # 1000 + 100 * 36 = 4600 B a block: at most 4 of them an SM
    assert plans.cam_pass_path(100, 9, 1000, 4600) == ("smem", 4 * G)
    assert plans.cam_pass_path(101, 9, 1000, 4600) == ("runs", 4 * G)
    assert plans.cam_pass_path(100, 9, 40_000, 10 ** 6) == ("smem", 2 * G)
    assert plans.cam_pass_path(13682, 9, 60_000, 200_000) == ("runs", G)
    # alone on an SM with its sums in shared memory, two with per-run sums
    assert 100_000 // (30_000 + runs + 1024) == 2
    assert plans.cam_pass_path(1500, 9, 30_000, 10 ** 6) == ("runs", 2 * G)
    # alone either way: the shared sums
    assert plans.cam_pass_path(100, 9, 90_000, 10 ** 6) == ("smem", G)
    assert plans.cam_pass_path(356, 54, 100, 100 + 356 * 216) == ("smem", G)
    assert plans.cam_pass_path(357, 54, 100, 100 + 356 * 216) \
        == ("records", 0)
    monkeypatch.setattr(plans, "SMEM_BUDGET", 100 + 357 * 216)
    assert plans.cam_pass_path(357, 54, 100, 100) == ("smem", G)


def test_tile_plan_refuses_unsorted_cam_perm():
    p = CASES["random"]()
    perm = p.cam_perm.clone()
    c = int(torch.argmax(p.cam_starts[1:] - p.cam_starts[:-1]))
    j = int(p.cam_starts[c])
    perm[j], perm[j + 1] = int(perm[j + 1]), int(perm[j])
    p.cam_perm = perm
    with pytest.raises(ValueError, match="ascending"):
        plans.build_tile_plan(p, rows=R)


def test_tile_plan_kept_on_the_problem():
    """Built once per problem, at the first call, with the kernels' C."""
    p = CASES["random"]()
    assert "tiles" not in p.plans
    first = plans.tile_plan(p)
    assert first.rows == plans.TILE_ROWS and plans.tile_plan(p) is first
    blocks = plans.point_blocks(p)
    assert plans.point_blocks(p) is blocks


def constant(name, source):
    return int(re.search(rf"{name} = (\d+);", (CSRC / source).read_text())[1])


def test_plan_sizes_match_the_kernels():
    """The Python plans' sizes are the CUDA sources' constants: K2's tile
    (the kernel refuses another); K5's chunk and K1's point chunk, which
    hold a block of POINT_BLOCK_ROWS rows with room for its last point;
    K5's camera range, a multiple of the columns a thread takes and at
    most the kernel's largest (it refuses others); K6 pnt12's chunk, as
    K1's; K4's row blocks, whole rows a thread."""
    assert constant("BA_TILE_ROWS", "cam_pass.cuh") == plans.TILE_ROWS
    assert plans.TILE_ROWS < 1 << 15    # the plan's 16-bit offsets
    assert 1 <= plans.TILE_SHORT <= plans.TILE_ROWS // 2
    for name, value in plans.PATHS.items():
        assert constant(f"BA_PATH_{name.upper()}", "cam_pass.cuh") == value
    for name in ("POINT", "CAMERA", "START"):
        assert constant(f"BA_VISIT_{name}", "cam_pass.cuh") \
            == getattr(plans, f"VISIT_{name}")
    block = constant("BA_BLOCK", "chain.cuh")
    for name, source in (("BA_PNT_ROWS_PER_THREAD", "wtv_point.cuh"),
                         ("BA_ASM_ROWS_PER_THREAD", "assemble.cu"),
                         ("BA_PNT12_ROWS_PER_THREAD", "seg_prod_reduce.cu")):
        assert constant(name, source) * block >= plans.POINT_BLOCK_ROWS + 256
    align = constant("BA_CAM_COL_ALIGN", "cam_cols.cuh")
    # a thread's columns: BA_CAM_LOAD_BYTES of a 2-byte W at most
    assert align % (constant("BA_CAM_LOAD_BYTES", "cam_cols.cuh") // 2) == 0
    for cols in (plans.CAM_BLOCK_COLS, plans.WCW_BLOCK_COLS):
        assert align % 4 == 0 and cols % align == 0
        assert cols <= constant("BA_CAM_COLS_MAX", "cam_cols.cuh")
    # K6 W C W': columns a lane, whole words of a 2-byte W's planes and a
    # divisor of the column alignment
    lane_cols = constant("BA_WCW_COLS", "seg_prod_reduce.cu")
    assert lane_cols in (2, 4) and align % lane_cols == 0
    assert constant("BA_OBJ_ROWS", "objective.cu") % block == 0


# --------------------------------------------- K2 and K3: the camera pass
def block_spans(count, blocks):
    """Block g's span [count g / G, count (g+1) / G) (csrc/cam_pass.cuh
    ba_span)."""
    return [(count * g // blocks, count * (g + 1) // blocks)
            for g in range(blocks)]


def block_walk(row_vals, plan, ncams, blocks):
    """K2's per-block sums in torch ops over the plan: block g of
    ``blocks`` adds each run of its span of tiles (rows read at
    tile_bounds + tile_rows) to its own row of the run's camera; pass 2
    sums each camera's rows over the blocks in block order."""
    K = row_vals.shape[1]
    slices = torch.zeros((blocks, ncams, K), dtype=row_vals.dtype)
    for g, (lo, hi) in enumerate(block_spans(plan.ntiles, blocks)):
        for c, _, rows in runs_of(plan, lo, hi):
            slices[g, c] += row_vals[rows].sum(0)
    out = torch.zeros((ncams, K), dtype=row_vals.dtype)
    for g in range(blocks):
        out += slices[g]
    return out


def row_products(product, W, JR, C, op, pnt):
    """Per-row products (rows in the order given) of ``product`` from the
    rows' W (27, m) or JR (26, m) and their points ``pnt``."""
    return {"w_op": lambda: sr.w_op_rows(W, op, pnt),
            "wcw": lambda: sr.wcw_rows(W, C, pnt),
            "wcw_rhs": lambda: torch.cat([sr.wcw_rows(W, C, pnt),
                                          sr.w_op_rows(W, op, pnt)], dim=1),
            "cam90": lambda: sr.jtj_cam_rows(JR)}[product]()


def runs_walk(row_vals, plan, ncams):
    """K2's per-run sums in torch ops: pass 1 sums each run of each tile
    (in tile order) into its row of the partials; pass 2 sums each camera's
    runs cam_runs[cam_run_starts[c]:cam_run_starts[c+1]] in that order."""
    runs = runs_of(plan)
    partial = torch.stack([row_vals[rows].sum(0) for _, _, rows in runs])
    cr, crs = plan.cam_runs.tolist(), plan.cam_run_starts.tolist()
    out = torch.zeros((ncams, row_vals.shape[1]), dtype=row_vals.dtype)
    for c in range(ncams):
        assert all(runs[s][0] == c for s in cr[crs[c]:crs[c + 1]])
        for s in cr[crs[c]:crs[c + 1]]:
            out[c] += partial[s]
    return out


def record_walk(problem, product, W, JR, C, op):
    """K2's records in torch ops: pass 1 writes each row's planes and point
    as its record, in row order; pass 2 sums each camera's rows
    cam_perm[j], j in [cam_starts[c], cam_starts[c+1]), read at their
    records, the products taken at the record's point."""
    perm = problem.cam_perm.long()
    vals = row_products(product, W[:, perm], JR[:, perm], C, op,
                        problem.pnt_idx.long()[perm])
    cs = problem.cam_starts.tolist()
    return torch.stack([vals[cs[c]:cs[c + 1]].sum(0)
                        for c in range(problem.ncams)])


def matvec_walk(problem, plan, W, v, hpp, gp, sign, blocks, runs=False):
    """K3 in torch ops over the plan's visits: block g walks the visits of
    its span from the first VISIT_START at or after nvisits g / G; a point
    pass sums each owned point's rows (W' v[cam]) in row order, a long
    point's carried over its tiles, and folds t_p; a camera pass adds each
    run's W t to the block's row of its camera (``runs``: to the run's own
    row, each camera's runs summed in cam_runs order after). Returns (out,
    t)."""
    n, ncams = problem.nobs_pad, problem.ncams
    ps, pidx = problem.pnt_starts.tolist(), problem.pnt_idx.long()
    cam = problem.cam_idx.long()
    y = torch.einsum("abr,ra->rb", W.reshape(9, 3, n), v[cam])
    H = hpp.reshape(-1, 3, 3)
    g_all = torch.zeros((problem.npnts, 3), dtype=W.dtype) if gp is None \
        else gp.reshape(-1, 3)
    t = torch.full((problem.npnts, 3), float("nan"), dtype=W.dtype)
    slices = torch.zeros((blocks, ncams, 9), dtype=W.dtype)
    partial = torch.zeros((plan.nruns, 9), dtype=W.dtype)
    codes, tb, tp = (plan.visits.tolist(), plan.tile_bounds.tolist(),
                     plan.tile_pnts.tolist())
    trs = plan.tile_run_starts.tolist()

    def start_at(j):
        while j < len(codes) and not codes[j] & plans.VISIT_START:
            j += 1
        return j
    for g, (lo, hi) in enumerate(block_spans(len(codes), blocks)):
        carry = torch.zeros(3, dtype=W.dtype)
        for code in codes[start_at(lo):start_at(hi)]:
            k, flags = code >> 3, code & 7
            r0, r1 = tb[k], tb[k + 1]
            if flags & plans.VISIT_POINT:
                for j, q in enumerate(range(tp[k], tp[k + 1])):
                    s = carry.clone() if j == 0 and ps[q] < r0 \
                        else torch.zeros(3, dtype=W.dtype)
                    for r in range(max(ps[q], r0), ps[q + 1]):
                        s += y[r]
                    t[q] = sign * H[q] @ (s + g_all[q])
                if tp[k] == tp[k + 1]:
                    if flags & plans.VISIT_START:
                        carry = torch.zeros(3, dtype=W.dtype)
                    carry = carry + y[r0:r1].sum(0)
            if flags & plans.VISIT_CAMERA:
                for s_run, (c, _, rows) in enumerate(runs_of(plan, k, k + 1),
                                                     trs[k]):
                    assert not torch.isnan(t[pidx[rows]]).any()
                    sums = sr.w_op_rows(W[:, rows], t, pidx[rows]).sum(0)
                    if runs:
                        partial[s_run] = sums
                    else:
                        slices[g, c] += sums
    if not runs:
        return slices.sum(0), t
    cr, crs = plan.cam_runs.tolist(), plan.cam_run_starts.tolist()
    out = torch.zeros((ncams, 9), dtype=W.dtype)
    for c in range(ncams):
        for s_run in cr[crs[c]:crs[c + 1]]:
            out[c] += partial[s_run]
    return out, t


def jax_problem(ncams, seed):
    """A JAX problem (f32, 300 points of 4 rows, padded to 1280 rows: a
    padding tail of 80 rows on the last point) and its port, and random
    operands from seed 0: W (zero on the padding), JR, an SPD C, op, v, g_p."""
    jp, _ = jax_synthetic(ncams=ncams, npnts=300, obs_per_pnt=4, seed=seed,
                          dtype=jnp.float32, noise_px=1.0, perturb=2e-2,
                          pad_obs_to=1280)
    tp = BAProblem.from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in BAProblem.FIELDS},
        device="cpu")
    rng = np.random.default_rng(0)
    W = rng.standard_normal((27, jp.nobs_pad)).astype(np.float32)
    W[:, jp.nobs:] = 0.0
    JR = rng.standard_normal((26, jp.nobs_pad)).astype(np.float32)
    A = rng.standard_normal((jp.npnts, 3, 3)).astype(np.float32)
    C = (A @ np.swapaxes(A, 1, 2) + 3.0 * np.eye(3, dtype=np.float32))
    op = rng.standard_normal((jp.npnts, 3)).astype(np.float32)
    v = rng.standard_normal((jp.ncams, 9)).astype(np.float32)
    gp = rng.standard_normal(jp.npnts * 3).astype(np.float32)
    return jp, tp, dict(W=W, JR=JR, C=C.reshape(-1), op=op, v=v, gp=gp)


@pytest.fixture(scope="module")
def jprob():
    return jax_problem(ncams=9, seed=11)


@pytest.fixture(scope="module")
def jprob_many():
    """More cameras (700) than a tile has rows: about a run a row, and
    cameras without rows."""
    jp, tp, ops = jax_problem(ncams=700, seed=12)
    seen = np.bincount(np.asarray(jp.cam_idx)[:jp.nobs], minlength=700)
    assert (seen == 0).sum() > 0
    return jp, tp, ops


def jax_cam_reduce(jp, ops, product):
    """`cam_scatter_reduce` with the JAX package's product, interpreted."""
    W_t = pad_rows(jnp.asarray(ops["W"]), 32)
    bounds = tile_bounds(jp.pnt_starts, jp.npnts)
    kw = dict(idx_row=jp.pnt_idx, interpret=True)
    C = jnp.asarray(ops["C"])
    h6 = C.reshape(-1, 9)[:, jnp.array([0, 1, 2, 4, 5, 8])]
    op_t = jnp.asarray(ops["op"]).T
    if product == "w_op":
        return cam_scatter_reduce(W_t, jp.cam_idx, bounds, jp.ncams, d_out=9,
                                  prod=pallas_schur._prod_w_op,
                                  op_t=pad_rows(op_t, 8), **kw)
    if product == "wcw":
        return cam_scatter_reduce(W_t, jp.cam_idx, bounds, jp.ncams,
                                  d_out=81, prod=pallas_schur._prod_wcw,
                                  op_t=pad_rows(h6.T, 8), **kw)
    if product == "wcw_rhs":
        op16 = pad_rows(jnp.concatenate([h6.T, op_t], axis=0), 16)
        return cam_scatter_reduce(W_t, jp.cam_idx, bounds, jp.ncams,
                                  d_out=90, prod=pallas_schur._prod_wcw_rhs,
                                  op_t=op16, **kw)
    JR = pad_rows(jnp.asarray(ops["JR"]), 32)
    return cam_scatter_reduce(JR, jp.cam_idx, bounds, jp.ncams, d_out=90,
                              prod=pallas_schur._prod_cam90, interpret=True)


def jax_matvec(jp, ops, form):
    """`matvec_cam_scatter` (``form`` "matvec" or "back_substitution"),
    interpreted: (out, t (npnts, 3))."""
    old = (pallas_schur.PALLAS_MODE, pallas_schur.INTERPRET,
           pallas_schur.CAM_SCATTER)
    try:
        pallas_schur.set_mode(True)
        pallas_schur.INTERPRET = True
        pallas_schur.CAM_SCATTER = True
        kw = dict(gp_f=jnp.asarray(ops["gp"]), sign=-1.0) \
            if form == "back_substitution" else {}
        out, dp = pallas_schur.matvec_cam_scatter(
            pad_rows(jnp.asarray(ops["W"]), 32), jnp.asarray(ops["v"]),
            jp.cam_idx, jp.pnt_idx, jnp.asarray(ops["C"]),
            tile_bounds(jp.pnt_starts, jp.npnts), jp.ncams, jp.npnts,
            with_dp=True, **kw)
    finally:
        (pallas_schur.PALLAS_MODE, pallas_schur.INTERPRET,
         pallas_schur.CAM_SCATTER) = old
    return np.asarray(out), np.asarray(dp)[:3, :jp.npnts].T


@pytest.fixture(scope="module")
def jax_refs(jprob, jprob_many):
    """The JAX kernels' outputs per (problem, product), computed once."""
    probs = {"few": jprob, "many": jprob_many}
    cache = {}

    def get(which, product):
        if (which, product) not in cache:
            jp, _, ops = probs[which]
            cache[which, product] = (
                jax_matvec(jp, ops, product) if product in MATVEC_FORMS
                else np.asarray(jax_cam_reduce(jp, ops, product)))
        return cache[which, product]
    return get


MATVEC_FORMS = ("matvec", "back_substitution")


def port_operands(ops, dtype):
    return {k: torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
            for k, x in ops.items()}


def port_rows_and_plain(tp, ops, product, dtype):
    """Per-row products (n, d_out) in point order, and the plain twin."""
    o = port_operands(ops, dtype)
    W, JR, C, op = o["W"], o["JR"], o["C"], o["op"]
    rows = row_products(product, W, JR, C, op, tp.pnt_idx.long())
    plain = {"w_op": lambda: fs.cam_reduce_w_op(W, tp, op),
             "wcw": lambda: fs.cam_reduce_wcw(W, tp, C),
             "wcw_rhs": lambda: fs.cam_reduce_wcw_rhs(W, tp, C, op),
             "cam90": lambda: fs.cam_reduce_cam90(JR, tp)}[product]()
    return rows, plain


def close32(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def close_twin(got, plain, dtype):
    """f64 against the f64 plain twin at 1e-12 (the same sums in another
    order); f32 at the f32 tolerance."""
    if dtype == torch.float64:
        torch.testing.assert_close(got, plain, rtol=1e-12, atol=1e-12)
    else:
        close32(got, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("rows", [8, 64, plans.TILE_ROWS])
@pytest.mark.parametrize("product", ["w_op", "wcw", "wcw_rhs", "cam90"])
def test_two_pass_sum_matches_pallas_and_plain(jprob, jax_refs, product,
                                                rows, dtype):
    """K2's per-block sums (pass 1 a block's own camera rows, pass 2 the
    blocks summed in order) over the plan at each tile size, for each
    product, with the kernels' CAM_BLOCKS blocks (more than the tiles at the
    larger sizes: blocks without tiles), against the JAX
    `cam_scatter_reduce` and the port's plain twin."""
    _, tp, ops = jprob
    plan = plans.build_tile_plan(tp, rows=rows)
    row_vals, plain = port_rows_and_plain(tp, ops, product, dtype)
    got = block_walk(row_vals, plan, tp.ncams, plans.CAM_BLOCKS)
    close32(got, jax_refs("few", product))
    close_twin(got, plain, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("budget", ["smem", "past_smem"])
@pytest.mark.parametrize("product", ["w_op", "wcw", "wcw_rhs", "cam90"])
def test_camera_pass_at_many_cameras_matches_pallas_and_plain(
        jprob_many, jax_refs, monkeypatch, product, budget, dtype):
    """K2 with more cameras than a tile has rows (about a run a row,
    cameras without rows, the padding tail on the last point), on the path
    ``plans.cam_pass_path`` picks under the injected budget (shared memory
    for all the sums, or none: per-run sums for W op, records for the
    others), against the JAX kernel and the plain twin."""
    _, tp, ops = jprob_many
    k = fs.FORMS[product][1]
    monkeypatch.setattr(plans, "SMEM_BUDGET",
                        10 ** 9 if budget == "smem" else 0)
    path, blocks = plans.cam_pass_path(tp.ncams, k, 0, 0)
    assert path == ("smem" if budget == "smem" else
                    "runs" if k == 9 else "records")
    plan = plans.build_tile_plan(tp, rows=64)
    tp.plans["tiles"] = plan
    row_vals, plain = port_rows_and_plain(tp, ops, product, dtype)
    assert plan.nruns > 0.8 * tp.nobs_pad
    o = port_operands(ops, dtype)
    if path == "records":
        got = record_walk(tp, product, o["W"], o["JR"], o["C"], o["op"])
    elif path == "runs":
        got = runs_walk(row_vals, plan, tp.ncams)
    else:
        assert blocks % plans.CAM_BLOCKS == 0
        got = block_walk(row_vals, plan, tp.ncams, blocks)
    close32(got, jax_refs("many", product))
    close_twin(got, plain, dtype)
    empty = (tp.cam_starts[1:] == tp.cam_starts[:-1]).nonzero().flatten()
    assert empty.numel() > 0 and not bool(got[empty].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("product", ["w_op", "wcw", "wcw_rhs", "cam90"])
def test_record_walk_matches_pallas_and_plain(jprob, jax_refs, product,
                                              dtype):
    """K2's records (each row's planes and point written as a record, then
    each camera's records reduced) and its per-run sums at few cameras,
    against the JAX kernel and the plain twin."""
    _, tp, ops = jprob
    o = port_operands(ops, dtype)
    row_vals, plain = port_rows_and_plain(tp, ops, product, dtype)
    for got in (record_walk(tp, product, o["W"], o["JR"], o["C"], o["op"]),
                runs_walk(row_vals, plans.build_tile_plan(tp, rows=64),
                          tp.ncams)):
        close32(got, jax_refs("few", product))
        close_twin(got, plain, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("blocks", [1, 7, plans.CAM_BLOCKS, "runs"])
@pytest.mark.parametrize("form", MATVEC_FORMS)
@pytest.mark.parametrize("which", ["few", "many"])
def test_fused_matvec_walk_matches_pallas_and_plain(
        jprob, jprob_many, jax_refs, which, form, blocks, dtype):
    """K3 in one walk over the plan's visits (each tile's point pass, then
    its camera pass; the padding tail's long point cut into three tiles,
    its point passes first), with 1, 7 and CAM_BLOCKS blocks (a span
    starts at a VISIT_START), and with per-run sums summed by camera,
    against the JAX `matvec_cam_scatter` (out and t) and the plain twin."""
    _, tp, ops = jprob if which == "few" else jprob_many
    plan = plans.build_tile_plan(tp, rows=32)
    assert int((plan.visits & 3 == plans.VISIT_CAMERA).sum()) == 3
    o = port_operands(ops, dtype)
    gp, sign = (o["gp"], -1.0) if form == "back_substitution" else (None, 1.0)
    runs = blocks == "runs"
    out, t = matvec_walk(tp, plan, o["W"], o["v"], o["C"], gp, sign,
                         plans.CAM_BLOCKS if runs else blocks, runs)
    ref_out, ref_t = jax_refs(which, form)
    close32(out, ref_out)
    close32(t, ref_t)
    p_out, p_t = fs._matvec_cam_scatter_plain(o["W"], o["v"], tp, o["C"],
                                              gp, sign, with_dp=True)
    close_twin(out, p_out, dtype)
    close_twin(t, p_t, dtype)


# ------------------------------------------------------- K5: point ranges
def point_walk(y, problem, bounds, chunk):
    """The point walk of K5 and K1 (csrc/wtv_point.cuh ba_point_walk) in
    Python over per-row values ``y`` (n, D): each block's rows in chunks;
    points that end in a chunk are summed in row order, the point that runs
    past it carries its sum. Returns the sums and how often each point was
    written."""
    ps, pidx = problem.pnt_starts.tolist(), problem.pnt_idx.tolist()
    out = torch.zeros((problem.npnts, y.shape[1]), dtype=y.dtype)
    written = [0] * problem.npnts
    bounds = bounds.tolist()
    for b in range(len(bounds) - 1):
        p_next, p_end = bounds[b], bounds[b + 1]
        carried, carry = False, torch.zeros(y.shape[1], dtype=y.dtype)
        r1 = ps[p_end]
        c0 = ps[p_next]
        while True:
            c1 = min(c0 + chunk, r1)
            last = c1 == r1
            p_fin = p_end if last else pidx[c1]
            for p in range(p_next, p_fin):
                s = carry.clone() if carried and p == p_next \
                    else torch.zeros(y.shape[1], dtype=y.dtype)
                for row in range(max(ps[p], c0), ps[p + 1]):
                    s += y[row]
                out[p] = s
                written[p] += 1
            if last:
                break
            if ps[p_fin] < c1:
                s = carry.clone() if carried and p_fin == p_next \
                    else torch.zeros(y.shape[1], dtype=y.dtype)
                for row in range(max(ps[p_fin], c0), c1):
                    s += y[row]
                carry, carried = s, True
            else:
                carried = False
            p_next = p_fin
            c0 += chunk
    return out, written


# Layouts for K5: a long point (more rows than a chunk) mid-range, points
# without rows, and the padding tail on the last point.
K5_CASES = {
    "random": lambda: random_problem(3, ncams=5, npnts=60, obs=3,
                                     pad_obs_to=64),
    "long_and_empty": lambda: problem_of(
        list(np.arange(50) % 4) + [1, 2, 3, 0, 1] + list(np.arange(30) % 4),
        [0, 0, 2] + [3] * 45 + [4, 4] + [7] * 5 + list(8 + np.arange(30) // 3),
        4, 20, pad_obs_to=40),
}


@pytest.mark.parametrize("case", K5_CASES)
@pytest.mark.parametrize("rows", [4, 16, plans.POINT_BLOCK_ROWS])
def test_point_blocks_cover_and_balance(case, rows):
    """Every point lies in exactly one block; a block holds at most
    ``rows`` rows plus the rows of its last point; blocks are not
    empty of points."""
    p = K5_CASES[case]()
    bounds = plans.build_point_blocks(p, rows=rows).long()
    assert int(bounds[0]) == 0 and int(bounds[-1]) == p.npnts
    assert bool((bounds[1:] > bounds[:-1]).all())
    ps = p.pnt_starts.long()
    seg = ps[1:] - ps[:-1]
    for b in range(bounds.shape[0] - 1):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        assert int(ps[hi] - ps[lo]) <= rows + int(seg[hi - 1])
    if rows == 4 and case == "long_and_empty":
        assert int(seg.max()) > 8      # a point longer than the chunk below


@pytest.mark.parametrize("case", K5_CASES)
@pytest.mark.parametrize("chunk", [8, 64])
@pytest.mark.parametrize("form", ["plain", "fold", "fold_add_sign"])
def test_point_walk_matches_plain(case, chunk, form):
    """The K5 walk over its plan (blocks of 4 rows, chunks of 8 or 64
    rows, so points cross chunks and blocks end mid-chunk) writes every
    point once and gives the plain twin's sums, in f64."""
    p = K5_CASES[case]()
    rng = np.random.default_rng(5)
    n, npt = p.nobs_pad, p.npnts
    W = torch.from_numpy(rng.standard_normal((27, n)))
    v = torch.from_numpy(rng.standard_normal((p.ncams, 9)))
    A = rng.standard_normal((npt, 3, 3))
    hpp = torch.from_numpy((A @ A.transpose(0, 2, 1)).reshape(-1))
    add = torch.from_numpy(rng.standard_normal(npt * 3))
    kw = {"plain": {}, "fold": dict(hpp_inv_f=hpp),
          "fold_add_sign": dict(hpp_inv_f=hpp, add_f=add, sign=-1.0)}[form]
    y = torch.einsum("nab,na->nb", sr.w_rows(W, v.dtype),
                     v[p.cam_idx.long()])
    s, written = point_walk(y, p, plans.build_point_blocks(p, rows=4), chunk)
    assert written == [1] * npt
    if "add_f" in kw:
        s = s + add.reshape(-1, 3)
    if "hpp_inv_f" in kw:
        s = torch.einsum("pab,pb->pa", hpp.reshape(-1, 3, 3), s)
    s = kw.get("sign", 1.0) * s
    torch.testing.assert_close(s, sr.wtv_point_reduce(W, v, p, **kw),
                               rtol=1e-12, atol=1e-12)


# ------------------------------------- K6 pnt12: the point walk over JR
UP3 = [(b, e) for b in range(3) for e in range(b, 3)]
SYM3 = [0, 1, 2, 1, 3, 4, 2, 4, 5]     # 3x3 entry -> its UP3 slot


def pnt12_rows(JR):
    """Each row's nine values in csrc/seg_prod_reduce.cu ba_jtj_pnt_kernel:
    [Jp'Jp upper (00, 01, 02, 11, 12, 22) | Jp'r] of a (26, n) JR ->
    (n, 9)."""
    Jp, r = JR[18:24], JR[24:26]
    return torch.stack([Jp[b] * Jp[e] + Jp[3 + b] * Jp[3 + e] for b, e in UP3]
                       + [Jp[b] * r[0] + Jp[3 + b] * r[1] for b in range(3)],
                       dim=1)


def hp12_of(s):
    """A point's nine sums -> its (12,) output: the symmetric 9, then the
    3 (the owner thread's store)."""
    return torch.cat([s[:, SYM3], s[:, 6:9]], dim=1)


@pytest.mark.parametrize("case", K5_CASES)
@pytest.mark.parametrize("chunk", [8, 64])
def test_point_walk_pnt12_matches_plain(case, chunk):
    """K6 pnt12's walk over K5's plan (blocks of 4 rows, chunks of 8 or 64
    rows: points cross chunks, points without rows) writes every point once
    and gives the plain twin's [Hpp | g_p], in f64."""
    p = K5_CASES[case]()
    JR = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (26, p.nobs_pad)))
    s, written = point_walk(pnt12_rows(JR), p,
                            plans.build_point_blocks(p, rows=4), chunk)
    assert written == [1] * p.npnts
    want = sr.jtj_pnt_reduce(JR, p)
    torch.testing.assert_close(hp12_of(s), want, rtol=1e-12, atol=1e-12)
    empty = p.pnt_starts[1:] == p.pnt_starts[:-1]
    assert not want[empty].any()
    if case == "long_and_empty":
        assert bool(empty.any())


def test_point_walk_pnt12_matches_pallas(jprob):
    """The walk in f32 at the kernel's point ranges and chunk, against the
    JAX `jtj_pnt_reduce` (`seg_prod_reduce` with `_prod_pnt12`, interpret
    mode) over the same JR."""
    jp, tp, ops = jprob
    ref = pallas_schur.jtj_pnt_reduce(pad_rows(jnp.asarray(ops["JR"]), 32),
                                      jp.pnt_idx, jp.pnt_starts, jp.npnts,
                                      interpret=True)
    chunk = 256 * constant("BA_PNT12_ROWS_PER_THREAD", "seg_prod_reduce.cu")
    s, written = point_walk(pnt12_rows(torch.from_numpy(ops["JR"])), tp,
                            plans.build_point_blocks(tp), chunk)
    assert written == [1] * tp.npnts
    close32(hp12_of(s), np.asarray(ref))


# ------------------------------------------- K4: blocks of rows a scale
def k4_row_pass(problem, cams_all, pts_all, rows, threads):
    """csrc/objective.cu's passes in torch ops: a block per ``rows`` rows
    and scale, each of its ``threads`` threads adding its rows' 1/2 |r|^2
    in turn (each row through `ops/chain.py:project_residual` at
    ``cams_all[s]``, ``pts_all[s]``); each block's sum in a fixed order
    written to partials[s * nblocks + b]; pass 2 adds a scale's partials
    in order. Returns (S,) objectives and how often each partial was
    written."""
    S, n = cams_all.shape[0], problem.nobs_pad
    ci, pi = problem.cam_idx.long(), problem.pnt_idx.long()
    nb = -(-n // rows)
    partials = torch.zeros(S * nb, dtype=cams_all.dtype)
    written = [0] * (S * nb)
    for s in range(S):
        res = chain.project_residual(cams_all[s][ci], pts_all[s][pi],
                                     problem.pt2d, problem.w)
        val = 0.5 * (res[:, 0] * res[:, 0] + res[:, 1] * res[:, 1])
        for b in range(nb):
            lo, hi = b * rows, min((b + 1) * rows, n)
            partials[s * nb + b] = block_sum(val[lo:hi, None], threads)[0]
            written[s * nb + b] += 1
    out = torch.stack([partials[s * nb:(s + 1) * nb].sum() for s in range(S)])
    return out, written


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_k4_row_pass_at_edge_rows(dtype):
    """K4's passes over rows at the chain's edges, at two scales: cameras
    with theta = 0 and theta^2 <= 1e-24 (the Taylor branch), a row on its
    camera's plane (z = 0) and a row of weight 0, both adding 0. Held to
    the plain twin: rel 1e-12 in f64, 1e-6 in f32 (sums in another
    order)."""
    p = random_problem(9, ncams=6, npnts=30, obs=3).astype(dtype)
    rng = np.random.default_rng(2)
    cams = torch.from_numpy(np.concatenate([
        0.1 * rng.standard_normal((6, 3)), rng.standard_normal((6, 2)),
        rng.standard_normal((6, 1)) - 10.0, [[1e-3, -1e-4, 500.0]] * 6],
        axis=1)).to(dtype)
    cams[0, 0:3] = 0.0
    cams[1, 0:3] = torch.tensor([1e-13, -2e-13, 0.0], dtype=dtype)
    points = p.points.clone()
    ci, pi = p.cam_idx.long(), p.pnt_idx.long()
    on_plane = int(torch.nonzero(ci[:p.nobs] == 0)[0])
    points[pi[on_plane], 2] = -cams[0, 5]      # theta = 0: RX = X, z = 0
    unweighted = int(torch.nonzero(ci[:p.nobs] == 1)[0])
    w = p.w.clone()
    w[unweighted] = 0.0
    p = dataclasses.replace(p, w=w)
    step = 1e-2 * torch.from_numpy(rng.standard_normal((6, 9))).to(dtype)
    step[:2, 0:3] = 0.0
    cams_all = torch.stack([cams, cams + 0.5 * step])
    pts_all = torch.stack([points, points])
    res = chain.project_residual(cams[ci], points[pi], p.pt2d, w)
    assert bool(torch.isfinite(res).all())
    assert not res[on_plane].any() and not res[unweighted].any()
    assert bool(res[:p.nobs].ne(0).any(1).sum() >= p.nobs - 2)
    got, written = k4_row_pass(p, cams_all, pts_all, 24, 4)
    assert written == [1] * (2 * -(-p.nobs_pad // 24))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(
        got, fa.objective_scatter(p, cams_all, pts_all),
        rtol=1e-12 if dtype == torch.float64 else 1e-6, atol=0.0)


def k4_states(problem, S, dtype, seed=9):
    """S trial states at scales 1, 1/2, ... of a random step, made with
    numpy in ``dtype`` as `tests/test_torch_kernels.py` makes them:
    (cams_all, pts_all, dp, scales)."""
    nd = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(seed)
    dc = (rng.standard_normal(problem.cams.shape) * 1e-2).astype(nd)
    dp = (rng.standard_normal(problem.points.shape) * 1e-2).astype(nd)
    sc = (0.5 ** np.arange(S)).astype(nd)
    cams, pts = (x.numpy().astype(nd) for x in (problem.cams, problem.points))
    return (torch.from_numpy(cams[None] + sc[:, None, None] * dc[None]),
            torch.from_numpy(pts[None] + sc[:, None, None] * dp[None]), dp,
            sc)


@pytest.mark.parametrize("S", [1, 5, 9])
@pytest.mark.parametrize("rows, threads", [(24, 4), (64, 8)])
def test_k4_row_pass_matches_plain(jprob, S, rows, threads):
    """K4's passes over blocks that end mid-problem (1280 rows in blocks
    of 24 or 64) write every partial once and give the plain twin's
    objectives, in f64."""
    _, tp, _ = jprob
    p = tp.astype(torch.float64)
    assert p.nobs_pad % 24 != 0 and p.nobs < p.nobs_pad
    cams_all, pts_all, _, _ = k4_states(p, S, torch.float64)
    got, written = k4_row_pass(p, cams_all, pts_all, rows, threads)
    assert written == [1] * (S * -(-p.nobs_pad // rows))
    torch.testing.assert_close(
        got, fa.objective_scatter(p, cams_all, pts_all), rtol=1e-12,
        atol=0.0)


def test_k4_row_pass_matches_pallas(jprob):
    """K4's passes in f32 at the kernel's rows a block and S = 5,
    against the JAX `objective_scatter` (interpret mode), with
    `tests/test_torch_kernels.py`'s tolerance."""
    jp, tp, _ = jprob
    cams_all, pts_all, dp, scales = k4_states(tp, 5, torch.float32)
    C = pallas_schur._chunk_rows(jp.nobs_pad)
    width = -(-(jp.npnts + C + 256) // 128) * 128
    ref = pallas_assemble.objective_scatter(
        pallas_assemble.pack_pw(jp),
        pallas_assemble.stack_trial_points(jp.points, jnp.asarray(dp),
                                           jnp.asarray(scales), width),
        jnp.asarray(cams_all.numpy()),
        pallas_assemble.trial_point_offsets(jp.pnt_idx, jp.nobs_pad, width,
                                            C), interpret=True)
    got, _ = k4_row_pass(tp, cams_all, pts_all,
                         constant("BA_OBJ_ROWS", "objective.cu"), 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


# ------------------------------------------------ K5 camera: column ranges
def many_small_cameras():
    """700 cameras of 1-3 rows each, 300 points."""
    rng = np.random.default_rng(4)
    cam = np.repeat(np.arange(700), rng.integers(1, 4, size=700))
    pnt = rng.integers(0, 300, size=cam.size)
    return problem_of(cam, pnt, 700, 300)


# Column layouts, each with the edge it puts in front of the plan (ranges
# of 16 columns below).
CAM_CASES = {
    "random": lambda: random_problem(1, ncams=7, npnts=40, obs=3),
    "one_camera": CASES["one_camera"],
    # camera 0 holds 100 columns: more than several ranges
    "long_camera": lambda: problem_of(
        [0] * 100 + [1, 2, 1, 2], list(np.arange(104) // 2), 3, 52),
    "many_small_cameras": many_small_cameras,
    "empty_cameras": CASES["empty_cameras"],
    # 37 real rows padded to 96: the padding rows sit on the last camera
    # and the last range is short (96 is not a multiple of 64)
    "padding_tail": lambda: random_problem(5, ncams=4, npnts=37, obs=1,
                                           pad_obs_to=96),
}


@pytest.mark.parametrize("case", CAM_CASES)
@pytest.mark.parametrize("cols", [8, 16, 64, plans.CAM_BLOCK_COLS])
def test_cam_col_plan_runs_partition_the_columns(case, cols):
    """Every camera-sorted column lies in exactly one run; a run is one
    camera and one range, and maximal; each range's runs and each camera's
    runs are consecutive ids (range_run_starts, cam_run_starts); cam_pnt is
    each column's point."""
    p = CAM_CASES[case]()
    plan = plans.build_cam_col_plan(p, cols=cols)
    n = p.nobs_pad
    b = plan.run_bounds.long()
    assert int(b[0]) == 0 and int(b[-1]) == n
    assert bool((b[1:] > b[:-1]).all())
    perm = p.cam_perm.long()
    cam, rng = p.cam_idx.long()[perm], torch.arange(n) // cols
    assert torch.equal(plan.cam_pnt.long(), p.pnt_idx.long()[perm])
    run_of_col = torch.repeat_interleave(torch.arange(plan.nruns),
                                         b[1:] - b[:-1])
    for key in (cam, rng):            # constant within a run
        assert torch.equal(key, key[b[:-1]][run_of_col])
    run_cam, run_rng = cam[b[:-1]], rng[b[:-1]]
    same = (run_cam[1:] == run_cam[:-1]) & (run_rng[1:] == run_rng[:-1])
    assert not bool(same.any())       # maximal
    assert plan.nranges == -(-n // cols)
    for starts, key, count in ((plan.range_run_starts, run_rng,
                                plan.nranges),
                               (plan.cam_run_starts, run_cam, p.ncams)):
        s = starts.long()
        assert s.shape[0] == count + 1 and int(s[0]) == 0 \
            and int(s[-1]) == plan.nruns
        assert torch.equal(key, torch.repeat_interleave(
            torch.arange(count), s[1:] - s[:-1]))
    empty = [c for c in range(p.ncams) if plan.cam_run_starts[c]
             == plan.cam_run_starts[c + 1]]
    assert empty == [c for c in range(p.ncams)
                     if p.cam_starts[c] == p.cam_starts[c + 1]]
    if case == "long_camera" and cols == 16:
        assert int(plan.cam_run_starts[1]) >= 100 // 16
    if case == "many_small_cameras" and cols == 64:
        assert int((plan.range_run_starts[1:]
                    - plan.range_run_starts[:-1]).max()) >= 20


def cam_walk(y, plan, V, block):
    """K5 camera direction's pass 1 and 2 (csrc/seg_block_reduce.cu) in
    torch ops over per-column 9-vectors ``y`` (n, 9), camera order: each
    range in chunks of ``block`` threads of ``V`` columns; each thread's
    segmented total from its last run head, the threads' totals scanned in
    order (the sum open at a chunk's end carried to the next), then each
    thread's columns from the sum open before it, a run's last column
    writing ``partial[run]``; pass 2 sums each camera's runs in order.
    Returns the camera sums and how often each run was written."""
    n, C = y.shape[0], plan.cols
    bounds, rrs = plan.run_bounds.tolist(), plan.range_run_starts.tolist()
    partial = torch.zeros((plan.nruns, 9), dtype=y.dtype)
    written = [0] * plan.nruns
    zero = torch.zeros(9, dtype=y.dtype)

    def columns(sb, l0, nv):
        """(k, run index, head, last) of a thread's columns."""
        r = max(i for i in range(len(sb) - 1) if sb[i] <= l0)
        for k in range(nv):
            if r + 1 < len(sb) - 1 and sb[r + 1] <= l0 + k:
                r += 1
            yield k, r, sb[r] == l0 + k, sb[r + 1] == l0 + k + 1

    for b in range(plan.nranges):
        c0, r0 = b * C, rrs[b]
        length = min(C, n - c0)
        sb = [bounds[r0 + i] - c0 for i in range(rrs[b + 1] - r0)] + [length]
        open_sum = zero
        for s0 in range(0, length, block * V):
            threads = []
            for i in range(block):
                l0 = s0 + i * V
                nv = max(0, min(V, length - l0))
                f, v = False, zero
                for k, _, head, _ in (columns(sb, l0, nv) if nv else []):
                    v = y[c0 + l0 + k] if head else v + y[c0 + l0 + k]
                    f = f or head
                threads.append((l0, nv, f, v))
            for l0, nv, f, v in threads:
                run = open_sum
                for k, r, head, last in (columns(sb, l0, nv) if nv else []):
                    run = y[c0 + l0 + k] if head else run + y[c0 + l0 + k]
                    if last:
                        partial[r0 + r] = run
                        written[r0 + r] += 1
                open_sum = v if f else open_sum + v
    crs = plan.cam_run_starts.long()
    cam_of_run = torch.repeat_interleave(torch.arange(crs.shape[0] - 1),
                                         crs[1:] - crs[:-1])
    out = torch.zeros((crs.shape[0] - 1, 9), dtype=y.dtype)
    return out.index_add_(0, cam_of_run, partial), written


def cam_products(W_cam, t, problem):
    """Per-column ``W_k t[pnt_k]`` (n, 9) over the camera-sorted W."""
    return sr.w_op_rows(W_cam, t, problem.pnt_idx.long()[
        problem.cam_perm.long()])


@pytest.mark.parametrize("case", CAM_CASES)
@pytest.mark.parametrize("V, block", [(4, 2), (8, 4), (4, 8)])
def test_cam_walk_matches_plain(case, V, block):
    """The walk over 16-column ranges (chunks of 8, 32 or 32 columns, so
    runs cross threads, warps' worth of threads and chunks) writes every
    run once and gives the plain twin's sums, in f64."""
    p = CAM_CASES[case]()
    rng = np.random.default_rng(6)
    W_cam = torch.from_numpy(rng.standard_normal((27, p.nobs_pad)))
    t = torch.from_numpy(rng.standard_normal((p.npnts, 3)))
    plan = plans.build_cam_col_plan(p, cols=16)
    got, written = cam_walk(cam_products(W_cam, t, p), plan, V, block)
    assert written == [1] * plan.nruns
    torch.testing.assert_close(got, sr.wt_cam_reduce(W_cam, t, p),
                               rtol=1e-12, atol=1e-12)


def test_cam_walk_matches_pallas(jprob):
    """The walk in f32, at the kernel's V for a float32 W, against the JAX
    `wt_cam_reduce` over the same camera-sorted W (interpret mode)."""
    jp, tp, ops = jprob
    perm = np.asarray(jp.cam_perm)
    W_cam = ops["W"][:, perm]
    t = ops["op"]
    ref = pallas_schur.wt_cam_reduce(
        pad_rows(jnp.asarray(W_cam), 32),
        gather_k_minor(pad_rows(jnp.asarray(t).T, 8), jp.pnt_idx[perm]),
        jp.cam_idx[perm], jp.cam_starts, jp.ncams, interpret=True)
    plan = plans.build_cam_col_plan(tp, cols=64)
    got, _ = cam_walk(cam_products(torch.from_numpy(W_cam),
                                   torch.from_numpy(t), tp), plan, 4, 8)
    close32(got, np.asarray(ref))


# ------------------------------------------------ K6 W C W': column ranges
def wcw_walk(y, plan, V, lanes=32):
    """K6 W C W's pass 1 and 2 (csrc/seg_prod_reduce.cu) in torch ops over
    per-column sums ``y`` (n, K), camera order: a warp of ``lanes`` lanes
    per range, each lane ``V`` consecutive columns of a chunk; the open
    run's sums kept per lane from chunk to chunk (each lane adds its
    columns in the run); when the run ends, the lanes' sums added and
    written to ``partial[run]``, and the next run opened (in the same
    chunk, or at the next chunk's start); pass 2 sums each camera's runs
    in order. Returns the camera sums and how often each run was
    written."""
    n, C, chunk = y.shape[0], plan.cols, lanes * V
    bounds, rrs = plan.run_bounds.tolist(), plan.range_run_starts.tolist()
    partial = torch.zeros((plan.nruns, y.shape[1]), dtype=y.dtype)
    written = [0] * plan.nruns
    for b in range(plan.nranges):
        c0, r0 = b * C, rrs[b]
        length = min(C, n - c0)
        acc = torch.zeros((lanes, y.shape[1]), dtype=y.dtype)
        r, lo, hi = 0, 0, bounds[r0 + 1] - c0
        for s0 in range(0, length, chunk):
            s1 = min(s0 + chunk, length)
            cols = torch.arange(s0, s1)
            while True:
                mine = (cols >= lo) & (cols < hi)
                acc.index_add_(0, (cols[mine] - s0) // V, y[c0 + cols[mine]])
                if hi > s1:
                    break
                partial[r0 + r] = acc.sum(0)
                written[r0 + r] += 1
                acc.zero_()
                if hi == length:
                    break
                chunk_ends = hi == s1
                r, lo, hi = r + 1, hi, bounds[r0 + r + 2] - c0
                if chunk_ends:
                    break
    crs = plan.cam_run_starts.long()
    cam_of_run = torch.repeat_interleave(torch.arange(crs.shape[0] - 1),
                                         crs[1:] - crs[:-1])
    out = torch.zeros((crs.shape[0] - 1, y.shape[1]), dtype=y.dtype)
    return out.index_add_(0, cam_of_run, partial), written


def spd_blocks(rng, npnts):
    """(npnts * 9,) symmetric positive definite 3x3 blocks, an Hpp_inv."""
    A = rng.standard_normal((npnts, 3, 3))
    return torch.from_numpy((A @ A.transpose(0, 2, 1)
                             + np.eye(3)).reshape(-1))


@pytest.mark.parametrize("case", CAM_CASES)
@pytest.mark.parametrize("V, lanes", [(1, 4), (2, 2), (4, 2), (2, 32)])
def test_wcw_walk_matches_plain(case, V, lanes):
    """K6 W C W's walk over 16-column ranges (chunks of 4 or 8 columns, so
    runs cross chunks and lanes, or of 64, one chunk a range) writes every
    run once and gives the plain twin's sums, in f64; a camera without rows
    gets exact zeros."""
    p = CAM_CASES[case]()
    rng = np.random.default_rng(7)
    W_cam = torch.from_numpy(rng.standard_normal((27, p.nobs_pad)))
    hpp = spd_blocks(rng, p.npnts)
    plan = plans.build_cam_col_plan(p, cols=16)
    got, written = wcw_walk(sr.wcw_rows(W_cam, hpp, plan.cam_pnt.long()),
                            plan, V, lanes)
    assert written == [1] * plan.nruns
    want = sr.wcw_cam_reduce(W_cam, p, hpp)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    empty = p.cam_starts[1:] == p.cam_starts[:-1]
    assert not got[empty].any() and not want[empty].any()
    if case == "empty_cameras":
        assert torch.nonzero(empty).flatten().tolist() == [0, 3, 5]


def test_wcw_walk_matches_pallas(jprob):
    """The walk in f32, at the kernel's column range and columns a lane,
    against the JAX `wcw_cam_reduce` over the same camera-sorted W and
    Hpp_inv (interpret mode)."""
    jp, tp, ops = jprob
    perm = np.asarray(jp.cam_perm)
    W_cam = ops["W"][:, perm]
    ref = pallas_schur.wcw_cam_reduce(
        pad_rows(jnp.asarray(W_cam), 32),
        pallas_schur.hpp_inv_sym6_t(jnp.asarray(ops["C"]), jp.pnt_idx[perm]),
        jp.cam_idx[perm], jp.cam_starts, jp.ncams, interpret=True)
    plan = plans.build_cam_col_plan(tp, cols=plans.WCW_BLOCK_COLS)
    got, written = wcw_walk(sr.wcw_rows(torch.from_numpy(W_cam),
                                        torch.from_numpy(ops["C"]),
                                        plan.cam_pnt.long()), plan,
                            constant("BA_WCW_COLS", "seg_prod_reduce.cu"))
    assert written == [1] * plan.nruns
    close32(got, np.asarray(ref))


# --------------------------------------------- K8: camera-order row copies
@pytest.mark.parametrize("case", CAM_CASES)
def test_cam_row_plan_copies_the_rows(case):
    """K8's plan holds pt2d, w, cam_idx and pnt_idx in camera order (the
    last the column plans' cam_pnt, one array), contiguous, in the
    problem's dtypes."""
    p = CAM_CASES[case]()
    rows = plans.cam_row_plan(p)
    perm = p.cam_perm.long()
    for got, want in ((rows.pt2d, p.pt2d[perm]), (rows.w, p.w[perm]),
                      (rows.cam, p.cam_idx[perm]), (rows.pnt,
                                                    p.pnt_idx[perm])):
        assert got.dtype == want.dtype and got.is_contiguous()
        assert torch.equal(got, want)
    assert rows.pnt is plans.cam_col_plan(p).cam_pnt \
        is plans.wcw_col_plan(p).cam_pnt
    assert plans.cam_row_plan(p) is rows


@pytest.mark.parametrize("first", ["original", "copy"])
def test_cam_row_plan_is_kept_per_dtype(first):
    """``with_state`` keeps pt2d and w and shares the row plan; an
    ``astype`` copy in another dtype builds its own from its own arrays,
    whichever of the two asks first, and never reads the other's; both
    share the index plans."""
    p = CAM_CASES["random"]()
    q = p.astype(torch.float64)
    built = {}
    for name in ((first, "copy" if first == "original" else "original")):
        built[name] = plans.cam_row_plan(p if name == "original" else q)
    rows, rows64 = built["original"], built["copy"]
    assert rows.pt2d.dtype == torch.float32
    assert rows64.pt2d.dtype == rows64.w.dtype == torch.float64
    assert rows64.pt2d.data_ptr() != rows.pt2d.data_ptr()
    perm = p.cam_perm.long()
    assert torch.equal(rows64.pt2d, q.pt2d[perm])
    assert torch.equal(rows64.w, q.w[perm])
    assert rows64.cam is rows.cam and rows64.pnt is rows.pnt
    moved = p.with_state(p.cams + 1.0, p.points)
    assert plans.cam_row_plan(moved) is rows
    assert plans.cam_row_plan(q.with_state(q.cams, q.points)) is rows64


def test_k8_reads_match_pallas(jprob):
    """K8's reads in torch ops: the chain at cams[cam], points[pnt],
    pt2d and w of the plan's camera-order rows, W = Jc' Jp, in f32,
    against the JAX `linearize_w_only` on its own camera-sorted packed
    operands (interpret mode), and against the plain twin."""
    jp, tp, _ = jprob
    perm = jp.cam_perm
    ref = pallas_linearize.linearize_w_only(pallas_linearize.pack_operands(
        jp.cams, jp.points, jp.cam_idx[perm], jp.pnt_idx[perm],
        jp.pt2d[perm], jp.w[perm]), interpret=True)
    rows = plans.cam_row_plan(tp)
    _, Jc, Jp = linearize(tp.cams[rows.cam.long()],
                          tp.points[rows.pnt.long()], rows.pt2d, rows.w)
    got = torch.einsum("nia,nib->abn", Jc, Jp).reshape(27, -1)
    close32(got, np.asarray(ref)[:27])
    torch.testing.assert_close(got, lz._linearize_w_only_plain(
        tp, tp.cams, tp.points), rtol=0, atol=0)


# ------------------------------------------------------- K1: both passes
def block_sum(rows, threads):
    """A block's fixed-order sum of ``rows`` (m, d): thread i sums rows i,
    i + threads, ... in order, then the threads' sums are added in order
    (the kernel's last step is a tree; the order is fixed either way)."""
    parts = [rows[i::threads].sum(0) for i in range(threads)]
    return torch.stack(parts).sum(0)


def k1_walks(problem, dtype, point_rows=4, chunk=8, threads=4):
    """K1's two passes in torch ops (csrc/assemble.cu): the rows' chain;
    the point pass's walk over its point ranges (blocks of ``point_rows``
    rows, chunks of ``chunk``) of each row's [Jp'Jp upper (6) | Jp'r (3)];
    the camera pass, a block of ``threads`` threads per camera over its
    rows in cam_perm order, of [Jc'Jc upper (45) | Jc'r (9) | r'r / 2]; the
    objective the camera totals summed in camera order. -> (W_t, hp12,
    hc90, obj)."""
    p = problem
    cams, points = p.cams.to(dtype), p.points.to(dtype)
    r, Jc, Jp = linearize(cams[p.cam_idx.long()], points[p.pnt_idx.long()],
                          p.pt2d.to(dtype), p.w.to(dtype))
    W_t = torch.einsum("nia,nib->abn", Jc, Jp).reshape(27, -1)
    up3 = [(b, e) for b in range(3) for e in range(b, 3)]
    y = torch.stack([(Jp[:, :, b] * Jp[:, :, e]).sum(1) for b, e in up3]
                    + [(Jp[:, :, b] * r).sum(1) for b in range(3)], dim=1)
    s, written = point_walk(y, p, plans.build_point_blocks(p, point_rows),
                            chunk)
    assert written == [1] * p.npnts
    sym3 = [[0, 1, 2], [1, 3, 4], [2, 4, 5]]
    hp12 = torch.cat([s[:, [sym3[a][b] for a in range(3) for b in range(3)]],
                      s[:, 6:9]], dim=1)
    up9 = [(a, d) for a in range(9) for d in range(a, 9)]
    rows = torch.stack([(Jc[:, :, a] * Jc[:, :, d]).sum(1) for a, d in up9]
                       + [(Jc[:, :, a] * r).sum(1) for a in range(9)]
                       + [0.5 * (r * r).sum(1)], dim=1)
    perm, cs = p.cam_perm.long(), p.cam_starts.tolist()
    tot = torch.stack([block_sum(rows[perm[cs[c]:cs[c + 1]]], threads)
                       for c in range(p.ncams)])
    tri = {ad: k for k, ad in enumerate(up9)}
    H = tot[:, [tri[min(a, d), max(a, d)] for a in range(9)
                for d in range(9)]]
    return W_t, hp12, torch.cat([H, tot[:, 45:54]], dim=1), tot[:, 54].sum()


@pytest.mark.parametrize("case", ["random", "empty_cameras", "ragged_tail",
                                  "one_tile_and_many", "one_camera"])
def test_k1_walks_match_plain(case):
    """K1's two passes (the point pass over its plan) give the plain
    twin's W, [Hpp | g_p], [Hcc | g_c] and objective, in f64."""
    p = CASES[case]()
    got = k1_walks(p, torch.float64)
    want = fa._assemble_plain(p, p.cams.double(), p.points.double())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_k1_walks_match_pallas(jprob):
    """K1's two passes in f32, at the kernel's point ranges, chunk and
    block, against the JAX `assemble_scatter` (interpret mode), with
    `tests/test_torch_kernels.py`'s tolerance."""
    jp, tp, _ = jprob
    old = (pallas_schur.PALLAS_MODE, pallas_schur.INTERPRET,
           pallas_schur.CAM_SCATTER)
    try:
        pallas_schur.set_mode(True)
        pallas_schur.INTERPRET = True
        pallas_schur.CAM_SCATTER = True
        ref = jax_assemble(jp, with_jr=False, kminor=True)
    finally:
        (pallas_schur.PALLAS_MODE, pallas_schur.INTERPRET,
         pallas_schur.CAM_SCATTER) = old
    W_t, hp12, hc90, obj = k1_walks(tp, torch.float32,
                                    point_rows=plans.POINT_BLOCK_ROWS,
                                    chunk=1280, threads=256)

    def close(got, want):
        got, want = np.asarray(got), np.asarray(want)
        np.testing.assert_allclose(
            got, want, rtol=1e-4, atol=max(1e-3, 1e-5 * np.abs(want).max()))
    close(W_t, np.asarray(ref.W_t)[:27])
    close(hp12[:, :9].reshape(-1), ref.Hpp_f)
    close(hp12[:, 9:].reshape(-1), ref.g_p_f)
    close(hc90[:, :81].reshape(-1), ref.Hcc_f)
    close(hc90[:, 81:].reshape(-1), ref.g_c_f)
    assert float(obj) == pytest.approx(float(ref.obj), rel=1e-5)
