"""Launch plans of the row-reduction kernels: K2's camera direction over the
point-sorted rows (``csrc/cam_prod.cuh``, read through ``cam_perm``), K5's
point direction and K1's point pass (``csrc/wtv_point.cuh``), K5's camera
direction and K6's W C W' over the camera-sorted copy of W
(``csrc/seg_block_reduce.cu``, ``csrc/seg_prod_reduce.cu``); and K8's
camera-order copies of the row data (``csrc/linearize.cu``).

The index plans depend only on the problem's index arrays (``cam_idx``,
``pnt_idx``, ``cam_perm``, ``pnt_starts``). K8's :class:`CamRowPlan`
copies float data too (``pt2d``, ``w``), so it is kept under a key that
holds their dtype: ``astype`` and ``with_state`` keep the index arrays and
share the plan dict, and ``with_state`` keeps ``pt2d`` and ``w``, but an
``astype`` copy in another dtype builds its own row plan. Each plan is
built once per problem, with torch ops on the problem's device, at the
first kernel call that needs it, and kept on the problem
(``BAProblem.plans``); the LM loop never rebuilds it.

K2 and K3, :class:`TilePlan`. The point-sorted rows are cut into tiles of
at most :data:`TILE_ROWS` (C) rows at point boundaries
(:func:`tile_bounds`): a tile ends at the start of the point that holds
each multiple of C - S (S = :data:`TILE_SHORT`), so a tile of points of at
most S rows holds fewer than C; a point of more than S rows has tiles of
its own (cut every C rows when it has more than C). Within a tile, a *run*
is one camera's rows: ``tile_rows`` lists each tile's rows by camera (row
order within a camera, offsets into the tile), ``run_ends`` each run's end
in that list, ``run_cam`` its camera, ``tile_run_starts`` each tile's runs.
A tile *owns* the points ``[tile_pnts[t], tile_pnts[t+1])``: from its
first row's point up to the next tile's, so every point, with rows or
not, has one owner, and a tile inside a long point owns none but its last
tile. ``visits`` is K3's walk over the tiles: a tile once (point and
camera pass), but the tiles of a point of more than C rows twice, their
point passes before their camera passes (:data:`VISIT_POINT`,
:data:`VISIT_CAMERA`); a block's span of visits starts only at a
:data:`VISIT_START`.

The kernels take the tiles in contiguous spans with a fixed number of
blocks, each keeping camera sums of its own in shared memory; a second
pass sums each camera's blocks in order. :func:`cam_pass_path` picks,
from the problem's sizes, the path: when the (ncams, K) floats do not fit
beside a block's tile stages, a 9-sum form writes each run's sums in tile
order and a second pass sums each camera's runs (``cam_runs``,
``cam_run_starts``); a 45- or 54-sum form writes each row's operands as a
record in row order and reduces each camera's records (``cam_perm``) a
block a camera.

K5's point direction, :func:`point_blocks`: the points cut into ranges of
about :data:`POINT_BLOCK_ROWS` rows each, one block per range.

K5's camera direction and K6's W C W', :class:`CamColPlan`, over the
camera-sorted copy ``W_cam_t`` (column ``j`` the row ``cam_perm[j]``): the
columns are cut into ranges of :data:`CAM_BLOCK_COLS` (K5, a block a range)
or :data:`WCW_BLOCK_COLS` (K6) columns. A *run* is a maximal stretch of
columns with one camera and one range; columns are in camera order, so run
ids in column order are in camera order too. Pass 1 sums each run's
columns into ``partial[run]``, pass 2 each camera's runs
``[cam_run_starts[c], cam_run_starts[c+1])`` in run order. ``cam_pnt`` =
``pnt_idx[cam_perm]`` (:func:`cam_pnt`, one array for every plan that
reads it) gives each column's point with one coalesced read.

K8, :class:`CamRowPlan`: the row data in camera order, so that K8 reads
every per-row field coalesced; 16 B a row on top of ``cam_pnt`` (148 MB at
Final-4585's 9,272,320 rows). K2 cam90 re-derived in camera order on
routes B1 and B2, and K2 W C W' | W t re-derived so on B1
(``csrc/linearize.cu``), read its ``pt2d`` and ``w``
(:func:`cam_obs`, kept apart) and ``cam_pnt`` alone: 16 B a row, without
K8's camera ids (the camera is the block's).

The dense Schur step's pair kernel (``csrc/dense_pairs.cu``),
:class:`PairPlan`: every point's pairs of true rows ``(k, l)``, ``k <= l``
(``sum_p n_p (n_p + 1) / 2``; 15,102,831 at Venice-1778), each oriented as
``(i, j)`` with ``cam_i >= cam_j`` and so charged to the 9x9 block
``(cam_i, cam_j)`` of S's lower triangle (block ``b = ci (ci + 1) / 2 +
cj``). The pairs are sorted by block, stably (within a block in point
order, then ``k``, then ``l``), so every block is one stretch summed in one
fixed order. A block is cut into chunks of at most :data:`PAIR_CHUNK`
pairs, and a block with no pair has one empty chunk: each chunk is summed
apart, a block of one chunk written at once, the chunks of a longer block
into partial slots that a second pass sums in order.

Each plan built opens the span ``ba.plan.<key>`` (`utils/profiling.py`;
the key's first part), and each value its builders read into the host is
counted there (``host_reads``): the flags of the checks, and each op whose
output size is a device value (``nonzero``, ``unique``, the total of the
cuts inside long points) and so waits for it.

Every plan assumes point-sorted rows: a problem in camera groups (its
``pnt_perm`` set, `parallel/partition.py`) has none, and each build function
refuses it; such a problem solves on the plain route.

:func:`rows`: the row data (``pt2d``, ``w``) in float32, which every kernel
that reads them takes. A problem in a 2-byte dtype (``astype("bfloat16")``)
holds them rounded to that dtype; their float32 copies are kept, like the
row plan, under a key that holds the problem's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundleadjustment_jl_tpu_torch.models.problem import HALF_DTYPES
from bundleadjustment_jl_tpu_torch.utils.profiling import host_read, span

# The most rows of a K2 / K3 tile: csrc/cam_pass.cuh:BA_TILE_ROWS (the
# kernel refuses a plan of another size; below 2^15, the plan's offsets
# are 16 bit), chosen by measurement (`tile_sweep --sweep tiles`,
# PERF.md); and the most rows of a point that shares a tile (a longer one
# has tiles of its own), so tiles hold about TILE_ROWS - TILE_SHORT rows
# (not swept).
TILE_ROWS = 512
TILE_SHORT = TILE_ROWS // 8
# Blocks of the per-block camera sums a wave (a plan constant: every sum's
# order depends on the problem alone, never on the card), and the blocks an
# SM holds at once: as many as its shared memory takes (SM_SMEM, the
# H100's, of which each block reserves 1 KB), at most BLOCKS_PER_SM of a
# form with K sums (its registers: 64 a thread for the 9-sum forms, ~175
# for the others). Chosen by measurement (`tile_sweep --sweep tiles`,
# PERF.md).
CAM_BLOCKS = 132
SM_SMEM = 233_472
BLOCKS_PER_SM = {9: 4}
# The dynamic shared memory a block may take for its stages and
# accumulators; None: the card's own limit for the kernel (the C entry
# points report it). Tests set it lower to take the other paths.
SMEM_BUDGET = None
# K2 / K3's paths (csrc/cam_pass.cuh:BA_PATH_*) and K3's visit flags
# (BA_VISIT_*).
PATHS = {"smem": 0, "records": 1, "runs": 2}
VISIT_POINT, VISIT_CAMERA, VISIT_START = 1, 2, 4
# Target rows of a K5 point block; a block ends at the first point boundary
# at or after each multiple of it. Its chunk of csrc/wtv_point.cuh
# (BA_PNT_CHUNK, 1536 rows) holds a block whose last point runs a few
# hundred rows past the target in one pass.
POINT_BLOCK_ROWS = 1024
# Columns of a K5 camera-direction range. A multiple of
# csrc/seg_block_reduce.cu:BA_CAM_COL_ALIGN (so each thread's columns start
# aligned in every plane), at most BA_CAM_COLS_MAX (the range's run bounds
# are staged in shared memory); the kernel refuses others. Chosen by
# measurement (`python -m bundleadjustment_jl_tpu_torch.tile_sweep --sweep
# cam_cols`: within 6% of the best at Dubrovnik-356 and Final-4585, PERF.md).
CAM_BLOCK_COLS = 2048
# Columns of a K6 W C W' range (csrc/seg_prod_reduce.cu: a warp a range);
# the same rules as CAM_BLOCK_COLS. Chosen by measurement
# (`python -m bundleadjustment_jl_tpu_torch.tile_sweep --sweep wcw`,
# PERF.md).
WCW_BLOCK_COLS = 512
# The most pairs a chunk of the dense Schur step's pair kernel sums
# (:class:`PairPlan`): a block of S with more is cut, so the few long
# blocks (at Venice-1778 each diagonal block holds ~2,800 pairs, an
# off-diagonal one ~6) are summed by many chunks side by side.
PAIR_CHUNK = 32


class TilePlan(NamedTuple):
    """K2 and K3's plan (on the problem's device; int32 but the 16-bit
    offsets into a tile)."""
    rows: int                       # C, the most rows a tile holds
    tile_bounds: torch.Tensor       # (ntiles+1,) tile t = rows [b[t], b[t+1])
    tile_pnts: torch.Tensor         # (ntiles+1,) the points tile t owns
    tile_run_starts: torch.Tensor   # (ntiles+1,) tile t's runs
    run_cam: torch.Tensor           # (nruns,) each run's camera
    run_ends: torch.Tensor          # (nruns,) int16, end in tile_rows
    tile_rows: torch.Tensor         # (n,) int16, each tile's rows by camera
    visits: torch.Tensor            # (nvisits,) K3's walk: t << 3 | flags
    cam_runs: torch.Tensor          # (nruns,) the runs by camera, tile order
    cam_run_starts: torch.Tensor    # (ncams+1,) camera c's stretch of them

    @property
    def nruns(self) -> int:
        return self.run_cam.shape[0]

    @property
    def ntiles(self) -> int:
        return self.tile_bounds.shape[0] - 1


class CamColPlan(NamedTuple):
    """K5 camera direction's plan (int32 tensors on the problem's device)."""
    cols: int                       # C, columns per range
    cam_pnt: torch.Tensor           # (n,) pnt_idx[cam_perm]
    run_bounds: torch.Tensor        # (nruns+1,) run r = columns [b[r], b[r+1])
    range_run_starts: torch.Tensor  # (nranges+1,) range b's runs
    cam_run_starts: torch.Tensor    # (ncams+1,) camera c's runs

    @property
    def nruns(self) -> int:
        return self.run_bounds.shape[0] - 1

    @property
    def nranges(self) -> int:
        return self.range_run_starts.shape[0] - 1


class CamRowPlan(NamedTuple):
    """K8's row data in camera order (on the problem's device; ``pt2d``
    and ``w`` in the problem's float dtype, the indices int32)."""
    pt2d: torch.Tensor              # (n, 2) pt2d[cam_perm]
    w: torch.Tensor                 # (n,) w[cam_perm]
    cam: torch.Tensor               # (n,) cam_idx[cam_perm]
    pnt: torch.Tensor               # (n,) pnt_idx[cam_perm], cam_pnt


class PairPlan(NamedTuple):
    """The dense Schur step's plan (int32 tensors on the problem's
    device): the oriented pairs by block of S's lower triangle, their
    chunks, and the blocks of more than one chunk."""
    pair_i: torch.Tensor            # (npairs,) the row of the block's row camera
    pair_j: torch.Tensor            # (npairs,) the row of its column camera
    chunk_starts: torch.Tensor      # (nchunks+1,) chunk c = pairs [s[c], s[c+1])
    chunk_block: torch.Tensor       # (nchunks,) the block chunk c sums into
    chunk_slot: torch.Tensor        # (nchunks,) its partial's slot, -1: none
    multi_block: torch.Tensor       # (nmulti,) the blocks of several chunks
    multi_slots: torch.Tensor       # (nmulti+1,) block m's slots [s[m], s[m+1])
    nslots: int                     # the partial slots, multi_slots[-1]

    @property
    def npairs(self) -> int:
        return self.pair_i.shape[0]

    @property
    def nchunks(self) -> int:
        return self.chunk_block.shape[0]

    @property
    def nmulti(self) -> int:
        return self.multi_block.shape[0]


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _point_sorted(problem) -> None:
    """Raise unless ``problem``'s rows are point-sorted, as every plan
    assumes (runs of a tile, point ranges of rows, columns of
    ``cam_perm`` in row order): a partitioned problem (``pnt_perm``) has
    no plan and solves on the plain route (`ops/normal.py:solve_stages`)."""
    if getattr(problem, "pnt_perm", None) is not None:
        raise ValueError(f"{problem.name}: rows in camera groups (pnt_perm) "
                         "have no launch plan; every plan needs point-sorted "
                         "rows (partitioned problems solve on the plain "
                         "route)")


def _check_cam_perm(problem) -> None:
    """Raise unless ``cam_perm`` lists the cameras in order and each
    camera's rows in ascending order (a stable argsort of ``cam_idx``)."""
    perm = problem.cam_perm.long()
    cam = problem.cam_idx.long()[perm]
    same_cam = cam[1:] == cam[:-1]
    if bool(host_read(((cam[1:] < cam[:-1])
                       | (same_cam & (perm[1:] <= perm[:-1]))).any())):
        raise ValueError("cam_perm must list the cameras in order and each "
                         "camera's rows in ascending order (a stable argsort "
                         "of cam_idx)")


def tile_bounds(pnt_starts: torch.Tensor, n: int, rows: int,
                short: int) -> torch.Tensor:
    """(ntiles+1,) row bounds of the tiles of at most ``rows`` rows over
    rows ``[0, n)`` with points ``pnt_starts``: a bound at the start of the
    point that holds each multiple of rows - short, at both ends of every
    point of more than ``short`` rows, and every ``rows`` rows inside a
    point of more than ``rows``. A tile between two bounds either lies in
    one long point (at most ``rows`` rows) or holds points of at most
    ``short`` rows and at most one multiple of rows - short past its start,
    so fewer than ``rows`` rows."""
    if not 1 <= short <= rows // 2:
        raise ValueError(f"short points of {short} rows: 1 to rows // 2")
    ps = pnt_starts.long()
    dev = ps.device
    at = torch.arange(0, n, rows - short, device=dev)
    cuts = [ps[torch.searchsorted(ps, at, right=True) - 1],
            ps.new_tensor([0, n])]
    seg = ps[1:] - ps[:-1]
    long_ = host_read(torch.nonzero(seg > short)).flatten()
    cuts += [ps[long_], ps[long_ + 1]]
    # The cuts inside each long point: none in one of at most ``rows``.
    nsplit = (seg[long_] - 1) // rows
    total = int(host_read(nsplit.sum()))
    if total > 0:
        owner = torch.repeat_interleave(long_, nsplit, output_size=total)
        first = torch.cumsum(nsplit, 0) - nsplit
        j = torch.arange(total, device=dev) - torch.repeat_interleave(
            first, nsplit, output_size=total) + 1
        cuts.append(ps[owner] + j * rows)
    return host_read(torch.unique(torch.cat(cuts)))


def build_tile_plan(problem, rows: int = TILE_ROWS,
                    short: int | None = None) -> TilePlan:
    """K2 and K3's plan for ``problem`` with tiles of at most ``rows`` rows,
    points of more than ``short`` rows (default rows // 8) in tiles of their
    own (uncached; :func:`tile_plan` keeps it on the problem). Raises
    ValueError unless ``cam_perm`` lists the cameras in order and each
    camera's rows in ascending order (a stable argsort of ``cam_idx``)."""
    _point_sorted(problem)
    if not 2 <= rows < 1 << 15:
        raise ValueError(f"tile rows {rows}: the plan's offsets are 16 bit")
    _check_cam_perm(problem)
    perm = problem.cam_perm.long()
    n, dev = perm.shape[0], perm.device
    ps, pidx = problem.pnt_starts.long(), problem.pnt_idx.long()
    bounds = tile_bounds(ps, n, rows, max(1, rows // 8) if short is None
                         else short)
    ntiles = bounds.shape[0] - 1
    tile = torch.searchsorted(bounds, torch.arange(n, device=dev),
                              right=True) - 1
    pnts = torch.cat([bounds.new_zeros(1), pidx[bounds[1:-1]],
                      bounds.new_tensor([problem.npnts])])
    # Each tile's rows by camera (stable: row order within a camera).
    order = perm[torch.sort(tile[perm], stable=True).indices]
    tile_o, cam_o = tile[order], problem.cam_idx.long()[order]
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = (cam_o[1:] != cam_o[:-1]) | (tile_o[1:] != tile_o[:-1])
    starts = host_read(torch.nonzero(new)).flatten()
    run_tile = tile_o[starts]
    ends = torch.cat([starts[1:], starts.new_tensor([n])])
    run_starts = torch.searchsorted(run_tile,
                                    torch.arange(ntiles + 1, device=dev))
    run_cam = cam_o[starts]
    cam_runs = torch.sort(run_cam, stable=True).indices
    return TilePlan(rows, _i32(bounds), _i32(pnts), _i32(run_starts),
                    _i32(run_cam),
                    (ends - bounds[run_tile]).to(torch.int16).contiguous(),
                    (order - bounds[tile_o]).to(torch.int16).contiguous(),
                    _i32(_visits(ps, bounds, pidx, rows)), _i32(cam_runs),
                    _i32(torch.searchsorted(run_cam[cam_runs], torch.arange(
                        problem.ncams + 1, device=dev))))


def _visits(ps, bounds, pidx, rows) -> torch.Tensor:
    """K3's walk over the tiles ``bounds``: a tile once (point and camera
    pass, a block may start there), a tile inside a point of more than
    ``rows`` rows twice: the point's tiles' point passes (the first may
    start a block), then their camera passes."""
    ntiles, dev = bounds.shape[0] - 1, bounds.device
    t = torch.arange(ntiles, device=dev)
    p = pidx[bounds[:-1]]
    grouped = (ps[p + 1] - ps[p]) > rows
    anchor = torch.where(grouped, torch.searchsorted(bounds, ps[p]), t)
    first = torch.where(grouped, VISIT_POINT | torch.where(
        t == anchor, VISIT_START, 0), VISIT_POINT | VISIT_CAMERA | VISIT_START)
    g = host_read(torch.nonzero(grouped)).flatten()
    codes = torch.cat([t * 8 + first, g * 8 + VISIT_CAMERA])
    keys = torch.cat([anchor * 2 * ntiles + t,
                      (anchor[g] * 2 + 1) * ntiles + g])
    return codes[torch.sort(keys).indices]


def cam_pass_path(ncams: int, k: int, stage_bytes: int,
                  budget: int) -> tuple[str, int]:
    """``(path, blocks)`` of a K2 form (or K3) with ``k`` sums a camera
    whose tile stages take ``stage_bytes`` of a block's dynamic shared
    memory ``budget`` (:data:`SMEM_BUDGET` when set): "smem" when the
    (ncams, k) float accumulators fit beside the stages (for a 9-sum form,
    and leave room for a second block on an SM, or the per-run sums would
    not either); else "runs" for the 9-sum forms (the stages and a tile's
    run sums always fit), "records" (no blocks: one a camera) for the
    others. The blocks: CAM_BLOCKS times the blocks an SM holds at once
    (:data:`SM_SMEM`, :data:`BLOCKS_PER_SM`)."""
    if SMEM_BUDGET is not None:
        budget = SMEM_BUDGET

    def per_sm(smem):
        return max(1, min(BLOCKS_PER_SM.get(k, 1), SM_SMEM // (smem + 1024)))
    smem = stage_bytes + ncams * k * 4
    runs = stage_bytes + TILE_ROWS * k * 4
    # A 9-sum form whose shared sums leave its block alone on an SM takes
    # the per-run sums when those let several blocks share it (W op and
    # K3 stage one tile at a time: alone, a block waits on each tile).
    if smem <= budget and not (k == 9 and per_sm(smem) == 1
                               and per_sm(runs) > 1):
        return "smem", CAM_BLOCKS * per_sm(smem)
    if k == 9:
        return "runs", CAM_BLOCKS * per_sm(runs)
    return "records", 0


def build_point_blocks(problem, rows: int = POINT_BLOCK_ROWS) -> torch.Tensor:
    """K5's plan (uncached; :func:`point_blocks` keeps it on the problem):
    (nblocks+1,) int32 point bounds, block b taking the points
    ``[bounds[b], bounds[b+1])``. A block ends at the first point that
    starts at or after each multiple of ``rows``, so it holds at most
    ``rows`` rows plus the rows of its last point."""
    _point_sorted(problem)
    ps = problem.pnt_starts.long()
    dev, npt = ps.device, problem.npnts
    cuts = torch.searchsorted(ps, rows * torch.arange(
        1, -(-problem.nobs_pad // rows), device=dev))
    ends = ps.new_tensor([0, npt])
    return _i32(host_read(torch.unique(torch.cat([ends,
                                                  cuts.clamp(max=npt)]))))


def build_cam_col_plan(problem, cols: int = CAM_BLOCK_COLS) -> CamColPlan:
    """The column plan of ``problem`` with ranges of ``cols`` columns
    (uncached; :func:`cam_col_plan` and :func:`wcw_col_plan` keep theirs
    on the problem). Raises ValueError unless ``cam_perm`` lists the
    cameras in order."""
    _point_sorted(problem)
    perm = problem.cam_perm.long()
    n, dev = perm.shape[0], perm.device
    cam = problem.cam_idx.long()[perm]
    if bool(host_read((cam[1:] < cam[:-1]).any())):
        raise ValueError("cam_perm must list the cameras in order")
    rng = torch.arange(n, device=dev) // cols
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = (cam[1:] != cam[:-1]) | (rng[1:] != rng[:-1])
    starts = host_read(torch.nonzero(new)).flatten()
    nranges = -(-n // cols)
    return CamColPlan(
        cols, cam_pnt(problem),
        _i32(torch.cat([starts, starts.new_tensor([n])])),
        _i32(torch.searchsorted(rng[starts],
                                torch.arange(nranges + 1, device=dev))),
        _i32(torch.searchsorted(cam[starts], torch.arange(
            problem.ncams + 1, device=dev))))


def build_cam_obs(problem) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pt2d[cam_perm], w[cam_perm])`` of ``problem``'s rows as the
    kernels read them (:func:`rows`), contiguous (uncached; :func:`cam_obs`
    keeps them on the problem)."""
    _point_sorted(problem)
    perm = problem.cam_perm.long()
    pt2d, w = rows(problem)
    return pt2d[perm].contiguous(), w[perm].contiguous()


def build_cam_row_plan(problem) -> CamRowPlan:
    """K8's camera-order copies of ``problem``'s row data: the
    observations of :func:`cam_obs` and the index arrays in camera order
    (uncached itself; :func:`cam_row_plan` keeps it on the problem)."""
    _point_sorted(problem)
    return CamRowPlan(*cam_obs(problem), _by_camera(problem, "cam_idx"),
                      cam_pnt(problem))


def count_pairs(problem) -> int:
    """``sum_p n_p (n_p + 1) / 2`` over the true rows, the padding rows past
    ``nobs`` (in the last point's segment) left out (uncached;
    :func:`pair_count` keeps it on the problem): one host read."""
    _point_sorted(problem)
    ps = problem.pnt_starts.long().clamp(max=problem.nobs)
    n = ps[1:] - ps[:-1]
    return int(host_read(torch.sum(n * (n + 1) // 2)))


def build_pair_plan(problem, npairs: int,
                    chunk: int = PAIR_CHUNK) -> PairPlan:
    """The dense Schur step's plan of ``problem`` with ``npairs`` pairs
    (:func:`count_pairs`) and chunks of at most ``chunk`` pairs (uncached;
    :func:`pair_plan` keeps it on the problem). One host read: the chunk
    counts."""
    _point_sorted(problem)
    nc, n = problem.ncams, problem.nobs
    nblk = nc * (nc + 1) // 2
    if nblk >= 1 << 31:
        raise ValueError(f"{nc} cameras: the plan's block ids are 32 bit")
    dev = problem.pnt_idx.device
    ps = problem.pnt_starts.long().clamp(max=n)
    rows = torch.arange(n, device=dev)
    per = ps[problem.pnt_idx[:n].long() + 1] - rows
    k = torch.repeat_interleave(rows, per, output_size=npairs)
    first = torch.cumsum(per, 0) - per
    l = k + torch.arange(npairs, device=dev) - torch.repeat_interleave(
        first, per, output_size=npairs)
    del first, per, rows
    cam = problem.cam_idx.long()
    ck, cl = cam[k], cam[l]
    swap = ck < cl
    i, j = torch.where(swap, l, k), torch.where(swap, k, l)
    del k, l
    ci, cj = torch.maximum(ck, cl), torch.minimum(ck, cl)
    block = ci * (ci + 1) // 2 + cj
    del ck, cl, ci, cj, swap
    block, order = torch.sort(block, stable=True)
    i, j = _i32(i[order]), _i32(j[order])
    del order
    ar = torch.arange(nblk + 1, device=dev)
    bstart = torch.searchsorted(block, ar)
    del block
    nch = ((bstart[1:] - bstart[:-1] + chunk - 1) // chunk).clamp(min=1)
    multi = nch > 1
    nchunks, nmulti, nslots = host_read(torch.stack(
        [nch.sum(), multi.sum(), (nch * multi).sum()])).tolist()
    cblock = torch.repeat_interleave(ar[:-1], nch, output_size=nchunks)
    q = torch.arange(nchunks, device=dev) - (torch.cumsum(nch, 0) - nch)[
        cblock]
    starts = torch.cat([bstart[cblock] + q * chunk,
                        bstart.new_tensor([npairs])])
    in_multi = multi[cblock]
    slot = torch.where(in_multi, torch.cumsum(in_multi, 0) - 1, -1)
    mblock = torch.sort((~multi).to(torch.uint8), stable=True).indices[
        :nmulti]
    mslots = torch.cat([mblock.new_zeros(1), torch.cumsum(nch[mblock], 0)])
    return PairPlan(i, j, _i32(starts), _i32(cblock), _i32(slot),
                    _i32(mblock), _i32(mslots), nslots)


def _cached(problem, key, build):
    """``problem.plans[key]``, built by ``build()`` at the first call inside
    the span ``ba.plan.<name>`` (`utils/profiling.py`; the name is the key's
    first part, a string key itself); a cached plan opens no span."""
    if key not in problem.plans:
        name = key if isinstance(key, str) else key[0]
        with span(f"ba.plan.{name}"):
            problem.plans[key] = build()
    return problem.plans[key]


def rows(problem) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pt2d, w)`` as the kernels read them: the problem's own, or for a
    problem in a 2-byte dtype their float32 copies (the rounded values,
    widened exactly), built at the first call and kept under that dtype."""
    if problem.pt2d.dtype not in HALF_DTYPES:
        return problem.pt2d, problem.w
    return _cached(problem, ("rows", problem.pt2d.dtype), lambda: (
        problem.pt2d.float().contiguous(), problem.w.float().contiguous()))


def tile_plan(problem) -> TilePlan:
    """K2 and K3's plan of ``problem``, built at the first call."""
    return _cached(problem, "tiles", lambda: build_tile_plan(
        problem, TILE_ROWS, TILE_SHORT))


def point_blocks(problem) -> torch.Tensor:
    """K5's point ranges of ``problem``, built at the first call."""
    return _cached(problem, "point_blocks", lambda: build_point_blocks(
        problem, POINT_BLOCK_ROWS))


def _by_camera(problem, field: str) -> torch.Tensor:
    """(n,) int32 index array ``field`` in camera order (``[cam_perm]``),
    built at the first call."""
    _point_sorted(problem)
    return _cached(problem, ("by_camera", field), lambda: _i32(
        getattr(problem, field).long()[problem.cam_perm.long()]))


def cam_pnt(problem) -> torch.Tensor:
    """(n,) int32 ``pnt_idx[cam_perm]``: each camera-sorted column's
    point, one array for every plan that reads it."""
    return _by_camera(problem, "pnt_idx")


def cam_col_plan(problem) -> CamColPlan:
    """K5 camera direction's plan of ``problem``, built at the first call."""
    return _cached(problem, "cam_cols", lambda: build_cam_col_plan(
        problem, CAM_BLOCK_COLS))


def wcw_col_plan(problem) -> CamColPlan:
    """K6 W C W's column plan of ``problem``, built at the first call."""
    return _cached(problem, "wcw_cols", lambda: build_cam_col_plan(
        problem, WCW_BLOCK_COLS))


def cam_obs(problem) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pt2d, w)`` of ``problem``'s rows in camera order, built at the
    first call and kept, as :func:`cam_row_plan`, under the dtype of
    ``pt2d``."""
    return _cached(problem, ("cam_obs", problem.pt2d.dtype),
                   lambda: build_cam_obs(problem))


def cam_row_plan(problem) -> CamRowPlan:
    """K8's camera-order rows of ``problem``, built at the first call and
    kept under the dtype of ``pt2d``: a copy of the problem in another
    dtype (``astype``) never reads them."""
    return _cached(problem, ("cam_rows", problem.pt2d.dtype),
                   lambda: build_cam_row_plan(problem))


def pair_count(problem) -> int:
    """The dense Schur step's pair count of ``problem``
    (:func:`count_pairs`), read at the first call."""
    return _cached(problem, ("pairs", "count"),
                   lambda: count_pairs(problem))


def pair_plan(problem) -> PairPlan:
    """The dense Schur step's plan of ``problem``, built at the first
    call."""
    return _cached(problem, "pairs", lambda: build_pair_plan(
        problem, pair_count(problem), PAIR_CHUNK))
