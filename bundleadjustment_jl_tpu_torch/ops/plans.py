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

K2, :class:`TilePlan`. The point-sorted rows are cut into tiles of
:data:`TILE_ROWS` rows. A *run* is a maximal stretch of ``cam_perm`` with
one camera and one tile. ``cam_perm`` is the stable argsort of ``cam_idx``,
so each camera's rows ascend, its runs are consecutive in ``cam_perm`` and
come in tile order (:func:`build_tile_plan` checks this and raises
otherwise). Pass 1
of the kernel takes one block per tile: it stages the tile's rows of every
plane, sums each run, and writes the run's sums to row ``r`` (the run's
id, in ``cam_perm`` order) of a (nruns, K) scratch buffer. Pass 2 sums
each camera's runs ``[cam_run_starts[c], cam_run_starts[c+1])`` in run
order. Pass 1 walks the tile's runs through arrays in tile order
(``tile_rows``, ``tile_run_bounds``, ``tile_runs``), so every read it makes
of the plan is coalesced.

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
Final-4585's 9,272,320 rows).

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

# Rows of a K2 tile: csrc/cam_prod.cuh:BA_TILE_ROWS (the kernel refuses a
# plan of another size). Chosen by measurement (see there).
TILE_ROWS = 512
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


class TilePlan(NamedTuple):
    """K2's plan (int32 tensors on the problem's device). Runs have two
    orders: their id ``r`` is their place in ``cam_perm`` order; *tile
    order* lists tile 0's runs, then tile 1's, each tile's in camera
    order."""
    rows: int                       # R, rows per tile
    run_bounds: torch.Tensor        # (nruns+1,) run r = cam_perm[b[r]:b[r+1]]
    cam_run_starts: torch.Tensor    # (ncams+1,) camera c's runs, by id
    tile_runs: torch.Tensor         # (nruns,) run ids in tile order
    tile_run_starts: torch.Tensor   # (ntiles+1,) tile t's runs, tile order
    tile_run_bounds: torch.Tensor   # (nruns+1,) tile-order runs in tile_rows
    tile_rows: torch.Tensor         # (n,) cam_perm's rows in tile order

    @property
    def nruns(self) -> int:
        return self.tile_runs.shape[0]

    @property
    def ntiles(self) -> int:
        return self.tile_run_starts.shape[0] - 1


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


def build_tile_plan(problem, rows: int = TILE_ROWS) -> TilePlan:
    """K2's plan for ``problem`` with tiles of ``rows`` rows (uncached;
    :func:`tile_plan` keeps it on the problem). Raises ValueError unless
    ``cam_perm`` lists the cameras in order and each camera's rows in
    ascending order (a stable argsort of ``cam_idx``)."""
    _point_sorted(problem)
    perm = problem.cam_perm.long()
    n, dev = perm.shape[0], perm.device
    cam = problem.cam_idx.long()[perm]
    tile = perm // rows
    same_cam = cam[1:] == cam[:-1]
    if bool(((cam[1:] < cam[:-1])
             | (same_cam & (perm[1:] <= perm[:-1]))).any()):
        raise ValueError("cam_perm must list the cameras in order and each "
                         "camera's rows in ascending order (a stable argsort "
                         "of cam_idx)")
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = ~same_cam | (tile[1:] != tile[:-1])
    starts = torch.nonzero(new).flatten()
    run_bounds = torch.cat([starts, starts.new_tensor([n])])
    run_tile = tile[starts]
    cam_run_starts = torch.searchsorted(
        cam[starts], torch.arange(problem.ncams + 1, device=dev))
    tile_sorted, tile_runs = torch.sort(run_tile, stable=True)
    ntiles = -(-n // rows)
    tile_run_starts = torch.searchsorted(
        tile_sorted, torch.arange(ntiles + 1, device=dev))
    lens = (run_bounds[1:] - run_bounds[:-1])[tile_runs]
    tile_run_bounds = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    # Positions in tile order: stable, so camera order within a tile, and
    # each tile-order run's rows are contiguous.
    tile_rows = perm[torch.sort(tile, stable=True).indices]
    return TilePlan(rows, _i32(run_bounds), _i32(cam_run_starts),
                    _i32(tile_runs), _i32(tile_run_starts),
                    _i32(tile_run_bounds), _i32(tile_rows))


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
    return _i32(torch.unique(torch.cat([ends, cuts.clamp(max=npt)])))


def build_cam_col_plan(problem, cols: int = CAM_BLOCK_COLS) -> CamColPlan:
    """The column plan of ``problem`` with ranges of ``cols`` columns
    (uncached; :func:`cam_col_plan` and :func:`wcw_col_plan` keep theirs
    on the problem). Raises ValueError unless ``cam_perm`` lists the
    cameras in order."""
    _point_sorted(problem)
    perm = problem.cam_perm.long()
    n, dev = perm.shape[0], perm.device
    cam = problem.cam_idx.long()[perm]
    if bool((cam[1:] < cam[:-1]).any()):
        raise ValueError("cam_perm must list the cameras in order")
    rng = torch.arange(n, device=dev) // cols
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = (cam[1:] != cam[:-1]) | (rng[1:] != rng[:-1])
    starts = torch.nonzero(new).flatten()
    nranges = -(-n // cols)
    return CamColPlan(
        cols, cam_pnt(problem),
        _i32(torch.cat([starts, starts.new_tensor([n])])),
        _i32(torch.searchsorted(rng[starts],
                                torch.arange(nranges + 1, device=dev))),
        _i32(torch.searchsorted(cam[starts], torch.arange(
            problem.ncams + 1, device=dev))))


def build_cam_row_plan(problem) -> CamRowPlan:
    """K8's camera-order copies of ``problem``'s row data (uncached;
    :func:`cam_row_plan` keeps them on the problem)."""
    _point_sorted(problem)
    perm = problem.cam_perm.long()
    pt2d, w = rows(problem)
    return CamRowPlan(pt2d[perm].contiguous(), w[perm].contiguous(),
                      _by_camera(problem, "cam_idx"), cam_pnt(problem))


def rows(problem) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pt2d, w)`` as the kernels read them: the problem's own, or for a
    problem in a 2-byte dtype their float32 copies (the rounded values,
    widened exactly), built at the first call and kept under that dtype."""
    if problem.pt2d.dtype not in HALF_DTYPES:
        return problem.pt2d, problem.w
    key = ("rows", problem.pt2d.dtype)
    if key not in problem.plans:
        problem.plans[key] = (problem.pt2d.float().contiguous(),
                              problem.w.float().contiguous())
    return problem.plans[key]


def tile_plan(problem) -> TilePlan:
    """K2's plan of ``problem``, built at the first call."""
    if "tiles" not in problem.plans:
        problem.plans["tiles"] = build_tile_plan(problem, TILE_ROWS)
    return problem.plans["tiles"]


def point_blocks(problem) -> torch.Tensor:
    """K5's point ranges of ``problem``, built at the first call."""
    if "point_blocks" not in problem.plans:
        problem.plans["point_blocks"] = build_point_blocks(problem,
                                                           POINT_BLOCK_ROWS)
    return problem.plans["point_blocks"]


def _by_camera(problem, field: str) -> torch.Tensor:
    """(n,) int32 index array ``field`` in camera order (``[cam_perm]``),
    built at the first call."""
    _point_sorted(problem)
    key = ("by_camera", field)
    if key not in problem.plans:
        problem.plans[key] = _i32(
            getattr(problem, field).long()[problem.cam_perm.long()])
    return problem.plans[key]


def cam_pnt(problem) -> torch.Tensor:
    """(n,) int32 ``pnt_idx[cam_perm]``: each camera-sorted column's
    point, one array for every plan that reads it."""
    return _by_camera(problem, "pnt_idx")


def cam_col_plan(problem) -> CamColPlan:
    """K5 camera direction's plan of ``problem``, built at the first call."""
    if "cam_cols" not in problem.plans:
        problem.plans["cam_cols"] = build_cam_col_plan(problem,
                                                       CAM_BLOCK_COLS)
    return problem.plans["cam_cols"]


def wcw_col_plan(problem) -> CamColPlan:
    """K6 W C W's column plan of ``problem``, built at the first call."""
    if "wcw_cols" not in problem.plans:
        problem.plans["wcw_cols"] = build_cam_col_plan(problem,
                                                       WCW_BLOCK_COLS)
    return problem.plans["wcw_cols"]


def cam_row_plan(problem) -> CamRowPlan:
    """K8's camera-order rows of ``problem``, built at the first call and
    kept under the dtype of ``pt2d``: a copy of the problem in another
    dtype (``astype``) never reads them."""
    key = ("cam_rows", problem.pt2d.dtype)
    if key not in problem.plans:
        problem.plans[key] = build_cam_row_plan(problem)
    return problem.plans[key]
