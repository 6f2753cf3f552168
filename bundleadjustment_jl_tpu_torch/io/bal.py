"""BAL (Bundle Adjustment in the Large) reader (PyTorch port of
`bundleadjustment_jl_tpu/io/bal.py`).

File format (https://grail.cs.washington.edu/projects/bal/):

    ncams npnts nobs
    <nobs lines>  cam_idx pnt_idx x y          (0-based indices)
    <ncams x 9 lines>  rx ry rz tx ty tz f k1 k2   (one value per line)
    <npnts x 3 lines>  point coordinates           (one value per line)

Camera parameters are reordered from file order ``(r, t, f, k1, k2)`` to
the internal order ``(r, t, k1, k2, f)``. :func:`read_bal` parses with the
native C++ parser (`io/native.py`), or with numpy for a ``.bz2`` file when
no libbz2 was found to link it with (the stdlib decompresses it then), as
the JAX reader chooses. :func:`write_bal` is its inverse.
"""

from __future__ import annotations

import bz2
import io as _io
import os

import numpy as np
import torch

from bundleadjustment_jl_tpu_torch.io.native import (
    NATIVE_BZ2, parse_bal_native)
from bundleadjustment_jl_tpu_torch.models.problem import BAProblem


def _open_text(path: str):
    if path.endswith(".bz2"):
        return _io.TextIOWrapper(bz2.open(path, "rb"))
    return open(path, "r")


def _read_raw(path: str):
    """Parse a BAL file into raw arrays (0-based indices, file camera
    order)."""
    with _open_text(path) as f:
        header = f.readline().split()
        ncams, npnts, nobs = (int(v) for v in header[:3])
        obs = np.loadtxt(f, max_rows=nobs).reshape(nobs, 4)
        rest = np.loadtxt(f).ravel()
    if rest.size != 9 * ncams + 3 * npnts:
        raise ValueError(
            f"{path}: expected {9 * ncams + 3 * npnts} trailing values, "
            f"got {rest.size}")
    cam_idx = obs[:, 0].astype(np.int64)
    pnt_idx = obs[:, 1].astype(np.int64)
    pt2d = obs[:, 2:4]
    cams_file = rest[: 9 * ncams].reshape(ncams, 9)
    points = rest[9 * ncams:].reshape(npnts, 3)
    return cam_idx, pnt_idx, pt2d, cams_file, points


def read_bal(path: str, dtype=torch.float64, pad_obs_to: int = 128,
             name: str | None = None, device="cuda") -> BAProblem:
    """Read a BAL ``.txt`` / ``.txt.bz2`` file into a :class:`BAProblem`
    (``dtype`` a torch dtype or a name, e.g. ``"bfloat16"``)."""
    if NATIVE_BZ2 or not path.endswith(".bz2"):
        raw = parse_bal_native(path)
    else:
        raw = _read_raw(path)
    cam_idx, pnt_idx, pt2d, cams_file, points = raw
    # (r, t, f, k1, k2) -> (r, t, k1, k2, f)
    cams = np.concatenate(
        [cams_file[:, 0:6], cams_file[:, 7:9], cams_file[:, 6:7]], axis=1)
    if name is None:
        name = os.path.basename(path).replace(".txt", "").replace(".bz2", "")
    return BAProblem.from_arrays(cams, points, cam_idx, pnt_idx, pt2d,
                                 dtype=dtype, pad_obs_to=pad_obs_to,
                                 name=name, device=device)


def write_bal(path: str, problem: BAProblem) -> None:
    """Write a problem in BAL format, ``.bz2``-compressed when ``path``
    ends so, values as ``%.16e`` (the inverse of :func:`read_bal`; the
    JAX writer's format)."""
    n = problem.nobs
    cams = problem.cams.double().cpu().numpy()
    # internal (r, t, k1, k2, f) -> file (r, t, f, k1, k2)
    cams_file = np.concatenate(
        [cams[:, 0:6], cams[:, 8:9], cams[:, 6:8]], axis=1)
    points = problem.points.double().cpu().numpy()
    cam_idx = problem.cam_idx[:n].cpu().numpy()
    pnt_idx = problem.pnt_idx[:n].cpu().numpy()
    pt2d = problem.pt2d[:n].double().cpu().numpy()
    raw = bz2.open(path, "wt") if path.endswith(".bz2") else open(path, "w")
    with raw as f:
        f.write(f"{problem.ncams} {problem.npnts} {n}\n")
        for k in range(n):
            f.write(f"{cam_idx[k]} {pnt_idx[k]} "
                    f"{pt2d[k, 0]:.16e} {pt2d[k, 1]:.16e}\n")
        for c in cams_file:
            for v in c:
                f.write(f"{v:.16e}\n")
        for p in points:
            for v in p:
                f.write(f"{v:.16e}\n")


# The reference test suite's golden mini-problem: 5 cameras observing one
# point. ``x`` is points-first with cameras in the internal order
# (r, t, k1, k2, f); residual convention proj - pt2d.
_FIXTURE_X = [
    -0.6120001571722636, 0.5717590477602829, -1.8470812764548823,
    0.01574151594294026, -0.012790936163850642, -0.004400849808198079,
    -0.034093839577186584, -0.10751387104921525, 1.1202240291236032,
    -3.177064385280358e-7, 5.882049053459402e-13, 399.75152639358436,
    0.01597732412020533, -0.02522446458285646, -0.00940014164793023,
    -0.00856676614082241, -0.12188049069425422, 0.719013307500946,
    -3.7804765613385677e-7, 9.30743116838448e-13, 402.0175338595593,
    0.014846251175275622, -0.021062899405576294, -0.0011669480098224182,
    -0.024950970734443037, -0.11398470545726247, 0.9216602073702798,
    -3.2952646187978145e-7, 6.732885068879348e-13, 400.4017536835857,
    0.01991666998444233, -1.2243308199651954, 0.011998875602428538,
    -1.411897512312013, -0.11480651507716103, 0.44915582738113896,
    5.958750036132224e-8, -2.4839062920074967e-13, 407.0302456821108,
    0.02082242153136291, -1.238434791463721, 0.013893147632321344,
    -1.0496862247709429, -0.12995132856190453, 0.3379838023131856,
    4.5673126640998776e-8, -1.7924276184384984e-13, 405.9176496201471,
]
_FIXTURE_PT2D = [
    [-332.65, 262.09], [-199.76, 166.7], [-253.06, 202.27],
    [58.13, 271.89], [238.22, 237.37],
]
FIXTURE_TRUE_RESIDUALS = np.array([
    [-9.020226301243156, 11.263958304987227],
    [-1.833229714946924, 5.304698960898122],
    [-4.332321480806684, 7.117305031392988],
    [-0.5632751791502884, -1.062178017695942],
    [-3.96920595468427, -2.285071283095334],
])


def load_fixture(dtype=torch.float64, pad_obs_to: int = 8,
                 device="cuda") -> BAProblem:
    """The reference's 5-observation golden problem."""
    x = np.array(_FIXTURE_X, dtype=np.float64)
    points = x[:3].reshape(1, 3)
    cams = x[3:].reshape(5, 9)
    return BAProblem.from_arrays(
        cams, points, cam_idx=np.arange(5), pnt_idx=np.zeros(5, np.int64),
        pt2d=np.array(_FIXTURE_PT2D), dtype=dtype, pad_obs_to=pad_obs_to,
        name="fixture-5obs", device=device)
