"""Bundle-adjustment problem container (PyTorch port of
`bundleadjustment_jl_tpu/models/problem.py`).

Structure-of-arrays with padded shapes, exactly the JAX layout:

- ``cams``    (ncams, 9)  camera params ``(rx,ry,rz,tx,ty,tz,k1,k2,f)``
- ``points``  (npnts, 3)  world points
- ``cam_idx`` (nobs_pad,) int32 camera index per observation
- ``pnt_idx`` (nobs_pad,) int32 point index per observation
- ``pt2d``    (nobs_pad, 2) observed image points
- ``w``       (nobs_pad,) observation weight; 0 marks padding

Rows are sorted by point id (stable). Padding rows carry the largest ids
(``ncams-1``, ``npnts-1``) and ``w = 0``, so they fall inside the last
point's segment and contribute exact zeros. ``pnt_starts`` (npnts+1,)
delimits the point segments; ``cam_perm`` (nobs_pad,) lists the rows in
camera order and ``cam_starts`` (ncams+1,) delimits the camera segments of
that order. The rows are always point-sorted here, so the JAX field
``pnt_perm`` has no counterpart. ``plans`` holds the kernels' launch plans
(`ops/plans.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def np_dtype(dtype) -> np.dtype:
    """numpy dtype for a torch or numpy float dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(_NP_DTYPES[dtype])
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype for a torch or numpy float dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(v): k for k, v in _NP_DTYPES.items()}[np.dtype(dtype)]


def make_starts(seg_ids, num_segments: int, total: int) -> np.ndarray:
    """Host-side starts array (nseg+1,) for rows sorted by ``seg_ids``
    (`ops/segsum.py:make_starts` of the JAX package). ``total`` is the
    padded row count; trailing padding rows carry segment id
    ``num_segments - 1``."""
    ids = np.asarray(seg_ids)
    starts = np.searchsorted(ids, np.arange(num_segments + 1)).astype(
        np.int32)
    starts[-1] = total
    return starts


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class BAProblem:
    cams: torch.Tensor        # (ncams, 9)
    points: torch.Tensor      # (npnts, 3)
    cam_idx: torch.Tensor     # (nobs_pad,) int32
    pnt_idx: torch.Tensor     # (nobs_pad,) int32
    pt2d: torch.Tensor        # (nobs_pad, 2)
    w: torch.Tensor           # (nobs_pad,)
    nobs: int                 # true (unpadded) observation count
    pnt_starts: torch.Tensor  # (npnts+1,) int32
    cam_perm: torch.Tensor    # (nobs_pad,) int32
    cam_starts: torch.Tensor  # (ncams+1,) int32
    name: str = "ba"
    # Kernel launch plans built from the index arrays at first use
    # (`ops/plans.py`), kept here so a solve builds each once. `astype` and
    # `with_state` keep the index arrays and share this dict; a problem
    # built with new indices starts with an empty one.
    plans: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    # Fields :meth:`from_numpy` reads; each is ``np.asarray`` of the JAX
    # problem attribute of the same name.
    FIELDS = ("cams", "points", "cam_idx", "pnt_idx", "pt2d", "w",
              "pnt_starts", "cam_perm", "cam_starts", "nobs")

    # ----- construction ----------------------------------------------------
    @classmethod
    def from_arrays(cls, cams, points, cam_idx, pnt_idx, pt2d,
                    dtype=torch.float64, pad_obs_to: int = 128,
                    name: str = "ba", device="cuda") -> "BAProblem":
        """Build a padded, point-sorted problem from host arrays (0-based
        indices), as `BAProblem.from_arrays` of the JAX package does."""
        ndt = np_dtype(dtype)
        cams = np.asarray(cams, dtype=ndt).reshape(-1, 9)
        points = np.asarray(points, dtype=ndt).reshape(-1, 3)
        cam_idx = np.asarray(cam_idx, dtype=np.int32).ravel()
        pnt_idx = np.asarray(pnt_idx, dtype=np.int32).ravel()
        pt2d = np.asarray(pt2d, dtype=ndt).reshape(-1, 2)
        nobs = cam_idx.shape[0]
        if not (pnt_idx.shape[0] == nobs and pt2d.shape[0] == nobs):
            raise ValueError("inconsistent observation arrays")
        if nobs and (cam_idx.max() >= cams.shape[0]
                     or pnt_idx.max() >= points.shape[0]):
            raise ValueError("observation index out of range")
        ncams, npnts = cams.shape[0], points.shape[0]
        order = np.argsort(pnt_idx, kind="stable")
        cam_idx = np.take(cam_idx, order)
        pnt_idx = np.take(pnt_idx, order)
        pt2d = np.take(pt2d, order, axis=0)

        npad = _round_up(max(nobs, 1), pad_obs_to)
        w = np.zeros((npad,), dtype=ndt)
        w[:nobs] = 1.0
        ci = np.full((npad,), max(ncams - 1, 0), dtype=np.int32)
        pi = np.full((npad,), max(npnts - 1, 0), dtype=np.int32)
        xy = np.zeros((npad, 2), dtype=ndt)
        ci[:nobs] = cam_idx
        pi[:nobs] = pnt_idx
        xy[:nobs] = pt2d

        pnt_starts = make_starts(pi, npnts, npad)
        cam_perm = np.argsort(ci, kind="stable").astype(np.int32)
        cam_starts = make_starts(np.take(ci, cam_perm), ncams, npad)
        return cls.from_numpy(
            dict(cams=cams, points=points, cam_idx=ci, pnt_idx=pi,
                 pt2d=xy, w=w, pnt_starts=pnt_starts, cam_perm=cam_perm,
                 cam_starts=cam_starts, nobs=nobs, name=name),
            device=device)

    @classmethod
    def from_numpy(cls, fields: Mapping[str, Any], device="cuda",
                   dtype=None) -> "BAProblem":
        """A problem from numpy arrays in the sorted, padded layout —
        e.g. ``{k: np.asarray(getattr(jax_problem, k)) for k in
        BAProblem.FIELDS}``. ``cams``/``points`` carry the state. Float
        fields take ``dtype`` (default: that of ``cams``)."""
        fdt = torch_dtype(dtype if dtype is not None
                          else np.asarray(fields["cams"]).dtype)

        def f(name):
            return torch.tensor(np.asarray(fields[name]), dtype=fdt,
                                device=device)

        def i(name):
            return torch.tensor(np.asarray(fields[name], dtype=np.int32),
                                device=device)

        name = fields.get("name", "ba")
        return cls(cams=f("cams").reshape(-1, 9),
                   points=f("points").reshape(-1, 3),
                   cam_idx=i("cam_idx"), pnt_idx=i("pnt_idx"),
                   pt2d=f("pt2d").reshape(-1, 2), w=f("w"),
                   nobs=int(np.asarray(fields["nobs"])),
                   pnt_starts=i("pnt_starts"), cam_perm=i("cam_perm"),
                   cam_starts=i("cam_starts"),
                   name=str(np.asarray(name)))

    # ----- sizes ------------------------------------------------------------
    @property
    def ncams(self) -> int:
        return self.cams.shape[0]

    @property
    def npnts(self) -> int:
        return self.points.shape[0]

    @property
    def nobs_pad(self) -> int:
        return self.cam_idx.shape[0]

    @property
    def nvar(self) -> int:
        """9*ncams + 3*npnts (`BALNLPModels.jl:95`)."""
        return 9 * self.ncams + 3 * self.npnts

    @property
    def nequ(self) -> int:
        """2*nobs (`BALNLPModels.jl:97`)."""
        return 2 * self.nobs

    @property
    def dtype(self) -> torch.dtype:
        return self.cams.dtype

    def _with_floats(self, cams, points, pt2d, w) -> "BAProblem":
        """This problem with new float arrays and the same index arrays, so
        the copy shares ``plans`` (they depend only on the indices)."""
        return dataclasses.replace(self, cams=cams, points=points, pt2d=pt2d,
                                   w=w, plans=self.plans)

    def astype(self, dtype) -> "BAProblem":
        dt = torch_dtype(dtype)
        return self._with_floats(self.cams.to(dt), self.points.to(dt),
                                 self.pt2d.to(dt), self.w.to(dt))

    # ----- state <-> reference flat layout ----------------------------------
    def state(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.cams, self.points

    def with_state(self, cams, points) -> "BAProblem":
        return self._with_floats(cams, points, self.pt2d, self.w)

    def flatten_state(self, cams=None, points=None) -> torch.Tensor:
        """Flat vector in the reference's points-first layout
        (`ReadFiles.jl:29-30`): ``[X_1..X_npnts, C_1..C_ncams]``."""
        cams = self.cams if cams is None else cams
        points = self.points if points is None else points
        return torch.cat([points.reshape(-1), cams.reshape(-1)])

    def unflatten_state(self, x: torch.Tensor):
        np3 = 3 * self.npnts
        return x[np3:].reshape(self.ncams, 9), x[:np3].reshape(self.npnts, 3)
