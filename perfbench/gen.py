"""The benchmark's problem generator: a synthetic BAL problem and its
starting states, made from a seed on the device with a ``torch.Generator``.

The laws are those of the port's ``synthetic_bal`` (the JAX package's
recipe): points N(0, 1) in x and y and N(0, 0.3) in z; cameras at depth 6
with axis-angle N(0, 0.05), tx and ty N(0, 0.3), tz -6 + N(0, 0.3), k1
N(0, 1e-7), k2 N(0, 1e-13), f 400 + N(0, 20); each point seen by distinct
cameras drawn uniformly, camera p forced into point p's set for the first
``ncams`` points; image points the projection plus N(0, ``noise_px``)
noise. The configuration's ``nobs`` rows are spread as evenly as they go:
k = nobs // npnts cameras a point, and k + 1 for nobs mod npnts points
drawn from the seed, so the rows are exactly the source problem's. A start is the truth perturbed as the recipe
perturbs it: N(0, ``perturb``) on the rotation and translation and on
every point coordinate, and f scaled by 1 + N(0, ``perturb``).

The numbers are computed in float64 and handed over in the configuration's
working type: both the system under test and the reference get exactly
these arrays. The same seed on the same kind of device gives the same
arrays.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 22     # rows a block of the projection


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _randn(g, shape, device, scale=1.0):
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float64) * scale


def _has_dup(rows: torch.Tensor) -> torch.Tensor:
    s = torch.sort(rows, dim=1).values
    return (s[:, 1:] == s[:, :-1]).any(dim=1)


def distinct_cameras(g, npnts: int, ncams: int, k: int, device):
    """(npnts, k) camera ids, distinct in each row, uniform; camera p is
    in column 0 of row p for p < min(ncams, npnts)."""
    if k > ncams // 2 or ncams <= 8:
        rows = torch.argsort(torch.rand((npnts, ncams), generator=g,
                                        device=device), dim=1)[:, :k]
    else:
        rows = torch.randint(0, ncams, (npnts, k), generator=g,
                             device=device)
        dup = _has_dup(rows)
        while bool(dup.any()):
            idx = torch.nonzero(dup).squeeze(1)
            rows[idx] = torch.randint(0, ncams, (idx.numel(), k),
                                      generator=g, device=device)
            dup = _has_dup(rows)
    nf = min(ncams, npnts)
    forced = torch.arange(nf, device=device)
    rows[:nf, 0] = forced
    dup = _has_dup(rows[:nf])
    while bool(dup.any()):
        idx = torch.nonzero(dup).squeeze(1)
        # the other k - 1 cameras, uniform over all but the forced one
        other = torch.randint(0, ncams - 1, (idx.numel(), k - 1),
                              generator=g, device=device)
        rows[idx, 1:] = other + (other >= forced[idx, None]).long()
        dup = _has_dup(rows[:nf])
    return rows


def make(cfg: dict, nstarts: int, seed: int, device) -> dict:
    """The problem of configuration ``cfg`` (its sizes and ``nobs``,
    ``noise_px``, ``perturb``, ``dtype``) and ``nstarts`` starting states
    from ``seed``: ``cam_idx``, ``pnt_idx`` (int32, rows in point order),
    ``pt2d``, ``truth`` (cams, points) and ``starts``, a list of (cams,
    points), in the working type, on ``device``."""
    from perfbench.reference import project
    nc, npt, nobs = int(cfg["ncams"]), int(cfg["npnts"]), int(cfg["nobs"])
    k, extra = divmod(nobs, npt)
    kmax = k + (extra > 0)
    if k < 1 or kmax > nc:
        raise ValueError(f"{nobs} rows over {npt} points and {nc} cameras")
    dt = getattr(torch, cfg["dtype"])
    g = _generator(seed, device)
    points = _randn(g, (npt, 3), device) * torch.tensor(
        [1.0, 1.0, 0.3], dtype=torch.float64, device=device)
    cams = torch.zeros((nc, 9), dtype=torch.float64, device=device)
    cams[:, 0:3] = _randn(g, (nc, 3), device, 0.05)
    cams[:, 3:5] = _randn(g, (nc, 2), device, 0.3)
    cams[:, 5] = -6.0 + _randn(g, (nc,), device, 0.3)
    cams[:, 6] = _randn(g, (nc,), device, 1e-7)
    cams[:, 7] = _randn(g, (nc,), device, 1e-13)
    cams[:, 8] = 400.0 + _randn(g, (nc,), device, 20.0)

    rows = distinct_cameras(g, npt, nc, kmax, device)
    counts = torch.full((npt,), k, dtype=torch.long, device=device)
    counts[torch.argsort(torch.rand(npt, generator=g, device=device))[
        :extra]] += 1
    keep = torch.arange(kmax, device=device) < counts[:, None]
    cam_idx = rows[keep]
    pnt_idx = torch.arange(npt, device=device).repeat_interleave(counts)
    n = cam_idx.numel()
    pt2d = torch.empty((n, 2), dtype=dt, device=device)
    for lo in range(0, n, BLOCK):
        hi = min(lo + BLOCK, n)
        proj = project(cams[cam_idx[lo:hi]], points[pnt_idx[lo:hi]])
        noise = _randn(g, (hi - lo, 2), device, float(cfg["noise_px"]))
        pt2d[lo:hi] = (proj + noise).to(dt)
    perturb = float(cfg["perturb"])
    starts = []
    for _ in range(nstarts):
        c0 = cams.clone()
        c0[:, 0:6] += _randn(g, (nc, 6), device, perturb)
        c0[:, 8] *= 1.0 + _randn(g, (nc,), device, perturb)
        p0 = points + _randn(g, (npt, 3), device, perturb)
        starts.append((c0.to(dt), p0.to(dt)))
    return dict(cam_idx=cam_idx.to(torch.int32),
                pnt_idx=pnt_idx.to(torch.int32), pt2d=pt2d,
                truth=(cams, points), starts=starts)
