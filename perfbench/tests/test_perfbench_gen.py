"""The device generator's laws, on the CPU at a tiny size."""

from __future__ import annotations

import pytest
import torch

from perfbench import gen
from perfbench.reference import project

# 6 cameras a point, 7 for 1,234 of the 3,000 points
CFG = dict(ncams=40, npnts=3000, nobs=3000 * 6 + 1234, dtype="float64",
           noise_px=1.0, perturb=2e-2)


def _tracks(d, npnts):
    """Each point's camera ids, in row order."""
    pnt = d["pnt_idx"].long()
    assert torch.equal(pnt, torch.sort(pnt).values)
    counts = torch.bincount(pnt, minlength=npnts)
    return list(torch.split(d["cam_idx"].long(), counts.tolist())), counts


def test_tracks_are_distinct_and_cover_every_camera():
    d = gen.make(CFG, 2, 2**31 + 11, "cpu")
    tracks, counts = _tracks(d, CFG["npnts"])
    assert d["cam_idx"].numel() == CFG["nobs"]
    assert int((counts == 7).sum()) == 1234
    assert int((counts == 6).sum()) == 3000 - 1234
    for t in tracks:
        assert t.unique().numel() == t.numel()
    assert [int(t[0]) for t in tracks[:CFG["ncams"]]] == list(
        range(CFG["ncams"]))
    # uniform cameras: every camera's count near nobs / ncams
    cams = torch.bincount(d["cam_idx"].long(), minlength=CFG["ncams"])
    mean = CFG["nobs"] / CFG["ncams"]
    assert (cams - mean).abs().max() < 6 * mean ** 0.5
    # the long tracks are spread over the points, not gathered at one end
    long = (counts == 7).nonzero().squeeze(1).float()
    assert abs(long.mean().item() / CFG["npnts"] - 0.5) < 0.05
    other = gen.make(CFG, 2, 2**31 + 12, "cpu")
    assert not torch.equal(counts, _tracks(other, CFG["npnts"])[1])


def test_refuses_rows_the_cameras_cannot_hold():
    for nobs in (CFG["npnts"] - 1, CFG["npnts"] * CFG["ncams"] + 1):
        with pytest.raises(ValueError):
            gen.make(dict(CFG, nobs=nobs), 1, 3, "cpu")


def test_laws_of_cameras_points_noise_and_starts():
    d = gen.make(CFG, 3, 5, "cpu")
    cams, points = d["truth"]
    assert abs(points[:, 2].std().item() - 0.3) < 0.03
    assert abs(points[:, 0].std().item() - 1.0) < 0.08
    assert abs(cams[:, 8].mean().item() - 400.0) < 12.0
    assert abs(cams[:, 5].mean().item() + 6.0) < 0.2
    proj = project(cams[d["cam_idx"].long()], points[d["pnt_idx"].long()])
    noise = d["pt2d"] - proj
    assert abs(noise.std().item() - 1.0) < 0.03
    assert abs(noise.mean().item()) < 0.03
    for c0, p0 in d["starts"]:
        dp = p0 - points
        assert abs(dp.std().item() - 2e-2) < 2e-3
        assert torch.equal(c0[:, 6:8], cams[:, 6:8])
        rel_f = c0[:, 8] / cams[:, 8] - 1.0
        assert abs(rel_f.std().item() - 2e-2) < 8e-3
    assert not torch.equal(d["starts"][0][1], d["starts"][1][1])


def test_same_seed_same_arrays():
    a, b = gen.make(CFG, 2, 77, "cpu"), gen.make(CFG, 2, 77, "cpu")
    c = gen.make(CFG, 2, 78, "cpu")
    assert torch.equal(a["pt2d"], b["pt2d"])
    assert torch.equal(a["cam_idx"], b["cam_idx"])
    assert torch.equal(a["starts"][1][0], b["starts"][1][0])
    assert not torch.equal(a["pt2d"], c["pt2d"])


def test_dense_tracks_and_working_type():
    cfg = dict(CFG, ncams=8, npnts=50, nobs=50 * 6, dtype="float32")
    d = gen.make(cfg, 1, 3, "cpu")
    tracks, counts = _tracks(d, cfg["npnts"])
    assert (counts == 6).all()
    for t in tracks:
        assert t.unique().numel() == 6
    assert d["pt2d"].dtype == torch.float32
    assert d["starts"][0][0].dtype == torch.float32
