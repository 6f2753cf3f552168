"""The harness on the card, at the tiny size: a run is correct, and the
control (the system's bfloat16 working type) is not. Marked ``cuda``;
each test skips when there is no card."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import run as runner
from perfbench.drivers import closed_loop

from conftest import ROOT


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.cuda
def test_card_run_is_correct(tiny):
    _need_card()
    cell, _ = tiny
    line = runner.measure(cell, 2**31 + 5, 1.0, True, "cuda",
                          time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    assert line["metrics"]["ba_kernel_ms"]["value"] > 0


@pytest.mark.cuda
def test_card_control_is_not_correct(tiny):
    _need_card()
    cell, _ = tiny
    for seed in (1, 2, 3):
        out = closed_loop.run(cell, seed, 0.0, False, "cuda",
                              time.perf_counter(), ROOT / "perfbench" / "out",
                              variant="control", warmup=False)
        assert not all(out["numbers"][k] <= lim
                       for k, lim in cell.cell["limits"].items())
