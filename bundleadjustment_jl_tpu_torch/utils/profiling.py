"""Phase timers and traces (PyTorch port of
`bundleadjustment_jl_tpu/utils/profiling.py`).

- :class:`PhaseTimers`: named wall-clock timers that accumulate over
  calls. PyTorch returns before the card finishes, so a phase given its
  result waits for the card (`utils/timing.py:sync`) before its clock
  stops, and the time lands on the phase that did the work. For the
  device time of a kernel use `utils/timing.py:timed` (CUDA events).
- :func:`trace`: ``torch.profiler`` around a block, written as a Chrome
  trace (``chrome://tracing`` or Perfetto): host operators and, on the
  card, each kernel with its device time.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Iterator

import torch

from bundleadjustment_jl_tpu_torch.utils.timing import sync as _sync


class PhaseTimers:
    """Wall time per named phase, accumulated over calls.

    >>> timers = PhaseTimers()
    >>> blocks = timers.timed("linearize", assemble_blocks,
    ...                       problem)          # doctest: +SKIP
    >>> print(timers.summary())                 # doctest: +SKIP
    """

    def __init__(self, sync: bool = True):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name: str, result=None) -> Iterator[None]:
        """Charge the block's wall time to ``name``; with ``sync`` and a
        ``result`` (tensors), first wait for the card to finish them."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and result is not None:
                _sync(result)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kwargs):
        """Run ``fn``, wait for its result (with ``sync``), charge the
        elapsed time to ``name``; returns the result."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.sync:
            _sync(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def summary(self) -> str:
        """A table of the phases, most time first: total seconds, calls,
        mean milliseconds and share of the total."""
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        total = sum(self.totals.values()) or 1.0
        lines = [f"{'phase':<24} {'total s':>10} {'calls':>7} "
                 f"{'mean ms':>9} {'%':>6}"]
        for name, t in rows:
            n = self.counts[name]
            lines.append(f"{name:<24} {t:10.3f} {n:7d} "
                         f"{1e3 * t / n:9.3f} {100 * t / total:6.1f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block (the card's kernels too, when one
    is present), written to ``<log_dir>/trace.json`` as a Chrome trace;
    yields the profiler (``key_averages()`` for a table)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
