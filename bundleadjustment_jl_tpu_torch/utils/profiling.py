"""Spans, a host-read counter and traces (the port's tracing).

- :func:`span`: a named ``torch.profiler.record_function`` annotation
  while a profiler records, one shared null context otherwise (no
  ``record_function`` entered: a flag read). Spans carry no clock and take
  no synchronize: the profiler keeps them beside the kernels, on its own
  clock, and writes them when it exports. They nest. The solvers open them
  at the stages of an LM solve (ROADMAP's seven): ``ba.solve`` around a
  call of a jit driver (its own time is stage 7, the lambda schedule and
  the stop tests), ``ba.linearize`` (1), ``ba.reduce`` (2-3), ``ba.pcg``
  (4, whichever step solver; inside it the dense step's
  ``ba.dense.assemble``, S, and ``ba.dense.factor``, its Cholesky and
  triangular solves), ``ba.backsub`` (5), ``ba.trial`` (6); and
  ``ba.plan.<key>`` around each launch plan built (`ops/plans.py`).
- :data:`COUNTERS`: ``host_reads``, each device value a solve reads into
  the host (:func:`host_read`): a ``bool()``, ``int()`` or copy to the
  host, or an op whose output size is a device value (``nonzero``,
  ``unique``) and so waits for it. Counted where the read happens, on the
  CPU as on the card; :func:`reset_counters` zeroes it.
  `solver/lm_jit.py:expected_host_reads` gives a solve's count from its
  decisions.
- :func:`trace`: ``torch.profiler`` around a block, written as a Chrome
  trace (``chrome://tracing`` or Perfetto): host operators, the spans and,
  on the card, each kernel with its device time.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

_OFF = contextlib.nullcontext()

COUNTERS = {"host_reads": 0}


def span(name: str):
    """A context manager that marks its block as ``name`` in the trace of a
    recording profiler; with none recording, the shared null context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def host_read(value):
    """Count one read of a device value into the host; returns ``value``
    (the caller reads it: ``bool(host_read(flag))``)."""
    COUNTERS["host_reads"] += 1
    return value


def reset_counters() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0


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
