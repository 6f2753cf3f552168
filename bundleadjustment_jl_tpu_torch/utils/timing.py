"""CUDA-event timing of work on one card — the counterpart of the JAX
package's `scripts/_bench_util.py:timed`.

PyTorch returns before the card finishes, so a time is read from CUDA
events recorded around a window of launches, after a warm-up and a
``torch.cuda.synchronize()``; the host enqueues the window ahead of the
card, so no launch waits for Python. With ``flush_l2`` a 64 MB read (more
than the H100's 50 MB L2) precedes each launch, so each finds its operands
in device memory, as a caller that streamed other data in between would:
the window of reads and launches less a window of the reads alone, over
the launches. A read, not a write: a 64 MB write leaves the L2 full of
dirty lines whose write-back the timed launch then pays. A measurement
that finds no card raises: it never falls back to the CPU.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

L2_FLUSH_BYTES = 64 << 20
WARMUP = 2                # launches before the timed window


class Timing(NamedTuple):
    ms: float                 # mean per launch
    gbs: float | None         # nbytes / time, when nbytes was given


def timed(fn: Callable, args: tuple = (), *, reps: int = 20,
          flush_l2: bool = False, nbytes: int | None = None) -> Timing:
    """Time ``fn(*args)`` on the card: the mean of ``reps`` launches after
    :data:`WARMUP` ones; ``nbytes`` (the least bytes one launch moves) gives
    its rate in GB/s. ``args`` must hold CUDA tensors."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or not all(t.is_cuda for t in tensors):
        raise ValueError("timed: the arguments must include CUDA tensors, "
                         "and all of them must be on the card")
    dev = tensors[0].device
    scratch = (torch.zeros((L2_FLUSH_BYTES // 4,), dtype=torch.float32,
                           device=dev) if flush_l2 else None)
    # The warm-up runs the flush too: the first launch of a kernel loads
    # its module (CUDA's lazy loading), milliseconds that no window may
    # hold.
    for _ in range(WARMUP):
        if scratch is not None:
            scratch.sum()
        fn(*args)
    torch.cuda.synchronize(dev)

    def window(launch: bool) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            if scratch is not None:
                scratch.sum()
            if launch:
                fn(*args)
        stop.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(stop)

    ms = window(True) / reps
    if scratch is not None:
        ms -= window(False) / reps
    return Timing(ms=ms, gbs=None if nbytes is None
                  else nbytes / (ms * 1e-3) / 1e9)

