"""Streaming-read probe (K9) — the counterpart of the TPU DMA probe
`scripts/tpu_mv_sweep.py:dma_probe`.

``stream_probe(big, *small)`` sums a (32, n) float32 array and 0-2 float32
rows of length n: ``out[r] = sum_j big[r, j] + sum over the small rows``,
(32,). Its bytes, ``(32 + nsmall) * 4 * n``, over its time on the card are
the rate the card streams device memory at: the denominator that
``mv_sweep.py`` of this package holds each kernel against, measured on the
card rather than taken from a data sheet.

Same device rule as `ops/fused_assemble.py`: CUDA float32 tensors launch
the hand-written kernel (``csrc/stream_probe.cu``), CPU tensors take the
plain PyTorch version beside it, anything else raises.
"""

from __future__ import annotations

import torch

from bundleadjustment_jl_tpu_torch.ops import _cuda

ROWS = 32


def stream_probe(big: torch.Tensor, *small: torch.Tensor) -> torch.Tensor:
    """``big.sum(1) + sum of every small row's entries`` -> (32,);
    ``big`` (32, n), each of the 0-2 ``small`` rows (n,) or (1, n)."""
    if len(small) > 2:
        raise ValueError(f"at most two small rows, got {len(small)}")
    if not big.is_cuda:
        return _stream_probe_plain(big, *small)
    n = big.shape[-1]
    _cuda.require(big, "big", torch.float32, (ROWS, n))
    rows = [s.reshape(-1) for s in small]
    for i, s in enumerate(rows):
        _cuda.require(s, f"small[{i}]", torch.float32, (n,))
    so = _cuda.lib()
    vec = int(n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (big, *rows)))
    part = torch.empty(((ROWS + len(rows)) * so.ba_stream_probe_blocks(n),),
                       dtype=torch.float32, device=big.device)
    out = torch.empty((ROWS,), dtype=torch.float32, device=big.device)
    s1, s2 = (rows + [None, None])[:2]
    rc = so.ba_stream_probe(_cuda.ptr(big), _cuda.ptr(s1), _cuda.ptr(s2),
                            len(rows), n, vec, _cuda.ptr(part),
                            _cuda.ptr(out), _cuda.stream())
    _cuda.check(rc, "ba_stream_probe")
    _cuda.launched("stream_probe")
    return out


def _stream_probe_plain(big: torch.Tensor, *small: torch.Tensor):
    """Plain version of :func:`stream_probe`, in the TPU probe's order:
    the small rows added to every row of ``big``, then each row summed."""
    x = big
    for s in small:
        x = x + s.reshape(1, -1)
    return x.sum(dim=1)
