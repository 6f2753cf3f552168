"""Time the port's kernels against the bytes they must move, on one card —
the counterpart of the JAX package's ``scripts/tpu_mv_sweep.py``.

    python -m bundleadjustment_jl_tpu_torch.mv_sweep

At synthetic Dubrovnik-356 (seed 1, as the TPU sweep builds it): the Schur
matvec of route A (K3) with W in float32 and in bfloat16, the
linearization (K7), K6's camera and point products over JR (cam90,
pnt12), and the whole assembly on routes A and C; then the streaming-read
probe (K9) with 0, 1 and 2 small rows at Dubrovnik-356's and Final-4585's
row counts, last, on a card the kernels have warmed. Every launch is
timed with CUDA events and the L2 flushed before it (``utils/timing.py``).
Each line gives ms, the least bytes (``bench.kernel_bytes``), GB/s, and
that rate's share of the H100's published 3.35 TB/s and of the probe's own
rate (nsmall = 0, same row count); the last line is all of it as one JSON
object. The TPU tile
constants the JAX sweep varied (``CHUNK_ROWS``, ``SEG_TILE``) have no
counterpart. A run that finds no card raises.
"""

from __future__ import annotations

import json

import torch

from bundleadjustment_jl_tpu_torch import bench

REPS = 20


def _probe_rows(n: int, nsmall: int):
    gen = torch.Generator(device="cuda").manual_seed(nsmall)
    rows = [torch.rand((32, n), generator=gen, device="cuda")]
    return tuple(rows + [torch.rand((n,), generator=gen, device="cuda")
                         for _ in range(nsmall)])


def sweep() -> dict:
    """Run the sweep; print one line per kernel and return them all."""
    bench.require_card()
    from bundleadjustment_jl_tpu_torch.ops import linearize as lz
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
    from bundleadjustment_jl_tpu_torch.ops.normal import assemble_blocks
    from bundleadjustment_jl_tpu_torch.ops.schur import (
        reduce_and_diag, schur_matvec)
    from bundleadjustment_jl_tpu_torch.ops.stream_probe import stream_probe
    from bundleadjustment_jl_tpu_torch.utils.timing import timed

    out = {"device": bench.card(), "lines": []}
    problem = bench.make_problem("dubrovnik356", seed=1)
    cams, points = problem.cams, problem.points
    lam = 1e2
    kernels = []

    def add(name, fn, args, nbytes):
        kernels.append((name, "dubrovnik356",
                        timed(fn, args, reps=REPS, flush_l2=True,
                              nbytes=nbytes), nbytes))

    for w_dtype, itemsize in ((torch.float32, 4), (torch.bfloat16, 2)):
        blocks = assemble_blocks(problem, route="fused", w_dtype=w_dtype)
        sys_, _ = reduce_and_diag(problem, blocks, lam)
        v = torch.ones_like(sys_.b)
        add(f"schur_matvec route A (K3) W {str(w_dtype)[6:]}", schur_matvec,
            (sys_, v), bench.kernel_bytes("matvec", problem, itemsize))
        del blocks, sys_
    JR_t, W_t = lz.linearize_w_kminor(problem, cams, points)
    JR_cam_t = JR_t[:, problem.cam_perm.long()]
    add("linearize (K7)", lz.linearize_w_kminor, (problem, cams, points),
        bench.kernel_bytes("linearize", problem))
    add("jtj_cam_reduce (K6 cam90)", sr.jtj_cam_reduce, (JR_cam_t, problem),
        bench.kernel_bytes("seg_prod_cam90", problem))
    add("jtj_pnt_reduce (K6 pnt12)", sr.jtj_pnt_reduce, (JR_t, problem),
        bench.kernel_bytes("seg_prod_pnt12", problem))
    del JR_t, W_t, JR_cam_t
    add("assemble route A (K1)",
        lambda c, p: assemble_blocks(problem, c, p, route="fused"),
        (cams, points), bench.kernel_bytes("assemble", problem))
    # Route C's assembly: K7, K6 pnt12 and cam90, and the two camera-sorted
    # copies; its least bytes are the problem in and the blocks (W, W_cam,
    # [Hpp | g_p], [Hcc | g_c]) out, as for K1 plus one more W.
    add("assemble route C (K7, K6, copies)",
        lambda c, p: assemble_blocks(problem, c, p, route="sorted"),
        (cams, points), bench.kernel_bytes("assemble", problem)
        + 27 * 4 * problem.nobs_pad)

    probe_gbs = {}
    probes = []
    for label in ("dubrovnik356", "final4585"):
        shape = bench.shape(label)
        for nsmall in (0, 1, 2):
            args = _probe_rows(shape.nobs_pad, nsmall)
            nbytes = bench.kernel_bytes("stream_probe", shape, nsmall=nsmall)
            t = timed(stream_probe, args, reps=REPS, flush_l2=True,
                      nbytes=nbytes)
            probe_gbs.setdefault(label, t.gbs)
            probes.append((f"stream_probe_nsmall{nsmall} {label}", label, t,
                           nbytes))
            del args

    for name, label, t, nbytes in kernels + probes:
        row = {"name": name, "problem": label, "ms": t.ms, "bytes": nbytes,
               "gbs": t.gbs, "of_peak": t.gbs / bench.PEAK_HBM_GBS,
               "of_probe": t.gbs / probe_gbs[label]}
        out["lines"].append(row)
        print(f"{name:<44} {t.ms:9.4f} ms {nbytes / 1e6:9.1f} MB "
              f"{t.gbs:8.1f} GB/s {row['of_peak']:6.3f} of 3.35 TB/s "
              f"{row['of_probe']:6.3f} of the probe", flush=True)
    return out


def main() -> None:
    out = sweep()
    print(f"card: {out['device']['nvidia_smi']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
