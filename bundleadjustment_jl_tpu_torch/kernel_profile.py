"""Device time of each CUDA kernel that K1 (the assembly) and K5's camera
direction launch, by kernel name, on one card.

    python -m bundleadjustment_jl_tpu_torch.kernel_profile

At synthetic Dubrovnik-356 and Final-4585 (``bench.make_problem``): K1 with
W in float32, and K5's camera direction over the camera-sorted W in
float32, bfloat16 and float16, each called :data:`REPS` times under
``torch.profiler`` after a warm-up; prints one JSON line per problem and
call with the device ms per call of each kernel it launched (the trace's
kernel events, ``route_profile.kernel_breakdown``) and the card's name and
power limit. A wrapper's passes are separate kernels, so this times them
apart: K1's point pass and its camera pass.

To compare two trees, run it from the root of each checkout and compare
the JSON lines; it uses only the wrappers' public calls, so a copy of this
file in an older tree's package times that tree too. A run that finds no
card raises.
"""

from __future__ import annotations

import json
import sys

import torch

from bundleadjustment_jl_tpu_torch import bench
from bundleadjustment_jl_tpu_torch.ops import _cuda
from bundleadjustment_jl_tpu_torch.route_profile import kernel_breakdown

REPS = 10


def device_ms(fn, tag: str, reps: int = REPS) -> dict:
    """``{kernel name: device ms per call}`` of ``fn()`` over ``reps``
    calls under ``torch.profiler``, after two unprofiled calls; the trace
    goes to the git-ignored kernel build directory as ``<tag>.json``."""
    from torch.profiler import ProfilerActivity, profile
    bench.require_card()
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = _cuda.BUILD_DIR / "kernel_profile"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{tag}.json"
    prof.export_chrome_trace(str(path))
    return {name: k["ms"] / reps
            for name, k in kernel_breakdown(path)["kernels"].items()}


def main() -> int:
    from bundleadjustment_jl_tpu_torch.ops import fused_assemble as fa
    from bundleadjustment_jl_tpu_torch.ops import seg_reduce as sr
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import narrow_w
    bench.require_card()
    card = bench.card()["nvidia_smi"]
    for name in ("dubrovnik356", "final4585"):
        p = bench.make_problem(name, 0)
        W = fa.assemble_scatter(p, p.cams, p.points)[0]
        line = {"problem": name, "card": card,
                "assemble@float32": device_ms(
                    lambda: fa.assemble_scatter(p, p.cams, p.points),
                    f"{name}_assemble")}
        gen = torch.Generator(device="cuda").manual_seed(0)
        t = torch.randn((p.npnts, 3), generator=gen, device="cuda")
        perm = p.cam_perm.long()
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            W_cam = narrow_w(W, dt)[:, perm].contiguous()
            line[f"seg_block_camera@{str(dt)[6:]}"] = device_ms(
                lambda: sr.wt_cam_reduce(W_cam, t, p),
                f"{name}_seg_block_camera_{str(dt)[6:]}")
            del W_cam
        print(json.dumps(line), flush=True)
        del p, W
    return 0


if __name__ == "__main__":
    sys.exit(main())
