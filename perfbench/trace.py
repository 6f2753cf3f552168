"""Reduction of a ``torch.profiler`` Chrome trace to what the per-layer
metrics read: the device's busy time inside the traced window (the union
of the intervals in which a kernel, copy or fill ran), the window's
length, device time by operation name, and the idle gaps labelled by the
host operation that was running in them.

The window is the host annotation :data:`WINDOW` that the driver puts
around the traced solves, so the idle share counts every gap from its
first instant to its last, not only those between the first and the last
kernel.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from pathlib import Path

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 160


def short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS]


def kernel_base(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template arguments and parameters:
    ``void (anonymous namespace)::ba_x<float, 0>(int)`` -> ``ba_x``."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    while True:
        cut = re.sub(r"<[^<>]*>", "", head)
        if cut == head:
            break
        head = cut
    return head.split("<")[0].strip().split(" ")[-1].split("::")[-1]


def union(intervals, lo: float, hi: float):
    """The merged intervals of ``intervals`` ((start, end) pairs) clipped
    to [lo, hi], in order."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(host, starts, t: float) -> str:
    """The innermost host operation running at ``t``: the latest-starting
    one that still covers it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 400, -1), -1):
        s, e, name = host[j]
        if e > t:
            return name
    return "no host op"


def reduce_events(events: list) -> dict:
    """``busy_s``, ``window_s``, device seconds by operation name
    (``ops``: name -> [seconds, count]) and idle seconds by the host
    operation running in each gap (``idle``: label -> seconds) of the
    events of one trace, inside its :data:`WINDOW` annotation (the whole
    trace if there is none)."""
    dev, host, windows = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, e_end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((s, e_end, e.get("name", "")))
        elif cat == "cpu_op":
            host.append((s, e_end, e.get("name", "")))
        elif e.get("name") == WINDOW and cat == "user_annotation":
            windows.append((s, e_end))
    if windows:
        lo, hi = min(w[0] for w in windows), max(w[1] for w in windows)
    else:
        spans = [(s, e) for s, e, _ in dev + host]
        lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    ops = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        if e > lo and s < hi:
            ops[name][0] += (min(e, hi) - max(s, lo)) / 1e6
            ops[name][1] += 1
    merged = union([(s, e) for s, e, _ in dev], lo, hi)
    busy = sum(e - s for s, e in merged)
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            idle[_label(host, starts, 0.5 * (a + b))] += (b - a) / 1e6
    return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
            "ops": dict(ops), "idle": dict(idle)}


def reduce_file(path: Path) -> dict:
    return reduce_events(json.loads(Path(path).read_text())["traceEvents"])


def breakdown(red: dict) -> dict:
    """The result line's ``breakdown``: the :data:`TOP` device operations
    by time and the :data:`TOP` host operations by the idle time they
    stood in, ``[name, seconds]`` each."""
    ops = sorted(red["ops"].items(), key=lambda kv: -kv[1][0])[:TOP]
    idle = sorted(red["idle"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[short(k), v[0]] for k, v in ops],
            "idle_gaps": [[short(k), v] for k, v in idle]}
