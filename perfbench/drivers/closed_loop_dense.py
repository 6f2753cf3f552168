"""The closed loop of solves (`perfbench/drivers/closed_loop.py`) checked
against the configuration's own reference, with the traced window's
stages kept.

The loop, the set-up, the window and the sampled check are
``closed_loop``'s, run from a copy of that module made for this run (so
that nothing set here reaches another run or another cell), with two
things set in the copy:

- the check solves with the ``Reference`` of the file the configuration's
  ``reference`` key names (a plain PyTorch solver under ``perfbench/``,
  such as `perfbench/reference_dense.py`), where ``closed_loop`` takes
  `perfbench/reference.py`'s;
- the traced window's Chrome trace is also reduced by the port's spans
  (`perfbench/spans.py:reduce_file`) before ``closed_loop`` deletes it:
  the run's ``spans``, which the stage metrics read (None without a trace;
  a program without spans charges everything to ``unattributed``).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from perfbench import spans, spec

ROOT = Path(__file__).resolve().parents[2]


def reference_class(cfg: dict):
    """The ``Reference`` of the file ``cfg["reference"]`` (a path from the
    root of the checkout)."""
    path = ROOT / cfg["reference"]
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_reference_" + path.stem, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.Reference


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, out_dir: Path, variant: str = "sut",
        warmup: bool = True) -> dict:
    """``closed_loop.run`` of ``cell`` with the configuration's reference;
    the result has ``spans`` too."""
    loop = spec.load_driver("closed_loop")
    loop.Reference = reference_class(cell.config)
    kept = {}
    reduce_trace = loop.reduce_file

    def reduce_both(path):
        kept["spans"] = spans.reduce_file(path)
        return reduce_trace(path)

    loop.reduce_file = reduce_both
    out = loop.run(cell, seed, seconds, trace, device, t0, out_dir,
                   variant=variant, warmup=warmup)
    out["spans"] = kept.get("spans")
    return out
