"""The closed loop of solves (`perfbench/drivers/closed_loop.py`) checked
against the configuration's own reference.

The loop, the set-up, the window, its spans and counts, and the sampled
check are ``closed_loop``'s, run from a copy of that module made for this
run (so that nothing set here reaches another run or another cell), in
which the check solves with the ``Reference`` of the file the
configuration's ``reference`` key names (a plain PyTorch solver under
``perfbench/``, such as `perfbench/reference_dense.py`), where
``closed_loop`` takes `perfbench/reference.py`'s.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from perfbench import spec

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
    """``closed_loop.run`` of ``cell`` with the configuration's
    reference."""
    loop = spec.load_driver("closed_loop")
    loop.Reference = reference_class(cell.config)
    return loop.run(cell, seed, seconds, trace, device, t0, out_dir,
                    variant=variant, warmup=warmup)
