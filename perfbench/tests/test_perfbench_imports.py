"""What a run loads: never JAX nor the JAX package (top-level names
compared whole), and the reference nothing of the system under test."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

PROBE = """
import json, sys, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_system():
    mods = _loaded("import perfbench.reference, perfbench.gen, "
                   "perfbench.judge, perfbench.yardstick, perfbench.trace")
    assert not mods & {"jax", "jaxlib", "flax", "bundleadjustment_jl_tpu",
                       "bundleadjustment_jl_tpu_torch"}


def test_a_run_loads_no_jax():
    body = """
from conftest import add_tiny
import tempfile, pathlib
from perfbench import run, spec
d = pathlib.Path(tempfile.mkdtemp())
path = add_tiny(d)
cell = spec.load_cell('tiny.pcg', path, d / 'perfbench')
line = run.measure(cell, 5, 0.0, True, 'cpu', time.perf_counter())
assert line['correct'], line
assert run.forbidden_modules() == []
"""
    mods = _loaded(f"sys.path.insert(0, {str(ROOT / 'perfbench' / 'tests')!r})"
                   + body)
    assert "bundleadjustment_jl_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "bundleadjustment_jl_tpu"}
