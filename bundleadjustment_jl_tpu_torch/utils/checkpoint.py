"""Solver checkpoint / resume (PyTorch port of
`bundleadjustment_jl_tpu/utils/checkpoint.py`).

The LM state (cams, points, lambda, iteration and a JSON ``meta``) goes to
one ``.npz`` file per checkpoint, written atomically (a temporary file in
the same directory, then a rename). A :class:`CheckpointManager` writes
``step-<n>.npz`` files and keeps the newest ``keep``. The format is the JAX
package's, key for key, so each package resumes from the other's
checkpoints; tensors cross as ``.detach().cpu().numpy()``.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, cams, points, *, lam: float = 0.0,
                    iteration: int = 0, meta: Optional[dict] = None) -> None:
    """Atomically write one checkpoint file."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    payload = {
        "cams": _host(cams),
        "points": _host(points),
        "lam": np.asarray(lam, np.float64),
        "iteration": np.asarray(iteration, np.int64),
        "meta_json": np.asarray(json.dumps(meta or {})),
    }
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> dict:
    """``{"cams", "points"}`` as numpy arrays, ``"lam"`` (float),
    ``"iteration"`` (int) and ``"meta"`` (dict)."""
    with np.load(path, allow_pickle=False) as z:
        return {
            "cams": z["cams"],
            "points": z["points"],
            "lam": float(z["lam"]),
            "iteration": int(z["iteration"]),
            "meta": json.loads(str(z["meta_json"])),
        }


def _steps(directory: str) -> dict:
    """``{n: file name}`` of the ``step-<n>.npz`` files in ``directory``."""
    out = {}
    for f in os.listdir(directory):
        if f.startswith("step-") and f.endswith(".npz"):
            try:
                out[int(f[5:-4])] = f
            except ValueError:
                continue
    return out


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest ``step-<n>.npz`` in a checkpoint directory (by step number)."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return os.path.join(directory, steps[max(steps)]) if steps else None


class CheckpointManager:
    """Rotating checkpoints: save every ``every`` iterations, keep ``keep``."""

    def __init__(self, directory: str, every: int = 10, keep: int = 3):
        self.directory = directory
        self.every = max(1, every)
        self.keep = max(1, keep)
        os.makedirs(directory, exist_ok=True)

    def due(self, iteration: int) -> bool:
        """Whether :meth:`maybe_save` writes at ``iteration``."""
        return iteration % self.every == 0

    def maybe_save(self, iteration: int, cams, points, *, lam: float = 0.0,
                   meta: Optional[dict] = None) -> Optional[str]:
        if not self.due(iteration):
            return None
        path = os.path.join(self.directory, f"step-{iteration}.npz")
        save_checkpoint(path, cams, points, lam=lam, iteration=iteration,
                        meta=meta)
        self._rotate()
        return path

    def _rotate(self) -> None:
        steps = _steps(self.directory)
        for n in sorted(steps)[:-self.keep]:
            os.unlink(os.path.join(self.directory, steps[n]))

    def restore_latest(self) -> Optional[dict]:
        path = latest_checkpoint(self.directory)
        return load_checkpoint(path) if path else None
