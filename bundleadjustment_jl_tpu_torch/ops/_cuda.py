"""Build, load and launch the package's CUDA kernels.

The sources are ``bundleadjustment_jl_tpu_torch/csrc/*.cu`` (plain C entry
points, no PyTorch headers). At first use they are compiled with ``nvcc``
for Hopper (``sm_90a``) into ``_build/<source hash>/libba_kernels.so`` and
loaded with ctypes; a changed source gets a new hash and a fresh build.
There is no fallback: without ``nvcc``, or when the compiler fails, the
loader raises with the compiler's output.

Each kernel wrapper (``ops/fused_assemble.py``, ``ops/fused_schur.py``)
counts its launches in :data:`LAUNCHES` — one per wrapper call that
launches the kernel — so a run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libba_kernels.so"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
# Not --use_fast_math: the chain's sqrtf / sincosf / divides stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"assemble": 0, "cam_reduce": 0, "matvec": 0, "objective": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(NVCC_DEFAULT) if NVCC_DEFAULT.exists() else None


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (once per source
    hash) and return its path. The compiler's output, including
    ``-Xptxas -v``'s register and spill report, is kept in ``build.log``
    beside it."""
    out_dir = BUILD_DIR / source_hash()
    out = out_dir / LIB_NAME
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of bundleadjustment_jl_tpu_torch cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
_SIGNATURES = {
    "ba_assemble": [_P] * 9 + [_I, _I, _I64] + [_P] * 6,
    "ba_cam_reduce_wcw_rhs": [_P] * 6 + [_I, _I64, _P, _P],
    "ba_matvec": [_P] * 9 + [_F, _I, _I, _I64, _P, _P, _P],
    "ba_objective": [_P] * 6 + [_I, _I, _I, _I64, _P, _P, _P],
}


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    so = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    so.ba_objective_blocks.argtypes = [_I64]
    so.ba_objective_blocks.restype = ctypes.c_int64
    so.ba_error_string.argtypes = [_I]
    so.ba_error_string.restype = ctypes.c_char_p
    return so


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().ba_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple | None = None) -> None:
    """Validate a kernel operand: on CUDA, of ``dtype``, contiguous, and
    (when given) of ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernels take {dtype}, got "
                        f"{t.dtype} (float64 runs on the CPU path only)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def require_problem(problem) -> None:
    """Validate the problem arrays every kernel reads."""
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    require(problem.pt2d, "pt2d", torch.float32, (n, 2))
    require(problem.w, "w", torch.float32, (n,))
    for name, size in (("cam_idx", n), ("pnt_idx", n), ("cam_perm", n),
                       ("pnt_starts", npt + 1), ("cam_starts", nc + 1)):
        require(getattr(problem, name), name, torch.int32, (size,))
