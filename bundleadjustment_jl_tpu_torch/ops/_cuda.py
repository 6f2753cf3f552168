"""Build, load and launch the package's CUDA kernels.

The sources are ``bundleadjustment_jl_tpu_torch/csrc/*.cu`` (plain C entry
points, no PyTorch headers). At first use each is compiled with ``nvcc``
for Hopper (``sm_90a``), all at once in parallel, and the objects are
linked into ``_build/<source hash>/libba_kernels.so``, loaded with ctypes;
a changed source gets a new hash and a fresh build. There is no fallback:
without ``nvcc``, or when the compiler fails, the loader raises with the
compiler's output.

Each kernel wrapper (``ops/fused_assemble.py``, ``ops/fused_schur.py``,
``ops/linearize.py``, ``ops/point_block.py``, ``ops/seg_reduce.py``,
``ops/dense_schur.py``, ``ops/stream_probe.py``)
counts its launches in :data:`LAUNCHES` through :func:`launched` — one
per wrapper call that launches the kernel — so a run can show which
kernels it went through; the W kernels' launches are also counted by W's
storage dtype in :data:`W_LAUNCHES`.

The per-observation W blocks may be stored as float32, bfloat16 or float16
(``facto_dtype``): a wrapper passes the storage as a code of
:data:`W_CODES`, and the kernel launches its instantiation for that type
(``csrc/w_store.cuh``).
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

from bundleadjustment_jl_tpu_torch.ops.plans import rows

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libba_kernels.so"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
# Not --use_fast_math: the chain's sqrtf / sincosf / divides stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# One key per kernel form: K1 assemble; K2 cam_reduce (its `_prod_wcw_rhs`
# form) and cam_reduce_{w_op,wcw81,cam90}, and cam_relin_{cam90,wcw_rhs} (its
# cam90 and W C W' | W t forms re-derived in camera order); K3 matvec; K4
# objective; K7 linearize; K8 linearize_w_only; K6 seg_prod_* (one key per
# product); K5 seg_block_* (one key per direction); K9 stream_probe; the point
# blocks' point_inv (damped inverse and Hpp_inv g_p) and point_quad (dp' Hpp
# dp); the dense Schur step's dense_pairs (S by camera pairs, every route).
# Which route runs which: `ops/normal.py:kernel_route`; K9 runs in the
# card tools alone (`mv_sweep.py`, `chip_smoke.py`'s probe phase).
LAUNCHES = {"assemble": 0, "cam_reduce": 0, "cam_reduce_w_op": 0,
            "cam_reduce_wcw81": 0, "cam_reduce_cam90": 0,
            "cam_relin_cam90": 0, "cam_relin_wcw_rhs": 0, "matvec": 0,
            "objective": 0, "linearize": 0, "linearize_w_only": 0,
            "seg_prod_pnt12": 0, "seg_prod_cam90": 0, "seg_prod_wcw81": 0,
            "seg_block_point": 0, "seg_block_camera": 0, "stream_probe": 0,
            "point_inv": 0, "point_quad": 0, "dense_pairs": 0}

# Storage dtypes of W and their codes in the C entry points
# (`csrc/w_store.cuh`).
W_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
W_DTYPES = tuple(W_CODES)
# The kernel forms that write W and those that read it (LAUNCHES keys);
# cam_relin_wcw_rhs re-derives W in the storage dtype in place of reading
# it, and counts as a reader.
W_WRITERS = ("assemble", "linearize", "linearize_w_only")
W_READERS = ("cam_reduce", "cam_reduce_w_op", "cam_reduce_wcw81", "matvec",
             "seg_prod_wcw81", "seg_block_point", "seg_block_camera",
             "dense_pairs", "cam_relin_wcw_rhs")
# Launches of the W_WRITERS and W_READERS forms by the storage dtype of the
# W each wrote or read, so a run can show that W went to the kernels narrow
# (`solver/lm_jit.py:expected_w_launches`).
W_LAUNCHES = dict.fromkeys(W_DTYPES, 0)


def reset_launches() -> None:
    for counts in (LAUNCHES, W_LAUNCHES):
        for k in counts:
            counts[k] = 0


def launched(key: str, w: torch.Tensor | torch.dtype | None = None) -> None:
    """Count one launch of kernel form ``key``; ``w``: the W it wrote or
    read (or the storage dtype of the W it re-derived), counted in
    :data:`W_LAUNCHES` under its dtype."""
    LAUNCHES[key] += 1
    if w is not None:
        W_LAUNCHES[w if isinstance(w, torch.dtype) else w.dtype] += 1


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


def _run_all(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Run the commands concurrently; (command, exit code, output) each."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    results = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        results.append((cmd, proc.returncode, out))
    return results


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (once per source
    hash) and return its path: one ``nvcc -c`` per source, all started
    together, then one link. The compiler's output, including ``-Xptxas
    -v``'s register and spill report, is kept in ``build.log`` beside
    it."""
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
    tag = f"{os.getpid()}.tmp"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for obj, src in zip(objs, srcs)])
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                              str(tmp), *map(str, objs)]])
    log = "".join(" ".join(cmd) + "\n" + text for cmd, _, text in results)
    (out_dir / "build.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    for cmd, rc, _ in results:
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {rc}:\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return out


_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)


class TilePlanC(ctypes.Structure):
    """K2 and K3's plan as their C entry points take it
    (``csrc/cam_pass.cuh`` ``BaTilePlan``), by pointer: the device arrays of
    :class:`ops.plans.TilePlan` and the problem's ``cam_perm`` and
    ``cam_starts``."""
    _fields_ = [("tile_bounds", _P), ("tile_pnts", _P),
                ("tile_run_starts", _P), ("run_cam", _P), ("run_ends", _P),
                ("tile_rows", _P), ("visits", _P), ("cam_runs", _P),
                ("cam_run_starts", _P), ("cam_perm", _P),
                ("cam_starts", _P), ("ntiles", _I),
                ("nruns", _I), ("nvisits", _I), ("rows", _I), ("npnts", _I)]


class CamColPlanC(ctypes.Structure):
    """The column plan as the C entry points of K5's camera direction and
    K6's W C W' take it (``csrc/cam_cols.cuh`` ``BaCamColPlan``), by
    pointer: the device arrays of :class:`ops.plans.CamColPlan`."""
    _fields_ = [("cam_pnt", _P), ("run_bounds", _P),
                ("range_run_starts", _P), ("cam_run_starts", _P),
                ("nranges", _I), ("cols", _I)]


_PLAN = ctypes.POINTER(TilePlanC)
_COLS = ctypes.POINTER(CamColPlanC)
# Every W pointer is followed by its storage code (W_CODES).
_SIGNATURES = {
    "ba_assemble": [_P] * 8 + [_I, _P, _P, _I, _I64, _P, _I] + [_P] * 5,
    "ba_cam_reduce": [_I, _P, _I] + [_P] * 3 + [_PLAN, _I, _I64, _I, _I]
    + [_P] * 3,
    "ba_matvec": [_P, _I] + [_P] * 4 + [_PLAN, _P, _P, _F, _I, _I64, _I, _I]
    + [_P] * 4,
    "ba_objective": [_P] * 6 + [_I, _I, _I, _I64, _P, _P, _P],
    "ba_linearize_rows": [_P] * 6 + [_I64, _P, _P, _I, _P],
    "ba_linearize_w_only": [_P] * 6 + [_I64, _P, _I, _P],
    "ba_cam_relin_cam90": [_P] * 6 + [_I, _P, _P],
    "ba_cam_relin_wcw_rhs": [_P] * 9 + [_I, _I, _I] + [_P] * 3,
    "ba_jtj_pnt_reduce": [_P] * 4 + [_I, _I64, _P, _P],
    "ba_jtj_cam_reduce": [_P, _P, _I, _I64, _P, _P],
    "ba_wcw_cam_reduce": [_P, _I, _P, _COLS, _I, _I64] + [_P] * 3,
    "ba_wtv_point_reduce": [_P, _I] + [_P] * 5 + [_I, _P, _P, _F, _I64, _P,
                                                   _P],
    "ba_wt_cam_reduce": [_P, _I, _P, _COLS, _I, _I64] + [_P] * 3,
    "ba_stream_probe": [_P] * 3 + [_I, _I64, _I, _P, _P, _P],
    "ba_point_inv": [_P, _P, _F, _P, _I, _I, _I64, _I, _P, _P, _P],
    "ba_point_quad": [_P, _P, _I, _I64, _I, _P, _P, _P],
    "ba_dense_pairs": [_P, _I, _I64, _I64] + [_P] * 8 + [_I64, _P, _P, _I64,
                                                        _I64] + [_P] * 4,
}


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    so = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in (("ba_cam_pass_bytes", [_I, _I, _I]),
                           ("ba_matvec_bytes", [_I, _I])):
        getattr(so, name).argtypes = argtypes
        getattr(so, name).restype = ctypes.c_int64
    for name in ("ba_objective_blocks", "ba_point_blocks"):
        getattr(so, name).argtypes = [_I64]
        getattr(so, name).restype = ctypes.c_int64
    so.ba_stream_probe_blocks.argtypes = [_I64]
    so.ba_stream_probe_blocks.restype = ctypes.c_int
    so.ba_error_string.argtypes = [_I]
    so.ba_error_string.restype = ctypes.c_char_p
    return so


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def tile_plan_arg(plan, problem) -> ctypes._Pointer:
    """:class:`ops.plans.TilePlan` of ``problem`` as the C entry points
    take it."""
    return ctypes.pointer(TilePlanC(
        ptr(plan.tile_bounds), ptr(plan.tile_pnts),
        ptr(plan.tile_run_starts), ptr(plan.run_cam), ptr(plan.run_ends),
        ptr(plan.tile_rows), ptr(plan.visits), ptr(plan.cam_runs),
        ptr(plan.cam_run_starts), ptr(problem.cam_perm),
        ptr(problem.cam_starts), plan.ntiles, plan.nruns,
        plan.visits.shape[0], plan.rows, problem.npnts))


@functools.cache
def cam_pass_bytes(form: int | None, x_code: int, which: int) -> int:
    """Sizes of K2's form ``form`` (``csrc/cam_reduce.cu``
    ``ba_cam_pass_bytes``; None: K3, ``ba_matvec_bytes``) with rows stored
    as ``x_code``: ``which`` 0 its stages' dynamic shared memory, 1 the
    most its block pass may take on this card, 2 a record's bytes."""
    got = (lib().ba_matvec_bytes(x_code, which) if form is None
           else lib().ba_cam_pass_bytes(form, x_code, which))
    if got < 0:
        raise ValueError(f"no K2 form {form} with storage {x_code}")
    return int(got)


def cam_col_plan_arg(plan) -> ctypes._Pointer:
    """:class:`ops.plans.CamColPlan` as the C entry points take it."""
    return ctypes.pointer(CamColPlanC(
        ptr(plan.cam_pnt), ptr(plan.run_bounds), ptr(plan.range_run_starts),
        ptr(plan.cam_run_starts), plan.nranges, plan.cols))


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().ba_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def require(t: torch.Tensor, name: str,
            dtype: torch.dtype | tuple[torch.dtype, ...],
            shape: tuple | None = None) -> None:
    """Validate a kernel operand: on CUDA, of ``dtype`` (or one of a tuple
    of them, e.g. :data:`W_DTYPES` for a W operand), contiguous, and (when
    given) of ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    allowed = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in allowed:
        raise TypeError(f"{name}: the CUDA kernels take "
                        f"{' or '.join(map(str, allowed))}, got {t.dtype} "
                        f"(float64 runs on the CPU path only)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def w_code(t: torch.Tensor, name: str, shape: tuple) -> int:
    """Validate a W operand (:func:`require` over :data:`W_DTYPES`) and
    return its storage code."""
    require(t, name, W_DTYPES, shape)
    return W_CODES[t.dtype]


def require_problem(problem) -> None:
    """Validate the problem arrays every kernel reads: the index arrays and
    the rows as the kernels get them (`ops/plans.py:rows`)."""
    n, nc, npt = problem.nobs_pad, problem.ncams, problem.npnts
    pt2d, w = rows(problem)
    require(pt2d, "pt2d", torch.float32, (n, 2))
    require(w, "w", torch.float32, (n,))
    for name, size in (("cam_idx", n), ("pnt_idx", n), ("cam_perm", n),
                       ("pnt_starts", npt + 1), ("cam_starts", nc + 1)):
        require(getattr(problem, name), name, torch.int32, (size,))
