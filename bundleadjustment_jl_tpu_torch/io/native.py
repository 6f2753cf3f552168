"""ctypes bindings of the native BAL parser, the repository's shared
``csrc/bal_parser.cpp`` (PyTorch port of `bundleadjustment_jl_tpu/io/native.py`).

At first use it is compiled with ``g++`` into this package's git-ignored
build directory (``_build/bal_parser-<source hash>.so``; a changed source
or flag set gets a new name and a fresh build) and loaded. It links libbz2
where one is found (:data:`NATIVE_BZ2`), so it parses ``.bz2`` files too;
`io/bal.py:read_bal` then prefers it, as the JAX reader does. A failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sysconfig
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "csrc" / "bal_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def _find_libbz2() -> str | None:
    """A linkable libbz2 (runtime images often ship only the versioned
    .so, so ``-lbz2`` alone may not resolve)."""
    for d in ("/usr/lib", "/usr/lib/x86_64-linux-gnu", "/usr/local/lib",
              sysconfig.get_config_var("LIBDIR") or ""):
        if not d:
            continue
        for name in ("libbz2.so", "libbz2.so.1.0", "libbz2.so.1"):
            p = os.path.join(d, name)
            if os.path.exists(p):
                return p
    return None


LIBBZ2 = _find_libbz2()
NATIVE_BZ2 = LIBBZ2 is not None


def _command(out: Path) -> list[str]:
    cmd = ["g++", "-O3", "-shared", "-fPIC", str(SOURCE), "-o", str(out)]
    if LIBBZ2 is not None:
        cmd.insert(1, "-DBAL_HAVE_BZ2")
        cmd.append(LIBBZ2)
    return cmd


def library_path() -> Path:
    """Where the parser's shared library is built, by its source and the
    libbz2 it links."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(str(LIBBZ2).encode())
    return BUILD_DIR / f"bal_parser-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the parser (once per source hash) and return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded parser (built at the first call)."""
    so = ctypes.CDLL(str(build()))
    so.bal_read_header.restype = ctypes.c_int
    so.bal_read_header.argtypes = [ctypes.c_char_p] + \
        [ctypes.POINTER(ctypes.c_int64)] * 3
    so.bal_parse.restype = ctypes.c_int
    so.bal_parse.argtypes = [ctypes.c_char_p] + [
        np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS")
        for t in (np.int64, np.int64, np.float64, np.float64, np.float64)]
    return so


def parse_bal_native(path: str):
    """Parse a BAL file with the native parser -> ``(cam_idx, pnt_idx,
    pt2d, cams_file, points)``, cameras in file order (r, t, f, k1, k2):
    the contract of `io/bal.py:_read_raw`."""
    so = lib()
    nc, npt, no = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if so.bal_read_header(path.encode(), ctypes.byref(nc), ctypes.byref(npt),
                          ctypes.byref(no)) != 0:
        raise IOError(f"native BAL header parse failed: {path}")
    ncams, npnts, nobs = nc.value, npt.value, no.value
    cam_idx = np.empty(nobs, np.int64)
    pnt_idx = np.empty(nobs, np.int64)
    pt2d = np.empty((nobs, 2), np.float64)
    cams = np.empty((ncams, 9), np.float64)
    points = np.empty((npnts, 3), np.float64)
    if so.bal_parse(path.encode(), cam_idx, pnt_idx, pt2d.reshape(-1),
                    cams.reshape(-1), points.reshape(-1)) != 0:
        raise IOError(f"native BAL parse failed: {path}")
    return cam_idx, pnt_idx, pt2d, cams, points
