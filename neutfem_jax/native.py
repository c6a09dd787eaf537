"""ctypes bindings for the host-side C++ runtime kernels (native/neutfem_host.cpp).

Every entry point has a pure-numpy fallback, so the framework works without the
compiled library; with it, the host-side O(n)-serial pieces (tridiagonal LDL^T
factorization at BuildMatrices time, XS block coarsening, VTK IO) run native.

The library is built from the tracked source on first use (``g++``, a few
seconds) into ``build/native/`` at the repository root, which git ignores, and
rebuilt when the source is newer; ``native/build.sh`` runs the same build.
NEUTFEM_NATIVE=0 skips it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["available", "build", "tridiag_ldlt_batch", "block_mean",
           "write_vtk_native"]

_ROOT = Path(__file__).resolve().parent.parent
SOURCE = _ROOT / "native" / "neutfem_host.cpp"
LIB_PATH = _ROOT / "build" / "native" / "libneutfem_host.so"


def build(dest: Path = LIB_PATH, source: Path = SOURCE) -> Path:
    """Compile the host library from ``source`` into ``dest`` (atomically: a
    temporary file renamed into place, so concurrent builders never load a
    half-written library).  Raises on a compiler failure."""
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=dest.parent)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=x86-64-v2", "-fPIC", "-shared", "-std=c++17",
             str(source), "-o", tmp],
            check=True, capture_output=True, text=True)
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return dest


def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("NEUTFEM_NATIVE", "1") == "0":
        return None
    try:
        if (not LIB_PATH.exists()
                or (SOURCE.exists() and SOURCE.stat().st_mtime > LIB_PATH.stat().st_mtime)):
            build()
        lib = ctypes.CDLL(str(LIB_PATH))
    except (OSError, subprocess.CalledProcessError):
        return None  # no compiler or no loadable library: numpy fallbacks
    lib.nf_tridiag_ldlt_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.nf_block_mean.argtypes = [ctypes.POINTER(ctypes.c_double)] * 3 + [
        ctypes.c_int64] * 7
    lib.nf_write_vtk.restype = ctypes.c_int
    lib.nf_write_vtk.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
    ]
    return lib


_lib = _load()


def available() -> bool:
    return _lib is not None


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def tridiag_ldlt_batch(diag: np.ndarray, off: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """LDL^T of batched SPD tridiagonal systems.

    diag: (..., n); off: (..., n-1) along the LAST axis.
    Returns (dinv, l) with the same shapes.
    """
    n = diag.shape[-1]
    d = np.ascontiguousarray(diag, dtype=np.float64).copy()
    l = np.ascontiguousarray(off, dtype=np.float64).copy()
    batch = int(np.prod(d.shape[:-1])) if d.ndim > 1 else 1
    if _lib is not None:
        _lib.nf_tridiag_ldlt_batch(_dp(d), _dp(l), batch, n)
        return d, l
    # numpy fallback (sequential recurrence over the line axis)
    d2 = d.reshape(batch, n)
    l2 = l.reshape(batch, n - 1)
    dp = d2[:, 0].copy()
    for i in range(n - 1):
        li = l2[:, i] / dp
        dn = d2[:, i + 1] - l2[:, i] * li
        l2[:, i] = li
        d2[:, i] = 1.0 / dp
        dp = dn
    d2[:, n - 1] = 1.0 / dp
    return d, l


def block_mean(a: np.ndarray, weights: np.ndarray, factors) -> np.ndarray:
    """Volume-weighted block mean over trailing (nz, ny, nx) axes.

    factors = (rx, ry, rz) in axis order x, y, z (matching coarse.py).
    """
    rx, ry, rz = factors
    lead_shape = a.shape[:-3]
    nz, ny, nx = a.shape[-3:]
    lead = int(np.prod(lead_shape)) if lead_shape else 1
    out = np.empty((*lead_shape, nz // rz, ny // ry, nx // rx))
    if _lib is not None:
        ac = np.ascontiguousarray(a, dtype=np.float64)
        wc = np.ascontiguousarray(weights, dtype=np.float64)
        _lib.nf_block_mean(_dp(ac), _dp(wc), _dp(out), lead, nz, ny, nx, rz, ry, rx)
        return out
    a6 = a.reshape(*lead_shape, nz // rz, rz, ny // ry, ry, nx // rx, rx)
    w6 = weights.reshape(nz // rz, rz, ny // ry, ry, nx // rx, rx)
    num = (a6 * w6).sum(axis=(-5, -3, -1))
    den = w6.sum(axis=(-5, -3, -1))
    return num / den


def write_vtk_native(
    path: str,
    title: str,
    xb: np.ndarray,
    yb: np.ndarray,
    zb: np.ndarray,
    n_cells: int,
    scalars: List[Tuple[str, np.ndarray]],
    vectors: List[Tuple[str, np.ndarray]],
) -> bool:
    """Write the VTK file with the native writer.  Returns False if unavailable
    (caller falls back to the python writer)."""
    if _lib is None:
        return False
    s_names = b"".join(n.encode() + b"\0" for n, _ in scalars) or b"\0"
    v_names = b"".join(n.encode() + b"\0" for n, _ in vectors) or b"\0"
    s_data = (np.ascontiguousarray(
        np.concatenate([np.asarray(v, dtype=np.float64).reshape(-1) for _, v in scalars])
    ) if scalars else np.zeros(0))
    v_data = (np.ascontiguousarray(
        np.concatenate([np.asarray(v, dtype=np.float64).reshape(-1) for _, v in vectors])
    ) if vectors else np.zeros(0))
    xb = np.ascontiguousarray(xb, dtype=np.float64)
    yb = np.ascontiguousarray(yb, dtype=np.float64)
    zb = np.ascontiguousarray(zb, dtype=np.float64)
    rc = _lib.nf_write_vtk(
        path.encode(), title.encode(), _dp(xb), len(xb), _dp(yb), len(yb),
        _dp(zb), len(zb), n_cells, s_names, _dp(s_data), len(scalars),
        v_names, _dp(v_data), len(vectors),
    )
    if rc != 0:
        raise IOError(f"native VTK writer failed with code {rc} for {path}")
    return True
