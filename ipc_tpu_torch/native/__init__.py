"""ctypes bindings for the native C++ host runtime (ipc_native.cpp).

The port's copy of ipc_tpu/native: `parse_msh`, `boundary_faces` and
`grid_candidates`, with `available()`. g++ builds the shared library at
first use into build/native/ beside the package (listed in .gitignore; the
JAX package writes its library beside the source), through a temporary
file renamed into place, so processes that build at once do not see a
partial library; it is rebuilt when the source is newer. It is built
without -march=native (the JAX package's flag), so a library built on one
host also loads on another. Nothing is built
at import time. Without g++ `available()` is False: the port's Python
paths (io_mesh.read_msh, mesh's boundary faces, the broad phases) do not
need this library.
"""

import ctypes
import os
import subprocess
import tempfile

import numpy as np

__all__ = ["available", "parse_msh", "boundary_faces", "grid_candidates", "LIB_PATH"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "ipc_native.cpp")
LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native",
                        "libipc_native.so")

_lib = None
_err = None


def _build():
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(LIB_PATH))
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _err
    if _lib is not None or _err is not None:
        return _lib
    try:
        if not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(LIB_PATH)
        lib.ipc_free.argtypes = [ctypes.c_void_p]
        lib.parse_msh.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.parse_msh.restype = ctypes.c_int
        lib.boundary_faces.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.boundary_faces.restype = ctypes.c_int
        lib.grid_candidates.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.grid_candidates.restype = ctypes.c_int64
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        _err = e
    return _lib


def available():
    """True when the library builds (g++ present) and loads."""
    return _load() is not None


def parse_msh(path):
    """Native .msh parser -> (V (n,3) f64, T (m,4) i32)."""
    lib = _load()
    Vp = ctypes.POINTER(ctypes.c_double)()
    Tp = ctypes.POINTER(ctypes.c_int32)()
    nV = ctypes.c_int64()
    nT = ctypes.c_int64()
    rc = lib.parse_msh(str(path).encode(), ctypes.byref(Vp), ctypes.byref(nV),
                       ctypes.byref(Tp), ctypes.byref(nT))
    if rc != 0:
        raise IOError(f"parse_msh({path}) failed with code {rc}")
    V = np.ctypeslib.as_array(Vp, shape=(nV.value, 3)).copy()
    T = np.ctypeslib.as_array(Tp, shape=(nT.value, 4)).copy()
    lib.ipc_free(Vp)
    lib.ipc_free(Tp)
    return V, T


def boundary_faces(tets):
    """Native boundary-face extraction -> (nF,3) i32 (outward oriented)."""
    lib = _load()
    tets = np.ascontiguousarray(tets, dtype=np.int32)
    Fp = ctypes.POINTER(ctypes.c_int32)()
    nF = ctypes.c_int64()
    lib.boundary_faces(
        tets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(tets)),
        ctypes.byref(Fp),
        ctypes.byref(nF),
    )
    F = np.ctypeslib.as_array(Fp, shape=(nF.value, 3)).copy()
    lib.ipc_free(Fp)
    return F


def grid_candidates(X, A, B, cell_size, gap, skip_shared=True, upper_only=False, cap=None):
    """Uniform-grid broad phase: candidate (a, b) index pairs between
    primitive sets A (nA, ka) and B (nB, kb) over positions X (n,3).

    Returns (pairs (m,2) i32, total_count). total_count > m means the cap
    was hit; call again with a larger cap."""
    lib = _load()
    X = np.ascontiguousarray(X, dtype=np.float64)
    A = np.ascontiguousarray(np.atleast_2d(A), dtype=np.int32)
    B = np.ascontiguousarray(np.atleast_2d(B), dtype=np.int32)
    if cap is None:
        cap = max(1024, 16 * max(len(A), len(B)))
    out = np.empty((cap, 2), dtype=np.int32)
    total = ctypes.c_int64()
    written = lib.grid_candidates(
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ctypes.c_int64(len(X)),
        A.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.c_int64(len(A)),
        ctypes.c_int32(A.shape[1]),
        B.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.c_int64(len(B)),
        ctypes.c_int32(B.shape[1]),
        ctypes.c_double(cell_size), ctypes.c_double(gap),
        ctypes.c_int32(1 if skip_shared else 0),
        ctypes.c_int32(1 if upper_only else 0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.c_int64(cap),
        ctypes.byref(total),
    )
    return out[:written], int(total.value)
