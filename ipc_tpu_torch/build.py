"""Build and load the port's CUDA kernels (csrc/*.cu).

One shared library with a plain C interface, compiled by nvcc for Hopper
(sm_90a) at first use and loaded with ctypes. It is built from the sources
in this checkout only, into `build/kernels/` beside the package (listed in
.gitignore), and rebuilt when a source is newer than the library. Nothing
here runs at import time: the CPU tests import every module without nvcc.
"""

import ctypes
import glob
import os
import shutil
import subprocess
import time

__all__ = ["LIB_PATH", "SOURCES", "build_kernels", "load_kernels"]

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCES = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
LIB_PATH = os.path.join(os.path.dirname(_PKG), "build", "kernels",
                        "libipc_tpu_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build on a machine with the CUDA toolkit")


def _stale():
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in SOURCES)


def build_kernels(force=False):
    """Compile csrc/*.cu into LIB_PATH when stale (or `force`). Returns
    dict(path, seconds, built, log) — `log` holds nvcc's output, including
    ptxas's register and shared-memory report."""
    if not (force or _stale()):
        return dict(path=LIB_PATH, seconds=0.0, built=False, log="")
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    os.replace(tmp, LIB_PATH)
    return dict(path=LIB_PATH, seconds=seconds, built=True, log=log)


def load_kernels():
    """The loaded kernel library (built first if stale), with argtypes set
    for every entry point."""
    global _lib
    if _lib is None:
        build_kernels()
        lib = ctypes.CDLL(LIB_PATH)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("ipc_tet_hv_f32", "ipc_tet_hv_f64"):
            fn = getattr(lib, name)
            # H, v, tets, inc, n_tets, n_verts, D, rows (scratch), out, stream
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
            fn.restype = i32
        lib.ipc_tet_hv_device_launches.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        lib.ipc_tet_hv_device_launches.restype = i32
        f64 = ctypes.c_double
        for name in ("ipc_accd_pt_f32", "ipc_accd_pt_f64", "ipc_accd_ee_f32", "ipc_accd_ee_f64"):
            fn = getattr(lib, name)
            # x4, p4, n, slackness, max_iter, t_max, t (out), live (out or null), stream
            fn.argtypes = [ptr, ptr, i32, f64, i32, f64, ptr, ptr, ptr]
            fn.restype = i32
        i64 = ctypes.c_int64
        for kind in ("pt", "ee", "et"):
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"ipc_grid_{kind}_{dt}")
                # q_i0, lo, n, prims, t_key, q_box, t_box, q_rb, q_u, q_w, t_rb, t_u,
                # t_w, q_v, t_v, q_dbc, t_dbc, nq, n_t, gap, write, counts, offsets, keys,
                # stream
                fn.argtypes = [ptr] * 17 + [i64, i64, f64, i32] + [ptr] * 4
                fn.restype = i32
        _lib = lib
    return _lib
