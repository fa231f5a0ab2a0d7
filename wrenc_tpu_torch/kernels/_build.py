"""Build and load the port's CUDA kernels (kernels/csrc/*.cu).

nvcc compiles each source into a shared library with a plain C interface
in the package's `_build/` directory at first use, and again whenever the
source is newer than the library; ctypes loads it. Nothing here runs at
import: the CPU tests import every module on a machine without nvcc.
A failed build or load raises.
"""
import ctypes
import fcntl
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "kernels", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs = {}


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    return "nvcc"


def build(name, extra_flags=()):
    """Compile csrc/<name>.cu to _build/lib<name>.so if missing or stale.
    Returns (path, compiler output). Safe against concurrent builders."""
    src = os.path.join(_CSRC, name + ".cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"lib{name}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if (os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(src)):
            return so, ""
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *extra_flags, src,
                               "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc build of {src} failed:\n"
                               + proc.stderr[-4000:])
        os.replace(tmp, so)
        return so, proc.stdout + proc.stderr


K1_MAX_JOBS = 8


class K1Job(ctypes.Structure):
    """ctypes mirror of csrc/dq_scan.cu's K1Job: one job of a K1 launch,
    or K2's one job."""
    _fields_ = [("t", ctypes.c_void_p), ("q", ctypes.c_void_p),
                ("rate", ctypes.c_void_p), ("ls", ctypes.c_void_p),
                ("bd", ctypes.c_void_p), ("B", ctypes.c_int),
                ("log2_n", ctypes.c_int), ("ls_stride", ctypes.c_int),
                ("bd_stride", ctypes.c_int), ("ls_val", ctypes.c_int),
                ("bd_val", ctypes.c_int), ("cta_begin", ctypes.c_int),
                ("t_transposed", ctypes.c_int)]


class K1Desc(ctypes.Structure):
    """ctypes mirror of K1Desc, passed to the kernel by value."""
    _fields_ = [("job", K1Job * K1_MAX_JOBS), ("n_jobs", ctypes.c_int),
                ("n_ctas", ctypes.c_int), ("max_log2_n", ctypes.c_int),
                ("lanes", ctypes.c_int)]


_SIGNATURES = {
    "dq_scan": {
        # desc (job[0] and lanes), lam_dq, lv, coding-order tables, stream
        "dq_greedy_launch": [K1Desc, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_void_p],
        # lanes, log2 of the block size
        "dq_greedy_blocks_per_cta": [ctypes.c_int, ctypes.c_int],
        "dq_greedy_smem_bytes": [ctypes.c_int, ctypes.c_int],
        # desc, lam_dq, lv, coding-order tables, stream
        "dq_trellis_launch": [K1Desc, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p],
        "dq_trellis_desc_size": [],
        # lanes, log2 of the largest block size
        "dq_trellis_smem_bytes": [ctypes.c_int, ctypes.c_int],
    },
}


def lib(name):
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            so, _ = build(name)
            handle = ctypes.CDLL(so)
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(handle, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            if name == "dq_scan" and (handle.dq_trellis_desc_size()
                                      != ctypes.sizeof(K1Desc)):
                raise RuntimeError(
                    f"K1Desc is {handle.dq_trellis_desc_size()} bytes in "
                    f"{so}, {ctypes.sizeof(K1Desc)} in its ctypes mirror")
            _libs[name] = handle
        return _libs[name]


def check(rc, what):
    """Raise on a nonzero cudaGetLastError() from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")
