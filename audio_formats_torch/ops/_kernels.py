"""Build and load the port's CUDA kernels (``audio_formats_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with nvcc for Hopper into a shared library
with a plain C interface, loaded with ctypes.  The build runs at first use,
from the sources in the package only, into ``audio_formats_torch/build/``.
A library's file name carries a hash of its source and flags, so an edited
source builds anew; the compiler writes to a private name that is then
renamed into place, so processes building at once never load a half-written
file.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_V = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures of every kernel library's entries: ((name, argtypes), ...)
_ENTRIES = {
    "flac_lpc": (("af_flac_lpc", [_V, _V, _V, _V, _V, _V, _I, _I, _V]),),
    "qoa_lms": (("af_qoa_decode", [_V, _V, _V, _V, _V, _V, _I, _I, _V]),
                ("af_qoa_encode", [_V, _I, _V, _V, _V, _V, _V, _V, _I, _V])),
}

_lock = threading.Lock()
_libs = {}
#: compiler output (ptxas register/spill report) of builds in this process
BUILD_LOG = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless a build of this exact source exists;
    returns the library's path."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed to build {src}:\n{res.stderr}")
    os.replace(tmp, so)
    BUILD_LOG[name] = (time.perf_counter() - t0, res.stdout + res.stderr)
    return so


def load(name: str):
    """The loaded ctypes library of kernel `name`, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn_name, argtypes in _ENTRIES[name]:
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib
