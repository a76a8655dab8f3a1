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

import torch

from .. import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: a library's flags beyond NVCC_FLAGS: K10's, K12a's and K12b's float
#: steps must each round alone (the FMAs K10 and K12a need, K12a's IMDCT
#: dot products among them, are written out as __fmaf_rn)
EXTRA_FLAGS = {"pcm": ("-fmad=false",), "celt_ola": ("-fmad=false",),
               "celt_deemph": ("-fmad=false",)}

_V = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C signatures of every kernel library's entries: ((name, argtypes), ...)
_ENTRIES = {
    "flac_lpc": (("af_flac_lpc", [_V, _V, _V, _V, _V, _V, _V, _I, _I, _V]),
                 ("af_flac_lpc_plan", [_V, _V, _V, _V, _V, _I, _I, _V]),
                 ("af_flac_lpc_plan_scratch", [_I])),
    "qoa_lms": (("af_qoa_decode", [_V, _V, _V, _V, _V, _V, _I, _I, _V]),
                ("af_qoa_encode", [_V, _I, _V, _V, _V, _V, _V, _V, _I, _V]),
                ("af_qoa_quant_mismatches", [_V, _V])),
    "mp3_huff": (("af_mp3_huff", [_V, _V, _V, _V, _V, _I, _I, _I, _V, _V, _V]),
                 ("af_mp3_huff_plan", [_V, _I, _I, _V, _V, _V, _V]),
                 ("af_mp3_huff_plan_scratch", [_I])),
    "flac_rice": (("af_flac_rice", [_V, _I, _V, _V, _V, _V, _I, _I, _I, _V,
                                    _V, _V, _V, _V, _V]),),
    "pcm": (("af_pcm_decode", [_V, _V, ctypes.c_longlong, _I, _V]),
            ("af_pcm_quantize", [_V, _V, _V, _I, _I, _I, _I, _V])),
    "vorbis_win": (("af_vorbis_win", [_V, _V, _V, _V, _V, _V, _V, _V, _V,
                                      _V, _V, _V, _V, _V, _I, _I, _I, _I,
                                      _I, _V]),),
    "celt_ola": (("af_celt_ola", [_V, _V, _V, _I, _I, _I, _V]),
                 ("af_celt_imdct_ola", [_V, _V, _V, _V, _V, _I, _I,
                                        ctypes.c_float, _V])),
    "celt_deemph": (("af_celt_deemph", [_V, _L, _V, _V, _L, _V, _I, _I,
                                        ctypes.c_float, _V]),),
    "silk_upsample": (("af_silk_upsample", [_V, _V, _V, _I, _I, _I, _I,
                                            _V]),),
}



class KernelError(RuntimeError):
    """A kernel did not build, load or launch, or the card refused the call
    as configured: a fault of the program or the card, never of a stream's
    data.  BatchDecoder lets it through instead of demoting lanes around
    the kernel."""


class KernelArgError(KernelError, ValueError):
    """A kernel's wrapper was given tensors it cannot take."""


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
    raise KernelError("nvcc not found: the CUDA toolkit is needed to build "
                      "the port's kernels")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless a build of this exact source exists;
    returns the library's path."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(flags).encode())
    so = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        with trace.span("kernel.build", kernel=name):
            res = subprocess.run([_nvcc(), *flags, "-o", tmp, src],
                                 capture_output=True, text=True,
                                 timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise KernelError(f"nvcc did not run on {src}: {e}") from e
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelError(f"nvcc failed to build {src}:\n{res.stderr}")
    os.replace(tmp, so)
    BUILD_LOG[name] = (time.perf_counter() - t0, res.stdout + res.stderr)
    return so


def check_args(fn: str, dev, want, rows=()) -> None:
    """Raise KernelArgError (a ValueError) unless every (name, tensor,
    dtypes, shape) in `want` lies contiguous on the CUDA device `dev` with
    one of the dtypes and the shape (a tensor named in `rows` in any
    layout: one its kernel takes by row stride, whose rows the wrapper
    checks itself): what a kernel's wrapper checks before it passes
    pointers.  A tensor's device is read as (is_cuda,
    get_device()), cheaper than building its torch.device; the message is
    made only for a tensor that fails."""
    if dev.type != "cuda":
        raise KernelArgError(f"{fn}: on {dev}, want a CUDA device")
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    for name, t, dtypes, shape in want:
        if not (t.is_cuda and t.get_device() == idx and t.dtype in dtypes
                and t.size() == shape and (t.is_contiguous()
                                           or name in rows)):
            if not (t.is_cuda and t.get_device() == idx):
                raise KernelArgError(f"{fn}: {name} on {t.device}, want "
                                     f"{dev} (a CUDA device)")
            if t.dtype not in dtypes or t.size() != shape:
                raise KernelArgError(f"{fn}: {name} is {t.dtype}"
                                     f"{list(t.shape)}, want {dtypes[0]}"
                                     f"{list(shape)}")
            raise KernelArgError(f"{fn}: {name} must be contiguous")


def load(name: str):
    """The loaded ctypes library of kernel `name`, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build(name)
            with trace.span("kernel.load", kernel=name):
                try:
                    lib = ctypes.CDLL(path)
                    fns = [(getattr(lib, fn_name), argtypes)
                           for fn_name, argtypes in _ENTRIES[name]]
                except (OSError, AttributeError) as e:
                    raise KernelError(f"cannot load {path}: {e}") from e
                for fn, argtypes in fns:
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check_launch(fn: str, rc: int) -> None:
    """Raise KernelError when a kernel library's entry returned a CUDA
    error code."""
    if rc != 0:
        raise KernelError(f"{fn} kernel launch failed: CUDA error {rc}")
