"""Builds the C host stages of both packages once, before any test module
beside this directory is collected.

pytest collects this directory before the test modules in ``tests/``, so
every pytest-xdist worker imports this module first.  Some of those modules
load the JAX package's host stage while they are imported (the skip mark of
``tests/test_celt_native.py``), and that package builds ``af_host.so`` in
place with no lock: workers building at once can load a file another one
is still writing, get no library, and skip the tests that need it.  Here
each worker builds, or finds built, both packages' libraries under one
file lock, one worker at a time.
"""

import fcntl
import os

from audio_formats_tpu.host import native as jax_native

from audio_formats_torch.host import native as torch_native

_LOCK = os.path.join(os.path.dirname(os.path.abspath(torch_native.__file__)),
                     "src", "af_host.build.lock")


def _build_both():
    with open(_LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            return jax_native.get_lib(), torch_native.get_lib()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


LIBS = _build_both()


def test_host_stages_built_before_collection():
    assert all(lib is not None for lib in LIBS)
