"""Wait for the JAX package's native library before a test compares with
it.

``fgt_tpu/native/__init__.py`` runs ``make`` in place in every process
that first needs ``native/libfgt_native.so`` (the Makefile links straight
to that name), and a process that opens the file while another one is
still writing it gets ``OSError``, latches ``_tried`` and runs the Python
fallback for the rest of its life. Under pytest-xdist every worker may
race so. The port's tests that hold the port's native flowNN against the
JAX package's native path byte for byte call :func:`require_jax_native`
first: it takes an ``fcntl`` lock on the ``native/`` directory, retries
until the library loads (or a deadline passes), re-arms the JAX module's
loader and asserts that it now loads, so a missing toolchain fails
loudly instead of comparing against the fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import time

import fgt_tpu.native as jnative

DEADLINE_S = 300.0


def _rearm():
    with jnative._lock:
        jnative._lib = None
        jnative._tried = False


def require_jax_native(deadline_s: float = DEADLINE_S) -> None:
    """Block until ``fgt_tpu.native`` loads its library in this process;
    raise ``AssertionError`` after ``deadline_s`` seconds."""
    if jnative._lib is not None:
        return
    fd = os.open(jnative._NATIVE_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        end = time.monotonic() + deadline_s
        while True:
            if os.path.exists(jnative._LIB_PATH):
                try:
                    ctypes.CDLL(jnative._LIB_PATH)
                except OSError:
                    pass                   # still being written
                else:
                    _rearm()
                    if jnative.available():
                        return
            else:
                _rearm()                   # its loader builds the library
                if jnative.available():
                    return
            if time.monotonic() > end:
                raise AssertionError(
                    f"the JAX package's native library {jnative._LIB_PATH} "
                    f"did not load within {deadline_s:.0f} s")
            time.sleep(0.2)
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
