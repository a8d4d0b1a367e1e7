"""Build-at-first-use for the port's shared libraries.

Each CUDA source under ``csrc/`` compiles with nvcc into its own shared
library with a plain C interface (bound with ctypes by its wrapper); the
host flowNN/Poisson kernels compile with g++. Outputs land in the
git-ignored ``fgt_tpu_torch/build/`` directory, named by a hash of the
source and flags, so an edited source rebuilds and concurrent processes
(test workers) never load a half-written file: each build writes a
temporary file and renames it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# the kernels each wrapper loads: name -> source under csrc/
CUDA_SOURCES = {
    "corr_fused": "corr_fused.cu",
    "flash_attention": "flash_attention.cu",
}

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _target(stem: str, source: str, cmd_flags: list) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(cmd_flags).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:12]}.so")


def _start(compiler: str, flags: list, source: str, out: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen([compiler] + flags + ["-o", tmp, source],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish(proc, tmp: str, out: str, timeout: float = 600.0) -> None:
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"build of {out} failed:\n{log}")
    os.replace(tmp, out)


def build_shared(stem: str, source: str, compiler: str, flags: list,
                 key: str = "") -> str:
    """Compile ``source`` into a cached shared library; returns its path.
    ``key`` joins the cache name (a host name for ``-march=native``)."""
    out = _target(stem, source, [compiler, key] + flags)
    if not os.path.exists(out):
        _finish(*_start(compiler, flags, source, out), out)
    return out


def build_cuda_kernels() -> float:
    """Build every CUDA kernel library not built yet, one nvcc process per
    source, all started together. Returns the wall seconds it took."""
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    running = []
    for name in CUDA_SOURCES:
        src = os.path.join(CSRC_DIR, CUDA_SOURCES[name])
        out = _target(name, src, [nvcc] + NVCC_FLAGS)
        if not os.path.exists(out):
            running.append((*_start(nvcc, NVCC_FLAGS, src, out), out))
    for proc, tmp, out in running:
        _finish(proc, tmp, out)
    return time.perf_counter() - t0


def load_cuda_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = os.path.join(CSRC_DIR, CUDA_SOURCES[name])
            lib = ctypes.CDLL(build_shared(name, src, nvcc_path(),
                                           NVCC_FLAGS))
            _libs[name] = lib
        return lib


def check_launch(err: int, kernel: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")
