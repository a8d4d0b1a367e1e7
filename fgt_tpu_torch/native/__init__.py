"""ctypes bindings for the host flowNN / Poisson kernels.

The source is the repository's ``native/fgt_native.cpp``; this loader
compiles its own copy with g++ into the port's git-ignored build
directory at first use (same flags as ``native/Makefile``) and binds only
what the object-removal path calls: ``flownn_pass``, ``flownn_sample``,
``flownn_fuse`` (stage s4) and ``unfilled_mask`` (stage s5). There is no
Python fallback: a missing compiler raises.
"""

from __future__ import annotations

import ctypes
import os
import platform
import threading

import numpy as np

from fgt_tpu_torch.ops._build import PKG_DIR, build_shared

SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native", "fgt_native.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-fopenmp"]

_lock = threading.Lock()
_lib = None

_u8 = ctypes.POINTER(ctypes.c_uint8)
_f32 = ctypes.POINTER(ctypes.c_float)
_i32 = ctypes.POINTER(ctypes.c_int32)
_int = ctypes.c_int


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            # -march=native code is only valid on the host that built it
            lib = ctypes.CDLL(build_shared("fgt_native", SOURCE, "g++",
                                           CXX_FLAGS, key=platform.node()))
            lib.flownn_pass.restype = None
            lib.flownn_pass.argtypes = [_u8, _f32, _f32, _int, _int, _int,
                                        _int, ctypes.c_float, _u8, _f32,
                                        _f32, _i32, _f32, _f32]
            lib.flownn_sample.restype = None
            lib.flownn_sample.argtypes = [_f32, _u8, _f32, _f32, _i32, _int,
                                          _int, _int, _int, _int]
            lib.flownn_fuse.restype = None
            lib.flownn_fuse.argtypes = [_f32, _f32, _f32, _f32, _u8, _f32,
                                        _f32, _u8, _f32, _f32, _u8, _u8,
                                        ctypes.c_float, _int, _int, _int,
                                        _int]
            lib.unfilled_mask.restype = None
            lib.unfilled_mask.argtypes = [_u8, _u8, _int, _int, _u8]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _c(a: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype)


def flownn_pass(mask: np.ndarray, flow_follow: np.ndarray,
                flow_check: np.ndarray, forward: bool, thres: float):
    """One directional flowNN chaining pass.

    mask: [N, H, W] uint8; flow_follow/flow_check: [N-1, H, W, 2] f32.
    Returns (have u8, nn_x f32, nn_y f32, nn_t i32, cons_u f32,
    cons_v f32), each [N, H, W]."""
    lib = _load()
    m = _c(mask, np.uint8)
    ff = _c(flow_follow, np.float32)
    fc = _c(flow_check, np.float32)
    n, h, w = m.shape
    if ff.shape != (n - 1, h, w, 2) or fc.shape != ff.shape:
        raise ValueError(f"flow shapes {ff.shape}/{fc.shape} do not match "
                         f"mask {m.shape}")
    have = np.zeros((n, h, w), np.uint8)
    nn_x = np.zeros((n, h, w), np.float32)
    nn_y = np.zeros((n, h, w), np.float32)
    nn_t = np.full((n, h, w), -1, np.int32)
    cons_u = np.zeros((n, h, w), np.float32)
    cons_v = np.zeros((n, h, w), np.float32)
    lib.flownn_pass(_ptr(m, ctypes.c_uint8), _ptr(ff, ctypes.c_float),
                    _ptr(fc, ctypes.c_float), int(forward), n, h, w,
                    float(thres), _ptr(have, ctypes.c_uint8),
                    _ptr(nn_x, ctypes.c_float), _ptr(nn_y, ctypes.c_float),
                    _ptr(nn_t, ctypes.c_int32), _ptr(cons_u, ctypes.c_float),
                    _ptr(cons_v, ctypes.c_float))
    return have, nn_x, nn_y, nn_t, cons_u, cons_v


def flownn_sample(grad: np.ndarray, have: np.ndarray, nn_x: np.ndarray,
                  nn_y: np.ndarray, nn_t: np.ndarray,
                  forward: bool) -> None:
    """Chain-endpoint sampling, IN PLACE on ``grad`` ([N, H, W, C]
    contiguous f32): the evolving-array semantics make the kernel
    in-place by construction. have/nn_*: the flownn_pass outputs."""
    lib = _load()
    if grad.dtype != np.float32 or not grad.flags["C_CONTIGUOUS"]:
        raise ValueError("flownn_sample mutates a C-contiguous f32 array")
    hv = _c(have, np.uint8)
    nx = _c(nn_x, np.float32)
    ny = _c(nn_y, np.float32)
    nt = _c(nn_t, np.int32)
    n, h, w, c = grad.shape
    if hv.shape != (n, h, w):
        raise ValueError(f"have {hv.shape} vs grad {grad.shape}")
    lib.flownn_sample(_ptr(grad, ctypes.c_float), _ptr(hv, ctypes.c_uint8),
                      _ptr(nx, ctypes.c_float), _ptr(ny, ctypes.c_float),
                      _ptr(nt, ctypes.c_int32), int(forward), n, h, w, c)


def flownn_fuse(gx: np.ndarray, gy: np.ndarray, s_bn: np.ndarray,
                s_fn: np.ndarray, bn_pass, fn_pass, mask: np.ndarray,
                alpha: float) -> np.ndarray:
    """BN/FN candidate fusion, in place on gx/gy ([N, H, W, C] contiguous
    f32, mutated at hole pixels). s_bn/s_fn: [N, H, W, 2C] sampled
    gradients (gx|gy stacked on channels). Returns tofill [N, H, W] u8."""
    lib = _load()
    n, h, w, c = gx.shape
    for a, want in ((gx, (n, h, w, c)), (gy, (n, h, w, c)),
                    (s_bn, (n, h, w, 2 * c)), (s_fn, (n, h, w, 2 * c))):
        if (a.dtype != np.float32 or not a.flags["C_CONTIGUOUS"]
                or a.shape != want):
            raise ValueError(f"flownn_fuse needs C f32 {want}, got "
                             f"{a.dtype} {a.shape}")
    have_bn, _, _, _, cu_bn, cv_bn = bn_pass
    have_fn, _, _, _, cu_fn, cv_fn = fn_pass
    m = _c(mask, np.uint8)
    tofill = np.empty((n, h, w), np.uint8)
    lib.flownn_fuse(
        _ptr(gx, ctypes.c_float), _ptr(gy, ctypes.c_float),
        _ptr(s_bn, ctypes.c_float), _ptr(s_fn, ctypes.c_float),
        _ptr(have_bn, ctypes.c_uint8), _ptr(cu_bn, ctypes.c_float),
        _ptr(cv_bn, ctypes.c_float), _ptr(have_fn, ctypes.c_uint8),
        _ptr(cu_fn, ctypes.c_float), _ptr(cv_fn, ctypes.c_float),
        _ptr(m, ctypes.c_uint8), _ptr(tofill, ctypes.c_uint8),
        float(alpha), n, h, w, c)
    return tofill


def unfilled_mask(hole: np.ndarray, gm: np.ndarray) -> np.ndarray:
    """Poisson connectivity check: hole pixels unreachable through
    gradient-valid paths. hole/gm: [H, W] bool-ish; returns [H, W] bool."""
    lib = _load()
    h_arr = _c(hole.astype(np.uint8), np.uint8)
    g_arr = _c(gm.astype(np.uint8), np.uint8)
    h, w = h_arr.shape
    if g_arr.shape != (h, w):
        raise ValueError(f"gradient mask {g_arr.shape} vs hole {(h, w)}")
    out = np.empty((h, w), np.uint8)
    lib.unfilled_mask(_ptr(h_arr, ctypes.c_uint8), _ptr(g_arr, ctypes.c_uint8),
                      h, w, _ptr(out, ctypes.c_uint8))
    return out.astype(bool)
