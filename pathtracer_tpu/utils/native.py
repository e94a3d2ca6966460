"""ctypes bindings to the optional native C++ helpers in ``native/``.

The reference keeps its I/O-heavy and build-heavy components native (fpng
PNG encoder, tinyobjloader, the C++ BVH builder inside bvh.h).  Our analogs
live in ``native/pathtracer_native.cc``.  The shared library is not kept in
git: the first use builds it with ``make -C native`` (under a file lock, to
a temporary name renamed into place, so several processes starting at once
build it once and never load a half-written file).  Every caller has a
pure-Python fallback, so the framework works where no compiler is present.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import warnings
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native")
LIB_PATH = os.path.join(_NATIVE_DIR, "libpathtracer_native.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "pathtracer_native.cc")

_LIB = None
_TRIED = False


def _up_to_date() -> bool:
    return (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(_SRC_PATH))


def build() -> Optional[str]:
    """Build the library if it is missing or older than its source;
    returns its path, or None when it cannot be built."""
    if not os.path.exists(_SRC_PATH):
        return LIB_PATH if os.path.exists(LIB_PATH) else None
    if _up_to_date():
        return LIB_PATH
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _up_to_date():  # another process built it while we waited
            return LIB_PATH
        tmp = f"libpathtracer_native.so.tmp.{os.getpid()}"
        try:
            subprocess.run(["make", "-s", "-C", _NATIVE_DIR, f"OUT={tmp}"],
                           check=True, capture_output=True, text=True)
        except (OSError, subprocess.CalledProcessError) as e:
            warnings.warn(f"native library not built ({e}); using the "
                          f"Python fallbacks", stacklevel=2)
            return None
        os.replace(os.path.join(_NATIVE_DIR, tmp), LIB_PATH)
    return LIB_PATH


def get_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)

    lib.pt_write_png.restype = ctypes.c_int
    lib.pt_write_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int,
    ]

    lib.pt_build_bvh.restype = ctypes.c_int
    lib.pt_build_bvh.argtypes = [
        ctypes.c_int,                       # n triangles
        ctypes.POINTER(ctypes.c_float),     # tri_lb (n,3)
        ctypes.POINTER(ctypes.c_float),     # tri_rt (n,3)
        ctypes.POINTER(ctypes.c_float),     # centroids (n,3)
        ctypes.POINTER(ctypes.c_float),     # out node lb (2n,3)
        ctypes.POINTER(ctypes.c_float),     # out node rt (2n,3)
        ctypes.POINTER(ctypes.c_int),       # out left (2n,)
        ctypes.POINTER(ctypes.c_int),       # out right (2n,)
        ctypes.POINTER(ctypes.c_int),       # out tri_start (2n,)
        ctypes.POINTER(ctypes.c_int),       # out tri_end (2n,)
        ctypes.POINTER(ctypes.c_int),       # out tri_idx (n,)
    ]
    _LIB = lib
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def write_png(filename: str, rgb_u8: np.ndarray) -> bool:
    """Native PNG write; returns False if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w, _ = rgb_u8.shape
    ok = lib.pt_write_png(
        filename.encode(),
        rgb_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h,
    )
    return bool(ok)


def build_bvh(tri_lb, tri_rt, centroids) -> Optional[Tuple[np.ndarray, ...]]:
    """Native SAH build; returns flat arrays or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = tri_lb.shape[0]
    tri_lb = np.ascontiguousarray(tri_lb, np.float32)
    tri_rt = np.ascontiguousarray(tri_rt, np.float32)
    centroids = np.ascontiguousarray(centroids, np.float32)
    cap = 2 * n
    lb = np.zeros((cap, 3), np.float32)
    rt = np.zeros((cap, 3), np.float32)
    left = np.zeros(cap, np.int32)
    right = np.zeros(cap, np.int32)
    start = np.zeros(cap, np.int32)
    end = np.zeros(cap, np.int32)
    tri_idx = np.zeros(n, np.int32)
    m = lib.pt_build_bvh(
        n, _fptr(tri_lb), _fptr(tri_rt), _fptr(centroids),
        _fptr(lb), _fptr(rt), _iptr(left), _iptr(right),
        _iptr(start), _iptr(end), _iptr(tri_idx),
    )
    if m <= 0:
        return None
    return lb[:m], rt[:m], left[:m], right[:m], start[:m], end[:m], tri_idx
