"""ctypes bindings for the repository's native IO runtime
(native/hugs_io.cpp, the COLMAP text and binary parsers), loaded by path.

As in the JAX package, the library is built with the repository's
Makefile on first use where it is missing or older than its source, and
every entry point returns None where it cannot be loaded, so that
data/colmap.py parses in pure Python instead. This is host IO; no device
work depends on it.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libhugs_io.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    src = os.path.join(_NATIVE_DIR, "hugs_io.cpp")
    stale = (not os.path.exists(_LIB_PATH)
             or (os.path.exists(src)
                 and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)))
    if stale:
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            if not os.path.exists(_LIB_PATH):
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.hugs_parse_points3d.restype = ctypes.c_int64
        lib.hugs_parse_points3d.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        lib.hugs_parse_images.restype = ctypes.c_int64
        lib.hugs_parse_images.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64]
        # binary-format parsers (same protocols); absent in a stale .so
        for name in ("hugs_parse_points3d_bin", "hugs_parse_images_bin"):
            try:
                fn = getattr(lib, name)
            except AttributeError:
                continue
            tmpl = (lib.hugs_parse_points3d if "points" in name
                    else lib.hugs_parse_images)
            fn.restype = tmpl.restype
            fn.argtypes = tmpl.argtypes
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def _parse_points3d_sym(path: str, sym: str):
    lib = _load()
    if lib is None or not hasattr(lib, sym):
        return None
    fn = getattr(lib, sym)
    n = fn(path.encode(), None, None, 0)
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.float32)
    got = fn(path.encode(), xyz.ctypes.data_as(ctypes.c_void_p),
             rgb.ctypes.data_as(ctypes.c_void_p), n)
    if got != n:
        return None
    return xyz, rgb


def _parse_images_sym(path: str, sym: str):
    lib = _load()
    if lib is None or not hasattr(lib, sym):
        return None
    fn = getattr(lib, sym)
    n = fn(path.encode(), None, None, None, None, 0, 0)
    if n < 0:
        return None
    quat = np.empty((n, 4), np.float64)
    trans = np.empty((n, 3), np.float64)
    cam_ids = np.empty(n, np.int32)
    names_cap = 65536 + 256 * n
    names_buf = ctypes.create_string_buffer(names_cap)
    got = fn(path.encode(), quat.ctypes.data_as(ctypes.c_void_p),
             trans.ctypes.data_as(ctypes.c_void_p),
             cam_ids.ctypes.data_as(ctypes.c_void_p),
             names_buf, names_cap, n)
    if got != n:
        return None
    names = names_buf.value.decode().split("\n")[:n]
    return quat, trans, cam_ids, names


def parse_points3d(path: str):
    """Fast points3D.txt parse -> (xyz (N,3) f32, rgb (N,3) f32 in [0,1])
    or None if the native lib is unavailable."""
    return _parse_points3d_sym(path, "hugs_parse_points3d")


def parse_points3d_bin(path: str):
    """points3D.bin (COLMAP binary model) -> same as parse_points3d."""
    return _parse_points3d_sym(path, "hugs_parse_points3d_bin")


def parse_images(path: str):
    """Fast images.txt parse -> (quat (N,4) f64 wxyz, trans (N,3) f64,
    cam_ids (N,) i32, names list[str]) or None."""
    return _parse_images_sym(path, "hugs_parse_images")


def parse_images_bin(path: str):
    """images.bin (COLMAP binary model) -> same as parse_images."""
    return _parse_images_sym(path, "hugs_parse_images_bin")
