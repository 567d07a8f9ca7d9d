"""ctypes bridge to the native host library (rt_tpu_torch/native/
rt_native.cpp), the twin of rt_tpu/io/native.py.

Built with `g++ -O2 -shared -fPIC` at first use into rt_tpu_torch/_build/
(listed in .gitignore) under a name keyed by a hash of the source, so an
edit rebuilds and an unchanged tree reuses the library; the build writes
a temporary file and renames it, so processes that build at once do not
load a half-written library. Every entry point degrades to its NumPy
counterpart when no compiler is available (import never fails), with
one warning that says why; `available()` says whether the library loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "rt_native.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"librt_native-{h.hexdigest()[:16]}.so"


def _build_and_load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            out = library_path()
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                                str(SOURCE)], check=True, capture_output=True)
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            lib.rt_write_ppm.restype = ctypes.c_int
            lib.rt_write_ppm.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8)]
            lib.rt_build_bvh.restype = ctypes.c_int
            lib.rt_build_bvh.argtypes = [
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
            _lib = lib
        except Exception as e:
            _lib = None
            detail = getattr(e, "stderr", None) or e
            if isinstance(detail, bytes):
                detail = detail.decode(errors="replace")
            warnings.warn(f"native library {SOURCE.name} did not build or "
                          f"load ({str(detail).strip()[:400]}); the NumPy "
                          f"fallbacks run instead", RuntimeWarning,
                          stacklevel=3)
        return _lib


def available() -> bool:
    """Whether the native library built (or was built) and loaded."""
    return _build_and_load() is not None


def native_write_ppm(path: str, u8_topdown: np.ndarray) -> bool:
    """C fast path for the ASCII PPM writer; False -> caller falls back."""
    lib = _build_and_load()
    if lib is None:
        return False
    img = np.ascontiguousarray(u8_topdown.astype(np.uint8))
    h, w, _ = img.shape
    rc = lib.rt_write_ppm(
        path.encode(), w, h,
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return rc == 0


def native_build_bvh(bmin: np.ndarray, bmax: np.ndarray):
    """Median-split threaded BVH (taichi-version/bvh.py semantics).

    bmin/bmax: [n,3] f32 primitive AABBs. Returns dict of flat arrays
    (obj_id, left_id, right_id, next_id, bmin, bmax) with 2n-1 nodes, or
    None if the native library is unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    n = bmin.shape[0]
    m = 2 * n - 1
    obj_id = np.empty(m, np.int32)
    left_id = np.empty(m, np.int32)
    right_id = np.empty(m, np.int32)
    next_id = np.empty(m, np.int32)
    bmin_o = np.empty((m, 3), np.float32)
    bmax_o = np.empty((m, 3), np.float32)

    def f32p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def i32p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = lib.rt_build_bvh(n, f32p(bmin), f32p(bmax), i32p(obj_id),
                          i32p(left_id), i32p(right_id), i32p(next_id),
                          f32p(bmin_o), f32p(bmax_o))
    if rc != m:
        return None
    return dict(obj_id=obj_id, left_id=left_id, right_id=right_id,
                next_id=next_id, bmin=bmin_o, bmax=bmax_o)
