"""ctypes binding of the repository's host C++ kernels (``native/ocm_native.cpp``).

The port's own build of that source: ``g++`` with the flags of
``native/Makefile`` writes a shared library into ``_build/`` beside this
file, named by a hash of the source and the flags, so a changed source
builds anew and an unchanged one is built once per checkout. The build runs
under an ``fcntl`` lock and the finished library is moved into place with
``os.replace``, so processes started together (test workers) never load a
half-written file. Nothing is written under ``native/``.

Connected components (8-connectivity), small-object removal, binary
dilation and erosion with a structuring element, region properties and the
Otsu threshold, with the input checks of the JAX package's ``native.py``. A
failed build or load raises; there is no silent fallback (the scipy
versions in ``ops/morphology.py`` are the plain twins the tests hold these
against).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "ocm_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall"]  # native/Makefile's CXXFLAGS

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libocm_native_{h.hexdigest()[:16]}.so")


def build(path: str | None = None) -> str:
    """Compile the source into ``path`` unless it is there; returns the path.
    Concurrent callers (threads or processes) serialize on a lock file, and
    the library appears under its name only once it is complete."""
    path = path or library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.isfile(path):  # built by the holder before us
                return path
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
            os.close(fd)
            try:
                cxx = os.environ.get("CXX", "g++")
                res = subprocess.run([cxx, *CXX_FLAGS, "-shared", "-o", tmp, SOURCE],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"building {SOURCE} failed:\n{res.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def load():
    """The loaded library, built on the first call. Raises when the source
    does not build or the library does not load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32 = ctypes.c_int32
        lib.cc_label.restype = i32
        lib.cc_label.argtypes = [u8p, i32, i32, i32p]
        lib.remove_small_objects.restype = i32
        lib.remove_small_objects.argtypes = [u8p, i32, i32, i32, u8p]
        lib.binary_dilation.argtypes = [u8p, i32, i32, u8p, i32, i32, u8p]
        lib.binary_erosion.argtypes = [u8p, i32, i32, u8p, i32, i32, ctypes.c_uint8, u8p]
        lib.region_props.argtypes = [i32p, i32, i32, i32, i64p, f64p, i32p]
        lib.otsu_threshold.restype = ctypes.c_double
        lib.otsu_threshold.argtypes = [u8p, ctypes.c_int64]
        _lib = lib
        return lib


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check_symmetric_odd_se(se: np.ndarray):
    """The C++ morphology correlates with the structuring element as it is;
    scipy mirrors it and shifts the origin of even sizes. Both agree for a
    symmetric, odd-sized element (every disk), so only those are taken."""
    if se.shape[0] % 2 == 0 or se.shape[1] % 2 == 0 or not np.array_equal(se, se[::-1, ::-1]):
        raise ValueError("native morphology requires a symmetric, odd-sized structuring "
                         "element (scipy mirrors the element; the native kernel does not)")


def cc_label(mask: np.ndarray):
    """(labels int32 (H, W), n): 8-connected components, labelled 1..n in
    first-encounter (row-major) order, as scipy.ndimage.label numbers them."""
    lib = load()
    m = _u8(np.asarray(mask) != 0)
    h, w = m.shape
    labels = np.empty((h, w), np.int32)
    n = lib.cc_label(_ptr(m, ctypes.c_uint8), h, w, _ptr(labels, ctypes.c_int32))
    return labels, int(n)


def remove_small_objects(mask: np.ndarray, min_size: int = 20) -> np.ndarray:
    """bool (H, W): the 8-connected components of at least min_size pixels."""
    lib = load()
    m = _u8(np.asarray(mask) != 0)
    h, w = m.shape
    out = np.empty((h, w), np.uint8)
    lib.remove_small_objects(_ptr(m, ctypes.c_uint8), h, w, min_size, _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def _morph(fn, mask, se, *extra):
    _check_symmetric_odd_se(np.asarray(se) != 0)
    m, s = _u8(np.asarray(mask) != 0), _u8(np.asarray(se) != 0)
    h, w = m.shape
    out = np.empty((h, w), np.uint8)
    fn(_ptr(m, ctypes.c_uint8), h, w, _ptr(s, ctypes.c_uint8), s.shape[0], s.shape[1], *extra,
       _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def binary_dilation(mask: np.ndarray, se: np.ndarray) -> np.ndarray:
    """bool (H, W): dilation by se, out-of-image background."""
    return _morph(load().binary_dilation, mask, se)


def binary_erosion(mask: np.ndarray, se: np.ndarray, border_value: int = 0) -> np.ndarray:
    """bool (H, W): erosion by se, out-of-image pixels read as border_value."""
    return _morph(load().binary_erosion, mask, se, border_value)


def region_props(labels: np.ndarray, n: int):
    """(areas int64 (n,), centroids float64 (n, 2) as (x, y), bbox int32
    (n, 4)) of labels 1..n."""
    lib = load()
    lab = np.ascontiguousarray(labels, np.int32)
    h, w = lab.shape
    areas = np.empty(n, np.int64)
    centroids = np.empty((n, 2), np.float64)
    bbox = np.empty((n, 4), np.int32)
    lib.region_props(_ptr(lab, ctypes.c_int32), h, w, n, _ptr(areas, ctypes.c_int64),
                     _ptr(centroids, ctypes.c_double), _ptr(bbox, ctypes.c_int32))
    return areas, centroids, bbox


def otsu_threshold(img_u8: np.ndarray) -> float:
    """cv2's Otsu threshold of a uint8 array; 0.0 for an empty one."""
    lib = load()
    a = _u8(img_u8)
    if a.size == 0:
        return 0.0
    return float(lib.otsu_threshold(_ptr(a, ctypes.c_uint8), a.size))
