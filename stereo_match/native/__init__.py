"""ctypes bindings for the native host-side library (see smt_native.cpp).

Builds on first use with g++ (cached as smt_native.so next to the source);
every entry point has a pure-Python/scipy fallback so the package works
without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "smt_native.cpp")
_LIB = os.path.join(_HERE, "smt_native.so")
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", _LIB, _SRC],
                check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB)
        lib.smt_delaunay.restype = ctypes.c_int
        lib.smt_delaunay.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.smt_rasterize_planes.restype = None
        lib.smt_rasterize_planes.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        lib.smt_speckle_filter.restype = ctypes.c_int
        lib.smt_speckle_filter.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int]
        _lib = lib
    except Exception:
        _build_failed = True
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def delaunay(points_xy: np.ndarray) -> np.ndarray:
    """(n, 2) points -> (m, 3) triangle vertex indices."""
    pts = np.ascontiguousarray(points_xy, dtype=np.float64)
    n = len(pts)
    lib = _load()
    if lib is None:
        from scipy.spatial import Delaunay
        return Delaunay(pts).simplices.astype(np.int32)
    max_tris = max(4 * n, 64)
    out = np.empty((max_tris, 3), np.int32)
    m = lib.smt_delaunay(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_tris)
    if m < 0:
        raise RuntimeError("delaunay triangle buffer overflow")
    return out[:m].copy()


def rasterize_planes(triangles: np.ndarray, support_xyd: np.ndarray,
                     height: int, width: int) -> np.ndarray:
    """Triangles + (x, y, d) vertices -> (H, W) interpolated disparity
    prior (NaN outside the support hull)."""
    tris = np.ascontiguousarray(triangles, np.int32)
    sup = np.ascontiguousarray(support_xyd, np.float64)
    lib = _load()
    if lib is None:
        return _rasterize_py(tris, sup, height, width)
    mu = np.empty((height, width), np.float32)
    lib.smt_rasterize_planes(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(tris),
        sup.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(sup),
        height, width, mu.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return mu


def _rasterize_py(tris, sup, height, width):
    mu = np.full((height, width), np.nan, np.float32)
    yy, xx = np.mgrid[0:height, 0:width]
    for a, b, c in tris:
        ax, ay, ad = sup[a]
        bx, by, bd = sup[b]
        cx, cy, cd = sup[c]
        den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        if abs(den) < 1e-12:
            continue
        l1 = ((by - cy) * (xx - cx) + (cx - bx) * (yy - cy)) / den
        l2 = ((cy - ay) * (xx - cx) + (ax - cx) * (yy - cy)) / den
        l3 = 1.0 - l1 - l2
        inside = (l1 >= -1e-9) & (l2 >= -1e-9) & (l3 >= -1e-9)
        mu[inside] = (l1 * ad + l2 * bd + l3 * cd)[inside].astype(np.float32)
    return mu


def speckle_filter_host(disparity: np.ndarray, max_speckle_size: int,
                        max_diff: float) -> np.ndarray:
    """Host-side exact speckle filter (cv::filterSpeckles semantics)."""
    disp = np.ascontiguousarray(disparity, np.float32).copy()
    lib = _load()
    if lib is None:
        from stereo_match.ops.speckle import speckle_filter
        import jax.numpy as jnp
        return np.asarray(speckle_filter(jnp.asarray(disp),
                                         max_speckle_size, max_diff))
    lib.smt_speckle_filter(
        disp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        disp.shape[0], disp.shape[1], float(max_diff), int(max_speckle_size))
    return disp
