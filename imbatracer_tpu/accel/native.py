"""ctypes binding for the native C++ BVH builder.

The reference's builders are in-repo C++ (core/fast_bvh_builder.h,
core/sbvh_builder.h); this is the renderer's native equivalent. The
shared library is compiled on first use (g++ -O3) and cached next to the
source; the NumPy builder (accel/builder.py) remains the portable
fallback so nothing hard-depends on a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..utils.log import logger
from .builder import BvhNodes

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cpp", "bvh_builder.cpp")
_LIB = os.path.join(_HERE, "cpp", "libbvh.so")

_lib = None
_tried = False


def _compile() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-o", _LIB, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            logger.warning("native builder compile failed: %s",
                           res.stderr.decode()[:500])
            return False
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("native builder compile error: %s", e)
        return False


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB) or (
        os.path.exists(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
    ):
        if not _compile():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
        lib.imba_build_bvh.restype = ctypes.c_int
        lib.imba_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.imba_build_sbvh.restype = ctypes.c_int
        lib.imba_build_sbvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
    except (OSError, AttributeError) as e:
        logger.warning("native builder load failed: %s", e)
    return _lib


def build_bvh_native(bbox_lo, bbox_hi, centers=None, leaf_size=4,
                     traversal_cost=1.0) -> BvhNodes | None:
    """Native binned-SAH build; returns None if the library is unavailable
    (callers fall back to the NumPy builder)."""
    lib = get_lib()
    if lib is None:
        return None
    n = bbox_lo.shape[0]
    lo = np.ascontiguousarray(bbox_lo, np.float32)
    hi = np.ascontiguousarray(bbox_hi, np.float32)
    if centers is None:
        centers = 0.5 * (lo + hi)
    ce = np.ascontiguousarray(centers, np.float32)

    cap = 2 * n + 2
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    right = np.empty(cap, np.int32)
    start = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    prim_ids = np.empty(n, np.int32)

    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    n_nodes = lib.imba_build_bvh(
        fp(lo), fp(hi), fp(ce), n, leaf_size, ctypes.c_float(traversal_cost),
        fp(node_min), fp(node_max), ip(right), ip(start), ip(count), ip(prim_ids),
    )
    if n_nodes <= 0:
        logger.warning("native builder returned %d", n_nodes)
        return None
    return BvhNodes(
        bbox_min=node_min[:n_nodes].copy(),
        bbox_max=node_max[:n_nodes].copy(),
        right=right[:n_nodes].copy(),
        start=start[:n_nodes].copy(),
        count=count[:n_nodes].copy(),
        prim_ids=prim_ids,
    )


def build_sbvh_native(tri_verts, leaf_size=4, alpha=1e-5,
                      ref_budget=1.5) -> BvhNodes | None:
    """Native spatial-split build (reference core/sbvh_builder.h role);
    tri_verts: (N, 3, 3).  Returns None if the library is unavailable
    (callers fall back to accel/sbvh.py)."""
    lib = get_lib()
    if lib is None:
        return None
    n = tri_verts.shape[0]
    tv = np.ascontiguousarray(tri_verts, np.float32)

    node_cap = 4 * n + 2
    max_refs = int(n * ref_budget) + 16
    node_min = np.empty((node_cap, 3), np.float32)
    node_max = np.empty((node_cap, 3), np.float32)
    right = np.empty(node_cap, np.int32)
    start = np.empty(node_cap, np.int32)
    count = np.empty(node_cap, np.int32)
    prim_ids = np.empty(max_refs, np.int32)
    num_refs = np.zeros(1, np.int32)

    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    n_nodes = lib.imba_build_sbvh(
        fp(tv), n, leaf_size, ctypes.c_float(alpha),
        ctypes.c_float(ref_budget),
        fp(node_min), fp(node_max), ip(right), ip(start), ip(count),
        ip(prim_ids), ip(num_refs),
    )
    if n_nodes <= 0:
        logger.warning("native sbvh returned %d", n_nodes)
        return None
    return BvhNodes(
        bbox_min=node_min[:n_nodes].copy(),
        bbox_max=node_max[:n_nodes].copy(),
        right=right[:n_nodes].copy(),
        start=start[:n_nodes].copy(),
        count=count[:n_nodes].copy(),
        prim_ids=prim_ids[: int(num_refs[0])].copy(),
    )
