"""ctypes bindings to the native geometry engine (native/esucd_native.cc).

The shared library is built from source (g++, plain C ABI + ctypes) at
first use, and rebuilt whenever the source is newer than it.  It is a build
product that git ignores.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
from ...errors import ValueParsingError

_LIB = None

BUILDING_CLASSES = ("Shop", "School", "Hospital", "Household", "WorkPlace", "Unknown")
CLASS_SHOP, CLASS_SCHOOL, CLASS_HOSPITAL, CLASS_HOUSEHOLD, CLASS_WORKPLACE = range(5)


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def _lib_path() -> str:
    return os.path.join(_repo_root(), "native", "libesucd.so")


def load_library():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _lib_path()
    src = os.path.join(_repo_root(), "native", "esucd_native.cc")
    if not os.path.exists(path) or os.path.getmtime(path) < os.path.getmtime(src):
        # build beside the target, then rename: concurrent first uses never
        # load a half-written library
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src, "-lz"],
            check=True,
        )
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.esucd_parse_pbf.restype = ctypes.c_int
    lib.esucd_parse_pbf.argtypes = [
        ctypes.c_char_p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.esucd_assign_points.restype = None
    lib.esucd_assign_points.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.esucd_free.restype = None
    lib.esucd_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def parse_pbf(path, bounds=(-90.0, 90.0, -180.0, 180.0)):
    """Parse an OSM PBF extract into (classes, lats, lons, areas) arrays.

    ``bounds``: (min_lat, max_lat, min_lon, max_lon) pre-filter
    (osm_data/src/lib.rs:69-108 boundary filtering).
    """
    lib = load_library()
    classes = ctypes.POINTER(ctypes.c_int32)()
    lats = ctypes.POINTER(ctypes.c_double)()
    lons = ctypes.POINTER(ctypes.c_double)()
    areas = ctypes.POINTER(ctypes.c_double)()
    n = ctypes.c_int64()
    rc = lib.esucd_parse_pbf(
        path.encode(), bounds[0], bounds[1], bounds[2], bounds[3],
        ctypes.byref(classes), ctypes.byref(lats), ctypes.byref(lons),
        ctypes.byref(areas), ctypes.byref(n),
    )
    if rc != 0:
        raise ValueParsingError(f"esucd_parse_pbf failed with code {rc}")
    count = n.value
    out = (
        np.ctypeslib.as_array(classes, (count,)).copy(),
        np.ctypeslib.as_array(lats, (count,)).copy(),
        np.ctypeslib.as_array(lons, (count,)).copy(),
        np.ctypeslib.as_array(areas, (count,)).copy(),
    )
    for p in (classes, lats, lons, areas):
        lib.esucd_free(p)
    return out


def assign_points_to_polygons(px, py, rings, ring_starts):
    """out[i] = index of the polygon containing point i, or -1.

    ``rings``: (M, 2) concatenated exterior-ring vertices; ``ring_starts``:
    (n_polys+1,) offsets.  Grid-indexed ray casting in C++ — the batch
    replacement for the reference's quadtree containment pass
    (simulator_builder.rs:1322-1366).
    """
    lib = load_library()
    px = np.ascontiguousarray(px, np.float64)
    py = np.ascontiguousarray(py, np.float64)
    rx = np.ascontiguousarray(rings[:, 0], np.float64)
    ry = np.ascontiguousarray(rings[:, 1], np.float64)
    starts = np.ascontiguousarray(ring_starts, np.int64)
    out = np.empty(len(px), np.int32)
    lib.esucd_assign_points(
        px.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        py.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(px),
        rx.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ry.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(starts) - 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
