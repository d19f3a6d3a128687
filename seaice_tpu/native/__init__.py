"""Native (C++) runtime components.

The device compute path is JAX/XLA; host-side mesh preprocessing that is
loop-heavy (the IR remap stencil construction) is implemented in C++
(remap_stencil.cpp), compiled to a shared library on first use and
bound via ctypes. The pure-Python implementations remain as reference
fallbacks and are equality-tested against the native versions.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "remap_stencil.cpp")
_LIB_PATH = os.path.join(_HERE, "_remap_stencil.so")
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    """Compile the shared library (g++ -O3) if missing or stale."""
    global _build_failed
    try:
        if (not os.path.exists(_LIB_PATH) or
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
            with tempfile.NamedTemporaryFile(
                    suffix=".so", dir=_HERE, delete=False) as tmp:
                tmp_path = tmp.name
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                   _SRC, "-o", tmp_path]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp_path, _LIB_PATH)
        return ctypes.CDLL(_LIB_PATH)
    except Exception:
        _build_failed = True
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        _lib = _build()
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def build_remap_stencil(mesh):
    """Native remap-stencil construction; returns
    (remap_edge, cells_rm, edges_rm, vocr, min_len, esoc) or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ne, nc, nv = mesh.n_edges, mesh.n_cells, mesh.n_vertices
    me, vd = mesh.max_edges, mesh.vertex_degree

    def i32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    def f64(a):
        return np.ascontiguousarray(a, dtype=np.float64)

    coe = i32(mesh.cells_on_edge)
    voe = i32(mesh.vertices_on_edge)
    eoc = i32(mesh.edges_on_cell)
    voc = i32(mesh.vertices_on_cell)
    neoc = i32(mesh.n_edges_on_cell)
    eov = i32(mesh.edges_on_vertex)
    dv = f64(mesh.dv_edge)

    remap_edge = np.zeros(ne, np.int32)
    cells_rm = np.zeros((ne, 6), np.int32)
    edges_rm = np.zeros((ne, 6), np.int32)
    vocr = np.zeros((ne, 6, 2), np.int32)
    min_len = np.zeros(nv, np.float64)
    esoc = np.zeros((nc, me), np.float64)

    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_f64p = ctypes.POINTER(ctypes.c_double)

    def ip(a):
        return a.ctypes.data_as(c_i32p)

    def fp(a):
        return a.ctypes.data_as(c_f64p)

    lib.build_remap_stencil(
        ctypes.c_int64(ne), ctypes.c_int64(nc), ctypes.c_int64(nv),
        ctypes.c_int64(me), ctypes.c_int64(vd),
        ip(coe), ip(voe), ip(eoc), ip(voc), ip(neoc), ip(eov), fp(dv),
        ip(remap_edge), ip(cells_rm), ip(edges_rm), ip(vocr),
        fp(min_len), fp(esoc))
    return remap_edge, cells_rm, edges_rm, vocr, min_len, esoc
