"""ctypes bridge to the native C++ builders (``tpurt_torch/native/builders.cpp``,
a byte-for-byte copy of ``tpurt/native/builders.cpp`` that a test holds
equal): the sweep-SAH cluster build, the uniform-grid build and the .obj
parse that ``prepare`` and ``load_obj`` go through.

The shared library is compiled with g++ at first use, with the flags of
``tpurt/native/Makefile``, into ``build/tpurt_torch/native-<hash>/`` at the
root of the checkout, never when a module is imported.  The hash covers the
source, the flags and the CPU target that -march=native picks on this
machine, so a library built for another CPU is never loaded.  A missing
compiler or a failed build raises with the compiler's output; nothing falls
back.  The numpy builders stay callable
by name as the plain versions: ``accel.clusters.build_clusters``,
``accel.grid.build_grid`` and ``scene.obj.parse_obj_lines``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from tpurt_torch.accel.clusters import LEAF, ClusterSet

SOURCE = Path(__file__).resolve().parents[1] / "native" / "builders.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpurt_torch"
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIB_NAME = "libtpurt_native.so"

_lib = None  # the loaded library, once per process


def _compile(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout


def build() -> Path:
    """Path of the built library, compiling it if this source, these flags
    and this machine's target (what -march=native resolves to) have no
    build yet."""
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found on PATH: it builds {SOURCE}")
    h = hashlib.sha256(" ".join((CXX, *CXXFLAGS)).encode())
    h.update(_compile([cxx, *CXXFLAGS, "-Q", "--help=target"]).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / f"native-{h.hexdigest()[:16]}"
    so = out_dir / LIB_NAME
    if so.is_file():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{os.getpid()}.{LIB_NAME}"
    try:
        _compile([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)])
        os.replace(tmp, so)  # atomic: another process never loads half a file
    finally:
        tmp.unlink(missing_ok=True)
    return so


def load() -> ctypes.CDLL:
    """The builders' library, built and loaded at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.tpurt_build_clusters.restype = ptr
        lib.tpurt_build_clusters.argtypes = [ptr, i64, ptr, i64, ctypes.c_int,
                                             ctypes.POINTER(i64)]
        lib.tpurt_build_grid.restype = ptr
        lib.tpurt_build_grid.argtypes = [ptr, i64, ptr, i64, ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(i64)]
        lib.tpurt_get_clusters.restype = None
        lib.tpurt_get_clusters.argtypes = [ptr] * 4
        lib.tpurt_free_clusters.restype = None
        lib.tpurt_free_clusters.argtypes = [ptr]
        lib.tpurt_load_obj.restype = ptr
        lib.tpurt_load_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64),
                                       ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(i64)]
        lib.tpurt_get_obj.restype = None
        lib.tpurt_get_obj.argtypes = [ptr] * 6
        lib.tpurt_obj_group_name.restype = ctypes.c_char_p
        lib.tpurt_obj_group_name.argtypes = [ptr, i64]
        lib.tpurt_free_obj.restype = None
        lib.tpurt_free_obj.argtypes = [ptr]
        _lib = lib
    return _lib


def _mesh(vertices, triangles):
    """Contiguous float32 (V, 3) and int32 (T, 3) copies, every index checked
    against V: the builders read the vertex rows the indices name."""
    verts = np.ascontiguousarray(vertices, np.float32)
    tris = np.ascontiguousarray(triangles, np.int32)
    if verts.ndim != 2 or verts.shape[1] != 3 or tris.ndim != 2 or tris.shape[1] != 3:
        raise ValueError(f"vertices {verts.shape} and triangles {tris.shape} must be (V, 3) "
                         "and (T, 3)")
    if tris.size and (int(tris.min()) < 0 or int(tris.max()) >= verts.shape[0]):
        raise ValueError(f"triangle indices outside [0, {verts.shape[0]})")
    return verts, tris


def _run(builder, vertices, triangles, leaf, *extra) -> ClusterSet:
    lib = load()
    verts, tris = _mesh(vertices, triangles)
    n = ctypes.c_int64(0)
    handle = builder(verts.ctypes.data, verts.shape[0], tris.ctypes.data, tris.shape[0],
                     *extra, leaf, ctypes.byref(n))
    try:
        tri_ids = np.empty((n.value, leaf), np.int32)
        lo = np.empty((n.value, 3), np.float32)
        hi = np.empty((n.value, 3), np.float32)
        if n.value:
            lib.tpurt_get_clusters(handle, tri_ids.ctypes.data, lo.ctypes.data,
                                   hi.ctypes.data)
    finally:
        lib.tpurt_free_clusters(handle)
    return ClusterSet(tri_ids=tri_ids, aabb_lo=lo, aabb_hi=hi)


def build_clusters_native(vertices, triangles, leaf: int = LEAF) -> ClusterSet:
    """Sweep-SAH cluster partition (the C++ counterpart of
    ``accel.clusters.build_clusters``; its plans are ``tpurt``'s)."""
    return _run(load().tpurt_build_clusters, vertices, triangles, leaf)


def build_grid_native(vertices, triangles, target_tris_per_cell: int = 64,
                      leaf: int = LEAF) -> ClusterSet:
    """Uniform-grid blocks (the C++ counterpart of ``accel.grid.build_grid``;
    its cell count and block order are the C++ builder's own)."""
    return _run(load().tpurt_build_grid, vertices, triangles, leaf, target_tris_per_cell)


def load_obj_native(path) -> dict:
    """Native .obj parse → the ``scene.obj.load_obj`` dict, equal array for
    array to the numpy parser (``scene.obj.parse_obj_lines``) on the file's
    lines."""
    lib = load()
    nv, nt, ng = ctypes.c_int64(0), ctypes.c_int64(0), ctypes.c_int64(0)
    has_n = ctypes.c_int(0)
    handle = lib.tpurt_load_obj(os.fsencode(path), ctypes.byref(nv), ctypes.byref(nt),
                                ctypes.byref(has_n), ctypes.byref(ng))
    if not handle:
        raise OSError(f"cannot read {os.fsdecode(path)!r}")
    try:
        verts = np.empty((nv.value, 3), np.float32)
        tris = np.empty((nt.value, 3), np.int32)
        uvs = np.empty((nv.value, 2), np.float32)
        nrms = np.empty((nv.value, 3), np.float32) if has_n.value else None
        tri_group = np.empty((nt.value,), np.int32)
        lib.tpurt_get_obj(handle, verts.ctypes.data, tris.ctypes.data, uvs.ctypes.data,
                          None if nrms is None else nrms.ctypes.data, tri_group.ctypes.data)
        groups = [lib.tpurt_obj_group_name(handle, i).decode() for i in range(ng.value)]
    finally:
        lib.tpurt_free_obj(handle)
    return {"vertices": verts, "triangles": tris, "uvs": uvs, "normals": nrms,
            "tri_group": tri_group, "groups": groups}
