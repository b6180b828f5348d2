"""Frozen numpy copies of the procedural meshes the benchmark scenes are made
of: a quad, a subdivided icosahedron, the displaced blob and the merge of
parts, with the arithmetic of ``tpurt_torch/scene/meshes.py`` as it stood
when the benchmark was defined.  They are copies, not imports, so that a
later change of the program's scene code cannot move the benchmark's
inputs; ``benchmark/tests/test_bench_reference.py`` holds them equal to the
program's at small sizes."""
from __future__ import annotations

import functools

import numpy as np


def quad(p0, p1, p2, p3):
    """Two triangles for the quad p0-p1-p2-p3: (verts (4, 3), tris (2, 3))."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, tris


@functools.lru_cache(maxsize=4)
def _unit_icosphere(subdiv: int):
    """The unit icosphere in float64, 20 * 4**subdiv triangles, vertices in
    the order the midpoints are first met.  Cached: every blob of a scene
    starts from the same sphere, and building it is most of the scene's
    host time.  Callers must not write to the arrays."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    tris = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        verts_list = list(verts)
        cache = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                cache[key] = len(verts_list)
                verts_list.append(m)
            return cache[key]

        new_tris = []
        for a, b, c in tris:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_tris += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        tris = np.asarray(new_tris, np.int64)
    verts.setflags(write=False)
    tris = tris.astype(np.int32)
    tris.setflags(write=False)
    return verts, tris


def displaced_blob(subdiv: int, radius: float, center, seed: int):
    """The unit icosphere displaced by six seeded sine lobes, scaled and
    moved: (verts (V, 3) float32, tris (T, 3) int32)."""
    verts, tris = _unit_icosphere(subdiv)
    verts = verts.astype(np.float32)
    rng = np.random.default_rng(seed)
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    disp = np.zeros(len(verts))
    for _ in range(6):
        a, b, c = rng.normal(size=3) * 2.0
        w = rng.uniform(0.05, 0.18)
        disp += w * np.sin(a * x + b * y + c * z)
    verts = verts * (1.0 + disp)[:, None]
    verts = verts * radius + np.asarray(center, np.float32)
    return verts.astype(np.float32), tris.copy()


def merge(parts):
    """Concatenate parts (verts, tris, mat_id[, uvs]), offsetting indices:
    (verts, tris, mat_ids, uvs)."""
    all_v, all_t, all_m, all_uv = [], [], [], []
    off = 0
    for part in parts:
        v, t, m = part[0], part[1], part[2]
        uv = part[3] if len(part) > 3 else np.zeros((len(v), 2), np.float32)
        all_v.append(v)
        all_t.append(t + off)
        all_m.append(np.full(len(t), m, np.int32))
        all_uv.append(uv)
        off += len(v)
    return (
        np.concatenate(all_v, 0),
        np.concatenate(all_t, 0),
        np.concatenate(all_m, 0),
        np.concatenate(all_uv, 0),
    )


def vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals, unit length (float32)."""
    vn = np.zeros_like(verts)
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    lens = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(lens, 1e-20)).astype(np.float32)


def checkerboard(n=64, c0=(0.9, 0.9, 0.9), c1=(0.2, 0.25, 0.3)):
    """An n × n checkerboard of 8-texel squares, (n, n, 3) float32."""
    ij = np.add.outer(np.arange(n) // 8, np.arange(n) // 8) % 2
    tex = np.where(ij[..., None] == 0, np.asarray(c0), np.asarray(c1))
    return tex.astype(np.float32)
