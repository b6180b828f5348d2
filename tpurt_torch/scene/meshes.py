"""Procedural meshes (host-side numpy, build time only), copied from
``tpurt/scene/meshes.py``: configs 4–5 use procedural stand-ins for mesh
files (a displaced icosphere for the bunny)."""
from __future__ import annotations

import numpy as np


def quad(p0, p1, p2, p3):
    """Two triangles for the quad p0-p1-p2-p3 (counter-clockwise winding).
    Returns (verts (4,3), tris (2,3))."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, tris


def box(lo, hi, inward=False):
    """Axis-aligned box as 12 triangles.  `inward=True` flips winding so
    normals point inside (Cornell-box walls).  Returns (verts (8,3),
    tris (12,3))."""
    x0, y0, z0 = np.asarray(lo, np.float32)
    x1, y1, z1 = np.asarray(hi, np.float32)
    verts = np.asarray(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ],
        np.float32,
    )
    faces = [
        (0, 3, 2, 1),  # z0 (back):  outward -z
        (4, 5, 6, 7),  # z1 (front): outward +z
        (0, 1, 5, 4),  # y0 (floor): outward -y
        (3, 7, 6, 2),  # y1 (ceil):  outward +y
        (0, 4, 7, 3),  # x0 (left):  outward -x
        (1, 2, 6, 5),  # x1 (right): outward +x
    ]
    tris = []
    for a, b, c, d in faces:
        if inward:
            tris += [[a, c, b], [a, d, c]]
        else:
            tris += [[a, b, c], [a, c, d]]
    return verts, np.asarray(tris, np.int32)


def icosphere(subdiv: int = 3, radius: float = 1.0, center=(0, 0, 0)):
    """Subdivided icosahedron: 20 * 4**subdiv triangles, deduped vertices.
    Returns (verts (V,3), tris (T,3))."""
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

    verts = verts * radius + np.asarray(center, np.float64)
    return verts.astype(np.float32), tris.astype(np.int32)


def displaced_blob(subdiv: int = 6, radius: float = 1.0, center=(0, 0, 0), seed=0):
    """A bunny-like organic blob: icosphere displaced by a few fixed spherical
    harmonics-ish lobes.  subdiv=6 → 81920 tris, the bunny
    stand-in of config 4.  Deterministic for a given seed."""
    verts, tris = icosphere(subdiv, 1.0, (0, 0, 0))
    rng = np.random.default_rng(seed)
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    disp = np.zeros(len(verts))
    for _ in range(6):
        a, b, c = rng.normal(size=3) * 2.0
        w = rng.uniform(0.05, 0.18)
        disp += w * np.sin(a * x + b * y + c * z)
    verts = verts * (1.0 + disp)[:, None]
    verts = verts * radius + np.asarray(center, np.float32)
    return verts.astype(np.float32), tris


def uv_sphere_grid(n_u: int, n_v: int, radius: float = 1.0, center=(0, 0, 0)):
    """UV sphere with an exact 2*n_u*n_v triangle count (pole triangles are
    zero-area and never hit) and natural texture coordinates.
    Returns (verts, tris, uvs)."""
    us = np.linspace(0.0, 1.0, n_u + 1)
    vs = np.linspace(0.0, 1.0, n_v + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")  # (n_u+1, n_v+1)
    theta = vv * np.pi
    phi = uu * 2.0 * np.pi
    x = np.sin(theta) * np.cos(phi)
    y = np.cos(theta)
    z = np.sin(theta) * np.sin(phi)
    verts = np.stack([x, y, z], -1).reshape(-1, 3) * radius + np.asarray(center)
    uvs = np.stack([uu, vv], -1).reshape(-1, 2)

    def vid(i, j):
        return i * (n_v + 1) + j

    tris = []
    for i in range(n_u):
        for j in range(n_v):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            tris.append([a, b, c])
            tris.append([a, c, d])
    return (
        verts.astype(np.float32),
        np.asarray(tris, np.int32),
        uvs.astype(np.float32),
    )


def merge(parts):
    """Concatenate (verts, tris[, uvs]) tuples, offsetting indices.
    Returns (verts, tris, mat_ids, uvs) where each part is
    (verts, tris, mat_id[, uvs])."""
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
