"""Procedural meshes (host-side numpy, build time only), the two of
``tpurt/scene/meshes.py`` that configs 1–3 need."""
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
