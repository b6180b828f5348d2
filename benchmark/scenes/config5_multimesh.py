"""Config 5 of the reference project's benchmark list: twelve displaced
blobs in three rings on a checkerboard floor, textured Phong, two lights
(the constants of ``tpurt_torch/scene/configs.py:config5_multimesh``,
frozen).  ``build(params)`` returns the scene as plain arrays (``scenes``
README in ``benchmark/README.md``)."""
from __future__ import annotations

import numpy as np

from benchmark.scenes import meshes


def build(params: dict) -> dict:
    n_blobs, subdiv = params["n_blobs"], params["subdiv"]
    parts = []
    for k in range(n_blobs):
        ang = 2 * np.pi * k / n_blobs
        ring = 1 + (k % 3)
        r = 1.4 * ring
        c = (r * np.cos(ang), 0.55 + 0.1 * (k % 4), r * np.sin(ang))
        bv, bt = meshes.displaced_blob(subdiv, radius=0.55, center=c, seed=k)
        parts.append((bv, bt, 1 + (k % 3)))
    fv, ft = meshes.quad((-12, 0, -12), (-12, 0, 12), (12, 0, 12), (12, 0, -12))
    fuv = np.asarray([[0, 0], [0, 8], [8, 8], [8, 0]], np.float32)
    parts.append((fv, ft, 0, fuv))
    verts, tris, tmat, uvs = meshes.merge(parts)
    base = {"shininess": 32.0, "reflectivity": 0.0, "texture_id": -1}
    return {
        "vertices": verts,
        "triangles": tris,
        "tri_mat": tmat,
        "vnormals": meshes.vertex_normals(verts, tris),
        "uvs": uvs,
        "spheres": [],
        "materials": [
            {**base, "ka": 0.1, "kd": (1.0, 1.0, 1.0), "ks": 0.05, "texture_id": 0},
            {**base, "ka": 0.06, "kd": (0.75, 0.3, 0.25), "ks": 0.35, "shininess": 48.0},
            {**base, "ka": 0.06, "kd": (0.25, 0.55, 0.3), "ks": 0.35, "shininess": 48.0},
            {**base, "ka": 0.06, "kd": (0.3, 0.35, 0.7), "ks": 0.35, "shininess": 48.0},
        ],
        "textures": meshes.checkerboard()[None],
        "lights": [((8.0, 10.0, 6.0), (1.0, 1.0, 1.0)),
                   ((-7.0, 6.0, -4.0), (0.35, 0.3, 0.3))],
        "ambient": (1.0, 1.0, 1.0),
        "camera": {"eye": (0.0, 3.2, 8.5), "look_at": (0.0, 0.7, 0.0),
                   "up": (0.0, 1.0, 0.0), "fov_y": float(np.pi / 4)},
        "smooth": True,
    }
