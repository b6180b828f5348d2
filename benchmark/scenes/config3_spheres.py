"""Config 3 of the reference project's benchmark list: three glossy spheres
on a floor, depth-2 Whitted reflections, shadows from two lights (the
constants of ``tpurt_torch/scene/configs.py:config3_spheres``, frozen).
``build(params)`` returns the scene as plain arrays."""
from __future__ import annotations

import numpy as np

from benchmark.scenes import meshes


def build(params: dict) -> dict:
    floor_v, floor_t = meshes.quad((-6, 0, -6), (-6, 0, 6), (6, 0, 6), (6, 0, -6))
    base = {"ka": 0.0, "ks": 0.0, "shininess": 32.0, "reflectivity": 0.0, "texture_id": -1}
    return {
        "vertices": floor_v,
        "triangles": floor_t,
        "tri_mat": np.zeros(2, np.int32),
        "vnormals": meshes.vertex_normals(floor_v, floor_t),
        "uvs": np.zeros((4, 2), np.float32),
        "spheres": [((-1.2, 1.0, 0.0), 1.0, 1),
                    ((1.2, 0.7, 0.8), 0.7, 2),
                    ((0.2, 0.45, -1.3), 0.45, 3)],
        "materials": [
            {**base, "ka": 0.1, "kd": (0.6, 0.6, 0.6), "ks": 0.1, "reflectivity": 0.15},
            {**base, "ka": 0.05, "kd": (0.7, 0.2, 0.2), "ks": 0.6, "shininess": 64.0,
             "reflectivity": 0.4},
            {**base, "ka": 0.05, "kd": (0.2, 0.3, 0.7), "ks": 0.6, "shininess": 64.0,
             "reflectivity": 0.4},
            {**base, "ka": 0.05, "kd": (0.9, 0.8, 0.2), "ks": 0.3, "shininess": 16.0,
             "reflectivity": 0.25},
        ],
        "textures": None,
        "lights": [((4.0, 6.0, 4.0), (0.9, 0.9, 0.9)),
                   ((-5.0, 4.0, 1.0), (0.35, 0.35, 0.4))],
        "ambient": (1.0, 1.0, 1.0),
        "camera": {"eye": (0.0, 1.6, 5.0), "look_at": (0.0, 0.8, 0.0),
                   "up": (0.0, 1.0, 0.0), "fov_y": float(np.pi / 4)},
        "smooth": False,
    }
