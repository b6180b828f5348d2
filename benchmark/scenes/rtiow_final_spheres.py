"""The final scene of Peter Shirley's "Ray Tracing in One Weekend" (v3.2.3,
section 13.1 "A Final Render", ``random_scene()``): a ground sphere of
radius 1000, a grid of small spheres of radius 0.2 with random materials,
and three spheres of radius 1 (the constants and the draw of
``tpurt_torch/scene/configs.py:rtiow_final_spheres``, frozen).
``build(params)`` returns the scene as plain arrays.

The draw is the book's, with ``numpy.random.default_rng(params["scene_seed"])``
for ``random_double()``: each candidate draws choose_mat, then its centre's
x and z; a kept one then draws its material (diffuse: two random colours,
multiplied; metal: a colour in [0.5, 1), then the fuzz in [0, 0.5); glass:
nothing).  Whitted shading stands in for the book's materials: diffuse a is
kd a; metal (a, f) kd a·f, ks 0.5 at shininess 64, reflectivity 1 - f;
glass kd 0, ks 0.5 at shininess 128, reflectivity 0.04 (Schlick's R0 at
ior 1.5); ka 0.1 everywhere under the sky's zenith colour as ambient.

The scene has no triangles.  Like every scene of the program it holds one
degenerate triangle (its three corners at one point far away), which no ray
can hit."""
from __future__ import annotations

import math

import numpy as np

#: where the degenerate triangle's corners lie
PAD_POS = 1.0e7
KA = 0.1
GLASS_R0 = 0.04


def draw(seed: int) -> list:
    """(center, radius, kind, albedo, fuzz) of every sphere, in the book's
    order."""
    rng = np.random.default_rng(seed)
    out = [((0.0, -1000.0, 0.0), 1000.0, "diffuse", (0.5, 0.5, 0.5), 0.0)]
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rng.random()
            x = a + 0.9 * rng.random()
            z = b + 0.9 * rng.random()
            if math.hypot(x - 4.0, z) <= 0.9:
                continue
            if choose_mat < 0.8:
                c1 = [rng.random() for _ in range(3)]
                c2 = [rng.random() for _ in range(3)]
                out.append(((x, 0.2, z), 0.2, "diffuse",
                            tuple(p * q for p, q in zip(c1, c2)), 0.0))
            elif choose_mat < 0.95:
                albedo = tuple(0.5 + 0.5 * rng.random() for _ in range(3))
                out.append(((x, 0.2, z), 0.2, "metal", albedo, 0.5 * rng.random()))
            else:
                out.append(((x, 0.2, z), 0.2, "glass", (1.0, 1.0, 1.0), 0.0))
    out += [((0.0, 1.0, 0.0), 1.0, "glass", (1.0, 1.0, 1.0), 0.0),
            ((-4.0, 1.0, 0.0), 1.0, "diffuse", (0.4, 0.2, 0.1), 0.0),
            ((4.0, 1.0, 0.0), 1.0, "metal", (0.7, 0.6, 0.5), 0.0)]
    return out


def material(kind: str, albedo, fuzz: float) -> dict:
    base = {"ka": KA, "ks": 0.0, "shininess": 32.0, "reflectivity": 0.0, "texture_id": -1}
    if kind == "diffuse":
        return {**base, "kd": tuple(albedo)}
    if kind == "metal":
        return {**base, "kd": tuple(a * fuzz for a in albedo), "ks": 0.5, "shininess": 64.0,
                "reflectivity": 1.0 - fuzz}
    return {**base, "kd": (0.0, 0.0, 0.0), "ks": 0.5, "shininess": 128.0,
            "reflectivity": GLASS_R0}


def build(params: dict) -> dict:
    spheres = draw(params["scene_seed"])
    if "spheres" in params and len(spheres) != params["spheres"]:
        raise ValueError(f"the draw of seed {params['scene_seed']} gave {len(spheres)} "
                         f"spheres; the configuration states {params['spheres']}")
    return {
        "vertices": np.full((1, 3), PAD_POS, np.float32),
        "triangles": np.zeros((1, 3), np.int32),
        "tri_mat": np.zeros(1, np.int32),
        "vnormals": np.asarray([[0.0, 1.0, 0.0]], np.float32),
        "uvs": np.zeros((1, 2), np.float32),
        "spheres": [(c, r, i) for i, (c, r, *_) in enumerate(spheres)],
        "materials": [material(kind, albedo, fuzz) for _, _, kind, albedo, fuzz in spheres],
        "textures": None,
        "lights": [((10.0, 12.0, 6.0), (1.0, 1.0, 1.0)),
                   ((-8.0, 6.0, -4.0), (0.35, 0.35, 0.4))],
        "ambient": (0.5, 0.7, 1.0),
        "camera": {"eye": (13.0, 2.0, 3.0), "look_at": (0.0, 0.0, 0.0),
                   "up": (0.0, 1.0, 0.0), "fov_y": math.radians(20.0)},
        "smooth": False,
    }
