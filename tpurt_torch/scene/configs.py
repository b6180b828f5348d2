"""The five benchmark scene configs of ``tpurt/scene/configs.py``, at the
same defaults, and one smooth-shaded test scene of the port's own.  Each
returns (scene, RenderConfig).  Configs 1–3 render through the phase-1
kernels, configs 4–5 (meshes of 81,922 and 983,042 triangles) through the
clustered path."""
from __future__ import annotations

import numpy as np

from tpurt_torch.core.types import RenderConfig
from tpurt_torch.scene import meshes
from tpurt_torch.scene.scene import Camera, build_scene


def config1_sphere(height=256, width=256, pad_to=1, device=None):
    """Config 1: single diffuse sphere + point light, primary rays."""
    scene = build_scene(
        spheres=[((0.0, 0.0, 0.0), 1.0, 0)],
        materials=[{"ka": 0.1, "kd": (0.8, 0.3, 0.3), "ks": 0.0}],
        lights=[((3.0, 4.0, 5.0), (1.0, 1.0, 1.0))],
        camera=Camera.make((0.0, 0.0, 4.0), (0.0, 0.0, 0.0), device=device),
        pad_tris_to=pad_to,
        pad_spheres_to=pad_to,
        device=device,
    )
    cfg = RenderConfig(width=width, height=height, max_depth=0, shadows=False)
    return scene, cfg


def config2_cornell(height=512, width=512, pad_to=1, device=None):
    """Config 2: Cornell box (36 tris) with shadow rays."""
    white, red, green, boxm = 0, 1, 2, 3
    room_v, room_t = meshes.box((-1, 0, -1), (1, 2, 1), inward=True)
    # faces of meshes.box: back(z0), front(z1), floor(y0), ceil(y1),
    # left(x0), right(x1); the front wall (faces 2,3) is dropped because the
    # camera looks through it
    room_m = np.asarray([white] * 8 + [red] * 2 + [green] * 2, np.int32)
    keep = np.ones(12, bool)
    keep[2:4] = False
    room_t, room_m = room_t[keep], room_m[keep]

    tall_v, tall_t = meshes.box((-0.65, 0.0, -0.6), (-0.15, 1.2, -0.1))
    short_v, short_t = meshes.box((0.15, 0.0, 0.0), (0.65, 0.6, 0.5))

    verts = np.concatenate([room_v, tall_v, short_v], 0)
    tris = np.concatenate(
        [room_t, tall_t + len(room_v), short_t + len(room_v) + len(tall_v)], 0
    )
    tmat = np.concatenate([room_m, np.full(12, boxm), np.full(12, boxm)], 0)

    scene = build_scene(
        vertices=verts,
        triangles=tris,
        tri_mat=tmat,
        materials=[
            {"ka": 0.1, "kd": (0.73, 0.73, 0.73)},
            {"ka": 0.1, "kd": (0.65, 0.05, 0.05)},
            {"ka": 0.1, "kd": (0.12, 0.45, 0.15)},
            {"ka": 0.1, "kd": (0.73, 0.73, 0.68)},
        ],
        lights=[((0.0, 1.9, 0.0), (1.0, 1.0, 1.0))],
        # generic-position camera: exact axis alignment puts pixel centers
        # on wall-seam diagonals, where tie-breaking is ill-defined
        camera=Camera.make((0.013, 1.004, 3.4), (0.0, 1.0, 0.0), fov_y=np.pi / 4,
                           device=device),
        pad_tris_to=pad_to,
        pad_spheres_to=pad_to,
        device=device,
    )
    cfg = RenderConfig(width=width, height=height, max_depth=0, shadows=True)
    return scene, cfg


def config3_spheres(height=512, width=512, pad_to=1, device=None):
    """Config 3: three glossy spheres on a floor, depth-2 Whitted, shadows
    from two lights."""
    floor_v, floor_t = meshes.quad(
        (-6, 0, -6), (-6, 0, 6), (6, 0, 6), (6, 0, -6)
    )
    scene = build_scene(
        vertices=floor_v,
        triangles=floor_t,
        tri_mat=np.zeros(2, np.int32),
        spheres=[
            ((-1.2, 1.0, 0.0), 1.0, 1),
            ((1.2, 0.7, 0.8), 0.7, 2),
            ((0.2, 0.45, -1.3), 0.45, 3),
        ],
        materials=[
            {"ka": 0.1, "kd": (0.6, 0.6, 0.6), "ks": 0.1, "reflectivity": 0.15},
            {"ka": 0.05, "kd": (0.7, 0.2, 0.2), "ks": 0.6, "shininess": 64.0,
             "reflectivity": 0.4},
            {"ka": 0.05, "kd": (0.2, 0.3, 0.7), "ks": 0.6, "shininess": 64.0,
             "reflectivity": 0.4},
            {"ka": 0.05, "kd": (0.9, 0.8, 0.2), "ks": 0.3, "shininess": 16.0,
             "reflectivity": 0.25},
        ],
        lights=[
            ((4.0, 6.0, 4.0), (0.9, 0.9, 0.9)),
            ((-5.0, 4.0, 1.0), (0.35, 0.35, 0.4)),
        ],
        camera=Camera.make((0.0, 1.6, 5.0), (0.0, 0.8, 0.0), fov_y=np.pi / 4,
                           device=device),
        pad_tris_to=pad_to,
        pad_spheres_to=pad_to,
        device=device,
    )
    cfg = RenderConfig(width=width, height=height, max_depth=2, shadows=True)
    return scene, cfg


def config4_bunny(height=1024, width=1024, subdiv=6, pad_to=1, device=None):
    """Config 4: one mesh (bunny stand-in: displaced icosphere, 20*4**subdiv
    tris; subdiv=6 → 81920) on a floor, two lights, smooth normals."""
    blob_v, blob_t = meshes.displaced_blob(subdiv, radius=1.0, center=(0, 1.1, 0))
    floor_v, floor_t = meshes.quad((-8, 0, -8), (-8, 0, 8), (8, 0, 8), (8, 0, -8))
    verts, tris, tmat, _ = meshes.merge(
        [(blob_v, blob_t, 1), (floor_v, floor_t, 0)]
    )
    scene = build_scene(
        vertices=verts,
        triangles=tris,
        tri_mat=tmat,
        materials=[
            {"ka": 0.1, "kd": (0.55, 0.55, 0.55)},
            {"ka": 0.08, "kd": (0.75, 0.65, 0.5), "ks": 0.25, "shininess": 32.0},
        ],
        lights=[
            ((4.0, 6.0, 4.0), (1.0, 1.0, 1.0)),
            ((-4.0, 3.0, 2.0), (0.3, 0.3, 0.35)),
        ],
        camera=Camera.make((0.0, 1.8, 4.2), (0.0, 1.0, 0.0), fov_y=np.pi / 4,
                           device=device),
        smooth=True,
        pad_tris_to=pad_to,
        pad_spheres_to=pad_to,
        device=device,
    )
    cfg = RenderConfig(width=width, height=height, max_depth=1, shadows=True)
    return scene, cfg


def _checkerboard(n=64, c0=(0.9, 0.9, 0.9), c1=(0.2, 0.25, 0.3)):
    ij = np.add.outer(np.arange(n) // 8, np.arange(n) // 8) % 2
    tex = np.where(ij[..., None] == 0, np.asarray(c0), np.asarray(c1))
    return tex.astype(np.float32)


def config5_multimesh(height=1080, width=1920, pad_to=1, n_blobs=12, subdiv=6,
                      device=None):
    """Config 5: multi-mesh scene (textured Phong) at 1080p: n_blobs=12 ×
    81920 tris + a checkerboard floor = 983,042 tris."""
    parts = []
    for k in range(n_blobs):
        ang = 2 * np.pi * k / n_blobs
        ring = 1 + (k % 3)
        r = 1.4 * ring
        c = (r * np.cos(ang), 0.55 + 0.1 * (k % 4), r * np.sin(ang))
        bv, bt = meshes.displaced_blob(subdiv, radius=0.55, center=c, seed=k)
        parts.append((bv, bt, 1 + (k % 3)))
    # textured floor (material 0 has texture_id 0)
    fv, ft = meshes.quad((-12, 0, -12), (-12, 0, 12), (12, 0, 12), (12, 0, -12))
    fuv = np.asarray([[0, 0], [0, 8], [8, 8], [8, 0]], np.float32)
    parts.append((fv, ft, 0, fuv))
    verts, tris, tmat, uvs = meshes.merge(parts)

    scene = build_scene(
        vertices=verts,
        triangles=tris,
        tri_mat=tmat,
        uvs=uvs,
        materials=[
            {"ka": 0.1, "kd": (1.0, 1.0, 1.0), "ks": 0.05, "texture_id": 0},
            {"ka": 0.06, "kd": (0.75, 0.3, 0.25), "ks": 0.35, "shininess": 48.0},
            {"ka": 0.06, "kd": (0.25, 0.55, 0.3), "ks": 0.35, "shininess": 48.0},
            {"ka": 0.06, "kd": (0.3, 0.35, 0.7), "ks": 0.35, "shininess": 48.0},
        ],
        textures=_checkerboard()[None],
        lights=[
            ((8.0, 10.0, 6.0), (1.0, 1.0, 1.0)),
            ((-7.0, 6.0, -4.0), (0.35, 0.3, 0.3)),
        ],
        camera=Camera.make((0.0, 3.2, 8.5), (0.0, 0.7, 0.0), fov_y=np.pi / 4,
                           device=device),
        smooth=True,
        pad_tris_to=pad_to,
        pad_spheres_to=pad_to,
        device=device,
    )
    cfg = RenderConfig(width=width, height=height, max_depth=1, shadows=True)
    return scene, cfg


def smooth_box(height=256, width=256, device=None):
    """Not one of ``tpurt``'s configs: a box with interpolated vertex normals
    and one sphere, two lights, depth 2.  Configs 1–3 shade flat and configs
    4–5 go through the clustered path, so this is the phase-1 scene that reaches
    the backward's barycentric branch (smooth normals) in tests and in
    chip_smoke.py."""
    verts, tris = meshes.box((-1, -1, -1), (1, 1, 1))
    scene = build_scene(
        vertices=verts,
        triangles=tris,
        spheres=[((1.6, 0.2, 0.3), 0.6, 1)],
        materials=[
            {"ka": 0.1, "kd": (0.7, 0.6, 0.5), "ks": 0.4, "shininess": 20.0,
             "reflectivity": 0.3},
            {"ka": 0.05, "kd": (0.2, 0.3, 0.7), "ks": 0.6, "reflectivity": 0.4},
        ],
        lights=[
            ((3.0, 4.0, 5.0), (1.0, 1.0, 1.0)),
            ((-4.0, 2.0, 3.0), (0.4, 0.4, 0.5)),
        ],
        camera=Camera.make((2.5, 2.0, 4.0), (0.3, 0.0, 0.0), device=device),
        smooth=True,
        device=device,
    )
    cfg = RenderConfig(width=width, height=height, max_depth=2, shadows=True)
    return scene, cfg


ALL_CONFIGS = {
    1: config1_sphere,
    2: config2_cornell,
    3: config3_spheres,
    4: config4_bunny,
    5: config5_multimesh,
}
