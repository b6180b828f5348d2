"""The five benchmark scene configs of ``tpurt/scene/configs.py``, at the
same defaults, and two scenes of the port's own: the final scene of "Ray
Tracing in One Weekend" (``rtiow_final_spheres``) and a smooth-shaded test
scene.  Each returns (scene, RenderConfig).  Configs 1–3 and the book's
scene render through the phase-1 kernels, configs 4–5 (meshes of 81,922
and 983,042 triangles) through the clustered path."""
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


#: Schlick's R0 at ior 1.5, ((1.5 - 1) / (1.5 + 1))², the reflectivity that
#: stands in for the book's glass (the port has no refraction)
RTIOW_GLASS_R0 = 0.04
#: every material's ka, under the scene's ambient: the book's sky zenith colour
RTIOW_KA, RTIOW_AMBIENT = 0.1, (0.5, 0.7, 1.0)
#: the book lights by the sky; two point lights stand in for it
RTIOW_LIGHTS = [((10.0, 12.0, 6.0), (1.0, 1.0, 1.0)),
                ((-8.0, 6.0, -4.0), (0.35, 0.35, 0.4))]


def rtiow_draws(seed=0):
    """The spheres of the book's ``random_scene()`` (Ray Tracing in One
    Weekend v3.2.3, §13.1), in its order, with ``numpy.random.default_rng(seed)``
    standing in for ``random_double()``: dicts of "center", "radius", "kind"
    ("diffuse", "metal", "glass"), "albedo", "fuzz" and, for the small
    spheres, the "choose_mat" that picked the kind.  Each candidate draws
    choose_mat and its centre's x and z; a kept one then draws its
    material's values (diffuse: two random colours, multiplied; metal: a
    colour in [0.5, 1), then the fuzz in [0, 0.5)), as the book does."""
    rng = np.random.default_rng(seed)
    out = [{"center": (0.0, -1000.0, 0.0), "radius": 1000.0, "kind": "diffuse",
            "albedo": (0.5, 0.5, 0.5), "fuzz": 0.0}]
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if np.hypot(center[0] - 4.0, center[2]) <= 0.9:
                continue
            sph = {"center": center, "radius": 0.2, "choose_mat": choose_mat, "fuzz": 0.0}
            if choose_mat < 0.8:
                c1 = [rng.random() for _ in range(3)]
                c2 = [rng.random() for _ in range(3)]
                sph.update(kind="diffuse", albedo=tuple(x * y for x, y in zip(c1, c2)))
            elif choose_mat < 0.95:
                albedo = tuple(0.5 + 0.5 * rng.random() for _ in range(3))
                sph.update(kind="metal", albedo=albedo, fuzz=0.5 * rng.random())
            else:
                sph.update(kind="glass", albedo=(1.0, 1.0, 1.0))
            out.append(sph)
    out += [{"center": (0.0, 1.0, 0.0), "radius": 1.0, "kind": "glass",
             "albedo": (1.0, 1.0, 1.0), "fuzz": 0.0},
            {"center": (-4.0, 1.0, 0.0), "radius": 1.0, "kind": "diffuse",
             "albedo": (0.4, 0.2, 0.1), "fuzz": 0.0},
            {"center": (4.0, 1.0, 0.0), "radius": 1.0, "kind": "metal",
             "albedo": (0.7, 0.6, 0.5), "fuzz": 0.0}]
    return out


def rtiow_material(sph) -> dict:
    """The Whitted material that stands in for one of the book's: diffuse
    albedo a is kd a; metal (a, fuzz f) is kd a·f, ks 0.5 at shininess 64
    and reflectivity 1 − f; glass is kd 0, ks 0.5 at shininess 128 and
    reflectivity RTIOW_GLASS_R0.  Every one has ka RTIOW_KA."""
    a, f = sph["albedo"], sph["fuzz"]
    if sph["kind"] == "diffuse":
        return {"ka": RTIOW_KA, "kd": a, "ks": 0.0, "reflectivity": 0.0}
    if sph["kind"] == "metal":
        return {"ka": RTIOW_KA, "kd": tuple(x * f for x in a), "ks": 0.5, "shininess": 64.0,
                "reflectivity": 1.0 - f}
    return {"ka": RTIOW_KA, "kd": 0.0, "ks": 0.5, "shininess": 128.0,
            "reflectivity": RTIOW_GLASS_R0}


def rtiow_final_spheres(height=1080, width=1920, seed=0, device=None):
    """The final scene of "Ray Tracing in One Weekend" (``rtiow_draws``):
    the ground sphere of radius 1000, the small spheres and the three of
    radius 1, each with its own material (``rtiow_material``), no
    triangles, the book's camera (from (13, 2, 3) at the origin, 20° of
    vertical field, a pinhole for its aperture of 0.1), depth-2 Whitted
    reflections and shadows from two lights."""
    draws = rtiow_draws(seed)
    scene = build_scene(
        spheres=[(s["center"], s["radius"], i) for i, s in enumerate(draws)],
        materials=[rtiow_material(s) for s in draws],
        lights=RTIOW_LIGHTS,
        ambient=RTIOW_AMBIENT,
        camera=Camera.make((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), fov_y=np.radians(20.0),
                           device=device),
        device=device,
    )
    cfg = RenderConfig(width=width, height=height, max_depth=2, shadows=True)
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
    "rtiow": rtiow_final_spheres,
}
