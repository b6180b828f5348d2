"""Scene representation: dataclasses of tensors (``tpurt/scene/scene.py``).

Padding convention, as in ``tpurt``: scenes always contain >=1 triangle and
>=1 sphere; the pad primitives are degenerate (zero-area triangle, tiny
far-away sphere), so brute-force reductions never see empty axes and the
kernel never branches on emptiness.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpurt_torch import constants as C
from tpurt_torch.core import vec
from tpurt_torch.core.types import resolve_device, tensors_to

#: Placement of degenerate pad primitives: far away, but small enough that
#: squared distances (sphere quadratic: |c|² - r²) stay finite in f32.
_PAD_POS = 1.0e7


@dataclasses.dataclass
class Materials:
    """Phong material table, indexed by per-primitive material id.

    ka/kd/ks: (M, 3) colour; shininess: (M,) Phong exponent; reflectivity:
    (M,) mirror weight in [0,1]; texture_id: (M,) int32, -1 = untextured.
    """

    ka: torch.Tensor
    kd: torch.Tensor
    ks: torch.Tensor
    shininess: torch.Tensor
    reflectivity: torch.Tensor
    texture_id: torch.Tensor

    @staticmethod
    def table(rows, device=None):
        """Build from a list of dicts with defaults."""
        dev = resolve_device(device)

        def col(key, default):
            out = []
            for r in rows:
                v = r.get(key, default)
                out.append([v] * 3 if np.isscalar(v) else v)
            return torch.tensor(np.asarray(out, np.float32), device=dev)

        def scalars(key, default, dtype):
            return torch.tensor([r.get(key, default) for r in rows], dtype=dtype,
                                device=dev)

        return Materials(
            ka=col("ka", 0.0),
            kd=col("kd", 0.8),
            ks=col("ks", 0.0),
            shininess=scalars("shininess", 32.0, C.DTYPE),
            reflectivity=scalars("reflectivity", 0.0, C.DTYPE),
            texture_id=scalars("texture_id", -1, C.INDEX_DTYPE),
        )

    def to(self, device):
        return tensors_to(self, device)


@dataclasses.dataclass
class Camera:
    """Pinhole camera (conventions in tpurt_torch/constants.py)."""

    eye: torch.Tensor
    look_at: torch.Tensor
    up: torch.Tensor
    fov_y: torch.Tensor  # vertical field of view, radians (0-d tensor)

    @staticmethod
    def make(eye, look_at, up=(0.0, 1.0, 0.0), fov_y=np.pi / 3, device=None):
        dev = resolve_device(device)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=dev)

        return Camera(eye=f32(eye), look_at=f32(look_at), up=f32(up),
                      fov_y=f32(fov_y))

    def basis(self):
        fwd = vec.normalize(self.look_at - self.eye)
        right = vec.normalize(vec.cross(fwd, self.up))
        true_up = vec.cross(right, fwd)
        return fwd, right, true_up

    def to(self, device):
        return tensors_to(self, device)


@dataclasses.dataclass
class Scene:
    """Full scene: geometry + materials + lights + camera.

    The fields and their shapes are ``tpurt.scene.Scene``'s: vertices (V, 3),
    triangles (T, 3) i32, tri_mat (T,) i32, vnormals (V, 3), uvs (V, 2),
    sph_center (S, 3), sph_radius (S,), sph_mat (S,) i32, materials,
    textures (NT, TH, TW, 3), light_pos (L, 3), light_color (L, 3),
    ambient (3,), camera.  `smooth`, `textured` and `n_real_spheres` are
    static flags.
    """

    vertices: torch.Tensor
    triangles: torch.Tensor
    tri_mat: torch.Tensor
    vnormals: torch.Tensor
    uvs: torch.Tensor
    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_mat: torch.Tensor
    materials: Materials
    textures: torch.Tensor
    light_pos: torch.Tensor
    light_color: torch.Tensor
    ambient: torch.Tensor
    camera: Camera
    smooth: bool = False
    textured: bool = False
    n_real_spheres: int = -1

    @property
    def n_tris(self):
        return self.triangles.shape[0]

    @property
    def n_spheres(self):
        return self.sph_center.shape[0]

    @property
    def n_lights(self):
        return self.light_pos.shape[0]

    def to(self, device):
        return tensors_to(self, device)


def build_scene(
    vertices=None,
    triangles=None,
    tri_mat=None,
    vnormals=None,
    uvs=None,
    spheres=None,  # list of (center(3), radius, mat_id)
    materials=None,  # list of material dicts (see Materials.table)
    textures=None,
    lights=None,  # list of (pos(3), color(3))
    ambient=C.AMBIENT_LIGHT,
    camera=None,
    smooth=False,
    pad_tris_to=1,
    pad_spheres_to=1,
    device=None,
):
    """Assemble a Scene from host data on `device`, inserting degenerate pad
    primitives exactly as ``tpurt.scene.build_scene`` does."""
    dev = resolve_device(device)
    verts = np.zeros((0, 3), np.float32) if vertices is None else np.asarray(
        vertices, np.float32
    )
    tris = np.zeros((0, 3), np.int32) if triangles is None else np.asarray(
        triangles, np.int32
    )
    tmat = (
        np.zeros((tris.shape[0],), np.int32)
        if tri_mat is None
        else np.asarray(tri_mat, np.int32)
    )
    if vnormals is None:
        vnormals = _vertex_normals(verts, tris)
    vnormals = np.asarray(vnormals, np.float32)
    if uvs is None:
        uvs = np.zeros((verts.shape[0], 2), np.float32)
    uvs = np.asarray(uvs, np.float32)

    def round_up(n, m):
        return max(1, -(-n // m) * m)

    # --- pad triangles: degenerate (all verts coincident, far away) ---------
    n_t = round_up(tris.shape[0], pad_tris_to)
    n_pad_t = n_t - tris.shape[0]
    if n_pad_t or verts.shape[0] == 0:
        pad_idx = verts.shape[0]
        verts = np.concatenate([verts, np.full((1, 3), _PAD_POS, np.float32)], 0)
        vnormals = np.concatenate([vnormals, np.array([[0, 1, 0]], np.float32)], 0)
        uvs = np.concatenate([uvs, np.zeros((1, 2), np.float32)], 0)
        tris = np.concatenate(
            [tris, np.full((max(n_pad_t, 1), 3), pad_idx, np.int32)], 0
        )
        tmat = np.concatenate([tmat, np.zeros((max(n_pad_t, 1),), np.int32)], 0)

    # --- spheres -------------------------------------------------------------
    spheres = spheres or []
    centers = np.asarray([s[0] for s in spheres], np.float32).reshape(-1, 3)
    radii = np.asarray([s[1] for s in spheres], np.float32).reshape(-1)
    smat = np.asarray([s[2] for s in spheres], np.int32).reshape(-1)
    n_s = round_up(centers.shape[0], pad_spheres_to)
    n_pad_s = n_s - centers.shape[0]
    if n_pad_s or centers.shape[0] == 0:
        k = max(n_pad_s, 1)
        centers = np.concatenate([centers, np.full((k, 3), _PAD_POS, np.float32)], 0)
        radii = np.concatenate([radii, np.full((k,), 1e-3, np.float32)], 0)
        smat = np.concatenate([smat, np.zeros((k,), np.int32)], 0)

    materials = materials or [{"kd": 0.8}]
    if isinstance(materials, Materials):
        has_tex = bool((materials.texture_id >= 0).any())
        materials = materials.to(dev)
    else:
        has_tex = any(m.get("texture_id", -1) >= 0 for m in materials)
        materials = Materials.table(materials, dev)
    lights = lights or [((0.0, 5.0, 0.0), (1.0, 1.0, 1.0))]
    lp = np.asarray([l[0] for l in lights], np.float32).reshape(-1, 3)
    lc = np.asarray([l[1] for l in lights], np.float32).reshape(-1, 3)
    if textures is None:
        textures = np.ones((1, 8, 8, 3), np.float32)
    camera = (camera or Camera.make((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), device=dev)).to(dev)

    def t(x, dtype=None):
        return torch.tensor(np.asarray(x, dtype), device=dev)

    return Scene(
        vertices=t(verts),
        triangles=t(tris),
        tri_mat=t(tmat),
        vnormals=t(vnormals),
        uvs=t(uvs),
        sph_center=t(centers),
        sph_radius=t(radii),
        sph_mat=t(smat),
        materials=materials,
        textures=t(textures, np.float32),
        light_pos=t(lp),
        light_color=t(lc),
        ambient=t(ambient, np.float32),
        camera=camera,
        smooth=smooth,
        textured=has_tex,
        n_real_spheres=len(spheres),
    )


def _vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (host-side numpy, build time only)."""
    vn = np.zeros_like(verts)
    if tris.shape[0] == 0 or verts.shape[0] == 0:
        return vn
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    lens = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(lens, 1e-20)).astype(np.float32)
