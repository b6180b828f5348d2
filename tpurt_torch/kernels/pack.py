"""Differentiable scene packing for the phase-1 kernel
(``tpurt/kernels/pack.py``).

The math is ``tpurt``'s; the layout is one row per primitive, which a CUDA
thread walking the primitives in order reads as a few 16-byte loads.  The
TPU layout (block-major lanes, sublane blocks, lane padding) is gone.
Every step is a differentiable torch op, so a backward can chain-rule kernel
cotangents into scene gradients through autograd.

* ``tri_forms`` (T, 3, 4): Baldwin–Weber linear forms.  For triangle
  (v0, e1, e2) with N = e1×e2, det = N·N, r1 = (e2×N)/det, r2 = (N×e1)/det:
  rows [N | -N·v0], [r1 | -r1·v0], [r2 | -r2·v0].  Against a ray (o, d),
  row k gives the pair (a·o + a₃, a·d):  t = -(N·o - N·v0)/(N·d),
  u = (r1·o + c1) + t·(r1·d), v likewise with r2.
* ``sph_forms`` (S, 2, 4): rows [-2c | c·c - r²] and [c | 0]:
  cterm = o·o + (-2c·o + c·c - r²), b = o·d - c·d (unit d, so a == 1).
* ``attrs`` (T + S, ACOLS): per-primitive shading attributes, triangles
  first, fetched by the winner's index.
* ``globals`` (NGLOB_BASE + 6L,): camera basis, ambient, light pos/colour.
"""
from __future__ import annotations

import dataclasses

import torch

from tpurt_torch import constants as C
from tpurt_torch.core import vec
from tpurt_torch.trace import span

# attribute columns, as tpurt/kernels/pack.py:42-57 (without its lane padding)
A_GN = 0        # geometric normal (3)
A_N0 = 3        # vertex normals (3 × 3); == gn for flat shading
A_N1 = 6
A_N2 = 9
A_UV0 = 12      # per-corner uv (3 × 2)
A_UV1 = 14
A_UV2 = 16
A_KA = 18       # material ka/kd/ks (3 × 3)
A_KD = 21
A_KS = 24
A_SHIN = 27
A_REFL = 28
A_IS_SPH = 29
A_CENTER = 30   # sphere center (3)
A_RADIUS = 33
A_TEXID = 34    # float texture id; -1 = untextured
ACOLS = 35

NGLOB_BASE = 15  # eye(3) fwd(3) right_s(3) up_s(3) ambient(3)


@dataclasses.dataclass
class PackedScene:
    tri_forms: torch.Tensor   # (T, 3, 4) f32
    sph_forms: torch.Tensor   # (S, 2, 4) f32
    attrs: torch.Tensor       # (T + S, ACOLS) f32
    globals: torch.Tensor     # (NGLOB_BASE + 6 L,) f32

    @property
    def n_tris(self):
        return self.tri_forms.shape[0]

    @property
    def n_spheres(self):
        return self.sph_forms.shape[0]

    @property
    def n_lights(self):
        return (self.globals.shape[0] - NGLOB_BASE) // 6


def tri_form_groups(v0, e1, e2):
    """Baldwin–Weber forms for triangles (v0, e1, e2) → (T, 3, 4).

    Degenerate (pad) triangles have N == 0 ⇒ |N·d| < eps ⇒ masked in the
    kernel; their t numerator is kept nonzero so no 0/0 NaN can form."""
    N = vec.cross(e1, e2)
    det = vec.dot(N, N)
    degenerate = det < 1e-18
    safe_det = torch.where(degenerate, 1.0, det)[..., None]
    r1 = vec.cross(e2, N) / safe_det
    r2 = vec.cross(N, e1) / safe_det
    nd = torch.where(degenerate, -1.0, vec.dot(N, v0))
    c1 = -vec.dot(r1, v0)
    c2 = -vec.dot(r2, v0)
    rows = [torch.cat([N, -nd[:, None]], 1),
            torch.cat([r1, c1[:, None]], 1),
            torch.cat([r2, c2[:, None]], 1)]
    return torch.stack(rows, 1)


def sphere_form_groups(cen, rad):
    """Sphere quadratic forms → (S, 2, 4): [-2c | c·c - r²], [c | 0]."""
    cc_r2 = vec.dot(cen, cen) - rad * rad
    ct = torch.cat([-2.0 * cen, cc_r2[:, None]], 1)
    cd = torch.cat([cen, torch.zeros_like(rad)[:, None]], 1)
    return torch.stack([ct, cd], 1)


def globals_vec(scene):
    """Camera/ambient/light packing: (NGLOB_BASE + 6 L,)."""
    cam = scene.camera
    fwd, right, true_up = cam.basis()
    half_h = torch.tan(cam.fov_y * 0.5)
    return torch.cat(
        [
            cam.eye, fwd,
            right * half_h,    # × aspect applied in the kernel
            true_up * half_h,
            scene.ambient.reshape(3).to(C.DTYPE),
            scene.light_pos.reshape(-1),
            scene.light_color.reshape(-1),
        ]
    )


@span("tpurt.pack")
def pack_scene(scene) -> PackedScene:
    """Differentiable Scene → PackedScene."""
    T = scene.n_tris
    S = scene.n_spheres
    tri = scene.triangles.long()
    v0 = scene.vertices[tri[:, 0]]
    e1 = scene.vertices[tri[:, 1]] - v0
    e2 = scene.vertices[tri[:, 2]] - v0
    cen = scene.sph_center
    rad = scene.sph_radius

    gn = vec.normalize(vec.cross(e1, e2))
    if scene.smooth:
        n0, n1, n2 = (scene.vnormals[tri[:, k]] for k in range(3))
    else:
        n0 = n1 = n2 = gn
    uv0, uv1, uv2 = (scene.uvs[tri[:, k]] for k in range(3))
    m = scene.materials

    def mat_cols(ids):
        ids = ids.long()
        return [
            m.ka[ids], m.kd[ids], m.ks[ids],
            m.shininess[ids][:, None], m.reflectivity[ids][:, None],
        ], m.texture_id[ids].to(C.DTYPE)[:, None]

    def zeros(n, k):
        return torch.zeros((n, k), dtype=C.DTYPE, device=v0.device)

    mat_t, tex_t = mat_cols(scene.tri_mat)
    attrs_t = torch.cat(
        [gn, n0, n1, n2, uv0, uv1, uv2, *mat_t,
         zeros(T, 1),          # is_sphere = 0
         zeros(T, 4),          # center, radius
         tex_t],
        1,
    )
    mat_s, tex_s = mat_cols(scene.sph_mat)
    attrs_s = torch.cat(
        [zeros(S, 18),         # normals come from center/radius; uv
         *mat_s,
         zeros(S, 1) + 1.0,    # is_sphere = 1
         cen, rad[:, None], tex_s],
        1,
    )
    return PackedScene(
        tri_forms=tri_form_groups(v0, e1, e2),
        sph_forms=sphere_form_groups(cen, rad),
        attrs=torch.cat([attrs_t, attrs_s], 0),
        globals=globals_vec(scene),
    )
