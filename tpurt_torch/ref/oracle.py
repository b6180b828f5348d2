"""The reference ("oracle") renderer of the port: plain PyTorch, brute force,
chunked over pixels (``tpurt/ref/oracle.py``).

It is the port's spec-level check: Möller–Trumbore and the ``oc = o - c``
sphere quadratic, independent of the kernel's packed forms.  Structure:
ray-gen → closest hit → Phong shade with shadow rays → iterative Whitted
reflection loop with multiplicative throughput; textures are sampled
bilinearly with wrap addressing.
"""
from __future__ import annotations

import torch

from tpurt_torch import constants as C
from tpurt_torch.core import geom, vec


def _face_normals(scene):
    tri = scene.triangles.long()
    v0 = scene.vertices[tri[:, 0]]
    e1 = scene.vertices[tri[:, 1]] - v0
    e2 = scene.vertices[tri[:, 2]] - v0
    return vec.normalize(vec.cross(e1, e2))


def hit_geometry(scene, o, d, rec):
    """Position, shading normal, material id at a hit record."""
    p = o + rec["t"][..., None] * d
    prim = rec["prim"].long()
    # a sphere hit's prim indexes spheres: clamp it for the triangle gathers,
    # whose result the is_tri select then drops
    tri_prim = prim.clamp_max(scene.n_tris - 1)
    sph_prim = prim.clamp_max(scene.n_spheres - 1)

    if scene.smooth:
        tri = scene.triangles.long()[tri_prim]
        n0, n1, n2 = (scene.vnormals[tri[..., k]] for k in range(3))
        w = (1.0 - rec["u"] - rec["v"])[..., None]
        n_tri = vec.normalize(
            w * n0 + rec["u"][..., None] * n1 + rec["v"][..., None] * n2
        )
    else:
        n_tri = _face_normals(scene)[tri_prim]
    # flip to face the incoming ray (two-sided shading)
    n_tri = torch.where(vec.dot(n_tri, d)[..., None] > 0.0, -n_tri, n_tri)
    n_sph = geom.sphere_normal(p, scene.sph_center[sph_prim])

    is_tri = rec["is_tri"]
    n = torch.where(is_tri[..., None], n_tri, n_sph)
    mat = torch.where(is_tri, scene.tri_mat[tri_prim], scene.sph_mat[sph_prim])
    return p, n, mat.long()


def bilinear_texels(textures, tid, uv, gather=None):
    """Bilinear lookup in textures (NT, TH, TW, 3) at texture ids tid (...,)
    and coordinates uv (..., 2), wrap addressing: ONE gather of the four
    texels' rows (..., 4, 3) from the flat (NT·TH·TW, 3) table, by plain
    indexing or by `gather(table, rows)`."""
    _, th, tw, _ = textures.shape
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * tw - 0.5
    y = v * th - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi = torch.remainder(torch.stack([x0, x0 + 1, x0, x0 + 1], -1).long(), tw)
    yi = torch.remainder(torch.stack([y0, y0, y0 + 1, y0 + 1], -1).long(), th)
    rows = (tid[..., None] * th + yi) * tw + xi
    table = textures.reshape(-1, textures.shape[-1])
    c00, c10, c01, c11 = (table[rows] if gather is None else gather(table, rows)).unbind(-2)
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


def _sample_texture(scene, mat, uv):
    """Texture colour at material ids mat (...,) and coordinates uv; an
    untextured material (texture_id < 0) gives 1 so `kd * tex` is a no-op."""
    tex_id = scene.materials.texture_id[mat]
    col = bilinear_texels(scene.textures, tex_id.clamp_min(0).long(), uv)
    return torch.where(tex_id[..., None] < 0, 1.0, col)


def _hit_uv(scene, rec):
    """Interpolated texture coordinates at a triangle hit (0 for spheres)."""
    tri = scene.triangles.long()[rec["prim"].long().clamp_max(scene.n_tris - 1)]
    uv0, uv1, uv2 = (scene.uvs[tri[..., k]] for k in range(3))
    w = (1.0 - rec["u"] - rec["v"])[..., None]
    uv = w * uv0 + rec["u"][..., None] * uv1 + rec["v"][..., None] * uv2
    return torch.where(rec["is_tri"][..., None], uv, 0.0)


def shade_hits(scene, o, d, rec, shadows=True):
    """Phong shading of hit records.

    Returns (color (..., 3), reflect_dir (..., 3), hit_p_off (..., 3),
    reflectivity (...,)).  Misses get BACKGROUND and zero reflectivity.
    """
    p, n, mat = hit_geometry(scene, o, d, rec)
    m = scene.materials
    ka, kd, ks, shin = m.ka[mat], m.kd[mat], m.ks[mat], m.shininess[mat]
    if scene.textured:
        kd = kd * _sample_texture(scene, mat, _hit_uv(scene, rec))

    color = ka * scene.ambient
    view = -d
    p_off = p + n * C.RAY_OFFSET_EPS                   # shadow-ray origin

    for li in range(scene.n_lights):
        lpos = scene.light_pos[li]
        lcol = scene.light_color[li]
        to_l = lpos - p
        dist = vec.length(to_l)
        ldir = to_l / dist.clamp_min(1e-20)[..., None]
        ndotl = vec.dot(n, ldir).clamp_min(0.0)
        refl_l = vec.reflect(-ldir, n)
        rdotv = vec.dot(refl_l, view).clamp_min(0.0)
        # guard pow so d/d(shininess) at rdotv == 0 stays finite
        safe_rv = torch.where(rdotv > 0.0, rdotv, 1.0)
        spec = torch.where((ndotl > 0.0) & (rdotv > 0.0), safe_rv ** shin, 0.0)
        if shadows:
            occluded = geom.any_hit(scene, p_off, ldir, dist - C.RAY_OFFSET_EPS)
            vis = torch.where(occluded, 0.0, 1.0)[..., None]
        else:
            vis = 1.0
        color = color + vis * lcol * (kd * ndotl[..., None] + ks * spec[..., None])

    refl_dir = vec.reflect(d, n)
    background = torch.tensor(C.BACKGROUND, dtype=C.DTYPE, device=d.device)
    color = torch.where(rec["hit"][..., None], color, background)
    reflectivity = torch.where(rec["hit"], m.reflectivity[mat], 0.0)
    return color, refl_dir, p_off, reflectivity


def trace_rays(scene, o, d, max_depth=C.DEFAULT_MAX_DEPTH, shadows=True):
    """Whitted-trace a flat bundle of rays (N, 3) → colors (N, 3)."""
    accum = torch.zeros_like(o)
    throughput = torch.ones((*o.shape[:-1], 1), dtype=C.DTYPE, device=o.device)
    alive = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)

    for _ in range(max_depth + 1):
        rec = geom.closest_hit(scene, o, d)
        color, refl_dir, p_off, reflectivity = shade_hits(scene, o, d, rec, shadows)
        accum = accum + torch.where(alive[..., None], throughput * color, 0.0)
        throughput = throughput * reflectivity[..., None]
        alive = alive & rec["hit"] & (reflectivity > 0.0)
        o = p_off
        d = refl_dir

    return accum.clamp(C.CLAMP_LO, C.CLAMP_HI)


def render_ref(scene, height=None, width=None, config=None, chunk=8192):
    """Render the full (H, W, 3) image with the oracle, `chunk` pixels at a
    time.  `config`: optional RenderConfig (wins over height/width)."""
    if config is not None:
        height, width = config.height, config.width
        max_depth, shadows = config.max_depth, config.shadows
    else:
        max_depth, shadows = C.DEFAULT_MAX_DEPTH, True
    o, d = geom.generate_rays(scene.camera, height, width)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    colors = [
        trace_rays(scene, o[s:s + chunk], d[s:s + chunk], max_depth, shadows)
        for s in range(0, o.shape[0], chunk)
    ]
    return torch.cat(colors).reshape(height, width, 3)
