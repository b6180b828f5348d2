"""Geometry routines shared by the oracle: camera ray generation,
Möller–Trumbore ray-triangle and ray-sphere intersection, brute-force
closest-hit and any-hit (``tpurt/core/geom.py``).

Broadcasting convention: ray args have shape (..., 3); primitive args have a
leading primitive axis (P, 3) (or (P,)).  Pairwise routines return tensors of
shape (..., P).
"""
from __future__ import annotations

import torch

from tpurt_torch import constants as C
from tpurt_torch.core import vec


def generate_rays(camera, height: int, width: int, row0: int = 0, nrows=None):
    """Primary rays through every pixel center.

    Returns (origins, directions), each (nrows, W, 3); directions unit.  Row
    0 is the top of the image; pixel centers at (j+0.5, i+0.5).  NDC is
    always computed against the FULL image height, so a slab of rows is
    pixel-identical to the same rows of the whole image.
    """
    if nrows is None:
        nrows = height
    fwd, right, true_up = camera.basis()
    dev = camera.eye.device
    aspect = width / height
    half_h = torch.tan(camera.fov_y * 0.5)
    half_w = half_h * aspect

    rows = row0 + torch.arange(nrows, dtype=C.DTYPE, device=dev)
    i = (rows + 0.5) / height                                       # top→bottom
    j = (torch.arange(width, dtype=C.DTYPE, device=dev) + 0.5) / width
    sx = (2.0 * j - 1.0) * half_w            # (W,)
    sy = (1.0 - 2.0 * i) * half_h            # (H,)

    d = (
        fwd[None, None, :]
        + sx[None, :, None] * right[None, None, :]
        + sy[:, None, None] * true_up[None, None, :]
    )
    d = vec.normalize(d)
    o = camera.eye.expand(d.shape)
    return o, d


def intersect_tris(o, d, v0, e1, e2, t_min=C.T_MIN, t_max=C.T_MAX):
    """Rays (..., 3) vs triangles (T, 3) given v0 and edges e1=v1-v0, e2=v2-v0.

    Returns (hit (..., T) bool, t (..., T), u (..., T), v (..., T)).
    Misses carry t = T_NONE; near-parallel pairs are masked by MT_DET_EPS.
    """
    o = o[..., None, :]
    d = d[..., None, :]
    pvec = vec.cross(d, e2)
    det = vec.dot(e1, pvec)
    safe_det = torch.where(det.abs() < C.MT_DET_EPS, 1.0, det)
    inv_det = 1.0 / safe_det
    tvec = o - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(d, qvec) * inv_det
    t = vec.dot(e2, qvec) * inv_det
    hit = (
        (det.abs() >= C.MT_DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    t = torch.where(hit, t, C.T_NONE)
    return hit, t, u, v


def intersect_spheres(o, d, center, radius, t_min=C.T_MIN, t_max=C.T_MAX):
    """Rays (..., 3) vs spheres (S, 3)/(S,).  Directions must be unit length.

    Returns (hit (..., S) bool, t (..., S)) with the nearest root in range;
    misses carry t = T_NONE.
    """
    oc = o[..., None, :] - center
    b = vec.dot(oc, d[..., None, :])             # half-b, since a == 1
    c = vec.dot(oc, oc) - radius * radius
    disc = b * b - c
    has_root = disc > 0.0
    sq = torch.sqrt(torch.where(has_root, disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t0_ok = has_root & (t0 > t_min) & (t0 < t_max)
    t1_ok = has_root & (t1 > t_min) & (t1 < t_max)
    t = torch.where(t0_ok, t0, torch.where(t1_ok, t1, C.T_NONE))
    return t0_ok | t1_ok, t


def sphere_normal(p, center):
    """Outward unit normal of a sphere at surface point p."""
    return vec.normalize(p - center)


def _tri_edges(scene):
    tri = scene.triangles.long()
    v0 = scene.vertices[tri[:, 0]]
    return v0, scene.vertices[tri[:, 1]] - v0, scene.vertices[tri[:, 2]] - v0


def closest_hit(scene, o, d, t_min=C.T_MIN, t_max=C.T_MAX):
    """Brute-force closest hit of rays (..., 3) against ALL primitives.

    Returns a dict of (...,)-shaped tensors: t (T_NONE on miss), hit, is_tri,
    prim (int32 index into tris or spheres), u, v (0 for spheres).  The
    lowest index wins a tie; a triangle beats a sphere at equal t.
    """
    v0, e1, e2 = _tri_edges(scene)
    _, t_tri, u, v = intersect_tris(o, d, v0, e1, e2, t_min, t_max)
    _, t_sph = intersect_spheres(o, d, scene.sph_center, scene.sph_radius,
                                 t_min, t_max)

    tri_t, tri_idx = t_tri.min(-1)
    tri_u = u.gather(-1, tri_idx[..., None])[..., 0]
    tri_v = v.gather(-1, tri_idx[..., None])[..., 0]
    sph_t, sph_idx = t_sph.min(-1)

    is_tri = tri_t <= sph_t
    t = torch.minimum(tri_t, sph_t)
    return {
        "t": t,
        "hit": t < C.T_MAX,
        "is_tri": is_tri,
        "prim": torch.where(is_tri, tri_idx, sph_idx).to(C.INDEX_DTYPE),
        "u": torch.where(is_tri, tri_u, 0.0),
        "v": torch.where(is_tri, tri_v, 0.0),
    }


def any_hit(scene, o, d, t_max):
    """Brute-force occlusion test: True where ANY primitive lies in
    (T_MIN, t_max) along the ray.  t_max has the rays' batch shape."""
    v0, e1, e2 = _tri_edges(scene)
    hit_t, t_tri, _, _ = intersect_tris(o, d, v0, e1, e2)
    hit_s, t_sph = intersect_spheres(o, d, scene.sph_center, scene.sph_radius)
    occ_tri = (hit_t & (t_tri < t_max[..., None])).any(-1)
    occ_sph = (hit_s & (t_sph < t_max[..., None])).any(-1)
    return occ_tri | occ_sph
