"""Deferred shading: differentiable Whitted shading from recorded hits
(``tpurt/shading/deferred.py``).

The clustered pipeline splits rendering in two:

1. **Traversal** (``tpurt_torch/kernels/traversal.py``, a CUDA kernel): finds,
   per pixel and per bounce, WHICH primitive is hit and WHICH lights are
   occluded.  Integer outputs only: a non-differentiable topology search.
2. **Deferred shading** (here, plain PyTorch under autograd): at the recorded
   integer topology, recompute (t, u, v) against the single recorded
   triangle or sphere, then normals, Phong, textures and the reflection
   chain, exactly as ``tpurt_torch/ref/oracle.py`` does.  Gradients to every
   float scene leaf flow through indexed gathers; their backward is
   PyTorch's index_put with accumulation, whose summation order on a card
   changes from run to run.

Not carried over from ``tpurt``: the packed gather tables, the sorted and
segment-sum scatter routes, hit compaction and rematerialisation, which
were tuned against XLA's fusion and the TPU's serial scatter.  The
vertex-table segment sum of the backward is a kernel of its own and comes
with the clustered backward; ring rendering's ``gather_fn`` comes with
scene sharding.  ``tpurt``'s per-depth ``lax.cond`` skip of a layer with no
live path is a Python ``if alive.any()`` here: one device-to-host sync per
depth beyond the first.
"""
from __future__ import annotations

import dataclasses

import torch

from tpurt_torch import constants as C
from tpurt_torch.core import geom, vec
from tpurt_torch.ref.oracle import _hit_uv, bilinear_texels


@dataclasses.dataclass
class HitRecords:
    """Per-depth hit topology for a flat bundle of N primary rays.

    prim:   (D, N) int32: triangle index if is_tri else sphere index;
            -1 = miss.
    is_tri: (D, N) bool
    occ:    (D, N) int32: bit l set when light l is occluded at this bounce.
    D = max_depth + 1.
    """

    prim: torch.Tensor
    is_tri: torch.Tensor
    occ: torch.Tensor


def split_ids(ids, n_tris: int):
    """(prim, is_tri) of the traversal kernel's global ids: -1 stays a miss,
    an id >= n_tris is sphere id - n_tris."""
    miss = ids < 0
    is_tri = (~miss) & (ids < n_tris)
    return torch.where(miss, -1, torch.where(is_tri, ids, ids - n_tris)), is_tri


def records_from_ids(ids, occ, n_tris: int) -> HitRecords:
    """HitRecords from the traversal kernel's ids and occlusion bits."""
    prim, is_tri = split_ids(ids, n_tris)
    return HitRecords(prim=prim, is_tri=is_tri, occ=occ)


def records_oracle(scene, o, d, max_depth=C.DEFAULT_MAX_DEPTH, shadows=True):
    """Brute-force record producer (parity reference for the traversal
    kernel).

    Record convention (shared with the kernel): a lane is LIVE at depth d if
    every prior bounce hit a reflective surface; dead lanes get id -1 and
    occ 0.  Their path throughput is zero, so the shader never reads them.
    """
    prims, is_tris, occs = [], [], []
    alive = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    for _ in range(max_depth + 1):
        rec = geom.closest_hit(scene, o, d)
        p, n, mat = _hit_geometry(scene, o, d, rec["t"], rec["prim"],
                                  rec["is_tri"], rec["u"], rec["v"])
        hit = rec["hit"] & alive
        p_off = p + n * C.RAY_OFFSET_EPS
        occ_bits = torch.zeros(o.shape[:-1], dtype=C.INDEX_DTYPE, device=o.device)
        if shadows:
            for li in range(scene.n_lights):
                to_l = scene.light_pos[li] - p
                dist = vec.length(to_l)
                ldir = to_l / dist.clamp_min(1e-20)[..., None]
                occluded = geom.any_hit(scene, p_off, ldir, dist - C.RAY_OFFSET_EPS)
                occ_bits = occ_bits | torch.where(hit & occluded, 1 << li, 0).to(
                    C.INDEX_DTYPE)
        prims.append(torch.where(hit, rec["prim"], -1).to(C.INDEX_DTYPE))
        is_tris.append(rec["is_tri"] & hit)
        occs.append(occ_bits)
        o = p_off
        d = vec.reflect(d, n)
        refl = scene.materials.reflectivity[mat]
        alive = hit & (refl > 0.0)
    return HitRecords(prim=torch.stack(prims), is_tri=torch.stack(is_tris),
                      occ=torch.stack(occs))


def _tri_rows(scene, pid):
    """v0/e1/e2 rows and the corner indices at triangle ids pid."""
    tri = scene.triangles.long()[pid.clamp_max(scene.n_tris - 1)]
    v0 = scene.vertices[tri[..., 0]]
    e1 = scene.vertices[tri[..., 1]] - v0
    e2 = scene.vertices[tri[..., 2]] - v0
    return v0, e1, e2, tri


def _recompute_tuv(scene, o, d, prim, is_tri):
    """Differentiable (t, u, v) at fixed topology.

    Triangles: Möller–Trumbore against the single gathered triangle
    (identical formulas and epsilons to the brute-force oracle).  Spheres:
    nearest-root-in-range quadratic.  Miss lanes get t = T_NONE.
    """
    pid = prim.clamp_min(0).long()
    v0, e1, e2, _ = _tri_rows(scene, pid)
    pvec = vec.cross(d, e2)
    det = vec.dot(e1, pvec)
    inv_det = 1.0 / torch.where(det.abs() < C.MT_DET_EPS, 1.0, det)
    tvec = o - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(d, qvec) * inv_det
    t_tri = vec.dot(e2, qvec) * inv_det

    if scene.n_real_spheres == 0:
        t_sph = torch.zeros_like(t_tri)  # static: mesh-only scene
    else:
        sid = pid.clamp_max(scene.n_spheres - 1)
        oc = o - scene.sph_center[sid]
        rad = scene.sph_radius[sid]
        b = vec.dot(oc, d)
        disc = b * b - (vec.dot(oc, oc) - rad * rad)
        has = disc > 0.0
        sq = torch.sqrt(torch.where(has, disc, 1.0))
        t0 = -b - sq
        t0_ok = has & (t0 > C.T_MIN) & (t0 < C.T_MAX)
        t_sph = torch.where(t0_ok, t0, -b + sq)

    hit = prim >= 0
    t = torch.where(is_tri, t_tri, t_sph)
    t = torch.where(hit, t, C.T_NONE)
    u = torch.where(is_tri & hit, u, 0.0)
    v = torch.where(is_tri & hit, v, 0.0)
    return t, u, v


def _hit_geometry(scene, o, d, t, prim, is_tri, u, v):
    """Position, shading normal, material id (mirrors ref/oracle.py)."""
    pid = prim.clamp_min(0).long()
    p = o + t[..., None] * d
    _, e1, e2, tri = _tri_rows(scene, pid)
    if scene.smooth:
        n0, n1, n2 = (scene.vnormals[tri[..., k]] for k in range(3))
        w = (1.0 - u - v)[..., None]
        n_tri = vec.normalize(w * n0 + u[..., None] * n1 + v[..., None] * n2)
    else:
        n_tri = vec.normalize(vec.cross(e1, e2))
    n_tri = torch.where(vec.dot(n_tri, d)[..., None] > 0.0, -n_tri, n_tri)
    mat_tri = scene.tri_mat[pid.clamp_max(scene.n_tris - 1)]
    if scene.n_real_spheres == 0:
        return p, n_tri, mat_tri.long()
    sid = pid.clamp_max(scene.n_spheres - 1)
    n_sph = geom.sphere_normal(p, scene.sph_center[sid])
    n = torch.where(is_tri[..., None], n_tri, n_sph)
    mat = torch.where(is_tri, mat_tri, scene.sph_mat[sid])
    return p, n, mat.long()


def _hit_uv_rows(scene, pid, u, v, is_tri):
    """Interpolated texture coordinates at triangle ids pid: the oracle's
    own expression (ref/oracle.py:_hit_uv)."""
    return _hit_uv(scene, {"prim": pid, "u": u, "v": v, "is_tri": is_tri})


def _sample_texture_flat(scene, tex_id, uv):
    """Bilinear texture lookup at texture ids tex_id (-1 = untextured, which
    gives 1): four texel gathers, element for element the expression of
    ref/oracle.py:_sample_texture."""
    col = bilinear_texels(scene.textures, tex_id.clamp_min(0).long(), uv)
    return torch.where(tex_id[..., None] < 0, 1.0, col)


def shade_from_records(scene, o, d, recs: HitRecords,
                       max_depth=C.DEFAULT_MAX_DEPTH, shadows=True):
    """Whitted shading replay from records → colors (N, 3), differentiable
    with respect to every float scene leaf.  Conventions identical to
    ref/oracle.py."""
    return _shade_bundle(scene, o, d, (recs.prim, recs.is_tri, recs.occ),
                         max_depth, shadows)


def _shade_bundle(scene, o, d, recs_tup, max_depth, shadows):
    """Whitted shading of one flat bundle."""
    prim_all, istri_all, occ_all = recs_tup
    m = scene.materials
    accum = torch.zeros_like(o)
    thr = torch.ones((*o.shape[:-1], 1), dtype=C.DTYPE, device=o.device)
    alive = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    background = torch.tensor(C.BACKGROUND, dtype=C.DTYPE, device=o.device)

    for depth in range(max_depth + 1):
        # a layer with no live path contributes exactly zero (accum is
        # alive-masked): skip its gathers and texture sampling
        if depth > 0 and not bool(alive.any()):
            break
        prim = prim_all[depth]
        is_tri = istri_all[depth]
        occ = occ_all[depth]
        hit = prim >= 0
        t, u, v = _recompute_tuv(scene, o, d, prim, is_tri)
        p, n, mat = _hit_geometry(scene, o, d, t, prim, is_tri, u, v)

        ka, ks, shin = m.ka[mat], m.ks[mat], m.shininess[mat]
        kd = m.kd[mat]
        if scene.textured:
            uv = _hit_uv_rows(scene, prim.clamp_min(0).long(), u, v, is_tri)
            kd = kd * _sample_texture_flat(scene, m.texture_id[mat], uv)

        color = ka * scene.ambient
        view = -d
        p_off = p + n * C.RAY_OFFSET_EPS
        for li in range(scene.n_lights):
            to_l = scene.light_pos[li] - p
            dist = vec.length(to_l)
            ldir = to_l / dist.clamp_min(1e-20)[..., None]
            ndotl = vec.dot(n, ldir).clamp_min(0.0)
            refl_l = vec.reflect(-ldir, n)
            rdotv = vec.dot(refl_l, view).clamp_min(0.0)
            safe_rv = torch.where(rdotv > 0.0, rdotv, 1.0)
            spec = torch.where((ndotl > 0.0) & (rdotv > 0.0), safe_rv ** shin, 0.0)
            if shadows:
                vis = 1.0 - ((occ >> li) & 1).to(C.DTYPE)[..., None]
            else:
                vis = 1.0
            color = color + vis * scene.light_color[li] * (
                kd * ndotl[..., None] + ks * spec[..., None])

        color = torch.where(hit[..., None], color, background)
        accum = accum + torch.where(alive[..., None], thr * color, 0.0)
        refl = torch.where(hit, m.reflectivity[mat], 0.0)
        thr = thr * refl[..., None]
        alive = alive & hit & (refl > 0.0)
        o = p_off
        d = vec.reflect(d, n)

    return accum.clamp(C.CLAMP_LO, C.CLAMP_HI)
