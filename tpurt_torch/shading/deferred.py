"""Deferred shading: differentiable Whitted shading from recorded hits
(``tpurt/shading/deferred.py``).

The clustered pipeline splits rendering in two:

1. **Traversal** (``tpurt_torch/kernels/traversal.py``, a CUDA kernel): finds,
   per pixel and per bounce, WHICH primitive is hit and WHICH lights are
   occluded.  Integer outputs only: a non-differentiable topology search.
2. **Deferred shading** (here, plain PyTorch under autograd): at the recorded
   integer topology, recompute (t, u, v) against the single recorded
   triangle or sphere, then normals, Phong, textures and the reflection
   chain, exactly as ``tpurt_torch/ref/oracle.py`` does.  Gradients flow to
   every float scene leaf.

The per-vertex leaves (positions, normals, uvs) are read through ONE merged
vertex table (``_build_vtab``), gathered once a depth at the hit triangle's
three corners by ``gather_rows``, an autograd Function (the counterpart of
``tpurt``'s ``_pack_gather``).  Its backward is the vertex-table segment
sum: the three corners' cotangent rows form one stream of 3 N updates that
``tpurt_torch.kernels.segsum.segsum_rows`` sorts and sums with the
hand-written kernel ``csrc/segsum.cu``: no atomics, the same bits on every
run.  Lanes that hit no triangle enter the stream with the index n_rows,
which the segment sum drops (their cotangent is zero).  ``v0``, ``e1 = g1 -
g0`` and ``e2 = g2 - g0`` are ordinary tensor ops behind the gather, so
autograd mixes the columns.

The per-material floats (one merged table, ``_build_mtab``), the sphere
centres and radii (one merged table, ``_build_stab``, on a scene with
spheres) and the four texels of a bilinear lookup (the flat texture table)
go through the same ``gather_rows``, one gather and one segment sum each a
depth.  Their tables are tiny and every pixel adds to them: PyTorch's
backward of plain indexing (index_put with accumulation: the indices sorted,
then each distinct row's duplicates added one after another) takes 170 to
1,040 ms for EACH such gather of a frame's pixels on an H100 (PERF.md), a
segment sum under 1 ms.  ``gather_rows_reference`` is the same gather by
plain indexing: the plain version, for tests and comparisons.  The integer
``sph_mat`` and ``tri_mat`` stay plain indexing, and so do the lights, read
by a scalar index a light.

Not carried over from ``tpurt``: the (T, K) shadepack, the gates and
partitions of the vertex-table scatter, the sorted scatter route, the
one-hot matrix products behind its material and texel gathers, hit
compaction and rematerialisation, which were tuned against XLA's fusion and
the TPU's serial scatter.  Ring rendering (``dist/scene_shard.py``) hands
``shade_from_records`` a ``corner_fn`` that fetches the corner rows of every
depth at once from the ring's rotating slices, in place of the per-depth
``_corner_rows``.  ``tpurt``'s per-depth ``lax.cond`` skip of a layer with
no live path is a Python ``if alive.any()`` here: one device-to-host sync
per depth beyond the first.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.autograd.function import once_differentiable

from tpurt_torch import constants as C
from tpurt_torch.core import geom, vec
from tpurt_torch.kernels.segsum import segsum_rows
from tpurt_torch.ref.oracle import bilinear_texels
from tpurt_torch.trace import span


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


def _build_vtab(scene):
    """ONE merged per-vertex table [position | normal? | uv?], (V, 3, 6 or 8),
    differentiable in its parts: one gather a corner instead of one a field,
    and one segment sum of W-wide rows in the backward."""
    cols = [scene.vertices]
    if scene.smooth:
        cols.append(scene.vnormals)
    if scene.textured:
        cols.append(scene.uvs)
    return torch.cat(cols, dim=-1) if len(cols) > 1 else cols[0]


def _build_mtab(materials):
    """ONE merged per-material table [ka | kd | ks | shininess |
    reflectivity], (M, 11), differentiable in its parts."""
    return torch.cat([materials.ka, materials.kd, materials.ks,
                      materials.shininess[:, None], materials.reflectivity[:, None]], dim=-1)


def _build_stab(scene):
    """ONE merged sphere table [centre | radius], (S, 4), differentiable in
    its parts."""
    return torch.cat([scene.sph_center, scene.sph_radius[:, None]], dim=-1)


def _rows_at(table, idx):
    """table[idx].  On a card PyTorch (2.11) gathers the rows of a contiguous
    table whose row size is a multiple of 16 bytes with a kernel that spends
    a thread block on each row: 0.6 ns a row on an H100 whatever the count,
    against 0.04 ns for the same rows read from a view of a wider table
    (tpurt_torch.tools.probe_segsum prints both).  A textured scene's vertex
    table has rows of 8 floats and a 1080x1920 frame reads 6.2 M of them, so
    such a table is copied into a view of a wider one first."""
    rows, width = table.shape
    if table.is_cuda and (width * table.element_size()) % 16 == 0:
        view = table.new_empty((rows, width + 1))[:, :width]
        table = view.copy_(table)
    return table[idx]


class _GatherRows(torch.autograd.Function):
    """table[idx] whose backward is the sorted segment sum (see the module's
    docstring)."""

    @staticmethod
    def forward(ctx, table, idx, live):
        if ctx.needs_input_grad[0]:
            # lanes outside `live` carry a zero cotangent: n_rows drops them
            live = live.reshape(live.shape + (1,) * (idx.dim() - live.dim()))
            ctx.save_for_backward(torch.where(live, idx, table.shape[0]).to(torch.int32))
            ctx.n_rows = table.shape[0]
        return _rows_at(table, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        idx, = ctx.saved_tensors
        # one stream of updates, a lane's k rows side by side
        dtable = segsum_rows(idx.reshape(-1), cot.contiguous().reshape(-1, cot.shape[-1]),
                             ctx.n_rows)
        return dtable, None, None


def gather_rows(table, idx, live):
    """Rows of a (R, W) float table at idx (N,) or (N, k) int64 → (N, W) or
    (N, k, W).  `live` (N,) bool marks the lanes whose rows are used."""
    return _GatherRows.apply(table, idx, live)


def gather_rows_reference(table, idx, live):
    """Plain version of gather_rows: indexing under autograd."""
    return table[idx]


def _corner_rows(scene, prim, is_tri, vtab=None):
    """The vertex-table rows (N, 3, W) of the hit triangles' corners: THE one
    gather of a depth.  A lane that hit no triangle reads triangle 0 or the
    last one; nothing downstream uses its rows."""
    vtab = _build_vtab(scene) if vtab is None else vtab
    pid = prim.clamp(0, scene.n_tris - 1).long()
    return gather_rows(vtab, scene.triangles.long()[pid], is_tri & (prim >= 0))


def _sphere_rows(scene, prim, is_tri, stab=None):
    """The sphere-table rows (N, 4) of the hit spheres, [centre | radius]:
    one gather a depth; None on a scene without spheres.  A lane that hit no
    sphere reads sphere 0 or the last one; nothing downstream uses its row."""
    if scene.n_real_spheres == 0:
        return None
    stab = _build_stab(scene) if stab is None else stab
    sid = prim.clamp(0, scene.n_spheres - 1).long()
    return gather_rows(stab, sid, ~is_tri & (prim >= 0))


def _tri_rows(rows):
    """v0, e1, e2 of gathered corner rows."""
    v0 = rows[..., 0, 0:3]
    return v0, rows[..., 1, 0:3] - v0, rows[..., 2, 0:3] - v0


def _recompute_tuv(scene, o, d, prim, is_tri, rows, srows):
    """Differentiable (t, u, v) at fixed topology.

    Triangles: Möller–Trumbore against the single gathered triangle
    (identical formulas and epsilons to the brute-force oracle).  Spheres:
    nearest-root-in-range quadratic.  Miss lanes get t = T_NONE.  `rows` are
    the gathered corner rows (_corner_rows), `srows` the sphere rows
    (_sphere_rows).
    """
    v0, e1, e2 = _tri_rows(rows)
    pvec = vec.cross(d, e2)
    det = vec.dot(e1, pvec)
    inv_det = 1.0 / torch.where(det.abs() < C.MT_DET_EPS, 1.0, det)
    tvec = o - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(d, qvec) * inv_det
    t_tri = vec.dot(e2, qvec) * inv_det

    if srows is None:
        t_sph = torch.zeros_like(t_tri)  # static: mesh-only scene
    else:
        oc = o - srows[..., 0:3]
        rad = srows[..., 3]
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


def _hit_geometry(scene, o, d, t, prim, is_tri, u, v, rows=None, srows=None):
    """Position, shading normal, material id (mirrors ref/oracle.py).  `rows`
    and `srows` are the corner and sphere rows where the caller has gathered
    them."""
    pid = prim.clamp_min(0).long()
    p = o + t[..., None] * d
    rows = _corner_rows(scene, prim, is_tri) if rows is None else rows
    if scene.smooth:
        n0, n1, n2 = (rows[..., k, 3:6] for k in range(3))
        w = (1.0 - u - v)[..., None]
        n_tri = vec.normalize(w * n0 + u[..., None] * n1 + v[..., None] * n2)
    else:
        _, e1, e2 = _tri_rows(rows)
        n_tri = vec.normalize(vec.cross(e1, e2))
    n_tri = torch.where(vec.dot(n_tri, d)[..., None] > 0.0, -n_tri, n_tri)
    mat_tri = scene.tri_mat[pid.clamp_max(scene.n_tris - 1)]
    if scene.n_real_spheres == 0:
        return p, n_tri, mat_tri.long()
    srows = _sphere_rows(scene, prim, is_tri) if srows is None else srows
    n_sph = geom.sphere_normal(p, srows[..., 0:3])
    n = torch.where(is_tri[..., None], n_tri, n_sph)
    mat = torch.where(is_tri, mat_tri, scene.sph_mat[pid.clamp_max(scene.n_spheres - 1)])
    return p, n, mat.long()


def _hit_uv_rows(rows, u, v, is_tri):
    """Interpolated texture coordinates from gathered corner rows (their last
    two columns): the oracle's own expression (ref/oracle.py:_hit_uv)."""
    uv0, uv1, uv2 = (rows[..., k, -2:] for k in range(3))
    w = (1.0 - u - v)[..., None]
    uv = w * uv0 + u[..., None] * uv1 + v[..., None] * uv2
    return torch.where(is_tri[..., None], uv, 0.0)


def _sample_texture_flat(scene, tex_id, uv, hit=None):
    """Bilinear texture lookup at texture ids tex_id (-1 = untextured, which
    gives 1): element for element the expression of
    ref/oracle.py:_sample_texture, the four texels by gather_rows.  `hit`
    marks the lanes whose colour is used (default: all)."""
    live = tex_id >= 0 if hit is None else hit & (tex_id >= 0)
    col = bilinear_texels(scene.textures, tex_id.clamp_min(0).long(), uv,
                          lambda table, rows: gather_rows(table, rows, live))
    return torch.where(tex_id[..., None] < 0, 1.0, col)


@span("tpurt.shade")
def shade_from_records(scene, o, d, recs: HitRecords,
                       max_depth=C.DEFAULT_MAX_DEPTH, shadows=True, corner_fn=None):
    """Whitted shading replay from records → colors (N, 3), differentiable
    with respect to every float scene leaf.  Conventions identical to
    ref/oracle.py.

    `corner_fn(prim, is_tri) -> prim.shape + (3, W)` replaces the vertex-table
    gather of the hit triangles' corners (_corner_rows).  It is called once,
    with the (D, N) records of every depth, before the first depth is shaded,
    so that the call happens whatever the records hold (the ring's fetch is
    collective: every rank must make it); the rows of a lane that hit no
    triangle are never used.  The default reads `scene`'s own vertex table."""
    return _shade_bundle(scene, o, d, (recs.prim, recs.is_tri, recs.occ),
                         max_depth, shadows, corner_fn)


def _shade_bundle(scene, o, d, recs_tup, max_depth, shadows, corner_fn=None):
    """Whitted shading of one flat bundle."""
    prim_all, istri_all, occ_all = recs_tup
    m = scene.materials
    accum = torch.zeros_like(o)
    thr = torch.ones((*o.shape[:-1], 1), dtype=C.DTYPE, device=o.device)
    alive = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    background = torch.tensor(C.BACKGROUND, dtype=C.DTYPE, device=o.device)
    if corner_fn is None:
        vtab, fetched = _build_vtab(scene), None
    else:
        vtab, fetched = None, corner_fn(prim_all[:max_depth + 1], istri_all[:max_depth + 1])
    mtab = _build_mtab(m)
    stab = None if scene.n_real_spheres == 0 else _build_stab(scene)

    for depth in range(max_depth + 1):
        # a layer with no live path contributes exactly zero (accum is
        # alive-masked): skip its gathers and texture sampling
        if depth > 0 and not bool(alive.any()):
            break
        prim = prim_all[depth]
        is_tri = istri_all[depth]
        occ = occ_all[depth]
        hit = prim >= 0
        rows = _corner_rows(scene, prim, is_tri, vtab) if fetched is None else fetched[depth]
        srows = _sphere_rows(scene, prim, is_tri, stab)
        t, u, v = _recompute_tuv(scene, o, d, prim, is_tri, rows, srows)
        p, n, mat = _hit_geometry(scene, o, d, t, prim, is_tri, u, v, rows, srows)

        mrows = gather_rows(mtab, mat, hit)
        ka, kd, ks, shin = mrows[..., 0:3], mrows[..., 3:6], mrows[..., 6:9], mrows[..., 9]
        if scene.textured:
            uv = _hit_uv_rows(rows, u, v, is_tri)
            kd = kd * _sample_texture_flat(scene, m.texture_id[mat], uv, hit)

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
        refl = torch.where(hit, mrows[..., 10], 0.0)
        thr = thr * refl[..., None]
        alive = alive & hit & (refl > 0.0)
        o = p_off
        d = vec.reflect(d, n)

    return accum.clamp(C.CLAMP_LO, C.CLAMP_HI)
