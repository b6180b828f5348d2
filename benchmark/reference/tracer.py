"""The benchmark's plain reference: a Whitted ray tracer in plain PyTorch,
written from the project's stated conventions and sharing no code with the
program under test.

Conventions (the project's, restated): a pinhole camera, forward =
normalize(look_at - eye), right = normalize(forward × up), up' = right ×
forward, pixel centres at ((j + 0.5) / W, (i + 0.5) / H), row 0 at the top;
Möller–Trumbore triangles and the unit-direction sphere quadratic, hits in
(T_MIN, T_MAX), the lowest index winning a tie and a triangle beating a
sphere at equal t; Phong shading ambient·ka + Σ vis · I · (kd·max(N·L, 0) +
ks·max(R·V, 0)^shininess), two-sided triangles, kd times a bilinear,
wrapped texture lookup; binary shadow rays from the hit point offset along
the normal; Whitted reflections weighted by the product of reflectivities,
a path ending at a miss or a surface that does not reflect; misses give
the background; the image is clamped to [0, 1].

The search for hits (which primitive, which lights are blocked) runs
without gradients; the hit's t, u and v are then recomputed from the
scene's tensors against that one primitive, so autograd gives the
gradient of every float leaf at the found topology.

Large scenes: rays that leave one point (primary rays from the eye, and
shadow rays, whose lines pass within RAY_OFFSET_EPS of their light) are
tested only against the triangles whose projection from that point, on
the face of a cube around it, covers the ray's bin; the bins are
conservative (a margin for rays that pass the point at a distance).
Other rays are tested against every triangle.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

T_MIN = 1e-4
T_MAX = 1e30
RAY_OFFSET_EPS = 1e-3
MT_DET_EPS = 1e-9
NORMALIZE_EPS = 1e-20
BACKGROUND = (0.05, 0.07, 0.10)

#: the reference's precision.  In float32 a sphere's silhouette pixels (the
#: discriminant near 0, its derivative unbounded) move config 3's camera
#: gradients at 1080 × 1920 by up to 9%, where float64 and every route of
#: the program agree within 0.4% (PERF.md, PR 16)
DTYPE = torch.float64
#: scenes with more triangles than this take the binned search
BRUTE_MAX_TRIS = 64
#: rays a bin of the binned search, on average
RAYS_PER_BIN = 24
#: ray-triangle tests a chunk
CHUNK_TESTS = 1 << 23


@dataclasses.dataclass
class RefScene:
    """The float leaves by their dotted paths in the program's Scene
    ("materials.kd"; no sphere or texture leaves where the scene has none)
    and the integer topology."""

    leaves: dict
    triangles: torch.Tensor
    tri_mat: torch.Tensor
    sph_mat: torch.Tensor
    texture_id: torch.Tensor
    smooth: bool

    @property
    def textured(self):
        return "textures" in self.leaves and bool((self.texture_id >= 0).any())

    def with_leaves(self, leaves: dict) -> "RefScene":
        return dataclasses.replace(self, leaves=dict(leaves))


def from_arrays(arrays: dict, device, dtype=DTYPE) -> RefScene:
    """The reference scene of a benchmark scene's arrays (``benchmark/scenes``)."""
    def f(x):
        return torch.as_tensor(x, dtype=torch.float64).to(device=device, dtype=dtype)

    def i(x):
        return torch.as_tensor(x, dtype=torch.int64).to(device)

    mats = arrays["materials"]

    def rgb(key):
        return f([[m[key]] * 3 if np.isscalar(m[key]) else m[key] for m in mats])

    leaves = {
        "vertices": f(arrays["vertices"]),
        "vnormals": f(arrays["vnormals"]),
        "uvs": f(arrays["uvs"]),
        "materials.ka": rgb("ka"),
        "materials.kd": rgb("kd"),
        "materials.ks": rgb("ks"),
        "materials.shininess": f([m["shininess"] for m in mats]),
        "materials.reflectivity": f([m["reflectivity"] for m in mats]),
        "light_pos": f([l[0] for l in arrays["lights"]]),
        "light_color": f([l[1] for l in arrays["lights"]]),
        "ambient": f(arrays["ambient"]),
        "camera.eye": f(arrays["camera"]["eye"]),
        "camera.look_at": f(arrays["camera"]["look_at"]),
        "camera.up": f(arrays["camera"]["up"]),
        "camera.fov_y": f(arrays["camera"]["fov_y"]),
    }
    spheres = arrays["spheres"]
    if spheres:
        leaves["sph_center"] = f([s[0] for s in spheres])
        leaves["sph_radius"] = f([s[1] for s in spheres])
    if arrays["textures"] is not None:
        leaves["textures"] = f(arrays["textures"])
    return RefScene(leaves=leaves, triangles=i(arrays["triangles"]),
                    tri_mat=i(arrays["tri_mat"]),
                    sph_mat=i([s[2] for s in spheres]),
                    texture_id=i([m["texture_id"] for m in mats]),
                    smooth=bool(arrays["smooth"]))


# -- vector helpers -------------------------------------------------------------

def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _unit(a):
    return a / torch.sqrt(_dot(a, a) + NORMALIZE_EPS)[..., None]


def _reflect(d, n):
    return d - 2.0 * _dot(d, n)[..., None] * n


def _rows(table, idx):
    """table[idx] by ``index_select``, whose backward adds rows with
    ``index_add_`` (plain indexing's sorts every index first)."""
    return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *table.shape[1:])


# -- intersection -------------------------------------------------------------

def _tri_test(o, d, v0, e1, e2, t_max):
    """Möller–Trumbore, rays and triangles paired row by row:
    (hit, t, u, v)."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    ok = det.abs() >= MT_DET_EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = o - v0
    u = _dot(tvec, pvec) * inv
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv
    t = _dot(e2, qvec) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN) & (t < t_max)
    return hit, t, u, v


def _sph_test(o, d, c, r, t_max):
    """Unit-direction sphere quadratic, rays and spheres paired row by row:
    (hit, t, takes the far root)."""
    oc = o - c
    b = _dot(oc, d)
    disc = b * b - (_dot(oc, oc) - r * r)
    has = disc > 0
    sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    t0, t1 = -b - sq, -b + sq
    ok0 = has & (t0 > T_MIN) & (t0 < t_max)
    ok1 = has & (t1 > T_MIN) & (t1 < t_max)
    t = torch.where(ok0, t0, t1)
    return ok0 | ok1, t, ~ok0


def _tri_corners(scene, tri):
    v = scene.leaves["vertices"]
    idx = scene.triangles[tri]
    return _rows(v, idx[..., 0]), _rows(v, idx[..., 1]), _rows(v, idx[..., 2])


def _brute_pairs(n_rays, n_tris, device):
    """Every (ray, triangle) pair, in chunks."""
    per = max(1, CHUNK_TESTS // max(n_tris, 1))
    tri = torch.arange(n_tris, device=device)
    for s in range(0, n_rays, per):
        r = torch.arange(s, min(s + per, n_rays), device=device)
        yield r.repeat_interleave(n_tris), tri.repeat(len(r))


def _binned_pairs(point, dirs, delta, corners):
    """Candidate (ray, triangle) pairs, in chunks, for rays whose lines pass
    within `delta` of `point` with unit directions `dirs` (pointing away
    from it): every pair whose triangle can meet its ray."""
    dev = dirs.device
    e = dirs.float()
    pt = point.float()
    rel = torch.stack([c.float() - pt for c in corners], 1)           # (T, 3, 3)
    ax = e.abs().argmax(-1)
    sgn = torch.gather(e, 1, ax[:, None])[:, 0] >= 0
    face = ax * 2 + (~sgn).long()
    zsmall = max(4.0 * delta, 1e-6)
    for f in range(6):
        rays = (face == f).nonzero()[:, 0]
        if len(rays) == 0:
            continue
        k, s = f // 2, (1.0 if f % 2 == 0 else -1.0)
        a, b = [j for j in range(3) if j != k]
        ez = s * e[rays, k]
        ru, rv = e[rays, a] / ez, e[rays, b] / ez
        nb = max(1, int(math.sqrt(len(rays) / RAYS_PER_BIN)))
        u0, u1 = float(ru.min()), float(ru.max())
        v0, v1 = float(rv.min()), float(rv.max())
        wu, wv = max((u1 - u0) / nb, 1e-9), max((v1 - v0) / nb, 1e-9)
        rb = ((ru - u0) / wu).floor().clamp(0, nb - 1).long() * nb \
            + ((rv - v0) / wv).floor().clamp(0, nb - 1).long()
        order = torch.argsort(rb)
        counts = torch.bincount(rb, minlength=nb * nb)
        starts = torch.cumsum(counts, 0) - counts
        # triangles: skipped (behind the point), in every bin (too near the
        # point's plane to project), or in the bins of their widened box
        z = s * rel[..., k]
        zmin, zmax = z.min(1).values, z.max(1).values
        live = zmax >= -(2.0 * delta + 1e-6)
        every = live & (zmin <= zsmall)
        boxed = (live & ~every).nonzero()[:, 0]
        zb = z[boxed]
        pu, pv = rel[boxed][..., a] / zb, rel[boxed][..., b] / zb
        margin = math.sqrt(3.0) * delta / zmin[boxed] + 1e-5
        lo_u = pu.min(1).values - margin - 1e-6 * pu.abs().max(1).values
        hi_u = pu.max(1).values + margin + 1e-6 * pu.abs().max(1).values
        lo_v = pv.min(1).values - margin - 1e-6 * pv.abs().max(1).values
        hi_v = pv.max(1).values + margin + 1e-6 * pv.abs().max(1).values
        inside = (hi_u >= u0) & (lo_u <= u1) & (hi_v >= v0) & (lo_v <= v1)
        boxed, lo_u, hi_u, lo_v, hi_v = (x[inside] for x in (boxed, lo_u, hi_u, lo_v, hi_v))
        bu0 = ((lo_u - u0) / wu).floor().clamp(0, nb - 1).long()
        bu1 = ((hi_u - u0) / wu).floor().clamp(0, nb - 1).long()
        bv0 = ((lo_v - v0) / wv).floor().clamp(0, nb - 1).long()
        bv1 = ((hi_v - v0) / wv).floor().clamp(0, nb - 1).long()
        nv = bv1 - bv0 + 1
        cnt = (bu1 - bu0 + 1) * nv
        pid = torch.repeat_interleave(torch.arange(len(boxed), device=dev), cnt)
        off = torch.arange(len(pid), device=dev) - (torch.cumsum(cnt, 0) - cnt)[pid]
        pair_bin = (bu0[pid] + off // nv[pid]) * nb + bv0[pid] + off % nv[pid]
        pair_tri = boxed[pid]
        all_tri = every.nonzero()[:, 0]
        pair_bin = torch.cat([pair_bin, torch.arange(nb * nb, device=dev).repeat(len(all_tri))])
        pair_tri = torch.cat([pair_tri, all_tri.repeat_interleave(nb * nb)])
        n_per = counts[pair_bin]
        keep = n_per > 0
        pair_bin, pair_tri, n_per = pair_bin[keep], pair_tri[keep], n_per[keep]
        if len(n_per) == 0:
            continue
        cum = torch.cumsum(n_per, 0)
        marks = torch.arange(1, int(cum[-1]) // CHUNK_TESTS + 1, device=dev) * CHUNK_TESTS
        cut = torch.searchsorted(cum, marks, right=True).tolist()
        bounds = [0] + [c for c in cut if c > 0] + [len(n_per)]
        excl = cum - n_per
        for p0, p1 in zip(bounds[:-1], bounds[1:]):
            if p1 <= p0:
                continue
            n = n_per[p0:p1]
            q = torch.repeat_interleave(torch.arange(p0, p1, device=dev), n)
            within = torch.arange(len(q), device=dev) - (excl[q] - excl[p0])
            yield rays[order[starts[pair_bin[q]] + within]], pair_tri[q]


def _pairs(scene, o, d, common, delta):
    n_tris = scene.triangles.shape[0]
    if n_tris <= BRUTE_MAX_TRIS or common is None:
        return _brute_pairs(o.shape[0], n_tris, o.device)
    return _binned_pairs(common, d, delta, _tri_corners(scene, torch.arange(n_tris, device=o.device)))


def closest(scene, o, d, common=None):
    """Closest hit of rays (N, 3): {"hit", "is_tri", "prim", "far"} (far: a
    sphere hit takes the far root).  `common`: a point every ray leaves."""
    dev = o.device
    n = o.shape[0]
    best = torch.full((n,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev)
    for ray, tri in _pairs(scene, o, d, common, 0.0):
        v0, v1, v2 = _tri_corners(scene, tri)
        hit, t, _, _ = _tri_test(o[ray], d[ray], v0, v1 - v0, v2 - v0, T_MAX)
        ray, tri, t = ray[hit], tri[hit], t[hit].float()
        key = (t.view(torch.int32).long() << 32) | tri
        best.scatter_reduce_(0, ray, key, "amin")
    tri_hit = best != torch.iinfo(torch.int64).max
    tri_id = torch.where(tri_hit, best & 0xFFFFFFFF, 0)
    tri_t = torch.where(tri_hit, (best >> 32).int().view(torch.float32),
                        torch.full((n,), float("inf"), device=dev))
    sph_t = torch.full((n,), float("inf"), device=dev)
    sph_id = torch.zeros(n, dtype=torch.int64, device=dev)
    far = torch.zeros(n, dtype=torch.bool, device=dev)
    if "sph_center" in scene.leaves:
        c, r = scene.leaves["sph_center"], scene.leaves["sph_radius"]
        for j in range(c.shape[0]):
            hit, t, fr = _sph_test(o, d, c[j], r[j], T_MAX)
            better = hit & (t.float() < sph_t)
            sph_t = torch.where(better, t.float(), sph_t)
            sph_id = torch.where(better, j, sph_id)
            far = torch.where(better, fr, far)
    is_tri = tri_t <= sph_t
    return {"hit": torch.minimum(tri_t, sph_t) < float("inf"), "is_tri": is_tri,
            "prim": torch.where(is_tri, tri_id, sph_id), "far": far & ~is_tri}


def occluded(scene, o, d, t_max, light=None):
    """Any hit in (T_MIN, t_max) of rays (N, 3); `light`: the point the rays
    end near (shadow rays pass within RAY_OFFSET_EPS of it), for the binned
    search."""
    out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    if light is not None and scene.triangles.shape[0] > BRUTE_MAX_TRIS and len(o):
        # how far the rays' lines pass from the light, as computed
        delta = float(_cross(light.float() - o.float(), d.float()).norm(dim=-1).max()) * 1.01
        pairs = _binned_pairs(light, -d, delta,
                              _tri_corners(scene, torch.arange(scene.triangles.shape[0],
                                                               device=o.device)))
    else:
        pairs = _brute_pairs(o.shape[0], scene.triangles.shape[0], o.device)
    for ray, tri in pairs:
        v0, v1, v2 = _tri_corners(scene, tri)
        hit, _, _, _ = _tri_test(o[ray], d[ray], v0, v1 - v0, v2 - v0, t_max[ray])
        out[ray[hit]] = True
    if "sph_center" in scene.leaves:
        c, r = scene.leaves["sph_center"], scene.leaves["sph_radius"]
        for j in range(c.shape[0]):
            out |= _sph_test(o, d, c[j], r[j], t_max)[0]
    return out


# -- shading ------------------------------------------------------------------

def camera_rays(scene, height, width):
    L = scene.leaves
    eye = L["camera.eye"]
    fwd = _unit(L["camera.look_at"] - eye)
    right = _unit(_cross(fwd, L["camera.up"]))
    up = _cross(right, fwd)
    half_h = torch.tan(L["camera.fov_y"] * 0.5)
    half_w = half_h * (width / height)
    dt = eye.dtype
    i = (torch.arange(height, device=eye.device, dtype=dt) + 0.5) / height
    j = (torch.arange(width, device=eye.device, dtype=dt) + 0.5) / width
    sx = (2.0 * j - 1.0) * half_w
    sy = (1.0 - 2.0 * i) * half_h
    d = fwd + sx[None, :, None] * right + sy[:, None, None] * up
    d = _unit(d).reshape(-1, 3)
    return eye.expand(d.shape), d


def _bilinear(tex, tid, uv):
    _, th, tw, _ = tex.shape
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x, y = u * tw - 0.5, v * th - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    flat = tex.reshape(-1, 3)

    def texel(dx, dy):
        xi = torch.remainder((x0 + dx).long(), tw)
        yi = torch.remainder((y0 + dy).long(), th)
        return _rows(flat, (tid * th + yi) * tw + xi)

    return (texel(0, 0) * (1 - fx) * (1 - fy) + texel(1, 0) * fx * (1 - fy)
            + texel(0, 1) * (1 - fx) * fy + texel(1, 1) * fx * fy)


def _shade(scene, o, d, rec, shadows, counts, depth):
    """Colour, reflectivity, offset point and reflected direction of hit
    lanes (o, d at the hits), differentiable in the scene's leaves."""
    L = scene.leaves
    is_tri, prim = rec["is_tri"], rec["prim"]
    n_tris = scene.triangles.shape[0]
    tprim = torch.where(is_tri, prim, 0).clamp_max(n_tris - 1)
    v0, v1, v2 = _tri_corners(scene, tprim)
    e1, e2 = v1 - v0, v2 - v0
    _, t_tri, u, v = _tri_test(o, d, v0, e1, e2, T_MAX)
    idx = scene.triangles[tprim]
    if scene.smooth:
        vn = L["vnormals"]
        w = (1.0 - u - v)[:, None]
        n_tri = _unit(w * _rows(vn, idx[:, 0]) + u[:, None] * _rows(vn, idx[:, 1])
                      + v[:, None] * _rows(vn, idx[:, 2]))
    else:
        n_tri = _unit(_cross(e1, e2))
    n_tri = torch.where((_dot(n_tri, d) > 0)[:, None], -n_tri, n_tri)
    if "sph_center" in L:
        sprim = torch.where(is_tri, 0, prim)
        c, r = _rows(L["sph_center"], sprim), _rows(L["sph_radius"], sprim)
        _, t_near, _ = _sph_test(o, d, c, r, T_MAX)
        oc = o - c
        b = _dot(oc, d)
        disc = b * b - (_dot(oc, oc) - r * r)
        sq = torch.sqrt(torch.where(disc > 0, disc, torch.ones_like(disc)))
        t_sph = torch.where(rec["far"], -b + sq, -b - sq)
        t = torch.where(is_tri, t_tri, t_sph)
        p = o + t[:, None] * d
        n = torch.where(is_tri[:, None], n_tri, _unit(p - c))
        mat = torch.where(is_tri, scene.tri_mat[tprim], scene.sph_mat[sprim])
    else:
        p = o + t_tri[:, None] * d
        n = n_tri
        mat = scene.tri_mat[tprim]
    ka, kd, ks = (_rows(L[f"materials.{k}"], mat) for k in ("ka", "kd", "ks"))
    shin = _rows(L["materials.shininess"], mat)
    if scene.textured:
        tid = scene.texture_id[mat]
        uvs = L["uvs"]
        w = (1.0 - u - v)[:, None]
        uv = w * _rows(uvs, idx[:, 0]) + u[:, None] * _rows(uvs, idx[:, 1]) \
            + v[:, None] * _rows(uvs, idx[:, 2])
        uv = torch.where(is_tri[:, None], uv, torch.zeros_like(uv))
        col = _bilinear(L["textures"], tid.clamp_min(0), uv)
        kd = kd * torch.where((tid < 0)[:, None], torch.ones_like(col), col)
    color = ka * L["ambient"]
    p_off = p + n * RAY_OFFSET_EPS
    for li in range(L["light_pos"].shape[0]):
        to_l = L["light_pos"][li] - p
        dist = torch.sqrt(_dot(to_l, to_l))
        ldir = to_l / dist.clamp_min(1e-20)[:, None]
        ndotl = _dot(n, ldir).clamp_min(0.0)
        rdotv = _dot(_reflect(-ldir, n), -d).clamp_min(0.0)
        safe = torch.where(rdotv > 0, rdotv, torch.ones_like(rdotv))
        spec = torch.where((ndotl > 0) & (rdotv > 0), safe ** shin, torch.zeros_like(rdotv))
        if shadows:
            with torch.no_grad():
                blocked = occluded(scene, p_off.detach(), ldir.detach(),
                                   (dist - RAY_OFFSET_EPS).detach(),
                                   light=L["light_pos"][li].detach())
            counts["blocked"][depth] += int(blocked.sum())
            vis = (~blocked).to(color.dtype)[:, None]
        else:
            vis = 1.0
        color = color + vis * L["light_color"][li] * (kd * ndotl[:, None] + ks * spec[:, None])
    refl = _rows(L["materials.reflectivity"], mat)
    return color, refl, p_off, _reflect(d, n)


def render(scene, height, width, max_depth, shadows, with_counts=False):
    """The (H, W, 3) image, differentiable in the scene's leaves; with
    `with_counts` also the path counts ({"rays", "shaded_tri", "shaded_sph",
    "blocked"}, one entry a depth)."""
    D = max_depth + 1
    counts = {k: [0] * D for k in ("rays", "shaded_tri", "shaded_sph", "blocked")}
    o, d = camera_rays(scene, height, width)
    dt = d.dtype
    n = o.shape[0]
    accum = torch.zeros((n, 3), dtype=dt, device=d.device)
    lane = torch.arange(n, device=d.device)
    thr = torch.ones((n, 1), dtype=dt, device=d.device)
    bg = torch.tensor(BACKGROUND, dtype=dt, device=d.device)
    for depth in range(D):
        if len(lane) == 0:
            break
        counts["rays"][depth] += len(lane)
        with torch.no_grad():
            rec = closest(scene, o.detach(), d.detach(),
                          common=scene.leaves["camera.eye"].detach() if depth == 0 else None)
        miss = (~rec["hit"]).nonzero()[:, 0]
        accum = accum.index_add(0, lane[miss], thr[miss] * bg)
        h = rec["hit"].nonzero()[:, 0]
        hrec = {k: val[h] for k, val in rec.items()}
        counts["shaded_tri"][depth] += int(hrec["is_tri"].sum())
        counts["shaded_sph"][depth] += int((~hrec["is_tri"]).sum())
        color, refl, p_off, rdir = _shade(scene, o[h], d[h], hrec, shadows, counts, depth)
        accum = accum.index_add(0, lane[h], thr[h] * color)
        keep = (refl > 0).nonzero()[:, 0]
        lane, thr = lane[h][keep], thr[h][keep] * refl[keep][:, None]
        o, d = p_off[keep], rdir[keep]
    img = accum.clamp(0.0, 1.0).reshape(height, width, 3)
    return (img, counts) if with_counts else img


def loss_and_grads(scene, target, height, width, max_depth, shadows):
    """(loss, {leaf: gradient}, path counts) of the mean squared error of
    the render against `target`."""
    names = list(scene.leaves)
    live = {k: v.detach().requires_grad_(True) for k, v in scene.leaves.items()}
    with torch.enable_grad():
        img, counts = render(scene.with_leaves(live), height, width, max_depth, shadows,
                             with_counts=True)
        loss = torch.mean((img - target.to(img.dtype)) ** 2)
        grads = torch.autograd.grad(loss, [live[k] for k in names], allow_unused=True)
    return (loss.detach(),
            {k: torch.zeros_like(live[k]) if g is None else g for k, g in zip(names, grads)},
            counts)


def sgd(scene, grads, lr):
    """Every float leaf moved by -lr × its gradient."""
    return scene.with_leaves({k: v - lr * grads[k] for k, v in scene.leaves.items()})
