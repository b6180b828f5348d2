"""The sharded scene and its ring (Distribution B), the counterpart of
``tpurt/dist/scene_shard.py`` over ``torch.distributed``.

The image is split into row slabs as in Distribution A (``dist/shard.py``),
and the triangle set is sharded too.  On the host the triangles are
renumbered into cluster-major order (`renumber_by_clusters`), so that a
contiguous range of clusters owns a contiguous range of global triangle ids,
and rank i holds (`shard_scene_clusters`):

* 1/n of the cluster blocks, and the traversal kernel's packing of them
  (``kernels/packc.py``), built by the rank from its own slice;
* the matching triangle rows, padded to a common Tmax;
* the rows of the merged vertex table that its triangles use (``widx``),
  with their corners renumbered into that list.

Materials, spheres, lights, textures and the camera stay replicated.  One
process runs a rank, and every rank calls with the same renumbered scene
and the same `ShardParts`.

Each bounce passes the rays of every rank's slab n times around the ring.
At each step a rank skips the rays that miss its shard's root box or whose
best t so far lies before the box's entry (a ray at equality is kept),
compacts the others (live first, in Morton order), traces them with the
traversal kernel's mode 1 (``trace_bounce``) against its own clusters, maps
local ids to global ids, folds the result into the carried (t, gid) record
(the smaller t wins; at equal t the smaller id) and sends the packet to rank
r+1 (`shard.ring_shift`).  The rank whose clusters improve a ray's best hit
also computes the ray's continuation from its own packed forms
(``traversal._hit_rows`` and ``_continuation``): the hit point, the offset
point, the reflected direction and whether the material reflects travel
with the record, so the rays of the next bounce are those the replicated
wavefront loop makes (``traversal._continue_rays``).  Counting a compacted
packet's live rays for the kernel is one host sync a step.

Shadows differ from ``tpurt``, which runs one closest-hit ring a light with
the band's end carried along.  Here the hit points (p, p_off) go around the
ring once a bounce; every rank runs the kernel's any-hit mode 2
(``trace_shadows``) against its shard, and the occlusion bits are OR-ed into
the carried bits.  This is exact, because any-hit over a union of shards is
the OR of any-hit over each shard, and it takes one pass for all lights; a
ray whose bits are all set skips the rest of the ring.

Shading stays on the rank that owns the pixel.  The port has no (T, K)
shadepack (ROADMAP, Queue 2, "Left out"), so each rank's slice of hit-corner
rows, ``gather_rows(vtab_loc, tri_loc)`` with shape (Tmax, 3·W), rotates
around the ring once a frame; the rows of every depth's hits are fetched
with one masked ``gather_rows`` a step and selected with ``torch.where``, so
they equal the replicated gather bit for bit, and each step's backward is
the segment-sum kernel.  The backward of the rotations (``_RingShift``)
carries each slice's cotangent back to the rank that owns it, and the
vertex table's gathers hand it to the scene's global leaves.  Every float
leaf's per-rank gradient is then summed in rank order.

Every ring packet has the same length on every rank, rows_per_device(H, n)·W
rays: a rank with an empty window sends dead rays and takes part in every
step.  The bounces and shadow passes that no rank needs are skipped by all
ranks alike (`shard.any_over_ranks`).  World 1 sends nothing.  Not carried
over: the two half-packets that overlap communication with compute
(``tpurt/dist/scene_shard.py:214-219``), which are speed, not function.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpurt_torch import constants as C
from tpurt_torch.core import geom
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.dist.shard import (Mesh, _GatherRows, _RingShift, any_over_ranks, rank_rows,
                                    ring_shift, rows_per_device)
from tpurt_torch.kernels import packc as PC
from tpurt_torch.kernels import traversal as TV
from tpurt_torch.shading.deferred import _build_vtab, gather_rows, records_from_ids, \
    shade_from_records

# the closest-hit packet's float columns: origin, direction, best t, then the
# continuation at the best hit: hit point, offset point, reflected direction
_O, _D, _T, _P, _POFF, _REFL, _NF = 0, 3, 6, 7, 10, 13, 16
# its int columns: best global id, flags (bit 0 live, bit 1 the hit reflects)
_LIVE, _REFLECTS = 1, 2

#: None on the render path.  When a dict, the first kernel call of each kind
#: ("closest", "shadows") at a ring step >= 1, which traces rays of another
#: rank, leaves here the shard's packing, the compacted packet as the kernel
#: took it and what the kernel returned (tools/ring_check.py holds them to
#: the plain versions)
tap = None


def _tapped(kind: str, step: int, **call) -> None:
    if tap is not None and step >= 1 and kind not in tap:
        tap[kind] = call


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def renumber_by_clusters(scene, tri_ids):
    """Permute the triangles into cluster-major first-occurrence order, so
    that each contiguous cluster range owns one contiguous global id range →
    (scene2, tri_ids2 (C, LEAF) int32).  Idempotent.  Images are the same
    except on exact-t ties between different triangles (the lowest-id rule
    follows the new numbering); vertices keep their order, so every float
    gradient maps one to one."""
    flat = _host(tri_ids).reshape(-1)
    T = scene.n_tris
    _, first = np.unique(flat, return_index=True)
    order = flat[np.sort(first)]                  # old ids, cluster-major
    if order.shape[0] != T:
        raise ValueError(f"the clusters hold {order.shape[0]} of the scene's {T} triangles")
    inv = np.empty(T, np.int64)
    inv[order] = np.arange(T)
    dev = scene.triangles.device
    order_t = torch.from_numpy(order).to(dev)
    scene2 = dataclasses.replace(scene, triangles=scene.triangles[order_t].contiguous(),
                                 tri_mat=scene.tri_mat[order_t].contiguous())
    tri_ids2 = inv[_host(tri_ids)].astype(np.int32)
    where = tri_ids.device if isinstance(tri_ids, torch.Tensor) else dev
    return scene2, torch.from_numpy(tri_ids2).to(where)


def shard_scene_clusters(scene, tri_ids2, n: int):
    """Cut the renumbered scene into n shards (host numpy, after
    `renumber_by_clusters`): the cluster list in n contiguous slices (padded
    with duplicates of the last cluster, harmless to closest and any hit) and
    the matching triangle rows, padded to a common Tmax; each shard's
    corners renumbered into `widx`, the sorted unique global vertex ids its
    triangles use (exact lists: on a connected mesh a split plane's vertices
    are shared by distant cluster ranges, which stretches any window to the
    whole table).

    Returns (tloc (n, Cs, LEAF) local ids, tri_sh (n, Tmax, 3) local
    corners, tmat_sh (n, Tmax), t0s (n,), cnts (n,), widx (n, Vmax), Tmax)
    as numpy arrays; rows [t0s[i], t0s[i] + cnts[i]) are the ones shard i
    serves to the shading ring, disjoint over the shards."""
    tri_ids2 = _host(tri_ids2)
    tris = _host(scene.triangles)
    tmat = _host(scene.tri_mat)
    T = tris.shape[0]
    n_clusters = tri_ids2.shape[0]
    Cs = -(-n_clusters // n)
    if Cs * n != n_clusters:
        # duplicates of the LAST cluster stay inside the last shard's range
        pad = np.broadcast_to(tri_ids2[-1:], (Cs * n - n_clusters, tri_ids2.shape[1]))
        tri_ids2 = np.concatenate([tri_ids2, pad], axis=0)
    t0s = np.empty(n, np.int64)
    trace_hi = np.empty(n, np.int64)      # ids the shard's clusters touch
    for i in range(n):
        sl = tri_ids2[i * Cs:(i + 1) * Cs]
        t0s[i] = sl.min()
        trace_hi[i] = sl.max() + 1
    # the renumbering's contiguity: duplicate-pad shards may repeat the
    # previous shard's range (t0s never decreases and leaves no gap)
    if not (t0s[0] == 0 and trace_hi.max() == T):
        raise ValueError(f"the shards do not cover [0, {T}): t0s {t0s}, ends {trace_hi}; "
                         "renumber_by_clusters first")
    if not all(t0s[i + 1] <= trace_hi[i] for i in range(n - 1)):
        raise ValueError(f"the shards' id ranges leave gaps: t0s {t0s}, ends {trace_hi}")
    # disjoint ranges for the shading ring: [t0s[i], t0s[i+1]); duplicate-pad
    # shards get cnt 0
    fetch_hi = np.concatenate([t0s[1:], [T]])
    cnts = np.maximum(fetch_hi - t0s, 0)
    # the trace needs every row its clusters reference, which can pass the
    # fetch range on duplicate-pad shards: slices hold the real rows at
    # [t0, t0 + Tmax)
    Tmax = int(np.maximum(trace_hi - t0s, cnts).max())
    tri_sh = np.zeros((n, Tmax, 3), tris.dtype)
    tmat_sh = np.zeros((n, Tmax), tmat.dtype)
    tloc = np.empty((n, Cs, tri_ids2.shape[1]), np.int32)
    for i in range(n):
        c = int(min(Tmax, T - t0s[i]))
        tri_sh[i, :c] = tris[t0s[i]:t0s[i] + c]
        tri_sh[i, c:] = tris[t0s[i]:t0s[i] + 1]    # pad rows: never packed
        tmat_sh[i, :c] = tmat[t0s[i]:t0s[i] + c]
        tmat_sh[i, c:] = tmat[t0s[i]]
        tloc[i] = tri_ids2[i * Cs:(i + 1) * Cs] - t0s[i]
    # each shard's vertex list, and its corners as positions in that list
    uniq = [np.unique(tri_sh[i].reshape(-1)) for i in range(n)]
    Vmax = max(int(u.shape[0]) for u in uniq)
    widx = np.empty((n, Vmax), np.int64)
    for i, u in enumerate(uniq):
        widx[i, :u.shape[0]] = u
        widx[i, u.shape[0]:] = u[-1]                 # pad: never referenced
        tri_sh[i] = np.searchsorted(u, tri_sh[i])
    return (tloc, tri_sh, tmat_sh, t0s.astype(np.int32), cnts.astype(np.int32),
            widx.astype(np.int32), Tmax)


@dataclasses.dataclass(frozen=True)
class ShardParts:
    """The host-built topology of n shards (`prepare_scene_sharded`), CPU
    integer tensors: frozen across steps, as a clusters plan's topology is.
    tri_sh's corners index the shard's own vertex list widx; tri_ids is the
    whole renumbered topology, the replicated clusters plan of scene2."""

    tri_ids: torch.Tensor   # (C, LEAF) i32: global ids, after renumber_by_clusters
    tloc: torch.Tensor      # (n, Cs, LEAF) i32: local triangle ids
    tri_sh: torch.Tensor    # (n, Tmax, 3) i32: corners, positions in widx[i]
    tmat_sh: torch.Tensor   # (n, Tmax) i32
    t0s: torch.Tensor       # (n,) i32: first global id of each shard
    cnts: torch.Tensor      # (n,) i32: ids each shard serves to shading
    widx: torch.Tensor      # (n, Vmax) i32: global vertex ids
    T_global: int
    # each rank's upper level over its clusters, built at its first render
    trees: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def n(self) -> int:
        return self.tloc.shape[0]

    @property
    def t_max(self) -> int:
        return self.tri_sh.shape[1]


def prepare_scene_sharded(scene, tri_ids, n: int):
    """Renumber the scene into cluster-major order and cut n shards (host
    work: call it once) → (scene2, ShardParts).  Pass scene2, or any update of
    it with the same topology (moved vertices, new materials), with the parts
    to `render_scene_sharded_prepared`; parts.tri_ids is scene2's replicated
    clusters plan."""
    scene2, tri_ids2 = renumber_by_clusters(scene, tri_ids)
    tloc, tri_sh, tmat_sh, t0s, cnts, widx, _ = shard_scene_clusters(scene2, tri_ids2, n)
    return scene2, ShardParts(tri_ids2.cpu(),
                              *(torch.from_numpy(a) for a in (tloc, tri_sh, tmat_sh, t0s,
                                                               cnts, widx)),
                              T_global=scene2.n_tris)


@dataclasses.dataclass
class _Resident:
    """What a rank holds of its shard for one frame."""

    packed: PC.PackedClusters
    corners: torch.Tensor   # (Tmax, 3·W): hit-corner rows, under autograd
    t0: int
    root: torch.Tensor      # (1, 2, 4) the shard's widened root box
    lo: torch.Tensor        # (3,) the shard's box, for the Morton keys
    hi: torch.Tensor
    light_pos: torch.Tensor


def _resident(scene2, parts: ShardParts, mesh: Mesh) -> _Resident:
    """This rank's shard of `scene2`: its vertex rows (a gather of the merged
    vertex table, whose backward is the segment-sum kernel), the scene of its
    triangles over them, its packed clusters and its hit-corner slice."""
    r, dev = mesh.rank, mesh.device
    tri_loc = parts.tri_sh[r].to(dev).long()
    widx = parts.widx[r].to(dev).long()
    vtab_loc = gather_rows(_build_vtab(scene2), widx,
                           torch.ones(widx.shape, dtype=torch.bool, device=dev))
    rows = vtab_loc.detach()
    k = 3 + (3 if scene2.smooth else 0)
    scene_loc = dataclasses.replace(
        scene2, triangles=tri_loc.to(torch.int32), tri_mat=parts.tmat_sh[r].to(dev),
        vertices=rows[:, 0:3],
        vnormals=rows[:, 3:6] if scene2.smooth else scene2.vnormals,
        uvs=rows[:, k:k + 2] if scene2.textured else scene2.uvs)
    tloc = parts.tloc[r].to(dev)
    key = (r, str(dev))
    if key not in parts.trees:
        parts.trees[key] = PC.tree_for(scene_loc, tloc)
    packed = PC.pack_clusters(scene_loc, tloc, parts.trees[key])
    T = parts.t_max
    corners = gather_rows(vtab_loc, tri_loc,
                          torch.ones((T,), dtype=torch.bool, device=dev)).reshape(T, -1)
    return _Resident(packed=packed, corners=corners, t0=int(parts.t0s[r]),
                     root=packed.boxes[0:1], lo=packed.aabb_lo.amin(0),
                     hi=packed.aabb_hi.amax(0), light_pos=scene2.light_pos.detach())


def _merge(best_t, best_id, t_new, id_new):
    """Which lanes a shard's hits (t_new, global id_new) improve in the
    carried record: a smaller t, or at equal t a smaller id (the kernel's
    own rule, so the fold over the shards picks the replicated winner)."""
    tie = (t_new == best_t) & (t_new < C.T_NONE) & (id_new >= 0)
    tie = tie & ((id_new < best_id) | (best_id < 0))
    return (t_new < best_t) | tie


def _closest_step(res: _Resident, config, fl, it, step: int, T_global: int) -> None:
    """One ring step of closest hit on this rank's shard, in place on the
    arrived packet (fl (P, 16) f32, it (P, 2) i32)."""
    packed = res.packed
    o, d, bt = fl[:, _O:_O + 3], fl[:, _D:_D + 3], fl[:, _T]
    gid = it[:, 0]
    live = (it[:, 1] & _LIVE) != 0
    # the root-box skip: the ray must enter the box no later than its best t
    keep = torch.isfinite(TV.box_entry_reference(res.root.expand(o.shape[0], 2, 4), o, d, bt))
    if packed.n_spheres and step == 0:
        # spheres are in every shard: the home step traces every ray once
        keep = torch.ones_like(keep)
    live = live & keep
    n_live = int(live.sum())          # the step's host sync
    if n_live == 0:
        return
    perm = torch.argsort(TV._bin_key(o, d, res.lo, res.hi, live), stable=True)
    o_s, d_s, live_s = o[perm].contiguous(), d[perm].contiguous(), live[perm]
    ids_s, _, t_s, _ = TV.trace_bounce(packed, config, o_s, d_s, live_s, n_live, shadows=False)
    _tapped("closest", step, packed=packed, o=o_s, d=d_s, alive=live_s, n_live=n_live,
            ids=ids_s, t=t_s)
    lanes, loc, t_new = perm[:n_live], ids_s[:n_live], t_s[:n_live]
    # local → global ids: a triangle adds the shard's first id, a sphere
    # (local id >= Tmax) maps past every global triangle
    Tmax = packed.n_tris
    g = torch.where(loc < 0, loc, torch.where(loc < Tmax, loc + res.t0, loc - Tmax + T_global))
    imp = _merge(bt[lanes], gid[lanes], t_new, g)
    lanes, loc, t_new, g = lanes[imp], loc[imp], t_new[imp], g[imp]
    # the continuation from this shard's forms, in the kernel's arithmetic
    o3, d3 = TV._cols(o[lanes]), TV._cols(d[lanes])
    t, u, v, a = TV._hit_rows(packed, o3, d3, loc)
    p, _, p_off, refl = TV._continuation(packed, o3, d3, t, u, v, a)
    fl[lanes, _T] = t_new
    fl[lanes, _P:_P + 3] = torch.stack(p, 1)
    fl[lanes, _POFF:_POFF + 3] = torch.stack(p_off, 1)
    fl[lanes, _REFL:_REFL + 3] = torch.stack(refl, 1)
    it[lanes, 0] = g
    it[lanes, 1] = _LIVE | torch.where(a[:, PC.R_REFL] > 0.0, _REFLECTS, 0).to(torch.int32)


def _ring_closest(res: _Resident, config, mesh: Mesh, o, d, alive, T_global: int):
    """n ring steps of closest hit for the rays that start on this rank →
    the packet back home: fl (P, 16) (origin, direction, best t, hit point,
    offset point, reflected direction) and it (P, 2) (best global id, -1 for
    none; flags)."""
    P = o.shape[0]
    fl = torch.zeros((P, _NF), dtype=C.DTYPE, device=o.device)
    fl[:, _O:_O + 3] = o
    fl[:, _D:_D + 3] = d
    fl[:, _T] = C.T_NONE
    it = torch.stack([torch.full((P,), -1, dtype=torch.int32, device=o.device),
                      alive.to(torch.int32) * _LIVE], 1)
    for step in range(mesh.size):
        _closest_step(res, config, fl, it, step, T_global)
        fl, it = ring_shift([fl, it], mesh)
    return fl, it


def _segments_enter(res: _Resident, p, p_off, bits):
    """Whether the shadow ray to some light not yet known to be blocked
    enters the shard's root box before the light: a cull no looser than the
    kernel's own box tests (the box is widened by packc.BOX_MARGIN)."""
    enter = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    root = res.root.expand(p.shape[0], 2, 4)
    for li in range(res.light_pos.shape[0]):
        to_l = res.light_pos[li] - p
        dist = torch.sqrt((to_l * to_l).sum(1))
        ldir = to_l / dist.clamp_min(1e-20)[:, None]
        open_l = ((bits >> li) & 1) == 0
        enter = enter | (open_l & torch.isfinite(TV.box_entry_reference(root, p_off, ldir, dist)))
    return enter


def _ring_shadows(res: _Resident, config, mesh: Mesh, p, p_off, hit):
    """Occlusion bits of this rank's hit points against every shard: n ring
    steps of the kernel's any-hit mode, the bits OR-ed → (P,) int32."""
    full = (1 << res.light_pos.shape[0]) - 1
    fl = torch.cat([p, p_off], 1)
    it = torch.stack([torch.zeros_like(hit, dtype=torch.int32), hit.to(torch.int32)], 1)
    for step in range(mesh.size):
        pts, offs, bits = fl[:, 0:3], fl[:, 3:6], it[:, 0]
        live = (it[:, 1] != 0) & (bits != full)
        if not (res.packed.n_spheres and step == 0):
            # the spheres lie outside the root box: the home step tests them
            live = live & _segments_enter(res, pts, offs, bits)
        n_live = int(live.sum())      # the step's host sync
        if n_live:
            perm = torch.argsort(TV._bin_key_pts(pts, res.lo, res.hi, live), stable=True)
            p_s, off_s, live_s = pts[perm].contiguous(), offs[perm].contiguous(), live[perm]
            occ, _ = TV.trace_shadows(res.packed, config, p_s, off_s, live_s, n_live)
            _tapped("shadows", step, packed=res.packed, p=p_s, p_off=off_s, alive=live_s,
                    n_live=n_live, occ=occ)
            lanes = perm[:n_live]
            it[lanes, 0] = bits[lanes] | occ[:n_live]
        fl, it = ring_shift([fl, it], mesh)
    return it[:, 0]


@torch.no_grad()
def _ring_records(res: _Resident, config: RenderConfig, mesh: Mesh, T_global: int):
    """The records (ids, occ), each (max_depth + 1, n_pix), of this rank's
    window, traced around the ring."""
    H, W = config.height, config.width
    P = rows_per_device(H, mesh.size) * W
    lo, hi = rank_rows(H, mesh)
    n_pix = (hi - lo) * W
    dev = mesh.device
    o = torch.zeros((P, 3), dtype=C.DTYPE, device=dev)
    d = torch.zeros((P, 3), dtype=C.DTYPE, device=dev)
    if n_pix:
        # the kernel's camera rays (what its mode 0 makes)
        o[:n_pix], d[:n_pix] = TV._camera_rays(res.packed, config, lo * W, n_pix)
    alive = torch.arange(P, device=dev) < n_pix
    ids_list, occ_list = [], []
    for depth in range(config.max_depth + 1):
        ids = torch.full((P,), -1, dtype=torch.int32, device=dev)
        occ = torch.zeros((P,), dtype=torch.int32, device=dev)
        if depth == 0 or any_over_ranks(bool(alive.any()), mesh):
            fl, it = _ring_closest(res, config, mesh, o, d, alive, T_global)
            ids = it[:, 0]
            hit = ids >= 0
            if config.shadows and any_over_ranks(bool(hit.any()), mesh):
                occ = _ring_shadows(res, config, mesh, fl[:, _P:_P + 3], fl[:, _POFF:_POFF + 3],
                                    hit)
            o = fl[:, _POFF:_POFF + 3].contiguous()
            d = fl[:, _REFL:_REFL + 3].contiguous()
            alive = hit & ((it[:, 1] & _REFLECTS) != 0)
        else:
            alive = torch.zeros_like(alive)
        ids_list.append(ids[:n_pix])
        occ_list.append(torch.where(ids >= 0, occ, 0)[:n_pix])
    return torch.stack(ids_list), torch.stack(occ_list)


def _ring_corners(res: _Resident, parts: ShardParts, mesh: Mesh):
    """The shading's corner_fn: the hit triangles' corner rows, fetched from
    the slices as they rotate around the ring (n masked gathers, n − 1
    rotations), bit-equal to the replicated gather."""
    t0s, cnts = parts.t0s.tolist(), parts.cnts.tolist()
    T = parts.t_max

    def corner_fn(prim, is_tri):
        pid = prim.reshape(-1).clamp(0, parts.T_global - 1).long()
        live = (is_tri & (prim >= 0)).reshape(-1)
        rows = res.corners.new_zeros((pid.shape[0], res.corners.shape[1]))
        slice_ = res.corners
        for s in range(mesh.size):
            src = (mesh.rank - s) % mesh.size      # the slice resident after s steps
            loc = pid - t0s[src]
            m = (loc >= 0) & (loc < cnts[src])
            g = gather_rows(slice_, loc.clamp(0, T - 1), live & m)
            rows = torch.where(m[:, None], g, rows)
            if s < mesh.size - 1:
                slice_ = _RingShift.apply(slice_, mesh)
        return rows.reshape(*prim.shape, 3, res.corners.shape[1] // 3)

    return corner_fn


def ring_records(scene2, config: RenderConfig, parts: ShardParts, mesh: Mesh):
    """The records (ids, occ) of this rank's window, (max_depth + 1,
    n_pix) each, as the ring traces them: they equal the replicated
    ``traversal.records_rows`` of the same rows."""
    _check(scene2, parts, mesh)
    return _ring_records(_resident(scene2, parts, mesh), config, mesh, parts.T_global)


def _check(scene2, parts: ShardParts, mesh: Mesh) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh={mesh!r}: a tpurt_torch.dist.shard.Mesh (make_mesh)")
    if parts.n != mesh.size:
        raise ValueError(f"the parts cut {parts.n} shards for a mesh of {mesh.size} ranks")
    if scene2.n_tris != parts.T_global:
        raise ValueError(f"the scene has {scene2.n_tris} triangles, the parts "
                         f"{parts.T_global}: pass the scene prepare_scene_sharded returned")
    if scene2.vertices.device != mesh.device:
        raise ValueError(f"the scene is on {scene2.vertices.device}, the mesh's rank "
                         f"{mesh.rank} renders on {mesh.device}")


def render_scene_sharded_prepared(scene2, config: RenderConfig, parts: ShardParts,
                                  mesh: Mesh):
    """Ring render of a prepared (renumbered) scene → the whole (H, W, 3)
    image on every rank, differentiable with respect to scene2.  Every rank
    calls it with the same scene2, config and parts; each traces and shades
    its own rows."""
    _check(scene2, parts, mesh)
    res = _resident(scene2, parts, mesh)
    ids, occ = _ring_records(res, config, mesh, parts.T_global)
    H, W = config.height, config.width
    lo, hi = rank_rows(H, mesh)
    o, d = geom.generate_rays(scene2.camera, H, W, lo, hi - lo)
    colors = shade_from_records(scene2, o.reshape(-1, 3), d.reshape(-1, 3),
                                records_from_ids(ids, occ, parts.T_global), config.max_depth,
                                config.shadows, corner_fn=_ring_corners(res, parts, mesh))
    return _GatherRows.apply(colors.reshape(hi - lo, W, 3), mesh, H)


def render_scene_sharded(scene, config: RenderConfig, tri_ids, mesh: Mesh):
    """Render with the image, the clusters and the shading rows sharded over
    `mesh`.  `tri_ids` is the (C, LEAF) cluster topology of a clusters plan.
    The scene is renumbered into cluster-major order first (the same image
    up to exact-t ties between different triangles); under a train loop call
    `prepare_scene_sharded` once and `render_scene_sharded_prepared` each
    step."""
    scene2, parts = prepare_scene_sharded(scene, tri_ids, mesh.size)
    return render_scene_sharded_prepared(scene2, config, parts, mesh)
