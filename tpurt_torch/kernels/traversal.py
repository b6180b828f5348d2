"""Cluster traversal: the kernel's wrappers, their plain versions and the
clustered render path (the counterpart of ``tpurt/kernels/traversal.py``).

``csrc/traversal.cu`` replaces the three modes of the TPU kernel
``tpurt/kernels/traversal.py:_trav_kernel``:

* ``trace_records`` (mode 0): camera rays of a slab of pixels; per depth the
  closest hit over the resident spheres and every cluster, the shading
  normal and the offset point in the kernel, one any-hit per light, and the
  reflection continuation.
* ``trace_bounce`` (mode 1): one depth of the same over an explicit ray set.
* ``trace_shadows`` (mode 2): any-hit to every light from given hit points.

What they return is the RECORDS CONTRACT, which the plain versions
(``*_reference``, brute force over every triangle slot and sphere in the
kernel's arithmetic) state exactly:

* ids: the global id of the closest hit in (T_MIN, T_MAX): triangle id, or
  n_tris + sphere index.  At equal t the smaller id wins everywhere (the TPU
  kernel breaks ties inside one block by lane; pad slots repeat a cluster's
  first triangle and never change the winner).
* a lane is live at depth d only if every earlier depth hit a reflective
  material; dead and missing lanes get id -1, occ 0, t T_NONE.
* occ: bit l is set when light l is blocked: the shadow ray starts at
  p_off = p + eps·n, points along (light - p) / dist with dist measured
  from p, and is tested in (T_MIN, dist - eps).
* ids, occ and tbest come back in IMAGE order, (D, n_pix) for a slab of
  rows (the TPU kernel writes tile-major; there is no ``_untile`` here), or
  (N,) in the order of the given rays.

A tensor on the CPU goes to the plain version; a tensor on a card goes to
the kernel, or the call raises.  Not carried over, because they answer the
TPU's lack of per-lane control flow: the interval cull of a ray tile, the
survivor lists and entry-distance buckets, the DMA pipeline and their
tunables.  ``traversal_stats`` returns the port's own counts (STAT_NAMES).
"""
from __future__ import annotations

import torch

from tpurt_torch import constants as C
from tpurt_torch.core import geom
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels import pack as PK
from tpurt_torch.kernels import packc as PC
from tpurt_torch.kernels.packc import PackedClusters, pack_clusters
from tpurt_torch.shading.deferred import records_from_ids, shade_from_records

#: the re-binned shadow pass runs above this many clusters (tpurt's gate)
SHADOW_REBIN_MIN_CLUSTERS = 2048
#: per-thread traversal stack entries in csrc/traversal.cu (shared memory)
MAX_STACK = 32
#: groups of GROUP slots a cluster may have in csrc/traversal.cu
MAX_GROUPS = 8
#: what a counting launch returns, (6,) int64 in this order: box tests of the
#: upper level, clusters entered, group box tests, triangle tests, sphere
#: tests, rays traced
STAT_NAMES = ("nodes", "clusters", "group_tests", "tri_tests", "sph_tests", "rays")
#: (rays × slots) elements a plain version holds at a time
_REF_ELEMS = 1 << 24

#: launches since reset_launches(): each mode of the kernel, each plain version
launches = {
    "trace_records": 0, "trace_bounce": 0, "trace_shadows": 0,
    "trace_records_reference": 0, "trace_bounce_reference": 0,
    "trace_shadows_reference": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# the plain versions: brute force, the kernel's arithmetic op for op (vec3s
# are tuples of (n,) tensors as in megakernel.py)
# ---------------------------------------------------------------------------
def _cols(x):
    return (x[:, 0], x[:, 1], x[:, 2])


def _ray_chunks(packed, n):
    step = max(1, _REF_ELEMS // max(packed.n_slots, 1))
    return [(s, min(step, n - s)) for s in range(0, n, step)]


def _closest_chunk(packed, o, d):
    """(t, u, v, attribute rows (n, TROWS)) of the nearest hit; among equal t
    the smallest global id."""
    tm, u, v = MK._tri_t(packed, o, d)
    t = tm.min(1).values
    gids = packed.tri_attrs[:, PC.R_GID]
    slot = torch.where(tm == t[:, None], gids[None, :], float("inf")).argmin(1)
    u = u.gather(1, slot[:, None])[:, 0]
    v = v.gather(1, slot[:, None])[:, 0]
    a = packed.tri_attrs[slot]
    if packed.n_spheres:
        t_sph, j = MK._sph_t(packed, o, d).min(1)   # first index: smallest id
        imp = t_sph < t                             # a triangle wins a tie
        t = torch.where(imp, t_sph, t)
        u = torch.where(imp, 0.0, u)
        v = torch.where(imp, 0.0, v)
        a = torch.where(imp[:, None], packed.sph_attrs[j], a)
    return t, u, v, a


def _occluded_chunk(packed, o, d, tmax):
    tm, _, _ = MK._tri_t(packed, o, d)
    occ = (tm < tmax[:, None]).any(1)
    if packed.n_spheres:
        occ = occ | (MK._sph_t(packed, o, d) < tmax[:, None]).any(1)
    return occ


def _over_chunks(packed, fn, *rays):
    """fn over ray chunks; rays are (n, k) or (n,) tensors, outputs are
    concatenated field by field."""
    chunks = _ray_chunks(packed, rays[0].shape[0]) or [(0, 0)]
    parts = [fn(*(r[s:s + m] for r in rays)) for s, m in chunks]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(f) for f in zip(*parts))
    return torch.cat(parts)


def _shadow_bits(packed, p, p_off, passes):
    """Occlusion bits of points p (3-tuple) with offset origins p_off."""
    g = packed.globals
    bits = torch.zeros_like(p[0], dtype=torch.int32)
    P = torch.stack(p_off, 1)
    for li in range(packed.n_lights):
        to_l = MK._sub(MK._g3(g, PK.NGLOB_BASE + 3 * li), p)
        dist = torch.sqrt(MK._dot(to_l, to_l))
        ldir = MK._scale(to_l, 1.0 / MK.max_pass(dist, 1e-20))
        occ = _over_chunks(
            packed, lambda q, l, tm: _occluded_chunk(packed, _cols(q), _cols(l), tm),
            P, torch.stack(ldir, 1), dist - C.RAY_OFFSET_EPS)
        bits = bits | (occ.to(torch.int32) << li)
        passes.append(p[0].shape[0])
    return bits


def _continuation(packed, o3, d3, t, u, v, a):
    """(p, nrm, p_off, reflected direction), each a 3-tuple, at hits t, u, v
    of rays o3, d3 on the primitives whose attribute rows are `a`: the
    kernel's hit point, shading normal, offset point and reflection
    (csrc/traversal.cu), in its arithmetic."""
    def a3(k):
        return (a[:, k], a[:, k + 1], a[:, k + 2])

    p = MK._add(o3, MK._scale(d3, t))
    w = 1.0 - u - v
    n_int = MK._normalize(MK._add(MK._scale(a3(PC.R_N0), w),
                                  MK._add(MK._scale(a3(PC.R_N1), u),
                                          MK._scale(a3(PC.R_N2), v))))
    n_tri = MK._where(MK._dot(n_int, d3) > 0.0, MK._neg(n_int), n_int)
    n_sph = MK._normalize(MK._sub(p, a3(PC.R_CENTER)))
    nrm = MK._where(a[:, PC.R_GID] >= float(packed.n_tris), n_sph, n_tri)
    p_off = MK._add(p, MK._scale(nrm, C.RAY_OFFSET_EPS))
    return p, nrm, p_off, MK._reflect(d3, nrm)


def _records_reference(packed, o, d, alive, max_depth, shadows, passes):
    """ids, occ (int32) and tbest (f32), each (max_depth + 1, n), of rays
    o, d (n, 3) live where `alive`.  Appends the ray count of every pass
    (closest or shadow) to `passes`."""
    n = o.shape[0]
    dev = o.device
    D = max_depth + 1
    ids = torch.full((D, n), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros((D, n), dtype=torch.int32, device=dev)
    tb = torch.full((D, n), C.T_NONE, dtype=C.DTYPE, device=dev)
    lanes = torch.nonzero(alive)[:, 0]
    o, d = o[lanes], d[lanes]
    for depth in range(D):
        if lanes.numel() == 0:
            break
        t, u, v, a = _over_chunks(
            packed, lambda oc, dc: _closest_chunk(packed, _cols(oc), _cols(dc)), o, d)
        passes.append(lanes.numel())
        hit = t < C.T_MAX
        lanes, t, u, v, a, o, d = (x[hit] for x in (lanes, t, u, v, a, o, d))
        o3, d3 = _cols(o), _cols(d)
        gid = a[:, PC.R_GID]
        p, nrm, p_off, refl = _continuation(packed, o3, d3, t, u, v, a)

        ids[depth, lanes] = gid.round().to(torch.int32)
        tb[depth, lanes] = t
        if shadows:
            occ[depth, lanes] = _shadow_bits(packed, p, p_off, passes)
        keep = a[:, PC.R_REFL] > 0.0
        lanes = lanes[keep]
        o = torch.stack(p_off, 1)[keep]
        d = torch.stack(refl, 1)[keep]
    return ids, occ, tb


def _reference_stats(packed, passes, count):
    """What brute force does, in the kernel's columns: no box test, every
    cluster, slot and sphere for every ray of every pass."""
    if not count:
        return None
    rays = sum(passes)
    return torch.tensor([0, rays * packed.n_clusters, 0, rays * packed.n_slots,
                         rays * packed.n_spheres, rays], dtype=torch.int64,
                        device=packed.globals.device)


def box_entry_reference(boxes, o, d, tmax):
    """The kernel's box test (csrc/traversal.cu:box_entry) in its arithmetic:
    the distance at which rays o, d (n, 3) enter boxes (n, 2, 4) within
    [0, tmax] (n,), else +inf.  The slabs meet through fmin and fmax, which
    drop a NaN as fminf and fmaxf do (an axis-parallel ray on a slab's
    plane)."""
    inv = 1.0 / d
    t0 = (boxes[:, 0, :3] - o) * inv
    t1 = (boxes[:, 1, :3] - o) * inv
    near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
    zero = torch.zeros_like(tmax)
    tn = torch.fmax(torch.fmax(near[:, 0], near[:, 1]), torch.fmax(near[:, 2], zero))
    tf = torch.fmin(torch.fmin(far[:, 0], far[:, 1]), torch.fmin(far[:, 2], tmax))
    return torch.where(tn <= tf, tn, float("inf"))


def _camera_rays(packed, config, off, n_pix):
    o, d, _, _, _ = MK._raygen(packed.globals, config.height, config.width, off, n_pix)
    return torch.stack(o, 1), torch.stack(d, 1)


@torch.no_grad()
def trace_records_reference(packed: PackedClusters, config, row0, nrows,
                            max_depth=None, shadows=None, count=False):
    """Plain version of trace_records, on any device."""
    _check_limits(packed)
    launches["trace_records_reference"] += 1
    md = config.max_depth if max_depth is None else max_depth
    sh = config.shadows if shadows is None else shadows
    n_pix = nrows * config.width
    o, d = _camera_rays(packed, config, int(row0) * config.width, n_pix)
    alive = torch.ones(n_pix, dtype=torch.bool, device=o.device)
    passes = []
    ids, occ, tb = _records_reference(packed, o, d, alive, md, sh, passes)
    return ids, occ, tb, _reference_stats(packed, passes, count)


def _live(alive, n_live):
    if n_live is None:
        return alive
    return alive & (torch.arange(alive.shape[0], device=alive.device) < n_live)


@torch.no_grad()
def trace_bounce_reference(packed: PackedClusters, config, o, d, alive, n_live=None,
                           shadows=None, count=False):
    """Plain version of trace_bounce, on any device."""
    _check_limits(packed)
    launches["trace_bounce_reference"] += 1
    sh = config.shadows if shadows is None else shadows
    passes = []
    ids, occ, tb = _records_reference(packed, o, d, _live(alive, n_live), 0, sh, passes)
    return ids[0], occ[0], tb[0], _reference_stats(packed, passes, count)


@torch.no_grad()
def trace_shadows_reference(packed: PackedClusters, config, p, p_off, alive,
                            n_live=None, count=False):
    """Plain version of trace_shadows, on any device."""
    _check_limits(packed)
    launches["trace_shadows_reference"] += 1
    lanes = torch.nonzero(_live(alive, n_live))[:, 0]
    occ = torch.zeros(p.shape[0], dtype=torch.int32, device=p.device)
    passes = []
    occ[lanes] = _shadow_bits(packed, _cols(p[lanes]), _cols(p_off[lanes]), passes)
    return occ, _reference_stats(packed, passes, count)


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------
def _check_limits(packed: PackedClusters) -> None:
    if packed.n_lights > MK.MAX_LIGHTS:
        raise ValueError(f"{packed.n_lights} lights: the occlusion record "
                         f"holds at most {MK.MAX_LIGHTS}")
    if packed.stack > MAX_STACK:
        raise ValueError(
            f"the 4-wide upper level needs a stack of {packed.stack} entries: the "
            f"traversal kernel keeps {MAX_STACK} a thread")
    if packed.leaf > MAX_GROUPS * PC.GROUP:
        raise ValueError(f"clusters of {packed.leaf} slots: the traversal kernel takes "
                         f"up to {MAX_GROUPS} groups of {PC.GROUP}")


def _check_kernel_inputs(packed: PackedClusters, **rays):
    """Raise on what the kernel does not take; `rays` are name=(tensor,
    shape, dtype).  Returns the card."""
    _check_limits(packed)
    dev = packed.globals.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take tensors on a card, not on {dev}")
    n_cl, P, S = packed.n_clusters, packed.n_slots, packed.n_spheres
    N4 = packed.wide_children.shape[0]
    args = {
        "tri_forms": (packed.tri_forms, (n_cl * packed.leaf, 3, 4), torch.float32),
        "tri_attrs": (packed.tri_attrs, (P, PC.TROWS), torch.float32),
        "boxes": (packed.boxes, (2 * n_cl - 1, 2, 4), torch.float32),
        "wide_boxes": (packed.wide_boxes, (N4, 4, 2, 4), torch.float32),
        "wide_children": (packed.wide_children, (N4, 4), torch.int32),
        "group_boxes": (packed.group_boxes, (n_cl * packed.leaf // PC.GROUP, 2, 4),
                        torch.float32),
        "sph_forms": (packed.sph_forms, (S, 2, 4), torch.float32),
        "sph_attrs": (packed.sph_attrs, (S, PC.TROWS), torch.float32),
        "globals": (packed.globals, (PK.NGLOB_BASE + 6 * packed.n_lights,), torch.float32),
        **rays,
    }
    for name, (t, shape, dtype) in args.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        # the kernel reads the packed tables as float4, the rays float by float
        if not t.is_contiguous() or (name not in rays and t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return dev


def _cluster_args(packed: PackedClusters):
    return (packed.tri_forms.data_ptr(), packed.tri_attrs.data_ptr(),
            packed.boxes.data_ptr(), packed.wide_boxes.data_ptr(),
            packed.wide_children.data_ptr(), packed.group_boxes.data_ptr(),
            packed.sph_forms.data_ptr(), packed.sph_attrs.data_ptr(),
            packed.globals.data_ptr(), packed.n_clusters, packed.leaf,
            packed.n_spheres, packed.n_lights, packed.n_tris)


def _stats_buffer(count, dev):
    """(tensor or None, pointer): the zeroed counters of a counting launch."""
    if not count:
        return None, 0
    stats = torch.zeros(len(STAT_NAMES), dtype=torch.int64, device=dev)
    return stats, stats.data_ptr()


def _launch(dev, name, fn, *args):
    from tpurt_torch.kernels import build

    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"{name} launch")
    launches[name] += 1


def trace_records_cuda(packed: PackedClusters, config, row0, nrows,
                       max_depth=None, shadows=None, count=False):
    """Launch mode 0 of csrc/traversal.cu on the current stream of the packed
    tensors' card.  Same contract as trace_records_reference."""
    from tpurt_torch.kernels import build

    dev = _check_kernel_inputs(packed)
    md = config.max_depth if max_depth is None else max_depth
    sh = config.shadows if shadows is None else shadows
    W = config.width
    off, n_pix = int(row0) * W, nrows * W
    if off < 0 or n_pix < 1 or off + n_pix >= 2 ** 31:
        raise ValueError(f"pixels [{off}, {off + n_pix}) must be a nonempty "
                         "range of int32 offsets")
    D = md + 1
    ids = torch.empty((D, n_pix), dtype=torch.int32, device=dev)
    occ = torch.empty((D, n_pix), dtype=torch.int32, device=dev)
    tb = torch.empty((D, n_pix), dtype=torch.float32, device=dev)
    stats, stats_ptr = _stats_buffer(count, dev)
    _launch(dev, "trace_records", build.load().tpurt_trace_records,
            *_cluster_args(packed), ids.data_ptr(), occ.data_ptr(), tb.data_ptr(),
            stats_ptr, config.height, W, W / config.height, md, int(sh), off, n_pix)
    return ids, occ, tb, stats


def trace_bounce_cuda(packed: PackedClusters, config, o, d, alive, n_live=None,
                      shadows=None, count=False):
    """Launch mode 1 of csrc/traversal.cu.  Same contract as
    trace_bounce_reference."""
    from tpurt_torch.kernels import build

    N = o.shape[0]
    dev = _check_kernel_inputs(
        packed, o=(o, (N, 3), torch.float32), d=(d, (N, 3), torch.float32),
        alive=(alive, (N,), torch.bool))
    sh = config.shadows if shadows is None else shadows
    ids = torch.empty((N,), dtype=torch.int32, device=dev)
    occ = torch.empty((N,), dtype=torch.int32, device=dev)
    tb = torch.empty((N,), dtype=torch.float32, device=dev)
    stats, stats_ptr = _stats_buffer(count, dev)
    if N:
        _launch(dev, "trace_bounce", build.load().tpurt_trace_bounce,
                *_cluster_args(packed), o.data_ptr(), d.data_ptr(), alive.data_ptr(),
                N if n_live is None else int(n_live), ids.data_ptr(), occ.data_ptr(),
                tb.data_ptr(), stats_ptr, int(sh), N)
    return ids, occ, tb, stats


def trace_shadows_cuda(packed: PackedClusters, config, p, p_off, alive,
                       n_live=None, count=False):
    """Launch mode 2 of csrc/traversal.cu.  Same contract as
    trace_shadows_reference."""
    from tpurt_torch.kernels import build

    N = p.shape[0]
    dev = _check_kernel_inputs(
        packed, p=(p, (N, 3), torch.float32), p_off=(p_off, (N, 3), torch.float32),
        alive=(alive, (N,), torch.bool))
    occ = torch.empty((N,), dtype=torch.int32, device=dev)
    stats, stats_ptr = _stats_buffer(count, dev)
    if N:
        _launch(dev, "trace_shadows", build.load().tpurt_trace_shadows,
                *_cluster_args(packed), p.data_ptr(), p_off.data_ptr(), alive.data_ptr(),
                N if n_live is None else int(n_live), occ.data_ptr(), stats_ptr, N)
    return occ, stats


def trace_records(packed: PackedClusters, config, row0, nrows: int,
                  max_depth: int | None = None, shadows: bool | None = None,
                  count: bool = False):
    """Records of rows [row0, row0 + nrows) → (ids, occ, tbest, stats), the
    first three (D, nrows·W) in image order, D = max_depth + 1.

    `max_depth` and `shadows` override the config's (the wavefront loop
    traces depth 0 here and later bounces through trace_bounce).  `stats` is
    None unless `count`: then the launch runs the counting instantiation of
    the kernel and returns (6,) int64 in the order of STAT_NAMES."""
    fn = MK._on(packed.globals.device, trace_records_reference, trace_records_cuda)
    return fn(packed, config, row0, nrows, max_depth, shadows, count)


def trace_bounce(packed: PackedClusters, config, o, d, alive, n_live=None,
                 shadows: bool | None = None, count: bool = False):
    """One depth over an explicit ray set: o, d (N, 3) f32 unit rays, alive
    (N,) bool; with `n_live` given, rays at index >= n_live are dead too.
    Returns (ids (N,), occ (N,), tbest (N,), stats) in the rays' order; dead
    rays get the defaults."""
    fn = MK._on(packed.globals.device, trace_bounce_reference, trace_bounce_cuda)
    return fn(packed, config, o, d, alive, n_live, shadows, count)


def trace_shadows(packed: PackedClusters, config, p, p_off, alive, n_live=None,
                  count: bool = False):
    """Occlusion bits for all lights over explicit hit points p and offset
    origins p_off, each (N, 3) f32.  Returns (occ (N,) int32, stats); ray
    construction and band match the in-kernel shadows of trace_records."""
    fn = MK._on(packed.globals.device, trace_shadows_reference, trace_shadows_cuda)
    return fn(packed, config, p, p_off, alive, n_live, count)


# ---------------------------------------------------------------------------
# the wavefront loop and the clustered render path
# ---------------------------------------------------------------------------
def _part1by2(x):
    """Spread the low 10 bits of x so consecutive bits land 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton(p, lo, hi, cells):
    q = ((p - lo) / (hi - lo).clamp_min(1e-12)).clamp(0.0, 1.0)
    cell = (q * cells).to(torch.int32)
    return (_part1by2(cell[:, 0]) | (_part1by2(cell[:, 1]) << 1)
            | (_part1by2(cell[:, 2]) << 2))


def _bin_key_pts(p, lo, hi, alive):
    """Morton key of a 3D point (no direction bits): the shadow pass bins
    hit points into compact cells.  Dead lanes sort to the end."""
    return torch.where(alive, _morton(p, lo, hi, 1023.0), 2 ** 30)


def _bin_key(p, d, lo, hi, alive):
    """Wavefront binning key: direction octant (high bits) then 9-bit-per-
    axis Morton code of the ray origin, so that the rays of a warp start
    near each other and point the same way.  Dead rays sort to the end."""
    octant = (((d[:, 0] < 0).to(torch.int32) << 2)
              | ((d[:, 1] < 0).to(torch.int32) << 1)
              | (d[:, 2] < 0).to(torch.int32))
    return torch.where(alive, (octant << 27) | _morton(p, lo, hi, 511.0), 2 ** 30)


def _lane_o(f, o):
    """Forms f (n, 4) at points o (3-tuple of (n,)), lane by lane: the
    arithmetic of MK._form_o."""
    return f[:, 0] * o[0] + f[:, 1] * o[1] + f[:, 2] * o[2] + f[:, 3]


def _lane_d(f, d):
    return f[:, 0] * d[0] + f[:, 1] * d[1] + f[:, 2] * d[2]


def _hit_rows(packed, o3, d3, ids):
    """(t, u, v, attribute rows) of rays o3, d3 at the primitives they hit
    (ids >= 0), recomputed from the packed forms in the arithmetic of
    MK._tri_t and MK._sph_t, so they equal the kernel's own.  A triangle in
    several slots has the same forms in each."""
    T = packed.n_tris
    slot_of = torch.zeros(T, dtype=torch.long, device=ids.device)
    slot_of[packed.tri_attrs[:, PC.R_GID].long()] = torch.arange(
        packed.n_slots, device=ids.device)
    is_tri = ids < T
    slot = slot_of[ids.clamp(0, T - 1).long()]
    f = packed.tri_forms[slot]
    ndd = _lane_d(f[:, 0], d3)
    t = -_lane_o(f[:, 0], o3) / torch.where(ndd.abs() >= C.MT_DET_EPS, ndd, 1.0)
    u = _lane_o(f[:, 1], o3) + t * _lane_d(f[:, 1], d3)
    v = _lane_o(f[:, 2], o3) + t * _lane_d(f[:, 2], d3)
    a = packed.tri_attrs[slot]
    if packed.n_spheres:
        sph = (ids.long() - T).clamp(0, packed.n_spheres - 1)
        sf = packed.sph_forms[sph]
        b = MK._dot(o3, d3) - _lane_d(sf[:, 1], d3)
        disc = b * b - (MK._dot(o3, o3) + _lane_o(sf[:, 0], o3))
        has = disc > 0.0
        sq = torch.sqrt(torch.where(has, disc, 1.0))
        t0 = -b - sq
        t0_ok = has & (t0 > C.T_MIN) & (t0 < C.T_MAX)
        t = torch.where(is_tri, t, torch.where(t0_ok, t0, -b + sq))
        u = torch.where(is_tri, u, 0.0)
        v = torch.where(is_tri, v, 0.0)
        a = torch.where(is_tri[:, None], a, packed.sph_attrs[sph])
    return t, u, v, a


def _continue_rays(packed, o, d, ids):
    """Reflection continuation from a bounce's records → (o2, d2, alive, p),
    o2 the offset point: what the kernel's multi-bounce launch computes
    between depths (_continuation), so the wavefront loop's rays are its
    rays."""
    o3, d3 = _cols(o), _cols(d)
    t, u, v, a = _hit_rows(packed, o3, d3, ids)
    p, _, p_off, refl = _continuation(packed, o3, d3, t, u, v, a)
    alive = (ids >= 0) & (a[:, PC.R_REFL] > 0.0)
    return torch.stack(p_off, 1), torch.stack(refl, 1), alive, torch.stack(p, 1)


def _unsort(x, perm):
    out = torch.empty_like(x)
    out[perm] = x
    return out


@torch.no_grad()
def _wavefront_records(scene, config, packed, row0, nrows):
    """Per-bounce wavefront tracing → (ids, occ), each (D, n_pix): depth 0
    generates camera rays in the kernel; each later bounce sorts its live
    rays by direction octant and origin Morton code, traces them in one
    launch and scatters the records back to pixel order.  One device-to-host
    sync per depth beyond the first (the count of live rays)."""
    W = config.width
    T = scene.n_tris
    # above the gate, shadows are traced in a separate launch over hit points
    # sorted by Morton code instead of inside the closest-hit launch
    rebin = (config.shadows and config.shadow_rebin
             and packed.n_clusters > SHADOW_REBIN_MIN_CLUSTERS)
    in_kernel = config.shadows and not rebin

    ids0, occ0, _, _ = trace_records(packed, config, row0, nrows, max_depth=0,
                                     shadows=in_kernel)
    ids_list = [ids0[0]]

    # scene bounds for the Morton quantization
    lo = packed.aabb_lo.amin(0)
    hi = packed.aabb_hi.amax(0)

    # the kernel's camera rays, so that every continuation is the kernel's
    n_pix = nrows * W
    o, d = _camera_rays(packed, config, int(row0) * W, n_pix)

    def shadow_occ(o_cur, d_cur, ids):
        """Occlusion bits for one bounce's hits through the re-binned shadow
        launch, from the kernel's hit points (_continue_rays)."""
        p_off, _, _, p = _continue_rays(packed, o_cur, d_cur, ids)
        alive = ids >= 0
        perm = torch.argsort(_bin_key_pts(p, lo, hi, alive), stable=True)
        occ, _ = trace_shadows(packed, config, p[perm].contiguous(),
                               p_off[perm].contiguous(), alive[perm])
        return torch.where(alive, _unsort(occ, perm), 0)

    occ_list = [shadow_occ(o, d, ids_list[0]) if rebin else occ0[0]]

    def alive_from_ids(ids):
        """Which lanes continue to the next bounce, from ids alone (two int
        gathers instead of the hit-geometry recompute): a path survives iff
        it hit and the hit material reflects."""
        tid = ids.clamp(0, max(T - 1, 0)).long()
        sid = (ids - T).clamp(0, max(scene.n_spheres - 1, 0)).long()
        mat = torch.where(ids < T, scene.tri_mat[tid], scene.sph_mat[sid]).long()
        return (ids >= 0) & (scene.materials.reflectivity[mat] > 0.0)

    for _depth in range(1, config.max_depth + 1):
        alive = alive_from_ids(ids_list[-1])
        n_live = int(alive.sum())
        if n_live == 0:
            # skip the recompute, the sort and the launch; every later bounce
            # is empty too, since alive only ever shrinks
            idsb = torch.full((n_pix,), -1, dtype=torch.int32, device=o.device)
            occb = torch.zeros((n_pix,), dtype=torch.int32, device=o.device)
        else:
            o, d, _, _ = _continue_rays(packed, o, d, ids_list[-1])
            perm = torch.argsort(_bin_key(o, d, lo, hi, alive), stable=True)
            idsb, occb, _, _ = trace_bounce(
                packed, config, o[perm].contiguous(), d[perm].contiguous(),
                alive[perm], n_live, shadows=in_kernel)
            idsb, occb = _unsort(idsb, perm), _unsort(occb, perm)
            if rebin:
                occb = shadow_occ(o, d, idsb)
        ids_list.append(idsb)
        occ_list.append(occb)

    return torch.stack(ids_list), torch.stack(occ_list)


def records_rows(scene, config, packed, row0, nrows: int):
    """The records (ids, occ), each (max_depth + 1, nrows·W), of rows
    [row0, row0 + nrows): the wavefront loop, or with config.wavefront off
    (or at depth 0) the single multi-bounce launch."""
    if config.wavefront and config.max_depth > 0:
        return _wavefront_records(scene, config, packed, row0, nrows)
    ids, occ, _, _ = trace_records(packed, config, row0, nrows)
    return ids, occ


def render_rows_clustered(scene, config, tri_ids, row0, nrows: int, tree=None):
    """Cluster-traversal render of rows [row0, row0 + nrows): the traversal
    kernel finds topology, deferred shading reconstructs the image under
    autograd.  `tree` is the plan's frozen upper level.

    config.wavefront selects per-bounce re-binned tracing (default) or the
    single multi-bounce launch (secondary rays keep their pixel's thread)."""
    packed = pack_clusters(scene, tri_ids, tree)
    W = config.width
    ids, occ = records_rows(scene, config, packed, row0, nrows)
    recs = records_from_ids(ids, occ, scene.n_tris)
    o, d = geom.generate_rays(scene.camera, config.height, W, row0, nrows)
    colors = shade_from_records(scene, o.reshape(-1, 3), d.reshape(-1, 3), recs,
                                config.max_depth, config.shadows)
    return colors.reshape(nrows, W, 3)


def traversal_stats(scene, config, tri_ids, row0=0, nrows=None, tree=None):
    """What one trace_records launch over these rows does, (6,) int64 in the
    order of STAT_NAMES: box tests of the upper level, clusters entered,
    group box tests, triangle tests, sphere tests, rays (closest and shadow)
    traced.  The operation counts of the kernel's bound are computed from
    these."""
    nrows = config.height if nrows is None else nrows
    packed = pack_clusters(scene, tri_ids, tree)
    return trace_records(packed, config, row0, nrows, count=True)[3]
