"""Phase-1 forward megakernel: wrapper, plain version and autograd entry
(the forward half of ``tpurt/kernels/megakernel.py``).

The hand-written CUDA kernel is ``csrc/megakernel_fwd.cu``; it replaces the
TPU kernel ``tpurt/kernels/megakernel.py:_fwd_kernel``.  Per pixel it
generates the camera ray, finds the closest hit over every triangle and
sphere (lowest index wins, triangles before spheres), shades with Phong and
one shadow ray per light, and follows the Whitted reflection loop.

``tile_color_reference`` is the same function in plain vectorised PyTorch,
op for op in the kernel's order.  A tensor on the CPU goes to it; a tensor
on a card goes to the kernel, or the call raises.

Outputs, for n_pix flat pixels from flat offset `off` of an H×W image:
colour (3, n_pix) f32 in [0, 1] and occ (max_depth + 1, n_pix) i32, where bit
l of occ[d, i] is set when light l is blocked from the point pixel i shades
at depth d.  A path with no shaded point at depth d (it missed, or ended at a
surface that does not reflect) has every light bit set when shadows are on:
the TPU kernel records the same for a miss, whose light distance overflows
to inf.
"""
from __future__ import annotations

import torch

from tpurt_torch import constants as C
from tpurt_torch.kernels import pack as PK
from tpurt_torch.kernels.pack import PackedScene, pack_scene

_F32_MAX_PRIMS = 4096  # phase-1 limit per primitive type (megakernel.py:62)
MAX_LIGHTS = 31        # one occlusion bit per light in an int32 record

#: launches since reset_launches(): the CUDA kernel, and the plain version
launches = {"megakernel_fwd": 0, "tile_color_reference": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# the plain version: vec3s are tuples of (n,) tensors, every op in the
# kernel's order, so that on a card both round alike
# ---------------------------------------------------------------------------
def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _neg(a):
    return (-a[0], -a[1], -a[2])


def _where(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _normalize(a):
    return _scale(a, torch.rsqrt(_dot(a, a) + C.NORMALIZE_EPS))


def _reflect(d, n):
    return _sub(d, _scale(n, 2.0 * _dot(d, n)))


def _form_o(f, o):
    """(n, P) values of forms f (P, 4) at points o: f.xyz·o + f.w."""
    return f[:, 0] * o[0][:, None] + f[:, 1] * o[1][:, None] \
        + f[:, 2] * o[2][:, None] + f[:, 3]


def _form_d(f, d):
    """(n, P) values of forms f (P, 4) at directions d: f.xyz·d."""
    return f[:, 0] * d[0][:, None] + f[:, 1] * d[1][:, None] \
        + f[:, 2] * d[2][:, None]


def _tri_t(packed, o, d):
    """(t, u, v), each (n, T); t = T_NONE where the triangle is missed."""
    tf = packed.tri_forms
    no = _form_o(tf[:, 0], o)
    ndd = _form_d(tf[:, 0], d)
    good = ndd.abs() >= C.MT_DET_EPS
    t = -no / torch.where(good, ndd, 1.0)
    u = _form_o(tf[:, 1], o) + t * _form_d(tf[:, 1], d)
    v = _form_o(tf[:, 2], o) + t * _form_d(tf[:, 2], d)
    hit = (good & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > C.T_MIN) & (t < C.T_MAX))
    return torch.where(hit, t, C.T_NONE), u, v


def _sph_t(packed, o, d):
    """(n, S) nearest root in range; T_NONE where the sphere is missed."""
    sf = packed.sph_forms
    b = _dot(o, d)[:, None] - _form_d(sf[:, 1], d)
    cterm = _dot(o, o)[:, None] + _form_o(sf[:, 0], o)
    disc = b * b - cterm
    has = disc > 0.0
    sq = torch.sqrt(torch.where(has, disc, 1.0))
    t0 = -b - sq
    t1 = -b + sq
    t0_ok = has & (t0 > C.T_MIN) & (t0 < C.T_MAX)
    t1_ok = has & (t1 > C.T_MIN) & (t1 < C.T_MAX)
    return torch.where(t0_ok, t0, torch.where(t1_ok, t1, C.T_NONE))


def _closest(packed, o, d):
    """(t, u, v, idx): idx is the attrs row of the winner (triangle i, or
    T + sphere j); the lowest index wins a tie, triangles before spheres."""
    tm, u, v = _tri_t(packed, o, d)
    tri_t, tri_i = tm.min(1)        # first index among equal minima
    u = u.gather(1, tri_i[:, None])[:, 0]
    v = v.gather(1, tri_i[:, None])[:, 0]
    sph_t, sph_i = _sph_t(packed, o, d).min(1)
    imp = sph_t < tri_t
    return (torch.where(imp, sph_t, tri_t),
            torch.where(imp, 0.0, u),
            torch.where(imp, 0.0, v),
            torch.where(imp, packed.n_tris + sph_i, tri_i))


def _occluded(packed, o, d, tmax):
    tm, _, _ = _tri_t(packed, o, d)
    occ = (tm < tmax[:, None]).any(1)
    return occ | (_sph_t(packed, o, d) < tmax[:, None]).any(1)


def _trace_chunk(packed, height, width, max_depth, shadows, pix0, n):
    g = packed.globals
    dev = g.device
    L = packed.n_lights

    def g3(k):
        return (g[k], g[k + 1], g[k + 2])

    pix = pix0 + torch.arange(n, device=dev)
    row = torch.div(pix, width, rounding_mode="floor").to(C.DTYPE)
    col = (pix % width).to(C.DTYPE)
    # divide by device tensors: on a card PyTorch turns division by a Python
    # number into a product with its reciprocal, which rounds otherwise
    w_f, h_f = (torch.full((), float(x), device=dev) for x in (width, height))
    sx = (2.0 * (col + 0.5) / w_f - 1.0) * (width / height)
    sy = 1.0 - 2.0 * (row + 0.5) / h_f
    ambient = g3(12)
    d = _normalize(_add(g3(3), _add(_scale(g3(6), sx), _scale(g3(9), sy))))
    o = tuple(e.expand(n) for e in g3(0))

    full = (1 << L) - 1 if shadows else 0
    zero = torch.zeros(n, dtype=C.DTYPE, device=dev)
    accum = (zero, zero, zero)
    thr = zero + 1.0
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    occs = []
    for _ in range(max_depth + 1):
        t, u, v, idx = _closest(packed, o, d)
        hit = t < C.T_MAX
        a = packed.attrs[idx]

        def a3(k):
            return (a[:, k], a[:, k + 1], a[:, k + 2])

        p = _add(o, _scale(d, t))
        w = 1.0 - u - v
        n_int = _normalize(_add(_scale(a3(PK.A_N0), w),
                                _add(_scale(a3(PK.A_N1), u),
                                     _scale(a3(PK.A_N2), v))))
        n_tri = _where(_dot(n_int, d) > 0.0, _neg(n_int), n_int)  # two-sided
        n_sph = _normalize(_sub(p, a3(PK.A_CENTER)))               # not flipped
        nrm = _where(idx < packed.n_tris, n_tri, n_sph)
        ka, kd, ks = a3(PK.A_KA), a3(PK.A_KD), a3(PK.A_KS)
        shin = a[:, PK.A_SHIN]

        color = tuple(ka[c] * ambient[c] for c in range(3))
        view = _neg(d)
        p_off = _add(p, _scale(nrm, C.RAY_OFFSET_EPS))
        bits = torch.zeros(n, dtype=torch.int32, device=dev)
        for li in range(L):
            lpos = g3(PK.NGLOB_BASE + 3 * li)
            lcol = g3(PK.NGLOB_BASE + 3 * L + 3 * li)
            to_l = _sub(lpos, p)
            dist = torch.sqrt(_dot(to_l, to_l))
            ldir = _scale(to_l, 1.0 / dist.clamp_min(1e-20))
            ndotl = _dot(nrm, ldir).clamp_min(0.0)
            rdotv = _dot(_reflect(_neg(ldir), nrm), view).clamp_min(0.0)
            safe_rv = torch.where(rdotv > 0.0, rdotv, 1.0)
            spec = torch.where((ndotl > 0.0) & (rdotv > 0.0), safe_rv ** shin, 0.0)
            vis = torch.ones_like(ndotl)
            if shadows:
                occ = _occluded(packed, p_off, ldir, dist - C.RAY_OFFSET_EPS)
                bits = bits | (occ.to(torch.int32) << li)
                vis = torch.where(occ, 0.0, 1.0)
            color = tuple(color[c] + vis * lcol[c] * (kd[c] * ndotl + ks[c] * spec)
                          for c in range(3))

        occs.append(torch.where(alive & hit, bits, full))
        accum = tuple(
            torch.where(alive, accum[c] + thr * torch.where(hit, color[c], C.BACKGROUND[c]),
                        accum[c])
            for c in range(3))
        refl = torch.where(hit, a[:, PK.A_REFL], 0.0)
        thr = thr * refl
        alive = alive & hit & (refl > 0.0)
        o, d = p_off, _reflect(d, nrm)
    colour = torch.stack(accum).clamp(C.CLAMP_LO, C.CLAMP_HI)
    return colour, torch.stack(occs)


def _check_limits(packed: PackedScene, off: int, n_pix: int) -> None:
    if packed.n_lights > MAX_LIGHTS:
        raise ValueError(f"{packed.n_lights} lights: the occlusion record "
                         f"holds at most {MAX_LIGHTS}")
    if off < 0 or n_pix < 1 or off + n_pix >= 2 ** 31:
        raise ValueError(f"pixels [{off}, {off + n_pix}) must be a nonempty "
                         "range of int32 offsets")


def tile_color_reference(packed: PackedScene, cfg, off: int, n_pix: int):
    """Plain PyTorch version of the kernel, on any device, chunked over
    pixels so that the (pixels × primitives) intermediates stay near 16 MB
    each.  Returns (colour (3, n_pix) f32, occ (max_depth + 1, n_pix) i32)."""
    _check_limits(packed, off, n_pix)
    launches["tile_color_reference"] += 1
    chunk = max(1024, (1 << 22) // (packed.n_tris + packed.n_spheres))
    parts = [
        _trace_chunk(packed, cfg.height, cfg.width, cfg.max_depth, cfg.shadows,
                     off + s, min(chunk, n_pix - s))
        for s in range(0, n_pix, chunk)
    ]
    return torch.cat([c for c, _ in parts], 1), torch.cat([o for _, o in parts], 1)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------
def megakernel_fwd_cuda(packed: PackedScene, cfg, off: int, n_pix: int):
    """Launch csrc/megakernel_fwd.cu on the current stream of the packed
    tensors' card.  Same contract as tile_color_reference."""
    from tpurt_torch.kernels import build

    _check_limits(packed, off, n_pix)
    T, S, L = packed.n_tris, packed.n_spheres, packed.n_lights
    args = {
        "tri_forms": (packed.tri_forms, (T, 3, 4)),
        "sph_forms": (packed.sph_forms, (S, 2, 4)),
        "attrs": (packed.attrs, (T + S, PK.ACOLS)),
        "globals": (packed.globals, (PK.NGLOB_BASE + 6 * L,)),
    }
    dev = packed.globals.device
    for name, (t, shape) in args.items():
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = build.load()
    colour = torch.empty((3, n_pix), dtype=torch.float32, device=dev)
    occ = torch.empty((cfg.max_depth + 1, n_pix), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpurt_megakernel_fwd(
            packed.tri_forms.data_ptr(), packed.sph_forms.data_ptr(),
            packed.attrs.data_ptr(), packed.globals.data_ptr(),
            colour.data_ptr(), occ.data_ptr(),
            T, S, L, cfg.height, cfg.width, cfg.width / cfg.height,
            cfg.max_depth, int(cfg.shadows), off, n_pix, stream,
        )
    build.check(err, "megakernel_fwd launch")
    launches["megakernel_fwd"] += 1
    return colour, occ


class _Forward(torch.autograd.Function):
    """The forward as an autograd node, so scene tensors that require grad
    flow in; its backward is the next kernel to port."""

    @staticmethod
    def forward(ctx, tri_forms, sph_forms, attrs, glob, cfg, off, n_pix):
        packed = PackedScene(tri_forms, sph_forms, attrs, glob)
        dev = glob.device
        if dev.type == "cpu":
            colour, occ = tile_color_reference(packed, cfg, off, n_pix)
        elif dev.type == "cuda":
            colour, occ = megakernel_fwd_cuda(packed, cfg, off, n_pix)
        else:
            raise ValueError(f"the phase-1 forward runs on cpu or cuda, not {dev}")
        ctx.mark_non_differentiable(occ)
        return colour, occ

    @staticmethod
    def backward(ctx, g_colour, g_occ):
        raise NotImplementedError(
            "the phase-1 backward is not ported yet: its kernels are "
            "tpurt/kernels/megakernel.py:_bwd_kernel and "
            "tpurt/kernels/megabwd.py:_hand_kernel (ROADMAP.md, Queue 2)"
        )


def fused_forward(packed: PackedScene, cfg, off: int, n_pix: int):
    """(colour (3, n_pix), occ (max_depth + 1, n_pix)) for flat pixels
    [off, off + n_pix) of the cfg.height × cfg.width image."""
    return _Forward.apply(packed.tri_forms.contiguous(),
                          packed.sph_forms.contiguous(),
                          packed.attrs.contiguous(),
                          packed.globals.contiguous(), cfg, off, n_pix)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def supports(scene, config) -> bool:
    """Phase-1 applicability: at most 4096 primitives of each type, no
    textures."""
    return (
        scene.n_tris <= _F32_MAX_PRIMS
        and scene.n_spheres <= _F32_MAX_PRIMS
        and not scene.textured
    )


def render_rows_fused(scene, config, row0: int, nrows: int):
    """Rows [row0, row0 + nrows) of the image, (nrows, W, 3) f32."""
    packed = pack_scene(scene)
    W = config.width
    colour, _ = fused_forward(packed, config, int(row0) * W, nrows * W)
    return colour.reshape(3, nrows, W).permute(1, 2, 0)


def render_fused(scene, config):
    return render_rows_fused(scene, config, 0, config.height)
