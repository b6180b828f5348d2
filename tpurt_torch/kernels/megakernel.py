"""Phase-1 megakernels: wrappers, plain versions and autograd entries (the
counterpart of ``tpurt/kernels/megakernel.py``).

Three hand-written CUDA kernels are bound here:

* ``csrc/megakernel_fwd.cu`` (``megakernel_fwd_cuda``) replaces the TPU kernel
  ``tpurt/kernels/megakernel.py:_fwd_kernel``.  Per pixel it generates the
  camera ray, finds the closest hit over every triangle and sphere (lowest
  index wins, triangles before spheres), shades with Phong and one shadow ray
  per light, and follows the Whitted reflection loop.
* ``csrc/megakernel_bwd.cu`` (``megakernel_bwd_cuda``) replaces ``_bwd_kernel``:
  it replays the forward at the recorded occlusion bits, without shadow rays,
  and returns the summed cotangents of the four packed tensors for an image
  cotangent ``g``.
* the same source's fused entry (``l2_fused_cuda``) replaces ``_fused_kernel``:
  forward with shadow rays, the L2 error and its seed, and the replay's
  cotangents, in one launch.

The fourth kernel of the train step, the hand-derived adjoint that keeps its
residuals, lives in ``megabwd.py``.

``tile_color_reference`` is the forward in plain vectorised PyTorch, op for
op in the kernel's order; ``tile_color_vjp_reference`` and
``l2_fused_reference`` are PyTorch autograd through it.  Where the kernels'
body (``csrc/phase1_math.cuh``) writes out an FMA, the plain version computes
the same fused operation exactly (``_fma``), through the ``_p1_`` helpers;
the unfused helpers (``_tri_t``, ``_sph_t``, ``_raygen``, ``_dot``,
``_form_o``, ``_normalize``) are the traversal kernels' arithmetic
(``traversal.py``).  A tensor on the CPU
goes to the plain versions; a tensor on a card goes to the kernel, or the
call raises.

Subgradients at ties follow the hand-derived adjoint in every kernel and
every plain version (see ``megabwd.py``): the clip to [0, 1] passes the whole
seed on the closed interval, ``max(x, 0)`` passes nothing at ``x == 0``.

Forward outputs, for n_pix flat pixels from flat offset `off` of an H×W image:
colour (3, n_pix) f32 in [0, 1] and occ (max_depth + 1, n_pix) i32, where bit
l of occ[d, i] is set when light l is blocked from the point pixel i shades
at depth d.  A path with no shaded point at depth d (it missed, or ended at a
surface that does not reflect) has every light bit set when shadows are on:
the TPU kernel records the same for a miss, whose light distance overflows
to inf.  Cotangents come back as a PackedScene of the packed tensors' shapes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tpurt_torch import constants as C
from tpurt_torch import trace
from tpurt_torch.kernels import pack as PK
from tpurt_torch.kernels.pack import PackedScene, pack_scene
from tpurt_torch.trace import span

_F32_MAX_PRIMS = 4096  # phase-1 limit per primitive type (megakernel.py:62)
MAX_LIGHTS = 31        # one occlusion bit per light in an int32 record

#: launches since reset_launches(): each CUDA kernel, and each plain version
launches = {
    "megakernel_fwd": 0, "megakernel_bwd": 0, "l2_fused": 0, "l2_hand": 0,
    "tile_color_reference": 0, "tile_color_vjp_reference": 0,
    "l2_fused_reference": 0, "l2_hand_reference": 0,
}


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


# ---------------------------------------------------------------------------
# the phase-1 body's arithmetic (csrc/phase1_math.cuh): a * b + c rounded
# once, as the kernels' __fmaf_rn
# ---------------------------------------------------------------------------
def _fma_f32(a, b, c):
    """a·b + c of float32 tensors, rounded once to float32 (round to nearest,
    ties to even).  The product of two floats is exact in float64; TwoSum
    gives the sum's float64 rounding s and its error e exactly; rounding to
    odd (s, or its neighbour toward e, whichever has an odd last bit)
    then keeps the float32 rounding of the float64 value the rounding of the
    exact a·b + c (Boldo and Melquiond: 53 ≥ 2·24 + 2 bits)."""
    a, b, c = (x.to(torch.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    c_part = s - p
    p_part = s - c_part
    e = (p - p_part) + (c - c_part)
    odd = (s.view(torch.int64) & 1) == 1
    inf = torch.full_like(s, float("inf"))
    toward = torch.nextafter(s, torch.where(e > 0, inf, -inf))
    exact = (e == 0) | odd | ~torch.isfinite(s)
    return torch.where(exact, s, toward).to(torch.float32)


class _FMA(torch.autograd.Function):
    """_fma_f32 under autograd, with the gradient of a·b + c."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.shapes = (a.shape, b.shape, c.shape)
        return _fma_f32(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        sa, sb, sc = ctx.shapes
        need = ctx.needs_input_grad
        return ((g * b).sum_to_size(sa) if need[0] else None,
                (g * a).sum_to_size(sb) if need[1] else None,
                g.sum_to_size(sc) if need[2] else None)


def _fma(a, b, c):
    """a·b + c rounded once, as __fmaf_rn; Python numbers are float32
    constants, as in the kernel."""
    like = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (x if isinstance(x, torch.Tensor)
               else torch.tensor(x, dtype=C.DTYPE, device=like.device) for x in (a, b, c))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (a, b, c)):
        return _FMA.apply(a, b, c)
    return _fma_f32(a, b, c)


def _p1_dot(a, b):
    """a·b = fma(a.z, b.z, fma(a.y, b.y, a.x·b.x))."""
    return _fma(a[2], b[2], _fma(a[1], b[1], a[0] * b[0]))


def _p1_row_o(f, o):
    """Value of forms f (..., 4) at points o: fma(f.z, o.z, fma(f.y, o.y,
    fma(f.x, o.x, f.w))); o's components broadcast against f's columns."""
    return _fma(f[..., 2], o[2], _fma(f[..., 1], o[1], _fma(f[..., 0], o[0], f[..., 3])))


def _p1_row_d(f, d):
    """Value of forms f (..., 4) at directions d: _p1_dot(f.xyz, d)."""
    return _p1_dot((f[..., 0], f[..., 1], f[..., 2]), d)


def _p1_form_o(f, o):
    """(n, P) values of forms f (P, 4) at points o."""
    return _p1_row_o(f, tuple(x[:, None] for x in o))


def _p1_form_d(f, d):
    """(n, P) values of forms f (P, 4) at directions d."""
    return _p1_row_d(f, tuple(x[:, None] for x in d))


def _p1_axpy(a, b, s):
    """a + b·s, each component fma(b, s, a)."""
    return tuple(_fma(b[k], s, a[k]) for k in range(3))


def _p1_normalize(a):
    """a·rsqrt(fma(a.z, a.z, fma(a.y, a.y, fma(a.x, a.x, eps))))."""
    sq = _fma(a[2], a[2], _fma(a[1], a[1], _fma(a[0], a[0], C.NORMALIZE_EPS)))
    return _scale(a, torch.rsqrt(sq))


def _p1_reflect(d, n):
    """d − n·(2 d·n) = _p1_axpy(d, n, −2 d·n)."""
    return _p1_axpy(d, n, -2.0 * _p1_dot(d, n))


def _p1_interp(n0, n1, n2, w, u, v):
    """n0·w + n1·u + n2·v = fma(n0, w, fma(n1, u, n2·v))."""
    return tuple(_fma(n0[k], w, _fma(n1[k], u, n2[k] * v)) for k in range(3))


def _p1_pow(x, y):
    """x^y for the specular term: exp2(y·log2(x)), as the kernels' p1_pow."""
    return torch.exp2(y * torch.log2(x))


def _p1_tri_t(packed, o, d):
    """(t, u, v), each (n, T), in the phase-1 body's arithmetic; t = T_NONE
    where the triangle is missed.  The kernel's early rejections
    (phase1_math.cuh:p1_tri_t) miss exactly where this does."""
    tf = packed.tri_forms
    no = _p1_form_o(tf[:, 0], o)
    ndd = _p1_form_d(tf[:, 0], d)
    good = ndd.abs() >= C.MT_DET_EPS
    t = -no / torch.where(good, ndd, 1.0)
    u = _fma(t, _p1_form_d(tf[:, 1], d), _p1_form_o(tf[:, 1], o))
    v = _fma(t, _p1_form_d(tf[:, 2], d), _p1_form_o(tf[:, 2], o))
    hit = (good & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > C.T_MIN) & (t < C.T_MAX))
    return torch.where(hit, t, C.T_NONE), u, v


def _p1_sph_terms(fc, fd, o, d, oo, od):
    """(b, c) of the quadratic t² + 2bt + c of spheres with forms fc, fd,
    from o·o and o·d: b = o·d − fd·d, c = o·o + fc(o)."""
    return od - _p1_row_d(fd, d), oo + _p1_row_o(fc, o)


def _p1_sph_t(packed, o, d, with_first=False):
    """(n, S) nearest root in range in the phase-1 body's arithmetic;
    T_NONE where the sphere is missed.  With `with_first` also (n, S) bool:
    the root is -b - sqrt(disc) (the kernels' `first`)."""
    sf = packed.sph_forms
    col = tuple(x[:, None] for x in o), tuple(x[:, None] for x in d)
    b, cterm = _p1_sph_terms(sf[:, 0], sf[:, 1], *col,
                             _p1_dot(o, o)[:, None], _p1_dot(o, d)[:, None])
    disc = _fma(b, b, -cterm)
    has = disc > 0.0
    sq = torch.sqrt(torch.where(has, disc, 1.0))
    t0 = -b - sq
    t1 = -b + sq
    t0_ok = has & (t0 > C.T_MIN) & (t0 < C.T_MAX)
    t1_ok = has & (t1 > C.T_MIN) & (t1 < C.T_MAX)
    t = torch.where(t0_ok, t0, torch.where(t1_ok, t1, C.T_NONE))
    return (t, t0_ok) if with_first else t


def _p1_sph_quadratic(fc, fd, a, o, d):
    """(b, disc) of the quadratic t² + 2bt + c of rays (o, d) against the
    spheres of form rows fc, fd (n, 4) and attrs rows `a` (n, ACOLS), as the
    kernels' p1_sph_quadratic: from the forms (_p1_sph_terms), or from
    o − c (b = oc·d, l = fma(d, −b, oc), disc = fma(r, r, −l·l)) where
    that rounds less: where r·(r + 4·|oc|₁) is below the forms' summands,
    b² + o·o + |fc.x·o.x| + |fc.y·o.y| + |fc.z·o.z| + |fc.w|."""
    oo, od = _p1_dot(o, o), _p1_dot(o, d)
    bf, cterm = _p1_sph_terms(fc, fd, o, d, oo, od)
    err_f = bf * bf + oo + (fc[:, 0] * o[0]).abs() + (fc[:, 1] * o[1]).abs() \
        + (fc[:, 2] * o[2]).abs() + fc[:, 3].abs()
    oc = _sub(o, tuple(a[:, PK.A_CENTER + k] for k in range(3)))
    r = a[:, PK.A_RADIUS]
    err_l = r * (r + 4.0 * (oc[0].abs() + oc[1].abs() + oc[2].abs()))
    b = _p1_dot(oc, d)
    l = _p1_axpy(oc, d, -b)
    local = err_l < err_f
    return (torch.where(local, b, bf),
            torch.where(local, _fma(r, r, -_p1_dot(l, l)), _fma(bf, bf, -cterm)))


class _SphereRoot(torch.autograd.Function):
    """t of winning spheres, as the kernels' p1_sph_root: −b − sqrt(disc)
    where `first`, else −b + sqrt(disc) (a disc below 0 taken as 0), with b
    and disc from _p1_sph_quadratic; its backward is the kernels' adjoint of the
    forms' root at those b and disc: cotangents into the winners' form rows
    fc, fd (n, 4) and into o, d."""

    @staticmethod
    def forward(ctx, fc, fd, o0, o1, o2, d0, d1, d2, b, disc, first):
        ctx.save_for_backward(fc, fd, o0, o1, o2, d0, d1, d2, b, disc, first)
        sq = torch.sqrt(torch.where(disc > 0.0, disc, 0.0))
        return torch.where(first, -b - sq, -b + sq)

    @staticmethod
    def backward(ctx, cot_t):
        fc, fd, o0, o1, o2, d0, d1, d2, b, disc, first = ctx.saved_tensors
        o, d = (o0, o1, o2), (d0, d1, d2)
        has = disc > 0.0
        sqv = torch.sqrt(torch.where(has, disc, 1.0))
        cot_sq = torch.where(first, -cot_t, cot_t)
        cot_disc = torch.where(has, cot_sq / (2.0 * sqv), 0.0)
        cot_b = -cot_t + 2.0 * b * cot_disc   # also the cotangent of o·d
        cot_ct = -cot_disc                    # also the cotangent of o·o
        cot_cd = -cot_b
        g_fc = torch.stack([cot_ct * o[k] for k in range(3)] + [cot_ct], 1)
        g_fd = torch.stack([cot_cd * d[k] for k in range(3)] + [torch.zeros_like(cot_cd)], 1)
        g_o = tuple(2.0 * o[k] * cot_ct + d[k] * cot_b + fc[:, k] * cot_ct for k in range(3))
        g_d = tuple(o[k] * cot_b + fd[:, k] * cot_cd for k in range(3))
        return (g_fc, g_fd, *g_o, *g_d, None, None, None)


def max_pass(x, lo=0.0):
    """max(x, lo) whose gradient passes only where x > lo: nothing at the tie."""
    return torch.where(x > lo, x, lo)


def clip_mask(accum):
    """Where the clip to [CLAMP_LO, CLAMP_HI] passes a cotangent: the closed
    interval, so a value exactly on a bound passes the whole seed."""
    return (accum >= C.CLAMP_LO) & (accum <= C.CLAMP_HI)


def clip_pass(accum):
    """The clip, with the gradient of clip_mask."""
    return torch.where(clip_mask(accum), accum,
                       accum.detach().clamp(C.CLAMP_LO, C.CLAMP_HI))


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
    T + sphere j); the lowest index wins a tie, triangles before spheres.
    The phase-1 body's arithmetic: the forms pick the winner and a sphere's
    root, and a winning sphere's t is that root again from the better
    rounded of two ways to write its quadratic (_SphereRoot)."""
    tm, u, v = _p1_tri_t(packed, o, d)
    tri_t, tri_i = tm.min(1)        # first index among equal minima
    u = u.gather(1, tri_i[:, None])[:, 0]
    v = v.gather(1, tri_i[:, None])[:, 0]
    with torch.no_grad():
        sph_all, first_all = _p1_sph_t(packed, o, d, with_first=True)
        sph_t, sph_i = sph_all.min(1)
        first = first_all.gather(1, sph_i[:, None])[:, 0]
        b, disc = _p1_sph_quadratic(*packed.sph_forms[sph_i].unbind(1),
                                    packed.attrs[packed.n_tris + sph_i], o, d)
    t_sph = _SphereRoot.apply(*packed.sph_forms[sph_i].unbind(1), *o, *d, b, disc, first)
    imp = sph_t < tri_t
    return (torch.where(imp, t_sph, tri_t),
            torch.where(imp, 0.0, u),
            torch.where(imp, 0.0, v),
            torch.where(imp, packed.n_tris + sph_i, tri_i))


def _occluded(packed, o, d, tmax):
    occ = (_p1_sph_t(packed, o, d) < tmax[:, None]).any(1)
    tm, _, _ = _p1_tri_t(packed, o, d)
    return occ | (tm < tmax[:, None]).any(1)


def _g3(g, k):
    return (g[k], g[k + 1], g[k + 2])


def _pixel_coords(g, height, width, pix0, n):
    """(sx, sy) of flat pixels [pix0, pix0 + n) on the image plane."""
    dev = g.device
    pix = pix0 + torch.arange(n, device=dev)
    row = torch.div(pix, width, rounding_mode="floor").to(C.DTYPE)
    col = (pix % width).to(C.DTYPE)
    # divide by device tensors: on a card PyTorch turns division by a Python
    # number into a product with its reciprocal, which rounds otherwise
    w_f, h_f = (torch.full((), float(x), device=dev) for x in (width, height))
    sx = (2.0 * (col + 0.5) / w_f - 1.0) * (width / height)
    sy = 1.0 - 2.0 * (row + 0.5) / h_f
    return sx, sy


def _raygen(g, height, width, pix0, n):
    """Camera rays of flat pixels [pix0, pix0 + n): (o, d, graw, sx, sy) with
    d = normalize(graw), graw = fwd + right·sx + up·sy."""
    sx, sy = _pixel_coords(g, height, width, pix0, n)
    graw = _add(_g3(g, 3), _add(_scale(_g3(g, 6), sx), _scale(_g3(g, 9), sy)))
    o = tuple(e.expand(n) for e in _g3(g, 0))
    return o, _normalize(graw), graw, sx, sy


def _p1_raygen(g, height, width, pix0, n):
    """_raygen in the phase-1 body's arithmetic: graw = fma(right, sx,
    fma(up, sy, fwd)), d = _p1_normalize(graw)."""
    sx, sy = _pixel_coords(g, height, width, pix0, n)
    graw = _p1_axpy(_p1_axpy(_g3(g, 3), _g3(g, 9), sy), _g3(g, 6), sx)
    o = tuple(e.expand(n) for e in _g3(g, 0))
    return o, _p1_normalize(graw), graw, sx, sy


def _light_terms(nrm, p, view, lpos, shin):
    """One light's forward terms at points p with normals nrm seen along
    view (phase1_math.cuh:light_terms): a dict of to_l, dist2, dist, inv,
    ldir, raw_nl, ndotl, refl_l, raw_rv, rdotv, safe_rv, specmask, spec."""
    to_l = _sub(lpos, p)
    dist2 = _p1_dot(to_l, to_l)
    dist = torch.sqrt(dist2)
    inv = 1.0 / max_pass(dist, 1e-20)
    ldir = _scale(to_l, inv)
    raw_nl = _p1_dot(nrm, ldir)
    ndotl = max_pass(raw_nl)
    refl_l = _p1_reflect(_neg(ldir), nrm)
    raw_rv = _p1_dot(refl_l, view)
    rdotv = max_pass(raw_rv)
    safe_rv = torch.where(rdotv > 0.0, rdotv, 1.0)
    specmask = (ndotl > 0.0) & (rdotv > 0.0)
    spec = torch.where(specmask, _p1_pow(safe_rv, shin), 0.0)
    return dict(to_l=to_l, dist2=dist2, dist=dist, inv=inv, ldir=ldir, raw_nl=raw_nl,
                ndotl=ndotl, refl_l=refl_l, raw_rv=raw_rv, rdotv=rdotv, safe_rv=safe_rv,
                specmask=specmask, spec=spec)


def _shade(packed, shadows, o, d, t, u, v, idx, rec=None):
    """Phong colour of the points o + t·d on primitive rows idx, with one
    shadow test per light, or with visibility read from the occlusion record
    `rec` (n,) i32 and no test.  Returns (colour 3-tuple, occ bits (n,) i32,
    offset point, normal, attribute rows)."""
    g = packed.globals
    L = packed.n_lights
    a = packed.attrs[idx]

    def a3(k):
        return (a[:, k], a[:, k + 1], a[:, k + 2])

    p = _p1_axpy(o, d, t)
    n_int = _p1_normalize(_p1_interp(a3(PK.A_N0), a3(PK.A_N1), a3(PK.A_N2), 1.0 - u - v, u, v))
    n_tri = _where(_p1_dot(n_int, d) > 0.0, _neg(n_int), n_int)  # two-sided
    n_sph = _p1_normalize(_sub(p, a3(PK.A_CENTER)))               # not flipped
    nrm = _where(idx < packed.n_tris, n_tri, n_sph)
    ka, kd, ks = a3(PK.A_KA), a3(PK.A_KD), a3(PK.A_KS)
    shin = a[:, PK.A_SHIN]
    ambient = _g3(g, 12)

    color = tuple(ka[c] * ambient[c] for c in range(3))
    view = _neg(d)
    p_off = _p1_axpy(p, nrm, C.RAY_OFFSET_EPS)
    bits = torch.zeros_like(idx, dtype=torch.int32) if rec is None else rec
    for li in range(L):
        lcol = _g3(g, PK.NGLOB_BASE + 3 * L + 3 * li)
        lt = _light_terms(nrm, p, view, _g3(g, PK.NGLOB_BASE + 3 * li), shin)
        vis = torch.ones_like(lt["ndotl"])
        if shadows and rec is not None:
            vis = 1.0 - ((rec >> li) & 1).to(C.DTYPE)
        elif shadows:
            occ = _occluded(packed, p_off, lt["ldir"], lt["dist"] - C.RAY_OFFSET_EPS)
            bits = bits | (occ.to(torch.int32) << li)
            vis = torch.where(occ, 0.0, 1.0)
        color = tuple(_fma(vis * lcol[c], _phong(kd[c], ks[c], lt), color[c]) for c in range(3))
    return color, bits, p_off, nrm, a


def _phong(kd, ks, lt):
    """One channel's Phong sum kd·ndotl + ks·spec = fma(kd, ndotl, ks·spec)."""
    return _fma(kd, lt["ndotl"], ks * lt["spec"])


def _accumulate(accum, alive, thr, hit, color):
    """accum + thr·colour (the background where the ray missed) on live
    paths: fma(thr, colour, accum)."""
    return tuple(
        torch.where(alive, _fma(thr, torch.where(hit, color[c], C.BACKGROUND[c]), accum[c]),
                    accum[c])
        for c in range(3))


def _trace_chunk(packed, height, width, max_depth, shadows, pix0, n, occ_rec=None):
    """Colour (3, n) and occ (max_depth + 1, n) of flat pixels [pix0, pix0 + n).
    With `occ_rec` (max_depth + 1, n) visibility comes from the records."""
    o, d, _, _, _ = _p1_raygen(packed.globals, height, width, pix0, n)
    dev = packed.globals.device
    full = (1 << packed.n_lights) - 1 if shadows else 0
    zero = torch.zeros(n, dtype=C.DTYPE, device=dev)
    accum = (zero, zero, zero)
    thr = zero + 1.0
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    occs = []
    for depth in range(max_depth + 1):
        t, u, v, idx = _closest(packed, o, d)
        hit = t < C.T_MAX
        color, bits, p_off, nrm, a = _shade(
            packed, shadows, o, d, t, u, v, idx,
            None if occ_rec is None else occ_rec[depth])
        occs.append(torch.where(alive & hit, bits, full))
        accum = _accumulate(accum, alive, thr, hit, color)
        refl = torch.where(hit, a[:, PK.A_REFL], 0.0)
        thr = thr * refl
        alive = alive & hit & (refl > 0.0)
        o, d = p_off, _p1_reflect(d, nrm)
    return torch.stack([clip_pass(x) for x in accum]), torch.stack(occs)


def _check_limits(packed: PackedScene, off: int, n_pix: int) -> None:
    if packed.n_lights > MAX_LIGHTS:
        raise ValueError(f"{packed.n_lights} lights: the occlusion record "
                         f"holds at most {MAX_LIGHTS}")
    if off < 0 or n_pix < 1 or off + n_pix >= 2 ** 31:
        raise ValueError(f"pixels [{off}, {off + n_pix}) must be a nonempty "
                         "range of int32 offsets")


def _chunks(packed: PackedScene, n_pix: int):
    """(start, length) pixel chunks that keep the (pixels × primitives)
    intermediates near 16 MB each."""
    chunk = max(1024, (1 << 22) // (packed.n_tris + packed.n_spheres))
    return [(s, min(chunk, n_pix - s)) for s in range(0, n_pix, chunk)]


def tile_color_reference(packed: PackedScene, cfg, off: int, n_pix: int,
                         occ_rec=None):
    """Plain PyTorch version of the forward kernel, on any device, chunked
    over pixels.  Returns (colour (3, n_pix) f32, occ (max_depth + 1, n_pix)
    i32).  With `occ_rec` (max_depth + 1, n_pix) i32 from an earlier forward,
    visibility comes from the records and no shadow test runs."""
    _check_limits(packed, off, n_pix)
    launches["tile_color_reference"] += 1
    parts = [
        _trace_chunk(packed, cfg.height, cfg.width, cfg.max_depth, cfg.shadows,
                     off + s, n, None if occ_rec is None else occ_rec[:, s:s + n])
        for s, n in _chunks(packed, n_pix)
    ]
    return torch.cat([c for c, _ in parts], 1), torch.cat([o for _, o in parts], 1)


def path_counts(packed: PackedScene, cfg, off: int, n_pix: int) -> dict:
    """What the paths of these pixels need, counted by the plain forward:
    per-depth lists `rays` (closest-hit passes: paths alive on entry),
    `shaded_tri` and `shaded_sph` (shaded points by the winner's type) and
    `blocked` (shadow rays that found an occluder; each shaded point sends
    one shadow ray per light when cfg.shadows).  For operation counts."""
    _check_limits(packed, off, n_pix)
    D = cfg.max_depth + 1
    out = {k: [0] * D for k in ("rays", "shaded_tri", "shaded_sph", "blocked")}
    with torch.no_grad():
        for s, n in _chunks(packed, n_pix):
            o, d, _, _, _ = _p1_raygen(packed.globals, cfg.height, cfg.width, off + s, n)
            alive = torch.ones(n, dtype=torch.bool, device=packed.globals.device)
            for depth in range(D):
                t, u, v, idx = _closest(packed, o, d)
                shaded = alive & (t < C.T_MAX)
                _, bits, p_off, nrm, a = _shade(packed, cfg.shadows, o, d, t, u, v, idx)
                n_bits = sum(((bits >> li) & 1) for li in range(packed.n_lights))
                out["rays"][depth] += int(alive.sum())
                out["shaded_tri"][depth] += int((shaded & (idx < packed.n_tris)).sum())
                out["shaded_sph"][depth] += int((shaded & (idx >= packed.n_tris)).sum())
                out["blocked"][depth] += int(torch.where(shaded, n_bits, 0).sum())
                alive = shaded & (a[:, PK.A_REFL] > 0.0)
                o, d = p_off, _p1_reflect(d, nrm)
    return out


def _replay_cotangents(packed, cfg, off, n_pix, occ_rec, seed_of):
    """Σ over pixels of the vjp of the forward at the packed tensors: autograd
    through _trace_chunk on detached leaves, one backward a chunk so that
    memory stays bounded.  `seed_of(colour (3, n), start)` gives the chunk's
    image cotangent."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (packed.tri_forms, packed.sph_forms, packed.attrs, packed.globals)]
    leaf_scene = PackedScene(*leaves)
    with torch.enable_grad():
        for s, n in _chunks(packed, n_pix):
            colour, _ = _trace_chunk(
                leaf_scene, cfg.height, cfg.width, cfg.max_depth, cfg.shadows,
                off + s, n, None if occ_rec is None else occ_rec[:, s:s + n])
            colour.backward(seed_of(colour.detach(), s))
    return PackedScene(*(torch.zeros_like(t) if t.grad is None else t.grad
                         for t in leaves))


def tile_color_vjp_reference(packed: PackedScene, cfg, off: int, n_pix: int,
                             occ, g):
    """Plain version of the backward kernel: the cotangents of the packed
    tensors for the image cotangent g (3, n_pix), by replay at the occlusion
    records occ (max_depth + 1, n_pix) under autograd, which is what the TPU
    kernel is under jax.vjp."""
    _check_limits(packed, off, n_pix)
    launches["tile_color_vjp_reference"] += 1
    return _replay_cotangents(packed, cfg, off, n_pix, occ,
                              lambda colour, s: g[:, s:s + colour.shape[1]])


def l2_fused_reference(packed: PackedScene, cfg, off: int, n_pix: int, target):
    """Plain version of the fused L2 kernel: (sq (n_pix,) per-pixel squared
    error against target (3, n_pix), cotangents of the packed tensors for the
    seed 2·(colour − target)), shadow tests included."""
    _check_limits(packed, off, n_pix)
    launches["l2_fused_reference"] += 1
    sq = []

    def seed_of(colour, s):
        e = colour - target[:, s:s + colour.shape[1]]
        sq.append((e * e).sum(0))
        return 2.0 * e

    cot = _replay_cotangents(packed, cfg, off, n_pix, None, seed_of)
    return torch.cat(sq), cot


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------
def check_kernel_inputs(packed: PackedScene, off: int, n_pix: int, **pixel_rows):
    """Raise on what the kernels do not take: packed tensors must be float32,
    contiguous, 16-byte aligned, of the packed shapes and on one card; each of
    `pixel_rows` (name=(tensor, rows, dtype)) must be a contiguous
    (rows, n_pix) tensor on that card.  Returns the card."""
    _check_limits(packed, off, n_pix)
    T, S, L = packed.n_tris, packed.n_spheres, packed.n_lights
    dev = packed.globals.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take tensors on a card, not on {dev}")
    args = {
        "tri_forms": (packed.tri_forms, (T, 3, 4), torch.float32),
        "sph_forms": (packed.sph_forms, (S, 2, 4), torch.float32),
        "attrs": (packed.attrs, (T + S, PK.ACOLS), torch.float32),
        "globals": (packed.globals, (PK.NGLOB_BASE + 6 * L,), torch.float32),
    }
    for name, (t, rows, dtype) in pixel_rows.items():
        args[name] = (t, (rows, n_pix), dtype)
    for name, (t, shape, dtype) in args.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return dev


def _scene_args(packed: PackedScene):
    return (packed.tri_forms.data_ptr(), packed.sph_forms.data_ptr(),
            packed.attrs.data_ptr(), packed.globals.data_ptr(),
            packed.n_tris, packed.n_spheres, packed.n_lights)


def megakernel_fwd_cuda(packed: PackedScene, cfg, off: int, n_pix: int):
    """Launch csrc/megakernel_fwd.cu on the current stream of the packed
    tensors' card.  Same contract as tile_color_reference."""
    from tpurt_torch.kernels import build

    dev = check_kernel_inputs(packed, off, n_pix)
    lib = build.load()
    colour = torch.empty((3, n_pix), dtype=torch.float32, device=dev)
    occ = torch.empty((cfg.max_depth + 1, n_pix), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpurt_megakernel_fwd(
            *_scene_args(packed), colour.data_ptr(), occ.data_ptr(),
            cfg.height, cfg.width, cfg.width / cfg.height,
            cfg.max_depth, int(cfg.shadows), off, n_pix, stream,
        )
    build.check(err, "megakernel_fwd launch")
    launches["megakernel_fwd"] += 1
    return colour, occ


#: depths of residuals the backward kernels keep (MAX_DEPTHS in
#: csrc/megakernel_adjoint.cuh)
MAX_DEPTHS = 16
# the backward kernels' blocks and shared memory (csrc/megakernel_adjoint.cuh):
# 256 threads, at least MIN_BLOCKS of them an SM (their __launch_bounds__, so
# at most 128 registers); each warp's scratch of SCRATCH_ROWS rows of
# SCRATCH_PITCH floats; RES_WORDS words of residuals and one of occlusion
# bits a thread and depth
THREADS, WARPS, MIN_BLOCKS = 256, 8, 2
SCRATCH_ROWS, SCRATCH_PITCH, RES_WORDS = 16, 36, 11


def table_floats(packed: PackedScene) -> int:
    """Floats of the backward kernels' cotangent tables: globals, tri_forms,
    sph_forms and attrs, laid out in that order."""
    return sum(t.numel() for t in (packed.globals, packed.tri_forms, packed.sph_forms,
                                   packed.attrs))


def phase1_shared_bytes(n: int, depths: int, fixed: bool) -> int:
    """Dynamic shared memory of a backward kernel's block at `depths` depths:
    the warps' scratch, the residuals and occlusion bits, and where `fixed` a
    copy of n floats for each warp: the whole table on the shared-memory
    route, its globals on the records route (n = NGLOB_BASE + 6 L)."""
    return 4 * (WARPS * SCRATCH_ROWS * SCRATCH_PITCH + depths * THREADS * (RES_WORDS + 1)
                + (WARPS * n if fixed else 0))


def takes_fixed_order(n: int, depths: int, sm_bytes: int, block_bytes: int,
                      reserved: int) -> bool:
    """The route of an n-float table at `depths` depths: True for the
    shared-memory route (a copy of the table a warp, summed inside the
    kernel), False for the records route (the globals in the warps' copies,
    each winner's values a record summed by the sorted segment sum).  Both
    sum in a fixed order; the name is the first route's, from before the
    second had one.

    The card: `sm_bytes` of shared memory an SM, at most `block_bytes` a
    block, `reserved` bytes an SM keeps back for each block.  The copies may
    take what the blocks that an SM keeps leave: MIN_BLOCKS, or fewer where
    the residuals of many depths already allow fewer."""
    def per_sm(nbytes):
        return sm_bytes // (nbytes + reserved)

    with_copies = phase1_shared_bytes(n, depths, True)
    kept = min(MIN_BLOCKS, per_sm(phase1_shared_bytes(n, depths, False)))
    return with_copies <= block_bytes and per_sm(with_copies) >= kept


def fixed_order_limit(depths: int, sm_bytes: int, block_bytes: int, reserved: int) -> int:
    """The largest table (floats) that takes the shared-memory route at
    `depths` depths on this card's shared memory."""
    lo, hi = 0, block_bytes // (4 * WARPS) + 1  # takes_fixed_order(lo), not (hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if takes_fixed_order(mid, depths, sm_bytes, block_bytes,
                                                reserved) else (lo, mid)
    return lo


#: values of a winner's record (csrc/megakernel_adjoint.cuh: R_ALL)
RECORD_FLOATS = 32
#: scratch that one launch's records may take; a larger launch runs in slabs
#: of rows
RECORD_SCRATCH_LIMIT = 1 << 30


def records_bytes(n_pix: int, depths: int) -> int:
    """Scratch of the records route for n_pix pixels: a key and
    RECORD_FLOATS values for each pixel and depth."""
    return 4 * (RECORD_FLOATS + 1) * depths * n_pix


def slab_pixels(n_pix: int, width: int, depths: int, limit: int | None = None) -> int:
    """Pixels a launch of the records route takes at a time: all n_pix where
    their records fit in `limit` bytes (RECORD_SCRATCH_LIMIT), else as many
    whole rows of `width` pixels as fit (one at least)."""
    limit = RECORD_SCRATCH_LIMIT if limit is None else limit
    if records_bytes(n_pix, depths) <= limit:
        return n_pix
    return max(1, limit // records_bytes(width, depths)) * width


@functools.lru_cache(maxsize=None)
def record_map(n_tris: int, n_sph: int, n_lights: int, device):
    """(src, dst) int64 on card `device`: entry src of the flattened (T + S,
    RECORD_FLOATS) record sums belongs at index dst of the flat cotangent
    table [globals | tri_forms | sph_forms | attrs].  The addresses are the
    kernels' own (csrc/megakernel_adjoint.cuh:winner_addr, through the C
    entry tpurt_record_map); each dst appears once.  Built once for each
    scene's counts and card."""
    from tpurt_torch.kernels import build

    dst = torch.empty(((n_tris + n_sph) * RECORD_FLOATS,), dtype=torch.int32)
    width = build.load().tpurt_record_map(n_tris, n_sph, n_lights, dst.data_ptr())
    if width != RECORD_FLOATS:
        raise RuntimeError(f"the kernels' records hold {width} values, not {RECORD_FLOATS}")
    src = torch.nonzero(dst >= 0).reshape(-1)
    return src.to(device), dst[src].long().to(device)


def records_into(table, key_of, rec, n_tris: int, n_sph: int, n_lights: int):
    """Sum the records (key_of (M,) int32 winners, T + S where a slot holds
    none; rec (M, RECORD_FLOATS)) by winner with segsum_rows and write each
    sum at its index of the flat table (n,); the table's other entries stay
    as they are.  Returns the table."""
    from tpurt_torch.kernels.segsum import segsum_rows

    sums = segsum_rows(key_of, rec, n_tris + n_sph)
    src, dst = record_map(n_tris, n_sph, n_lights, table.device)
    return table.index_copy_(0, dst, sums.reshape(-1).index_select(0, src))


@functools.lru_cache(maxsize=None)
def _shared_limits(index: int):
    """(shared bytes an SM, the most a block may ask for, bytes an SM keeps
    back for each block) of card `index`."""
    from tpurt_torch.kernels import build

    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(index):
        build.check(build.load().tpurt_shared_limits(*map(ctypes.byref, vals)),
                    "shared memory query")
    return tuple(v.value for v in vals)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(kernel: str, index: int, n: int, depths: int, records: bool) -> int:
    """Blocks of `kernel` that an SM of card `index` holds at once with warp
    copies of n floats, on the records route or not
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    from tpurt_torch.kernels import build

    blocks = ctypes.c_int()
    with torch.cuda.device(index):
        query = getattr(build.load(), f"tpurt_{kernel}_occupancy")
        build.check(query(n, depths, int(records), ctypes.byref(blocks)),
                    f"{kernel} occupancy query")
    return blocks.value


class _Tables:
    """Scratch and outputs of one backward call of `kernel`.  n = globals +
    tri_forms + sph_forms + attrs, laid out in that order, in `out`.  Each
    persistent block writes the sum of its warps' copies as a row of
    `partials` (blocks, n_copy), which the reduce kernel adds in order: the
    whole table on the shared-memory route; on the records route
    (takes_fixed_order is False) the globals only, and the launch writes the
    winners' records into `key_of` and `rec`, which records_into sums and
    writes into the rest.  The records route runs in slabs of `slab` pixels
    (slab_pixels) and adds the slabs' tables in slab order.  The grid is as
    many blocks as the card holds at once, or one a 256 pixels where that is
    fewer."""

    def __init__(self, packed: PackedScene, cfg, n_pix: int, dev, kernel: str):
        T, S, L = packed.n_tris, packed.n_spheres, packed.n_lights
        self.counts = (T, S, L)
        self.sizes = (packed.globals.numel(), 12 * T, 8 * S, PK.ACOLS * (T + S))
        self.shapes = ((self.sizes[0],), (T, 3, 4), (S, 2, 4), (T + S, PK.ACOLS))
        n = table_floats(packed)
        depths = cfg.max_depth + 1
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        self.records = not takes_fixed_order(n, depths, *_shared_limits(index))
        n_copy = self.sizes[0] if self.records else n
        self.slab = slab_pixels(n_pix, cfg.width, depths) if self.records else n_pix
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        self.blocks = min(-(-min(n_pix, self.slab) // THREADS),
                          sms * _blocks_per_sm(kernel, index, n_copy, depths, self.records))
        self.partials = torch.empty((self.blocks, n_copy), dtype=torch.float32, device=dev)
        if self.records:
            self.key_of = torch.empty((depths * self.slab,), dtype=torch.int32, device=dev)
            self.rec = torch.empty((depths * self.slab, RECORD_FLOATS), dtype=torch.float32,
                                   device=dev)
            self.out = torch.zeros((n,), dtype=torch.float32, device=dev)
        else:
            self.out = torch.empty((n,), dtype=torch.float32, device=dev)
        self.depths = depths

    def slab_table(self, first: bool):
        """The table a slab's launch writes: `out` for the first slab, a
        zeroed table for each later one; the records' keys reset."""
        if self.records:
            self.key_of.fill_(sum(self.counts[:2]))
        return self.out if first else torch.zeros_like(self.out)

    def args(self, table):
        none = (None, None)
        return (self.partials.data_ptr(), table.data_ptr(), self.blocks, int(self.records),
                *((self.key_of.data_ptr(), self.rec.data_ptr()) if self.records else none))

    def finish(self, table, n_pix: int) -> None:
        """After a slab of n_pix pixels: its records into its table, and a
        later slab's table added to the first's."""
        if self.records:
            m = self.depths * n_pix
            records_into(table, self.key_of[:m], self.rec[:m], *self.counts)
        if table is not self.out:
            self.out += table

    def cotangents(self) -> PackedScene:
        glob, tri, sph, attrs = (
            t.view(shape) for t, shape in zip(self.out.split(self.sizes), self.shapes))
        return PackedScene(tri_forms=tri, sph_forms=sph, attrs=attrs, globals=glob)


def _check_depth(cfg) -> None:
    if cfg.max_depth + 1 > MAX_DEPTHS:
        raise ValueError(f"max_depth {cfg.max_depth}: the backward kernels keep "
                         f"at most {MAX_DEPTHS} depths of residuals a thread")


def launch_backward(kernel: str, packed: PackedScene, cfg, off: int, n_pix: int, dev,
                    pixel_rows, sq=None) -> PackedScene:
    """Launch the backward kernel `kernel` (megakernel_bwd, l2_fused or
    l2_hand) over pixels [off, off + n_pix) on the current stream of card
    `dev`, in slabs where the records route asks for them.  `pixel_rows`:
    its (rows, n_pix) inputs in the order of its C entry; `sq`: its (n_pix,)
    output or None.  Returns the cotangent tables."""
    from tpurt_torch.kernels import build

    fn = getattr(build.load(), f"tpurt_{kernel}")
    tables = _Tables(packed, cfg, n_pix, dev, kernel)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s0 in range(0, n_pix, tables.slab):
            m = min(tables.slab, n_pix - s0)
            ins = [t if m == n_pix else t[:, s0:s0 + m].contiguous() for t in pixel_rows]
            outs = [] if sq is None else [sq[s0:].data_ptr()]
            table = tables.slab_table(s0 == 0)
            err = fn(*_scene_args(packed), *(t.data_ptr() for t in ins), *outs,
                     *tables.args(table), cfg.height, cfg.width, cfg.width / cfg.height,
                     cfg.max_depth, int(cfg.shadows), off + s0, m, stream)
            build.check(err, f"{kernel} launch")
            tables.finish(table, m)
    return tables.cotangents()


def megakernel_bwd_cuda(packed: PackedScene, cfg, off: int, n_pix: int, occ, g):
    """Launch the replay backward of csrc/megakernel_bwd.cu.  Same contract as
    tile_color_vjp_reference."""
    _check_depth(cfg)
    dev = check_kernel_inputs(
        packed, off, n_pix,
        occ=(occ, cfg.max_depth + 1, torch.int32), g=(g, 3, torch.float32))
    cot = launch_backward("megakernel_bwd", packed, cfg, off, n_pix, dev, (occ, g))
    launches["megakernel_bwd"] += 1
    return cot


def l2_fused_cuda(packed: PackedScene, cfg, off: int, n_pix: int, target):
    """Launch the fused L2 entry of csrc/megakernel_bwd.cu.  Same contract as
    l2_fused_reference."""
    _check_depth(cfg)
    dev = check_kernel_inputs(packed, off, n_pix,
                              target=(target, 3, torch.float32))
    sq = torch.empty((n_pix,), dtype=torch.float32, device=dev)
    cot = launch_backward("l2_fused", packed, cfg, off, n_pix, dev, (target,), sq)
    launches["l2_fused"] += 1
    return sq, cot


def _on(dev, cpu_fn, cuda_fn):
    """The plain version for CPU tensors, the kernel for a card's."""
    if dev.type == "cpu":
        return cpu_fn
    if dev.type == "cuda":
        return cuda_fn
    raise ValueError(f"the phase-1 kernels run on cpu or cuda, not {dev}")


class _Forward(torch.autograd.Function):
    """The forward as an autograd node whose backward is the replay kernel:
    scene tensors that require grad flow in, and the cotangents of the four
    packed tensors flow out."""

    @staticmethod
    def forward(ctx, tri_forms, sph_forms, attrs, glob, cfg, off, n_pix):
        packed = PackedScene(tri_forms, sph_forms, attrs, glob)
        fwd = _on(glob.device, tile_color_reference, megakernel_fwd_cuda)
        colour, occ = fwd(packed, cfg, off, n_pix)
        ctx.save_for_backward(tri_forms, sph_forms, attrs, glob, occ)
        ctx.static = (cfg, off, n_pix)
        ctx.mark_non_differentiable(occ)
        return colour, occ

    @staticmethod
    def backward(ctx, g_colour, g_occ):
        *tensors, occ = ctx.saved_tensors
        packed = PackedScene(*tensors)
        cfg, off, n_pix = ctx.static
        bwd = _on(occ.device, tile_color_vjp_reference, megakernel_bwd_cuda)
        cot = bwd(packed, cfg, off, n_pix, occ, g_colour.contiguous())
        return cot.tri_forms, cot.sph_forms, cot.attrs, cot.globals, None, None, None


def fused_forward(packed: PackedScene, cfg, off: int, n_pix: int):
    """(colour (3, n_pix), occ (max_depth + 1, n_pix)) for flat pixels
    [off, off + n_pix) of the cfg.height × cfg.width image; differentiable
    with respect to the packed tensors."""
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


def _count_launch(packed: PackedScene, n_pix: int) -> None:
    """The counters of one phase-1 launch: its table's primitives and its
    pixels (they count only while a profiler records)."""
    trace.count("megakernel.prims", packed.n_tris + packed.n_spheres)
    trace.count("megakernel.pixels", n_pix)


def render_rows_fused(scene, config, row0: int, nrows: int):
    """Rows [row0, row0 + nrows) of the image, (nrows, W, 3) f32."""
    packed = pack_scene(scene)
    W = config.width
    with span("tpurt.megakernel"):
        _count_launch(packed, nrows * W)
        colour, _ = fused_forward(packed, config, int(row0) * W, nrows * W)
    return colour.reshape(3, nrows, W).permute(1, 2, 0)


def render_fused(scene, config):
    return render_rows_fused(scene, config, 0, config.height)


def scene_float_leaves(scene):
    """(path, tensor) of every floating-point leaf of a Scene, nested
    dataclasses included; path is a tuple of field names."""
    out = []
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            out.append(((f.name,), v))
        elif dataclasses.is_dataclass(v):
            out += [((f.name, *path), t) for path, t in scene_float_leaves(v)]
    return out


def scene_like(scene, values: dict, default=None):
    """A copy of `scene` whose tensor leaves are values[path], or `default(leaf)`
    where the path is missing (None for every such leaf when default is None)."""

    def build(obj, prefix):
        changes = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            path = (*prefix, f.name)
            if isinstance(v, torch.Tensor):
                changes[f.name] = values[path] if path in values else (
                    None if default is None else default(v))
            elif dataclasses.is_dataclass(v):
                changes[f.name] = build(v, path)
        return dataclasses.replace(obj, **changes)

    return build(scene, ())


def l2_loss_and_grad(scene, target, config, hand: bool = True):
    """Fused phase-1 train objective: ``sum((render(scene) − target)²)`` and
    its gradients with respect to every float scene leaf, in one kernel pass.

    `target` is (H, W, 3).  Returns (sum of squares, grads) where grads is a
    Scene of cotangents with None on integer leaves.  `hand=True` runs the
    hand-derived adjoint that keeps its residuals (megabwd.py), `hand=False`
    the fused forward-and-replay kernel; the two agree up to summation order.
    The kernel's cotangents of the packed tensors are chained into scene
    gradients through pack_scene by autograd."""
    if not supports(scene, config):
        raise ValueError("l2_loss_and_grad is the phase-1 fast path; "
                         "use render_and_grad for clustered scenes")
    from tpurt_torch.kernels import megabwd

    H, W = config.height, config.width
    n_pix = H * W
    paths, leaves = zip(*scene_float_leaves(scene))
    live = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        packed = pack_scene(scene_like(scene, dict(zip(paths, live)), default=lambda t: t))
    outs = (packed.tri_forms, packed.sph_forms, packed.attrs, packed.globals)
    detached = PackedScene(*(t.detach().contiguous() for t in outs))
    tgt = target.reshape(n_pix, 3).t().contiguous()
    dev = detached.globals.device
    if hand:
        fn = _on(dev, megabwd.hand_l2_reference, megabwd.hand_l2_cuda)
    else:
        fn = _on(dev, l2_fused_reference, l2_fused_cuda)
    with span("tpurt.megakernel"):
        _count_launch(detached, n_pix)
        sq, cot = fn(detached, config, 0, n_pix, tgt)
    grads = torch.autograd.grad(
        outs, live, grad_outputs=(cot.tri_forms, cot.sph_forms, cot.attrs, cot.globals),
        allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live, grads)]
    return sq.sum(), scene_like(scene, dict(zip(paths, grads)))
