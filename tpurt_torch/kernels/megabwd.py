"""Hand-derived phase-1 fused L2 backward: wrapper, plain version and the
small adjoint helpers (the counterpart of ``tpurt/kernels/megabwd.py``).

The hand-written CUDA kernel is ``csrc/megabwd_hand.cu``; it replaces the TPU
kernel ``tpurt/kernels/megabwd.py:_hand_kernel`` (body ``_tile_l2_hand``).  Per
pixel it makes one forward sweep with shadow tests that keeps, for every
depth, the entry ray, the throughput, (t, u, v), the winner's row, which
sphere root won and the occlusion bits; forms the L2 error against the target
and its seed; and sweeps back through closed-form adjoints of every stage:
Phong and Whitted shading, normal interpolation and normalisation, reflect,
the winner's Baldwin–Weber forms, the sphere's quadratic root and the camera
ray.  Where the TPU kernel transposes one-hot matmuls, the adjoint adds
straight into the winner's rows.

``hand_l2_reference`` is the same sweep pair in plain vectorised PyTorch, op
for op; ``megakernel.l2_fused_reference`` reaches the same numbers through
autograd, and the tests hold the two together.  The forward sweep and the
forward values the reverse sweep evaluates again (the hit point, the normal,
each light's terms, the winner's forms) are the phase-1 body's arithmetic
(``megakernel._p1_`` helpers, exact FMA), as in the kernel; the reverse
arithmetic rounds every product and sum on its own.  A tensor on the CPU goes to
the plain version; a tensor on a card goes to the kernel, or the call raises.

Subgradient convention, shared by every backward kernel of the port and by
their plain versions (``jax.vjp`` splits these ties in two; the hand adjoint
of ``tpurt`` does not, and the port follows the hand adjoint):

* the final clip passes the whole seed where CLAMP_LO ≤ accum ≤ CLAMP_HI,
  bounds included (``clip_mask``);
* ``max(x, 0)`` on n·l and r·v passes nothing unless x > 0 (``max_pass``);
* the light distance passes nothing through ``max(dist, 1e-20)`` unless
  dist > 1e-20;
* hit topology, the winner, the sphere root chosen and visibility are fixed.
"""
from __future__ import annotations

import torch

from tpurt_torch import constants as C
from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels import pack as PK
from tpurt_torch.kernels.megakernel import (
    _accumulate, _add, _closest, _dot, _fma, _g3, _light_terms, _neg, _p1_axpy, _p1_dot,
    _p1_interp, _p1_normalize, _p1_raygen, _p1_reflect, _p1_row_d, _p1_row_o, _p1_sph_quadratic,
    _p1_sph_terms, _phong, _scale, _shade, _sub, _where, clip_mask, max_pass)
from tpurt_torch.kernels.pack import PackedScene


def _nrm_bwd(v, cot_n):
    """Adjoint of normalize: n = v·s, s = rsqrt(v·v + eps) ⇒
    cot_v = s·cot_n − s³·v·(v·cot_n)."""
    s = torch.rsqrt(_dot(v, v) + C.NORMALIZE_EPS)
    vc = _dot(v, cot_n)
    s3 = s * s * s
    return tuple(s * cot_n[k] - s3 * v[k] * vc for k in range(3))


def _refl_bwd(m, n, cot_r):
    """Adjoint of reflect r = m − 2(m·n)n ⇒
    cot_m = cot_r − 2n(n·cot_r);  cot_n = −2[(m·n)·cot_r + (n·cot_r)·m]."""
    ncr = _dot(n, cot_r)
    mn = _dot(m, n)
    cot_m = tuple(cot_r[k] - 2.0 * n[k] * ncr for k in range(3))
    cot_n = tuple(-2.0 * (mn * cot_r[k] + ncr * m[k]) for k in range(3))
    return cot_m, cot_n


def _zeros3(like):
    z = torch.zeros_like(like)
    return (z, z, z)


def _masked3(m, a):
    return tuple(torch.where(m, x, 0.0) for x in a)


def _hand_chunk(packed, cfg, pix0, n, target, tables):
    """One chunk of pixels: returns sq (n,) and adds the chunk's cotangents
    into `tables` (a PackedScene of zero-initialised accumulators)."""
    g = packed.globals
    L, T = packed.n_lights, packed.n_tris
    shadows = cfg.shadows
    o, d, graw, sx, sy = _p1_raygen(g, cfg.height, cfg.width, pix0, n)
    ambient = _g3(g, 12)

    # ---- forward sweep: residuals per depth ------------------------------
    zero = torch.zeros(n, dtype=C.DTYPE, device=g.device)
    accum = (zero, zero, zero)
    thr = zero + 1.0
    alive = torch.ones(n, dtype=torch.bool, device=g.device)
    res = []
    for _ in range(cfg.max_depth + 1):
        t, u, v, idx = _closest(packed, o, d)
        hit = t < C.T_MAX
        color, bits, p_off, nrm, a = _shade(packed, shadows, o, d, t, u, v, idx)
        res.append(dict(o=o, d=d, thr=thr, alive=alive, t=t, u=u, v=v, idx=idx,
                        occ=bits, color=color))
        accum = _accumulate(accum, alive, thr, hit, color)
        refl = torch.where(hit, a[:, PK.A_REFL], 0.0)
        thr = thr * refl
        alive = alive & hit & (refl > 0.0)
        o, d = p_off, _p1_reflect(d, nrm)

    # ---- the L2 objective and its seed -----------------------------------
    e = tuple(accum[c].clamp(C.CLAMP_LO, C.CLAMP_HI) - target[c] for c in range(3))
    sq = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
    cot_acc = tuple(torch.where(clip_mask(accum[c]), 2.0 * e[c], 0.0) for c in range(3))

    # ---- reverse sweep ----------------------------------------------------
    cot_o, cot_d, cot_thr = _zeros3(zero), _zeros3(zero), zero
    for r in reversed(res):
        o, d, thr, idx = r["o"], r["d"], r["thr"], r["idx"]
        hit = r["t"] < C.T_MAX
        act = r["alive"] & hit                 # a shaded point: the adjoint runs
        miss = r["alive"] & ~hit               # background: only cot_thr moves
        # lanes without a shaded point contribute nothing; give them finite
        # stand-ins so that no inf or NaN reaches a sum
        o, d = _masked3(act, o), _masked3(act, d)
        t, u, v = (torch.where(act, r[k], 0.0) for k in "tuv")
        is_tri = idx < T
        a = packed.attrs[idx]

        def a3(k):
            return (a[:, k], a[:, k + 1], a[:, k + 2])

        cot_a = torch.zeros_like(a)

        def arow3(k, vals):
            for i in range(3):
                cot_a[:, k + i] += vals[i]

        # recompute the shading intermediates at the residuals
        p = _p1_axpy(o, d, t)
        w = 1.0 - u - v
        n0, n1, n2 = a3(PK.A_N0), a3(PK.A_N1), a3(PK.A_N2)
        gsum = _p1_interp(n0, n1, n2, w, u, v)
        n_int = _p1_normalize(gsum)
        flip = _p1_dot(n_int, d) > 0.0
        n_tri = _where(flip, _neg(n_int), n_int)
        psub = _sub(p, a3(PK.A_CENTER))
        nrm = _where(is_tri, n_tri, _p1_normalize(psub))
        ka, kd, ks = a3(PK.A_KA), a3(PK.A_KD), a3(PK.A_KS)
        shin = a[:, PK.A_SHIN]
        view = _neg(d)

        # thr' = thr·refl;  accum += thr·colour
        cot_a[:, PK.A_REFL] += cot_thr * thr
        cot_live = sum(cot_acc[c] * torch.where(hit, r["color"][c], C.BACKGROUND[c])
                       for c in range(3))
        cot_thr_in = torch.where(act, cot_thr * a[:, PK.A_REFL], 0.0) \
            + torch.where(act | miss, cot_live, 0.0)
        cot_csh = tuple(torch.where(act, cot_acc[c] * thr, 0.0) for c in range(3))

        cot_n, cot_p, cot_view = _zeros3(zero), _zeros3(zero), _zeros3(zero)
        d_glob = torch.zeros_like(g)
        for li in range(L):
            k_pos = PK.NGLOB_BASE + 3 * li
            k_col = PK.NGLOB_BASE + 3 * L + 3 * li
            lcol = _g3(g, k_col)
            lt = _light_terms(nrm, p, view, _g3(g, k_pos), shin)
            to_l, dist2, dist, inv, ldir = (lt[k] for k in ("to_l", "dist2", "dist", "inv",
                                                            "ldir"))
            raw_nl, ndotl, refl_l, raw_rv = (lt[k] for k in ("raw_nl", "ndotl", "refl_l",
                                                             "raw_rv"))
            safe_rv, specmask, spec = lt["safe_rv"], lt["specmask"], lt["spec"]
            mneg = _neg(ldir)
            vis = (1.0 - ((r["occ"] >> li) & 1).to(C.DTYPE)) if shadows \
                else torch.ones_like(dist)

            arow3(PK.A_KD, tuple(vis * lcol[c] * ndotl * cot_csh[c] for c in range(3)))
            arow3(PK.A_KS, tuple(vis * lcol[c] * spec * cot_csh[c] for c in range(3)))
            cot_ndotl = vis * sum(lcol[c] * kd[c] * cot_csh[c] for c in range(3))
            cot_spec = vis * sum(lcol[c] * ks[c] * cot_csh[c] for c in range(3))
            for c in range(3):
                d_glob[k_col + c] += (vis * _phong(kd[c], ks[c], lt) * cot_csh[c]).sum()

            # pow's two adjoints, both under the spec mask
            cot_srv = torch.where(specmask, shin * safe_rv ** (shin - 1.0), 0.0) * cot_spec
            cot_a[:, PK.A_SHIN] += torch.where(specmask, spec * torch.log(safe_rv), 0.0) * cot_spec
            cot_raw_rv = torch.where(raw_rv > 0.0, cot_srv, 0.0)
            cot_refl_l = _scale(view, cot_raw_rv)
            cot_view = _add(cot_view, _scale(refl_l, cot_raw_rv))
            cot_m, cot_n_r = _refl_bwd(mneg, nrm, cot_refl_l)
            cot_raw_nl = torch.where(raw_nl > 0.0, cot_ndotl, 0.0)
            cot_n = _add(_add(cot_n, cot_n_r), _scale(ldir, cot_raw_nl))
            cot_ldir = _add(_neg(cot_m), _scale(nrm, cot_raw_nl))
            cot_inv = _dot(to_l, cot_ldir)
            cot_dist = torch.where(dist > 1e-20, -(inv * inv) * cot_inv, 0.0)
            cot_dist2 = torch.where(dist2 > 0.0, cot_dist / (2.0 * dist), 0.0)
            cot_to_l = _add(_scale(cot_ldir, inv), _scale(to_l, 2.0 * cot_dist2))
            for c in range(3):
                d_glob[k_pos + c] += cot_to_l[c].sum()
            cot_p = _sub(cot_p, cot_to_l)

        arow3(PK.A_KA, tuple(ambient[c] * cot_csh[c] for c in range(3)))
        for c in range(3):
            d_glob[12 + c] += (ka[c] * cot_csh[c]).sum()

        # the next ray: o' = p + eps·n, d' = reflect(d, n); view = −d
        cot_p = _add(cot_p, cot_o)
        cot_n = _add(cot_n, _scale(cot_o, C.RAY_OFFSET_EPS))
        cot_d_in, cot_n_r2 = _refl_bwd(d, nrm, cot_d)
        cot_n = _add(cot_n, cot_n_r2)
        cot_d_in = _sub(cot_d_in, cot_view)

        # n = sphere normal or interpolated, two-sided triangle normal
        cot_psub = _nrm_bwd(psub, _masked3(~is_tri, cot_n))
        cot_p = _add(cot_p, cot_psub)
        arow3(PK.A_CENTER, _neg(cot_psub))
        cot_ntri = _masked3(is_tri, cot_n)
        cot_g = _nrm_bwd(gsum, _where(flip, _neg(cot_ntri), cot_ntri))
        arow3(PK.A_N0, _scale(cot_g, w))
        arow3(PK.A_N1, _scale(cot_g, u))
        arow3(PK.A_N2, _scale(cot_g, v))
        cot_u = torch.where(is_tri, _dot(_sub(n1, n0), cot_g), 0.0)
        cot_v = torch.where(is_tri, _dot(_sub(n2, n0), cot_g), 0.0)

        # p = o + t·d
        cot_o_in = cot_p
        cot_t = _dot(cot_p, d)
        cot_d_in = _add(cot_d_in, _scale(cot_p, t))

        # the winner's forms, evaluated again from its row
        tri_w = act & is_tri
        sph_w = act & ~is_tri
        ti = torch.where(is_tri, idx, 0)
        si = torch.where(is_tri, 0, idx - T)
        fn, fu, fv = (packed.tri_forms[ti, k] for k in range(3))
        fc, fd = (packed.sph_forms[si, k] for k in range(2))

        no = _p1_row_o(fn, o)
        ndd = _p1_row_d(fn, d)
        good = ndd.abs() >= C.MT_DET_EPS
        safe_nd = torch.where(good, ndd, 1.0)
        t_tri = -no / safe_nd
        cot_t_tri = torch.where(
            tri_w, cot_t + _p1_row_d(fu, d) * cot_u + _p1_row_d(fv, d) * cot_v, 0.0)
        cot_uo = torch.where(tri_w, cot_u, 0.0)
        cot_vo = torch.where(tri_w, cot_v, 0.0)
        cot_no = torch.where(good, -cot_t_tri / safe_nd, 0.0)
        cot_nd = torch.where(good, -t_tri / safe_nd, 0.0) * cot_t_tri
        cot_ud = t_tri * cot_uo
        cot_vd = t_tri * cot_vo

        # sphere: t = −b ∓ sqrt(b² − cterm), the root the forward chose by
        # the forms, with b and the discriminant of _p1_sph_quadratic, as the
        # forward's t
        bf, cterm = _p1_sph_terms(fc, fd, o, d, _p1_dot(o, o), _p1_dot(o, d))
        disc_f = _fma(bf, bf, -cterm)
        t0 = -bf - torch.sqrt(torch.where(disc_f > 0.0, disc_f, 1.0))
        first = (disc_f > 0.0) & (t0 > C.T_MIN) & (t0 < C.T_MAX)
        b, disc = _p1_sph_quadratic(fc, fd, a, o, d)
        has = disc > 0.0
        sqv = torch.sqrt(torch.where(has, disc, 1.0))
        cot_t_sph = torch.where(sph_w, cot_t, 0.0)
        cot_sq = torch.where(first, -cot_t_sph, cot_t_sph)
        cot_disc = torch.where(has, cot_sq / (2.0 * sqv), 0.0)
        cot_b = -cot_t_sph + 2.0 * b * cot_disc
        cot_ct = -cot_disc          # also the cotangent of o·o
        cot_cd = -cot_b             # cot_b is also the cotangent of o·d

        cot_o_in = tuple(
            cot_o_in[k] + 2.0 * o[k] * cot_ct + d[k] * cot_b
            + fn[:, k] * cot_no + fu[:, k] * cot_uo + fv[:, k] * cot_vo
            + fc[:, k] * cot_ct for k in range(3))
        cot_d_in = tuple(
            cot_d_in[k] + o[k] * cot_b
            + fn[:, k] * cot_nd + fu[:, k] * cot_ud + fv[:, k] * cot_vd
            + fd[:, k] * cot_cd for k in range(3))

        # straight into the winner's rows: cot ⊗ (o, 1) and cot ⊗ d share the
        # form's three xyz columns
        def form_row(c_o, c_d):
            return torch.stack([c_o * o[k] + c_d * d[k] for k in range(3)] + [c_o], 1)

        d_tri = torch.stack([form_row(cot_no, cot_nd), form_row(cot_uo, cot_ud),
                             form_row(cot_vo, cot_vd)], 1)
        d_sph = torch.stack([form_row(cot_ct, torch.zeros_like(cot_ct)),
                             torch.stack([cot_cd * d[0], cot_cd * d[1], cot_cd * d[2],
                                          torch.zeros_like(cot_cd)], 1)], 1)
        tables.tri_forms.index_add_(0, ti, torch.where(tri_w[:, None, None], d_tri, 0.0))
        tables.sph_forms.index_add_(0, si, torch.where(sph_w[:, None, None], d_sph, 0.0))
        tables.attrs.index_add_(0, idx, torch.where(act[:, None], cot_a, 0.0))
        tables.globals.add_(d_glob)

        cot_o = _masked3(act, cot_o_in)
        cot_d = _masked3(act, cot_d_in)
        cot_thr = cot_thr_in

    # ---- the camera ray: o = eye, d = normalize(fwd + right·sx + up·sy) ----
    cot_graw = _nrm_bwd(graw, cot_d)
    for k in range(3):
        tables.globals[k] += cot_o[k].sum()
        tables.globals[3 + k] += cot_graw[k].sum()
        tables.globals[6 + k] += (sx * cot_graw[k]).sum()
        tables.globals[9 + k] += (sy * cot_graw[k]).sum()
    return sq


def hand_l2_reference(packed: PackedScene, cfg, off: int, n_pix: int, target):
    """Plain PyTorch version of the hand-adjoint kernel, chunked over pixels.
    Returns (sq (n_pix,) per-pixel squared error against target (3, n_pix),
    cotangents of the packed tensors as a PackedScene)."""
    MK._check_limits(packed, off, n_pix)
    MK.launches["l2_hand_reference"] += 1
    with torch.no_grad():
        tables = PackedScene(*(torch.zeros_like(t) for t in (
            packed.tri_forms, packed.sph_forms, packed.attrs, packed.globals)))
        sq = [_hand_chunk(packed, cfg, off + s, n, target[:, s:s + n], tables)
              for s, n in MK._chunks(packed, n_pix)]
    return torch.cat(sq), tables


def hand_l2_cuda(packed: PackedScene, cfg, off: int, n_pix: int, target):
    """Launch csrc/megabwd_hand.cu on the current stream of the packed
    tensors' card.  Same contract as hand_l2_reference."""
    MK._check_depth(cfg)
    dev = MK.check_kernel_inputs(packed, off, n_pix,
                                 target=(target, 3, torch.float32))
    sq = torch.empty((n_pix,), dtype=torch.float32, device=dev)
    cot = MK.launch_backward("l2_hand", packed, cfg, off, n_pix, dev, (target,), sq)
    MK.launches["l2_hand"] += 1
    return sq, cot
