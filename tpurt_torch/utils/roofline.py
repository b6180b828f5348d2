"""Roofline model of one NVIDIA H100 SXM for the port's kernels: the least
time the card could take for a kernel's work, the larger of the bytes it
must move over the memory rate and the operations it must do over the peak
rate for their type.  It replaces ``tpurt/utils/roofline.py``'s TPU v5e
model for the port; ``chip_smoke.py`` and the tools in ``tpurt_torch/tools``
take their bounds from here.

The operation counts are read off the kernels' sources by hand, one for each
add, multiply, divide, sqrt, rsqrt, pow and log (compares and selects are not
counted), so the bounds are low estimates: a division, a sqrt or a ``powf``
costs the card several instructions, and the kernels are built with
``-fmad=false``, which forgoes the FMA half of the FP32 peak.
"""
from __future__ import annotations

#: published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W
#: power limit): FP32 outside the tensor cores with a fused multiply-add
#: counted as two operations, bf16 in the tensor cores, and HBM
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# the phase-1 kernels (csrc/megakernel_common.cuh, megakernel_adjoint.cuh)
OPS_TRI_TEST = 40        # tri_t: three forms at o and d, t, u, v, u + v
OPS_SPH_TEST = 19        # sph_t: two forms, discriminant, root
OPS_RAY_SETUP = 10       # o.o and o.d of a closest or shadow pass
OPS_SHADE_FIXED = 37     # p, ambient, offset point, accumulate, throughput, reflect
OPS_NORMAL_TRI, OPS_NORMAL_SPH = 32, 13
OPS_SHADE_LIGHT = 57     # one light's Phong term
OPS_REVERSE_FIXED_TRI, OPS_REVERSE_FIXED_SPH = 230, 150  # recompute + adjoint of a depth
OPS_REVERSE_LIGHT = 150  # recompute + adjoint of one light's term

# K11, deferred shading (csrc/shade.cu), a shaded hit
OPS_SHADE_TRI = 55       # edges, Moller-Trumbore t, u, v, p
OPS_SHADE_SPH = 30       # o - c, the quadratic and its root, p, the normal
OPS_SHADE_NORMAL = 20    # interpolated or cross-product normal, normalized
OPS_SHADE_TEXTURE = 40   # the uv, the wrap lookup's weights, kd times texel
OPS_SHADE_HIT = 25       # ambient, accumulate, throughput, offset point, reflect

# the traversal kernel (csrc/traversal.cu), besides the triangle and sphere tests
OPS_BOX_TEST = 12     # box_entry: six subtract-multiplies (min and max not counted)
OPS_HIT_POINT = 45    # p, the interpolated normal, the offset point, reflect
OPS_SHADOW_SETUP = 14  # direction and distance to a light


def bound_ms(nbytes, ops, peak_ops: float = PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over `peak_ops`, and which of the two it is."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase1_work(packed, cfg, n_pix) -> dict:
    """What one launch of each phase-1 kernel over n_pix pixels must do on
    this scene's paths: {"ops": {kernel: n}, "bytes": {kernel: n}} and the
    path counts they come from (closest-hit passes, shaded points on
    triangles and on spheres, shadow rays and how many are blocked).  Each
    input is read once and each output written once."""
    from tpurt_torch.kernels import megakernel as MK

    T, S, L = packed.n_tris, packed.n_spheres, packed.n_lights
    D = cfg.max_depth + 1
    c = MK.path_counts(packed, cfg, 0, n_pix)
    rays = sum(c["rays"])
    tri, sph = sum(c["shaded_tri"]), sum(c["shaded_sph"])
    shadow = (tri + sph) * L if cfg.shadows else 0
    blocked = sum(c["blocked"])
    closest = rays * (T * OPS_TRI_TEST + S * OPS_SPH_TEST + OPS_RAY_SETUP)
    # an open shadow ray tests every primitive; a blocked one needs one test
    shadows = (shadow - blocked) * (T * OPS_TRI_TEST + S * OPS_SPH_TEST + OPS_RAY_SETUP) \
        + blocked * (OPS_SPH_TEST + OPS_RAY_SETUP)
    shade = tri * (OPS_SHADE_FIXED + OPS_NORMAL_TRI) + sph * (OPS_SHADE_FIXED + OPS_NORMAL_SPH) \
        + (tri + sph) * L * OPS_SHADE_LIGHT
    reverse = tri * OPS_REVERSE_FIXED_TRI + sph * OPS_REVERSE_FIXED_SPH \
        + (tri + sph) * L * OPS_REVERSE_LIGHT
    table = 4 * (packed.globals.numel() + 12 * T + 8 * S + 35 * (T + S))
    ops = {"megakernel_fwd": closest + shadows + shade,
           "megakernel_bwd": closest + shade + reverse,
           "l2_fused": 2 * closest + shadows + 2 * shade + reverse,
           "l2_hand": closest + shadows + shade + reverse}
    nbytes = {"megakernel_fwd": n_pix * (12 + 4 * D) + table,
              "megakernel_bwd": n_pix * (12 + 4 * D) + 2 * table,
              "l2_fused": n_pix * (12 + 4) + 2 * table,
              "l2_hand": n_pix * (12 + 4) + 2 * table}
    return {"ops": ops, "bytes": nbytes, "counts": c, "shaded_tri": tri, "shaded_sph": sph,
            "shadow_rays": shadow, "blocked": blocked}


def phase1_bounds(packed, cfg, n_pix) -> dict:
    """{kernel: (bound_ms, bound_by)} of the phase-1 kernels (``phase1_work``)."""
    work = phase1_work(packed, cfg, n_pix)
    return {k: bound_ms(work["bytes"][k], work["ops"][k]) for k in work["ops"]}


def traversal_ops(n, lanes_out):
    """FP32 operations of a traversal launch from its counting launch's
    counts (``kernels/traversal.py:STAT_NAMES``) and its output lanes."""
    return (n["nodes"] + n.get("group_tests", 0)) * OPS_BOX_TEST \
        + n["tri_tests"] * OPS_TRI_TEST + n["sph_tests"] * OPS_SPH_TEST \
        + n["rays"] * (OPS_RAY_SETUP + OPS_SHADOW_SETUP) + lanes_out * OPS_HIT_POINT


def shade_work(scene, o, prim, is_tri, max_depth) -> dict:
    """What one launch of K11 (``kernels/shade.py``) must do on these records:
    {"bytes", "ops"} and the counts they come from.  Bytes: the records of
    each depth a lane reaches (9 B), the rays as they are stored (24 B a
    pixel, 12 B for an origin that every pixel shares), the colour (12 B),
    and once each the table rows that the hits touch: triangles (12 B of
    corners, 4 of material), their vertices (12 B, 12 more smooth, 8 more
    textured), spheres (20 B), materials (48 B), and four texels (48 B) a
    textured hit, at most the texture table."""
    import torch

    n, T, S = prim.shape[1], scene.n_tris, scene.n_spheres
    m = scene.materials
    reach = torch.ones(n, dtype=torch.bool, device=prim.device)
    lanes = hit_tri = hit_sph = textured = 0
    tris, sphs, mats = [], [], []
    for k in range(max_depth + 1):
        lanes += int(reach.sum())
        hit = reach & (prim[k] >= 0)
        tri = hit & (is_tri[k] | (scene.n_real_spheres == 0))
        sph = hit & ~tri
        mat = torch.where(tri, scene.tri_mat[prim[k].clamp(0, T - 1)],
                          scene.sph_mat[prim[k].clamp(0, S - 1)]).long()
        tris.append(prim[k][tri])
        sphs.append(prim[k][sph])
        mats.append(mat[hit])
        hit_tri, hit_sph = hit_tri + int(tri.sum()), hit_sph + int(sph.sum())
        if scene.textured:
            textured += int((hit & (m.texture_id[mat] >= 0)).sum())
        reach = hit & (m.reflectivity[mat] > 0.0)
    tris = torch.unique(torch.cat(tris))
    verts = torch.unique(scene.triangles[tris.long()].reshape(-1)).numel()
    n_sph, n_mat = torch.unique(torch.cat(sphs)).numel(), torch.unique(torch.cat(mats)).numel()
    vert_bytes = 12 + (12 if scene.smooth else 0) + (8 if scene.textured else 0)
    nbytes = (lanes * 9 + (12 * n if o.stride(0) else 12) + 12 * n + 12 * n
              + tris.numel() * 16 + verts * vert_bytes + n_sph * 20 + n_mat * 48
              + min(textured * 48, scene.textures.numel() * 4))
    hits = hit_tri + hit_sph
    ops = (hit_tri * OPS_SHADE_TRI + hit_sph * OPS_SHADE_SPH
           + hits * (OPS_SHADE_NORMAL + OPS_SHADE_HIT + scene.n_lights * OPS_SHADE_LIGHT)
           + textured * OPS_SHADE_TEXTURE)
    return {"bytes": nbytes, "ops": ops, "lanes": lanes, "hits": hits, "triangles":
            tris.numel(), "vertices": verts, "spheres": n_sph, "materials": n_mat,
            "textured_hits": textured}
