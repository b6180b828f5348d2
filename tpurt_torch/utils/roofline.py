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
