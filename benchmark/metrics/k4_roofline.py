"""K4 (``l2_hand``, the phase-1 plan's fused L2 step) against its roofline,
in %: the least time an H100 could take for the step's work over the
kernel's mean device time a launch.

The work is a frozen copy of the arithmetic of the program's
``utils/roofline.py:phase1_work`` as it stood when the benchmark was
defined, with its operation counts a primitive test, a shaded point and a
light; the path counts it needs (closest-hit passes, shaded points on
triangles and on spheres, blocked shadow rays) come from the benchmark's
own reference render of the cell's first start, never from the program.
Peaks: 67 TFLOP/s FP32 and 3.35 TB/s (NVIDIA's data sheet, H100 SXM, 700 W).
"""

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
OPS_TRI_TEST = 40
OPS_SPH_TEST = 19
OPS_RAY_SETUP = 10
OPS_SHADE_FIXED = 37
OPS_NORMAL_TRI, OPS_NORMAL_SPH = 32, 13
OPS_SHADE_LIGHT = 57
OPS_REVERSE_FIXED_TRI, OPS_REVERSE_FIXED_SPH = 230, 150
OPS_REVERSE_LIGHT = 150
#: the packed tables the kernel reads: floats a triangle, a sphere, a
#: primitive's attributes, and the globals (15 + 6 a light)
TRI_FORM_FLOATS, SPH_FORM_FLOATS, ATTR_FLOATS, GLOBAL_BASE = 12, 8, 35, 15


def l2_hand_bound_s(counts, n_tris, n_spheres, n_lights, shadows, n_pix):
    rays = sum(counts["rays"])
    tri, sph = sum(counts["shaded_tri"]), sum(counts["shaded_sph"])
    shadow = (tri + sph) * n_lights if shadows else 0
    blocked = sum(counts["blocked"])
    per_ray = n_tris * OPS_TRI_TEST + n_spheres * OPS_SPH_TEST + OPS_RAY_SETUP
    closest = rays * per_ray
    shadows_ops = (shadow - blocked) * per_ray + blocked * (OPS_SPH_TEST + OPS_RAY_SETUP)
    shade = tri * (OPS_SHADE_FIXED + OPS_NORMAL_TRI) + sph * (OPS_SHADE_FIXED + OPS_NORMAL_SPH) \
        + (tri + sph) * n_lights * OPS_SHADE_LIGHT
    reverse = tri * OPS_REVERSE_FIXED_TRI + sph * OPS_REVERSE_FIXED_SPH \
        + (tri + sph) * n_lights * OPS_REVERSE_LIGHT
    ops = closest + shadows_ops + shade + reverse
    table = 4 * (GLOBAL_BASE + 6 * n_lights + TRI_FORM_FLOATS * n_tris
                 + SPH_FORM_FLOATS * n_spheres + ATTR_FLOATS * (n_tris + n_spheres))
    nbytes = n_pix * (12 + 4) + 2 * table
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def read(ctx):
    if ctx.mode != "step" or ctx.trace is None or ctx.ref_counts is None:
        return None
    seconds, n = ctx.trace.kernel_seconds(lambda name: "l2_hand" in name)
    if not n:
        return None
    cfg = ctx.config
    bound = l2_hand_bound_s(ctx.ref_counts, cfg["triangles"], cfg.get("spheres", 0),
                            cfg["lights"], cfg["shadows"], ctx.n_pix)
    return 100.0 * bound / (seconds / n)
